# coding=utf-8
"""The whole frames K5 and K8 of every material and ``robust_inversion`` —
their plain PyTorch versions on the CPU — against the JAX package's
whole-frame Pallas kernels (``make_frame_fn`` with
``frame_backend="blocked"`` and ``"blocked_explicit"``, interpret mode) and
its op-composed frames, on the same arrays (``configs/demo_passage_corotated.json``
through the port is held in tests/test_torch_golden_corotated.py).

Tolerances: positions (and internal inverses) within 1e-5 after each of 3
frames (the two sum in other orders); CG iteration counts within 1; the
robust frames 5e-5 of the largest position, the bound of the JAX package's
own tests/test_blocked_frame.py for its robust frame."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu import sim as jsim
from fem_tpu.models.state import Obstacles as JaxObstacles
from fem_tpu_torch import convert, entry, sim
from fem_tpu_torch.models.state import Obstacles
from fem_tpu_torch.utils import config as pconfig
from tests.test_blocked_frame import _cfg, _scene
from tests.test_torch_inelastic import (
    assert_state_close,
    inelastic_pair,
    sim_configs,
)
from tests.test_torch_materials import MATERIALS

torch.set_num_threads(1)

TOL = 1e-5
KERNELS = {
    "K5": dict(frame_backend="blocked", preconditioned=0),
    "K8": dict(frame_backend="blocked_explicit", use_explicit_method=True),
}
CASES = (
    [(kernel, 2, m, {}) for kernel in sorted(KERNELS) for m in MATERIALS[2]]
    + [(kernel, 3, m, {}) for kernel in sorted(KERNELS)
       for m in ("corotated", "fiber:1,0.5,0.25")]
    # A base material under the inelastic branches.
    + [("K8", 2, "corotated", dict(plastic_yield=0.02)),
       ("K5", 3, "stvk", dict(plastic_yield=0.02, viscous_mu=1e4,
                              viscous_tau=0.03))]
)


@pytest.mark.parametrize("kernel,dim,material,inelastic", CASES)
def test_material_frame_plain_matches_jax(kernel, dim, material, inelastic):
    """3 frames against the JAX package's whole-frame kernel in interpret
    mode; the 3D corotated ones against its op-composed frame (the same
    substeps summed in another order), since its interpreted 3D corotated
    frame, 12 Higham iterations a tet in every substep, takes minutes."""
    obj, state, jobj, jstate = inelastic_pair(
        dim, dict(material=material, **inelastic), seed=23, squash=0.1)
    pcfg, jcfg = sim_configs(dim, **KERNELS[kernel])
    if dim == 3 and material == "corotated":
        jcfg = dataclasses.replace(jcfg, frame_backend="auto")
    supports = (sim.supports_blocked_frame if kernel == "K5"
                else sim.supports_explicit_blocked_frame)
    assert supports(obj, pcfg)
    frame = sim.make_frame_fn(obj, pcfg)
    jframe = jsim.make_frame_fn(jobj, jcfg)
    obs = Obstacles.from_configs((), dim, device="cpu")
    jobs = JaxObstacles.from_configs((), dim)
    for i in range(3):
        state, aux = frame(state, obs)
        jstate, jaux = jframe(jstate, jobs)
        assert_state_close(state, jstate, what=f"frame {i}")
        got = aux.solver_iterations.numpy()
        ref = np.asarray(jaux.solver_iterations)
        assert np.all(np.abs(got - ref) <= 1), (got, ref)


def _robust_scene(flatten=None):
    """tests/test_blocked_frame.py's cube (one block, a wall and the sphere)
    in both packages; with ``flatten``, one tet whose base lies in a plane
    y = const gets its apex pushed ``flatten`` past that plane: inverted and
    nearly flat (det F ≈ −1.7e-5 at 3e-6)."""
    jobj, jstate, jobs = _scene()
    pos = np.asarray(jstate.pos).copy()
    if flatten is not None:
        idx = np.asarray(jobj.element_indices)
        e, k = next((e, k) for e in range(idx.shape[0]) for k in range(4)
                    if len({float(pos[v, 1]) for j, v in enumerate(idx[e])
                            if j != k}) == 1
                    and pos[idx[e][k], 1] != pos[idx[e][(k + 1) % 4], 1])
        y = pos[idx[e][(k + 1) % 4], 1]
        pos[idx[e][k], 1] = y - np.sign(pos[idx[e][k], 1] - y) * flatten
        jstate = jstate.replace(pos=jnp.asarray(pos))
    arrays = {n: np.asarray(getattr(jobj, n)) for n in convert.OBJECT_ARRAYS}
    statics = {n: getattr(jobj, n) for n in convert.OBJECT_STATICS}
    obj = convert.object_from_arrays(arrays, statics, "cpu")
    state = convert.state_from_arrays(
        {n: np.asarray(getattr(jstate, n)) for n in convert.STATE_ARRAYS},
        "cpu")
    obs = Obstacles(torch.tensor(np.asarray(jobs.centers)),
                    torch.tensor(np.asarray(jobs.radii)))
    return obj, state, obs, jobj, jstate, jobs


def _port_cfg(**kw):
    """The port's twin of tests/test_blocked_frame.py's ``_cfg``."""
    return pconfig.SimConfig(
        dim=3, delta_time=5e-4, sim_count=4, use_explicit_method=False,
        auto_diff=False, implicit_method=1, preconditioned=1,
        g_dir=(0.0, -1.0, 0.0), **kw)


def test_inverted_cube_is_the_robust_scene():
    """``entry.inverted_cube``, the state that chip_smoke.py and the CUDA
    tests run the robust K5 on, is this file's inverted scene, meshed by the
    port: the same tets, positions, masses and obstacle, and the config of
    :func:`_port_cfg` with ``robust_inversion``."""
    cfg, obj, state, obs = entry.inverted_cube("cpu")
    pobj, pstate, pobs, _, _, _ = _robust_scene(flatten=3e-6)
    assert torch.equal(obj.element_indices, pobj.element_indices)
    for got, want in ((state.pos, pstate.pos), (obj.mass, pobj.mass),
                      (obs.centers, pobs.centers), (obs.radii, pobs.radii)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=0)
    want = _port_cfg(robust_inversion=True)
    for name in ("dim", "delta_time", "sim_count", "implicit_method",
                 "preconditioned", "robust_inversion", "g_dir"):
        assert getattr(cfg, name) == getattr(want, name), name


def test_robust_frame_matches_op_composed():
    """The JAX package's tests/test_blocked_frame.py:154-171 through the
    port: the robust whole frame (K5's plain version) against the JAX
    package's robust op-composed frame (blocked operator, XLA elements) and
    its robust whole-frame kernel, 5 frames."""
    obj, state, obs, jobj, jstate, jobs = _robust_scene()
    frame = sim.make_frame_fn(obj, _port_cfg(robust_inversion=True,
                                             frame_backend="blocked"))
    j_ops = jsim.make_frame_fn(jobj, _cfg(robust_inversion=True,
                                          operator_mode="blocked",
                                          element_backend="xla"))
    j_fused = jsim.make_frame_fn(jobj, _cfg(robust_inversion=True,
                                            frame_backend="blocked"))
    s_ops = s_fused = jstate
    for _ in range(5):
        state, _ = frame(state, obs)
        s_ops, _ = j_ops(s_ops, jobs)
        s_fused, _ = j_fused(s_fused, jobs)
    scale = float(jnp.max(jnp.abs(s_ops.pos)))
    for ref in (s_ops, s_fused):
        np.testing.assert_allclose(state.pos.numpy(), np.asarray(ref.pos),
                                   rtol=0, atol=5e-5 * scale)


def test_robust_frame_on_an_inverted_tet():
    """An inverted, nearly flat tet (det F ≈ −1.7e-5, so that det F² < 1e-8
    and the robust clamp of the rhs log acts): the robust frame — K5's plain
    version, the blocked operator and K1 + K4 — stays finite and equals the
    JAX package's robust op-composed frame over its Pallas element chain
    (the blocked prep, interpret mode) to 1e-5, and differs from the
    non-robust frame.  On this state the JAX package's XLA element path,
    whose rhs takes log max(det(FᵀF), 1e-8) with det(FᵀF) rounded anywhere
    in ±1e-7, drifts by ~1e-3 from its Pallas chains' log max(det F²,
    1e-8), which the port takes, and its whole-frame kernel goes
    non-finite after one substep (ROADMAP F6)."""
    obj, state, obs, jobj, jstate, jobs = _robust_scene(flatten=3e-6)
    from fem_tpu_torch.ops.element import deformation_gradients
    from fem_tpu_torch.ops import smallmat as sm

    det = sm.det(deformation_gradients(state.pos, obj.element_indices,
                                       obj.ref_inv))
    assert -1e-4 < float(det.min()) < 0.0
    js, jaux = jsim.make_frame_fn(jobj, _cfg(
        robust_inversion=True, operator_mode="blocked",
        element_backend="pallas"))(jstate, jobs)
    got = {}
    for over in (dict(frame_backend="blocked"), dict(operator_mode="blocked"),
                 dict(operator_mode="graph")):
        s, aux = sim.make_frame_fn(obj, _port_cfg(robust_inversion=True,
                                                  **over))(state, obs)
        assert torch.isfinite(s.pos).all()
        np.testing.assert_allclose(s.pos.numpy(), np.asarray(js.pos),
                                   rtol=0, atol=TOL, err_msg=str(over))
        assert np.all(np.abs(aux.solver_iterations.numpy()
                             - np.asarray(jaux.solver_iterations)) <= 1)
        got[tuple(over.items())] = s.pos
    plain, _ = sim.make_frame_fn(obj, _port_cfg(frame_backend="blocked"))(
        state, obs)
    assert not torch.equal(plain.pos, got[(("frame_backend", "blocked"),)])
