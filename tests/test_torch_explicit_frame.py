# coding=utf-8
"""K8, the explicit whole frame — its plain PyTorch version on the CPU —
against the JAX package's explicit whole-frame Pallas kernel
(``make_frame_fn`` with ``frame_backend="blocked_explicit"``, interpret
mode) on the same arrays; the port's explicit frame dispatch; and the
shipped explicit configs ``demo_3d.json`` and ``demo_cube_autodiff.json``
as they are, against the JAX package's frames.

Tolerances: positions atol 1e-5 after each frame of at most 10 substeps
(both sides run the analytic chain; they differ in summation order).
Against the autodiff path, which differentiates the energy instead and so
sums in another association order, the JAX package's own bound for the
same comparison: 1e-4 of max |pos| (tests/test_blocked_frame.py)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu import scene as jscene
from fem_tpu import sim as jsim
from fem_tpu.ops import blocking as jblocking
from fem_tpu.utils import config as jconfig
from fem_tpu_torch import entry, sim
from fem_tpu_torch.ops import blocking
from tests.test_torch_frame import _scene
from tests.test_torch_sim import _bodies

torch.set_num_threads(1)

CAPS = dict(eb=16, pb=24)
TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _explicit_scene(seed, reblock):
    """The cube scene of tests/test_torch_frame.py (the floor, the x = 1
    wall and a circle) under the explicit method, optionally re-blocked in
    both packages with small caps so that it spans several blocks."""
    pcfg, jcfg, obj, state, obs, jobj, jstate, jobs = _scene(seed)
    over = dict(use_explicit_method=True, frame_backend="blocked_explicit",
                implicit_method=0, preconditioned=0)
    pcfg = dataclasses.replace(pcfg, **over)
    jcfg = dataclasses.replace(jcfg, **over)
    if reblock:
        args = (obj.element_indices.numpy(), obj.ref_inv.numpy(),
                obj.volume.numpy(), obj.rest_pos.numpy())
        jblk = jblocking.build_blocking(*args, **CAPS)
        assert jblk.s_dense is not None
        obj = dataclasses.replace(
            obj, blocking=blocking.build_blocking(*args, **CAPS, device="cpu"))
        jobj = jobj.replace(blocking=jblk)
        assert obj.blocking.num_blocks == jblk.num_blocks >= 3
    return pcfg, jcfg, obj, state, obs, jobj, jstate, jobs


@pytest.mark.parametrize("reblock", [False, True])
@pytest.mark.parametrize("method", ["explicit", "autodiff"])
def test_explicit_frame_plain_matches_jax(method, reblock):
    pcfg, jcfg, obj, state, obs, jobj, jstate, jobs = _explicit_scene(
        seed=0, reblock=reblock)
    if method == "autodiff":
        pcfg = dataclasses.replace(pcfg, auto_diff=True)
        jcfg = dataclasses.replace(jcfg, auto_diff=True)
    assert sim.supports_explicit_blocked_frame(obj, pcfg)
    assert jsim.supports_explicit_blocked_frame(jobj, jcfg)
    assert not sim.supports_blocked_frame(obj, pcfg)
    frame = sim.make_frame_fn(obj, pcfg)
    jframe = jsim.make_frame_fn(jobj, jcfg)
    for i in range(3):
        state, aux = frame(state, obs)
        jstate, jaux = jframe(jstate, jobs)
        np.testing.assert_allclose(state.pos.numpy(), np.asarray(jstate.pos),
                                   rtol=0, atol=TOL, err_msg=f"frame {i}")
        np.testing.assert_allclose(state.vel.numpy(), np.asarray(jstate.vel),
                                   rtol=0, atol=2e-3, err_msg=f"frame {i}")
    assert torch.isfinite(state.pos).all()
    for got, ref in ((aux.solver_iterations, jaux.solver_iterations),
                     (aux.solver_residual, jaux.solver_residual)):
        assert got.shape == (pcfg.sim_count,) and not got.any()
        assert got.numpy().dtype == np.asarray(ref).dtype
    assert torch.equal(state.force, torch.zeros_like(state.pos))


def test_autodiff_frame_matches_the_explicit_frame_kernel():
    """The op-composed autodiff frame (autograd, then K7a) against K8's
    plain version, which runs the analytic chain, over 6 frames."""
    pcfg, _, obj, state0, obs, _, _, _ = _explicit_scene(seed=1, reblock=True)
    ad_cfg = dataclasses.replace(pcfg, auto_diff=True, frame_backend="auto")
    ad_frame = sim.make_frame_fn(obj, ad_cfg)
    k8_frame = sim.make_frame_fn(obj, pcfg)
    s_ad, s_k8 = state0, state0
    for i in range(6):
        s_ad, _ = ad_frame(s_ad, obs)
        s_k8, _ = k8_frame(s_k8, obs)
        scale = float(s_ad.pos.abs().max())
        np.testing.assert_allclose(s_k8.pos.numpy(), s_ad.pos.numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=f"frame {i}")
    assert torch.isfinite(s_ad.pos).all()


def _spy(monkeypatch):
    calls = []
    real = sim.fused_explicit_frame

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(sim, "fused_explicit_frame", spy)
    return calls


def test_make_frame_fn_picks_the_explicit_frame_kernel(monkeypatch):
    pcfg, _, obj, state, obs, _, _, _ = _explicit_scene(seed=2, reblock=False)
    calls = _spy(monkeypatch)
    forced, _ = sim.make_frame_fn(obj, pcfg)(state, obs)
    assert len(calls) == 1
    # "auto" runs it on a CUDA object only; this one lies on the CPU, and
    # the op-composed frame gives the same frame.
    auto, _ = sim.make_frame_fn(
        obj, dataclasses.replace(pcfg, frame_backend="auto"))(state, obs)
    assert len(calls) == 1
    np.testing.assert_allclose(auto.pos.numpy(), forced.pos.numpy(), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("over", [
    dict(use_explicit_method=False),
    dict(element_backend="xla"),
    dict(wall_friction=0.5),
])
def test_explicit_frame_rejects_ineligible_configs(over):
    pcfg, _, obj, _, _, _, _, _ = _explicit_scene(seed=3, reblock=False)
    cfg = dataclasses.replace(pcfg, **over)
    assert not sim.supports_explicit_blocked_frame(obj, cfg)
    with pytest.raises(ValueError, match="blocked_explicit"):
        sim.make_frame_fn(obj, cfg)


def test_explicit_frame_is_3d_only():
    """Named when K8 took 3D only.  It now takes 2D too, as the JAX
    package's does (its sim.py:316): a 2D explicit config is eligible, and
    on the CPU "blocked_explicit" runs K8's plain frame, which tracks the
    op-composed frame (it multiplies by m⁻¹ where the substep divides)."""
    pcfg, _, obj, state, obs, _, _, _ = _bodies(2, seed=0)
    cfg = dataclasses.replace(pcfg, use_explicit_method=True,
                              frame_backend="blocked_explicit")
    assert obj.dim == 2 and sim.supports_explicit_blocked_frame(obj, cfg)
    a, _ = sim.make_frame_fn(obj, cfg)(state, obs)
    b, _ = sim.make_frame_fn(
        obj, dataclasses.replace(cfg, frame_backend="auto"))(state, obs)
    np.testing.assert_allclose(a.pos.numpy(), b.pos.numpy(), rtol=0,
                               atol=TOL)
    assert float((a.pos - state.pos).abs().max()) > 1e-4


@pytest.mark.parametrize("name", ["demo_3d.json", "demo_cube_autodiff.json"])
def test_shipped_explicit_configs_match_jax(name, capsys, monkeypatch):
    """The configs as shipped, built by each package's own loader from
    ``assets/cube.stl``: 5 frames of the op-composed frame, and of K8's
    plain version, against the JAX package's frame."""
    monkeypatch.chdir(REPO)  # the JAX loader reads the mesh path as given
    path = os.path.join(REPO, "configs", name)
    cfg, obj, state, obs = entry.load_config(path, "cpu")
    jcfg = jconfig.read_config(path)
    (jbody,), jobs = jscene.load_scene(jcfg)
    capsys.readouterr()  # the loader's banner
    jobj, jstate = jbody.obj, jbody.state
    np.testing.assert_array_equal(obj.element_indices.numpy(),
                                  np.asarray(jobj.element_indices))
    np.testing.assert_array_equal(state.pos.numpy(), np.asarray(jstate.pos))
    assert cfg.use_explicit_method and cfg.frame_backend == "auto"
    assert cfg.auto_diff == (name == "demo_cube_autodiff.json")
    assert sim.supports_explicit_blocked_frame(obj, cfg)
    frames = [
        sim.make_frame_fn(obj, cfg),
        sim.make_frame_fn(obj, dataclasses.replace(
            cfg, frame_backend="blocked_explicit")),
    ]
    jframe = jsim.make_frame_fn(jobj, jcfg)
    states = [state, state]
    for i in range(5):
        jstate, _ = jframe(jstate, jobs)
        for k, frame in enumerate(frames):
            states[k], _ = frame(states[k], obs)
            np.testing.assert_allclose(
                states[k].pos.numpy(), np.asarray(jstate.pos), rtol=0,
                atol=TOL, err_msg=f"frame {i}, frame function {k}")
    moved = np.abs(states[0].pos.numpy() - state.pos.numpy()).max()
    assert moved > 1e-3
    assert jnp.isfinite(jstate.pos).all()
