# coding=utf-8
"""K5 and K8 with their plastic and Maxwell branches — their plain PyTorch
versions on the CPU — against the JAX package's whole-frame Pallas kernels
(``make_frame_fn`` with ``frame_backend="blocked"`` and
``"blocked_explicit"``, interpret mode) on the same arrays: 3 frames of the
2D grid at 16 subdivisions (3 locality blocks) and of the 3D grid re-blocked
into several blocks, both meshes whose blocks permute the elements, from an
over-yield state with perturbed internal inverses.  Also the port's frame
dispatch for inelastic configs and ``configs/demo_plastic.json``'s implicit
variant.

Tolerance: positions and both internal inverses within 1e-5 after each
frame (the two sum in other orders; ≤ 3 frames, as a yield decision that
rounding flips would move a long arc)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu import scene as jscene
from fem_tpu import sim as jsim
from fem_tpu.models.state import Obstacles as JaxObstacles
from fem_tpu.utils import config as jconfig
from fem_tpu_torch import convert, sim
from fem_tpu_torch.models.state import Obstacles
from tests.test_torch_inelastic import (
    MATS,
    REPO,
    _demo_plastic,
    assert_state_close,
    inelastic_pair,
    sim_configs,
)

torch.set_num_threads(1)

KERNELS = {
    "K5": dict(frame_backend="blocked", preconditioned=0),
    "K8": dict(frame_backend="blocked_explicit", use_explicit_method=True),
}


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mat", sorted(MATS))
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_inelastic_frame_plain_matches_jax(kernel, mat, dim):
    obj, state, jobj, jstate = inelastic_pair(dim, MATS[mat], seed=11,
                                              squash=0.1)
    pcfg, jcfg = sim_configs(dim, **KERNELS[kernel])
    if kernel == "K5":
        assert sim.supports_blocked_frame(obj, pcfg)
    else:
        assert sim.supports_explicit_blocked_frame(obj, pcfg)
    frame = sim.make_frame_fn(obj, pcfg)
    jframe = jsim.make_frame_fn(jobj, jcfg)
    obs = Obstacles.from_configs((), dim, device="cpu")
    jobs = JaxObstacles.from_configs((), dim)
    start = state
    for i in range(3):
        state, aux = frame(state, obs)
        jstate, jaux = jframe(jstate, jobs)
        assert_state_close(state, jstate, what=f"frame {i}")
        got = aux.solver_iterations.numpy()
        ref = np.asarray(jaux.solver_iterations)
        assert np.all(np.abs(got - ref) <= 1), (got, ref)
    for name in convert.INTERNAL_ARRAYS:
        fi = getattr(state, name)
        if fi is not None:
            moved = float((fi - getattr(start, name)).abs().max())
            assert moved > 1e-4, name


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_inelastic_frame_plain_tracks_the_op_composed_frame(kernel):
    """On the CPU the whole frame's plain version and the op-composed
    layered frame compute the same substeps (they sum the layers in another
    order)."""
    obj, state, _, _ = inelastic_pair(2, MATS["both"], seed=12, squash=0.1)
    pcfg, _ = sim_configs(2, **KERNELS[kernel])
    a, _ = sim.make_frame_fn(obj, pcfg)(state, Obstacles.from_configs(
        (), 2, device="cpu"))
    b, _ = sim.make_frame_fn(obj, dataclasses.replace(
        pcfg, frame_backend="auto"))(state, Obstacles.from_configs(
            (), 2, device="cpu"))
    for name in ("pos", "plastic_inv", "viscous_inv"):
        np.testing.assert_allclose(getattr(a, name).numpy(),
                                   getattr(b, name).numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_make_frame_fn_runs_the_whole_frame_kernel_for_inelastic(
        kernel, monkeypatch):
    obj, state, _, _ = inelastic_pair(2, MATS["both"], seed=13)
    pcfg, _ = sim_configs(2, **KERNELS[kernel])
    name = "fused_blocked_frame" if kernel == "K5" else "fused_explicit_frame"
    calls = []
    real = getattr(sim, name)

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(sim, name, spy)
    out, _ = sim.make_frame_fn(obj, pcfg)(state, Obstacles.from_configs(
        (), 2, device="cpu"))
    assert len(calls) == 1
    assert calls[0]["plastic_yield"] == 0.02 and calls[0]["viscous_mu"] == 1e4
    assert calls[0]["plastic_inv"] is state.plastic_inv
    assert out.plastic_inv.shape == state.plastic_inv.shape
    assert not torch.equal(out.viscous_inv, state.viscous_inv)


def test_whole_frame_wrappers_check_the_state_against_the_branches():
    obj, state, _, _ = inelastic_pair(2, MATS["plastic"], seed=14)
    from fem_tpu_torch.ops import frame_kernels as fk

    obs = Obstacles.from_configs((), 2, device="cpu")
    kw = dict(dt=5e-4, damping=8.0, g_dir=(0.0, -1.0), mu=obj.mu,
              s_lambda=obj.s_lambda, sim_count=2)
    with pytest.raises(ValueError, match="plastic_inv"):
        fk.fused_explicit_frame(obj.blocking, state.pos, state.vel, obj.mass,
                                obs.centers, obs.radii, plastic_yield=0.02,
                                **kw)
    out = fk.fused_explicit_frame(obj.blocking, state.pos, state.vel,
                                  obj.mass, obs.centers, obs.radii,
                                  plastic_inv=state.plastic_inv,
                                  plastic_yield=0.02, **kw)
    assert len(out) == 3 and out[2].shape == state.plastic_inv.shape


def test_autodiff_inelastic_runs_the_analytic_layered_gradient():
    """An inelastic autodiff substep equals the explicit one (the JAX
    package's sim.py:116-123): both run the analytic layered chain."""
    obj, state, _, _ = inelastic_pair(2, MATS["both"], seed=15)
    pcfg, _ = sim_configs(2, use_explicit_method=True)
    obs = Obstacles.from_configs((), 2, device="cpu")
    a, _ = sim.substep(obj, state, obs, **sim.substep_kwargs(pcfg))
    b, _ = sim.substep(obj, state, obs, **sim.substep_kwargs(
        dataclasses.replace(pcfg, auto_diff=True)))
    for name in ("pos", "vel", "plastic_inv", "viscous_inv"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def squashed_demo_state(state, seed):
    """A body of demo_plastic.json pressed into the floor: 0.7 down,
    squashed 30 % in y and stretched 20 % in x about its centroid, with
    seeded velocities — its first frames yield."""
    rng = np.random.default_rng(seed)
    pos = state.pos.numpy()
    c = pos.mean(axis=0, keepdims=True)
    pos = c + (pos - c) * np.array([1.2, 0.7]) - np.array([0.0, 0.7])
    vel = rng.uniform(-0.3, 0.3, pos.shape)
    return state.replace(pos=torch.as_tensor(pos.astype(np.float32)),
                         vel=torch.as_tensor(vel.astype(np.float32)))


def test_demo_plastic_implicit_variant_matches_jax(capsys):
    """``demo_plastic.json`` with the implicit CG in normal-equations mode
    (the ``implicit_cg`` golden's overrides) from a squashed state: 3 K5
    plain frames per body against the JAX package's."""
    cfg, bodies, obs = _demo_plastic()
    jcfg = jconfig.read_config(os.path.join(REPO, "configs",
                                            "demo_plastic.json"))
    jbodies, jobs = jscene.load_scene(jcfg)
    capsys.readouterr()
    over = dict(use_explicit_method=False, preconditioned=1,
                frame_backend="blocked")
    cfg = dataclasses.replace(cfg, **over)
    jcfg = dataclasses.replace(jcfg, **over)
    for i, (b, jb) in enumerate(zip(bodies, jbodies)):
        state = squashed_demo_state(b.state, seed=i)
        jstate = jb.state.replace(pos=jnp.asarray(state.pos.numpy()),
                                  vel=jnp.asarray(state.vel.numpy()))
        frame = sim.make_frame_fn(b.obj, cfg)
        jframe = jsim.make_frame_fn(jb.obj, jcfg)
        for k in range(3):
            state, _ = frame(state, obs)
            jstate, _ = jframe(jstate, jobs)
            assert_state_close(state, jstate, what=f"body {i} frame {k}")
        fi = state.plastic_inv if i == 0 else state.viscous_inv
        eye = torch.eye(2).expand_as(fi)
        assert float((fi - eye).abs().max()) > 1e-3, i
