# coding=utf-8
"""K5, the whole frame — its plain PyTorch version on the CPU — against the
JAX package's whole-frame Pallas kernel (``make_frame_fn`` with
``frame_backend="blocked"``, interpret mode) on the same arrays, and the
port's frame dispatch.

Tolerances: positions atol 1e-5 after each frame of 5 substeps; CG
iterations within 1 per substep, which is sound only in short solves, so the
test also asserts that the solves stay at 20 iterations or fewer (PERF.md,
PR 1: over ~140 iterations f32 round-off alone moves the count by more)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu import sim as jsim
from fem_tpu.models.state import Obstacles as JaxObstacles
from fem_tpu.models.state import build_object as jax_build_object
from fem_tpu.utils import config as jconfig
from fem_tpu_torch import convert, sim
from fem_tpu_torch.models.state import Obstacles
from fem_tpu_torch.utils import config as pconfig
from tests.test_blocked import _cube_mesh
from tests.test_torch_sim import _bodies

torch.set_num_threads(1)


def _configs(**over):
    data = dict(
        dim=3, delta_time=5e-4, sim_count=5, auto_diff=False,
        use_explicit_method=False, implicit_method=1, preconditioned=1,
        g_dir=[0, -1, 0],
        # One circle inside the body, one of radius 0 (never hits).
        blocks=[dict(id=0, block_center=[0.85, 0.2, 0.45], block_radius=0.1),
                dict(id=1, block_center=[0.8, 0.1, 0.4], block_radius=0.0)],
        frame_backend="blocked",
    )
    data.update(over)
    return pconfig.parse_config(data), jconfig.parse_config(data)


def _scene(seed):
    """The Delaunay cube of tests/test_blocked_frame.py, placed across the
    floor (y < 0) and the x = 1 wall, deformed and moving with numpy noise,
    in both packages."""
    pcfg, jcfg = _configs()
    nodes, f, tets = _cube_mesh(spacing=0.45)
    ocfg = jconfig.ObjectConfig(obj="cube", center=(0.7, -0.02, 0.3),
                                rho=1000.0, E=4e5, nu=0.3, damping=10.0)
    jobj, jstate = jax_build_object(ocfg, (nodes * 0.35).astype(np.float32),
                                    f, tets)
    assert jobj.blocking is not None and jobj.blocking.s_dense is not None
    arrays = {n: np.asarray(getattr(jobj, n)) for n in convert.OBJECT_ARRAYS}
    statics = {n: getattr(jobj, n) for n in convert.OBJECT_STATICS}
    obj = convert.object_from_arrays(arrays, statics, "cpu")
    rng = np.random.default_rng(seed)
    pos = np.asarray(jstate.pos)
    pos = (pos + rng.uniform(-0.004, 0.004, pos.shape)).astype(np.float32)
    vel = rng.uniform(-0.3, 0.3, pos.shape).astype(np.float32)
    vel[:, 0] += 0.3
    vel[:, 1] -= 0.5
    jstate = jstate.replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel))
    state = convert.state_from_arrays(
        {n: np.asarray(getattr(jstate, n)) for n in convert.STATE_ARRAYS},
        "cpu",
    )
    jobs = JaxObstacles.from_configs(jcfg.blocks, 3)
    obs = Obstacles.from_configs(pcfg.blocks, 3, device="cpu")
    # Every quirk of the advection is reached: the floor, the x = 1 wall
    # and the circle.
    assert (pos[:, 1] < 0).sum() > 0 and (pos[:, 0] > 1).sum() > 0
    assert (np.linalg.norm(pos - [0.85, 0.2, 0.45], axis=1) < 0.1).sum() > 0
    return pcfg, jcfg, obj, state, obs, jobj, jstate, jobs


@pytest.mark.parametrize("preconditioned", [1, 0])
def test_blocked_frame_plain_matches_jax(preconditioned):
    pcfg, jcfg, obj, state, obs, jobj, jstate, jobs = _scene(seed=0)
    pcfg = dataclasses.replace(pcfg, preconditioned=preconditioned)
    jcfg = dataclasses.replace(jcfg, preconditioned=preconditioned)
    assert sim.supports_blocked_frame(obj, pcfg)
    assert jsim.supports_blocked_frame(jobj, jcfg)
    frame = sim.make_frame_fn(obj, pcfg)
    jframe = jsim.make_frame_fn(jobj, jcfg)
    most = 0
    for i in range(3):
        state, aux = frame(state, obs)
        jstate, jaux = jframe(jstate, jobs)
        np.testing.assert_allclose(state.pos.numpy(), np.asarray(jstate.pos),
                                   rtol=0, atol=1e-5, err_msg=f"frame {i}")
        np.testing.assert_allclose(
            state.vel.numpy() + state.vel_g.numpy(),
            np.asarray(jstate.vel) + np.asarray(jstate.vel_g), rtol=0,
            atol=2e-3, err_msg=f"frame {i}")
        got = aux.solver_iterations.numpy()
        ref = np.asarray(jaux.solver_iterations)
        assert aux.solver_iterations.dtype == torch.int32
        assert got.shape == ref.shape == (pcfg.sim_count,)
        assert np.all(np.abs(got - ref) <= 1), (i, got, ref)
        assert ref.max() <= 20, ref
        assert float(aux.solver_residual.max()) <= 1e-5
        most = max(most, int(got.max()))
    assert torch.isfinite(state.pos).all()
    assert most > 1


def test_whole_frame_and_blocked_operator_frame_agree_on_the_cpu():
    """On the CPU the whole frame's plain version runs the same plain K2,
    K3 and advection as the op-composed frame with the blocked operator:
    bit-identical results."""
    pcfg, _, obj, state, obs, _, _, _ = _scene(seed=1)
    a, aux_a = sim.make_frame_fn(obj, pcfg)(state, obs)
    op_cfg = dataclasses.replace(pcfg, frame_backend="auto",
                                 operator_mode="blocked")
    b, aux_b = sim.make_frame_fn(obj, op_cfg)(state, obs)
    for name in ("pos", "vel", "vel_g"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert torch.equal(aux_a.solver_iterations, aux_b.solver_iterations)


def _spy(monkeypatch):
    calls = []
    real = sim.fused_blocked_frame

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(sim, "fused_blocked_frame", spy)
    return calls


def test_make_frame_fn_picks_the_whole_frame_kernel(monkeypatch):
    pcfg, _, obj, state, obs, _, _, _ = _scene(seed=2)
    calls = _spy(monkeypatch)
    sim.make_frame_fn(obj, pcfg)(state, obs)
    assert len(calls) == 1
    # "auto" runs it on a CUDA object only; this one lies on the CPU.
    sim.make_frame_fn(obj, dataclasses.replace(pcfg, frame_backend="auto"))(
        state, obs)
    assert len(calls) == 1


@pytest.mark.parametrize("over", [
    dict(implicit_method=0),
    dict(operator_mode="graph"),
    dict(operator_mode="blocked"),
    dict(cg_precond="block_jacobi"),
    dict(use_explicit_method=True),
])
def test_blocked_frame_rejects_ineligible_configs(over):
    pcfg, _, obj, _, _, _, _, _ = _scene(seed=3)
    cfg = dataclasses.replace(pcfg, **over)
    assert not sim.supports_blocked_frame(obj, cfg)
    with pytest.raises(ValueError):
        sim.make_frame_fn(obj, cfg)


@pytest.mark.parametrize("backend", ["fused", "blocked_explicit"])
def test_unported_frame_backends_raise(backend, monkeypatch):
    """Both backends are ported: ``"fused"`` (K11b) runs the unblocked
    whole frame's plain version once a frame, and ``"blocked_explicit"``
    (K8) on an explicit config K8's plain version once a frame."""
    pcfg, _, obj, state, obs, _, _, _ = _scene(seed=4)
    cfg = dataclasses.replace(pcfg, frame_backend=backend)
    if backend == "fused":
        from fem_tpu_torch.experiments import fused_frame as ff

        calls = []
        real = ff.fused_frame

        def spy_fused(*args, **kwargs):
            calls.append(1)
            return real(*args, **kwargs)

        monkeypatch.setattr(ff, "fused_frame", spy_fused)
        frame = sim.make_frame_fn(obj, cfg)
        s = state
        for i in range(2):
            s, aux = frame(s, obs)
            assert len(calls) == i + 1
        assert torch.isfinite(s.pos).all() and not torch.equal(s.pos,
                                                               state.pos)
        assert aux.solver_iterations.shape == (cfg.sim_count,)
        return
    calls = []
    real = sim.fused_explicit_frame

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(sim, "fused_explicit_frame", spy)
    cfg = dataclasses.replace(cfg, use_explicit_method=True)
    out, aux = sim.make_frame_fn(obj, cfg)(state, obs)
    assert len(calls) == 1
    assert torch.isfinite(out.pos).all() and not torch.equal(out.pos, state.pos)
    assert aux.solver_iterations.shape == (cfg.sim_count,)


def test_cg_fast_math_has_no_counterpart():
    pcfg, _, obj, _, _, _, _, _ = _scene(seed=5)
    with pytest.raises(NotImplementedError, match="bf16"):
        sim.make_frame_fn(obj, dataclasses.replace(pcfg, cg_fast_math=True))


def test_blocked_frame_is_3d_only():
    """Named when K5 took 3D only.  It now takes 2D too, as the JAX
    package's does (its sim.py:283): a 2D config is eligible, and on the
    CPU "blocked" runs K5's plain frame, which is bit-identical to the
    op-composed frame over the blocked operator."""
    pcfg, _, obj, state, obs, _, _, _ = _bodies(2, seed=0)
    cfg = dataclasses.replace(pcfg, frame_backend="blocked")
    assert obj.dim == 2 and sim.supports_blocked_frame(obj, cfg)
    a, aux_a = sim.make_frame_fn(obj, cfg)(state, obs)
    op_cfg = dataclasses.replace(pcfg, operator_mode="blocked")
    b, aux_b = sim.make_frame_fn(obj, op_cfg)(state, obs)
    for name in ("pos", "vel", "vel_g"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert torch.equal(aux_a.solver_iterations, aux_b.solver_iterations)
    assert int(aux_a.solver_iterations.max()) > 1
