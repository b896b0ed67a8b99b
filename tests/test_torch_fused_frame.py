# coding=utf-8
"""K11b, the unblocked whole frame (``frame_backend="fused"``) — its plain
version on the CPU — against the JAX package's fused frame (interpret mode)
on tests/test_pallas_frame.py's two scenes, against the port's own K5
frame, and the frame dispatch's gates.

Tolerances: positions and ``vel_g`` atol 1e-5 after every frame, CG
iterations equal substep by substep (short solves of a few iterations),
and each substep's final ‖r‖² within 5e-7 absolute of the JAX one's (both
below the 1e-5 tolerance, where two summation orders of a converged
residual differ in their last digits).  Against the port's K5 frame
(another operator order: locality blocks), positions atol 1e-5 and
iterations within 1."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from fem_tpu.models.state import Obstacles as JaxObstacles
from fem_tpu.sim import make_frame_fn as jax_make_frame_fn
from fem_tpu.utils import config as jconfig
from fem_tpu_torch import convert, scene, sim
from fem_tpu_torch.experiments import fused_frame as ff
from fem_tpu_torch.models.state import Obstacles, build_object
from fem_tpu_torch.utils import config as pconfig
from tests.utils import make_2d_object, two_tet_object

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(jobj, jstate):
    arrays = {n: np.asarray(getattr(jobj, n)) for n in convert.OBJECT_ARRAYS}
    statics = {n: getattr(jobj, n) for n in convert.OBJECT_STATICS}
    obj = convert.object_from_arrays(arrays, statics, "cpu")
    state = convert.state_from_arrays(
        {n: np.asarray(getattr(jstate, n)) for n in convert.STATE_ARRAYS},
        "cpu")
    return obj, state


def _moving(jstate, seed=3):
    """``jstate`` deformed (±0.01) and moving (±0.5) with numpy noise."""
    rng = np.random.default_rng(seed)
    shape = tuple(jstate.pos.shape)
    return jstate.replace(
        pos=jstate.pos + rng.uniform(-0.01, 0.01, shape).astype(np.float32),
        vel=jstate.vel + rng.uniform(-0.5, 0.5, shape).astype(np.float32))


def _scene_3d(precond, moving=False):
    """tests/test_pallas_frame.py's 3D scene: the two-tet body lifted by
    0.05, 4 substeps, no circles.  From rest its CG converges at x₀ = b, so
    ``moving`` runs the two tets stiffer (E 4e5), scaled by 0.2 about the
    origin, moved to 0.3 and deformed and moving: 3-5 iterations a
    substep."""
    if moving:
        _, jobj, jstate = two_tet_object(rho=800.0, E=4e5, nu=0.3,
                                         damping=10.0)
        jstate = _moving(jstate.replace(
            pos=jstate.pos * np.float32(0.2) + np.float32(0.3)))
    else:
        _, jobj, jstate = two_tet_object(rho=800.0, E=4e4, nu=0.3,
                                         damping=10.0)
        jstate = jstate.replace(pos=jstate.pos + np.float32(0.05))
    cfg = dict(dim=3, delta_time=5e-4, sim_count=4, auto_diff=False,
               use_explicit_method=False, implicit_method=1,
               preconditioned=precond, g_dir=(0.0, -1.0, 0.0))
    jcfg = jconfig.SimConfig(**cfg, objects=(jconfig.ObjectConfig(
        center=(0.45, 0.25, 0.45), rho=800.0, E=4e4, nu=0.3, damping=10.0),),
        blocks=())
    pcfg = pconfig.SimConfig(**cfg, objects=(pconfig.ObjectConfig(
        center=(0.45, 0.25, 0.45), rho=800.0, E=4e4, nu=0.3, damping=10.0),),
        blocks=())
    obj, state = _port(jobj, jstate)
    return (pcfg, obj, state, Obstacles.from_configs((), 3, device="cpu"),
            jcfg, jobj, jstate, JaxObstacles.from_configs((), 3))


def _scene_2d(moving=False):
    """tests/test_pallas_frame.py's 2D scene: 3 subdivisions, one circle,
    5 substeps; ``moving`` with E 4e5, deformed and moving."""
    over = dict(E=4e5) if moving else {}
    jocfg, jobj, jstate = make_2d_object(subdivisions=3, center=(0.45, 0.55),
                                         **over)
    if moving:
        jstate = _moving(jstate)
    cfg = dict(dim=2, delta_time=5e-4, sim_count=5, auto_diff=False,
               use_explicit_method=False, implicit_method=1, preconditioned=1)
    jblocks = (jconfig.BlockConfig(block_center=(0.5, 0.35),
                                   block_radius=0.15),)
    pblocks = (pconfig.BlockConfig(block_center=(0.5, 0.35),
                                   block_radius=0.15),)
    jcfg = jconfig.SimConfig(**cfg, objects=(jocfg,), blocks=jblocks)
    pcfg = pconfig.SimConfig(**cfg, objects=(pconfig.ObjectConfig(
        center=(0.45, 0.55), subdivisions=3, **over),), blocks=pblocks)
    obj, state = _port(jobj, jstate)
    return (pcfg, obj, state, Obstacles.from_configs(pblocks, 2, device="cpu"),
            jcfg, jobj, jstate, JaxObstacles.from_configs(jblocks, 2))


def _compare_with_jax(scene_, frames, iterates=True):
    pcfg, obj, state, obs, jcfg, jobj, jstate, jobs = scene_
    pcfg = dataclasses.replace(pcfg, frame_backend="fused")
    jcfg = dataclasses.replace(jcfg, frame_backend="fused")
    frame = sim.make_frame_fn(obj, pcfg)
    jframe = jax_make_frame_fn(jobj, jcfg)
    most = 0
    for i in range(frames):
        state, aux = frame(state, obs)
        jstate, jaux = jframe(jstate, jobs)
        np.testing.assert_allclose(state.pos.numpy(), np.asarray(jstate.pos),
                                   rtol=0, atol=1e-5, err_msg=f"frame {i}")
        np.testing.assert_allclose(state.vel_g.numpy(),
                                   np.asarray(jstate.vel_g), rtol=0,
                                   atol=1e-5, err_msg=f"frame {i}")
        assert aux.solver_iterations.dtype == torch.int32
        assert aux.solver_iterations.tolist() == np.asarray(
            jaux.solver_iterations).tolist(), i
        np.testing.assert_allclose(aux.solver_residual.numpy(),
                                   np.asarray(jaux.solver_residual), rtol=0,
                                   atol=5e-7, err_msg=f"frame {i}")
        most = max(most, int(aux.solver_iterations.max()))
    assert torch.isfinite(state.pos).all()
    assert (most > 0) == iterates


@pytest.mark.parametrize("moving", [False, True], ids=["at rest", "moving"])
@pytest.mark.parametrize("precond", [1, 0], ids=["precond", "plain"])
def test_fused_frame_matches_jax_3d(precond, moving):
    _compare_with_jax(_scene_3d(precond, moving), frames=5, iterates=moving)


@pytest.mark.parametrize("moving", [False, True], ids=["at rest", "moving"])
def test_fused_frame_matches_jax_2d_with_a_circle(moving):
    _compare_with_jax(_scene_2d(moving), frames=8, iterates=moving)


@pytest.mark.parametrize("which", ["3d", "2d"])
def test_fused_frame_matches_the_blocked_frame(which):
    """The port's K11b and K5 plain frames on the same moving state: the
    same semantics over the unblocked and the blocked operator."""
    pcfg, obj, state, obs = (_scene_3d(1, True) if which == "3d"
                             else _scene_2d(True))[:4]
    fused = sim.make_frame_fn(obj, dataclasses.replace(
        pcfg, frame_backend="fused"))
    blocked = sim.make_frame_fn(obj, dataclasses.replace(
        pcfg, frame_backend="blocked"))
    a, b = state, state
    for i in range(4):
        a, aux_a = fused(a, obs)
        b, aux_b = blocked(b, obs)
        np.testing.assert_allclose(a.pos.numpy(), b.pos.numpy(), rtol=0,
                                   atol=1e-5, err_msg=f"frame {i}")
        assert np.all(np.abs(aux_a.solver_iterations.numpy()
                             - aux_b.solver_iterations.numpy()) <= 1)


def _gate_object(**over):
    ocfg = pconfig.ObjectConfig(center=(0.3, 0.3, 0.3), **over)
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1]],
                     np.float32) * 0.2
    tets = np.array([[0, 1, 2, 3], [1, 2, 3, 4]], np.int32)
    obj, state = build_object(ocfg, verts, np.zeros((0, 3), np.int32), tets,
                              device="cpu")
    cfg = pconfig.SimConfig(dim=3, auto_diff=False, use_explicit_method=False,
                            implicit_method=1, g_dir=(0.0, -1.0, 0.0),
                            objects=(ocfg,), frame_backend="fused")
    return obj, cfg


# Each semantic gate of the JAX package's supports_fused_frame
# (tests/test_pallas_frame.py's test_fused_frame_eligibility_gates checks
# the first four), and those the port adds for what the kernel leaves out.
GATES = {
    "implicit_method=0": (dict(), dict(implicit_method=0)),
    "explicit": (dict(), dict(use_explicit_method=True)),
    "robust": (dict(), dict(robust_inversion=True)),
    "exact_jvp": (dict(), dict(hessian="exact_jvp")),
    "auto_diff": (dict(), dict(auto_diff=True)),
    "stvk": (dict(material="stvk"), dict()),
    "plastic": (dict(plastic_yield=0.01), dict()),
    "viscous": (dict(viscous_mu=1.0), dict()),
    "pins": (dict(pin_boxes=(((0.0, 0.0, 0.0), (1.0, 0.1, 1.0)),)), dict()),
    "loads": (dict(load_boxes=(((0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
                                (0.0, -1.0, 0.0)),)), dict()),
    "beta": (dict(damping_beta=1e-3), dict()),
    "halfspace": (dict(), dict(obstacles=(pconfig.ObstacleConfig(
        type="halfspace", point=(0.0, 0.0, 0.0), normal=(0.0, 1.0, 0.0)),))),
    "wall_friction": (dict(), dict(wall_friction=0.3)),
    "block_jacobi": (dict(), dict(cg_precond="block_jacobi")),
    "sim_count=129": (dict(), dict(sim_count=129)),
}


@pytest.mark.parametrize("gate", list(GATES))
def test_fused_frame_eligibility_gates(gate):
    base_obj, base_cfg = _gate_object()
    assert ff.supports_fused_frame(base_obj, base_cfg)
    assert callable(sim.make_frame_fn(base_obj, base_cfg))
    obj_over, cfg_over = GATES[gate]
    obj, cfg = _gate_object(**obj_over)
    objects = tuple(dataclasses.replace(o, **obj_over) for o in cfg.objects)
    cfg = dataclasses.replace(cfg, objects=objects, **cfg_over)
    assert not ff.supports_fused_frame(obj, cfg)
    with pytest.raises(ValueError, match="fused"):
        sim.make_frame_fn(obj, cfg)


def test_load_scene_reaches_the_fused_frame(monkeypatch):
    """``configs/default.json`` with the implicit CG and
    ``"frame_backend": "fused"``: ``scene.load_scene`` builds the body and
    its frame function runs K11b (here its plain version) once a frame."""
    with open(os.path.join(REPO, "configs", "default.json")) as fh:
        data = json.load(fh)
    data.update(auto_diff=False, use_explicit_method=False, implicit_method=1,
                preconditioned=1, frame_backend="fused")
    cfg = pconfig.parse_config(data)
    bodies, obs = scene.load_scene(cfg, device="cpu")
    calls = []
    real = ff.fused_frame

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(ff, "fused_frame", spy)
    frame = sim.make_frame_fn(bodies[0].obj, cfg)
    state = bodies[0].state
    for i in range(2):
        state, aux = frame(state, obs)
        assert len(calls) == i + 1
    assert aux.solver_iterations.shape == (cfg.sim_count,)
    assert torch.isfinite(state.pos).all()
