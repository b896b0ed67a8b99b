# coding=utf-8
"""Pins and loads through the port, against the JAX package on the same
numpy inputs: the ``free_mask``/``pin_vel``/``static_load`` arrays of
``build_object``, the CG dispatch (plain, normal equations, block-Jacobi,
the pin projection with and without ``pin_vel``), pinned and loaded
substeps of the explicit and implicit methods in 2D and 3D (the implicit
ones over the blocked operator, as both packages take it on the CPU), and
``configs/demo_hanging.json``'s 200-frame arc.

Tolerances: the arrays exactly; a solve 1e-5 relative in x with equal
iterations; substeps 1e-5 in positions, velocities 2e-3 (as
tests/test_torch_sim.py), CG iterations equal (short solves); the 200-frame
arc within tests/test_golden.py's tolerances (mean and std 5e-3, particles
1e-2), the recorded values within 1e-5 of the live JAX run."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu import scene as jscene
from fem_tpu import sim as jsim
from fem_tpu.models.state import Obstacles as JaxObstacles
from fem_tpu.models.state import build_object as jax_build_object
from fem_tpu.solvers import implicit as jimplicit
from fem_tpu.utils import config as jconfig
from fem_tpu_torch import convert, scene, sim
from fem_tpu_torch.models import mesh as pmesh
from fem_tpu_torch.models.state import Obstacles, build_object
from fem_tpu_torch.ops import cg_kernels
from fem_tpu_torch.solvers import implicit
from fem_tpu_torch.utils import config as pconfig

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def configs(dim, obj_over=None, **over):
    """The same small config in both packages (parsed twice): a 2D square
    of 6 subdivisions or a 3D cube of 3, a circle overlapping it."""
    if dim == 3:
        data = dict(
            dim=3, delta_time=5e-4, sim_count=10, auto_diff=False,
            use_explicit_method=False, implicit_method=1, preconditioned=0,
            g_dir=[0, -1, 0],
            objects=[dict(center=[0.4, 0.3, 0.4], E=4e5, nu=0.3, rho=1000,
                          damping=10, subdivisions=3, side_length=0.2)],
            blocks=[dict(id=0, block_center=[0.45, 0.2, 0.5],
                         block_radius=0.08)],
        )
    else:
        data = dict(
            dim=2, delta_time=5e-4, sim_count=10, auto_diff=False,
            use_explicit_method=False, implicit_method=1, preconditioned=0,
            g_dir=[0, -1],
            objects=[dict(center=[0.4, 0.3], E=4e4, nu=0.2, rho=500,
                          damping=14.5, subdivisions=6, side_length=0.2)],
            blocks=[dict(id=0, block_center=[0.5, 0.2], block_radius=0.08)],
        )
    data["objects"][0].update(obj_over or {})
    data.update(over)
    return pconfig.parse_config(data), jconfig.parse_config(data)


def bodies(pcfg, jcfg, seed=None, squash=1.1):
    """(obj, state, obstacles) in the port on the CPU and in the JAX
    package, from one mesh: the JAX package builds the object, the port
    converts its arrays; with ``seed`` the state is squashed and moved with
    the same numpy noise so that the solve iterates."""
    ocfg = pcfg.objects[0]
    if pcfg.dim == 3:
        v, f, t = pmesh.construct_3d_grid_mesh(ocfg)
    else:
        v, f, t = pmesh.construct_2d_mesh(ocfg)
    jobj, jstate = jax_build_object(jcfg.objects[0], v, f, t)
    names = convert.OBJECT_ARRAYS + convert.OPTIONAL_OBJECT_ARRAYS
    arrays = {n: None if getattr(jobj, n) is None
              else np.asarray(getattr(jobj, n)) for n in names}
    statics = {n: getattr(jobj, n) for n in convert.OBJECT_STATICS}
    obj = convert.object_from_arrays(arrays, statics, "cpu")
    if seed is not None:
        rng = np.random.default_rng(seed)
        pos = np.asarray(jstate.pos)
        c = pos.mean(axis=0, keepdims=True)
        pos = (c + (pos - c) * squash
               + rng.uniform(-0.002, 0.002, pos.shape)).astype(np.float32)
        vel = rng.uniform(-0.3, 0.3, pos.shape).astype(np.float32)
        jstate = jstate.replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel))
    state = convert.state_from_arrays(
        {n: np.asarray(getattr(jstate, n))
         for n in convert.STATE_ARRAYS + convert.INTERNAL_ARRAYS
         if getattr(jstate, n) is not None}, "cpu")
    jobs = JaxObstacles.from_configs(jcfg.blocks, pcfg.dim, jcfg.obstacles)
    obs = Obstacles.from_configs(pcfg.blocks, pcfg.dim, pcfg.obstacles,
                                 device="cpu")
    return (obj, state, obs), (jobj, jstate, jobs)


def run_both(pcfg, jcfg, port, jax_side, substeps=4):
    """``substeps`` substeps in both packages; returns the end states and
    each package's iterations."""
    obj, state, obs = port
    jobj, jstate, jobs = jax_side
    kw = sim.substep_kwargs(pcfg)
    jstep = jsim.make_substep_fn(jobj, jcfg)
    its, jits = [], []
    for _ in range(substeps):
        state, aux = sim.substep(obj, state, obs, **kw)
        jstate, jaux = jstep(jstate, jobs)
        its.append(int(aux.solver_iterations))
        jits.append(int(jaux.solver_iterations))
    return state, jstate, its, jits


def assert_states_match(state, jstate, its, jits):
    np.testing.assert_allclose(state.pos.numpy(), np.asarray(jstate.pos),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        state.vel.numpy() + state.vel_g.numpy(),
        np.asarray(jstate.vel) + np.asarray(jstate.vel_g), rtol=0, atol=2e-3)
    assert its == jits, (its, jits)


# The bodies span [0.4, 0.6] × [0.3, 0.5] (× [0.4, 0.6]): a static pin box
# across the top, a moving one on the left face, a load box at the lower
# right.
PIN_2D = [[[0.35, 0.49], [0.65, 0.51]],
          [[0.39, 0.29], [0.41, 0.45], [0.0, 0.3]]]
LOAD_2D = [[[0.55, 0.29], [0.61, 0.4], [0.5, -2.0]]]
PIN_3D = [[[0.35, 0.49, 0.35], [0.65, 0.51, 0.65]]]
MOVING_3D = [[[0.39, 0.29, 0.35], [0.41, 0.45, 0.65], [0.1, 0.0, 0.05]]]
LOAD_3D = [[[0.55, 0.29, 0.39], [0.61, 0.4, 0.61], [0.0, -5.0, 1.0]]]


@pytest.mark.parametrize("dim", [2, 3])
def test_pin_and_load_arrays_match_jax(dim):
    pins, loads = (PIN_2D, LOAD_2D) if dim == 2 else (
        PIN_3D + MOVING_3D,
        LOAD_3D)
    pcfg, jcfg = configs(dim, dict(pin_boxes=pins, load_boxes=loads))
    (obj, _, _), (jobj, _, _) = bodies(pcfg, jcfg)
    for name in ("free_mask", "pin_vel", "static_load"):
        np.testing.assert_array_equal(getattr(obj, name).numpy(),
                                      np.asarray(getattr(jobj, name)),
                                      err_msg=name)
    assert 0 < int((obj.free_mask == 0).sum()) < obj.particle_cnt
    # Loads spread each box's total force over its vertices by mass.
    np.testing.assert_allclose(obj.static_load.sum(0).numpy(), loads[0][2],
                               rtol=1e-5)
    # Only static pins: no pin_vel.
    pcfg, _ = configs(dim, dict(pin_boxes=pins[:1]))
    ocfg = pcfg.objects[0]
    mesh = (pmesh.construct_2d_mesh(ocfg) if dim == 2
            else pmesh.construct_3d_grid_mesh(ocfg))
    obj, _ = build_object(ocfg, *mesh, device="cpu")
    assert obj.free_mask is not None and obj.pin_vel is None
    assert obj.static_load is None


def test_load_box_selecting_nothing_raises():
    pcfg, _ = configs(2, dict(load_boxes=[[[5, 5], [6, 6], [0, 1]]]))
    with pytest.raises(ValueError, match="selects no vertices"):
        build_object(pcfg.objects[0], *pmesh.construct_2d_mesh(
            pcfg.objects[0]), device="cpu")


def _operator_case():
    """A 3D object's K at a squashed state in both packages, with a moving
    pin box: (obj, jobj, K, b) — K and b numpy."""
    pcfg, jcfg = configs(3, dict(pin_boxes=PIN_3D + MOVING_3D))
    (obj, state, _), (jobj, jstate, _) = bodies(pcfg, jcfg, seed=3,
                                                squash=1.3)
    K = np.asarray(jimplicit.hessian_blocks(
        jstate.pos, jobj.element_indices, jobj.ref_inv, jobj.volume, jobj.mu,
        jobj.s_lambda))
    b = np.asarray(jimplicit.implicit_rhs(jobj, jstate, 5e-4))
    return obj, jobj, K, b


@pytest.mark.parametrize("mode", [
    ("reference", 0, False, False), ("reference", 1, False, False),
    ("none", 1, True, False), ("block_jacobi", 0, True, False),
    ("reference", 0, True, True), ("reference", 1, True, True),
    ("block_jacobi", 0, True, True),
])
def test_cg_solve_dispatch_matches_jax(mode):
    """The dispatch over the graph operator with β, in each mode, with and
    without the pin projection and with ``pin_vel``."""
    cg_precond, pre, pins, moving = mode
    obj, jobj, K, b = _operator_case()
    dt, beta = 5e-4, 2e-3
    t = torch.as_tensor(K)
    apply_a = implicit.make_system_apply(obj, t, dt, beta)
    apply_at = implicit.make_system_apply_t(obj, t, dt, beta)
    jK = jnp.asarray(K)
    japply_a = jimplicit.make_system_apply(jobj, jK, dt, beta=beta)
    japply_at = jimplicit.make_system_apply_t(jobj, jK, dt, beta=beta)
    free = obj.free_mask if pins else None
    pin_vel = obj.pin_vel if moving else None
    res = cg_kernels.cg_solve_dispatch(
        apply_a, lambda: apply_at, torch.as_tensor(b), pre, cg_precond,
        lambda: implicit.diagonal_blocks(obj, t, dt, beta), obj.mass, free,
        pin_vel)
    jres = jimplicit._cg_solve_dispatch(
        japply_a, lambda: japply_at, jnp.asarray(b), pre, cg_precond,
        lambda: jimplicit.diagonal_blocks(jobj, jK, dt, beta=beta), jobj.mass,
        free=None if free is None else jobj.free_mask,
        pin_vel=None if pin_vel is None else jobj.pin_vel)
    x, jx = res.x.numpy(), np.asarray(jres.x)
    np.testing.assert_allclose(x, jx, rtol=1e-5,
                               atol=1e-5 * np.abs(jx).max())
    assert int(res.iterations) == int(jres.iterations) > 0
    if pins:
        held = obj.free_mask.numpy()[:, 0] == 0
        want = obj.pin_vel.numpy()[held] if moving else 0.0
        np.testing.assert_allclose(x[held], want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("case", [
    (2, False, "graph"), (2, True, "auto"), (3, False, "auto"),
    (3, True, "auto"), (3, False, "graph"),
])
def test_pinned_loaded_substeps_match_jax(case):
    """Substeps with a static and a moving pin box and a load box: the
    explicit method, and the implicit one over the blocked operator
    ("auto", blocks) and the graph operator; 2D and 3D."""
    dim, explicit, mode = case
    pins, loads = (PIN_2D, LOAD_2D) if dim == 2 else (
        PIN_3D + MOVING_3D,
        LOAD_3D)
    over = dict(operator_mode=mode)
    if explicit:
        over.update(use_explicit_method=True, delta_time=1e-4)
    pcfg, jcfg = configs(dim, dict(pin_boxes=pins, load_boxes=loads), **over)
    port, jax_side = bodies(pcfg, jcfg, seed=dim)
    state, jstate, its, jits = run_both(pcfg, jcfg, port, jax_side)
    assert_states_match(state, jstate, its, jits)
    obj, start, _ = port
    held = obj.free_mask.numpy()[:, 0] == 0
    moved = start.pos.numpy() + 4 * pcfg.delta_time * obj.pin_vel.numpy()
    np.testing.assert_allclose(state.pos.numpy()[held], moved[held], rtol=0,
                               atol=1e-6)
    if not explicit:
        assert max(its) > 0


@pytest.mark.parametrize("change", [
    "pins", "loads", "beta", "halfspace", "wall_friction", "exact_jvp",
    "block_jacobi",
])
def test_whole_frame_kernels_not_eligible(change):
    """Neither whole-frame kernel implements pins, loads, β, typed
    obstacles, wall friction, the exact Hessian or block-Jacobi, so both
    predicates are false and ``make_frame_fn`` runs the op-composed frame
    (on a CUDA object too)."""
    obj_over, over = {}, {}
    if change == "pins":
        obj_over = dict(pin_boxes=PIN_3D)
    elif change == "loads":
        obj_over = dict(load_boxes=LOAD_3D)
    elif change == "beta":
        obj_over = dict(damping_beta=2e-3)
    elif change == "halfspace":
        over = dict(obstacles=[dict(type="halfspace", point=[0, 0.1, 0],
                                    normal=[0, 1, 0])])
    elif change == "wall_friction":
        over = dict(wall_friction=0.3)
    else:
        over = {"hessian" if change == "exact_jvp" else "cg_precond": change}
    pcfg, _ = configs(3, obj_over, **over)
    ocfg = pcfg.objects[0]
    obj, _ = build_object(ocfg, *pmesh.construct_3d_grid_mesh(ocfg),
                          device="cpu")
    base, _ = configs(3)
    # The plain config on the same object is eligible unless the change is
    # the object's.
    assert sim.supports_blocked_frame(obj, base) == (not obj_over)
    assert not sim.supports_blocked_frame(obj, pcfg)
    explicit = dataclasses.replace(pcfg, use_explicit_method=True)
    explicit_ok = change in ("exact_jvp", "block_jacobi")
    assert sim.supports_explicit_blocked_frame(obj, explicit) == explicit_ok
    with pytest.raises(ValueError, match="not eligible"):
        sim.make_frame_fn(obj, dataclasses.replace(pcfg,
                                                   frame_backend="blocked"))


# Recorded from the JAX package on the CPU (200 frames of
# configs/demo_hanging.json through fem_tpu.sim.make_frame_fn);
# test_demo_hanging_golden_is_the_jax_run holds them to a live run.
GOLDEN_HANGING = dict(mean=0.54870546, std=0.07990864,
                      p0=(0.40102217, 0.49494788),
                      p60=(0.50076079, 0.59617370),
                      p120=(0.60000002, 0.69999999))
GOLDEN_FRAMES = 200
HANGING = os.path.join(REPO, "configs", "demo_hanging.json")


def golden_values(pos):
    pos = np.asarray(pos, np.float64)
    return dict(mean=float(pos.mean()), std=float(pos.std()),
                p0=tuple(pos[0]), p60=tuple(pos[60]), p120=tuple(pos[120]))


def assert_golden(got, golden, tol_mean, tol_particle):
    for key in ("mean", "std"):
        assert abs(got[key] - golden[key]) < tol_mean, key
    for key in ("p0", "p60", "p120"):
        np.testing.assert_allclose(got[key], golden[key], atol=tol_particle,
                                   err_msg=key)


def test_demo_hanging_golden_is_the_jax_run(capsys):
    jcfg = jconfig.read_config(HANGING)
    (jb,), jobs = jscene.load_scene(jcfg)
    capsys.readouterr()
    frame = jsim.make_frame_fn(jb.obj, jcfg)
    s = jb.state
    for _ in range(GOLDEN_FRAMES):
        s, _ = frame(s, jobs)
    assert_golden(golden_values(s.pos), GOLDEN_HANGING, 1e-5, 1e-5)


def test_demo_hanging_through_the_port(capsys):
    """The shipped config (a pin box across the top, plain CG) as shipped
    through ``scene.load_scene`` and ``make_frame_fn`` on the CPU: the
    first frame equal to the JAX package's with equal iterations, the
    pinned vertices at their start positions exactly, and the 200-frame arc
    on the JAX package's values."""
    cfg = pconfig.read_config(HANGING)
    (body,), obs = scene.load_scene(cfg, device="cpu")
    jcfg = jconfig.read_config(HANGING)
    (jb,), jobs = jscene.load_scene(jcfg)
    capsys.readouterr()
    obj = body.obj
    assert (obj.particle_cnt, obj.element_cnt) == (121, 200)
    assert not sim.supports_blocked_frame(obj, cfg)
    held = obj.free_mask.numpy()[:, 0] == 0
    assert held.sum() == 11
    frame = sim.make_frame_fn(obj, cfg)
    s, aux = frame(body.state, obs)
    js, jaux = jsim.make_frame_fn(jb.obj, jcfg)(jb.state, jobs)
    np.testing.assert_allclose(s.pos.numpy(), np.asarray(js.pos), rtol=0,
                               atol=1e-5)
    assert aux.solver_iterations.tolist() == np.asarray(
        jaux.solver_iterations).tolist()
    for _ in range(GOLDEN_FRAMES - 1):
        s, aux = frame(s, obs)
    assert torch.isfinite(s.pos).all()
    assert torch.equal(s.pos[held], body.state.pos[held])
    assert_golden(golden_values(s.pos.numpy()), GOLDEN_HANGING, 5e-3, 1e-2)
