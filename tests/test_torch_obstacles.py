# coding=utf-8
"""The typed SDF obstacles, friction and pins in the port's advection,
against the JAX package on the same numpy inputs: the obstacle arrays, each
SDF piece (half-space, solid box, sphere, the mesh grid's trilinear sample
and normal), the Coulomb slide, the explicit and implicit extension passes,
both advection steps with wall friction, pins and the θ-scheme, the mesh
SDF build on tests/test_obstacles.py's cube, substeps with typed obstacles
in 2D and 3D, and ``configs/demo_ramp.json``'s first 31 frames.

Tolerances: arrays and masks exactly; elementwise pieces 1e-6 absolute
(f32 rounding of sums of a few terms); substeps 1e-5 in positions with equal
CG iterations; demo_ramp's first frame 1e-5 and frame 31 within
tests/test_golden.py's tolerances (mean and std 5e-3, particles 1e-2) of
the JAX run, whose recorded values hold to 1e-5.  The
JAX package goes NaN on that config at frame 37 (ROADMAP F7), so the check
stops at 31."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu import obstacles as jobstacles
from fem_tpu import scene as jscene
from fem_tpu import sim as jsim
from fem_tpu.models.state import Obstacles as JaxObstacles
from fem_tpu.models.state import SimState as JaxSimState
from fem_tpu.solvers import advect as jadvect
from fem_tpu.utils import config as jconfig
from fem_tpu_torch import convert, obstacles, scene, sim
from fem_tpu_torch.models.state import Obstacles, SimState
from fem_tpu_torch.solvers import advect
from fem_tpu_torch.utils import config as pconfig
from tests.test_obstacles import _write_cube_obj
from tests.test_torch_pins import (
    REPO,
    assert_golden,
    assert_states_match,
    bodies,
    configs,
    golden_values,
    run_both,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
OBSTACLES_2D = [
    dict(type="halfspace", point=[0.1, 0.32], normal=[-0.3, 1.0]),
    dict(type="box", lo=[0.55, 0.0], hi=[0.75, 0.33], friction=0.4),
    dict(type="sphere", center=[0.45, 0.3], radius=0.04),
    dict(type="sphere", center=[0.4, 0.32], radius=0.05, friction=0.6),
    dict(type="halfspace", point=[0.0, 0.305], normal=[0.0, 1.0],
         friction=0.5),
]
OBSTACLES_3D = [
    dict(type="halfspace", point=[0.1, 0.32, 0.0], normal=[-0.3, 1.0, 0.2]),
    dict(type="box", lo=[0.55, 0.0, 0.3], hi=[0.75, 0.33, 0.7],
         friction=0.4),
    dict(type="sphere", center=[0.45, 0.3, 0.5], radius=0.05, friction=0.6),
]


def _obstacle_pair(dim, cfgs):
    pcfg, jcfg = configs(dim, obstacles=cfgs)
    return (Obstacles.from_configs(pcfg.blocks, dim, pcfg.obstacles,
                                   device="cpu"),
            JaxObstacles.from_configs(jcfg.blocks, dim, jcfg.obstacles))


@pytest.mark.parametrize("dim", [2, 3])
def test_typed_obstacle_arrays_match_jax(dim):
    obs, jobs = _obstacle_pair(dim, OBSTACLES_2D if dim == 2 else
                               OBSTACLES_3D)
    for name in ("centers", "radii", "half_p", "half_n", "box_lo", "box_hi",
                 "sph_c", "sph_r"):
        got, ref = getattr(obs, name), getattr(jobs, name)
        assert (got is None) == (ref is None), name
        if ref is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref),
                                          err_msg=name)
    for name in ("half_f", "box_f", "sdf_f", "sph_f"):
        assert getattr(obs, name) == getattr(jobs, name), name
    assert obstacles.has_extensions(obs)
    # The JAX package's arrays carry over through convert, and back.
    arrays = {n: np.asarray(getattr(jobs, n))
              for n in convert.OBSTACLE_ARRAYS
              + convert.OPTIONAL_OBSTACLE_ARRAYS
              if getattr(jobs, n) is not None}
    frictions = {n: getattr(jobs, n) for n in convert.OBSTACLE_FRICTIONS}
    conv = convert.obstacles_from_arrays(arrays, frictions, "cpu")
    back, back_f = convert.obstacles_to_arrays(conv)
    assert back.keys() == arrays.keys() and back_f == frictions
    for name, a in arrays.items():
        np.testing.assert_array_equal(back[name], a, err_msg=name)
    # A frictionless sphere folds into the circle arrays.
    assert obs.radii.shape[0] == (2 if dim == 2 else 1)
    with pytest.raises(ValueError, match="friction"):
        _obstacle_pair(dim, [dict(OBSTACLES_2D[0] if dim == 2 else
                                  OBSTACLES_3D[0], friction=-1.0)])


def _cloud(dim, n=400, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 0.8, (n, dim)).astype(np.float32)
    vel = rng.uniform(-1, 1, (n, dim)).astype(np.float32)
    vel_g = rng.uniform(-1, 1, (n, dim)).astype(np.float32)
    return pos, vel, vel_g


@pytest.mark.parametrize("dim", [2, 3])
def test_sdf_pieces_match_jax(dim):
    """φ and the normal of each obstacle class, and the slide with and
    without friction, on a cloud of points around the obstacles."""
    obs, jobs = _obstacle_pair(dim, OBSTACLES_2D if dim == 2 else
                               OBSTACLES_3D)
    pos, vel, _ = _cloud(dim)
    got = list(obstacles._iter_obstacles(obs, torch.as_tensor(pos)))
    ref = list(jobstacles._iter_obstacles(jobs, jnp.asarray(pos)))
    assert len(got) == len(ref) > 2
    hits = 0
    for (phi, n, mu), (jphi, jn, jmu) in zip(got, ref):
        assert mu == jmu
        np.testing.assert_allclose(phi.numpy(), np.asarray(jphi), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(n.numpy(), np.asarray(jn), rtol=0,
                                   atol=1e-6)
        v, hit, _, s = obstacles._slide(torch.as_tensor(vel), phi, n, mu)
        jv, jhit, _, js = jobstacles._slide(jnp.asarray(vel), jphi, jn, mu)
        np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0,
                                   atol=1e-6)
        assert (s is None) == (js is None) == (mu == 0.0)
        hits += int(hit.sum())
    assert hits > 20


def test_sdf_grid_sample_and_normal_match_jax():
    rng = np.random.default_rng(1)
    grid = rng.normal(size=(9, 7, 8)).astype(np.float32)
    origin = np.array([0.1, -0.2, 0.05], np.float32)
    spacing = np.float32(0.07)
    pts = rng.uniform(-0.3, 0.9, (300, 3)).astype(np.float32)
    t = torch.as_tensor
    got = obstacles.sample_sdf_grid(t(grid), t(origin), t(spacing), t(pts))
    ref = jobstacles.sample_sdf_grid(jnp.asarray(grid), jnp.asarray(origin),
                                     jnp.float32(spacing), jnp.asarray(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    phi, n = obstacles._mesh_phi_normal(t(grid), t(origin), t(spacing),
                                        t(pts))
    jphi, jn = jobstacles._mesh_phi_normal(
        jnp.asarray(grid), jnp.asarray(origin), jnp.float32(spacing),
        jnp.asarray(pts))
    np.testing.assert_allclose(phi.numpy(), np.asarray(jphi), atol=1e-6)
    np.testing.assert_allclose(n.numpy(), np.asarray(jn), atol=2e-6)


@pytest.mark.parametrize("dim", [2, 3])
def test_extension_passes_match_jax(dim):
    obs, jobs = _obstacle_pair(dim, OBSTACLES_2D if dim == 2 else
                               OBSTACLES_3D)
    pos, vel, vel_g = _cloud(dim, seed=2)
    t = torch.as_tensor
    v = obstacles.apply_extensions_explicit(t(pos), t(vel), obs)
    jv = jobstacles.apply_extensions_explicit(jnp.asarray(pos),
                                              jnp.asarray(vel), jobs)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    assert np.abs(v.numpy() - vel).max() > 0.1
    out = obstacles.apply_extensions_implicit(t(pos), t(vel + vel_g), t(vel),
                                              t(vel_g), obs)
    jout = jobstacles.apply_extensions_implicit(
        jnp.asarray(pos), jnp.asarray(vel + vel_g), jnp.asarray(vel),
        jnp.asarray(vel_g), jobs)
    for a, b, name in zip(out, jout, ("v", "vel", "vel_g")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-6, err_msg=name)


def _advect_inputs(dim, seed):
    """A cloud with particles past every wall, pins on a fifth of them (a
    moving pin velocity on half of those) and a mass per particle."""
    rng = np.random.default_rng(seed)
    n = 300
    pos = rng.uniform(-0.1, 1.1, (n, dim)).astype(np.float32)
    pos[:100] = rng.uniform(0.2, 0.8, (100, dim)).astype(np.float32)
    vel = rng.uniform(-1, 1, (n, dim)).astype(np.float32)
    vel_g = rng.uniform(-1, 1, (n, dim)).astype(np.float32)
    grad = rng.uniform(-1, 1, (n, dim)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, (n,)).astype(np.float32)
    free = (rng.uniform(size=(n, 1)) > 0.2).astype(np.float32)
    pin_vel = np.where(rng.uniform(size=(n, 1)) > 0.5, 0.0,
                       rng.uniform(-0.5, 0.5, (n, dim))).astype(np.float32)
    pin_vel = pin_vel * (1.0 - free)
    return pos, vel, vel_g, grad, mass, free, pin_vel


@pytest.mark.parametrize("case", [
    (2, "explicit", 0.0, False), (2, "explicit", 0.4, True),
    (3, "explicit", 0.4, True), (2, "implicit", 0.0, False),
    (2, "implicit", 0.4, True), (3, "implicit", 0.4, True),
    (3, "implicit", 0.0, True),
])
def test_advection_steps_match_jax(case):
    """``kinematic_step`` and ``advect_implicit_step`` with circles, the
    typed obstacles, wall friction and pins (static and moving)."""
    dim, method, mu, pins = case
    obs, jobs = _obstacle_pair(dim, OBSTACLES_2D if dim == 2 else
                               OBSTACLES_3D)
    pos, vel, vel_g, grad, mass, free, pin_vel = _advect_inputs(dim, 3)
    t = torch.as_tensor
    dt, damping = 5e-4, 10.0
    g_dir = (0.0, -1.0) if dim == 2 else (0.0, -1.0, 0.0)
    pin_kw = dict(free_mask=t(free), pin_vel=t(pin_vel)) if pins else {}
    jpin_kw = dict(free_mask=jnp.asarray(free),
                   pin_vel=jnp.asarray(pin_vel)) if pins else {}
    z = np.zeros_like(pos)
    state = SimState(pos=t(pos), vel=t(vel), vel_g=t(vel_g), force=t(z))
    jstate = JaxSimState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                         vel_g=jnp.asarray(vel_g), force=jnp.asarray(z),
                         jacobi_past_x=jnp.asarray(z))
    decay = advect.damping_decay(dt, damping)
    gravity = advect.gravity_vector(g_dir, CPU)
    if method == "explicit":
        out = advect.kinematic_step(state, t(grad), t(mass), obs, dt, decay,
                                    gravity, wall_friction=mu, **pin_kw)
        jout = jadvect.kinematic_step(jstate, jnp.asarray(grad),
                                      jnp.asarray(mass), jobs, dt, damping,
                                      g_dir, wall_friction=mu, **jpin_kw)
        names = ("pos", "vel")
    else:
        out = advect.advect_implicit_step(state, obs, dt, decay, gravity,
                                          wall_friction=mu, **pin_kw)
        jout = jadvect.advect_implicit_step(jstate, jobs, dt, damping, g_dir,
                                            wall_friction=mu, **jpin_kw)
        names = ("pos", "vel", "vel_g")
    for name in names:
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(jout, name)), rtol=0,
                                   atol=1e-6, err_msg=name)
    if pins:
        held = free[:, 0] == 0
        np.testing.assert_array_equal(
            out.pos.numpy()[held],
            (t(pos) + t(pin_vel) * dt).numpy()[held])


def test_theta_scheme_matches_jax():
    dim = 2
    obs, jobs = _obstacle_pair(dim, OBSTACLES_2D)
    pos, vel, vel_g, _, _, free, pin_vel = _advect_inputs(dim, 4)
    old = np.random.default_rng(5).uniform(-1, 1, pos.shape).astype(
        np.float32)
    t = torch.as_tensor
    z = np.zeros_like(pos)
    out = advect.advect_implicit_step(
        SimState(pos=t(pos), vel=t(vel), vel_g=t(vel_g), force=t(z)), obs,
        5e-4, advect.damping_decay(5e-4, 3.0),
        advect.gravity_vector((0.0, -1.0), CPU), wall_friction=0.2,
        free_mask=t(free), theta=0.5, vel_pos_old=t(old))
    jout = jadvect.advect_implicit_step(
        JaxSimState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                    vel_g=jnp.asarray(vel_g), force=jnp.asarray(z),
                    jacobi_past_x=jnp.asarray(z)),
        jobs, 5e-4, 3.0, (0.0, -1.0), wall_friction=0.2,
        free_mask=jnp.asarray(free), theta=0.5, vel_pos_old=jnp.asarray(old))
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(jout.pos),
                               rtol=0, atol=1e-6)


def test_mesh_sdf_build_and_sample(tmp_path):
    """The cube of tests/test_obstacles.py: the port's grid equals the JAX
    package's, and a point just inside its top face moving down slides."""
    path = str(tmp_path / "cube.obj")
    _write_cube_obj(path)
    grid, origin, spacing = obstacles.build_mesh_sdf(
        path, scale=1.0, offset=(0.5, 0.5, 0.5), resolution=24)
    jgrid, jorigin, jspacing = jobstacles.build_mesh_sdf(
        path, scale=1.0, offset=(0.5, 0.5, 0.5), resolution=24)
    np.testing.assert_array_equal(grid, jgrid)
    np.testing.assert_array_equal(origin, jorigin)
    assert spacing == jspacing
    pts = torch.tensor([[0.5, 0.5, 0.5], [0.5, 0.5, 1.2], [0.5, 0.5, 0.95]])
    phi = obstacles.sample_sdf_grid(torch.as_tensor(grid),
                                    torch.as_tensor(origin),
                                    torch.tensor(spacing, dtype=torch.float32),
                                    pts).numpy()
    assert phi[0] < -0.3
    assert abs(phi[1] - 0.2) < 2.5 * spacing
    assert phi[2] < 0.0
    cfg = pconfig.parse_config(dict(dim=3, g_dir=[0, -1, 0], obstacles=[dict(
        type="mesh", obj=path, offset=[0.5, 0.5, 0.5], resolution=24)]))
    obs = Obstacles.from_configs((), 3, cfg.obstacles, device="cpu")
    assert obstacles.has_extensions(obs) and obs.sdf_grid.shape[0] == 1
    v2 = obstacles.apply_extensions_explicit(
        torch.tensor([[0.5, 0.5, 0.97]]), torch.tensor([[0.3, 0.1, -1.0]]),
        obs)[0].numpy()
    assert abs(v2[2]) < 0.15
    np.testing.assert_allclose(v2[:2], [0.3, 0.1], atol=0.05)
    with pytest.raises(ValueError, match="3D only"):
        Obstacles.from_configs((), 2, cfg.obstacles, device="cpu")


@pytest.mark.parametrize("case", [
    (2, "explicit", 0.0), (2, "implicit", 0.3), (3, "explicit", 0.3),
    (3, "implicit", 0.0),
])
def test_obstacle_substeps_match_jax(case):
    """Substeps of a body squashed into the typed obstacles, with wall
    friction: explicit and implicit (blocked operator), 2D and 3D."""
    dim, method, mu = case
    over = dict(obstacles=OBSTACLES_2D if dim == 2 else OBSTACLES_3D,
                wall_friction=mu)
    if method == "explicit":
        over.update(use_explicit_method=True, delta_time=1e-4)
    pcfg, jcfg = configs(dim, **over)
    port, jax_side = bodies(pcfg, jcfg, seed=7, squash=1.2)
    port = (port[0], port[1].replace(pos=port[1].pos - 0.05), port[2])
    jstate = jax_side[1]
    jax_side = (jax_side[0], jstate.replace(pos=jstate.pos - 0.05),
                jax_side[2])
    state, jstate, its, jits = run_both(pcfg, jcfg, port, jax_side)
    assert_states_match(state, jstate, its, jits)
    start = port[1].pos.numpy()
    moved = state.pos.numpy() - start
    free_fall = moved.mean(0)
    assert np.abs(moved - free_fall).max() > 1e-5  # something was hit


RAMP = os.path.join(REPO, "configs", "demo_ramp.json")
RAMP_FRAMES = 31
# Recorded from the JAX package on the CPU (31 frames of demo_ramp.json
# through fem_tpu.sim.make_frame_fn; chip_smoke.py holds the card's run to
# them); the test below holds them to the live run.
GOLDEN_RAMP_31 = dict(mean=0.58076754, std=0.23927735,
                      p0=(0.24999997, 0.71153498),
                      p60=(0.34999999, 0.81153518),
                      p120=(0.45000017, 0.91153520))


def test_demo_ramp_first_31_frames_match_jax(capsys):
    """The shipped config (β 2e-3, a tilted half-space and a solid box,
    plain CG) as shipped through ``scene.load_scene`` and
    ``make_frame_fn`` on the CPU against a live JAX run: the first frame
    within 1e-5 with equal iterations, frame 31 within the golden
    tolerances."""
    cfg = pconfig.read_config(RAMP)
    (body,), obs = scene.load_scene(cfg, device="cpu")
    jcfg = jconfig.read_config(RAMP)
    (jb,), jobs = jscene.load_scene(jcfg)
    capsys.readouterr()
    assert body.obj.damping_beta == 2e-3
    assert obs.half_p is not None and obs.box_lo is not None
    assert not sim.supports_blocked_frame(body.obj, cfg)
    frame = sim.make_frame_fn(body.obj, cfg)
    jframe = jsim.make_frame_fn(jb.obj, jcfg)
    s, js = body.state, jb.state
    for i in range(RAMP_FRAMES):
        s, aux = frame(s, obs)
        js, jaux = jframe(js, jobs)
        if i == 0:
            np.testing.assert_allclose(s.pos.numpy(), np.asarray(js.pos),
                                       rtol=0, atol=1e-5)
            assert aux.solver_iterations.tolist() == np.asarray(
                jaux.solver_iterations).tolist()
    assert torch.isfinite(s.pos).all()
    assert_golden(golden_values(js.pos), GOLDEN_RAMP_31, 1e-5, 1e-5)
    assert_golden(golden_values(s.pos.numpy()), GOLDEN_RAMP_31, 5e-3, 1e-2)
    # The checked arc ends as the body reaches the ramp (the JAX run's CG
    # jumps from frame 32 on): every vertex still on the free side of the
    # half-space.
    phi = obstacles._iter_obstacles(obs, s.pos)
    assert float(next(phi)[0].min()) > 0.0
