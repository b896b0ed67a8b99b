# coding=utf-8
"""K10a and K10b, the fused advection steps: their plain versions (what the
wrappers run on CPU tensors) against the JAX package's Pallas kernels
``kinematic_pallas`` and ``advect_implicit_pallas`` in interpret mode, 2D
and 3D, with circles — a radius-0 one included — and particles past every
wall; the ``backend="pallas"`` advection steps, pins included, against the
JAX package's; and the errors of that backend.

Tolerances: 1e-6 absolute (the same f32 formulas; sums of 2-3 terms may
round in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu.models.state import Obstacles as JaxObstacles
from fem_tpu.models.state import SimState as JaxSimState
from fem_tpu.ops.pallas_advect import advect_implicit_pallas, kinematic_pallas
from fem_tpu.solvers import advect as jadvect
from fem_tpu_torch.models.state import Obstacles, SimState
from fem_tpu_torch.ops import advect_kernels
from fem_tpu_torch.solvers import advect
from tests.test_torch_obstacles import OBSTACLES_2D, _obstacle_pair

torch.set_num_threads(1)

CPU = torch.device("cpu")
DT, DAMP = 5e-4, 10.0


def _case(dim, seed):
    """Particles in and around the unit box, a third of them inside three
    overlapping circles (one of radius 0), random velocities, gradients and
    masses."""
    rng = np.random.default_rng(seed)
    n = 240
    pos = rng.uniform(-0.1, 1.1, (n, dim)).astype(np.float32)
    centers = rng.uniform(0.3, 0.7, (3, dim)).astype(np.float32)
    radii = np.array([0.2, 0.15, 0.0], np.float32)
    pos[:80] = (centers[rng.integers(0, 2, 80)]
                + rng.uniform(-0.12, 0.12, (80, dim))).astype(np.float32)
    vel = rng.normal(scale=0.5, size=(n, dim)).astype(np.float32)
    vel_g = rng.normal(scale=0.5, size=(n, dim)).astype(np.float32)
    grad = rng.normal(scale=10.0, size=(n, dim)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, (n,)).astype(np.float32)
    return pos, vel, vel_g, grad, mass, centers, radii


def _g(dim):
    return (0.0, -1.0) if dim == 2 else (0.0, -1.0, 0.0)


@pytest.mark.parametrize("dim", [2, 3])
def test_kinematic_plain_matches_pallas(dim):
    pos, vel, _, grad, mass, centers, radii = _case(dim, dim)
    t = torch.as_tensor
    got = advect_kernels.kinematic(
        t(pos), t(vel), t(grad), 1.0 / t(mass), t(centers), t(radii), dt=DT,
        decay=advect.damping_decay(DT, DAMP),
        gravity=advect.gravity_vector(_g(dim), CPU))
    ref = kinematic_pallas(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(grad),
        (1.0 / jnp.asarray(mass))[:, None], jnp.asarray(centers),
        jnp.asarray(radii)[None, :], dt=DT, damping=DAMP, g_dir=_g(dim),
        interpret=True)
    for a, b, name in zip(got, ref, ("pos", "vel")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6, err_msg=name)
    # Circles and walls both acted.
    free = (vel + ((np.array(_g(dim)) * 9.8) - grad / mass[:, None]) * DT)
    assert np.abs(got[1].numpy() - free * advect.damping_decay(DT, DAMP)
                  ).max() > 0.1
    assert advect_kernels.kinematic.launches == 0  # the CPU runs no kernel


@pytest.mark.parametrize("dim", [2, 3])
def test_advect_implicit_plain_matches_pallas(dim):
    pos, vel, vel_g, _, _, centers, radii = _case(dim, 10 + dim)
    t = torch.as_tensor
    got = advect_kernels.advect_implicit(
        t(pos), t(vel), t(vel_g), t(centers), t(radii), dt=DT,
        decay=advect.damping_decay(DT, DAMP),
        gravity=advect.gravity_vector(_g(dim), CPU))
    ref = advect_implicit_pallas(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(vel_g),
        jnp.asarray(centers), jnp.asarray(radii)[None, :], dt=DT,
        damping=DAMP, g_dir=_g(dim), interpret=True)
    for a, b, name in zip(got, ref, ("pos", "vel", "vel_g")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6, err_msg=name)
    # The upper-wall quirk: vel zeroed there, vel_g kept.
    up = (pos > 1.0) & ((vel + vel_g) > 0.0)
    assert up.any()
    assert np.all(got[1].numpy()[up] == 0.0)
    assert advect_kernels.advect_implicit.launches == 0


@pytest.mark.parametrize("case", [
    (2, "explicit", False), (3, "explicit", True), (2, "implicit", True),
    (3, "implicit", False),
])
def test_pallas_backend_steps_match_jax(case):
    """``kinematic_step`` and ``advect_implicit_step`` with
    ``backend="pallas"`` (pins applied after the kernel) against the JAX
    package's same steps."""
    dim, method, pins = case
    pos, vel, vel_g, grad, mass, centers, radii = _case(dim, 20 + dim)
    rng = np.random.default_rng(30 + dim)
    free = (rng.uniform(size=(pos.shape[0], 1)) > 0.3).astype(np.float32)
    pin_vel = (rng.uniform(-0.5, 0.5, pos.shape) * (1.0 - free)).astype(
        np.float32)
    t = torch.as_tensor
    z = np.zeros_like(pos)
    state = SimState(pos=t(pos), vel=t(vel), vel_g=t(vel_g), force=t(z))
    jstate = JaxSimState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                         vel_g=jnp.asarray(vel_g), force=jnp.asarray(z),
                         jacobi_past_x=jnp.asarray(z))
    obs = Obstacles(centers=t(centers), radii=t(radii))
    jobs = JaxObstacles(centers=jnp.asarray(centers), radii=jnp.asarray(radii))
    kw = dict(free_mask=t(free), pin_vel=t(pin_vel)) if pins else {}
    jkw = dict(free_mask=jnp.asarray(free),
               pin_vel=jnp.asarray(pin_vel)) if pins else {}
    decay = advect.damping_decay(DT, DAMP)
    gravity = advect.gravity_vector(_g(dim), CPU)
    if method == "explicit":
        out = advect.kinematic_step(state, t(grad), t(mass), obs, DT, decay,
                                    gravity, backend="pallas", **kw)
        jout = jadvect.kinematic_step(jstate, jnp.asarray(grad),
                                      jnp.asarray(mass), jobs, DT, DAMP,
                                      _g(dim), "pallas", **jkw)
        names = ("pos", "vel", "force")
    else:
        out = advect.advect_implicit_step(state, obs, DT, decay, gravity,
                                          backend="pallas", **kw)
        jout = jadvect.advect_implicit_step(jstate, jobs, DT, DAMP, _g(dim),
                                            "pallas", **jkw)
        names = ("pos", "vel", "vel_g")
    for name in names:
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(jout, name)), rtol=0,
                                   atol=1e-6, err_msg=name)
    # The XLA backend gives the same step up to K10b's multiplied 1/|d|².
    xla = (advect.kinematic_step(state, t(grad), t(mass), obs, DT, decay,
                                 gravity, inv_mass=1.0 / t(mass), **kw)
           if method == "explicit" else
           advect.advect_implicit_step(state, obs, DT, decay, gravity, **kw))
    np.testing.assert_allclose(xla.pos.numpy(), out.pos.numpy(), rtol=0,
                               atol=1e-6)


def test_pallas_backend_rejects_what_the_kernels_lack():
    """``backend="pallas"`` takes circles only: typed obstacles, wall
    friction and the θ-scheme raise, as in the JAX package; an unknown
    backend raises."""
    obs, _ = _obstacle_pair(2, OBSTACLES_2D[:1])
    plain, _ = _obstacle_pair(2, [])
    pos, vel, vel_g, grad, mass, _, _ = _case(2, 40)
    t = torch.as_tensor
    state = SimState(pos=t(pos), vel=t(vel), vel_g=t(vel_g), force=t(vel))
    g = advect.gravity_vector((0.0, -1.0), CPU)
    for o, mu, theta in ((obs, 0.0, 1.0), (plain, 0.3, 1.0),
                         (plain, 0.0, 0.5)):
        with pytest.raises(ValueError, match="backend='xla'"):
            advect.advect_implicit_step(state, o, DT, 1.0, g,
                                        backend="pallas", wall_friction=mu,
                                        theta=theta, vel_pos_old=t(vel))
        if theta == 1.0:
            with pytest.raises(ValueError, match="backend='xla'"):
                advect.kinematic_step(state, t(grad), t(mass), o, DT, 1.0, g,
                                      backend="pallas", wall_friction=mu)
    for step in (
        lambda: advect.kinematic_step(state, t(grad), t(mass), plain, DT, 1.0,
                                      g, backend="triton"),
        lambda: advect.advect_implicit_step(state, plain, DT, 1.0, g,
                                            backend="triton"),
    ):
        with pytest.raises(ValueError, match="unknown advection backend"):
            step()
