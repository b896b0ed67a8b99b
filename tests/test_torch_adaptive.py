# coding=utf-8
"""The adaptive-dt κ-guard (``fem_tpu_torch/solvers/adaptive.py`` and the
guarded frame and substep of ``sim.py``) against the JAX package's, on the
CPU: the four cases of tests/test_adaptive_dt.py, each against the JAX
function, and the guard composed with K5's plain frame.

Tolerances: κ within 1e-5 relative (with and without a locality
blocking); split levels equal; the benign guarded substep bit-equal to the
unguarded one; guarded frames' positions within 1e-5 of the JAX package's
and their iterations, summed over each outer substep's inner steps,
within 1 an inner step.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu import sim as jsim
from fem_tpu.solvers import adaptive as jadaptive
from fem_tpu_torch import sim
from fem_tpu_torch.solvers import adaptive
from tests.test_torch_2d import DEFAULT_BLOCKS, _both, _configs

torch.set_num_threads(1)

TOL = 1e-5
THRESHOLD = 0.5


def _scene(subdivisions=5, dt=5e-4, vel_shift=0.0, vel_noise=0.0, **obj):
    """tests/test_adaptive_dt.py's square (tests/utils.make_2d_object) under
    default.json's two circles, in both packages from one mesh; velocities
    shifted by ``vel_shift`` and noised (numpy, seed 0) by ``vel_noise``."""
    body = dict(center=[0.5, 0.8], side_length=0.2, subdivisions=subdivisions,
                **obj)
    pcfg, jcfg = _configs(body, DEFAULT_BLOCKS, delta_time=dt)
    rng = np.random.default_rng(0)

    def move(p, v):
        return p, (v + vel_shift + rng.normal(scale=vel_noise, size=v.shape)
                   ).astype(np.float32)

    return _both(pcfg, jcfg, move)


def _kappas(obj, state, jobj, jstate, dt):
    return (float(adaptive.kappa_estimate(obj, state.pos, dt)),
            float(jadaptive.kappa_estimate(jobj, jstate.pos, dt)))


@pytest.mark.parametrize("blocked", [True, False])
def test_kappa_matches_jax_and_scales_with_dt_squared(blocked):
    """κ through K2's plain version (a blocking) and through
    ``hessian_blocks`` (none), at rest and squashed, against the JAX
    package's; κ(2·dt) = 4·κ(dt)."""
    pcfg, jcfg, obj, state, obs, jobj, jstate, jobs = _scene()
    if not blocked:
        obj = dataclasses.replace(obj, blocking=None)
        jobj = jobj.replace(blocking=None)
    assert (obj.blocking is None) == (jobj.blocking is None) == (not blocked)
    c = state.pos.mean(dim=0, keepdim=True)
    squashed = c + (state.pos - c) * torch.tensor([[1.15, 0.7]])
    for pos in (state.pos, squashed):
        jpos = jstate.replace(pos=jnp.asarray(pos.numpy()))
        for dt in (5e-4, 1e-3):
            k, jk = _kappas(obj, state.replace(pos=pos), jobj, jpos, dt)
            assert k > 0.0
            np.testing.assert_allclose(k, jk, rtol=TOL)
    k1, _ = _kappas(obj, state, jobj, jstate, 5e-4)
    k2, _ = _kappas(obj, state, jobj, jstate, 1e-3)
    np.testing.assert_allclose(k2, 4.0 * k1, rtol=TOL)


def test_split_level_ladder_matches_jax():
    """tests/test_adaptive_dt.py's ladder, then a sweep of κ over seven
    decades through both functions."""
    for kappa, level in ((0.1, 0), (0.5, 0), (1.9, 1), (7.9, 2), (31.0, 3),
                         (1e6, 3)):
        assert int(adaptive.split_level(torch.tensor(kappa), THRESHOLD)) \
            == level
    for kappa in np.geomspace(1e-3, 1e4, 57).astype(np.float32):
        assert int(adaptive.split_level(torch.tensor(kappa), THRESHOLD)) == \
            int(jadaptive.split_level(jnp.float32(kappa), THRESHOLD)), kappa


def test_guarded_substep_identical_when_benign():
    """κ below the threshold: the guard runs one inner step at dt,
    bit-equal to the unguarded substep, with one host read of the level;
    within 1e-5 of the JAX package's guarded substep, iterations equal."""
    pcfg, jcfg, obj, state, obs, jobj, jstate, jobs = _scene(vel_shift=0.2)
    dt = 5e-4
    assert _kappas(obj, state, jobj, jstate, dt)[0] < THRESHOLD
    guarded = dataclasses.replace(pcfg, adaptive_dt=True)
    s_plain, aux_p = sim.make_substep_fn(obj, pcfg)(state, obs)
    reads = adaptive.read_level.reads
    s_guard, aux_g = sim.make_substep_fn(obj, guarded)(state, obs)
    assert adaptive.read_level.reads == reads + 1
    assert torch.equal(s_guard.pos, s_plain.pos)
    assert torch.equal(s_guard.vel, s_plain.vel)
    assert int(aux_g.solver_iterations) == int(aux_p.solver_iterations)
    js, jaux = jsim.make_substep_fn(
        jobj, dataclasses.replace(jcfg, adaptive_dt=True))(jstate, jobs)
    np.testing.assert_allclose(s_guard.pos.numpy(), np.asarray(js.pos),
                               rtol=0, atol=TOL)
    assert int(aux_g.solver_iterations) == int(jaux.solver_iterations)


def _level(split, kappa):
    return int(split(kappa, THRESHOLD))


def test_guard_rescues_the_stiff_reproducer():
    """tests/test_adaptive_dt.py's reproducer (7 subdivisions, E 4e5, dt
    2e-3, κ₀ > 1): unguarded, the port goes non-finite within 8 frames, as
    the JAX package does; guarded, it stays finite past that frame, at the
    JAX run's split level in every frame, and its first frame is within
    1e-5 of the JAX package's.

    The start state's velocities carry numpy noise of 1e-4: at rest the
    port's elastic forces are exactly zero, so its unguarded run stays at
    rest (0 CG iterations), while the JAX package's rest forces carry
    round-off that the unstable integrator amplifies (its CG takes 3-76
    iterations a substep in the first frame).  The noise seeds both."""
    dt = 2e-3
    pcfg, jcfg, obj, state0, obs, jobj, jstate0, jobs = _scene(
        subdivisions=7, dt=dt, vel_noise=1e-4, E=4e5)
    assert _kappas(obj, state0, jobj, jstate0, dt)[0] > 1.0

    def nan_frame(frame, s, o):
        for i in range(8):
            s, _ = frame(s, o)
            if not np.isfinite(np.asarray(s.pos)).all():
                return i
        return None

    port_nan = nan_frame(sim.make_frame_fn(obj, pcfg), state0, obs)
    jax_nan = nan_frame(jsim.make_frame_fn(jobj, jcfg), jstate0, jobs)
    assert jax_nan is not None and port_nan is not None

    gframe = sim.make_frame_fn(obj, dataclasses.replace(pcfg,
                                                        adaptive_dt=True))
    jgframe = jsim.make_frame_fn(jobj, dataclasses.replace(jcfg,
                                                           adaptive_dt=True))
    s, js = state0, jstate0
    for i in range(max(port_nan, jax_nan) + 1):
        level = _level(adaptive.split_level,
                       adaptive.kappa_estimate(obj, s.pos, dt))
        jlevel = _level(jadaptive.split_level,
                        jadaptive.kappa_estimate(jobj, js.pos, dt))
        assert level == jlevel, i
        s, aux = gframe(s, obs)
        js, jaux = jgframe(js, jobs)
        assert torch.isfinite(s.pos).all() and torch.isfinite(s.vel).all()
        assert aux.solver_iterations.shape == (pcfg.sim_count,)
        if i == 0:
            assert level > 0
            np.testing.assert_allclose(s.pos.numpy(), np.asarray(js.pos),
                                       rtol=0, atol=TOL)


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_blocked_guarded_frame_matches_jax(level):
    """default.json's implicit-CG variant (``frame_backend="blocked"``:
    K2's and K5's plain versions) from a squashed, moving state, the level
    forced through ``adaptive_dt_threshold``: one frame at sim_count·n
    substeps of dt/n against the JAX package's op-composed guarded frame;
    positions within 1e-5, iterations within 1 an inner step."""
    dt = 5e-4
    pcfg, jcfg, obj, state, obs, jobj, jstate, jobs = _scene(
        subdivisions=10, dt=dt, E=4e4, nu=0.2, rho=500, damping=14.5)
    c = state.pos.mean(dim=0, keepdim=True)
    pos = c + (state.pos - c) * torch.tensor([[1.15, 0.7]])
    vel = torch.full_like(state.vel, -0.05)
    state = state.replace(pos=pos, vel=vel)
    jstate = jstate.replace(pos=jnp.asarray(pos.numpy()),
                            vel=jnp.asarray(vel.numpy()))
    kappa, _ = _kappas(obj, state, jobj, jstate, dt)
    # κ/θ of 0.5, 2, 8 and 32: inside each level's (4^(l-1), 4^l].
    threshold = kappa / (0.5 * 4.0 ** level)
    cfg = dataclasses.replace(pcfg, adaptive_dt=True,
                              adaptive_dt_threshold=threshold,
                              frame_backend="blocked")
    jcfg_g = dataclasses.replace(jcfg, adaptive_dt=True,
                                 adaptive_dt_threshold=threshold)
    n = adaptive.LEVELS[level]
    assert int(adaptive.split_level(torch.tensor(kappa), threshold)) == level
    s, aux = sim.make_frame_fn(obj, cfg)(state, obs)
    js, jaux = jsim.make_frame_fn(jobj, jcfg_g)(jstate, jobs)
    np.testing.assert_allclose(s.pos.numpy(), np.asarray(js.pos), rtol=0,
                               atol=TOL)
    it, jit = aux.solver_iterations.numpy(), np.asarray(jaux.solver_iterations)
    assert it.shape == jit.shape == (pcfg.sim_count,)
    assert aux.solver_iterations.dtype == torch.int32
    assert np.abs(it - jit).max() <= n, (it, jit)
    assert it.sum() > 0
