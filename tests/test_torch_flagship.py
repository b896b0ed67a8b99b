# coding=utf-8
"""The flagship itself, ``configs/demo_spot.json`` (1,007 particles, 4,068
tets, 17 locality blocks, 10 substeps a frame, the reference CG in
normal-equations mode), held to the JAX package on the CPU.

(a) Three frames from ``entry.deformed``: the port's
``frame_backend="blocked"`` (K5's plain frame) against the JAX package's
``make_frame_fn`` with the same backend (its ``_frame_kernel`` in interpret
mode).  (b) One substep of ``entry.entry(device="cpu")`` (K1's and K4's
plain versions) against the substep of ``__graft_entry__.entry()``,
imported and not edited, run as the JAX package's own CPU tests run it
(its Pallas kernels in interpret mode, jitted on the CPU).

Both packages start from the JAX package's flagship arrays (the mesh, the
rest state and the obstacles), handed to the port through
``fem_tpu_torch.convert``; the port's ``entry.deformed`` must deform that
state as ``__graft_entry__.entry`` does.  Tolerances: CG iterations equal
in every substep (these solves take at most a few iterations, where f32
round-off does not move the count), positions within 1e-5 after each
frame and velocities within 1e-5 after the substep."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from fem_tpu import sim as jsim
from fem_tpu_torch import convert, entry, sim
from fem_tpu_torch.models.state import Obstacles

torch.set_num_threads(1)

FRAMES = 3
TOL = 1e-5


def _to_port(jobj, jstate, jobs):
    arrays = {n: np.asarray(getattr(jobj, n)) for n in convert.OBJECT_ARRAYS}
    statics = {n: getattr(jobj, n) for n in convert.OBJECT_STATICS}
    obj = convert.object_from_arrays(arrays, statics, "cpu")
    state = convert.state_from_arrays(
        {n: np.asarray(getattr(jstate, n)) for n in convert.STATE_ARRAYS},
        "cpu")
    obs = Obstacles(torch.tensor(np.asarray(jobs.centers)),
                    torch.tensor(np.asarray(jobs.radii)))
    return obj, state, obs


@pytest.fixture(scope="module")
def graft_entry():
    """``__graft_entry__.entry()``: its substep and its deformed flagship."""
    return graft.entry()


@pytest.fixture(scope="module")
def flagship(graft_entry):
    """(JAX cfg, JAX obj, the JAX deformed state, JAX obstacles, the port's
    cfg, obj, deformed state, obstacles)."""
    jcfg, jobj, jstate0, jobs = graft._flagship()
    _, (_, jstate, _) = graft_entry
    obj, state0, obs = _to_port(jobj, jstate0, jobs)
    state = entry.deformed(state0)
    # The port's deformation is the JAX entry's.
    np.testing.assert_allclose(state.pos.numpy(), np.asarray(jstate.pos),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(state.vel.numpy(), np.asarray(jstate.vel))
    cfg, _, _, _ = entry.flagship("cpu")
    assert (obj.particle_cnt, obj.element_cnt) == (1007, 4068)
    assert obj.blocking.num_blocks == 17
    return jcfg, jobj, jstate, jobs, cfg, obj, state, obs


def test_flagship_blocked_frames_match_jax(flagship):
    jcfg, jobj, jstate, jobs, cfg, obj, state, obs = flagship
    jcfg = dataclasses.replace(jcfg, frame_backend="blocked")
    cfg = dataclasses.replace(cfg, frame_backend="blocked")
    assert sim.supports_blocked_frame(obj, cfg)
    assert jsim.supports_blocked_frame(jobj, jcfg)
    frame = sim.make_frame_fn(obj, cfg)
    jframe = jsim.make_frame_fn(jobj, jcfg)
    # jstate carries the deformed positions as the graft entry computed them;
    # the port's deformed state is within 1e-6 of them (fixture).
    jstate = jstate.replace(pos=jax.numpy.asarray(state.pos.numpy()))
    most = 0
    for i in range(FRAMES):
        state, aux = frame(state, obs)
        jstate, jaux = jframe(jstate, jobs)
        got = aux.solver_iterations.numpy()
        ref = np.asarray(jaux.solver_iterations)
        assert got.shape == ref.shape == (cfg.sim_count,)
        np.testing.assert_array_equal(got, ref, err_msg=f"frame {i}")
        np.testing.assert_allclose(state.pos.numpy(), np.asarray(jstate.pos),
                                   rtol=0, atol=TOL, err_msg=f"frame {i}")
        most = max(most, int(got.max()))
    assert most > 0
    assert torch.isfinite(state.pos).all()


def test_flagship_entry_substep_matches_the_graft_entry(graft_entry):
    """One substep of the port's entry (K1 + K4's plain path) against
    ``__graft_entry__.entry()``'s, jitted on the CPU, on the same arrays:
    equal iterations, velocities and positions within 1e-5.  The port's
    entry deforms the flagship as the graft entry does up to the f32
    rounding of the centroid (positions within 1.2e-7), which the stiff
    deformed body's solve amplifies to ~1.4e-5 in a few velocities; so the
    port's substep runs on the graft entry's arrays, handed over through
    ``convert``, as every parity test of the port does."""
    jfn, (jobj, jstate, jobs) = graft_entry
    jnext, jaux = jax.jit(jfn)(jobj, jstate, jobs)
    fn, (_, state, _) = entry.entry(device="cpu")
    np.testing.assert_allclose(state.pos.numpy(), np.asarray(jstate.pos),
                               rtol=0, atol=1e-6)
    obj, state, obs = _to_port(jobj, jstate, jobs)
    nxt, aux = fn(obj, state, obs)
    assert int(aux.solver_iterations) == int(jaux.solver_iterations)
    assert int(aux.solver_iterations) > 0
    for name in ("vel", "pos"):
        np.testing.assert_allclose(
            getattr(nxt, name).numpy(), np.asarray(getattr(jnext, name)),
            rtol=0, atol=TOL, err_msg=name)
