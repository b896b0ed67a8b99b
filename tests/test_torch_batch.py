# coding=utf-8
"""Batched ensembles (``fem_tpu_torch/batch.py``) against the JAX
package's ``fem_tpu/batch.py``, on the CPU: B = 3 members over 2 frames,
positions within 1e-5 and CG iterations equal; ``perturb_states``
bit-equal to the JAX package's draws."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu import batch as jbatch
from fem_tpu.models.state import Obstacles as JObstacles
from fem_tpu.models.state import build_object as jbuild
from fem_tpu.utils import config as jconfig
from fem_tpu_torch import batch, convert, sim
from fem_tpu_torch.models.mesh import construct_2d_mesh
from fem_tpu_torch.models.state import Obstacles, build_object
from fem_tpu_torch.utils import config as pconfig

torch.set_num_threads(1)

TOL = 1e-5
B = 3
BLOCKS = [dict(id=0, block_center=[0.8, 0.5], block_radius=0.21),
          dict(id=1, block_center=[0.2, 0.5], block_radius=0.21)]


def _scene(sub=4, **over):
    """tests/test_batch.py's square under default.json's circles, in both
    packages from one mesh."""
    data = dict(dim=2, delta_time=5e-4, sim_count=3, auto_diff=False,
                use_explicit_method=True, g_dir=[0, -1], blocks=BLOCKS,
                objects=[dict(center=[0.5, 0.7], side_length=0.2,
                              subdivisions=sub)])
    data.update(over)
    pcfg, jcfg = pconfig.parse_config(data), jconfig.parse_config(data)
    mesh = construct_2d_mesh(pcfg.objects[0])
    jobj, jstate = jbuild(jcfg.objects[0], *mesh)
    obj, state = build_object(pcfg.objects[0], *mesh, device="cpu")
    return (pcfg, obj, state, Obstacles.from_configs(pcfg.blocks, 2,
                                                     device="cpu"),
            jcfg, jobj, jstate, JObstacles.from_configs(jcfg.blocks, 2))


def _to_port(jstates):
    """A batched JAX state through ``convert`` (the leading B axis kept)."""
    return convert.state_from_arrays(
        {n: np.asarray(getattr(jstates, n)) for n in convert.STATE_ARRAYS
         if getattr(jstates, n, None) is not None}, "cpu")


def _run(frame, states, obs, frames=2):
    for _ in range(frames):
        states, aux = frame(states, obs)
    return states, aux


def _assert_batch_close(states, jstates, aux, jaux):
    assert states.pos.shape[0] == B
    np.testing.assert_allclose(states.pos.numpy(), np.asarray(jstates.pos),
                               rtol=0, atol=TOL)
    assert tuple(aux.solver_iterations.shape) == tuple(
        np.asarray(jaux.solver_iterations).shape)
    np.testing.assert_array_equal(aux.solver_iterations.numpy(),
                                  np.asarray(jaux.solver_iterations))


def test_perturb_states_bit_equal():
    pcfg, obj, state, obs, jcfg, jobj, jstate, jobs = _scene()
    got = batch.perturb_states(state, 8, scale=1e-4, seed=3)
    ref = jbatch.perturb_states(jstate, 8, scale=1e-4, seed=3)
    assert got.pos.shape == (8,) + tuple(state.pos.shape)
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(ref.pos))
    np.testing.assert_array_equal(_to_port(ref).pos.numpy(),
                                  got.pos.numpy())
    np.testing.assert_array_equal(
        batch.broadcast_state(state, 2).vel.numpy(),
        np.asarray(jbatch.broadcast_state(jstate, 2).vel))


@pytest.mark.parametrize("method", [
    dict(), dict(auto_diff=True),
    dict(use_explicit_method=False, implicit_method=1, preconditioned=1,
         sub=3)])
def test_shared_obstacles_match_jax(method):
    """A perturbed ensemble under shared obstacles: explicit, autodiff and
    the implicit CG ensemble (tests/test_batch.py's
    ``test_batched_implicit_cg``)."""
    method = dict(method)
    sub = method.pop("sub", 4)
    pcfg, obj, state, obs, jcfg, jobj, jstate, jobs = _scene(sub, **method)
    jstates = jbatch.perturb_states(jstate, B, scale=1e-3, seed=1)
    jout, jaux = _run(jbatch.make_batched_frame_fn(jobj, jcfg), jstates,
                      jobs)
    out, aux = _run(batch.make_batched_frame_fn(obj, pcfg),
                    _to_port(jstates), obs)
    _assert_batch_close(out, jout, aux, jaux)
    # Each member equals its own single run.
    single = sim.make_frame_fn(obj, pcfg)
    member = convert.state_from_arrays(
        {n: np.asarray(getattr(jstates, n))[1] for n in ("pos", "vel",
                                                           "vel_g", "force")},
        "cpu")
    member, _ = _run(single, member, obs)
    assert torch.equal(member.pos, out.pos[1])


def test_per_sample_obstacles_match_jax():
    """Obstacle layouts per member (``centers`` (B, nb, d)): each member
    under its own circles."""
    pcfg, obj, state, obs, jcfg, jobj, jstate, jobs = _scene()
    shift = np.asarray([[[0.0, 0.0]], [[0.05, 0.1]], [[-0.1, 0.15]]],
                       np.float32)
    centers = np.asarray(obs.centers)[None] + shift
    radii = np.broadcast_to(np.asarray(obs.radii), (B, 2)).copy()
    jobs_b = dataclasses.replace(jobs, centers=jnp.asarray(centers),
                                 radii=jnp.asarray(radii))
    obs_b = dataclasses.replace(obs, centers=torch.tensor(centers),
                                radii=torch.tensor(radii))
    jstates = jbatch.broadcast_state(jstate, B)
    jout, jaux = _run(jbatch.make_batched_frame_fn(jobj, jcfg), jstates,
                      jobs_b, frames=4)
    out, aux = _run(batch.make_batched_frame_fn(obj, pcfg),
                    _to_port(jstates), obs_b, frames=4)
    _assert_batch_close(out, jout, aux, jaux)
    assert float((out.pos[0] - out.pos[2]).abs().max()) > 0.0


def test_sharded_batch_is_refused():
    """``make_sharded_batched_frame_fn`` runs (ROADMAP M20, ported): on a
    one-rank mesh here (gloo on the CPU) its members are those of
    ``make_batched_frame_fn``, bit for bit, and those of the JAX package's
    batched frame within 1e-5 with equal iterations."""
    from fem_tpu_torch.parallel.sharding import make_element_mesh

    pcfg, obj, state, obs, jcfg, jobj, jstate, jobs = _scene()
    jstates = jbatch.perturb_states(jstate, B, scale=1e-3, seed=1)
    states = _to_port(jstates)
    sharded = batch.make_sharded_batched_frame_fn(
        obj, pcfg, make_element_mesh(device="cpu"))
    out, aux = _run(sharded, states, obs)
    ref, ref_aux = _run(batch.make_batched_frame_fn(obj, pcfg), states, obs)
    assert torch.equal(out.pos, ref.pos) and torch.equal(out.vel, ref.vel)
    assert torch.equal(aux.solver_iterations, ref_aux.solver_iterations)
    jout, jaux = _run(jbatch.make_batched_frame_fn(jobj, jcfg), jstates, jobs)
    _assert_batch_close(out, jout, aux, jaux)
