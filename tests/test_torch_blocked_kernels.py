# coding=utf-8
"""K2 (blocked prep) and K3 (blocked operator) — their plain PyTorch
versions on the CPU — against the JAX package's Pallas kernels in interpret
mode on the same blocking and the same numpy inputs, and the blocked
implicit substep (``operator_mode="blocked"``) against the JAX package's.

Tolerances: K blocks 1e-5 block-relative and force partials 1e-5 of their
largest entry (the same chain, with the JAX package's one-hot dots summing
in another order); G(K)·x 1e-5 of its largest entry; the substep as in
tests/test_torch_sim.py (positions 1e-5, CG iterations within 1)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu import sim as jsim
from fem_tpu.ops import blocking as jblocking
from fem_tpu_torch import sim
from fem_tpu_torch.ops import blocked_kernels, blocking
from tests.test_torch_sim import _assert_matches, _bodies

torch.set_num_threads(1)

CAPS = dict(eb=32, pb=24)


@pytest.fixture(scope="module")
def bodies():
    """The 3D grid body of tests/test_torch_sim.py, deformed and moving,
    re-blocked in both packages with small caps so it spans several
    blocks."""
    pcfg, jcfg, obj, state, obs, jobj, jstate, jobs = _bodies(3, seed=2)
    args = (obj.element_indices.numpy(), obj.ref_inv.numpy(),
            obj.volume.numpy(), obj.rest_pos.numpy())
    jblk = jblocking.build_blocking(*args, **CAPS)
    obj = dataclasses.replace(
        obj, blocking=blocking.build_blocking(*args, **CAPS, device="cpu"))
    jobj = jobj.replace(blocking=jblk)
    assert obj.blocking.num_blocks == jblk.num_blocks >= 4
    return pcfg, jcfg, obj, state, obs, jobj, jstate, jobs


def _block_rel(got, ref):
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(axis=1)
    scale = np.maximum(scale, 1e-30)[:, None, None]
    return float((np.abs(got - ref) / scale).max())


def test_blocked_prep_plain_matches_jax(bodies):
    _, _, obj, state, _, jobj, jstate, _ = bodies
    K, part = blocked_kernels.blocked_prep_plain(
        obj.blocking, state.pos, obj.mu, obj.s_lambda)
    kplane, yt = jblocking.blocked_prep(
        jobj.blocking, jstate.pos, 3, jobj.mu, jobj.s_lambda)
    kflat = np.asarray(jblocking.kplane_to_kflat(jobj.blocking, kplane, 3))
    assert K.shape == kflat.shape
    assert _block_rel(K.numpy(), kflat) <= 1e-5
    ref = np.asarray(yt).transpose(0, 2, 1)
    assert part.shape == ref.shape
    np.testing.assert_allclose(part.numpy(), ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))
    # Padded element slots carry K = 0.
    real = blocked_kernels._real_slots(obj.blocking).reshape(-1)
    assert not bool(real.all())
    assert float(K[~real].abs().max()) == 0.0


def test_blocked_force_assembly_matches_jax(bodies):
    _, _, obj, state, _, jobj, jstate, _ = bodies
    _, part = blocked_kernels.blocked_prep_plain(
        obj.blocking, state.pos, obj.mu, obj.s_lambda)
    f = blocking.blocked_scatter_sum(part, obj.blocking).numpy()
    _, yt = jblocking.blocked_prep(
        jobj.blocking, jstate.pos, 3, jobj.mu, jobj.s_lambda)
    ref = np.asarray(jblocking.blocked_scatter_sum(
        yt, jobj.blocking, jobj.particle_cnt))
    np.testing.assert_allclose(f, ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))


@pytest.mark.parametrize("transpose_k", [False, True])
def test_blocked_graph_apply_plain_matches_jax(bodies, transpose_k):
    _, _, obj, state, _, jobj, _, _ = bodies
    K, _ = blocked_kernels.blocked_prep_plain(
        obj.blocking, state.pos, obj.mu, obj.s_lambda)
    x = np.random.default_rng(3).uniform(
        -1, 1, (obj.particle_cnt, 3)).astype(np.float32)
    got = blocked_kernels.blocked_graph_apply_plain(
        obj.blocking, K, torch.as_tensor(x), transpose_k).numpy()
    kplane = jblocking.make_kplane(jobj.blocking, jnp.asarray(K.numpy()), 3)
    ref = np.asarray(jblocking.blocked_graph_apply(
        jobj.blocking, kplane, jnp.asarray(x), jobj.particle_cnt, 3,
        transpose_k=transpose_k))
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))


def test_wrappers_run_plain_versions_on_the_cpu(bodies):
    _, _, obj, state, _, _, _, _ = bodies
    before = (blocked_kernels.blocked_prep.launches,
              blocked_kernels.blocked_graph_apply.launches)
    K, part = blocked_kernels.blocked_prep(
        obj.blocking, state.pos, obj.mu, obj.s_lambda)
    Kp, partp = blocked_kernels.blocked_prep_plain(
        obj.blocking, state.pos, obj.mu, obj.s_lambda)
    assert torch.equal(K, Kp) and torch.equal(part, partp)
    y = blocked_kernels.blocked_graph_apply(obj.blocking, K, state.vel, True)
    yp = blocked_kernels.blocked_graph_apply_plain(
        obj.blocking, K, state.vel, True)
    assert torch.equal(y, yp)
    # The counters count kernel launches only.
    assert (blocked_kernels.blocked_prep.launches,
            blocked_kernels.blocked_graph_apply.launches) == before


@pytest.mark.parametrize("preconditioned", [1, 0])
def test_blocked_substep_matches_jax(bodies, preconditioned):
    pcfg, jcfg, obj, state, obs, jobj, jstate, jobs = bodies
    pcfg = dataclasses.replace(pcfg, operator_mode="blocked",
                               preconditioned=preconditioned)
    jcfg = dataclasses.replace(jcfg, operator_mode="blocked",
                               element_backend="pallas",
                               preconditioned=preconditioned)
    got, aux = sim.substep(obj, state, obs, **sim.substep_kwargs(pcfg))
    ref, jaux = jsim.make_substep_fn(jobj, jcfg)(jstate, jobs)
    iters = _assert_matches(got, aux, ref, jaux)
    assert 1 < iters.max() <= 20
