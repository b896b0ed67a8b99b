# coding=utf-8
"""The exact-Hessian operator (``hessian="exact_jvp"``), the block-Jacobi
PCG and the K9 kernels' plain versions, against the JAX package on the same
numpy inputs: the Hessian-vector product against ``jax.jvp`` and finite
differences, its transpose against ``jax.vjp``, the ``exact_jvp`` substep,
``preconditioned_conjugate_gradient`` and ``diagonal_blocks(_from)``, and
K9a/K9b's plain versions against ``hessian_blocks_planar`` and
``implicit_force_planar`` in interpret mode.

Tolerances: operators and element blocks 1e-5 relative to their largest
entry (block-relative for K9); finite differences 2e-2 relative as
tests/test_exact_hessian.py; solves 1e-5 relative in x with equal
iterations; substeps 1e-5 in positions with equal CG iterations."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu.ops import pallas_kernels as jpallas
from fem_tpu.ops.assembly import element_contrib_full as j_contrib
from fem_tpu.ops.assembly import segment_assemble
from fem_tpu.ops.blocking import kplane_to_kflat
from fem_tpu.ops.element import implicit_force_columns as j_force_columns
from fem_tpu.solvers import implicit as jimplicit
from fem_tpu_torch.ops import blocked_kernels
from fem_tpu_torch.ops import element_kernels as ek
from fem_tpu_torch.ops.cg_kernels import preconditioned_conjugate_gradient
from fem_tpu_torch.solvers import implicit
from tests.test_torch_pins import (
    MOVING_3D,
    PIN_2D,
    PIN_3D,
    assert_states_match,
    bodies,
    configs,
    run_both,
)

torch.set_num_threads(1)

DT = 5e-4


def _close(got, ref, rel=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _pair(dim, seed=11, squash=1.15, **obj_over):
    pcfg, jcfg = configs(dim, obj_over)
    return bodies(pcfg, jcfg, seed=seed, squash=squash)


@pytest.mark.parametrize("case", [
    (2, {}), (3, {}), (3, dict(material="stvk")), (2, dict(robust=True)),
])
def test_exact_hvp_matches_jax_jvp(case):
    dim, over = case
    robust = over.pop("robust", False)
    (obj, state, _), (jobj, jstate, _) = _pair(dim, **over)
    x = np.random.default_rng(1).normal(size=state.pos.shape).astype(
        np.float32)
    got = implicit.make_exact_hvp_apply(obj, state.pos, DT, robust, 2e-3)(
        torch.as_tensor(x)).numpy()
    ref = np.asarray(jimplicit.make_exact_hvp_apply(
        jobj, jstate.pos, DT, None, robust, 2e-3)(jnp.asarray(x)))
    _close(got - x, ref - x)
    # The transpose from the reverse derivative, against jax.vjp's.
    y = np.random.default_rng(2).normal(size=state.pos.shape).astype(
        np.float32)
    at = implicit._exact_apply_t(obj, state.pos, DT, robust, 2e-3, None)(
        torch.as_tensor(y)).numpy()

    def force(p):
        cols = jimplicit._material_force_columns(jobj, p, robust)
        return segment_assemble(j_contrib(cols), jobj.element_indices,
                                jobj.particle_cnt)

    _, vjp_fn = jax.vjp(force, jstate.pos)
    (jt,) = vjp_fn(jnp.asarray(y) / jobj.mass[:, None])
    _close(at - y, -jimplicit.system_coeff(DT, 2e-3) * np.asarray(jt))


def test_exact_hvp_matches_finite_differences():
    (obj, state, _), (jobj, _, _) = _pair(2, seed=13, squash=1.05)

    def force_np(p):
        cols = j_force_columns(jnp.asarray(p, jnp.float32),
                               jobj.element_indices, jobj.ref_inv,
                               jobj.volume, jobj.mu, jobj.s_lambda)
        return np.asarray(segment_assemble(j_contrib(cols),
                                           jobj.element_indices,
                                           jobj.particle_cnt), np.float64)

    x = np.random.default_rng(3).normal(size=state.pos.shape).astype(
        np.float32)
    got = implicit.make_exact_hvp_apply(obj, state.pos, DT)(
        torch.as_tensor(x)).numpy()
    pos = state.pos.numpy().astype(np.float64)
    eps = 1e-3
    jfd = (force_np(pos + eps * x) - force_np(pos - eps * x)) / (2 * eps)
    expect = x - DT * DT * jfd / obj.mass.numpy()[:, None]
    np.testing.assert_allclose(got, expect, rtol=2e-2, atol=2e-4)


@pytest.mark.parametrize("case", [
    (2, 0, {}), (3, 1, {}), (3, 0, dict(pin_boxes=PIN_3D + MOVING_3D,
                                        damping_beta=2e-3)),
    (2, 1, dict(pin_boxes=PIN_2D, material="stable_neo_hookean")),
    (2, 0, dict(plastic_yield=0.01)),
])
def test_exact_jvp_substeps_match_jax(case):
    """Four ``hessian="exact_jvp"`` substeps: plain and normal-equations
    CG, with pins (moving too) and β, a non-Neo-Hookean material and an
    inelastic one."""
    dim, pre, obj_over = case
    pcfg, jcfg = configs(dim, obj_over, hessian="exact_jvp",
                         preconditioned=pre)
    port, jax_side = bodies(pcfg, jcfg, seed=17, squash=1.15)
    state, jstate, its, jits = run_both(pcfg, jcfg, port, jax_side)
    assert_states_match(state, jstate, its, jits)
    assert max(its) > 0


def test_exact_jvp_rejects_jacobi_and_block_jacobi():
    pcfg, jcfg = configs(2, hessian="exact_jvp", cg_precond="block_jacobi")
    (obj, state, _), _ = bodies(pcfg, jcfg, seed=1)
    with pytest.raises(ValueError, match="exact_jvp"):
        implicit.implicit_velocity_solve(obj, state, DT, 1, 0,
                                         cg_precond="block_jacobi",
                                         hessian="exact_jvp")
    # The Jacobi solver (ported in M10) refuses the exact Hessian, as the
    # JAX package does: it needs explicit diagonal blocks.
    with pytest.raises(ValueError, match="exact_jvp.*Jacobi"):
        implicit.implicit_velocity_solve(obj, state, DT, 0, 0,
                                         hessian="exact_jvp")
    with pytest.raises(ValueError, match="unknown hessian"):
        implicit.implicit_velocity_solve(obj, state, DT, 1, 0,
                                         hessian="exact")


@pytest.mark.parametrize("hetero", [False, True])
def test_pcg_matches_jax(hetero):
    """The block-Jacobi PCG over the graph operator, with the masses as
    built and scattered over two orders of magnitude (the regime the
    mass-symmetrized form is for)."""
    (obj, state, _), (jobj, jstate, _) = _pair(3, seed=19, squash=1.3)
    if hetero:
        m = obj.mass.numpy() * np.random.default_rng(4).uniform(
            0.1, 10.0, obj.particle_cnt).astype(np.float32)
        obj = dataclasses.replace(obj, mass=torch.as_tensor(m))
        jobj = jobj.replace(mass=jnp.asarray(m))
    K = jimplicit.hessian_blocks(jstate.pos, jobj.element_indices,
                                 jobj.ref_inv, jobj.volume, jobj.mu,
                                 jobj.s_lambda)
    b = np.asarray(jimplicit.implicit_rhs(jobj, jstate, DT))
    t = torch.as_tensor(np.asarray(K))
    res = preconditioned_conjugate_gradient(
        implicit.make_system_apply(obj, t, DT),
        implicit.diagonal_blocks(obj, t, DT), obj.mass, torch.as_tensor(b),
        torch.as_tensor(b))
    jres = jimplicit.preconditioned_conjugate_gradient(
        jimplicit.make_system_apply(jobj, K, DT),
        jimplicit.diagonal_blocks(jobj, K, DT), jobj.mass, jnp.asarray(b),
        jnp.asarray(b))
    _close(res.x.numpy(), jres.x)
    assert int(res.iterations) == int(jres.iterations) > 0
    assert float(res.residual) <= 1e-5


def test_diagonal_blocks_match_jax():
    """The graph form on mesh-order K, and the blocked branch's form (K2's
    block-order K taken to mesh order through ``element_slot``) against the
    JAX package's ``diagonal_blocks_from`` on its blocked K."""
    (obj, state, _), (jobj, jstate, _) = _pair(3, seed=23, squash=1.2)
    K = jimplicit.hessian_blocks(jstate.pos, jobj.element_indices,
                                 jobj.ref_inv, jobj.volume, jobj.mu,
                                 jobj.s_lambda)
    eye = np.eye(3, dtype=np.float32)
    got = implicit.diagonal_blocks(obj, torch.as_tensor(np.asarray(K)), DT,
                                   2e-3).numpy()
    ref = np.asarray(jimplicit.diagonal_blocks(jobj, K, DT, beta=2e-3))
    _close(got - eye, ref - eye)
    blk = obj.blocking
    kb, _ = blocked_kernels.blocked_prep_plain(blk, state.pos, obj.mu,
                                               obj.s_lambda)
    got_b = implicit.diagonal_blocks(obj, kb[blk.element_slot.long()], DT,
                                     2e-3).numpy()
    jblk = jobj.blocking
    from fem_tpu.ops.blocking import blocked_prep as jax_blocked_prep

    kplane, _ = jax_blocked_prep(jblk, jstate.pos, 3, jobj.mu, jobj.s_lambda)
    ref_b = np.asarray(jimplicit.diagonal_blocks_from(
        jblk.element_indices, kplane_to_kflat(jblk, kplane, 3), jobj.mass,
        DT, jobj.particle_cnt, beta=2e-3))
    _close(got_b - eye, ref_b - eye)


def _block_rel(got, ref):
    ref = np.asarray(ref)
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(axis=1)
    return float((np.abs(got - ref) / np.maximum(scale, 1e-30)[:, None, None]
                  ).max())


@pytest.mark.parametrize("dim", [2, 3])
def test_k9_plain_matches_pallas(dim):
    """K9a's and K9b's plain versions (the wrappers on CPU tensors) against
    the Pallas kernels in interpret mode, on a squashed state and on one
    with an inverted element (K9b's log of det F² stays finite there)."""
    (obj, state, _), (jobj, jstate, _) = _pair(dim, seed=29, squash=1.25)
    pos = state.pos.clone()
    idx = obj.element_indices.numpy()
    pos[idx[0, 1]] = 2 * pos[idx[0, 0]] - pos[idx[0, 1]]  # invert element 0
    jpos = jnp.asarray(pos.numpy())
    args = (pos, obj.element_indices, obj.ref_inv, obj.volume, obj.mu,
            obj.s_lambda)
    planes = jpallas._planar_inputs(jpos, jobj.element_indices, jobj.ref_inv,
                                    jobj.volume)
    xp, rp, vp, e, d = planes
    k_ref = np.asarray(jpallas.hessian_blocks_planar(
        xp, rp, vp, jobj.mu, jobj.s_lambda, True)[:, :e].T.reshape(e, d, d))
    h_ref = np.asarray(jpallas.implicit_force_planar(
        xp, rp, vp, jobj.mu, jobj.s_lambda, True)[:, :e].T.reshape(e, d, d))
    k = ek.hessian_blocks(*args).numpy()
    h = ek.implicit_force_columns(*args).numpy()
    assert np.isfinite(h).all()
    assert _block_rel(k, k_ref) <= 1e-5
    assert _block_rel(h, h_ref) <= 1e-5
    # They are K1's halves.
    k1, h1 = ek.hessian_and_force_plain(*args)
    np.testing.assert_array_equal(k, k1.numpy())
    np.testing.assert_array_equal(h, h1.numpy())
    assert ek.hessian_blocks.launches == 0
    assert ek.implicit_force_columns.launches == 0


def test_implicit_rhs_pallas_backend_matches_jax():
    """``implicit_rhs`` with ``element_backend="pallas"``: K9b (its plain
    version here) for the Neo-Hookean layer, against the JAX package's
    rhs through ``implicit_force_columns_pallas`` in interpret mode."""
    (obj, state, _), (jobj, jstate, _) = _pair(3, seed=31, squash=1.2)
    got = implicit.implicit_rhs(obj, state, DT, False, "pallas").numpy()
    ref = np.asarray(jimplicit.implicit_rhs(jobj, jstate, DT, None, False,
                                            "pallas"))
    v = state.vel.numpy()
    _close(got - v, ref - v)
