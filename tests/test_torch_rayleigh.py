# coding=utf-8
"""Rayleigh damping β (``damping_beta``) through the port, against the JAX
package on the same numpy inputs: ``system_coeff``, the damped operators A
and Aᵀ and their diagonal blocks, ``rayleigh_damping_grad`` (elastic,
layered and non-Neo-Hookean), and each method's substeps with β — explicit,
autodiff, and the implicit CG over the blocked and the graph operators,
plain, in normal equations and block-Jacobi — in 2D and 3D.

Tolerances: operators and gradients 1e-5 relative to their largest entry
(sums in another order); substeps 1e-5 in positions with equal CG
iterations (as tests/test_torch_pins.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu.ops.inelastic import material_layers as jax_material_layers
from fem_tpu.solvers import implicit as jimplicit
from fem_tpu_torch.ops import cg_kernels
from fem_tpu_torch.ops.inelastic import material_layers
from fem_tpu_torch.solvers import implicit
from tests.test_torch_pins import (
    assert_states_match,
    bodies,
    configs,
    run_both,
)

torch.set_num_threads(1)

BETA = 2e-3


def test_system_coeff_matches_jax():
    for dt, beta in ((5e-4, 0.0), (5e-4, BETA), (1e-4, 0.03)):
        assert implicit.system_coeff(dt, beta) == jimplicit.system_coeff(
            dt, beta) == cg_kernels.system_coeff(dt, beta)
    assert implicit.system_coeff(5e-4) == 5e-4 * 5e-4


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("dim", [2, 3])
def test_damped_operators_match_jax(dim):
    pcfg, jcfg = configs(dim, dict(damping_beta=BETA))
    (obj, state, _), (jobj, jstate, _) = bodies(pcfg, jcfg, seed=1,
                                                squash=1.2)
    K = jimplicit.hessian_blocks(jstate.pos, jobj.element_indices,
                                 jobj.ref_inv, jobj.volume, jobj.mu,
                                 jobj.s_lambda)
    t = torch.as_tensor(np.asarray(K))
    x = np.random.default_rng(2).normal(size=state.pos.shape).astype(
        np.float32)
    tx, jx = torch.as_tensor(x), jnp.asarray(x)
    eye = np.eye(dim, dtype=np.float32)
    # Each against its identity part, so that the tolerance bites on the
    # c·M⁻¹·G(K) term.
    for got, ref, ident in (
        (implicit.make_system_apply(obj, t, 5e-4, BETA)(tx),
         jimplicit.make_system_apply(jobj, K, 5e-4, beta=BETA)(jx), x),
        (implicit.make_system_apply_t(obj, t, 5e-4, BETA)(tx),
         jimplicit.make_system_apply_t(jobj, K, 5e-4, beta=BETA)(jx), x),
        (implicit.diagonal_blocks(obj, t, 5e-4, BETA),
         jimplicit.diagonal_blocks(jobj, K, 5e-4, beta=BETA), eye),
    ):
        _close(got.numpy() - ident, np.asarray(ref) - ident)


@pytest.mark.parametrize("case", [
    (2, {}), (3, {}), (2, dict(plastic_yield=0.01, viscous_mu=2e4)),
    (3, dict(material="stvk")),
])
def test_rayleigh_damping_grad_matches_jax(case):
    """−β·G(K)·v over the material layers: the Neo-Hookean layer through
    K9a's plain version, every other material the plain blocks."""
    dim, over = case
    pcfg, jcfg = configs(dim, dict(damping_beta=BETA, **over))
    (obj, state, _), (jobj, jstate, _) = bodies(pcfg, jcfg, seed=3,
                                                squash=1.2)
    layers = jlayers = None
    if "plastic_yield" in over:
        rng = np.random.default_rng(4)
        e = obj.element_cnt
        fi = (np.eye(dim) + rng.uniform(-0.05, 0.05, (e, dim, dim))).astype(
            np.float32)
        fv = (np.eye(dim) + rng.uniform(-0.05, 0.05, (e, dim, dim))).astype(
            np.float32)
        state = state.replace(plastic_inv=torch.as_tensor(fi),
                              viscous_inv=torch.as_tensor(fv))
        jstate = jstate.replace(plastic_inv=jnp.asarray(fi),
                                viscous_inv=jnp.asarray(fv))
        layers = material_layers(obj, state)
        jlayers = jax_material_layers(jobj, jstate)
        assert len(layers) == 2
    got = implicit.rayleigh_damping_grad(obj, state.pos, state.vel, layers)
    ref = jimplicit.rayleigh_damping_grad(jobj, jstate.pos, jstate.vel, None,
                                          jlayers)
    _close(got.numpy(), ref)
    assert float(got.abs().max()) > 0.0


@pytest.mark.parametrize("case", [
    (2, dict(use_explicit_method=True, delta_time=1e-4)),
    (3, dict(use_explicit_method=True, delta_time=1e-4)),
    (2, dict(auto_diff=True, use_explicit_method=True, delta_time=1e-4)),
    (2, dict()), (3, dict()), (3, dict(preconditioned=1)),
    (2, dict(operator_mode="graph", preconditioned=1)),
    (3, dict(cg_precond="block_jacobi")),
    (2, dict(cg_precond="block_jacobi", operator_mode="graph")),
])
def test_substeps_with_beta_match_jax(case):
    """Four substeps with β of each method (the implicit ones blocked
    unless ``operator_mode="graph"``), from a squashed, moving state."""
    dim, over = case
    pcfg, jcfg = configs(dim, dict(damping_beta=BETA), **over)
    port, jax_side = bodies(pcfg, jcfg, seed=5, squash=1.15)
    state, jstate, its, jits = run_both(pcfg, jcfg, port, jax_side)
    assert_states_match(state, jstate, its, jits)
    if not pcfg.use_explicit_method:
        assert max(its) > 0


def test_rigid_translation_is_undamped():
    """G(K) annihilates a uniform velocity, so β damps deformation rates
    only: the Rayleigh term of a rigid translation is zero to rounding."""
    pcfg, jcfg = configs(3, dict(damping_beta=BETA))
    (obj, state, _), _ = bodies(pcfg, jcfg, seed=6, squash=1.2)
    rigid = torch.tensor([[0.3, -1.2, 0.5]]).expand_as(state.vel)
    g_rigid = implicit.rayleigh_damping_grad(obj, state.pos, rigid)
    g_moving = implicit.rayleigh_damping_grad(obj, state.pos, state.vel)
    assert float(g_rigid.abs().max()) < 1e-5 * float(g_moving.abs().max())
