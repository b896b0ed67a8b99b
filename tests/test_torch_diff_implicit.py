# coding=utf-8
"""Differentiable rollouts, the implicit substep (``fem_tpu_torch/diff.py``:
K, the rhs, the normal-equations solve under ``_NormalSolve``, the implicit
advection) against the JAX package's ``fem_tpu.diff`` on the same numpy
inputs: the forward substeps in 2D and 3D, with and without locality
blocks, against the JAX package and against a float64 dense solve; the
gradients of ``tests/test_diff.py``'s ``_loss_at`` functional against
``jax.grad``; finite differences of the port itself; the plastic yield
strain and the Maxwell branch; pins, moving pins, a static load and
Rayleigh β; ``remat``; and two runs bit-identical.

Tolerances: positions 1e-5 (the same fixed-iteration CG, its sums in
another order); gradients 1e-3 relative to ``jax.grad`` — both in float32,
which reaches it here: the forward and the adjoint CG run the same
operator on the same inputs in both packages, and their f32 rounding moves
the gradients by ~1e-6 relative, so float64 under x64 is not needed;
finite differences 5e-2 relative (8e-2 with plasticity), as
``tests/test_diff.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu import diff as jdiff
from fem_tpu.models.state import dense_system_matrix
from fem_tpu.solvers.advect import advect_implicit_step as jadvect
from fem_tpu_torch import diff
from tests.test_torch_diff import (
    IMPLICIT,
    _cfg_3d,
    assert_grads_match,
    case,
    grads_both,
    port_config,
    port_loss,
    states_close,
    tensors,
)
from tests.utils import default_sim_config

torch.set_num_threads(1)

PLAIN_CG = dict(IMPLICIT, preconditioned=0)


def _run_both(port, jax_side, jcfg, substeps, n_cg_iters=32):
    (obj, state, obs), (jobj, jstate, jobs) = port, jax_side
    sub = diff.make_diff_substep_fn(obj, port_config(jcfg), n_cg_iters)
    jsub = jax.jit(jdiff.make_diff_substep_fn(jobj, jcfg, n_cg_iters))
    params, jparams = diff.params_from_object(obj), \
        jdiff.params_from_object(jobj)
    with torch.no_grad():
        for _ in range(substeps):
            state = sub(params, state, obs)
            jstate = jsub(jparams, jstate, jobs)
    return state, jstate


@pytest.mark.parametrize("dim,blocks", [(2, True), (3, True), (3, False)],
                         ids=["2d", "3d", "3d-noblocks"])
def test_forward_matches_jax(dim, blocks):
    port, jax_side = case(dim=dim, subdivisions=3 if dim == 2 else 2)
    if not blocks:
        obj, state, obs = port
        port = (dataclasses.replace(obj, blocking=None), state, obs)
    jcfg = default_sim_config(**IMPLICIT) if dim == 2 else _cfg_3d()
    state, jstate = _run_both(port, jax_side, jcfg, 6, 48)
    states_close(state, jstate, 1e-5)


def test_substep_matches_dense_f64_solve():
    """One implicit diff substep against the float64 dense normal-equations
    solution of the same system, advected by the JAX package's step
    (tests/test_diff.py's oracle)."""
    from fem_tpu.ops.assembly import assemble_for, element_contrib_full
    from fem_tpu.ops.element import implicit_force_columns

    port, (jobj, jstate, jobs) = case(dim=3, subdivisions=2)
    obj, state, obs = port
    jcfg = _cfg_3d(element_backend="xla", operator_mode="graph")
    sub = diff.make_diff_substep_fn(obj, port_config(jcfg), n_cg_iters=128)
    with torch.no_grad():
        s = sub(diff.params_from_object(obj), state, obs)
    dt = jcfg.delta_time
    ad = dense_system_matrix(jobj, jstate, dt).astype(np.float64)
    cols = implicit_force_columns(jstate.pos, jobj.element_indices,
                                  jobj.ref_inv, jobj.volume, jobj.mu,
                                  jobj.s_lambda)
    f = assemble_for(jobj, element_contrib_full(cols))
    b = np.asarray(jstate.vel + dt * f / jobj.mass[:, None], np.float64)
    x = np.linalg.solve(ad.T @ ad, ad.T @ b.reshape(-1))
    oracle = jadvect(jstate.replace(vel=jnp.asarray(
        x.reshape(b.shape), jnp.float32)), jobs, dt, jobj.damping,
        tuple(jcfg.g_dir))
    np.testing.assert_allclose(s.vel.numpy(), np.asarray(oracle.vel),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(s.pos.numpy(), np.asarray(oracle.pos),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("dim", [2, 3])
def test_grads_match_jax(dim):
    port, jax_side = case(dim=dim, subdivisions=3 if dim == 2 else 2)
    assert_grads_match(*grads_both(port, jax_side, IMPLICIT, 8, 48))


def test_grad_matches_fd():
    """Central differences of the port's own functional in μ, λ and the
    damping (tests/test_diff.py:97-117 takes μ)."""
    (obj, state, obs), _ = case()
    cfg = port_config(default_sim_config(**IMPLICIT))
    base = [obj.mu, obj.s_lambda, obj.damping]
    ts = tensors(base)
    got = torch.autograd.grad(port_loss(obj, cfg, state, obs, 8,
                                        diff.DiffParams(*ts), 48), ts)
    with torch.no_grad():
        for i in (0, 1, 2):
            eps = 1e-3 * base[i]
            hi, lo = list(base), list(base)
            hi[i] += eps
            lo[i] -= eps
            fd = (float(port_loss(obj, cfg, state, obs, 8, diff.DiffParams(
                *tensors(hi, False)), 48)) - float(port_loss(
                    obj, cfg, state, obs, 8, diff.DiffParams(
                        *tensors(lo, False)), 48))) / (2 * eps)
            assert abs(float(got[i])) > 0.0
            assert float(got[i]) == pytest.approx(fd, rel=5e-2, abs=1e-12), i


def test_grad_wrt_initial_velocity_matches_jax():
    (obj, state, obs), (jobj, jstate, jobs) = case(dim=3, subdivisions=2)
    jcfg = _cfg_3d()
    rollout = diff.make_diff_rollout_fn(obj, port_config(jcfg), 4)
    jrollout = jdiff.make_diff_rollout_fn(jobj, jcfg, 4)
    params, jparams = diff.params_from_object(obj), \
        jdiff.params_from_object(jobj)
    v0 = state.vel.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(torch.mean(
        rollout(params, state.replace(vel=v0), obs)[1] ** 2), v0)
    jg = jax.grad(lambda v: jnp.mean(
        jrollout(jparams, jstate.replace(vel=v), jobs)[1] ** 2))(jstate.vel)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-3 * float(jnp.abs(jg).max()))


def test_plastic_implicit_grads():
    """The traced yield strain on the implicit method (plain CG, as
    tests/test_diff.py's implicit_plastic): against jax.grad and central
    differences (8e-2)."""
    port, jax_side = case(plastic_yield=0.05, scale=(1.35, 0.75))
    res = grads_both(port, jax_side, PLAIN_CG, 10, yield_strain=0.05)
    assert_grads_match(*res)
    obj, state, obs = port
    cfg = port_config(default_sim_config(**PLAIN_CG))

    def loss(y):
        return float(port_loss(obj, cfg, state, obs, 10, diff.DiffParams(
            *tensors([obj.mu, obj.s_lambda, obj.damping], False),
            plastic_yield=torch.tensor(y))))

    with torch.no_grad():
        fd = (loss(0.051) - loss(0.049)) / 2e-3
    assert res[0][1][3] == pytest.approx(fd, rel=8e-2, abs=1e-10)


def test_maxwell_implicit_matches_jax():
    port, jax_side = case(viscous_mu=2e4, viscous_tau=0.01,
                          scale=(1.2, 0.85))
    jcfg = default_sim_config(**IMPLICIT)
    state, jstate = _run_both(port, jax_side, jcfg, 6)
    states_close(state, jstate, 1e-5)
    np.testing.assert_allclose(state.viscous_inv.numpy(),
                               np.asarray(jstate.viscous_inv), atol=1e-5)
    assert_grads_match(*grads_both(port, jax_side, IMPLICIT, 6))


@pytest.mark.parametrize("moving", [False, True], ids=["held", "moving"])
def test_pins_loads_rayleigh_match_jax(moving):
    """Pins (held, or moving: the particular solution through _GraphApply),
    a static load and Rayleigh β in c: forward and gradients."""
    box = ((0.0, 0.0), (1.0, 0.71)) + (((0.0, 0.1),) if moving else ())
    port, jax_side = case(
        pin_boxes=(box,), damping_beta=2e-3,
        load_boxes=(((0.0, 0.75), (1.0, 1.0), (0.5, -2.0)),))
    assert (port[0].pin_vel is not None) == moving
    jcfg = default_sim_config(**IMPLICIT)
    state, jstate = _run_both(port, jax_side, jcfg, 6)
    states_close(state, jstate, 1e-5)
    assert_grads_match(*grads_both(port, jax_side, IMPLICIT, 6))


def test_remat_on_and_off_agree():
    """``remat`` on and off: equal losses and gradients, the initial
    velocity's too."""
    (obj, state, obs), _ = case(subdivisions=2)
    cfg = port_config(default_sim_config(**IMPLICIT))
    out = []
    for remat in (True, False):
        ts = tensors([obj.mu, obj.s_lambda, obj.damping])
        v0 = state.vel.clone().requires_grad_(True)
        loss = port_loss(obj, cfg, state.replace(vel=v0), obs, 5,
                         diff.DiffParams(*ts), 16, remat)
        out.append((loss.detach(), torch.autograd.grad(loss, ts + [v0])))
    assert torch.equal(out[1][0], out[0][0])
    for a, b in zip(out[1][1], out[0][1]):
        assert torch.equal(a, b)


def test_two_runs_bit_identical():
    (obj, state, obs), _ = case(dim=3, subdivisions=2)
    cfg = port_config(_cfg_3d())
    runs = []
    for _ in range(2):
        ts = tensors([obj.mu, obj.s_lambda, obj.damping])
        loss = port_loss(obj, cfg, state, obs, 4, diff.DiffParams(*ts))
        runs.append(torch.autograd.grad(loss, ts))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
