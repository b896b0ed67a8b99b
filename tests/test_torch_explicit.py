# coding=utf-8
"""The explicit and autodiff gradients (M9) and their kernels' plain
versions — K6 (gradient columns), K7b (the blocked prep's explicit mode) and
K7a (the blocked assembly) — against the JAX package's Pallas kernels in
interpret mode and its solvers on the same numpy inputs; the explicit and
autodiff substeps against ``fem_tpu.sim.make_substep_fn``; and the port's
plain explicit substep in float64 against the independent oracle
``tests/oracle.py``.

Tolerances: columns 1e-5 block-relative (max |entry| of each tet's 3×3
block: the same chain in float32, entries of a block cancel); assembled
gradients and per-slot partials 1e-5 of their largest entry (the JAX
package sums through one-hot dots, the port through its gather plans);
energies rtol 1e-5; substeps positions atol 1e-5 over 10 substeps; the
float64 run within 5e-8 of the oracle over 200 substeps, the bound
``tests/test_f64_parity.py`` holds ``fem_tpu`` to."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu import sim as jsim
from fem_tpu.ops import blocking as jblocking
from fem_tpu.ops import element as jelement
from fem_tpu.ops.pallas_kernels import explicit_grad_columns_pallas
from fem_tpu.solvers import explicit as jexplicit
from fem_tpu_torch import convert, sim
from fem_tpu_torch.models import mesh as pmesh
from fem_tpu_torch.models.state import Obstacles, build_object
from fem_tpu_torch.ops import blocked_kernels, blocking, element, element_kernels
from fem_tpu_torch.solvers import explicit
from fem_tpu_torch.utils.config import BlockConfig, ObjectConfig
from tests.oracle import Oracle
from tests.test_torch_frame import _scene
from tests.test_torch_sim import _bodies

torch.set_num_threads(1)

CAPS = dict(eb=8, pb=16)
TOL = 1e-5


@pytest.fixture(scope="module")
def scene():
    """The Delaunay cube of tests/test_torch_frame.py across the floor, the
    x = 1 wall and a circle, deformed and moving with numpy noise, in both
    packages; re-blocked with small caps so that it spans several blocks
    with padded element slots."""
    pcfg, jcfg, obj, state, obs, jobj, jstate, jobs = _scene(seed=7)
    args = (obj.element_indices.numpy(), obj.ref_inv.numpy(),
            obj.volume.numpy(), obj.rest_pos.numpy())
    jblk = jblocking.build_blocking(*args, **CAPS)
    obj = dataclasses.replace(
        obj, blocking=blocking.build_blocking(*args, **CAPS, device="cpu"))
    jobj = jobj.replace(blocking=jblk)
    blk = obj.blocking
    assert blk.num_blocks == jblk.num_blocks >= 3
    assert int((blk.block_elements < blk.eb).sum()) > 0  # padded slots
    return pcfg, jcfg, obj, state, obs, jobj, jstate, jobs


def _rel(got, ref):
    """max |got − ref| / max |ref|."""
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max()
                 / np.abs(np.asarray(ref)).max())


def _block_rel(got, ref):
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(axis=1)
    scale = np.maximum(scale, 1e-30)[:, None, None]
    return float((np.abs(got - ref) / scale).max())


def test_grad_cols_plain_matches_pallas_kernel(scene):
    _, _, obj, state, _, _, jstate, _ = scene
    args = (obj.element_indices, obj.ref_inv, obj.volume, obj.mu,
            obj.s_lambda)
    got = element_kernels.explicit_grad_columns(state.pos, *args).numpy()
    assert element_kernels.explicit_grad_columns.launches == 0  # CPU: plain
    ref = np.asarray(explicit_grad_columns_pallas(
        jstate.pos, *(jnp.asarray(a.numpy()) for a in args[:3]), obj.mu,
        obj.s_lambda))
    assert got.shape == ref.shape == (obj.element_cnt, 3, 3)
    assert np.isfinite(got).all()
    assert _block_rel(got, ref) <= TOL
    # The plain version is the element module's chain, +V scaled.
    f = element.deformation_gradients(state.pos, *args[:2])
    chain = element.grad_cols_chain(f, obj.ref_inv, obj.mu, obj.s_lambda)
    assert torch.equal(torch.as_tensor(got), obj.volume[:, None, None] * chain)


def test_grad_cols_chain_is_nan_for_an_inverted_tet():
    """The explicit chain's log is unclamped (parity: NaN on inversion),
    while K1's rhs columns stay finite there."""
    f = torch.eye(3).repeat(2, 1, 1)
    f[1, 2, 2] = -1.0  # det F = −1
    g = element.grad_cols_chain(f, torch.eye(3).repeat(2, 1, 1), 1.0, 2.0)
    assert torch.isfinite(g[0]).all() and torch.equal(g[0], torch.zeros(3, 3))
    assert torch.isnan(g[1]).any()
    _, h = element.k_and_h_chain(f, torch.eye(3).repeat(2, 1, 1), 1.0, 2.0)
    assert torch.isfinite(h).all()


def test_blocked_grad_prep_plain_matches_jax(scene):
    _, _, obj, state, _, jobj, jstate, _ = scene
    part = blocked_kernels.blocked_grad_prep_plain(
        obj.blocking, state.pos, obj.mu, obj.s_lambda)
    yt = jblocking.blocked_grad_prep(jobj.blocking, jstate.pos, 3, jobj.mu,
                                     jobj.s_lambda)
    ref = np.transpose(np.asarray(yt), (0, 2, 1))
    assert part.shape == ref.shape
    assert _rel(part.numpy(), ref) <= TOL
    got = blocking.blocked_scatter_sum(part, obj.blocking).numpy()
    ref_g = np.asarray(jblocking.blocked_scatter_sum(yt, jobj.blocking,
                                                     obj.particle_cnt))
    assert np.isfinite(got).all()
    assert _rel(got, ref_g) <= TOL


def test_blocked_assemble_plain_matches_jax(scene):
    _, _, obj, _, _, jobj, _, _ = scene
    blk = obj.blocking
    rng = np.random.default_rng(3)
    cols = rng.standard_normal((blk.num_blocks * blk.eb, 3, 3)).astype(
        np.float32)
    real = (blk.volume.numpy() > 0)[:, None, None]
    ref = np.asarray(jblocking.blocked_assemble(
        jobj.blocking, jnp.asarray(np.where(real, cols, 0.0)),
        obj.particle_cnt, 3))
    got = blocked_kernels.blocked_assemble(blk, torch.as_tensor(cols))
    assert blocked_kernels.blocked_assemble.launches == 0  # CPU: plain
    assert got.shape == (obj.particle_cnt, 3)
    assert _rel(got.numpy(), ref) <= TOL
    # Padded element slots contribute nothing, whatever they hold.
    zeroed = blocked_kernels.blocked_assemble_plain(
        blk, torch.as_tensor(np.where(real, cols, 0.0)))
    assert torch.equal(got, zeroed)


@pytest.mark.parametrize("blocked", [True, False])
def test_autodiff_gradient_matches_jax(scene, blocked):
    _, _, obj, state, _, jobj, jstate, _ = scene
    if not blocked:
        obj = dataclasses.replace(obj, blocking=None)
        jobj = jobj.replace(blocking=None)
    got = explicit.autodiff_energy_gradient(obj, state.pos)
    ref = np.asarray(jexplicit.autodiff_energy_gradient(jobj, jstate.pos))
    assert not got.requires_grad
    assert np.isfinite(got.numpy()).all()
    assert _rel(got.numpy(), ref) <= TOL


@pytest.mark.parametrize("blocked", [True, False])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_analytic_gradient_matches_jax(scene, backend, blocked):
    _, _, obj, state, _, jobj, jstate, _ = scene
    if not blocked:
        obj = dataclasses.replace(obj, blocking=None)
        jobj = jobj.replace(blocking=None)
    got = explicit.analytic_energy_gradient(obj, state.pos, backend)
    ref = np.asarray(jexplicit.analytic_energy_gradient(
        jobj, jstate.pos, element_backend=backend))
    assert _rel(got.numpy(), ref) <= TOL
    # The analytic and the autodiff gradient are one function.
    ad = explicit.autodiff_energy_gradient(obj, state.pos)
    assert _rel(got.numpy(), ad.numpy()) <= TOL


def test_energies_match_jax(scene):
    """φ is a difference of terms of size μ/2·tr FᵀF, which cancel near the
    rest shape: each V·φ is held to 1e-5 of V·μ/2·tr FᵀF, its largest term,
    and U to 1e-5 of their sum."""
    _, _, obj, state, _, _, jstate, _ = scene
    args = (obj.element_indices, obj.ref_inv, obj.volume)
    jargs = tuple(jnp.asarray(a.numpy()) for a in args)
    got = element.element_energies(state.pos, *args, obj.mu, obj.s_lambda)
    ref = np.asarray(jelement.element_energies(jstate.pos, *jargs, obj.mu,
                                               obj.s_lambda))
    f = element.deformation_gradients(state.pos, *args[:2])
    scale = (obj.volume * obj.mu / 2.0 * (f * f).sum(dim=(-2, -1))).numpy()
    assert np.all(np.abs(got.numpy() - ref) <= TOL * scale)
    assert np.abs(ref).max() > 10 * TOL * scale.max()  # not lost in rounding
    total = element.total_energy(state.pos, *args, obj.mu, obj.s_lambda)
    ref_total = float(jelement.total_energy(jstate.pos, *jargs, obj.mu,
                                            obj.s_lambda))
    assert total.shape == ()
    assert abs(float(total) - ref_total) <= TOL * scale.sum()


def _explicit_cfgs(pcfg, jcfg, **over):
    over = dict(dict(use_explicit_method=True, frame_backend="auto"), **over)
    return (dataclasses.replace(pcfg, **over),
            dataclasses.replace(jcfg, **over))


@pytest.mark.parametrize("blocked", [True, False])
@pytest.mark.parametrize("mode", [
    dict(element_backend="auto"),
    dict(element_backend="xla"),
    dict(element_backend="pallas"),
    dict(auto_diff=True),
    dict(auto_diff=True, use_explicit_method=False),
])
def test_explicit_substeps_match_jax(scene, mode, blocked):
    """Ten substeps; ``auto_diff`` wins over ``use_explicit_method``."""
    pcfg, jcfg, obj, state, obs, jobj, jstate, jobs = scene
    if not blocked:
        obj = dataclasses.replace(obj, blocking=None)
        jobj = jobj.replace(blocking=None)
    pcfg, jcfg = _explicit_cfgs(pcfg, jcfg, **mode)
    kwargs = sim.substep_kwargs(pcfg)
    jstep = jsim.make_substep_fn(jobj, jcfg)
    for i in range(10):
        state, aux = sim.substep(obj, state, obs, **kwargs)
        jstate, _ = jstep(jstate, jobs)
        np.testing.assert_allclose(state.pos.numpy(), np.asarray(jstate.pos),
                                   rtol=0, atol=TOL, err_msg=f"substep {i}")
    np.testing.assert_allclose(state.vel.numpy(), np.asarray(jstate.vel),
                               rtol=0, atol=2e-3)
    assert aux.solver_iterations.dtype == torch.int32
    assert int(aux.solver_iterations) == 0 and float(aux.solver_residual) == 0
    assert torch.equal(state.force, torch.zeros_like(state.pos))
    assert torch.equal(state.vel_g, torch.zeros_like(state.pos))


@pytest.mark.parametrize("auto_diff", [False, True])
def test_explicit_2d_frame_matches_jax(auto_diff):
    """2D on the CPU ("auto" on a CPU object): one op-composed frame of 10
    substeps with floor contact and two circles, through the plain
    versions.  The config is eligible for K8, which "auto" runs on a CUDA
    object (tests/test_torch_2d.py holds K8's plain 2D frame)."""
    pcfg, jcfg, obj, state, obs, jobj, jstate, jobs = _bodies(2, seed=4)
    over = dict(use_explicit_method=True, auto_diff=auto_diff,
                element_backend="auto", operator_mode="auto")
    pcfg = dataclasses.replace(pcfg, **over)
    jcfg = dataclasses.replace(jcfg, **over)
    assert obj.blocking is not None
    assert sim.supports_explicit_blocked_frame(obj, pcfg)
    state, aux = sim.make_frame_fn(obj, pcfg)(state, obs)
    jstate, _ = jsim.make_frame_fn(jobj, jcfg)(jstate, jobs)
    np.testing.assert_allclose(state.pos.numpy(), np.asarray(jstate.pos),
                               rtol=0, atol=TOL)
    assert aux.solver_iterations.shape == (pcfg.sim_count,)


def test_float64_explicit_substep_tracks_the_oracle():
    """The port's plain explicit substep (no blocking, gather assembly)
    in float64 over 200 substeps: a 3D cube falling onto a sphere tracks
    the float64 numpy oracle to < 5e-8."""
    ocfg = ObjectConfig(subdivisions=3, side_length=0.2,
                        center=(0.45, 0.65, 0.45), E=4e4, nu=0.3,
                        damping=14.5, rho=500.0)
    blocks = [((0.55, 0.6, 0.55), 0.08)]
    v, f, t = pmesh.construct_3d_grid_mesh(ocfg)
    obj, state = build_object(ocfg, v, f, t, device="cpu")
    obj = convert.to_dtype(dataclasses.replace(obj, blocking=None),
                           torch.float64)
    state = convert.to_dtype(state, torch.float64)
    obs = convert.to_dtype(Obstacles.from_configs(
        tuple(BlockConfig(block_center=c, block_radius=r) for c, r in blocks),
        3, device="cpu"), torch.float64)
    assert obj.ref_inv.dtype == obj.mass.dtype == torch.float64
    assert obj.element_indices.dtype == torch.int32
    oracle = Oracle(state.pos.numpy(), t, ocfg.rho, ocfg.mu, ocfg.s_lambda,
                    ocfg.damping)
    g_dir = (0.0, -1.0, 0.0)
    worst, hits = 0.0, 0
    for _ in range(200):
        state, _ = sim.substep(obj, state, obs, dt=5e-4, g_dir=g_dir,
                               implicit_method=1, preconditioned=1,
                               use_explicit_method=True)
        oracle.step_explicit(5e-4, g_dir, blocks)
        worst = max(worst, float(np.abs(state.pos.numpy() - oracle.pos).max()))
        disp = oracle.pos - np.asarray(blocks[0][0])
        hits += int((np.linalg.norm(disp, axis=1) < blocks[0][1]).sum())
    assert state.pos.dtype == torch.float64
    assert hits > 0  # the sphere was reached
    assert worst < 5e-8, worst


def test_float64_implicit_substep_tracks_the_oracle():
    """The port's plain implicit-CG substep (normal equations, no blocking)
    in float64 over 200 substeps: the ``implicit_cg`` case of
    tests/test_f64_parity.py — a 2D square at 3 subdivisions falling past a
    circle — tracks the float64 numpy oracle to < 5e-9 (the JAX package
    measures 2.5e-9 there; with the damping decay rounded to f32 the port
    measured 9.06e-9)."""
    ocfg = ObjectConfig(center=(0.45, 0.65), side_length=0.2, subdivisions=3,
                        E=4e4, nu=0.2, damping=14.5, rho=500.0)
    blocks = [((0.55, 0.55), 0.12)]
    v, f, t = pmesh.construct_2d_mesh(ocfg)
    obj, state = build_object(ocfg, v, f, t, device="cpu")
    obj = convert.to_dtype(dataclasses.replace(obj, blocking=None),
                           torch.float64)
    state = convert.to_dtype(state, torch.float64)
    obs = convert.to_dtype(Obstacles.from_configs(
        tuple(BlockConfig(block_center=c, block_radius=r) for c, r in blocks),
        2, device="cpu"), torch.float64)
    oracle = Oracle(state.pos.numpy(), t, ocfg.rho, ocfg.mu, ocfg.s_lambda,
                    ocfg.damping)
    g_dir = (0.0, -1.0)
    worst = 0.0
    for _ in range(200):
        state, _ = sim.substep(obj, state, obs, dt=5e-4, g_dir=g_dir,
                               implicit_method=1, preconditioned=1)
        oracle.step_implicit_cg(5e-4, g_dir, blocks, preconditioned=True)
        worst = max(worst, float(np.abs(state.pos.numpy() - oracle.pos).max()))
    assert state.pos.dtype == torch.float64
    assert worst < 5e-9, worst
