# coding=utf-8
"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips when no CUDA device is present (decided
inside the fixture, never at import).  Run on a GPU machine with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX, which these tests do
not use).  Tolerances are those of chip_smoke.py: K1 and K2 block-relative
1e-5, K2's force partials and K3's product 1e-5 of their largest entry; K4
velocity rtol 5e-4 / atol 1e-6 and iterations within 1; K5 positions 1e-5,
iterations within 1, velocities √1e-5 (what its CG's stopping rule fixes)
and vel_g 1e-5; K6 block-relative 1e-5, K7b's partials and K7a's
sums 1e-5 of their largest entry, K8 positions 1e-5; J1 (the serial
Jacobi solve) equal iterations and x and its anchor within 1e-5 of the
largest entry, its sparse and dense row sources; the adaptive-dt guard's
κ within 1e-5 relative and its guarded frames' positions 1e-5 with
iterations within 1 an inner step; the CLI's resume bit-equal; the
differentiable rollout's loss 1e-5 and gradients 1e-3 (of the largest
entry), as tests/test_torch_diff_implicit.py holds them.  Iteration
counts are compared only where a solve takes a few tens of iterations at
most: over ~140 iterations f32 round-off moves the count by more than one
between two summation orders, so there the velocity is held to the f64
solution instead (the same check on the plain version runs on the CPU in
tests/test_torch_cg_kernels.py).

The 2D (triangle) instances take the same tolerances at the default
scene's size (``configs/default.json``'s square, one locality block).  On
the 40-subdivision grid (16 blocks) K1's and K6's near-rest triangles cancel
in f32 at ~1e-5 block-relative in either evaluation, so there the kernels
are held to the plain version in f64 at 1e-4, and K4's and K5's solves are
long (20-100 iterations): velocities against f64, positions to 1e-5,
residuals under the tolerance, counts left out."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from fem_tpu_torch import convert, sim
from fem_tpu_torch.solvers import explicit
from fem_tpu_torch.models import mesh as pmesh
from fem_tpu_torch.models.state import Obstacles, build_object
from fem_tpu_torch.ops import (
    blocked_kernels,
    blocking,
    cg_kernels,
    element_kernels,
    frame_kernels,
)
from fem_tpu_torch.utils.config import BlockConfig, ObjectConfig, parse_config

TOL = 1e-5

pytestmark = pytest.mark.cuda


def _body(E):
    """The 5×5×5 grid cube, deformed and moving, made from a numpy seed."""
    cfg = ObjectConfig(
        subdivisions=5, side_length=0.2, center=(0.4, 0.1, 0.4), E=E,
        rho=1000.0, damping=10.0,
    )
    v, f, t = pmesh.construct_3d_grid_mesh(cfg)
    obj, state = build_object(cfg, v, f, t, device="cuda")
    rng = np.random.default_rng(0)
    pos = state.pos + torch.as_tensor(
        rng.uniform(-0.004, 0.004, tuple(state.pos.shape)).astype(np.float32),
        device="cuda",
    )
    vel = torch.as_tensor(
        rng.uniform(-0.3, 0.3, tuple(state.pos.shape)).astype(np.float32),
        device="cuda",
    )
    return obj, state.replace(pos=pos, vel=vel)


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.fixture(scope="module")
def body():
    """E = 4e5: 8-15 CG iterations a solve, where two summation orders keep
    the iteration count within 1 of each other."""
    _require_cuda()
    return _body(4e5)


@pytest.fixture(scope="module")
def stiff_body():
    """E = 4e6: about 140 normal-equations iterations a solve."""
    _require_cuda()
    return _body(4e6)


@pytest.fixture(scope="module")
def flagship():
    """The flagship (configs/demo_spot.json: 4,068 tets), deformed."""
    _require_cuda()
    from fem_tpu_torch import entry

    _, obj, state, _ = entry.flagship("cuda")
    assert obj.element_cnt == 4068
    return obj, entry.deformed(state)


# Element counts of the ragged-tile checks: one element, one past a tile of
# 32, and one past the flagship.
RAGGED = (1, 33, 4069)


def _cut(obj, state, n):
    """K1's inputs over ``n`` elements cut from ``obj``'s, cyclically past
    its count (fresh, aligned tensors)."""
    idx = torch.arange(n, device=state.pos.device) % obj.element_cnt
    return (state.pos, obj.element_indices[idx].contiguous(),
            obj.ref_inv[idx].contiguous(), obj.volume[idx].contiguous(),
            obj.mu, obj.s_lambda)


def _check_tiled(kernel, plain, args, extra=(), kwargs=None, mid=0):
    """``kernel`` (K1, K6, K9a or K9b) on ``args`` (K1's six): within TOL
    block-relative of ``plain``, twice bit-identical, one launch a call,
    its instance counted, the plan's CTAs covering the elements."""
    kwargs = kwargs or {}
    n, dim = args[1].shape[0], args[0].shape[1]
    ref = _as_tuple(plain(*args, *extra))
    before = kernel.launches
    by = kernel.instance_launches.get((dim, mid), 0)
    got = _as_tuple(kernel(*args, **kwargs))
    again = _as_tuple(kernel(*args, **kwargs))
    assert kernel.launches == before + 2
    assert kernel.instance_launches[(dim, mid)] == by + 2
    plan = kernel.last_plan
    assert plan.ctas == -(-n // plan.tile)
    assert (plan.ctas - 1) * plan.tile + plan.last == n
    for g, a, r in zip(got, again, ref):
        assert g.shape == (n, dim, dim)
        assert _block_rel_err(g, r) <= TOL, n
        assert torch.equal(g, a), n


def test_element_chain_kernel_matches_plain(body, flagship, body_2d):
    """K1 (Neo-Hookean) on the grid cube, then at 1, 33 and 4,069 elements
    cut from the flagship and from default.json's square (ragged tiles)."""
    obj, state = body
    args = (state.pos, obj.element_indices, obj.ref_inv, obj.volume,
            obj.mu, obj.s_lambda)
    before = element_kernels.hessian_and_force.launches
    k, h = element_kernels.hessian_and_force(*args)
    assert element_kernels.hessian_and_force.launches == before + 1
    kp, hp = element_kernels.hessian_and_force_plain(*args)
    for got, ref in ((k, kp), (h, hp)):
        scale = ref.abs().reshape(ref.shape[0], -1).amax(1)[:, None, None]
        assert float(((got - ref).abs() / scale).max()) <= 1e-5
    for o, s in (flagship, body_2d):
        for n in RAGGED:
            _check_tiled(element_kernels.hessian_and_force,
                         element_kernels.hessian_and_force_plain,
                         _cut(o, s, n))


@pytest.mark.parametrize("preconditioned", [False, True])
def test_fused_cg_kernel_matches_plain_and_repeats(body, preconditioned):
    obj, state = body
    k, h = element_kernels.hessian_and_force(
        state.pos, obj.element_indices, obj.ref_inv, obj.volume, obj.mu,
        obj.s_lambda,
    )
    args = (k, h, obj.element_indices, obj.plan, state.vel, obj.mass, 5e-4,
            preconditioned)
    before = cg_kernels.fused_cg_solve.launches
    v, it, res = cg_kernels.fused_cg_solve(*args)
    assert cg_kernels.fused_cg_solve.launches == before + 1
    vp, itp, _ = cg_kernels.fused_cg_solve_plain(*args)
    assert int(it) > 1
    assert abs(int(it) - int(itp)) <= 1
    torch.testing.assert_close(v, vp, rtol=5e-4, atol=1e-6)
    v2, it2, res2 = cg_kernels.fused_cg_solve(*args)
    assert torch.equal(v, v2) and torch.equal(it, it2) and torch.equal(res, res2)
    # max_iter = 0 returns x₀ = b.
    b, it0, _ = cg_kernels.fused_cg_solve(*args, max_iter=0)
    bp, _, _ = cg_kernels.fused_cg_solve_plain(*args, max_iter=0)
    assert int(it0) == 0
    torch.testing.assert_close(b, bp, rtol=1e-6, atol=1e-7)


def test_wrappers_reject_bad_inputs(body):
    obj, state = body
    args = [state.pos, obj.element_indices, obj.ref_inv, obj.volume, 1.0, 1.0]
    bad = list(args)
    bad[1] = obj.element_indices.long()
    with pytest.raises(TypeError):
        element_kernels.hessian_and_force(*bad)
    bad = list(args)
    bad[2] = obj.ref_inv.transpose(1, 2)
    with pytest.raises(ValueError):
        element_kernels.hessian_and_force(*bad)
    bad = list(args)
    bad[3] = obj.volume.cpu()
    with pytest.raises(ValueError):
        element_kernels.hessian_and_force(*bad)


def test_frame_on_cuda_matches_cpu_frame(body):
    obj, state = body
    cfg = parse_config(dict(
        dim=3, delta_time=5e-4, sim_count=10, auto_diff=False,
        use_explicit_method=False, implicit_method=1, preconditioned=1,
        g_dir=[0, -1, 0],
    ))
    blocks = (BlockConfig(block_center=(0.5, 0.2, 0.5), block_radius=0.1),)
    obs = Obstacles.from_configs(blocks, 3, device="cuda")
    s, aux = sim.make_frame_fn(obj, cfg)(state, obs)
    cpu_obj = convert.object_from_arrays(*convert.object_to_arrays(obj), "cpu")
    cpu_state = convert.state_from_arrays(convert.state_to_arrays(state), "cpu")
    cpu_obs = Obstacles.from_configs(blocks, 3, device="cpu")
    ref, ref_aux = sim.make_frame_fn(cpu_obj, cfg)(cpu_state, cpu_obs)
    assert aux.solver_iterations.device.type == "cuda"
    got_it = aux.solver_iterations.cpu().numpy()
    ref_it = ref_aux.solver_iterations.numpy()
    # Counts are compared only in short solves; long ones are held by
    # test_fused_cg_kernel_long_solve_matches_float64 instead.
    assert ref_it.max() <= 20, ref_it
    assert np.all(np.abs(got_it - ref_it) <= 1), (got_it, ref_it)
    np.testing.assert_allclose(s.pos.cpu().numpy(), ref.pos.numpy(), atol=1e-5)


def test_op_composed_frame_on_cuda_matches_cpu_frame(body):
    """The op-composed frame (K1 + K4 a substep): ``operator_mode="graph"``
    is not eligible for the whole-frame kernel."""
    obj, state = body
    cfg = _frame_cfg(operator_mode="graph")
    assert not sim.supports_blocked_frame(obj, cfg)
    k1 = element_kernels.hessian_and_force.launches
    k4 = cg_kernels.fused_cg_solve.launches
    k5 = frame_kernels.fused_blocked_frame.launches
    s, aux = sim.make_frame_fn(obj, cfg)(state, _obstacles("cuda"))
    assert element_kernels.hessian_and_force.launches - k1 == cfg.sim_count
    assert cg_kernels.fused_cg_solve.launches - k4 == cfg.sim_count
    assert frame_kernels.fused_blocked_frame.launches == k5
    cpu_obj = convert.object_from_arrays(*convert.object_to_arrays(obj), "cpu")
    cpu_state = convert.state_from_arrays(convert.state_to_arrays(state), "cpu")
    ref, ref_aux = sim.make_frame_fn(cpu_obj, cfg)(cpu_state, _obstacles("cpu"))
    ref_it = ref_aux.solver_iterations.numpy()
    assert ref_it.max() <= 20, ref_it
    assert np.all(np.abs(aux.solver_iterations.cpu().numpy() - ref_it) <= 1)
    np.testing.assert_allclose(s.pos.cpu().numpy(), ref.pos.numpy(), atol=1e-5)


def test_fused_cg_kernel_long_solve_matches_float64(stiff_body):
    """A long normal-equations solve: the kernel stops on the tolerance and
    lands within 1e-4 (of the largest entry) of the plain solve in f64 on the
    CPU.  Iteration counts are left out (see the module docstring)."""
    obj, state = stiff_body
    k, h = element_kernels.hessian_and_force(
        state.pos, obj.element_indices, obj.ref_inv, obj.volume, obj.mu,
        obj.s_lambda,
    )
    v, it, res = cg_kernels.fused_cg_solve(
        k, h, obj.element_indices, obj.plan, state.vel, obj.mass, 5e-4, True
    )
    assert 100 < int(it) < 500 and float(res) <= TOL
    cpu_plan = convert.object_from_arrays(
        *convert.object_to_arrays(obj), "cpu").plan
    f64 = [t.cpu().double() for t in (k, h, state.vel, obj.mass)]
    ref, ref_it, ref_res = cg_kernels.fused_cg_solve_plain(
        f64[0], f64[1], obj.element_indices.cpu(), cpu_plan, f64[2], f64[3],
        5e-4, True,
    )
    assert int(ref_it) < 500 and float(ref_res) <= TOL
    err = float((v.cpu().double() - ref).abs().max())
    assert err <= 1e-4 * float(ref.abs().max()), err


# K5's launch variants: the automatic plan, the grid variant with one CTA a
# block and with 3 CTAs walking the blocks, and clusters of 1, 3 and 16 CTAs
# (ranks past the blocks own none).
K5_VARIANTS = ["auto", "grid", "grid 3 CTAs", "cluster 1", "cluster 3",
               "cluster 16"]


def _k5_launch(variant, blk):
    """fused_blocked_frame's launch options of ``variant`` on ``blk``."""
    if variant == "auto":
        return {}
    if variant == "grid":
        return dict(grid=blk.num_blocks)
    if variant == "grid 3 CTAs":
        return dict(grid=3)
    return dict(cluster=int(variant.split()[1]))


def _k5_fits(variant, blk, n):
    """Whether ``variant``'s cluster fits a CTA's shared memory (a forced
    cluster that does not must raise)."""
    launch = _k5_launch(variant, blk)
    if "cluster" not in launch:
        return True
    limits = frame_kernels.device_limits(0, blk.dim)
    return frame_kernels.cluster_smem(blk.num_blocks, blk.eb, blk.pb, n,
                                      blk.dim, launch["cluster"]) \
        <= limits.smem_optin


def _check_plan(variant, blk):
    """The last launch ran the variant asked for (auto: the cluster on the
    blockings of these tests)."""
    plan = frame_kernels.fused_blocked_frame.last_plan
    launch = _k5_launch(variant, blk)
    if "cluster" in launch:
        assert (plan.variant, plan.size) == ("cluster", launch["cluster"])
    elif "grid" in launch:
        assert (plan.variant, plan.size) == ("grid", launch["grid"])
    else:
        assert plan.variant == "cluster"
        assert plan.size == min(blk.num_blocks, 16)


def _check_barriers(out, normal):
    """The last launch counted the barriers that frame_barriers places in
    a frame of its variant and iterations."""
    plan = frame_kernels.fused_blocked_frame.last_plan
    met = int(frame_kernels.fused_blocked_frame.last_barriers.item())
    assert met == frame_kernels.frame_barriers(
        plan.variant, normal, out[3].tolist()), (plan, met, out[3].tolist())


def _check_velocities(out, ref):
    """vel and vel_g of a K5 frame against its plain frame's.  A CG stopped
    at ‖r‖² ≤ TOL fixes the velocity only to about √TOL (A's eigenvalues
    are near 1), and the kernel's and the plain frame's f32 roundings stop
    it at different points (both variants ~1e-4 apart from it after 10
    substeps): vel within √TOL.  vel_g, which no solve touches, within
    TOL.  A wrong row written back would be off by a whole velocity."""
    assert float((out[1] - ref[1]).abs().max()) <= TOL ** 0.5
    assert float((out[2] - ref[2]).abs().max()) <= TOL


def _reblocked(obj, eb=32, pb=24):
    """``obj`` with small locality blocks, so that the 5×5×5 cube spans
    several blocks with padded element slots."""
    args = [t.cpu().numpy() for t in (obj.element_indices, obj.ref_inv,
                                      obj.volume, obj.rest_pos)]
    blk = blocking.build_blocking(*args, eb=eb, pb=pb, device="cuda")
    assert blk.num_blocks > 4
    return dataclasses.replace(obj, blocking=blk)


def _frame_cfg(**over):
    data = dict(
        dim=3, delta_time=5e-4, sim_count=10, auto_diff=False,
        use_explicit_method=False, implicit_method=1, preconditioned=1,
        g_dir=[0, -1, 0],
    )
    data.update(over)
    return parse_config(data)


def _obstacles(device):
    blocks = (BlockConfig(block_center=(0.5, 0.2, 0.5), block_radius=0.1),
              BlockConfig(block_center=(0.4, 0.1, 0.4), block_radius=0.0))
    return Obstacles.from_configs(blocks, 3, device=device)


def test_blocked_prep_kernel_matches_plain_and_repeats(body):
    obj, state = body
    obj = _reblocked(obj)
    args = (obj.blocking, state.pos, obj.mu, obj.s_lambda)
    before = blocked_kernels.blocked_prep.launches
    k, part = blocked_kernels.blocked_prep(*args)
    assert blocked_kernels.blocked_prep.launches == before + 1
    kp, partp = blocked_kernels.blocked_prep_plain(*args)
    scale = kp.abs().reshape(kp.shape[0], -1).amax(1).clamp(min=1e-30)
    assert float(((k - kp).abs() / scale[:, None, None]).max()) <= 1e-5
    assert float((part - partp).abs().max()) <= 1e-5 * float(partp.abs().max())
    k2, part2 = blocked_kernels.blocked_prep(*args)
    assert torch.equal(k, k2) and torch.equal(part, part2)


@pytest.mark.parametrize("transpose_k", [False, True])
def test_blocked_matvec_kernel_matches_plain_and_repeats(body, transpose_k):
    obj, state = body
    obj = _reblocked(obj)
    k, _ = blocked_kernels.blocked_prep(
        obj.blocking, state.pos, obj.mu, obj.s_lambda)
    x = state.vel  # random per particle: G(K)·x is far from 0
    before = blocked_kernels.blocked_graph_apply.launches
    y = blocked_kernels.blocked_graph_apply(obj.blocking, k, x, transpose_k)
    assert blocked_kernels.blocked_graph_apply.launches == before + 1
    yp = blocked_kernels.blocked_graph_apply_plain(obj.blocking, k, x,
                                                   transpose_k)
    assert float(yp.abs().max()) > 0
    assert float((y - yp).abs().max()) <= 1e-5 * float(yp.abs().max())
    y2 = blocked_kernels.blocked_graph_apply(obj.blocking, k, x, transpose_k)
    assert torch.equal(y, y2)


@pytest.mark.parametrize("variant", K5_VARIANTS)
@pytest.mark.parametrize("preconditioned", [False, True])
def test_frame_kernel_matches_plain_and_repeats(body, preconditioned,
                                                variant):
    """Each variant (module K5_VARIANTS) on the cube in ~30 small blocks:
    the grid variant and the clusters of 1 and 3 CTAs walk several blocks
    a CTA."""
    obj, state = body
    obj = _reblocked(obj)
    launch = _k5_launch(variant, obj.blocking)
    obs = _obstacles("cuda")
    args = (obj.blocking, state.pos, state.vel, state.vel_g, obj.mass,
            obs.centers, obs.radii)
    kw = dict(dt=5e-4, damping=obj.damping, g_dir=(0.0, -1.0, 0.0),
              mu=obj.mu, s_lambda=obj.s_lambda,
              preconditioned=preconditioned, sim_count=10)
    before = frame_kernels.fused_blocked_frame.launches
    out = frame_kernels.fused_blocked_frame(*args, **launch, **kw)
    assert frame_kernels.fused_blocked_frame.launches == before + 1
    _check_plan(variant, obj.blocking)
    ref = frame_kernels.fused_blocked_frame_plain(*args, **kw)
    it, ref_it = out[3].cpu().numpy(), ref[3].cpu().numpy()
    assert ref_it.max() <= 20 and it.max() > 1, ref_it
    assert np.all(np.abs(it - ref_it) <= 1), (it, ref_it)
    assert float((out[0] - ref[0]).abs().max()) <= 1e-5
    _check_velocities(out, ref)
    _check_barriers(out, preconditioned)
    again = frame_kernels.fused_blocked_frame(*args, **launch, **kw)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("variant", K5_VARIANTS)
def test_frame_kernel_long_solve_matches_float64(stiff_body, variant):
    """About 140 normal-equations iterations a solve: the kernel's
    velocity lands within 1e-4 (of the largest entry) of the plain frame in
    f64 on the CPU, in each variant.  Iteration counts are left out (module
    docstring)."""
    obj, state = stiff_body
    obj = _reblocked(obj)
    kw = dict(dt=5e-4, damping=obj.damping, g_dir=(0.0, -1.0, 0.0),
              mu=obj.mu, s_lambda=obj.s_lambda, preconditioned=True,
              sim_count=1)
    obs = _obstacles("cuda")
    out = frame_kernels.fused_blocked_frame(
        obj.blocking, state.pos, state.vel, state.vel_g, obj.mass,
        obs.centers, obs.radii, **_k5_launch(variant, obj.blocking), **kw)
    _check_plan(variant, obj.blocking)
    _check_barriers(out, True)
    assert 100 < int(out[3][0]) < 500 and float(out[4][0]) <= TOL
    cpu_blk = blocking.build_blocking(
        *[t.cpu().numpy() for t in (obj.element_indices, obj.ref_inv,
                                    obj.volume, obj.rest_pos)],
        eb=obj.blocking.eb, pb=obj.blocking.pb, device="cpu")
    cpu_obs = _obstacles("cpu")
    f64 = [t.cpu().double() for t in (state.pos, state.vel, state.vel_g,
                                      obj.mass)]
    ref = frame_kernels.fused_blocked_frame_plain(
        cpu_blk, *f64, cpu_obs.centers, cpu_obs.radii, **kw)
    assert int(ref[3][0]) < 500 and float(ref[4][0]) <= TOL
    err = float((out[1].cpu().double() - ref[1]).abs().max())
    assert err <= 1e-4 * float(ref[1].abs().max()), err


def test_frame_kernel_raises_when_the_grid_cannot_be_co_resident(body):
    obj, state = body
    obs = _obstacles("cuda")
    args = (obj.blocking, state.pos, state.vel, state.vel_g, obj.mass,
            obs.centers, obs.radii)
    kw = dict(dt=5e-4, damping=obj.damping, g_dir=(0.0, -1.0, 0.0),
              mu=obj.mu, s_lambda=obj.s_lambda, preconditioned=True,
              sim_count=1)
    too_many = 1000 * torch.cuda.get_device_properties(0).multi_processor_count
    before = frame_kernels.fused_blocked_frame.launches
    with pytest.raises(RuntimeError, match="co-resident"):
        frame_kernels.fused_blocked_frame(*args, grid=too_many, **kw)
    assert frame_kernels.fused_blocked_frame.launches == before
    # The card still runs the kernel afterwards.
    out = frame_kernels.fused_blocked_frame(*args, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out[0]).all()


@pytest.mark.parametrize("cluster", [17, 32])
def test_frame_kernel_raises_when_the_cluster_cannot_be_scheduled(body,
                                                                  cluster):
    """A cluster above the device's 16 CTAs raises before any launch; it is
    never retried as the grid variant or the plain version."""
    obj, state = body
    obj = _reblocked(obj)
    assert obj.blocking.num_blocks >= cluster
    obs = _obstacles("cuda")
    args = (obj.blocking, state.pos, state.vel, state.vel_g, obj.mass,
            obs.centers, obs.radii)
    kw = dict(dt=5e-4, damping=obj.damping, g_dir=(0.0, -1.0, 0.0),
              mu=obj.mu, s_lambda=obj.s_lambda, preconditioned=True,
              sim_count=1)
    assert frame_kernels.device_limits(0, 3).max_cluster < cluster
    before = frame_kernels.fused_blocked_frame.launches
    variants = dict(frame_kernels.fused_blocked_frame.variant_launches)
    with pytest.raises(RuntimeError, match="cannot be scheduled"):
        frame_kernels.fused_blocked_frame(*args, cluster=cluster, **kw)
    assert frame_kernels.fused_blocked_frame.launches == before
    assert frame_kernels.fused_blocked_frame.variant_launches == variants
    out = frame_kernels.fused_blocked_frame(*args, cluster=16, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out[0]).all()


def test_blocked_frame_on_cuda_matches_cpu_frame(body):
    """Path A: make_frame_fn on a CUDA object runs K5 once a frame and
    nothing else of the kernels; the frame equals the CPU plain frame."""
    obj, state = body
    obj = _reblocked(obj)
    cfg = _frame_cfg()
    counters = (element_kernels.hessian_and_force, cg_kernels.fused_cg_solve,
                blocked_kernels.blocked_prep,
                blocked_kernels.blocked_graph_apply)
    before = [c.launches for c in counters]
    k5 = frame_kernels.fused_blocked_frame.launches
    s, aux = sim.make_frame_fn(obj, cfg)(state, _obstacles("cuda"))
    assert frame_kernels.fused_blocked_frame.launches == k5 + 1
    assert [c.launches for c in counters] == before
    cpu_obj = dataclasses.replace(
        convert.object_from_arrays(*convert.object_to_arrays(obj), "cpu"),
        blocking=blocking.build_blocking(
            *[t.cpu().numpy() for t in (obj.element_indices, obj.ref_inv,
                                        obj.volume, obj.rest_pos)],
            eb=32, pb=24, device="cpu"))
    cpu_state = convert.state_from_arrays(convert.state_to_arrays(state), "cpu")
    ref, ref_aux = sim.make_frame_fn(cpu_obj, cfg)(cpu_state,
                                                   _obstacles("cpu"))
    ref_it = ref_aux.solver_iterations.numpy()
    assert ref_it.max() <= 20, ref_it
    assert np.all(np.abs(aux.solver_iterations.cpu().numpy() - ref_it) <= 1)
    np.testing.assert_allclose(s.pos.cpu().numpy(), ref.pos.numpy(), atol=1e-5)


def test_blocked_operator_frame_launch_counts(body):
    """Path B: operator_mode="blocked" runs K2 once a substep and K3
    3 + 2·iterations times a normal-equations solve."""
    obj, state = body
    obj = _reblocked(obj)
    cfg = _frame_cfg(operator_mode="blocked")
    k2 = blocked_kernels.blocked_prep.launches
    k3 = blocked_kernels.blocked_graph_apply.launches
    k5 = frame_kernels.fused_blocked_frame.launches
    s, aux = sim.make_frame_fn(obj, cfg)(state, _obstacles("cuda"))
    iters = aux.solver_iterations.cpu().numpy()
    assert blocked_kernels.blocked_prep.launches - k2 == cfg.sim_count
    assert blocked_kernels.blocked_graph_apply.launches - k3 == int(
        np.sum(3 + 2 * iters))
    assert frame_kernels.fused_blocked_frame.launches == k5
    assert torch.isfinite(s.pos).all()


def _explicit_kw(obj, sim_count=10):
    return dict(dt=5e-4, damping=obj.damping, g_dir=(0.0, -1.0, 0.0),
                mu=obj.mu, s_lambda=obj.s_lambda, sim_count=sim_count)


def test_grad_columns_kernel_matches_plain_and_repeats(body, flagship,
                                                      body_2d):
    """K6 (Neo-Hookean) on the grid cube, then at 1, 33 and 4,069 elements
    cut from the flagship and from default.json's square (ragged tiles)."""
    for o, s in (flagship, body_2d):
        for n in RAGGED:
            _check_tiled(element_kernels.explicit_grad_columns,
                         element_kernels.explicit_grad_columns_plain,
                         _cut(o, s, n))
    obj, state = body
    args = (state.pos, obj.element_indices, obj.ref_inv, obj.volume,
            obj.mu, obj.s_lambda)
    before = element_kernels.explicit_grad_columns.launches
    g = element_kernels.explicit_grad_columns(*args)
    assert element_kernels.explicit_grad_columns.launches == before + 1
    gp = element_kernels.explicit_grad_columns_plain(*args)
    scale = gp.abs().reshape(gp.shape[0], -1).amax(1).clamp(min=1e-30)
    assert float(((g - gp).abs() / scale[:, None, None]).max()) <= TOL
    assert torch.equal(g, element_kernels.explicit_grad_columns(*args))


def test_blocked_grad_prep_kernel_matches_plain_and_repeats(body):
    obj, state = body
    obj = _reblocked(obj)
    args = (obj.blocking, state.pos, obj.mu, obj.s_lambda)
    before = blocked_kernels.blocked_grad_prep.launches
    part = blocked_kernels.blocked_grad_prep(*args)
    assert blocked_kernels.blocked_grad_prep.launches == before + 1
    partp = blocked_kernels.blocked_grad_prep_plain(*args)
    assert torch.isfinite(part).all()
    assert float((part - partp).abs().max()) <= TOL * float(partp.abs().max())
    assert torch.equal(part, blocked_kernels.blocked_grad_prep(*args))


def test_blocked_assemble_kernel_matches_plain_and_repeats(body):
    obj, state = body
    obj = _reblocked(obj)
    blk = obj.blocking
    gen = torch.Generator().manual_seed(0)
    cols = torch.randn((blk.num_blocks * blk.eb, 3, 3), generator=gen).cuda()
    before = blocked_kernels.blocked_assemble.launches
    y = blocked_kernels.blocked_assemble(blk, cols)
    assert blocked_kernels.blocked_assemble.launches == before + 1
    yp = blocked_kernels.blocked_assemble_plain(blk, cols)
    assert float((y - yp).abs().max()) <= TOL * float(yp.abs().max())
    assert torch.equal(y, blocked_kernels.blocked_assemble(blk, cols))


@pytest.mark.parametrize("grid", [0, 3])
def test_explicit_frame_kernel_matches_plain_and_repeats(body, grid):
    """grid 3: fewer CTAs than locality blocks, each walking several."""
    obj, state = body
    obj = _reblocked(obj)
    obs = _obstacles("cuda")
    args = (obj.blocking, state.pos, state.vel, obj.mass, obs.centers,
            obs.radii)
    before = frame_kernels.fused_explicit_frame.launches
    out = frame_kernels.fused_explicit_frame(*args, grid=grid,
                                             **_explicit_kw(obj))
    assert frame_kernels.fused_explicit_frame.launches == before + 1
    ref = frame_kernels.fused_explicit_frame_plain(*args, **_explicit_kw(obj))
    assert torch.isfinite(out[0]).all()
    assert float((out[0] - ref[0]).abs().max()) <= TOL
    assert float((out[0] - state.pos).abs().max()) > 1e-4
    again = frame_kernels.fused_explicit_frame(*args, grid=grid,
                                               **_explicit_kw(obj))
    assert all(torch.equal(a, b) for a, b in zip(out, again))


def test_explicit_frame_kernel_raises_when_the_grid_cannot_be_co_resident(body):
    obj, state = body
    obs = _obstacles("cuda")
    args = (obj.blocking, state.pos, state.vel, obj.mass, obs.centers,
            obs.radii)
    too_many = 1000 * torch.cuda.get_device_properties(0).multi_processor_count
    before = frame_kernels.fused_explicit_frame.launches
    with pytest.raises(RuntimeError, match="co-resident"):
        frame_kernels.fused_explicit_frame(*args, grid=too_many,
                                           **_explicit_kw(obj, 1))
    assert frame_kernels.fused_explicit_frame.launches == before
    out = frame_kernels.fused_explicit_frame(*args, **_explicit_kw(obj, 1))
    torch.cuda.synchronize()
    assert torch.isfinite(out[0]).all()


@pytest.mark.parametrize("mode", ["explicit", "autodiff"])
def test_explicit_frame_on_cuda_matches_cpu_frame(body, mode):
    """Path D: make_frame_fn on a CUDA object runs K8 once a frame and no
    other kernel; the frame equals the CPU frame (K8's plain version)."""
    obj, state = body
    obj = _reblocked(obj)
    cfg = _frame_cfg(use_explicit_method=True,
                     auto_diff=mode == "autodiff")
    counters = (element_kernels.hessian_and_force,
                element_kernels.explicit_grad_columns,
                cg_kernels.fused_cg_solve, blocked_kernels.blocked_prep,
                blocked_kernels.blocked_grad_prep,
                blocked_kernels.blocked_assemble,
                blocked_kernels.blocked_graph_apply,
                frame_kernels.fused_blocked_frame)
    before = [c.launches for c in counters]
    k8 = frame_kernels.fused_explicit_frame.launches
    s, _ = sim.make_frame_fn(obj, cfg)(state, _obstacles("cuda"))
    assert frame_kernels.fused_explicit_frame.launches == k8 + 1
    assert [c.launches for c in counters] == before
    cpu_obj = dataclasses.replace(
        convert.object_from_arrays(*convert.object_to_arrays(obj), "cpu"),
        blocking=blocking.build_blocking(
            *[t.cpu().numpy() for t in (obj.element_indices, obj.ref_inv,
                                        obj.volume, obj.rest_pos)],
            eb=32, pb=24, device="cpu"))
    cpu_state = convert.state_from_arrays(convert.state_to_arrays(state), "cpu")
    ref, _ = sim.make_frame_fn(
        cpu_obj, dataclasses.replace(cfg, frame_backend="blocked_explicit"))(
            cpu_state, _obstacles("cpu"))
    np.testing.assert_allclose(s.pos.cpu().numpy(), ref.pos.numpy(), atol=TOL)


@pytest.mark.parametrize("case", ["pallas", "xla", "autodiff", "unblocked"])
def test_explicit_substep_launch_counts(body, case):
    """Paths E, F and G: one substep launches K7b (E), K7a (F: "xla" and
    autodiff) or K6 (G: no blocking) exactly once, and equals the CPU
    substep."""
    obj, state = body
    obj = _reblocked(obj)
    over = dict(use_explicit_method=True, element_backend="auto")
    if case == "xla":
        over["element_backend"] = "xla"
    if case == "autodiff":
        over["auto_diff"] = True
    if case == "unblocked":
        obj = dataclasses.replace(obj, blocking=None)
    kwargs = sim.substep_kwargs(_frame_cfg(**over))
    expected = dict(pallas=blocked_kernels.blocked_grad_prep,
                    xla=blocked_kernels.blocked_assemble,
                    autodiff=blocked_kernels.blocked_assemble,
                    unblocked=element_kernels.explicit_grad_columns)[case]
    counters = (element_kernels.explicit_grad_columns,
                blocked_kernels.blocked_grad_prep,
                blocked_kernels.blocked_assemble)
    before = {c: c.launches for c in counters}
    s, _ = sim.substep(obj, state, _obstacles("cuda"), **kwargs)
    for c in counters:
        assert c.launches - before[c] == (1 if c is expected else 0), c
    cpu_obj = convert.object_from_arrays(*convert.object_to_arrays(obj), "cpu")
    cpu_obj = dataclasses.replace(
        cpu_obj, blocking=None if obj.blocking is None else
        blocking.build_blocking(
            *[t.cpu().numpy() for t in (obj.element_indices, obj.ref_inv,
                                        obj.volume, obj.rest_pos)],
            eb=32, pb=24, device="cpu"))
    cpu_state = convert.state_from_arrays(convert.state_to_arrays(state), "cpu")
    ref, _ = sim.substep(cpu_obj, cpu_state, _obstacles("cpu"), **kwargs)
    np.testing.assert_allclose(s.pos.cpu().numpy(), ref.pos.numpy(), atol=TOL)
    if case == "unblocked":
        g = explicit.analytic_energy_gradient(obj, state.pos)
        assert torch.isfinite(g).all()


# -- 2D: every kernel's triangle instance ---------------------------------

def _body_2d(sub, seed=1):
    """The 2D square of configs/default.json's material with ``sub``
    subdivisions, resting just across the floor, its positions moved by a
    tenth of an element's size and its velocities random (numpy seed)."""
    cfg = ObjectConfig(subdivisions=sub, side_length=0.2, center=(0.4, -0.005),
                       E=4e4, nu=0.2, rho=500.0, damping=14.5)
    v, f, t = pmesh.construct_2d_mesh(cfg)
    obj, state = build_object(cfg, v, f, t, device="cuda")
    rng = np.random.default_rng(seed)
    h = 0.2 / sub
    shape = tuple(state.pos.shape)
    pos = state.pos + torch.as_tensor(
        rng.uniform(-0.1 * h, 0.1 * h, shape).astype(np.float32),
        device="cuda")
    vel = torch.as_tensor(rng.uniform(-0.3, 0.3, shape).astype(np.float32),
                          device="cuda")
    vel[:, 1] -= 0.5
    return obj, state.replace(pos=pos, vel=vel)


def _obstacles_2d(device):
    """A circle over the body's top edge, the default scene's left circle
    and a radius-0 circle (never hits)."""
    blocks = (BlockConfig(block_center=(0.5, 0.2), block_radius=0.08),
              BlockConfig(block_center=(0.2, 0.5), block_radius=0.21),
              BlockConfig(block_center=(0.45, 0.1), block_radius=0.0))
    return Obstacles.from_configs(blocks, 2, device=device)


@pytest.fixture(scope="module")
def body_2d():
    """10 subdivisions, the default scene's size: one locality block."""
    _require_cuda()
    obj, state = _body_2d(10)
    assert obj.blocking.num_blocks == 1
    return obj, state


@pytest.fixture(scope="module")
def grid_2d():
    """40 subdivisions: 1,681 particles, 3,200 triangles, 16 blocks."""
    _require_cuda()
    obj, state = _body_2d(40)
    assert (obj.particle_cnt, obj.element_cnt) == (1681, 3200)
    assert obj.blocking.num_blocks == 16
    return obj, state


def _block_rel_err(got, ref):
    scale = ref.abs().reshape(ref.shape[0], -1).amax(1).clamp(min=1e-30)
    return float(((got - ref).abs() / scale[:, None, None]).max())


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("size", ["default size", "40 subdivisions"])
@pytest.mark.parametrize("kernel", ["hessian_and_force",
                                    "explicit_grad_columns"])
def test_element_kernels_2d_match_plain_and_repeat(body_2d, grid_2d, kernel,
                                                   size):
    """K1 and K6 on triangles, bit-identical twice.  At the default scene's
    size within 1e-5 (block-relative) of the plain version.  The 40-
    subdivision grid's near-rest triangles cancel F against F⁻ᵀ and log det
    F against 0, so there both f32 evaluations stray ~1e-5 from the exact
    chain: each is held to the plain version in f64, at 1e-4."""
    obj, state = body_2d if size == "default size" else grid_2d
    args = (state.pos, obj.element_indices, obj.ref_inv, obj.volume,
            obj.mu, obj.s_lambda)
    fn = getattr(element_kernels, kernel)
    plain = getattr(element_kernels, kernel + "_plain")
    before = fn.launches
    got = _as_tuple(fn(*args))
    assert fn.launches == before + 1
    if size == "default size":
        ref, tol = _as_tuple(plain(*args)), TOL
    else:
        f64 = [t.double() for t in args[:4] if t.is_floating_point()]
        ref = _as_tuple(plain(f64[0], obj.element_indices, f64[1], f64[2],
                              obj.mu, obj.s_lambda))
        tol = 1e-4
    again = _as_tuple(fn(*args))
    for g, r, a in zip(got, ref, again):
        assert g.shape == (obj.element_cnt, 2, 2)
        assert torch.isfinite(g).all()
        assert _block_rel_err(g.double(), r.double()) <= tol
        assert torch.equal(g, a)


@pytest.mark.parametrize("size", ["default size", "40 subdivisions"])
@pytest.mark.parametrize("preconditioned", [False, True])
def test_fused_cg_kernel_2d_matches_plain_and_repeats(body_2d, grid_2d,
                                                      preconditioned, size):
    """K4 on triangles, bit-identical twice.  At the default scene's size
    (short solves) iterations within 1 of the plain version and velocity
    rtol 5e-4 / atol 1e-6.  The 40-subdivision grid takes ~20-100
    iterations, where two f32 orders part by more than one: its velocity
    is held to the plain solve in f64 (1e-4 of the largest entry), as the
    3D long-solve test does."""
    obj, state = body_2d if size == "default size" else grid_2d
    k, h = element_kernels.hessian_and_force(
        state.pos, obj.element_indices, obj.ref_inv, obj.volume, obj.mu,
        obj.s_lambda,
    )
    args = (k, h, obj.element_indices, obj.plan, state.vel, obj.mass, 5e-4,
            preconditioned)
    before = cg_kernels.fused_cg_solve.launches
    v, it, res = cg_kernels.fused_cg_solve(*args)
    assert cg_kernels.fused_cg_solve.launches == before + 1
    assert int(it) > 1 and float(res) <= TOL
    if size == "default size":
        vp, itp, _ = cg_kernels.fused_cg_solve_plain(*args)
        assert int(itp) <= 20
        assert abs(int(it) - int(itp)) <= 1
        torch.testing.assert_close(v, vp, rtol=5e-4, atol=1e-6)
    else:
        f64 = [t.double() for t in (k, h, state.vel, obj.mass)]
        ref, ref_it, _ = cg_kernels.fused_cg_solve_plain(
            f64[0], f64[1], obj.element_indices, obj.plan, f64[2], f64[3],
            5e-4, preconditioned)
        assert int(ref_it) < 500
        err = float((v.double() - ref).abs().max())
        assert err <= 1e-4 * float(ref.abs().max()), err
    v2, it2, res2 = cg_kernels.fused_cg_solve(*args)
    assert torch.equal(v, v2) and torch.equal(it, it2) and torch.equal(res, res2)


def test_blocked_kernels_2d_match_plain_and_repeat(grid_2d):
    """K2, K3 (both transposes), K7b and K7a over the 16 blocks."""
    obj, state = grid_2d
    blk = obj.blocking
    args = (blk, state.pos, obj.mu, obj.s_lambda)
    k, part = blocked_kernels.blocked_prep(*args)
    kp, partp = blocked_kernels.blocked_prep_plain(*args)
    assert k.shape == (blk.num_blocks * blk.eb, 2, 2)
    assert _block_rel_err(k, kp) <= TOL
    assert float((part - partp).abs().max()) <= TOL * float(partp.abs().max())
    assert all(torch.equal(a, b) for a, b in
               zip((k, part), blocked_kernels.blocked_prep(*args)))
    for tr in (False, True):
        y = blocked_kernels.blocked_graph_apply(blk, k, state.vel, tr)
        yp = blocked_kernels.blocked_graph_apply_plain(blk, k, state.vel, tr)
        assert float(yp.abs().max()) > 0
        assert float((y - yp).abs().max()) <= TOL * float(yp.abs().max())
        assert torch.equal(
            y, blocked_kernels.blocked_graph_apply(blk, k, state.vel, tr))
    g = blocked_kernels.blocked_grad_prep(*args)
    gp = blocked_kernels.blocked_grad_prep_plain(*args)
    assert torch.isfinite(g).all()
    assert float((g - gp).abs().max()) <= TOL * float(gp.abs().max())
    assert torch.equal(g, blocked_kernels.blocked_grad_prep(*args))
    gen = torch.Generator().manual_seed(0)
    cols = torch.randn((blk.num_blocks * blk.eb, 2, 2), generator=gen).cuda()
    s = blocked_kernels.blocked_assemble(blk, cols)
    sp = blocked_kernels.blocked_assemble_plain(blk, cols)
    assert float((s - sp).abs().max()) <= TOL * float(sp.abs().max())
    assert torch.equal(s, blocked_kernels.blocked_assemble(blk, cols))


def _frame_kw_2d(obj, dt, preconditioned=None, sim_count=10):
    kw = dict(dt=dt, damping=obj.damping, g_dir=(0.0, -1.0), mu=obj.mu,
              s_lambda=obj.s_lambda, sim_count=sim_count)
    if preconditioned is not None:
        kw["preconditioned"] = preconditioned
    return kw


@pytest.mark.parametrize("variant", K5_VARIANTS)
@pytest.mark.parametrize("case", ["one block", "16 blocks"])
@pytest.mark.parametrize("preconditioned", [False, True])
def test_frame_kernel_2d_matches_plain_and_repeats(body_2d, grid_2d, case,
                                                   preconditioned, variant):
    """K5 on triangles in each variant (module K5_VARIANTS): the one-block
    scene and the 16-block grid (3 CTAs walk its blocks); positions within
    1e-5 of the plain frame.  Iterations within 1 on the one-block scene,
    whose solves are short; the 40-subdivision grid's take ~20-100
    iterations, where only the residual is held (module docstring).  One
    CTA cannot hold the grid's 1,681 particles and 16 blocks: that cluster
    raises."""
    obj, state = body_2d if case == "one block" else grid_2d
    launch = _k5_launch(variant, obj.blocking)
    obs = _obstacles_2d("cuda")
    args = (obj.blocking, state.pos, state.vel, state.vel_g, obj.mass,
            obs.centers, obs.radii)
    kw = _frame_kw_2d(obj, 5e-4, preconditioned)
    before = frame_kernels.fused_blocked_frame.launches
    if not _k5_fits(variant, obj.blocking, obj.particle_cnt):
        with pytest.raises(RuntimeError, match="shared memory"):
            frame_kernels.fused_blocked_frame(*args, **launch, **kw)
        assert frame_kernels.fused_blocked_frame.launches == before
        return
    out = frame_kernels.fused_blocked_frame(*args, **launch, **kw)
    assert frame_kernels.fused_blocked_frame.launches == before + 1
    _check_plan(variant, obj.blocking)
    ref = frame_kernels.fused_blocked_frame_plain(*args, **kw)
    it, ref_it = out[3].cpu().numpy(), ref[3].cpu().numpy()
    assert it.max() > 1 and it.max() < 500 and float(out[4].max()) <= TOL
    if case == "one block":
        assert ref_it.max() <= 20, ref_it
        assert np.all(np.abs(it - ref_it) <= 1), (it, ref_it)
    assert out[0].shape == state.pos.shape
    assert float((out[0] - ref[0]).abs().max()) <= TOL
    _check_velocities(out, ref)
    _check_barriers(out, preconditioned)
    again = frame_kernels.fused_blocked_frame(*args, **launch, **kw)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("case", ["one block", "16 blocks", "16 blocks, 3 CTAs"])
def test_explicit_frame_kernel_2d_matches_plain_and_repeats(body_2d, grid_2d,
                                                            case):
    """K8 on triangles, as the K5 test; dt 1e-4 on the 40-subdivision grid
    (its explicit stability limit), 5e-4 on the default scene's size."""
    obj, state = body_2d if case == "one block" else grid_2d
    grid = 3 if "3 CTAs" in case else 0
    dt = 5e-4 if case == "one block" else 1e-4
    obs = _obstacles_2d("cuda")
    args = (obj.blocking, state.pos, state.vel, obj.mass, obs.centers,
            obs.radii)
    before = frame_kernels.fused_explicit_frame.launches
    out = frame_kernels.fused_explicit_frame(*args, grid=grid,
                                             **_frame_kw_2d(obj, dt))
    assert frame_kernels.fused_explicit_frame.launches == before + 1
    ref = frame_kernels.fused_explicit_frame_plain(*args,
                                                   **_frame_kw_2d(obj, dt))
    assert torch.isfinite(out[0]).all()
    assert float((out[0] - ref[0]).abs().max()) <= TOL
    assert float((out[0] - state.pos).abs().max()) > 1e-4
    again = frame_kernels.fused_explicit_frame(*args, grid=grid,
                                               **_frame_kw_2d(obj, dt))
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("mode", ["explicit", "autodiff", "implicit"])
def test_2d_frame_on_cuda_matches_cpu_frame(body_2d, mode):
    """make_frame_fn on a 2D CUDA object runs K8 (explicit, autodiff) or K5
    (implicit CG) once a frame and no other kernel; the frame equals the
    CPU frame of the same kernel's plain version."""
    obj, state = body_2d
    over = dict(dim=2, g_dir=[0, -1])
    if mode == "implicit":
        key = frame_kernels.fused_blocked_frame
    else:
        over.update(use_explicit_method=True, auto_diff=mode == "autodiff")
        key = frame_kernels.fused_explicit_frame
    cfg = _frame_cfg(**over)
    counters = (element_kernels.hessian_and_force,
                element_kernels.explicit_grad_columns,
                cg_kernels.fused_cg_solve, blocked_kernels.blocked_prep,
                blocked_kernels.blocked_grad_prep,
                blocked_kernels.blocked_assemble,
                blocked_kernels.blocked_graph_apply,
                frame_kernels.fused_blocked_frame,
                frame_kernels.fused_explicit_frame)
    before = {c: c.launches for c in counters}
    s, _ = sim.make_frame_fn(obj, cfg)(state, _obstacles_2d("cuda"))
    for c in counters:
        assert c.launches - before[c] == (1 if c is key else 0), c
    cpu_obj = convert.object_from_arrays(*convert.object_to_arrays(obj), "cpu")
    cpu_state = convert.state_from_arrays(convert.state_to_arrays(state), "cpu")
    backend = "blocked" if mode == "implicit" else "blocked_explicit"
    ref, _ = sim.make_frame_fn(
        cpu_obj, dataclasses.replace(cfg, frame_backend=backend))(
            cpu_state, _obstacles_2d("cpu"))
    np.testing.assert_allclose(s.pos.cpu().numpy(), ref.pos.numpy(), atol=TOL)


def test_two_bodies_scene_runs_two_explicit_frames():
    """configs/demo_two_bodies.json through scene.load_scene: one
    make_frame_fn per body, K8 once per body a frame, each equal to its
    CPU frame."""
    import os

    from fem_tpu_torch import scene
    from fem_tpu_torch.utils.config import read_config

    _require_cuda()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = read_config(os.path.join(repo, "configs", "demo_two_bodies.json"))
    bodies, obs = scene.load_scene(cfg, device="cuda")
    cpu_bodies, cpu_obs = scene.load_scene(cfg, device="cpu")
    assert len(bodies) == 2
    before = frame_kernels.fused_explicit_frame.launches
    for body, cpu_body in zip(bodies, cpu_bodies):
        s, _ = sim.make_frame_fn(body.obj, cfg)(body.state, obs)
        ref, _ = sim.make_frame_fn(cpu_body.obj, dataclasses.replace(
            cfg, frame_backend="blocked_explicit"))(cpu_body.state, cpu_obs)
        np.testing.assert_allclose(s.pos.cpu().numpy(), ref.pos.numpy(),
                                   atol=TOL)
    assert frame_kernels.fused_explicit_frame.launches == before + 2


# -- Inelastic materials: the layered chains, K7b edges, K5 and K8 ---------

INELASTIC_MATS = {
    "plastic": dict(plastic_yield=0.02),
    "viscous": dict(viscous_mu=1e4, viscous_tau=0.03),
    "both": dict(plastic_yield=0.02, viscous_mu=1e4, viscous_tau=0.03),
}


def _inelastic_body(dim, mat, sub, side, seed=3):
    """A grid body with material ``mat``, stretched 10 % along x and
    squashed 10 % along y about its centroid (so that it yields at once),
    random velocities and internal inverses I + 0.03·noise (so that a state
    applied to the wrong element shows), from a numpy seed."""
    if dim == 2:
        cfg = ObjectConfig(subdivisions=sub, side_length=side,
                           center=(0.5, 0.45), E=4e4, nu=0.2, rho=500.0,
                           damping=8.0, **mat)
        v, f, t = pmesh.construct_2d_mesh(cfg)
    else:
        cfg = ObjectConfig(subdivisions=sub, side_length=side,
                           center=(0.4, 0.3, 0.4), E=4e4, nu=0.2, rho=500.0,
                           damping=8.0, **mat)
        v, f, t = pmesh.construct_3d_grid_mesh(cfg)
    obj, state = build_object(cfg, v, f, t, device="cuda")
    rng = np.random.default_rng(seed)
    pos = state.pos.cpu().numpy()
    c = pos.mean(axis=0, keepdims=True)
    scale = np.ones(dim)
    scale[0], scale[1] = 1.1, 0.9
    pos = c + (pos - c) * scale
    vel = rng.uniform(-0.3, 0.3, pos.shape)
    changes = dict(pos=torch.as_tensor(pos.astype(np.float32), device="cuda"),
                   vel=torch.as_tensor(vel.astype(np.float32), device="cuda"))
    for name in ("plastic_inv", "viscous_inv"):
        if getattr(state, name) is not None:
            fi = np.eye(dim) + 0.03 * rng.standard_normal(
                (obj.element_cnt, dim, dim))
            changes[name] = torch.as_tensor(fi.astype(np.float32),
                                            device="cuda")
    return obj, state.replace(**changes)


@pytest.fixture(scope="module")
def inelastic_bodies():
    """Both branches on: the 2D one-block scene's size (10 subdivisions),
    the 2D 40-subdivision grid (16 blocks; side 0.8, so that an element's
    edge, 0.02, is long beside the positions' rounding its F⁻¹ divides by)
    and the 3D grid at 5 subdivisions (3 blocks)."""
    _require_cuda()
    mat = INELASTIC_MATS["both"]
    out = {"2D one block": _inelastic_body(2, mat, 10, 0.2),
           "2D 16 blocks": _inelastic_body(2, mat, 40, 0.8),
           "3D": _inelastic_body(3, mat, 5, 0.2)}
    assert out["2D one block"][0].blocking.num_blocks == 1
    assert out["2D 16 blocks"][0].blocking.num_blocks == 16
    assert out["3D"][0].blocking.num_blocks >= 3
    return out


def _layers(obj, state):
    """(ref_inv (E, d, d), block-ordered ref_inv (B·Eb, d, d), μ, λ,
    material) of the base layer on R⁻¹·F_p⁻¹ and the Maxwell layer."""
    from fem_tpu_torch.ops import inelastic

    out = []
    for fi, mu, lam, material in inelastic.material_layers(obj, state):
        out.append((inelastic.layer_ref_inv_local(obj.ref_inv, fi),
                    inelastic.layer_ref_inv_blocked(obj.blocking, fi), mu,
                    lam, material))
    return out


@pytest.mark.parametrize("case", ["2D one block", "3D"])
def test_layer_chain_kernels_match_plain_and_repeat(inelastic_bodies, case):
    """K1, K6, K2 and K7b on each material layer — the base Neo-Hookean on
    the dynamic R⁻¹·F_p⁻¹ and the stable Neo-Hookean branch on R⁻¹·F_v⁻¹:
    within 1e-5 of the plain version (block-relative, or of the partials'
    largest entry), bit-identical twice."""
    obj, state = inelastic_bodies[case]
    blk = obj.blocking
    for r, rb, mu, lam, material in _layers(obj, state):
        args = (state.pos, obj.element_indices, r, obj.volume, mu, lam)
        k, h = element_kernels.hessian_and_force(*args, material=material)
        kp, hp = element_kernels.hessian_and_force_plain(*args, material)
        assert _block_rel_err(k, kp) <= TOL and _block_rel_err(h, hp) <= TOL
        again = element_kernels.hessian_and_force(*args, material=material)
        assert torch.equal(k, again[0]) and torch.equal(h, again[1])
        g = element_kernels.explicit_grad_columns(*args, material)
        gp = element_kernels.explicit_grad_columns_plain(*args, material)
        assert _block_rel_err(g, gp) <= TOL
        assert torch.equal(g, element_kernels.explicit_grad_columns(
            *args, material))
        bargs = (blk, state.pos, mu, lam, rb, material)
        kb, part = blocked_kernels.blocked_prep(*bargs)
        kbp, partp = blocked_kernels.blocked_prep_plain(*bargs)
        assert _block_rel_err(kb, kbp) <= TOL
        assert float((part - partp).abs().max()) <= TOL * float(
            partp.abs().max())
        assert all(torch.equal(a, b) for a, b in
                   zip((kb, part), blocked_kernels.blocked_prep(*bargs)))
        gb = blocked_kernels.blocked_grad_prep(*bargs)
        gbp = blocked_kernels.blocked_grad_prep_plain(*bargs)
        assert float((gb - gbp).abs().max()) <= TOL * float(gbp.abs().max())
        assert torch.equal(gb, blocked_kernels.blocked_grad_prep(*bargs))


@pytest.mark.parametrize("case", ["2D one block", "2D 16 blocks", "3D"])
def test_blocked_edges_kernel_matches_plain_and_repeats(inelastic_bodies,
                                                        case):
    obj, state = inelastic_bodies[case]
    blk = obj.blocking
    before = blocked_kernels.blocked_edges.launches
    x = blocked_kernels.blocked_edges(blk, state.pos)
    assert blocked_kernels.blocked_edges.launches == before + 1
    xp = blocked_kernels.blocked_edges_plain(blk, state.pos)
    assert x.shape == (blk.num_blocks * blk.eb, obj.dim, obj.dim)
    assert float((x - xp).abs().max()) <= TOL * float(xp.abs().max())
    assert torch.equal(x, blocked_kernels.blocked_edges(blk, state.pos))


def _inelastic_frame(kernel, obj, state, grid=0, plain=False, launch=None):
    from fem_tpu_torch.ops.frame_kernels import (
        fused_blocked_frame_plain,
        fused_explicit_frame_plain,
    )

    dt = 2e-4 if obj.element_cnt > 1000 else 5e-4
    kw = dict(dt=dt, damping=obj.damping,
              g_dir=(0.0, -1.0) if obj.dim == 2 else (0.0, -1.0, 0.0),
              mu=obj.mu, s_lambda=obj.s_lambda, sim_count=10,
              plastic_inv=state.plastic_inv, plastic_yield=obj.plastic_yield,
              viscous_inv=state.viscous_inv, viscous_mu=obj.viscous_mu,
              viscous_tau=obj.viscous_tau)
    obs = Obstacles.from_configs((), obj.dim, device="cuda")
    if kernel == "K5":
        fn = fused_blocked_frame_plain if plain else frame_kernels.fused_blocked_frame
        args = (obj.blocking, state.pos, state.vel, state.vel_g, obj.mass,
                obs.centers, obs.radii)
        kw["preconditioned"] = True
    else:
        fn = (fused_explicit_frame_plain if plain
              else frame_kernels.fused_explicit_frame)
        args = (obj.blocking, state.pos, state.vel, obj.mass, obs.centers,
                obs.radii)
    if not plain:
        kw.update(launch if launch is not None else dict(grid=grid))
    return fn(*args, **kw)


@pytest.mark.parametrize("case", ["2D one block", "2D 16 blocks", "3D"])
@pytest.mark.parametrize("kernel,variant", [
    ("K5", v) for v in K5_VARIANTS] + [("K8", "grid"), ("K8", "grid 3 CTAs")])
def test_inelastic_frame_kernels_match_plain_and_repeat(inelastic_bodies,
                                                        kernel, variant,
                                                        case):
    """K5 in each variant (module K5_VARIANTS) and K8 with both branches
    (each branch alone: the next test): positions and both internal
    inverses within 1e-5 of the plain frame after a frame of 10 substeps,
    two runs bit-identical; CTAs walking several blocks check the update's
    order after the advection (a grid barrier, or the CTA's own copy of the
    positions).  One CTA cannot hold the 16-block grid: that cluster
    raises."""
    obj, state = inelastic_bodies[case]
    launch = (_k5_launch(variant, obj.blocking) if kernel == "K5"
              else dict(grid=3 if "3 CTAs" in variant else 0))
    counter = (frame_kernels.fused_blocked_frame if kernel == "K5"
               else frame_kernels.fused_explicit_frame)
    before = counter.launches
    if kernel == "K5" and not _k5_fits(variant, obj.blocking,
                                       obj.particle_cnt):
        with pytest.raises(RuntimeError, match="shared memory"):
            _inelastic_frame(kernel, obj, state, launch=launch)
        assert counter.launches == before
        return
    out = _inelastic_frame(kernel, obj, state, launch=launch)
    assert counter.launches == before + 1
    if kernel == "K5":
        _check_plan(variant, obj.blocking)
        _check_barriers(out, True)
    ref = _inelastic_frame(kernel, obj, state, plain=True)
    assert len(out) == len(ref)
    assert float((out[0] - ref[0]).abs().max()) <= TOL
    for got, want, start in zip(out[-2:], ref[-2:], (state.plastic_inv,
                                                     state.viscous_inv)):
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= TOL
        assert float((got - start).abs().max()) > 1e-4
    again = _inelastic_frame(kernel, obj, state, launch=launch)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mat", ["plastic", "viscous"])
@pytest.mark.parametrize("kernel", ["K5", "K8"])
def test_inelastic_frame_kernels_one_branch(kernel, mat, dim):
    """One branch alone (the other's state None): positions and the
    branch's internal inverse within 1e-5 of the plain frame, over 2 CTAs
    walking the blocks of the 2D 16-subdivision grid (3) or of the 3D grid
    at 5 subdivisions."""
    _require_cuda()
    if dim == 2:
        obj, state = _inelastic_body(2, INELASTIC_MATS[mat], 16, 0.4)
    else:
        obj, state = _inelastic_body(3, INELASTIC_MATS[mat], 5, 0.2)
    assert obj.blocking.num_blocks >= 3
    out = _inelastic_frame(kernel, obj, state, grid=2)
    ref = _inelastic_frame(kernel, obj, state, plain=True)
    assert len(out) == len(ref) == (6 if kernel == "K5" else 3)
    for got, want in ((out[0], ref[0]), (out[-1], ref[-1])):
        assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("method", ["explicit", "implicit", "blocked",
                                    "unblocked"])
def test_layered_substep_launch_counts(inelastic_bodies, method):
    """The op-composed layered substep on the card: each chain kernel once
    per layer (two layers), K7b edges once (the blocked update; none
    without blocks), and equal to the CPU substep within 1e-5."""
    obj, state = inelastic_bodies["2D one block"]
    over = dict(dim=2, g_dir=[0, -1], frame_backend="auto")
    if method in ("explicit", "unblocked"):
        over["use_explicit_method"] = True
    if method == "blocked":
        over["operator_mode"] = "blocked"
    if method == "unblocked":
        obj = dataclasses.replace(obj, blocking=None)
    cfg = _frame_cfg(**over)
    counters = {
        "K1": element_kernels.hessian_and_force,
        "K4": cg_kernels.fused_cg_solve,
        "K2": blocked_kernels.blocked_prep,
        "K3": blocked_kernels.blocked_graph_apply,
        "K6": element_kernels.explicit_grad_columns,
        "K7b": blocked_kernels.blocked_grad_prep,
        "K7b edges": blocked_kernels.blocked_edges,
    }
    before = {k: c.launches for k, c in counters.items()}
    obs = Obstacles.from_configs((), 2, device="cuda")
    s, aux = sim.substep(obj, state, obs, **sim.substep_kwargs(cfg))
    got = {k: c.launches - before[k] for k, c in counters.items()}
    want = dict.fromkeys(counters, 0)
    want["K7b edges"] = 0 if method == "unblocked" else 1
    if method == "explicit":
        want["K7b"] = 2
    elif method == "unblocked":
        want["K6"] = 2
    elif method == "implicit":
        want.update(K1=2, K4=1)
    else:
        want.update(K2=2, K3=3 + 2 * int(aux.solver_iterations))
    assert got == want
    cpu_obj = convert.object_from_arrays(*convert.object_to_arrays(obj), "cpu")
    if method == "unblocked":
        cpu_obj = dataclasses.replace(cpu_obj, blocking=None)
    cpu_state = convert.state_from_arrays(convert.state_to_arrays(state), "cpu")
    ref, _ = sim.substep(cpu_obj, cpu_state, Obstacles.from_configs(
        (), 2, device="cpu"), **sim.substep_kwargs(cfg))
    for name in ("pos", "plastic_inv", "viscous_inv"):
        np.testing.assert_allclose(getattr(s, name).cpu().numpy(),
                                   getattr(ref, name).numpy(), rtol=0,
                                   atol=TOL, err_msg=name)


def test_demo_plastic_runs_each_body_through_k8():
    """configs/demo_plastic.json through scene.load_scene: K8 once per body
    a frame, each frame equal to its CPU frame (positions and the body's
    internal inverse)."""
    import os

    from fem_tpu_torch import scene
    from fem_tpu_torch.utils.config import read_config

    _require_cuda()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = read_config(os.path.join(repo, "configs", "demo_plastic.json"))
    bodies, obs = scene.load_scene(cfg, device="cuda")
    cpu_bodies, cpu_obs = scene.load_scene(cfg, device="cpu")
    before = frame_kernels.fused_explicit_frame.launches
    for body, cpu_body in zip(bodies, cpu_bodies):
        s, _ = sim.make_frame_fn(body.obj, cfg)(body.state, obs)
        ref, _ = sim.make_frame_fn(cpu_body.obj, dataclasses.replace(
            cfg, frame_backend="blocked_explicit"))(cpu_body.state, cpu_obs)
        for name in ("pos", "plastic_inv", "viscous_inv"):
            if getattr(ref, name) is not None:
                np.testing.assert_allclose(
                    getattr(s, name).cpu().numpy(),
                    getattr(ref, name).numpy(), atol=TOL, err_msg=name)
    assert frame_kernels.fused_explicit_frame.launches == before + 2


# -- Materials: every base material and robust Neo-Hookean ------------------

# The six non-Neo-Hookean base materials (Mooney-Rivlin at β = 0.3, which
# E = 4e4, ν = 0.2 allows) and robust Neo-Hookean, as (material, robust).
MATERIAL_CASES = {
    2: [(m, False) for m in ("stvk", "linear", "corotated",
                             "stable_neo_hookean", "mooney_rivlin:0.3",
                             "fiber:1,0.5:2")] + [("neo_hookean", True)],
    3: [(m, False) for m in ("stvk", "linear", "corotated",
                             "stable_neo_hookean", "mooney_rivlin:0.3",
                             "fiber:1,0.5,0.25")] + [("neo_hookean", True)],
}
MATERIAL_CASE_IDS = [f"{d}D-{m}{'-robust' if r else ''}"
                for d in (2, 3) for m, r in MATERIAL_CASES[d]]


@pytest.fixture(scope="module")
def material_bodies():
    """The 2D scene's size (10 subdivisions, one block) and the 3D grid at
    5 subdivisions (3 blocks), stretched and moving, elastic."""
    _require_cuda()
    return {2: _inelastic_body(2, {}, 10, 0.2), 3: _inelastic_body(3, {}, 5, 0.2)}


def _material_case(material_bodies, case):
    dim = int(case[0])
    material, robust = MATERIAL_CASES[dim][MATERIAL_CASE_IDS.index(case)
                                           - (0 if dim == 2 else 7)]
    return material_bodies[dim] + (material, robust)


@pytest.mark.parametrize("case", MATERIAL_CASE_IDS)
def test_material_chain_kernels_match_plain_and_repeat(material_bodies,
                                                       flagship, body_2d,
                                                       case):
    """K1, K2 (robust too), K6 and K7b of each material instance: within
    1e-5 of the plain version (block-relative, or of the partials' largest
    entry), bit-identical twice, counted by instance; K1 and K6 also at 1,
    33 and 4,069 elements cut from the flagship (3D) or default.json's
    square (2D): ragged tiles."""
    obj, state, material, robust = _material_case(material_bodies, case)
    mid = element_kernels.kernel_material_id(material, robust)
    o, s = flagship if obj.dim == 3 else body_2d
    for n in RAGGED:
        _check_tiled(element_kernels.hessian_and_force,
                     element_kernels.hessian_and_force_plain, _cut(o, s, n),
                     (material, robust), dict(robust=robust,
                                              material=material), mid)
        if not robust:
            _check_tiled(element_kernels.explicit_grad_columns,
                         element_kernels.explicit_grad_columns_plain,
                         _cut(o, s, n), (material,),
                         dict(material=material), mid)
    blk = obj.blocking
    args = (state.pos, obj.element_indices, obj.ref_inv, obj.volume, obj.mu,
            obj.s_lambda)
    mid = element_kernels.kernel_material_id(material, robust)
    by = dict(element_kernels.hessian_and_force.instance_launches)
    k, h = element_kernels.hessian_and_force(*args, robust, material)
    counts = element_kernels.hessian_and_force.instance_launches
    assert counts[(obj.dim, mid)] == by.get((obj.dim, mid), 0) + 1
    kp, hp = element_kernels.hessian_and_force_plain(*args, material, robust)
    assert _block_rel_err(k, kp) <= TOL and _block_rel_err(h, hp) <= TOL
    again = element_kernels.hessian_and_force(*args, robust, material)
    assert torch.equal(k, again[0]) and torch.equal(h, again[1])
    bargs = (blk, state.pos, obj.mu, obj.s_lambda, None, material)
    kb, part = blocked_kernels.blocked_prep(*bargs, robust)
    kbp, partp = blocked_kernels.blocked_prep_plain(*bargs, robust)
    assert _block_rel_err(kb, kbp) <= TOL
    assert float((part - partp).abs().max()) <= TOL * float(partp.abs().max())
    assert all(torch.equal(a, b) for a, b in
               zip((kb, part), blocked_kernels.blocked_prep(*bargs, robust)))
    if robust:
        return
    g = element_kernels.explicit_grad_columns(*args, material)
    gp = element_kernels.explicit_grad_columns_plain(*args, material)
    assert _block_rel_err(g, gp) <= TOL
    assert torch.equal(g, element_kernels.explicit_grad_columns(*args,
                                                                material))
    gb = blocked_kernels.blocked_grad_prep(*bargs)
    gbp = blocked_kernels.blocked_grad_prep_plain(*bargs)
    assert float((gb - gbp).abs().max()) <= TOL * float(gbp.abs().max())
    assert torch.equal(gb, blocked_kernels.blocked_grad_prep(*bargs))


def _material_frame(kernel, obj, state, material, robust, plain=False,
                    grid=0):
    from fem_tpu_torch.ops.frame_kernels import (
        fused_blocked_frame_plain,
        fused_explicit_frame_plain,
    )

    kw = dict(dt=5e-4, damping=obj.damping,
              g_dir=(0.0, -1.0) if obj.dim == 2 else (0.0, -1.0, 0.0),
              mu=obj.mu, s_lambda=obj.s_lambda, sim_count=10,
              material=material, plastic_inv=state.plastic_inv,
              plastic_yield=obj.plastic_yield, viscous_inv=state.viscous_inv,
              viscous_mu=obj.viscous_mu, viscous_tau=obj.viscous_tau)
    obs = Obstacles.from_configs((), obj.dim, device="cuda")
    if kernel == "K5":
        fn = (fused_blocked_frame_plain if plain
              else frame_kernels.fused_blocked_frame)
        args = (obj.blocking, state.pos, state.vel, state.vel_g, obj.mass,
                obs.centers, obs.radii)
        kw.update(preconditioned=True, robust=robust)
    else:
        fn = (fused_explicit_frame_plain if plain
              else frame_kernels.fused_explicit_frame)
        args = (obj.blocking, state.pos, state.vel, obj.mass, obs.centers,
                obs.radii)
    if not plain:
        kw["grid"] = grid
    return fn(*args, **kw)


@pytest.mark.parametrize("case", MATERIAL_CASE_IDS)
@pytest.mark.parametrize("kernel", ["K5", "K8"])
def test_material_frame_kernels_match_plain_and_repeat(material_bodies,
                                                       kernel, case):
    """K5 (robust too) and K8 of each material instance: positions within
    1e-5 of the plain frame after a frame of 10 substeps, CG iterations
    within 1 (short solves), two runs bit-identical; the 3D grid over 2
    CTAs walking its blocks."""
    obj, state, material, robust = _material_case(material_bodies, case)
    if kernel == "K8" and robust:
        pytest.skip("the explicit chain has no robust variant (no instance)")
    grid = 2 if obj.dim == 3 else 0
    out = _material_frame(kernel, obj, state, material, robust, grid=grid)
    ref = _material_frame(kernel, obj, state, material, robust, plain=True)
    assert torch.isfinite(out[0]).all()
    assert float((out[0] - ref[0]).abs().max()) <= TOL
    if kernel == "K5":
        it, itp = out[3].tolist(), ref[3].tolist()
        assert max(itp) > 0
        if max(itp) <= 20:
            assert all(abs(a - b) <= 1 for a, b in zip(it, itp)), (it, itp)
    again = _material_frame(kernel, obj, state, material, robust, grid=grid)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("kernel,dim,material", [
    ("K5", 3, "stvk"), ("K8", 2, "corotated"), ("K5", 2, "fiber:1,0.5:2"),
    ("K8", 3, "mooney_rivlin:0.3")])
def test_material_frame_kernels_with_inelastic_branches(kernel, dim,
                                                        material):
    """A base material under both inelastic branches: positions and both
    internal inverses within 1e-5 of the plain frame."""
    _require_cuda()
    obj, state = _inelastic_body(dim, dict(material=material,
                                           **INELASTIC_MATS["both"]),
                                 10 if dim == 2 else 5, 0.2)
    out = _material_frame(kernel, obj, state, material, False)
    ref = _material_frame(kernel, obj, state, material, False, plain=True)
    for got, want in zip(out[:1] + out[-2:], ref[:1] + ref[-2:]):
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("variant", K5_VARIANTS)
def test_robust_frame_kernel_on_an_inverted_tet(variant):
    """``entry.inverted_cube`` (one tet inverted and nearly flat, det F ≈
    −1.7e-5, where the robust clamp of the rhs log acts): the robust K5, in
    each variant, stays finite, equals its plain frame within 1e-5 and twice
    bit-identical, and differs from the non-robust K5.  Bit-identical
    compares the bits: the first substep's CG ends on a NaN ‖r‖² (its last
    residual update overflows f32 in the normal equations at the flat tet),
    in the plain version too, and the positions stay finite."""
    from fem_tpu_torch import entry
    from fem_tpu_torch.ops.frame_kernels import fused_blocked_frame_plain

    _require_cuda()
    cfg, obj, state, obs = entry.inverted_cube("cuda")
    args = (obj.blocking, state.pos, state.vel, state.vel_g, obj.mass,
            obs.centers, obs.radii)
    kw = dict(dt=cfg.delta_time, damping=obj.damping, g_dir=cfg.g_dir,
              mu=obj.mu, s_lambda=obj.s_lambda, preconditioned=True,
              sim_count=cfg.sim_count, robust=True)
    launch = _k5_launch(variant, obj.blocking)
    out = frame_kernels.fused_blocked_frame(*args, **launch, **kw)
    _check_plan(variant, obj.blocking)
    _check_barriers(out, True)
    again = frame_kernels.fused_blocked_frame(*args, **launch, **kw)
    ref = fused_blocked_frame_plain(*args, **kw)
    assert torch.isfinite(out[0]).all()
    assert all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(out, again))
    assert torch.isnan(ref[4][0]) and torch.isnan(out[4][0])
    assert float((out[0] - ref[0]).abs().max()) <= TOL
    nonrobust = frame_kernels.fused_blocked_frame(
        *args, **launch, **dict(kw, robust=False))
    assert not torch.equal(nonrobust[0], out[0])


# -- K9a/K9b, K10a/K10b and the implicit extensions --------------------------


@pytest.mark.parametrize("dim", [2, 3])
def test_k9_kernels_match_plain_and_repeat(body, body_2d, flagship, dim):
    """K9a and K9b (the halves of K1's Neo-Hookean chain) against their
    plain versions, block-relative 1e-5, twice bit-identical, one launch
    each; both also at 1, 33 and 4,069 elements cut from the flagship (3D)
    or default.json's square (2D): ragged tiles."""
    o, s = flagship if dim == 3 else body_2d
    for n in RAGGED:
        for kernel, plain in (
                (element_kernels.implicit_force_columns,
                 element_kernels.implicit_force_columns_plain),
                (element_kernels.hessian_blocks,
                 element_kernels.hessian_blocks_plain)):
            _check_tiled(kernel, plain, _cut(o, s, n))
    obj, state = body if dim == 3 else body_2d
    args = (state.pos, obj.element_indices, obj.ref_inv, obj.volume,
            obj.mu, obj.s_lambda)
    for kernel, plain in (
        (element_kernels.hessian_blocks, element_kernels.hessian_blocks_plain),
        (element_kernels.implicit_force_columns,
         element_kernels.implicit_force_columns_plain),
    ):
        before = kernel.launches
        got, again = kernel(*args), kernel(*args)
        assert kernel.launches == before + 2
        assert _block_rel_err(got, plain(*args)) <= TOL
        assert torch.equal(got, again)


# Particle counts of the K10 cases: ragged tiles, the flagship's 1,007 and a
# large mesh.
K10_SIZES = (1, 33, 1007, 4097, 262144)


def _k10_case(kernel, n, dim, num_circles, seed):
    """(wrapper, plain version, operands on the card) of K10a or K10b: n
    particles past every wall, 30 % of them inside the first two of
    ``num_circles`` circles."""
    from fem_tpu_torch.ops import advect_kernels

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device="cuda")

    if kernel == "K10a":
        fn, plain = advect_kernels.kinematic, advect_kernels.kinematic_plain
    else:
        fn = advect_kernels.advect_implicit
        plain = advect_kernels.advect_implicit_plain
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.1, 1.1, (n, dim))
    centers = rng.uniform(0.3, 0.7, (max(num_circles, 2), dim))
    inside = (n * 3) // 10
    pos[:inside] = centers[rng.integers(0, 2, inside)] + rng.uniform(
        -0.12, 0.12, (inside, dim))
    vel, vel_g, grad = (rng.normal(scale=s, size=(n, dim))
                        for s in (0.5, 0.5, 10.0))
    rows = ((t(pos), t(vel), t(grad), t(rng.uniform(0.5, 2.0, n)))
            if kernel == "K10a" else (t(pos), t(vel), t(vel_g)))
    return fn, plain, rows, t(centers[:num_circles]), t


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kernel", ["K10a", "K10b"])
def test_k10_kernels_match_plain_and_repeat(kernel, dim):
    """K10a and K10b against their plain versions on particles past every
    wall and inside three circles (one of radius 0), and with no circle, at
    K10_SIZES particles: 1e-6 absolute, twice bit-identical, the launch's
    plan kept in ``last_plan``."""
    _require_cuda()
    from fem_tpu_torch.ops import advect_kernels
    from fem_tpu_torch.solvers.advect import damping_decay, gravity_vector

    kw = dict(dt=5e-4, decay=damping_decay(5e-4, 10.0),
              gravity=gravity_vector((0.0, -1.0, 0.0)[:dim],
                                     torch.device("cuda")))
    for n in K10_SIZES:
        fn, plain, rows, centers, t = _k10_case(kernel, n, dim, 3, n + dim)
        for circles in ((centers, t([0.2, 0.15, 0.0])),
                        (centers[:0], t(np.zeros(0)))):
            args = rows + circles
            ref = plain(*args, **kw)
            before = fn.launches
            got, again = fn(*args, **kw), fn(*args, **kw)
            assert fn.launches == before + 2
            assert fn.last_plan == advect_kernels.advect_plan(n, dim)
            for a, b, c in zip(got, ref, again):
                assert float((a - b).abs().max()) <= 1e-6, n
                assert torch.equal(a, c), n


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kernel", ["K10a", "K10b"])
def test_k10_circle_tables_past_48_kb(kernel, dim):
    """A circle table over the 48 KB a CTA takes without opting in (5,000
    small circles: 60,000 B in 2D, 80,000 B in 3D) against the plain version at
    1e-6 and twice bit-identical; one over a CTA's 227 KB (20,000 circles)
    refused, its launch not counted."""
    _require_cuda()
    from fem_tpu_torch.solvers.advect import damping_decay, gravity_vector

    kw = dict(dt=5e-4, decay=damping_decay(5e-4, 10.0),
              gravity=gravity_vector((0.0, -1.0, 0.0)[:dim],
                                     torch.device("cuda")))
    fn, plain, rows, centers, t = _k10_case(kernel, 1007, dim, 5000,
                                            17 + dim)
    radii = t(np.linspace(0.03, 0.0, 5000))
    ref = plain(*rows, centers, radii, **kw)
    before = fn.launches
    got, again = fn(*rows, centers, radii, **kw), fn(*rows, centers, radii,
                                                     **kw)
    assert fn.launches == before + 2
    for a, b, c in zip(got, ref, again):
        assert float((a - b).abs().max()) <= 1e-6
        assert torch.equal(a, c)
    big = t(np.full((20000, dim), 0.5)), t(np.zeros(20000))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        fn(*rows, *big, **kw)
    assert fn.launches == before + 2


def _extension_counters():
    from fem_tpu_torch.ops import advect_kernels

    return (element_kernels.hessian_and_force,
            element_kernels.hessian_blocks,
            element_kernels.implicit_force_columns,
            element_kernels.explicit_grad_columns,
            cg_kernels.fused_cg_solve, blocked_kernels.blocked_prep,
            blocked_kernels.blocked_grad_prep,
            blocked_kernels.blocked_assemble,
            blocked_kernels.blocked_graph_apply,
            frame_kernels.fused_blocked_frame,
            frame_kernels.fused_explicit_frame,
            advect_kernels.kinematic, advect_kernels.advect_implicit)


@pytest.mark.parametrize("case", ["hanging", "ramp", "exact_jvp",
                                  "block_jacobi+pins", "explicit beta+load"])
def test_extension_paths_on_cuda_match_cpu(case):
    """The slice's paths on a CUDA object: one frame (one substep for the
    exact Hessian) through ``make_frame_fn``, the op-composed frame, with
    the kernels each path takes — K2 + K3 (hanging, ramp, block-Jacobi),
    K9b and nothing else (exact_jvp), K7b + K9a (explicit with β) — equal
    to the CPU's to 1e-5 with equal iterations."""
    _require_cuda()
    from fem_tpu_torch import entry

    ops = {}
    if case in ("hanging", "ramp"):
        path = f"configs/demo_{case}.json"
        cfg, obj, state, obs = entry.load_config(path, "cuda")
        ccfg, cobj, cstate, cobs = entry.load_config(path, "cpu")
        ops = {blocked_kernels.blocked_prep: cfg.sim_count}
    else:
        over = {}
        if case == "block_jacobi+pins":
            over = dict(pin_boxes=(((0.0, 0.295, 0.0), (1.0, 1.0, 1.0)),))
        elif case == "explicit beta+load":
            over = dict(damping_beta=2e-4, load_boxes=(
                ((0.0, 0.0, 0.0), (1.0, 0.2, 1.0), (0.0, -5.0, 0.0)),))
        _, state = _body(4e5)
        cfgo = ObjectConfig(subdivisions=5, side_length=0.2,
                            center=(0.4, 0.1, 0.4), E=4e5, rho=1000.0,
                            damping=10.0, **over)
        v, f, t = pmesh.construct_3d_grid_mesh(cfgo)
        obj, _ = build_object(cfgo, v, f, t, device="cuda")
        cfg = _frame_cfg(dim=3, g_dir=[0, -1, 0])
        if case == "exact_jvp":
            cfg = dataclasses.replace(cfg, hessian="exact_jvp", sim_count=1)
            ops = {element_kernels.implicit_force_columns: 1}
        elif case == "block_jacobi+pins":
            cfg = dataclasses.replace(cfg, cg_precond="block_jacobi")
            ops = {blocked_kernels.blocked_prep: cfg.sim_count}
        else:
            cfg = dataclasses.replace(cfg, use_explicit_method=True,
                                      delta_time=1e-4)
            ops = {blocked_kernels.blocked_grad_prep: cfg.sim_count,
                   element_kernels.hessian_blocks: cfg.sim_count}
        obs = Obstacles.from_configs(cfg.blocks, 3, device="cuda")
        cobj = convert.object_from_arrays(*convert.object_to_arrays(obj),
                                          "cpu")
        cstate = convert.state_from_arrays(convert.state_to_arrays(state),
                                           "cpu")
        cobs = Obstacles.from_configs(cfg.blocks, 3, device="cpu")
        ccfg = cfg
    assert not sim.supports_blocked_frame(obj, cfg)
    assert not sim.supports_explicit_blocked_frame(obj, cfg)
    counters = _extension_counters()
    before = {c: c.launches for c in counters}
    s, aux = sim.make_frame_fn(obj, cfg)(state, obs)
    torch.cuda.synchronize()
    for c in counters:
        if c is blocked_kernels.blocked_graph_apply and ops.get(
                blocked_kernels.blocked_prep):
            assert c.launches - before[c] == int(
                (1 + aux.solver_iterations.cpu()).sum()), c
        else:
            assert c.launches - before[c] == ops.get(c, 0), c
    ref, ref_aux = sim.make_frame_fn(cobj, ccfg)(cstate, cobs)
    np.testing.assert_allclose(s.pos.cpu().numpy(), ref.pos.numpy(),
                               atol=TOL)
    assert aux.solver_iterations.tolist() == ref_aux.solver_iterations.tolist()
    if obj.free_mask is not None:
        held = obj.free_mask[:, 0] == 0
        assert torch.equal(s.pos[held], state.pos[held])


# -- K11a, K11b, P1 and P2 ---------------------------------------------------


def _circles(pos):
    """Two circles over a body (one of radius 0, which never hits)."""
    c = pos.mean(dim=0)
    d = pos.shape[1]
    centers = torch.stack([c + 0.02, c]).contiguous()
    assert centers.shape == (2, d)
    return centers, torch.tensor([0.08, 0.0], device=pos.device)


@pytest.mark.parametrize("preconditioned", [False, True])
@pytest.mark.parametrize("dim", [2, 3])
def test_edge_cg_kernel_matches_plain_and_repeats(body, body_2d, dim,
                                                  preconditioned):
    """K11a against its plain version (the dense S products): iterations
    within 1, velocity rtol 5e-4 / atol 1e-6 (K4's), twice bit-identical,
    one launch a call."""
    from fem_tpu_torch.experiments import edge_cg
    from fem_tpu_torch.solvers.implicit import build_edge_matrix

    obj, state = body if dim == 3 else body_2d
    s_mat = torch.as_tensor(build_edge_matrix(
        obj.element_indices.cpu().numpy(), obj.particle_cnt), device="cuda")
    k, _ = element_kernels.hessian_and_force(
        state.pos, obj.element_indices, obj.ref_inv, obj.volume, obj.mu,
        obj.s_lambda)
    kw = dict(dim=dim, dt2=5e-4 * 5e-4, preconditioned=preconditioned)
    before = edge_cg.cg_solve_edge.launches
    x, it = edge_cg.cg_solve_edge(s_mat, k, state.vel, obj.mass, **kw)
    x2, it2 = edge_cg.cg_solve_edge(s_mat, k, state.vel, obj.mass, **kw)
    assert edge_cg.cg_solve_edge.launches == before + 2
    xp, itp = edge_cg.cg_solve_edge_plain(s_mat, k, state.vel, obj.mass, **kw)
    assert it.dtype == torch.int32 and int(it) > 1
    assert abs(int(it) - int(itp)) <= 1
    torch.testing.assert_close(x, xp, rtol=5e-4, atol=1e-6)
    assert torch.equal(x, x2) and torch.equal(it, it2)


@pytest.mark.parametrize("preconditioned", [False, True])
@pytest.mark.parametrize("dim", [2, 3])
def test_fused_frame_kernel_matches_plain_and_repeats(body, body_2d, dim,
                                                      preconditioned):
    """K11b against its plain version on the card: positions and vel_g
    within 1e-5, velocities within 1e-4 of their largest entry (a CG
    solve stopped after a few iterations: the f32 plain frame is 3e-5 to
    5e-5 of it from the f64 plain frame on the flagship and
    ``default.json``, as ``chip_smoke.py`` logs), iterations within 1 per
    substep, twice bit-identical, one launch a frame."""
    from fem_tpu_torch.experiments import fused_frame as ff

    obj, state = body if dim == 3 else body_2d
    centers, radii = _circles(state.pos)
    g = [0.0, -1.0, 0.0][:dim]
    args = (state.pos, state.vel, torch.zeros_like(state.vel), obj.ref_inv,
            obj.volume, obj.element_indices, obj.plan, obj.mass, centers,
            radii)
    kw = dict(dt=5e-4, damping=10.0, g_dir=g, mu=obj.mu,
              s_lambda=obj.s_lambda, preconditioned=preconditioned,
              sim_count=4)
    before = ff.fused_frame.launches
    out = ff.fused_frame(*args, **kw)
    again = ff.fused_frame(*args, **kw)
    assert ff.fused_frame.launches == before + 2
    ref = ff.fused_frame_plain(*args, **kw)
    assert float((out[0] - ref[0]).abs().max()) <= TOL
    assert (float((out[1] - ref[1]).abs().max())
            <= 1e-4 * float(ref[1].abs().max()))
    assert float((out[2] - ref[2]).abs().max()) <= TOL
    its, itp = out[3].tolist(), ref[3].tolist()
    assert max(its) > 0
    assert all(abs(a - b) <= 1 for a, b in zip(its, itp))
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("pair", [1, 2, 4])
@pytest.mark.parametrize("case", ["body", "body_2d", "grid_2d"])
def test_paired_matvec_kernel_matches_plain_and_k3(request, case, pair):
    """P1 against its plain version, and its per-block products summed over
    each particle's slots against K3's G(K)·x (1e-5 of the largest
    per-block entry), twice bit-identical, one launch a call counted under
    its pair, on the launch of :func:`pair_plan` (read from the library);
    the padded blocks' products are zero.  The 3D cube (3 blocks), the 2D
    square of ``default.json``'s size (one block) and the 40-subdivision
    grid (16 blocks)."""
    from fem_tpu_torch.probes import pairblock as pbk

    obj, state = request.getfixturevalue(case)
    blk = obj.blocking
    d = obj.dim
    K, _ = blocked_kernels.blocked_prep(blk, state.pos, obj.mu, obj.s_lambda)
    kp = pbk.make_kplane(blk, K)
    blk_p, kp_p, xbt_p = pbk.padded_inputs(blk, kp, state.vel, pair)
    before = pbk.paired_matvec.launches
    mine = pbk.paired_matvec.instance_launches.get((pair,), 0)
    out = pbk.paired_matvec(blk_p, kp_p, xbt_p, d, pair)
    again = pbk.paired_matvec(blk_p, kp_p, xbt_p, d, pair)
    assert pbk.paired_matvec.launches == before + 2
    assert pbk.paired_matvec.instance_launches[(pair,)] == mine + 2
    plan = pbk.pair_plan(blk.eb, blk.pb, d, pair)
    assert pbk.paired_matvec.last_plan == plan
    assert pbk.last_launch() == (plan.ctas * blk_p.num_blocks // pair,
                                 plan.threads, plan.ctas, plan.smem)
    ref = pbk.paired_matvec_plain(blk_p, kp_p, xbt_p, d, pair)
    top = float(ref.abs().max())
    assert top > 0 and float((out - ref).abs().max()) <= TOL * top
    assert torch.equal(out, again)
    assert not out[blk.num_blocks:].any()
    y = blocked_kernels.blocked_graph_apply(blk, K, state.vel)
    summed = blocking.blocked_scatter_sum(
        out[: blk.num_blocks].transpose(1, 2), blk)
    assert float((summed - y).abs().max()) <= TOL * top


@pytest.mark.parametrize("variant", ["bf16xbf16", "int8xint8", "int8xbf16"])
def test_chained_dot_kernel_matches_plain(variant):
    """P2 against its plain version at (6, 1024) × (1024, 256), 20 reps:
    int8 × int8 exactly; the bf16 variants, whose products are exact in f32
    but whose ~20,000-term sums run in another order (and in the tensor
    cores' accumulator), within 1e-4 of the largest entry."""
    _require_cuda()
    from fem_tpu_torch.probes import int8 as p2

    a, w = p2.probe_inputs(6, 1024, 256, variant, "cuda")
    before = p2.chained_dot.launches
    mine = p2.chained_dot.instance_launches.get((variant,), 0)
    out = p2.chained_dot(a, w, 20, variant)
    again = p2.chained_dot(a, w, 20, variant)
    assert p2.chained_dot.launches == before + 2
    assert p2.chained_dot.instance_launches[(variant,)] == mine + 2
    ref = p2.chained_dot_plain(a, w, 20, variant)
    assert out.dtype == ref.dtype
    if variant == "int8xint8":
        assert torch.equal(out, ref)
    else:
        top = float(ref.abs().max())
        assert float((out - ref).abs().max()) <= 1e-4 * top
    assert torch.equal(out, again)


@pytest.mark.parametrize("preconditioned", [False, True])
@pytest.mark.parametrize("variant", ["auto", "single", "cluster 1",
                                     "cluster 3", "cluster 16"])
@pytest.mark.parametrize("dim", [2, 3])
def test_fused_frame_variants_match_plain_and_count_barriers(
        body, body_2d, dim, variant, preconditioned):
    """K11b in each variant — the plan's (the cluster variant), the single
    CTA, clusters of 1, 3 and 16 CTAs forced — against its plain version at
    the tolerances of test_fused_frame_kernel_matches_plain_and_repeats,
    twice bit-identical, the barriers its kernel counted equal to
    ``frame_barriers``; a cluster of 17 is refused before any launch."""
    from fem_tpu_torch.experiments import fused_frame as ff

    obj, state = body if dim == 3 else body_2d
    centers, radii = _circles(state.pos)
    args = (state.pos, state.vel, torch.zeros_like(state.vel), obj.ref_inv,
            obj.volume, obj.element_indices, obj.plan, obj.mass, centers,
            radii)
    kw = dict(dt=5e-4, damping=10.0, g_dir=[0.0, -1.0, 0.0][:dim], mu=obj.mu,
              s_lambda=obj.s_lambda, preconditioned=preconditioned,
              sim_count=4)
    if variant == "auto":
        opts = {}
    elif variant == "single":
        opts = dict(single=True)
    else:
        opts = dict(cluster=int(variant.split()[1]))
    out = ff.fused_frame(*args, **kw, **opts)
    plan = ff.fused_frame.last_plan
    barriers = int(ff.fused_frame.last_barriers.item())
    again = ff.fused_frame(*args, **kw, **opts)
    ref = ff.fused_frame_plain(*args, **kw)
    assert plan.variant == ("single" if variant == "single" else "cluster")
    if "cluster" in opts:
        assert plan.size == opts["cluster"]
    assert float((out[0] - ref[0]).abs().max()) <= TOL
    assert (float((out[1] - ref[1]).abs().max())
            <= 1e-4 * float(ref[1].abs().max()))
    assert float((out[2] - ref[2]).abs().max()) <= TOL
    its, itp = out[3].tolist(), ref[3].tolist()
    assert max(its) > 0
    assert all(abs(a - b) <= 1 for a, b in zip(its, itp))
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert barriers == ff.frame_barriers(plan.variant, preconditioned, its)
    with pytest.raises(ValueError, match="does not fit"):
        ff.fused_frame(*args, **kw, cluster=17)


P2_SHAPES = [(6, 1024, 2048, 200), (7, 128, 64, 3), (64, 256, 128, 5),
             (1, 64, 192, 11), (33, 192, 64, 4), (5, 320, 768, 9),
             (6, 128, 64, 0), (5, 3072, 512, 13)]


@pytest.mark.parametrize("variant", ["bf16xbf16", "int8xint8", "int8xbf16"])
@pytest.mark.parametrize("shape", P2_SHAPES, ids=str)
def test_chained_dot_tilings_match_plain(shape, variant):
    """P2 at the probe's defaults and at edge shapes — rows not dividing 64,
    reps not filling a tile, 64-column slices (cols not a multiple of 256),
    n of one 64-row chunk or of several a cluster rank, no reps, clusters of
    1 to 8 CTAs: int8 × int8 exact, bf16 within 1e-4 of the largest entry,
    twice bit-identical, and the MACs the kernel counted equal to the plan's
    tiles·64·n·cols, at least reps·rows·n·cols (no rep folded)."""
    _require_cuda()
    from fem_tpu_torch.probes import int8 as p2

    rows, n, cols, reps = shape
    a, w = p2.probe_inputs(rows, n, cols, variant, "cuda")
    ref = p2.chained_dot_plain(a, w, reps, variant)
    out = p2.chained_dot(a, w, reps, variant)
    plan = p2.chained_dot.last_plan
    macs = int(p2.chained_dot.last_macs.item())
    again = p2.chained_dot(a, w, reps, variant)
    if variant == "int8xint8":
        assert torch.equal(out, ref)
    else:
        top = float(ref.abs().max()) if reps else 0.0
        assert float((out - ref).abs().max()) <= 1e-4 * top
    assert torch.equal(out, again)
    assert macs == plan.macs >= reps * rows * n * cols


# K8's launch variants: the automatic plan (the cluster variant on every
# blocking here), the grid variant with one CTA a block and with 3 CTAs
# walking the blocks, and clusters of 1, 3 and 16 CTAs.
K8_VARIANTS = ["auto", "grid", "grid 3 CTAs", "cluster 1", "cluster 3",
               "cluster 16"]


def _k8_expect(variant, obj):
    """(launch options, the plan that must run or None when the plan must
    refuse the variant) of ``variant`` on ``obj``: a cluster with more CTAs
    than blocks, or whose CTA exceeds the device's shared memory, is
    refused before any launch."""
    blk = obj.blocking
    launch = _k5_launch(variant, blk)
    on = obj.plastic_yield > 0.0 or obj.viscous_mu > 0.0
    host = (blk.block_particles.cpu().numpy(),
            blk.slot_plan.ptr.cpu().numpy(), blk.slot_plan.rows.cpu().numpy())
    limits = frame_kernels.explicit_device_limits(0, obj.dim, 0, on)
    try:
        plan = frame_kernels.explicit_frame_plan(
            *host, obj.particle_cnt, blk.eb, obj.dim, limits,
            int(obj.plastic_yield > 0.0) + int(obj.viscous_mu > 0.0),
            **launch)
    except ValueError:
        return launch, None
    return launch, plan


def _k8_case(case, body, body_2d, grid_2d, inelastic_bodies):
    """(obj, state, obstacles, frame kwargs) of a K8 variants case."""
    if case.startswith("inelastic"):
        obj, state = inelastic_bodies[case.split(" ", 1)[1]]
        dt = 2e-4 if obj.element_cnt > 1000 else 5e-4
        kw = dict(dt=dt, damping=obj.damping,
                  g_dir=(0.0, -1.0) if obj.dim == 2 else (0.0, -1.0, 0.0),
                  mu=obj.mu, s_lambda=obj.s_lambda, sim_count=10,
                  plastic_inv=state.plastic_inv,
                  plastic_yield=obj.plastic_yield,
                  viscous_inv=state.viscous_inv, viscous_mu=obj.viscous_mu,
                  viscous_tau=obj.viscous_tau)
        return obj, state, Obstacles.from_configs((), obj.dim, device="cuda"),\
            kw
    if case == "3D":
        obj, state = body
        return _reblocked(obj), state, _obstacles("cuda"), _explicit_kw(obj)
    obj, state = body_2d if case == "2D one block" else grid_2d
    dt = 5e-4 if case == "2D one block" else 1e-4
    return obj, state, _obstacles_2d("cuda"), _frame_kw_2d(obj, dt)


@pytest.mark.parametrize("variant", K8_VARIANTS)
@pytest.mark.parametrize("case", ["3D", "2D one block", "2D 16 blocks",
                                  "inelastic 3D", "inelastic 2D 16 blocks"])
def test_explicit_frame_variants_match_plain_and_count_barriers(
        body, body_2d, grid_2d, inelastic_bodies, case, variant):
    """K8 in each variant (K8_VARIANTS), elastic and with both inelastic
    branches, 2D and 3D: positions (and both internal inverses) within 1e-5
    of the plain frame, two runs bit-identical, the barriers its kernel
    counted equal to ``explicit_frame_barriers``, and every variant
    bit-identical to the grid variant (the same arithmetic in the same
    order); a variant the plan refuses raises before any launch."""
    obj, state, obs, kw = _k8_case(case, body, body_2d, grid_2d,
                                   inelastic_bodies)
    args = (obj.blocking, state.pos, state.vel, obj.mass, obs.centers,
            obs.radii)
    launch, want = _k8_expect(variant, obj)
    before = frame_kernels.fused_explicit_frame.launches
    if want is None:
        with pytest.raises(ValueError):
            frame_kernels.fused_explicit_frame(*args, **kw, **launch)
        assert frame_kernels.fused_explicit_frame.launches == before
        return
    out = frame_kernels.fused_explicit_frame(*args, **kw, **launch)
    assert frame_kernels.fused_explicit_frame.launches == before + 1
    plan = frame_kernels.fused_explicit_frame.last_plan
    barriers = int(frame_kernels.fused_explicit_frame.last_barriers.item())
    if variant == "auto":
        assert (plan.variant, plan.size) == (
            "cluster", min(obj.blocking.num_blocks, 16))
    else:
        assert (plan.variant, plan.size) == (want.variant, want.size)
    inelastic = "plastic_inv" in kw
    assert barriers == frame_kernels.explicit_frame_barriers(
        plan.variant, inelastic, kw["sim_count"])
    ref = frame_kernels.fused_explicit_frame_plain(*args, **kw)
    assert len(out) == len(ref) == (4 if inelastic else 2)
    assert torch.isfinite(out[0]).all()
    assert float((out[0] - ref[0]).abs().max()) <= TOL
    assert float((out[0] - state.pos).abs().max()) > 1e-4
    for got, want_state in zip(out[2:], ref[2:]):
        assert float((got - want_state).abs().max()) <= TOL
    again = frame_kernels.fused_explicit_frame(*args, **kw, **launch)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    grid = frame_kernels.fused_explicit_frame(
        *args, **kw, grid=obj.blocking.num_blocks)
    assert all(torch.equal(a, b) for a, b in zip(out, grid))


@pytest.mark.parametrize("mode", ["explicit", "autodiff"])
def test_explicit_frame_function_runs_the_cluster_variant(body, mode):
    """make_frame_fn's K8 frame (explicit and autodiff configs) runs the
    plan's cluster variant, binds once, counts its barriers and returns
    fresh tensors each frame."""
    obj, state = body
    obj = _reblocked(obj)
    cfg = _frame_cfg(use_explicit_method=True, auto_diff=mode == "autodiff")
    builds = frame_kernels.ExplicitFrameBinding.builds
    frame = sim.make_frame_fn(obj, cfg)
    assert frame_kernels.ExplicitFrameBinding.builds <= builds + 1
    obs = _obstacles("cuda")
    s1, _ = frame(state, obs)
    keep = s1.pos.clone()
    s2, _ = frame(s1, obs)
    torch.cuda.synchronize()
    assert frame_kernels.ExplicitFrameBinding.builds <= builds + 1
    plan = frame_kernels.fused_explicit_frame.last_plan
    assert plan.variant == "cluster"
    assert int(frame_kernels.fused_explicit_frame.last_barriers.item()) == \
        frame_kernels.explicit_frame_barriers("cluster", False, cfg.sim_count)
    assert torch.equal(s1.pos, keep)
    assert s2.pos.data_ptr() != s1.pos.data_ptr()


K4_VARIANTS = ["auto", "single", "cluster 1", "cluster 3", "cluster 16"]


def _k4_launch(variant):
    if variant == "auto":
        return {}
    if variant == "single":
        return dict(single=True)
    return dict(cluster=int(variant.split()[1]))


def _k4_fits(obj, opts):
    """Whether K4's forced cluster fits a CTA's shared memory on the
    device (one that does not is refused before any launch)."""
    from fem_tpu_torch.experiments import fused_frame as ff

    if "cluster" not in opts:
        return True
    asg = ff.cluster_assignment(
        obj.element_indices.cpu().numpy(), obj.plan.ptr.cpu().numpy(),
        obj.plan.rows.cpu().numpy(), obj.particle_cnt, opts["cluster"])
    limits = cg_kernels.device_limits(0, obj.dim)
    return (opts["cluster"] <= limits.max_cluster and ff.cluster_smem(
        *asg.sizes(), obj.dim, cg_kernels.CLUSTER_VECTORS)
        <= limits.smem_optin)


@pytest.mark.parametrize("preconditioned", [False, True])
@pytest.mark.parametrize("variant", K4_VARIANTS)
@pytest.mark.parametrize("dim", [2, 3])
def test_fused_cg_variants_match_plain_and_count_barriers(
        body, body_2d, dim, variant, preconditioned):
    """K4 in each variant — the plan's (the cluster variant), the single
    CTA, clusters of 1, 3 and 16 CTAs forced — against its plain version:
    equal iterations (short solves), velocity rtol 5e-4 / atol 1e-6, twice
    bit-identical, the barriers its kernel counted equal to
    ``fused_cg_barriers``; a cluster of 17 is refused before any
    launch."""
    obj, state = body if dim == 3 else body_2d
    k, h = element_kernels.hessian_and_force(
        state.pos, obj.element_indices, obj.ref_inv, obj.volume, obj.mu,
        obj.s_lambda)
    args = (k, h, obj.element_indices, obj.plan, state.vel, obj.mass, 5e-4,
            preconditioned)
    opts = _k4_launch(variant)
    before = cg_kernels.fused_cg_solve.launches
    if not _k4_fits(obj, opts):
        with pytest.raises(ValueError, match="does not fit"):
            cg_kernels.fused_cg_solve(*args, **opts)
        assert cg_kernels.fused_cg_solve.launches == before
        return
    v, it, res = cg_kernels.fused_cg_solve(*args, **opts)
    assert cg_kernels.fused_cg_solve.launches == before + 1
    plan = cg_kernels.fused_cg_solve.last_plan
    barriers = int(cg_kernels.fused_cg_solve.last_barriers.item())
    assert plan.variant == ("single" if variant == "single" else "cluster")
    if "cluster" in opts:
        assert plan.size == opts["cluster"]
    vp, itp, resp = cg_kernels.fused_cg_solve_plain(*args)
    assert 1 < int(itp) <= 20
    assert int(it) == int(itp)
    assert float(res) <= TOL
    torch.testing.assert_close(v, vp, rtol=5e-4, atol=1e-6)
    assert barriers == cg_kernels.fused_cg_barriers(plan.variant,
                                                    preconditioned, int(it))
    v2, it2, res2 = cg_kernels.fused_cg_solve(*args, **opts)
    assert torch.equal(v, v2) and torch.equal(it, it2) and torch.equal(res,
                                                                      res2)
    with pytest.raises(ValueError, match="does not fit"):
        cg_kernels.fused_cg_solve(*args, cluster=17)


@pytest.mark.parametrize("variant", ["auto", "single", "cluster 3"])
def test_fused_cg_variants_long_solve_match_float64(stiff_body, variant):
    """test_fused_cg_kernel_long_solve_matches_float64 for each variant of
    K4: a long normal-equations solve (~140 iterations) stops on the
    tolerance within 1e-4 (of the largest entry) of the plain solve in f64,
    with the barriers the formula places."""
    obj, state = stiff_body
    k, h = element_kernels.hessian_and_force(
        state.pos, obj.element_indices, obj.ref_inv, obj.volume, obj.mu,
        obj.s_lambda,
    )
    v, it, res = cg_kernels.fused_cg_solve(
        k, h, obj.element_indices, obj.plan, state.vel, obj.mass, 5e-4, True,
        **_k4_launch(variant))
    plan = cg_kernels.fused_cg_solve.last_plan
    assert int(cg_kernels.fused_cg_solve.last_barriers.item()) == \
        cg_kernels.fused_cg_barriers(plan.variant, True, int(it))
    assert 100 < int(it) < 500 and float(res) <= TOL
    cpu_plan = convert.object_from_arrays(
        *convert.object_to_arrays(obj), "cpu").plan
    f64 = [t.cpu().double() for t in (k, h, state.vel, obj.mass)]
    ref, ref_it, ref_res = cg_kernels.fused_cg_solve_plain(
        f64[0], f64[1], obj.element_indices.cpu(), cpu_plan, f64[2], f64[3],
        5e-4, True,
    )
    assert int(ref_it) < 500 and float(ref_res) <= TOL
    err = float((v.cpu().double() - ref).abs().max())
    assert err <= 1e-4 * float(ref.abs().max()), err


K11A_VARIANTS = ["auto", "single", "cluster 1", "cluster 3", "cluster 16"]


def _edge_case(dim, body, body_2d):
    """(S, K, b, mass, kwargs) of a K11a case: the cube or default.json's
    square, K from K1 at the moving state, b its velocities."""
    from fem_tpu_torch.solvers.implicit import build_edge_matrix

    obj, state = body if dim == 3 else body_2d
    s_mat = torch.as_tensor(build_edge_matrix(
        obj.element_indices.cpu().numpy(), obj.particle_cnt), device="cuda")
    k, _ = element_kernels.hessian_and_force(
        state.pos, obj.element_indices, obj.ref_inv, obj.volume, obj.mu,
        obj.s_lambda)
    return s_mat, k, state.vel, obj.mass, obj


def _k11a_fits(obj, opts):
    """Whether K11a's forced cluster fits the device (one that does not is
    refused before any launch)."""
    from fem_tpu_torch.experiments import edge_cg
    from fem_tpu_torch.experiments import fused_frame as ff

    if "cluster" not in opts:
        return True
    asg = ff.cluster_assignment(
        obj.element_indices.cpu().numpy(), obj.plan.ptr.cpu().numpy(),
        obj.plan.rows.cpu().numpy(), obj.particle_cnt, opts["cluster"])
    limits = edge_cg.device_limits(0, obj.dim)
    return (opts["cluster"] <= limits.max_cluster and ff.cluster_smem(
        *asg.sizes(), obj.dim, edge_cg.CLUSTER_VECTORS) <= limits.smem_optin)


@pytest.mark.parametrize("preconditioned", [False, True])
@pytest.mark.parametrize("variant", K11A_VARIANTS)
@pytest.mark.parametrize("dim", [2, 3])
def test_edge_cg_variants_match_plain_and_count_barriers(
        body, body_2d, dim, variant, preconditioned):
    """K11a in each variant — the plan's (the cluster variant), the single
    CTA, clusters of 1, 3 and 16 CTAs forced — against its plain version
    (the dense S products): equal iterations, x within 1e-5 of its largest
    entry, twice bit-identical, the barriers its kernel counted equal to
    ``edge_cg_barriers``, and within 1e-5 of the single variant (the two
    differ only in the rounding of their dot products); a cluster of 17 is
    refused before any launch."""
    from fem_tpu_torch.experiments import edge_cg

    s_mat, k, b, mass, obj = _edge_case(dim, body, body_2d)
    kw = dict(dim=dim, dt2=5e-4 * 5e-4, preconditioned=preconditioned)
    opts = _k4_launch(variant)
    before = edge_cg.cg_solve_edge.launches
    if not _k11a_fits(obj, opts):
        with pytest.raises(ValueError, match="does not fit"):
            edge_cg.cg_solve_edge(s_mat, k, b, mass, **kw, **opts)
        assert edge_cg.cg_solve_edge.launches == before
        return
    x, it = edge_cg.cg_solve_edge(s_mat, k, b, mass, **kw, **opts)
    assert edge_cg.cg_solve_edge.launches == before + 1
    plan = edge_cg.cg_solve_edge.last_plan
    barriers = int(edge_cg.cg_solve_edge.last_barriers.item())
    assert plan.variant == ("single" if variant == "single" else "cluster")
    if "cluster" in opts:
        assert plan.size == opts["cluster"]
    assert barriers == edge_cg.edge_cg_barriers(plan.variant, preconditioned,
                                                int(it))
    x2, it2 = edge_cg.cg_solve_edge(s_mat, k, b, mass, **kw, **opts)
    assert torch.equal(x, x2) and torch.equal(it, it2)
    xp, itp = edge_cg.cg_solve_edge_plain(s_mat, k, b, mass, **kw)
    assert 1 < int(itp) <= 20 and int(it) == int(itp)
    top = float(xp.abs().max())
    assert float((x - xp).abs().max()) <= TOL * top
    xs, its = edge_cg.cg_solve_edge(s_mat, k, b, mass, **kw, single=True)
    assert int(its) == int(it)
    assert float((x - xs).abs().max()) <= TOL * top
    with pytest.raises(ValueError, match="does not fit"):
        edge_cg.cg_solve_edge(s_mat, k, b, mass, **kw, cluster=17)


K3_VARIANTS = ["auto", "grid", "cluster 1", "cluster 3", "cluster 16"]


def _k3_case(case, body, body_2d, grid_2d):
    if case == "3D 3 blocks":
        return body
    if case == "3D 35 blocks":
        obj, state = body
        return _reblocked(obj), state
    return body_2d if case == "2D one block" else grid_2d


@pytest.mark.parametrize("transpose_k", [False, True])
@pytest.mark.parametrize("variant", K3_VARIANTS)
@pytest.mark.parametrize("case", ["3D 3 blocks", "3D 35 blocks",
                                  "2D one block", "2D 16 blocks"])
def test_blocked_matvec_variants_are_bit_identical(
        body, body_2d, grid_2d, case, variant, transpose_k):
    """K3 in each variant — the plan's, the two-kernel grid variant,
    clusters of 1, 3 and 16 CTAs forced — bit-identical to the two-kernel
    variant and to itself (the same two sums in the same order), within
    1e-5 of the plain version's largest entry, one launch a call, the
    barriers the cluster kernel counted equal to ``blocked_barriers``; the
    plan's variant is the cluster one unless the blocks outnumber 16 CTAs of
    two thread groups; a cluster of more CTAs than blocks, or of 17, is
    refused before any launch."""
    obj, state = _k3_case(case, body, body_2d, grid_2d)
    blk = obj.blocking
    k, _ = blocked_kernels.blocked_prep(blk, state.pos, obj.mu, obj.s_lambda)
    x = state.vel
    opts = ({} if variant == "auto" else dict(grid=True)
            if variant == "grid" else dict(cluster=int(variant.split()[1])))
    before = blocked_kernels.blocked_graph_apply.launches
    if opts.get("cluster", 0) > blk.num_blocks:
        with pytest.raises(ValueError, match="without a block"):
            blocked_kernels.blocked_graph_apply(blk, k, x, transpose_k,
                                                **opts)
        assert blocked_kernels.blocked_graph_apply.launches == before
        return
    y = blocked_kernels.blocked_graph_apply(blk, k, x, transpose_k, **opts)
    assert blocked_kernels.blocked_graph_apply.launches == before + 1
    plan = blocked_kernels.blocked_graph_apply.last_plan
    if variant == "auto":
        want = "grid" if blk.num_blocks > 32 else "cluster"
        assert (plan.variant, plan.size) == (
            want, min(blk.num_blocks, 16) if want == "cluster"
            else blk.num_blocks)
    elif "cluster" in opts:
        assert (plan.variant, plan.size) == ("cluster", opts["cluster"])
    else:
        assert plan.variant == "grid"
    if plan.variant == "cluster":
        got = int(blocked_kernels.blocked_graph_apply.last_barriers.item())
        assert got == blocked_kernels.blocked_barriers("cluster", plan.size)
    else:
        assert blocked_kernels.blocked_graph_apply.last_barriers is None
    y2 = blocked_kernels.blocked_graph_apply(blk, k, x, transpose_k, **opts)
    grid = blocked_kernels.blocked_graph_apply(blk, k, x, transpose_k,
                                               grid=True)
    assert torch.equal(y, y2) and torch.equal(y, grid)
    yp = blocked_kernels.blocked_graph_apply_plain(blk, k, x, transpose_k)
    top = float(yp.abs().max())
    assert top > 0 and float((y - yp).abs().max()) <= TOL * top
    with pytest.raises(ValueError):
        blocked_kernels.blocked_graph_apply(blk, k, x, transpose_k,
                                            cluster=17)


def test_blocked_matvec_binds_once_a_blocking(body):
    """blocked_graph_apply binds a blocking once (the plan, its tables and
    the launch arguments), binds again after a table is changed in place,
    and returns a fresh y each call."""
    obj, state = body
    blk = dataclasses.replace(obj.blocking,
                              local_rows=obj.blocking.local_rows.clone())
    k, _ = blocked_kernels.blocked_prep(blk, state.pos, obj.mu, obj.s_lambda)
    builds = blocked_kernels.BlockedBinding.builds
    y1 = blocked_kernels.blocked_graph_apply(blk, k, state.vel)
    y2 = blocked_kernels.blocked_graph_apply(blk, k, state.vel)
    assert blocked_kernels.BlockedBinding.builds == builds + 1
    assert y1.data_ptr() != y2.data_ptr() and torch.equal(y1, y2)
    blk.local_rows.add_(0)
    y3 = blocked_kernels.blocked_graph_apply(blk, k, state.vel)
    assert blocked_kernels.BlockedBinding.builds == builds + 2
    assert torch.equal(y1, y3)


# -- K2, K7b and K7a as one launch each that ends in the per-particle sum ----

SOURCE_VARIANTS = ["auto", "grid", "cluster 1", "cluster 3", "cluster 16"]


def _source_call(source, obj, state, opts, layer=None):
    """One launch of ``source`` (prep: K2's (K, f); grad: K7b's g; columns:
    K7a's assembly of the gradient's block-ordered columns) and its
    counter; ``layer`` = (block-ordered R⁻¹, μ, λ, material) or the
    object's own."""
    blk = obj.blocking
    rb, mu, lam, material = layer or (None, obj.mu, obj.s_lambda,
                                      "neo_hookean")
    if source == "prep":
        return (lambda **o: blocked_kernels.blocked_prep_force(
            blk, state.pos, mu, lam, rb, material, **opts, **o),
            blocked_kernels.blocked_prep)
    if source == "grad":
        return (lambda **o: blocked_kernels.blocked_grad_force(
            blk, state.pos, mu, lam, rb, material, **opts, **o),
            blocked_kernels.blocked_grad_prep)
    cols = element_kernels.explicit_grad_columns_plain(
        state.pos, blk.element_indices, blk.ref_inv, blk.volume, mu, lam)
    return (lambda **o: blocked_kernels.blocked_assemble(blk, cols, **opts,
                                                         **o),
            blocked_kernels.blocked_assemble)


def _source_plain(source, obj, state):
    blk = obj.blocking
    args = (blk, state.pos, obj.mu, obj.s_lambda)
    if source == "prep":
        return blocked_kernels.blocked_prep_force_plain(*args)
    if source == "grad":
        return (blocked_kernels.blocked_grad_force_plain(*args),)
    cols = element_kernels.explicit_grad_columns_plain(
        state.pos, blk.element_indices, blk.ref_inv, blk.volume, obj.mu,
        obj.s_lambda)
    return (blocked_kernels.blocked_assemble_plain(blk, cols),)


@pytest.mark.parametrize("variant", SOURCE_VARIANTS)
@pytest.mark.parametrize("case", ["3D 3 blocks", "3D 35 blocks",
                                  "2D one block", "2D 16 blocks"])
@pytest.mark.parametrize("source", ["prep", "grad", "columns"])
def test_blocked_source_variants_are_bit_identical(
        body, body_2d, grid_2d, source, case, variant):
    """K2 (K and the assembled force), K7b (the assembled gradient) and K7a
    (the assembly) in each variant — the plan's, the grid variant (one CTA
    a block, then the slot sums), clusters of 1, 3 and 16 CTAs forced:
    bit-identical to the grid variant and to themselves, within 1e-5 of the
    plain version's largest entry (K block-relative), one launch a call,
    the barriers the cluster kernel counted equal to ``blocked_barriers``;
    the plan's variant is the cluster one unless the blocks outnumber 16
    CTAs of two thread groups; a cluster of more CTAs than blocks, or of
    17, is refused before any launch."""
    obj, state = _k3_case(case, body, body_2d, grid_2d)
    blk = obj.blocking
    opts = ({} if variant == "auto" else dict(grid=True)
            if variant == "grid" else dict(cluster=int(variant.split()[1])))
    call, fn = _source_call(source, obj, state, opts)
    before = fn.launches
    if opts.get("cluster", 0) > blk.num_blocks:
        with pytest.raises(ValueError, match="without a block"):
            call()
        assert fn.launches == before
        return
    out = _as_tuple(call())
    assert fn.launches == before + 1
    plan = fn.last_plan
    if variant == "auto":
        want = "grid" if blk.num_blocks > 32 else "cluster"
        assert (plan.variant, plan.size) == (
            want, min(blk.num_blocks, 16) if want == "cluster"
            else blk.num_blocks)
    elif "cluster" in opts:
        assert (plan.variant, plan.size) == ("cluster", opts["cluster"])
    else:
        assert plan.variant == "grid" and fn.last_barriers is None
    if plan.variant == "cluster":
        got = int(fn.last_barriers.item())
        assert got == blocked_kernels.blocked_barriers("cluster", plan.size)
    again = _as_tuple(call())
    grid, _ = _source_call(source, obj, state, {})
    ref = _as_tuple(grid(grid=True) if "grid" not in opts else call())
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    plain = _source_plain(source, obj, state)
    if source == "prep":
        assert _block_rel_err(out[0], plain[0]) <= TOL
    top = float(plain[-1].abs().max())
    assert top > 0 and float((out[-1] - plain[-1]).abs().max()) <= TOL * top
    with pytest.raises(ValueError):
        call(cluster=17) if "cluster" not in opts else _source_call(
            source, obj, state, dict(cluster=17))[0]()


@pytest.mark.parametrize("case", MATERIAL_CASE_IDS)
def test_material_sources_match_their_partials_form(material_bodies, case):
    """K2's and K7b's cluster launch of each material instance (the robust
    one for K2): K equal to the partials form's, the assembled force and
    gradient bit-identical to the grid variant and within 1e-5 of the
    partials form's slot sum, counted by instance."""
    obj, state, material, robust = _material_case(material_bodies, case)
    blk = obj.blocking
    bargs = (blk, state.pos, obj.mu, obj.s_lambda, None, material)
    mid = element_kernels.kernel_material_id(material, robust)
    by = dict(blocked_kernels.blocked_prep.instance_launches)
    k, f = blocked_kernels.blocked_prep_force(*bargs, robust)
    assert blocked_kernels.blocked_prep.instance_launches[(obj.dim, mid)] == (
        by.get((obj.dim, mid), 0) + 1)
    assert blocked_kernels.blocked_prep.last_plan.variant == "cluster"
    kg, fg = blocked_kernels.blocked_prep_force(*bargs, robust, grid=True)
    assert torch.equal(k, kg) and torch.equal(f, fg)
    kb, part = blocked_kernels.blocked_prep(*bargs, robust)
    assert torch.equal(k, kb)
    fp = blocking.blocked_scatter_sum(part, blk)
    assert float((f - fp).abs().max()) <= TOL * float(fp.abs().max())
    if robust:
        return
    g = blocked_kernels.blocked_grad_force(*bargs)
    assert torch.equal(g, blocked_kernels.blocked_grad_force(*bargs,
                                                             grid=True))
    gp = blocking.blocked_scatter_sum(
        blocked_kernels.blocked_grad_prep(*bargs), blk)
    assert float((g - gp).abs().max()) <= TOL * float(gp.abs().max())


@pytest.mark.parametrize("case", ["2D one block", "3D"])
def test_layer_sources_match_their_partials_form(inelastic_bodies, case):
    """K2 and K7b on each material layer (the dynamic R⁻¹·F_p⁻¹ and the
    stable Neo-Hookean branch): one cluster launch each, bit-identical to
    the grid variant, K equal to the partials form's and f, g within 1e-5
    of its slot sum."""
    obj, state = inelastic_bodies[case]
    blk = obj.blocking
    for _, rb, mu, lam, material in _layers(obj, state):
        for source in ("prep", "grad"):
            call, fn = _source_call(source, obj, state, {},
                                    (rb, mu, lam, material))
            out = _as_tuple(call())
            assert fn.last_plan.variant == "cluster"
            assert all(torch.equal(a, b) for a, b in
                       zip(out, _as_tuple(call(grid=True))))
            bargs = (blk, state.pos, mu, lam, rb, material)
            if source == "prep":
                kb, part = blocked_kernels.blocked_prep(*bargs)
                assert torch.equal(out[0], kb)
            else:
                part = blocked_kernels.blocked_grad_prep(*bargs)
            ref = blocking.blocked_scatter_sum(part, blk)
            assert float((out[-1] - ref).abs().max()) <= TOL * float(
                ref.abs().max())


@pytest.mark.parametrize("case", ["2D one block", "2D 16 blocks", "3D"])
def test_blocked_edges_split_is_bit_identical(inelastic_bodies, case):
    """K7b edges, two CTAs a block: one launch a call, bit-identical to
    itself and within 1e-5 of the plain version."""
    obj, state = inelastic_bodies[case]
    blk = obj.blocking
    before = blocked_kernels.blocked_edges.launches
    x = blocked_kernels.blocked_edges(blk, state.pos)
    assert blocked_kernels.blocked_edges.launches == before + 1
    assert torch.equal(x, blocked_kernels.blocked_edges(blk, state.pos))
    xp = blocked_kernels.blocked_edges_plain(blk, state.pos)
    assert float((x - xp).abs().max()) <= TOL * float(xp.abs().max())


def test_explicit_and_implicit_substeps_take_one_launch_a_layer(body):
    """The op-composed blocked substeps take the force forms: K2 (one
    launch a substep, the cluster variant) and K7b likewise, and no other
    blocked prep."""
    obj, state = body
    for cfg, fn in ((_frame_cfg(operator_mode="blocked"),
                     blocked_kernels.blocked_prep),
                    (_frame_cfg(use_explicit_method=True, delta_time=1e-4),
                     blocked_kernels.blocked_grad_prep)):
        fn.variant_launches = {}
        before = fn.launches
        sim.substep(obj, state, _obstacles("cuda"),
                    **sim.substep_kwargs(cfg))
        assert fn.launches == before + 1
        assert set(fn.variant_launches) == {("cluster", obj.blocking.num_blocks
                                             if obj.blocking.num_blocks <= 16
                                             else 16)}


# -- J1: the serial Jacobi solve ---------------------------------------------

def _jacobi_system(obj, state, seed):
    """(K, b, the sparse rows, the dense system, a past anchor) of the
    body's state: K and the rhs columns from K1, the anchor numpy noise."""
    from fem_tpu_torch.ops.assembly import element_contrib_full, gather_assemble
    from fem_tpu_torch.solvers import dense, implicit

    K, H = element_kernels.hessian_and_force(
        state.pos, obj.element_indices, obj.ref_inv, obj.volume, obj.mu,
        obj.s_lambda)
    f = gather_assemble(element_contrib_full(H), obj.plan.idx)
    b = (state.vel + 5e-4 * f / obj.mass[:, None]).contiguous()
    rows = implicit.sparse_system_rows(obj, K, 5e-4).contiguous()
    a = dense.assemble_dense_system(obj, K, 5e-4).contiguous()
    rng = np.random.default_rng(seed)
    past = torch.as_tensor(
        rng.normal(scale=0.01, size=tuple(b.shape)).astype(np.float32),
        device="cuda")
    return K, b, rows, a, past


# The flagship's dense system (36 MB) is no path: the dense backend runs
# the 2D scenes.
@pytest.mark.parametrize("case,source", [
    ("2d", "sparse"), ("2d", "dense"), ("3d", "sparse"), ("3d", "dense"),
    ("flagship", "sparse")])
def test_jacobi_serial_kernel_matches_plain_and_repeats(
        request, case, source):
    """J1 against its plain version on the card: iterations (read from the
    kernel's output tensor) within 1 — the stop test ‖b − A·x‖ ≤ 1e-5
    meets ties that two orders of summation break differently (the 3D
    cube: J1's 20th sweep ends just above 1e-5, the plain one's at
    9.6e-6) — and, capped at the smaller count, equal, with x and the
    anchor within 1e-5 of the largest entry; two runs bit-identical, one
    launch a solve."""
    from fem_tpu_torch.ops import jacobi_kernels as jk

    obj, state = request.getfixturevalue(
        {"2d": "body_2d", "3d": "body", "flagship": "flagship"}[case])
    _, b, rows, a, past = _jacobi_system(obj, state, 3)
    args = ((rows, b, past, obj.jacobi_nb) if source == "sparse"
            else (a, b, past))
    before = jk.jacobi_serial.launches
    got = jk.jacobi_serial(*args)
    again = jk.jacobi_serial(*args)
    assert jk.jacobi_serial.launches == before + 2
    assert jk.jacobi_serial.last_plan.dense == (source == "dense")
    ref = jk.jacobi_serial_plain(*args)
    torch.cuda.synchronize()
    assert got.iterations.device.type == "cuda"
    assert got.iterations.dtype == torch.int32
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    it, itp = int(got.iterations), int(ref.iterations)
    assert abs(it - itp) <= 1 and min(it, itp) > 1, (it, itp)
    if it != itp:
        got = jk.jacobi_serial(*args, max_iter=min(it, itp))
        ref = jk.jacobi_serial_plain(*args, max_iter=min(it, itp))
        assert int(got.iterations) == int(ref.iterations) == min(it, itp)
    top = float(ref.x.abs().max())
    for g, r in ((got.x, ref.x), (got.past_x, ref.past_x)):
        assert float((g - r).abs().max()) <= TOL * top
    # The reported error is ‖b − A·x‖ of the returned x, up to the f32
    # rounding of the residual (9e-7 on the cube's plain solve, |b| ≤ 5).
    err64 = torch.linalg.norm(b.double().reshape(-1)
                              - a.double() @ got.x.double().reshape(-1))
    assert abs(float(got.error) - float(err64)) <= 2e-6


def test_jacobi_serial_zero_diagonal_and_rollback():
    """The JAX package's edge cases (tests/test_implicit.py:199, :270,
    :375: two particles, one component) through J1's two sources, each
    component of a 2D particle a copy of the case (J1 takes dim 2 or 3):
    the zeroed row, the rollback."""
    from fem_tpu_torch.ops import jacobi_kernels as jk

    _require_cuda()
    eye = np.eye(2)
    for a_np, past_np in ((np.diag([1.0, 1e-9]), [0.0, 0.0]),
                          (np.array([[1.0, 4.0], [5.0, 1.0]]), [7.0, 9.0])):
        a = torch.tensor(np.kron(a_np, eye), dtype=torch.float32,
                         device="cuda")
        blocks = torch.tensor(a_np[:, :, None, None] * eye,
                              dtype=torch.float32, device="cuda")
        b = torch.ones((2, 2), device="cuda")
        past = torch.tensor(np.repeat(past_np, 2).reshape(2, 2),
                            dtype=torch.float32, device="cuda")
        nb = torch.tensor([[0, 1], [0, 1]], dtype=torch.int32, device="cuda")
        for args in ((a, b, past), (blocks, b, past, nb)):
            got = jk.jacobi_serial(*args)
            ref = jk.jacobi_serial_plain(*args)
            assert int(got.iterations) == int(ref.iterations) >= 1
            top = float(ref.x.abs().max())
            for g, r in ((got.x, ref.x), (got.past_x, ref.past_x)):
                assert float((g - r).abs().max()) <= TOL * top
            if past_np[0] == 0.0:  # the zero diagonal zeroes particle 1
                assert bool((got.x[1] == 0.0).all())


def test_jacobi_serial_raises_and_never_falls_back(body, monkeypatch):
    """A failed library load raises; bad operands raise before a launch;
    the plain version is never taken for CUDA tensors."""
    from fem_tpu_torch.ops import jacobi_kernels as jk
    from fem_tpu_torch.utils import cuda_build

    obj, state = body
    _, b, rows, a, past = _jacobi_system(obj, state, 4)

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(jk, "jacobi_serial_plain", no_plain)
    with pytest.raises(TypeError):
        jk.jacobi_serial(rows.double(), b, past, obj.jacobi_nb)
    with pytest.raises(ValueError):
        jk.jacobi_serial(rows, b, past, obj.jacobi_nb[:, :1].contiguous())
    with pytest.raises(ValueError):
        jk.jacobi_serial(a[:, :-1], b, past)
    with pytest.raises(ValueError):
        jk.serial_plan(5000, 3, 29)
    with pytest.raises(ValueError):
        jk.serial_plan(100, 3, 129)

    def broken(*args, **kwargs):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(jk, "_LIB", None)
    monkeypatch.setattr(cuda_build, "load", broken)
    with pytest.raises(RuntimeError, match="nvcc"):
        jk.jacobi_serial(rows, b, past, obj.jacobi_nb)


@pytest.mark.parametrize("sweep", ["serial", "snapshot"])
def test_jacobi_frame_on_cuda_matches_cpu_frame(sweep, monkeypatch):
    """configs/demo_passage_jacobi.json from a squashed, moving start: one
    frame on the card against the CPU frame, positions within 1e-5,
    iterations within 1 a substep; serial: J1 once a substep and never its
    plain version; snapshot: no J1."""
    from fem_tpu_torch import entry
    from fem_tpu_torch.ops import jacobi_kernels as jk

    _require_cuda()
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "demo_passage_jacobi.json")
    out = {}
    for dev in ("cuda", "cpu"):
        cfg, obj, state, obs = entry.load_config(
            path, dev, sim_overrides=dict(jacobi_sweep=sweep))
        rng = np.random.default_rng(3)
        pos = state.pos.cpu().numpy()
        c = pos.mean(axis=0, keepdims=True)
        pos = (c + (pos - c) * np.array([1.1, 0.8])).astype(np.float32)
        vel = rng.uniform(-0.3, 0.3, pos.shape).astype(np.float32)
        state = state.replace(pos=torch.as_tensor(pos, device=dev),
                              vel=torch.as_tensor(vel, device=dev))
        frame = sim.make_frame_fn(obj, cfg)
        before = jk.jacobi_serial.launches
        if dev == "cuda":
            with monkeypatch.context() as m:
                m.setattr(jk, "jacobi_serial_plain", None)
                s, aux = frame(state, obs)
                torch.cuda.synchronize()
            launches = jk.jacobi_serial.launches - before
            assert launches == (cfg.sim_count if sweep == "serial" else 0)
        else:
            s, aux = frame(state, obs)
        out[dev] = (s.pos.cpu(), aux.solver_iterations.cpu())
    assert float((out["cuda"][0] - out["cpu"][0]).abs().max()) <= TOL
    assert int((out["cuda"][1] - out["cpu"][1]).abs().max()) <= 1
    assert int(out["cpu"][1].min()) > 1


@pytest.mark.parametrize("case", ["2d", "grid_2d", "3d", "flagship"])
def test_jacobi_level_variant_is_bit_identical_to_serial(request, case):
    """J1's level variant (the sparse rows' default) against its serial
    variant: x, the anchor, the iterations and the error bit-identical (the
    same x values read, the same sums in the same order); twice
    bit-identical; the levels the kernel counted equal to L × sweeps; within
    1e-5 of the plain version, iterations within 1 as in
    test_jacobi_serial_kernel_matches_plain_and_repeats (the 40-subdivision
    grid's long solve: both capped at 20 sweeps).  The 2D square's
    rows are staged in shared memory, the 40-subdivision grid's and the
    flagship's read from L2."""
    from fem_tpu_torch.ops import jacobi_kernels as jk

    obj, state = request.getfixturevalue(
        {"2d": "body_2d", "grid_2d": "grid_2d", "3d": "body",
         "flagship": "flagship"}[case])
    _, b, rows, _, past = _jacobi_system(obj, state, 3)
    args = (rows, b, past, obj.jacobi_nb)
    levels = jk.level_plan(obj.jacobi_nb).levels
    before = jk.jacobi_serial.launches
    got = jk.jacobi_serial(*args)
    plan, counted = jk.jacobi_serial.last_plan, jk.jacobi_serial.last_levels
    again = jk.jacobi_serial(*args, variant="levels")
    counted_again = jk.jacobi_serial.last_levels
    serial = jk.jacobi_serial(*args, variant="serial")
    assert jk.jacobi_serial.last_plan.variant == "serial"
    assert jk.jacobi_serial.last_levels is None
    assert jk.jacobi_serial.launches == before + 3
    ref = jk.jacobi_serial_plain(*args)
    torch.cuda.synchronize()
    assert (plan.variant, plan.levels, plan.threads) == ("levels", levels,
                                                         1024)
    assert plan.staged == (case == "2d" or case == "3d")
    for x, y, z in zip(got, again, serial):
        assert torch.equal(x, y) and torch.equal(x, z)
    it = int(got.iterations)
    assert int(counted) == int(counted_again) == levels * it
    itp = int(ref.iterations)
    assert min(it, itp) > 1, (it, itp)
    if case == "grid_2d":
        # ~95 sweeps, where the two orders of summation move the stop by a
        # few (measured 97 and 93): both held to the same 20 sweeps.
        cap = 20
    else:
        assert abs(it - itp) <= 1, (it, itp)
        cap = min(it, itp)
    if it != cap or itp != cap:
        got = jk.jacobi_serial(*args, max_iter=cap)
        ref = jk.jacobi_serial_plain(*args, max_iter=cap)
        assert int(got.iterations) == int(ref.iterations) == cap
    top = float(ref.x.abs().max())
    for g, r in ((got.x, ref.x), (got.past_x, ref.past_x)):
        assert float((g - r).abs().max()) <= TOL * top


def test_jacobi_level_variant_clocks_change_nothing(flagship):
    """J1's SM clocks (tools/torch_j1_probe.py): with them on, the level
    variant's outputs are bit-identical to those without; every phase's
    count is positive, the sweeps' above warp 0's rows and barrier waits
    together; the serial variant refuses them."""
    from fem_tpu_torch.ops import jacobi_kernels as jk

    obj, state = flagship
    _, b, rows, _, past = _jacobi_system(obj, state, 3)
    args = (rows, b, past, obj.jacobi_nb)
    clocks = torch.zeros(5, dtype=torch.int64, device="cuda")
    timed = jk.jacobi_serial(*args, clocks=clocks)
    plain = jk.jacobi_serial(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(timed, plain))
    setup, err, sweeps, work, wait = clocks.tolist()
    assert min(setup, err, sweeps, work, wait) > 0
    assert sweeps > work + wait
    with pytest.raises(ValueError, match="level variant"):
        jk.jacobi_serial(*args, variant="serial", clocks=clocks)


def test_jacobi_level_variant_edge_cases():
    """The zero diagonal and the rollback (the JAX package's edge cases, as
    test_jacobi_serial_zero_diagonal_and_rollback builds them) through the
    level variant, bit-identical to the serial variant."""
    from fem_tpu_torch.ops import jacobi_kernels as jk

    _require_cuda()
    eye = np.eye(2)
    for a_np, past_np in ((np.diag([1.0, 1e-9]), [0.0, 0.0]),
                          (np.array([[1.0, 4.0], [5.0, 1.0]]), [7.0, 9.0])):
        blocks = torch.tensor(a_np[:, :, None, None] * eye,
                              dtype=torch.float32, device="cuda")
        b = torch.ones((2, 2), device="cuda")
        past = torch.tensor(np.repeat(past_np, 2).reshape(2, 2),
                            dtype=torch.float32, device="cuda")
        nb = torch.tensor([[0, 1], [0, 1]], dtype=torch.int32, device="cuda")
        got = jk.jacobi_serial(blocks, b, past, nb, variant="levels")
        counted = jk.jacobi_serial.last_levels
        serial = jk.jacobi_serial(blocks, b, past, nb, variant="serial")
        assert all(torch.equal(x, y) for x, y in zip(got, serial))
        assert int(counted) == 2 * int(got.iterations)


def test_jacobi_level_variant_raises_and_never_falls_back(body_2d,
                                                          monkeypatch):
    """The level variant refused on the dense rows and past a CTA; a failed
    library load raises; neither plain version runs for CUDA tensors."""
    from fem_tpu_torch.ops import jacobi_kernels as jk
    from fem_tpu_torch.utils import cuda_build

    obj, state = body_2d
    _, b, rows, a, past = _jacobi_system(obj, state, 4)

    def no_plain(*args, **kwargs):
        raise AssertionError("a plain version ran on CUDA tensors")

    monkeypatch.setattr(jk, "jacobi_serial_plain", no_plain)
    monkeypatch.setattr(jk, "jacobi_levels_plain", no_plain)
    with pytest.raises(ValueError, match="sparse rows"):
        jk.jacobi_serial(a, b, past, variant="levels")
    with pytest.raises(ValueError, match="unknown J1 variant"):
        jk.jacobi_serial(rows, b, past, obj.jacobi_nb, variant="warp")
    with pytest.raises(ValueError):
        jk.jacobi_plan(4000, 3, 29, 1, "levels")

    def broken(*args, **kwargs):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(jk, "_LIB", None)
    monkeypatch.setattr(cuda_build, "load", broken)
    with pytest.raises(RuntimeError, match="nvcc"):
        jk.jacobi_serial(rows, b, past, obj.jacobi_nb)


@pytest.mark.parametrize("case", ["2d", "grid_2d", "3d"])
def test_jacobi_dense_level_variant_is_bit_identical_to_serial(request,
                                                               case):
    """J1 over the dense rows on the level schedule of their pattern (the
    Jacobi table, as solvers/dense passes it) against the serial variant
    over the same rows: x, the anchor, the iterations and the error
    bit-identical; twice bit-identical; the levels the kernel counted equal
    to L × sweeps; within 1e-5 of the plain version (both capped at 20
    sweeps on the 40-subdivision grid's long solve)."""
    from fem_tpu_torch.ops import jacobi_kernels as jk

    obj, state = request.getfixturevalue(
        {"2d": "body_2d", "grid_2d": "grid_2d", "3d": "body"}[case])
    _, b, _, a, past = _jacobi_system(obj, state, 3)
    args = (a, b, past)
    pattern = obj.jacobi_nb
    levels = jk.level_plan(pattern).levels
    before = jk.jacobi_serial.launches
    got = jk.jacobi_serial(*args, pattern=pattern)
    plan, counted = jk.jacobi_serial.last_plan, jk.jacobi_serial.last_levels
    again = jk.jacobi_serial(*args, pattern=pattern, variant="levels")
    serial = jk.jacobi_serial(*args, pattern=pattern, variant="serial")
    assert jk.jacobi_serial.last_plan.variant == "serial"
    alone = jk.jacobi_serial(*args)
    assert jk.jacobi_serial.last_plan.variant == "serial"
    assert jk.jacobi_serial.launches == before + 4
    torch.cuda.synchronize()
    assert (plan.variant, plan.dense, plan.levels, plan.threads,
            plan.staged) == ("levels", True, levels, 1024, False)
    for x, y, z, w in zip(got, again, serial, alone):
        assert torch.equal(x, y) and torch.equal(x, z) and torch.equal(x, w)
    it = int(got.iterations)
    assert int(counted) == levels * it and it > 1
    cap = 20 if case == "grid_2d" else it
    got = jk.jacobi_serial(*args, pattern=pattern, max_iter=cap)
    ref = jk.jacobi_serial_plain(*args, max_iter=cap)
    assert int(got.iterations) == int(ref.iterations) == cap
    top = float(ref.x.abs().max())
    for g, r in ((got.x, ref.x), (got.past_x, ref.past_x)):
        assert float((g - r).abs().max()) <= TOL * top


def test_jacobi_dense_level_variant_edge_cases():
    """The zero diagonal and the rollback (the JAX package's edge cases, as
    test_jacobi_serial_zero_diagonal_and_rollback builds them) over the
    dense rows with the two particles' pattern, and a particle in no
    element (its row the identity, its pattern row empty): bit-identical
    to the serial variant, the kernel's level count L × sweeps."""
    from fem_tpu_torch.ops import jacobi_kernels as jk

    _require_cuda()
    eye = np.eye(2)
    cases = [(np.diag([1.0, 1e-9]), [0.0, 0.0], [[0, 1], [0, 1]]),
             (np.array([[1.0, 4.0], [5.0, 1.0]]), [7.0, 9.0],
              [[0, 1], [0, 1]]),
             (np.array([[2.0, 0.5, 0.0], [0.5, 2.0, 0.0], [0.0, 0.0, 1.0]]),
              [0.1, 0.2, 0.3], [[0, 1], [0, 1], [-1, -1]])]
    for a_np, past_np, nb in cases:
        n = len(past_np)
        a = torch.tensor(np.kron(a_np, eye), dtype=torch.float32,
                         device="cuda")
        b = torch.ones((n, 2), device="cuda")
        past = torch.tensor(np.repeat(past_np, 2).reshape(n, 2),
                            dtype=torch.float32, device="cuda")
        pattern = torch.tensor(nb, dtype=torch.int32, device="cuda")
        got = jk.jacobi_serial(a, b, past, pattern=pattern)
        counted = jk.jacobi_serial.last_levels
        assert jk.jacobi_serial.last_plan.variant == "levels"
        serial = jk.jacobi_serial(a, b, past)
        assert all(torch.equal(x, y) for x, y in zip(got, serial))
        levels = jk.level_plan(pattern).levels
        assert int(counted) == levels * int(got.iterations)


def test_jacobi_dense_level_variant_raises_and_never_falls_back(
        body_2d, monkeypatch):
    """A bad pattern raises before a launch; a failed library load raises;
    neither plain version runs for CUDA tensors."""
    from fem_tpu_torch.ops import jacobi_kernels as jk
    from fem_tpu_torch.utils import cuda_build

    obj, state = body_2d
    _, b, rows, a, past = _jacobi_system(obj, state, 4)

    def no_plain(*args, **kwargs):
        raise AssertionError("a plain version ran on CUDA tensors")

    monkeypatch.setattr(jk, "jacobi_serial_plain", no_plain)
    monkeypatch.setattr(jk, "jacobi_levels_plain", no_plain)
    with pytest.raises(ValueError, match="dense rows only"):
        jk.jacobi_serial(rows, b, past, obj.jacobi_nb, pattern=obj.jacobi_nb)
    with pytest.raises(TypeError):
        jk.jacobi_serial(a, b, past, pattern=obj.jacobi_nb.long())
    with pytest.raises(ValueError):
        jk.jacobi_serial(a, b, past, pattern=obj.jacobi_nb[:-1].contiguous())
    with pytest.raises(ValueError, match="shared memory"):
        jk.jacobi_plan(4000, 3, None, 1, "levels")

    def broken(*args, **kwargs):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(jk, "_LIB", None)
    monkeypatch.setattr(cuda_build, "load", broken)
    with pytest.raises(RuntimeError, match="nvcc"):
        jk.jacobi_serial(a, b, past, pattern=obj.jacobi_nb)


# -- The adaptive-dt guard and the entry points -----------------------------

def _cpu_copy(obj, state):
    return (convert.object_from_arrays(*convert.object_to_arrays(obj), "cpu"),
            convert.state_from_arrays(convert.state_to_arrays(state), "cpu"))


def test_kappa_on_the_card_matches_the_cpu(flagship):
    """κ of the deformed flagship through K2 (one launch) within 1e-5
    relative of the CPU's plain κ, twice bit-identical."""
    from fem_tpu_torch.solvers import adaptive

    obj, state = flagship
    cobj, cstate = _cpu_copy(obj, state)
    before = blocked_kernels.blocked_prep.launches
    k = adaptive.kappa_estimate(obj, state.pos, 5e-4)
    k2 = adaptive.kappa_estimate(obj, state.pos, 5e-4)
    assert blocked_kernels.blocked_prep.launches == before + 2
    assert torch.equal(k, k2)
    ref = float(adaptive.kappa_estimate(cobj, cstate.pos, 5e-4))
    assert abs(float(k) - ref) <= TOL * ref


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_guarded_frame_is_k2_and_one_k5_launch(flagship, level):
    """The flagship's guarded frame (``adaptive_dt``, ``frame_backend``
    "auto" on the card) with its level forced through
    ``adaptive_dt_threshold``: K2 once and K5 once, the split level read
    once on the host, K5's barriers as the kernel counted them equal to
    ``frame_barriers`` over 10·n substeps; positions within 1e-5 of the CPU
    guarded frame (K5's plain version), iterations within 1 an inner step;
    twice bit-identical."""
    from fem_tpu_torch import entry
    from fem_tpu_torch.solvers import adaptive

    obj, state = flagship
    cfg, _, _, obs = entry.flagship("cuda")
    kappa = float(adaptive.kappa_estimate(obj, state.pos, cfg.delta_time))
    gcfg = dataclasses.replace(cfg, adaptive_dt=True,
                               adaptive_dt_threshold=kappa / (
                                   0.5 * 4.0 ** level))
    n = adaptive.LEVELS[level]
    frame = sim.make_frame_fn(obj, gcfg)
    counts = (blocked_kernels.blocked_prep.launches,
              frame_kernels.fused_blocked_frame.launches,
              adaptive.read_level.reads)
    s, aux = frame(state, obs)
    s2, aux2 = frame(state, obs)
    torch.cuda.synchronize()
    assert (blocked_kernels.blocked_prep.launches - counts[0],
            frame_kernels.fused_blocked_frame.launches - counts[1],
            adaptive.read_level.reads - counts[2]) == (2, 2, 2)
    assert torch.equal(s.pos, s2.pos) and torch.equal(s.vel, s2.vel)
    assert torch.equal(aux.solver_iterations, aux2.solver_iterations)
    plan = frame_kernels.fused_blocked_frame.last_plan
    met = int(frame_kernels.fused_blocked_frame.last_barriers.item())
    fb = frame_kernels.frame_barriers
    per_step = fb(plan.variant, True, [0]) - 1
    per_it = fb(plan.variant, True, [1]) - fb(plan.variant, True, [0])
    inner = (met - 1 - per_it * int(aux.solver_iterations.sum())) / per_step
    assert inner == cfg.sim_count * n, (met, inner)
    assert aux.solver_iterations.shape == (cfg.sim_count,)
    cobj, cstate = _cpu_copy(obj, state)
    cobs = type(obs)(obs.centers.cpu(), obs.radii.cpu())
    ref, raux = sim.make_frame_fn(
        cobj, dataclasses.replace(gcfg, frame_backend="blocked"))(cstate, cobs)
    assert float((s.pos.cpu() - ref.pos).abs().max()) <= TOL
    assert int((aux.solver_iterations.cpu()
                - raux.solver_iterations).abs().max()) <= n


def test_cli_on_the_card(tmp_path):
    """``python -m fem_tpu_torch.main`` on the card: configs/demo_spot.json,
    4 frames with K5 once a frame and nothing else, a checkpoint at frame 2
    resumed to frame 4 bit-equal to the straight run; configs/default.json
    through K8 once a frame."""
    from fem_tpu_torch import main as cli

    _require_cuda()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spot = os.path.join(repo, "configs", "demo_spot.json")
    cwd = os.getcwd()
    os.chdir(repo)
    try:
        a, b = str(tmp_path / "a"), str(tmp_path / "b")
        before = frame_kernels.fused_blocked_frame.launches
        assert cli.run(["--config", spot, "--frames", "4", "--no-render",
                        "--checkpoint-every", "2", "--output", a,
                        "--print-every", "0"]) == 0
        assert frame_kernels.fused_blocked_frame.launches == before + 4
        assert cli.run(["--config", spot, "--frames", "4", "--no-render",
                        "--checkpoint-every", "2", "--output", b,
                        "--print-every", "0", "--resume",
                        os.path.join(a, "ckpt_000002.npz")]) == 0
        ref = np.load(os.path.join(a, "ckpt_000004.npz"))
        got = np.load(os.path.join(b, "ckpt_000004.npz"))
        for key in ref.files:
            np.testing.assert_array_equal(ref[key], got[key], err_msg=key)
        before = frame_kernels.fused_explicit_frame.launches
        assert cli.run(["--config", os.path.join(repo, "configs",
                                                 "default.json"),
                        "--frames", "3", "--no-render", "--output",
                        str(tmp_path / "c"), "--print-every", "0"]) == 0
        assert frame_kernels.fused_explicit_frame.launches == before + 3
    finally:
        os.chdir(cwd)


def test_simulation_on_the_card_matches_the_cpu():
    """``Simulation`` of configs/default.json on the card (K8) and on the CPU:
    5 guarded frames, positions within 1e-5, metrics' energies within 1e-5
    relative."""
    import fem_tpu_torch

    _require_cuda()
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "default.json")
    sims = {d: fem_tpu_torch.Simulation.from_config(path, device=d)
            for d in ("cuda", "cpu")}
    before = frame_kernels.fused_explicit_frame.launches
    for s in sims.values():
        s.run(frames=5, nan_guard=True)
    assert frame_kernels.fused_explicit_frame.launches == before + 5
    assert np.abs(sims["cuda"].positions()
                  - sims["cpu"].positions()).max() <= TOL
    m, r = sims["cuda"].metrics(), sims["cpu"].metrics()
    assert abs(m.kinetic_energy - r.kinetic_energy) <= TOL * r.kinetic_energy
    assert not m.any_nan


# -- C1 and C2: the contact kernels -------------------------------------------

def _soup(seed, sizes, d, center, span):
    rng = np.random.default_rng(seed)
    n = sum(sizes)
    pos = (center - span / 2 + span * rng.random((n, d))).astype(np.float32)
    vel = rng.standard_normal((n, d)).astype(np.float32)
    return (torch.as_tensor(pos, device="cuda"),
            torch.as_tensor(vel, device="cuda"))


def _masks(seed, sizes):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        m = np.triu(rng.random((n, n)) < 0.5, 1)
        out.append(m | m.T)
    return out


@pytest.mark.parametrize("d,sizes,center,radius", [
    (2, (81, 121), 0.5, 0.0236),  # demo_two_bodies_contact.json's soup
    (3, (642, 642), 2.0, 0.1018),  # two flagship surfaces, at x ~ 2
    (3, (2780,), 2.0, 0.0399),  # the blob's masked self-pairs
    (3, (4096, 4096), 0.5, 0.0078),  # tools/probe_broadphase.py, ns 8,192
])
@pytest.mark.parametrize("friction_c,mu", [(0.0, 0.0), (1.0, 0.3)])
def test_contact_pairs_kernel_matches_plain_and_repeats(d, sizes, center,
                                                        radius, friction_c,
                                                        mu):
    """C1 against its plain version, twice bit-identical.  The matmul form
    (x·S − T over the three-term distance) cancels in f32 in both, so both
    are held to the plain version in float64: the kernel within twice the
    plain version's error there plus 1e-5 of the largest force; the
    Coulomb form (direct differences) within 1e-5 of the largest force."""
    from fem_tpu_torch.ops import contact_kernels as ck

    _require_cuda()
    span = 6 * radius * (sum(sizes) / 100) ** (1 / d)
    pos, vel = _soup(len(sizes), sizes, d, center, span)
    masks = _masks(5, sizes) if len(sizes) == 1 else [None] * len(sizes)
    tables = ck.pair_tables(sizes, masks, "cuda")
    args = (radius, 1e3, friction_c, mu, 20.0)
    before = ck.pair_forces.launches
    got = ck.pair_forces(tables, pos, vel, *args)
    again = ck.pair_forces(tables, pos, vel, *args)
    assert ck.pair_forces.launches == before + 2
    ref = ck.pair_forces_plain(tables, pos, vel, *args)
    ref64 = ck.pair_forces_plain(tables, pos.double(), vel.double(), *args)
    torch.cuda.synchronize()
    top = float(ref.abs().max())
    assert top > 0.0
    assert torch.equal(got, again)
    if mu > 0.0:
        assert float((got - ref).abs().max()) <= TOL * top
    else:
        plain64 = float((ref.double() - ref64).abs().max())
        assert float((got.double() - ref64).abs().max()) <= (
            2 * plain64 + TOL * top)


@pytest.mark.parametrize("d,n,cap,self_contact", [
    (2, 400, 2, False), (2, 400, 8, True), (3, 600, 1, False),
    (3, 600, 16, True), (3, 24576, 8, False)])
def test_contact_grid_kernel_matches_plain_and_repeats(d, n, cap,
                                                       self_contact):
    """C2 against its plain version (the same stable sort and lookup):
    within 1e-5 of the largest force, truncating caps and self-contact with
    the Coulomb cone included; twice bit-identical; the total force within
    1e-5 of Σ|f|."""
    from fem_tpu_torch import broadphase as bp
    from fem_tpu_torch.ops import contact_kernels as ck

    _require_cuda()
    radius = 0.06 if n < 1000 else 0.0045
    pos, vel = _soup(n, (n,), d, 0.5, 0.3 if n < 1000 else 0.6)
    body = torch.as_tensor((np.arange(n) % 3).astype(np.int32),
                           device="cuda")
    rest = pos.flip(0).contiguous()
    kw = dict(vel=vel, friction_c=0.5, cap=cap, self_contact=self_contact,
              mu=0.3 if self_contact else 0.0, mu_slope=20.0)
    before = ck.grid_pair_forces.launches
    got = bp.grid_contact_forces(pos, body, rest, radius, 1e3, **kw)
    again = bp.grid_contact_forces(pos, body, rest, radius, 1e3, **kw)
    assert ck.grid_pair_forces.launches == before + 2
    ref = bp.grid_contact_forces(pos.cpu(), body.cpu(), rest.cpu(), radius,
                                 1e3, **dict(kw, vel=vel.cpu()))
    torch.cuda.synchronize()
    top = float(ref.abs().max())
    assert top > 0.0
    assert torch.equal(got, again)
    assert float((got.cpu() - ref).abs().max()) <= TOL * top
    assert float(got.sum(0).abs().max()) <= TOL * float(got.abs().sum())


@pytest.mark.parametrize("d,n,cap,self_contact", [
    (2, 400, 2, False), (2, 400, 8, True), (3, 600, 1, False),
    (3, 600, 16, True), (3, 24576, 8, False)])
@pytest.mark.parametrize("friction_c,mu", [(0.0, 0.0), (0.5, 0.0),
                                           (0.5, 0.3)])
def test_contact_grid_warp_variant_is_bit_identical_to_thread(
        d, n, cap, self_contact, friction_c, mu):
    """C2's warp variant (the soup in rank order, a warp a vertex over the
    run table) against the thread variant at the inputs of
    test_contact_grid_kernel_matches_plain_and_repeats, without friction,
    with the dashpot and with the Coulomb cone: bit-identical, twice
    bit-identical, one call each; the forces' total within 1e-5 of Σ|f|."""
    from fem_tpu_torch import broadphase as bp
    from fem_tpu_torch.ops import contact_kernels as ck

    _require_cuda()
    radius = 0.06 if n < 1000 else 0.0045
    pos, vel = _soup(n, (n,), d, 0.5, 0.3 if n < 1000 else 0.6)
    body = torch.as_tensor((np.arange(n) % 3).astype(np.int32),
                           device="cuda")
    rest = pos.flip(0).contiguous()
    cell, m = bp.grid_cells(pos, radius)
    order = torch.argsort(cell, stable=True)
    cell_s = cell[order]
    runs = ck.grid_runs(cell_s, m, d)
    args = (pos, vel, rest if self_contact else None, body, cell_s, order,
            runs)
    kw = dict(friction_c=friction_c, mu=mu, mu_slope=20.0,
              self_contact=self_contact)
    before = ck.grid_pair_forces.launches
    ck.grid_pair_forces.variant_launches = {}
    warp = ck.grid_pair_forces(*args, m, radius, 1e3, cap, **kw)
    assert ck.grid_pair_forces.last_plan == ck.grid_plan(n, d, cap)
    again = ck.grid_pair_forces(*args, m, radius, 1e3, cap, **kw)
    thread = ck.grid_pair_forces(*args, m, radius, 1e3, cap,
                                 variant="thread", **kw)
    assert ck.grid_pair_forces.last_plan.variant == "thread"
    torch.cuda.synchronize()
    assert ck.grid_pair_forces.launches == before + 3
    assert ck.grid_pair_forces.variant_launches == {"warp": 2, "thread": 1}
    assert float(warp.abs().max()) > 0.0
    assert torch.equal(warp, again) and torch.equal(warp, thread)
    assert float(warp.sum(0).abs().max()) <= TOL * float(warp.abs().sum())


def test_contact_grid_variants_raise_and_never_fall_back(monkeypatch):
    from fem_tpu_torch import broadphase as bp
    from fem_tpu_torch.ops import contact_kernels as ck
    from fem_tpu_torch.utils import cuda_build

    _require_cuda()
    pos, _ = _soup(0, (20,), 3, 0.5, 0.2)
    body = torch.zeros(20, dtype=torch.int32, device="cuda")
    body[10:] = 1

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(ck, "grid_pair_forces_plain", no_plain)
    cell, m = bp.grid_cells(pos, 0.05)
    order = torch.argsort(cell, stable=True)
    cell_s = cell[order]
    runs = ck.grid_runs(cell_s, m, 3)
    head = (pos, None, None, body, cell_s, order)
    args = head + (runs, m, 0.05, 1e3, 8)
    with pytest.raises(ValueError, match="unknown C2 variant"):
        ck.grid_pair_forces(*args, variant="rows")
    for variant in ck.GRID_VARIANTS:
        with pytest.raises(TypeError):
            ck.grid_pair_forces(*head, runs.long(), m, 0.05, 1e3, 8,
                                variant=variant)
    with pytest.raises(ValueError, match="cap"):
        ck.grid_pair_forces(*args[:-1], 0)
    for variant in ck.GRID_VARIANTS:
        out = ck.grid_pair_forces(*args, variant=variant)
        assert out.device.type == "cuda"

    def broken(*args, **kwargs):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(ck, "_LIBS", {})
    monkeypatch.setattr(cuda_build, "load", broken)
    with pytest.raises(RuntimeError, match="nvcc"):
        ck.grid_pair_forces(*args)


def test_contact_kernels_raise_and_never_fall_back():
    from fem_tpu_torch import broadphase as bp
    from fem_tpu_torch.ops import contact_kernels as ck

    _require_cuda()
    pos, vel = _soup(0, (10, 10), 3, 0.5, 0.2)
    tables = ck.pair_tables((10, 10), [None, None], "cuda")
    with pytest.raises(TypeError):
        ck.pair_forces(tables, pos.double(), None, 0.05, 1e3)
    with pytest.raises(ValueError):
        ck.pair_forces(tables, pos[:15].contiguous(), None, 0.05, 1e3)
    with pytest.raises(TypeError):
        bp.grid_contact_forces(pos, tables.body_id.long(), pos, 0.05, 1e3)


@pytest.mark.parametrize("d,sizes,center,radius", [
    (2, (81, 121), 0.5, 0.0236),  # demo_two_bodies_contact.json's soup
    (2, (90,), 0.5, 0.05),  # one 2D body's masked self-pairs
    (3, (642, 642), 2.0, 0.1018),  # two flagship surfaces, at x ~ 2
    (3, (2780,), 2.0, 0.0399),  # the blob's masked self-pairs
    (3, (4096, 4096), 0.5, 0.0078),  # tools/probe_broadphase.py, ns 8,192
])
@pytest.mark.parametrize("friction_c,mu", [(0.0, 0.0), (1.0, 0.3)])
def test_contact_pairs_cluster_variant_matches_rows_variant(d, sizes, center,
                                                            radius,
                                                            friction_c, mu):
    """C1's cluster variant (its own P, and every P forced) against the rows
    variant: each row's accepted partners, counted by both kernels, equal;
    with P = 1 the forces bit-identical; twice bit-identical; the
    tolerances of test_contact_pairs_kernel_matches_plain_and_repeats
    (only the order of the sums over j differs)."""
    from fem_tpu_torch.ops import contact_kernels as ck

    _require_cuda()
    span = 6 * radius * (sum(sizes) / 100) ** (1 / d)
    pos, vel = _soup(len(sizes), sizes, d, center, span)
    masks = _masks(5, sizes) if len(sizes) == 1 else [None] * len(sizes)
    tables = ck.pair_tables(sizes, masks, "cuda")
    n = sum(sizes)
    args = (radius, 1e3, friction_c, mu, 20.0)

    def run(**kw):
        acc = torch.full((n,), -1, dtype=torch.int32, device="cuda")
        return ck.pair_forces(tables, pos, vel, *args, accepted=acc,
                              **kw), acc

    rows_f, rows_acc = run(variant="rows")
    assert ck.pair_forces.last_plan.variant == "rows"
    got, acc = run()
    plan = ck.pair_forces.last_plan
    again, acc_again = run()
    ref = ck.pair_forces_plain(tables, pos, vel, *args)
    ref64 = ck.pair_forces_plain(tables, pos.double(), vel.double(), *args)
    torch.cuda.synchronize()
    assert plan == ck.contact_plan(n)
    top = float(ref.abs().max())
    plain64 = float((ref.double() - ref64).abs().max())
    assert top > 0.0 and int(rows_acc.sum()) > 0
    assert torch.equal(got, again) and torch.equal(acc, acc_again)
    for p in ck.PAIR_CLUSTERS:
        forced, forced_acc = run(cluster=p)
        assert ck.pair_forces.last_plan.cluster == p
        assert torch.equal(forced_acc, rows_acc), p
        if p == 1:
            assert torch.equal(forced, rows_f)
        if p == plan.cluster:
            assert torch.equal(forced, got)
        if mu > 0.0:
            assert float((forced - ref).abs().max()) <= TOL * top
        else:
            assert float((forced.double() - ref64).abs().max()) <= (
                2 * plain64 + TOL * top)


def test_contact_pairs_variants_raise_and_never_fall_back(monkeypatch):
    from fem_tpu_torch.ops import contact_kernels as ck

    _require_cuda()
    pos, vel = _soup(0, (10, 10), 3, 0.5, 0.2)
    tables = ck.pair_tables((10, 10), [None, None], "cuda")

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(ck, "pair_forces_plain", no_plain)
    with pytest.raises(ValueError, match="clusters"):
        ck.pair_forces(tables, pos, vel, 0.05, 1e3, cluster=3)
    with pytest.raises(ValueError, match="unknown C1 variant"):
        ck.pair_forces(tables, pos, vel, 0.05, 1e3, variant="warp")
    with pytest.raises(TypeError):
        ck.pair_forces(tables, pos, vel, 0.05, 1e3,
                       accepted=torch.zeros(20, device="cuda"))
    for variant in ck.PAIR_VARIANTS:
        out = ck.pair_forces(tables, pos, vel, 0.05, 1e3, variant=variant)
        assert out.device.type == "cuda"


@pytest.mark.parametrize("over", [
    dict(), dict(auto_diff=True),
    dict(use_explicit_method=False, implicit_method=1, preconditioned=1),
    dict(contact_broadphase="grid", contact_mu=0.3, self_contact=True)])
def test_contact_frame_on_cuda_matches_cpu_frame(over):
    """tests/test_contact.py's two squares in contact, one coupled frame
    of 10 substeps on the card and on the CPU: C1 (or C2) once a substep,
    positions within 1e-5, iterations equal."""
    import fem_tpu_torch
    from fem_tpu_torch.ops import contact_kernels as ck

    _require_cuda()
    data = dict(dim=2, delta_time=5e-4, sim_count=10, auto_diff=False,
                use_explicit_method=True, g_dir=[0, -1], contact="penalty",
                blocks=[], objects=[
                    dict(id=0, center=[0.5, 0.35], side_length=0.18,
                         subdivisions=5, rho=800, E=8e4, nu=0.25),
                    dict(id=1, center=[0.5, 0.54], side_length=0.18,
                         subdivisions=5, rho=500, E=4e4, nu=0.25)])
    data.update(over)
    sims = {d: fem_tpu_torch.Simulation.from_dict(data, device=d)
            for d in ("cuda", "cpu")}
    grid = over.get("contact_broadphase") == "grid"
    fn = ck.grid_pair_forces if grid else ck.pair_forces
    before = fn.launches
    states, auxes = {}, {}
    for d, s in sims.items():
        states[d], auxes[d] = s._contact_frame(
            tuple(b.state for b in s.scene), s.obstacles)
    assert fn.launches == before + 10
    for a, b in zip(states["cuda"], states["cpu"]):
        assert float((a.pos.cpu() - b.pos).abs().max()) <= TOL
    for a, b in zip(auxes["cuda"], auxes["cpu"]):
        assert torch.equal(a.solver_iterations.cpu(), b.solver_iterations)


# -- differentiable rollouts (fem_tpu_torch/diff.py) -------------------------

DIFF_TOL = 1e-3  # gradients, as tests/test_torch_diff_implicit.py holds them


@pytest.fixture(scope="module")
def diff_flagship():
    """(cfg, obj, deformed state, obstacles) of the flagship and the target
    trajectory of one frame at 1.5× μ, made on the card."""
    _require_cuda()
    from fem_tpu_torch import diff, entry

    cfg, obj, state, obs = entry.flagship("cuda")
    state = entry.deformed(state)
    p = diff.params_from_object(obj)
    with torch.no_grad():
        target = diff.make_diff_rollout_fn(obj, cfg, cfg.sim_count)(
            p._replace(mu=1.5 * p.mu), state, obs)[1]
    return cfg, obj, state, obs, target


def _diff_grads(cfg, obj, state, obs, target, remat=True):
    """(loss, gradients in μ, λ, the damping and the initial velocity) of
    the flagship frame's trajectory MSE."""
    from fem_tpu_torch import diff

    p = diff.params_from_object(obj)
    leaves = [t.requires_grad_(True) for t in p[:3]]
    v0 = state.vel.clone().requires_grad_(True)
    _, traj = diff.make_diff_rollout_fn(obj, cfg, cfg.sim_count,
                                        remat=remat)(
        diff.DiffParams(*leaves), state.replace(vel=v0), obs)
    loss = torch.mean((traj - target) ** 2)
    return loss.detach(), torch.autograd.grad(loss, leaves + [v0])


def _grads_close(got, ref):
    (loss, g), (rloss, r) = got, ref
    assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
    for a, b in zip(g, r):
        a, b = a.cpu(), b.cpu()
        scale = float(b.abs().max())
        assert scale > 0.0
        assert float((a - b).abs().max()) <= DIFF_TOL * scale


def test_diff_rollout_k3_matches_plain_products(diff_flagship, monkeypatch):
    """The implicit diff rollout on the flagship with every G(K)·x on K3
    against the same rollout with K3's plain version on the card: K3
    launches as ``implicit_graph_products`` predicts, none with the plain
    products; loss and gradients within DIFF_TOL."""
    from fem_tpu_torch import diff

    cfg, obj, state, obs, target = diff_flagship
    k3 = blocked_kernels.blocked_graph_apply
    before = sum(k3.variant_launches.values())
    got = _diff_grads(cfg, obj, state, obs, target)
    assert sum(k3.variant_launches.values()) - before == \
        diff.implicit_graph_products(obj, cfg.sim_count)
    before = sum(k3.variant_launches.values())
    monkeypatch.setattr(blocked_kernels, "blocked_graph_apply",
                        lambda blk, K, x, t=False:
                        blocked_kernels.blocked_graph_apply_plain(blk, K, x,
                                                                  t))
    plain = _diff_grads(cfg, obj, state, obs, target)
    assert sum(k3.variant_launches.values()) == before
    _grads_close(got, plain)


def test_diff_rollout_card_matches_cpu(diff_flagship):
    cfg, obj, state, obs, target = diff_flagship
    c_obj = convert.object_from_arrays(*convert.object_to_arrays(obj), "cpu")
    c_state = convert.state_from_arrays(convert.state_to_arrays(state),
                                        "cpu")
    c_obs = Obstacles(obs.centers.cpu(), obs.radii.cpu())
    _grads_close(_diff_grads(cfg, obj, state, obs, target),
                 _diff_grads(cfg, c_obj, c_state, c_obs, target.cpu()))


def test_diff_gradients_bit_identical(diff_flagship):
    """Two gradients on the card bit-identical, and equal with ``remat``
    off: no backward adds floats by atomics."""
    cfg, obj, state, obs, target = diff_flagship
    a = _diff_grads(cfg, obj, state, obs, target)
    b = _diff_grads(cfg, obj, state, obs, target)
    c = _diff_grads(cfg, obj, state, obs, target, remat=False)
    for other in (b, c):
        assert torch.equal(a[0], other[0])
        for x, y in zip(a[1], other[1]):
            assert torch.equal(x, y)


# -- H1, the exact stiffness apply ----------------------------------------


@pytest.fixture(scope="module")
def stiffness_bodies():
    """{d: (object, positions)}: the deformed flagship and
    ``configs/default.json``'s square with a numpy-seeded deformation."""
    _require_cuda()
    from fem_tpu_torch import entry, scene

    _, obj, state, _ = entry.flagship("cuda")
    bodies, _ = scene.load_scene(
        parse_config(json.load(open(os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "configs", "default.json")))), device="cuda")
    o2 = bodies[0].obj
    rng = np.random.default_rng(0)
    p2 = bodies[0].state.pos + torch.as_tensor(rng.uniform(
        -0.005, 0.005, tuple(bodies[0].state.pos.shape)).astype(np.float32),
        device="cuda")
    return {3: (obj, entry.deformed(state).pos), 2: (o2, p2)}


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("c", [1, 8, 9])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stiffness_apply_matches_plain_and_repeats(stiffness_bodies, d, c,
                                                   dtype):
    """H1 against its plain version on the card, within 1e-6 (f32) / 1e-13
    (f64) of the largest entry, and twice bit-identical; the rows variant
    (the default) equal bit for bit to the slots variant (the first
    design); (N, d) the same as one column; one launch an apply."""
    from fem_tpu_torch.ops import stiffness_kernels as sk
    from fem_tpu_torch.solvers import modal

    obj, pos = stiffness_bodies[d]
    o = convert.to_dtype(obj, dtype)
    kv = modal.make_stiffness_hvp(o, pos.to(dtype))
    b = kv.binding
    assert torch.equal(b.slot_of_row.cpu(), sk.slot_order(obj.plan.rows.cpu()))
    w = torch.randn((obj.particle_cnt, d, c), generator=torch.Generator(
        ).manual_seed(c), dtype=dtype).cuda()
    before = sk.stiffness_apply.launches
    got, again = kv(w), kv(w)
    assert sk.stiffness_apply.launches - before == 2
    assert sk.stiffness_apply.last_plan == sk.stiffness_plan(
        obj.particle_cnt, d, c, dtype, obj.element_cnt)
    slots = sk.stiffness_apply(b, w, variant="slots")
    assert sk.stiffness_apply.last_plan == sk.stiffness_plan(
        obj.particle_cnt, d, c, dtype, obj.element_cnt, "slots")
    ref = sk.stiffness_apply_plain(b.jac, w, b.element_indices, b.plan_idx)
    torch.cuda.synchronize()
    tol = 1e-6 if dtype == torch.float32 else 1e-13
    assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())
    assert torch.equal(got, again)
    assert torch.equal(got, slots)
    one = kv(w[..., 0].contiguous())
    assert torch.equal(one, kv(w[..., :1].contiguous())[..., 0])
    assert torch.equal(one, sk.stiffness_apply(b, w[..., 0].contiguous(),
                                               variant="slots"))


def test_stiffness_apply_refusals(stiffness_bodies):
    """The plan refuses what the kernel does not take; a mismatched w
    raises before a launch; nothing falls back."""
    from fem_tpu_torch.ops import stiffness_kernels as sk
    from fem_tpu_torch.solvers import modal

    obj, pos = stiffness_bodies[3]
    kv = modal.make_stiffness_hvp(obj, pos)
    before = sk.stiffness_apply.launches
    with pytest.raises(TypeError):
        kv(torch.zeros((obj.particle_cnt, 3), dtype=torch.float64,
                       device="cuda"))
    with pytest.raises(ValueError):
        kv(torch.zeros((obj.particle_cnt + 1, 3), device="cuda"))
    with pytest.raises(ValueError):
        sk.stiffness_plan(obj.particle_cnt, 4, 1, torch.float32,
                          obj.element_cnt)
    with pytest.raises(ValueError):
        sk.stiffness_plan(obj.particle_cnt, 3, 0, torch.float32,
                          obj.element_cnt)
    w = torch.zeros((obj.particle_cnt, 3), device="cuda")
    with pytest.raises(ValueError, match="unknown H1 variant"):
        sk.stiffness_apply(kv.binding, w, variant="tiles")
    assert sk.stiffness_apply.launches == before


# -- element sharding: the kernels on a rank's tables --------------------------

@pytest.mark.parametrize("world", [2, 4, 8])
def test_sharded_blocks_match_plain_and_sum_to_unsharded(flagship, world):
    """K3 and K2 on each rank's blocks of the flagship
    (``blocking.shard_blocking``: 9, 5 and 3 blocks a rank at 2, 4 and 8
    ranks, padded blocks empty) against their plain versions (1e-5 of the
    largest entry, K block-relative 1e-5), twice bit-identical; the ranks'
    products summed in rank order equal the unsharded ones within 1e-6 of
    the largest entry."""
    obj, state = flagship
    blk, pos = obj.blocking, state.pos
    x = state.vel + 0.3 * torch.randn(
        state.vel.shape, generator=torch.Generator().manual_seed(21)).cuda()
    K, f = blocked_kernels.blocked_prep_force(blk, pos, obj.mu, obj.s_lambda)
    y = blocked_kernels.blocked_graph_apply(blk, K, x)
    y_sum, f_sum = torch.zeros_like(y), torch.zeros_like(f)
    for rank in range(world):
        lb = blocking.shard_blocking(blk, rank, world)
        assert lb.num_blocks == -(-17 // world)
        k_r, f_r = blocked_kernels.blocked_prep_force(lb, pos, obj.mu,
                                                      obj.s_lambda)
        k_p, f_p = blocked_kernels.blocked_prep_force_plain(
            lb, pos, obj.mu, obj.s_lambda)
        y_r = blocked_kernels.blocked_graph_apply(lb, k_r, x)
        assert blocked_kernels.blocked_graph_apply.last_plan.size == \
            min(lb.num_blocks, 16)
        y_p = blocked_kernels.blocked_graph_apply_plain(lb, k_r, x)
        k_r2, f_r2 = blocked_kernels.blocked_prep_force(lb, pos, obj.mu,
                                                        obj.s_lambda)
        y_r2 = blocked_kernels.blocked_graph_apply(lb, k_r, x)
        torch.cuda.synchronize()
        scale = (k_p.abs().reshape(k_p.shape[0], -1).amax(dim=1)
                 .clamp(min=1e-30)[:, None, None])
        assert float(((k_r - k_p).abs() / scale).max()) <= TOL
        for got, ref in ((f_r, f_p), (y_r, y_p)):
            assert float((got - ref).abs().max()) <= TOL * max(
                float(ref.abs().max()), 1e-30)
        assert torch.equal(k_r, k_r2) and torch.equal(f_r, f_r2)
        assert torch.equal(y_r, y_r2)
        y_sum, f_sum = y_sum + y_r, f_sum + f_r
    for got, ref in ((y_sum, y), (f_sum, f)):
        assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


@pytest.mark.parametrize("world", [2, 4, 8])
def test_sharded_elements_match_plain_and_sum_to_unsharded(flagship, world):
    """K1, K6 and H1 (9 columns) on each rank's element rows of the
    flagship (``parallel/sharding.shard_object``) against their plain
    versions, twice bit-identical, and their assemblies summed over the
    ranks equal to the unsharded ones within 1e-6 of the largest entry."""
    from fem_tpu_torch.ops import assembly
    from fem_tpu_torch.ops import stiffness_kernels as sk
    from fem_tpu_torch.parallel import sharding
    from fem_tpu_torch.solvers import modal

    obj, state = flagship
    pos = state.pos
    w = torch.randn((obj.particle_cnt, 3, 9), generator=torch.Generator(
        ).manual_seed(9)).cuda()

    def assembled(cols, o):
        return assembly.gather_assemble(assembly.element_contrib_full(cols),
                                        o.plan.idx)

    def chains(o):
        args = (pos, o.element_indices, o.ref_inv, o.volume, obj.mu,
                obj.s_lambda)
        return (element_kernels.hessian_and_force(*args)[1],
                element_kernels.explicit_grad_columns(*args), args)

    h_ref, g_ref, _ = chains(obj)
    sums = [0.0, 0.0, 0.0]
    refs = (assembled(h_ref, obj), assembled(g_ref, obj),
            modal.make_stiffness_hvp(obj, pos)(w))
    for rank in range(world):
        local = sharding.shard_object(obj, rank, world, blocked=False)
        h, g, args = chains(local)
        h2, g2, _ = chains(local)
        _, h_p = element_kernels.hessian_and_force_plain(*args)
        g_p = element_kernels.explicit_grad_columns_plain(*args)
        kv = modal.make_stiffness_hvp(local, pos)
        s, s2 = kv(w), kv(w)
        s_p = sk.stiffness_apply_plain(kv.binding.jac, w,
                                       kv.binding.element_indices,
                                       kv.binding.plan_idx)
        torch.cuda.synchronize()
        for got, ref in ((h, h_p), (g, g_p)):
            scale = (ref.abs().reshape(ref.shape[0], -1).amax(dim=1)
                     .clamp(min=1e-30)[:, None, None])
            assert float(((got - ref).abs() / scale).max()) <= TOL
        assert float((s - s_p).abs().max()) <= 1e-6 * float(s_p.abs().max())
        assert torch.equal(h, h2) and torch.equal(g, g2) and torch.equal(s, s2)
        for i, part in enumerate((assembled(h, local), assembled(g, local),
                                  s)):
            sums[i] = sums[i] + part
    for got, ref in zip(sums, refs):
        assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


def test_sharded_frame_on_one_nccl_rank_matches_single_device(flagship):
    """The flagship's sharded frame on a one-rank NCCL group against the
    single-device op-composed frame on the same blocked operator: positions
    within 1e-5, equal CG iterations, K2 once a substep and K3 3 + 2 an
    iteration."""
    from fem_tpu_torch import entry
    from fem_tpu_torch.parallel import sharding

    cfg, obj, state, obstacles = entry.flagship("cuda")
    state = entry.deformed(state)
    mesh = sharding.make_element_mesh(device="cuda")
    frame = sharding.make_sharded_frame_fn(obj, cfg, mesh)
    blocked_kernels.blocked_prep.launches = 0
    blocked_kernels.blocked_graph_apply.launches = 0
    out, aux = frame(state, obstacles)
    iters = aux.solver_iterations.cpu().tolist()
    assert blocked_kernels.blocked_prep.launches == cfg.sim_count
    assert blocked_kernels.blocked_graph_apply.launches == sum(
        3 + 2 * i for i in iters)
    ref, ref_aux = sim.make_frame_fn(obj, dataclasses.replace(
        cfg, operator_mode="blocked"))(state, obstacles)
    assert iters == ref_aux.solver_iterations.cpu().tolist()
    assert float((out.pos - ref.pos).abs().max()) <= TOL
