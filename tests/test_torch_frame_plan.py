# coding=utf-8
"""K5's launch plan on the host: the choice between the cluster and the
grid variant (``frame_kernels.frame_plan``, a pure function of the sizes and
the device's limits, here the H100's) and the cluster assignment of blocks
and particles to ranks (``frame_kernels.cluster_assignment``), on the
flagship's blocking (17 blocks), ``default.json``'s (1 block), path L's
40-subdivision grid (16 blocks), small Delaunay cubes and hand-made plans.

The JAX package has no counterpart (its Pallas kernel runs on one core), so
the blockings are held to ``fem_tpu.ops.blocking.build_blocking``'s block
counts and the assignment to the slot plan it is built from: every slot sum
through a rank's slot lists equals the sum through the slot plan, exactly
(the same terms in the same order, in float64)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from fem_tpu.ops import blocking as jblocking
from fem_tpu_torch import entry, scene
from fem_tpu_torch.ops import blocking, frame_kernels as fk
from fem_tpu_torch.utils.config import read_config
from tests.test_blocked import _cube_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = fk.H100_LIMITS


def _host(blk):
    return (blk.block_particles.numpy(), blk.slot_plan.ptr.numpy(),
            blk.slot_plan.rows.numpy())


@pytest.fixture(scope="module")
def flagship():
    _, obj, _, _ = entry.flagship("cpu")
    return obj


@pytest.fixture(scope="module")
def default_2d():
    cfg = read_config(os.path.join(REPO, "configs", "default.json"))
    (body,), _ = scene.load_scene(cfg, device="cpu")
    return body.obj


@pytest.fixture(scope="module")
def grid_2d():
    cfg = read_config(os.path.join(REPO, "configs", "default.json"))
    ocfg = dataclasses.replace(cfg.objects[0], subdivisions=40)
    (body,), _ = scene.load_scene(
        dataclasses.replace(cfg, objects=(ocfg,)), device="cpu")
    return body.obj


def _cube(eb, pb, seed=0):
    """A Delaunay cube blocked small, so that it spans many blocks, as
    tensors of the port and of the JAX package's partition."""
    nodes, _, tets = _cube_mesh(spacing=0.3)
    rng = np.random.default_rng(seed)
    ref_inv = rng.normal(size=(tets.shape[0], 3, 3)).astype(np.float32)
    volume = rng.uniform(0.5, 1.0, tets.shape[0]).astype(np.float32)
    args = (tets, ref_inv, volume, nodes.astype(np.float32))
    return (blocking.build_blocking(*args, eb=eb, pb=pb, device="cpu"),
            jblocking.build_blocking(*args, eb=eb, pb=pb), nodes.shape[0])


def test_shipped_blockings_pick_the_cluster_variant(flagship, default_2d,
                                                    grid_2d):
    """Under the H100's limits the flagship (17 blocks), default.json (1
    block) and path L's grid (16 blocks) each fit one cluster of one CTA a
    block, at most 16; the flagship's 17th block goes to rank 0 with a
    second thread group."""
    cases = ((flagship, 17, 16, 512), (default_2d, 1, 1, 256),
             (grid_2d, 16, 16, 256))
    for obj, blocks, size, threads in cases:
        blk = obj.blocking
        assert blk.num_blocks == blocks
        plan = fk.frame_plan(blk.num_blocks, blk.eb, blk.pb, obj.particle_cnt,
                             obj.dim, H100)
        assert plan == fk.FramePlan(
            "cluster", size, fk.cluster_smem(blk.num_blocks, blk.eb, blk.pb,
                                             obj.particle_cnt, obj.dim, size),
            threads)
        assert plan.smem <= H100.smem_optin


def test_large_blocking_picks_the_grid_variant():
    """270 blocks (P1's probe mesh, 68,508 tets): 17 blocks a CTA even at 16
    CTAs, whose K and vectors exceed a CTA's shared memory; the grid
    variant, one CTA per SM."""
    for n in (13_000, 2_176):
        plan = fk.frame_plan(270, 256, 128, n, 3, H100)
        assert plan == fk.FramePlan("grid", 132, fk.grid_smem(270, 256, 128,
                                                              3, 132))
        assert fk.cluster_smem(270, 256, 128, n, 3, 16) > H100.smem_optin


@pytest.mark.parametrize("limits,expect", [
    (fk.FrameLimits(max_cluster=8, smem_optin=232304, sms=132),
     ("cluster", 8, 512)),
    (fk.FrameLimits(max_cluster=16, smem_optin=100_000, sms=132),
     ("grid", 17, 256)),
    (fk.FrameLimits(max_cluster=16, smem_optin=232304, sms=10),
     ("cluster", 16, 512)),
])
def test_plan_follows_the_device_limits(limits, expect):
    plan = fk.frame_plan(17, 256, 128, 1007, 3, limits)
    assert (plan.variant, plan.size, plan.threads) == expect


def test_forced_variants_and_bad_requests():
    assert fk.frame_plan(17, 256, 128, 1007, 3, H100, grid=3) == fk.FramePlan(
        "grid", 3, fk.grid_smem(17, 256, 128, 3, 3))
    # Forced sizes are not checked here: the device refuses them at launch.
    plan = fk.frame_plan(17, 256, 128, 1007, 3, H100, cluster=32)
    assert (plan.variant, plan.size, plan.threads) == ("cluster", 32, 256)
    plan = fk.frame_plan(17, 256, 128, 1007, 3, H100, cluster=3)
    assert (plan.size, plan.threads) == (3, 512)
    for kw in (dict(grid=2, cluster=2), dict(grid=-1), dict(cluster=-1)):
        with pytest.raises(ValueError):
            fk.frame_plan(17, 256, 128, 1007, 3, H100, **kw)
    with pytest.raises(ValueError):
        fk.frame_plan(0, 256, 128, 10, 3, H100)


def test_shared_memory_sizes():
    """The flagship at 16 CTAs: K of 2 blocks, 2 working sets, 3 copies of
    2 blocks' slot partials, 7 vectors of 3 and 1/m over 256 rows, the tables of 2
    blocks, ids and slot offsets (257) and the slot lists (17 · 128)."""
    words = (9 * 2 * 256 + 2 * (3 * 128 + 12 * 256) + 3 * 2 * 128 * 3
             + 256 * 22 + 2 * (10 * 256 + 2 * 128 + 1) + 2 * 256 + 1
             + 17 * 128)
    assert fk.cluster_smem(17, 256, 128, 1007, 3, 16) == 4 * words
    assert fk.cluster_capacity(17, 128, 1007, 16) == 256
    assert fk.cluster_capacity(1, 128, 121, 1) == 121
    assert fk.cluster_capacity(1, 128, 121, 1, n_free=3) == 121
    assert fk.cluster_capacity(4, 32, 500, 2, n_free=5) == 69
    assert fk.grid_smem(17, 256, 128, 3, 17) == 4 * (9 * 256 + 3 * 128
                                                     + 12 * 256)


@pytest.mark.parametrize("normal,per_step,per_it", [(True, 4, 4),
                                                    (False, 3, 3)])
def test_barrier_counts(normal, per_step, per_it):
    """A frame of substeps with 2, 3 and 0 iterations: the cluster variant's
    count against the grid variant's 8 + 6·it (5 + 4·it plain), each with
    one barrier a frame more.  (The CUDA tests hold the count each kernel
    makes of its own barriers to this one.)"""
    its = [2, 3, 0]
    grid_step, grid_it = (8, 6) if normal else (5, 4)
    assert fk.frame_barriers("cluster", normal, its) == (
        3 * per_step + 5 * per_it + 1)
    assert fk.frame_barriers("grid", normal, its) == 3 * grid_step + \
        5 * grid_it + 1
    # The flagship's frame at 29 iterations: 255 grid barriers, 157 cluster.
    assert fk.frame_barriers("grid", True, [2] + [3] * 9) == 255
    assert fk.frame_barriers("cluster", True, [2] + [3] * 9) == 157


def _check_assignment(bp, ptr, rows, n, cluster):
    """The assignment's invariants, and its slot lists against the slot
    plan (random partials, float64 sums in slot order)."""
    asg = fk.cluster_assignment(bp, ptr, rows, n, cluster)
    b_cnt, pb = bp.shape
    real = np.zeros(b_cnt * pb, bool)
    real[rows] = True
    # Every block is owned exactly once: block b by rank b mod C, the
    # (b // C)-th of its blocks.
    owners = [[b for b in range(b_cnt) if b % cluster == r]
              for r in range(cluster)]
    assert sorted(sum(owners, [])) == list(range(b_cnt))
    # Every particle's vector rows are owned exactly once.
    owned = np.concatenate([
        asg.local_ids[asg.local_ptr[r]:asg.local_ptr[r] + asg.owned[r]]
        for r in range(cluster)])
    assert np.array_equal(np.sort(owned), np.arange(n))
    rng = np.random.default_rng(cluster)
    partials = rng.normal(size=(b_cnt * pb, 3))
    # Rank r's copy of its blocks' partials, slot (b // C)·Pb + p.
    bufs = [np.zeros((len(owners[r]) * pb, 3)) for r in range(cluster)]
    for b in range(b_cnt):
        bufs[b % cluster][(b // cluster) * pb:(b // cluster + 1) * pb] = \
            partials[b * pb:(b + 1) * pb]
    for r in range(cluster):
        lo, hi = asg.local_ptr[r], asg.local_ptr[r + 1]
        ids = asg.local_ids[lo:hi]
        assert len(set(ids.tolist())) == ids.size
        owned_r = ids[:asg.owned[r]]
        assert np.array_equal(owned_r, np.sort(owned_r))
        assert np.array_equal(ids[asg.owned[r]:], np.sort(ids[asg.owned[r]:]))
        # Every particle the rank's blocks touch is one of its local
        # particles, reached through block_local.
        for b in owners[r]:
            for p in range(pb):
                if real[b * pb + p]:
                    loc = asg.block_local[b * pb + p]
                    assert 0 <= loc < ids.size
                    assert ids[loc] == bp[b, p]
                else:
                    assert asg.block_local[b * pb + p] == 0
        # Each local particle's slot list is its slot plan row, encoded.
        for i, g in enumerate(ids):
            codes = asg.slot_code[asg.slot_ptr[lo + i]:asg.slot_ptr[lo + i + 1]]
            slots = rows[ptr[g]:ptr[g + 1]]
            assert codes.size == slots.size
            got = np.zeros(3)
            want = np.zeros(3)
            for code, slot in zip(codes, slots):
                got = got + bufs[code >> 16][code & 0xFFFF]
                want = want + partials[slot]
            assert np.array_equal(got, want)
    assert asg.slot_ptr.size == asg.local_ptr[-1] + 1
    for a in asg:
        assert a.dtype == np.int32
    return asg


@pytest.mark.parametrize("cluster", [1, 3, 16])
def test_flagship_assignment(flagship, cluster):
    asg = _check_assignment(*_host(flagship.blocking), flagship.particle_cnt,
                            cluster)
    counts = np.diff(asg.local_ptr)
    assert counts.max() <= fk.cluster_capacity(17, 128, 1007, cluster)


@pytest.mark.parametrize("cluster", [1, 3, 16])
def test_2d_assignments(default_2d, grid_2d, cluster):
    for obj in (default_2d, grid_2d):
        _check_assignment(*_host(obj.blocking), obj.particle_cnt, cluster)


@pytest.mark.parametrize("eb,pb", [(32, 24), (16, 12)])
def test_cube_assignment_matches_the_jax_partition(eb, pb):
    """Small blocks (many, some padded): the port's blocking has the JAX
    package's block count, and the assignment holds for 1, 5 and 16 ranks
    (16 > blocks per rank owning several, or none)."""
    blk, jblk, n = _cube(eb, pb)
    assert blk.num_blocks == jblk.num_blocks > 4
    assert np.array_equal(blk.block_particles.numpy(),
                          np.asarray(jblk.block_particles))
    for cluster in (1, 5, 16):
        _check_assignment(*_host(blk), n, cluster)


def test_assignment_with_particles_in_no_block():
    """Particles 5 and 6 are in no block: each is owned by a rank (round
    robin over such particles) and is its local particle, with no slots;
    a padded slot (id 0) maps to local index 0."""
    bp = np.array([[0, 1, 2, 0], [2, 3, 4, 0]], np.int32)
    # Slots 0-2 and 4-6 are real (3 and 7 padded), by particle.
    ptr = np.array([0, 1, 2, 4, 5, 6, 6, 6], np.int32)
    rows = np.array([0, 1, 2, 4, 5, 6], np.int32)
    asg = _check_assignment(bp, ptr, rows, 7, 2)
    assert asg.owned.tolist() == [4, 3]
    assert asg.local_ids.tolist() == [0, 1, 2, 5, 3, 4, 6, 2]
    assert fk.cluster_capacity(2, 4, 7, 2, n_free=2) == 6


def test_cluster_tables_are_cached_per_blocking(flagship):
    blk = flagship.blocking
    a = fk.cluster_tables(blk, flagship.particle_cnt, 16)
    b = fk.cluster_tables(blk, flagship.particle_cnt, 16)
    assert all(x is y for x, y in zip(a, b))
    ref = fk.cluster_assignment(*_host(blk), flagship.particle_cnt, 16)
    for t, want in zip(a, ref):
        assert t.dtype == torch.int32 and t.device.type == "cpu"
        assert np.array_equal(t.numpy(), want)


def test_cpu_frame_ignores_the_launch_options(flagship):
    """On CPU tensors the frame is the plain version whatever variant is
    asked for."""
    _, obj, state, obs = entry.flagship("cpu")
    state = entry.deformed(state)
    args = (obj.blocking, state.pos, state.vel, state.vel_g, obj.mass,
            obs.centers, obs.radii)
    kw = dict(dt=5e-4, damping=obj.damping, g_dir=(0.0, -1.0, 0.0),
              mu=obj.mu, s_lambda=obj.s_lambda, preconditioned=True,
              sim_count=1)
    ref = fk.fused_blocked_frame_plain(*args, **kw)
    for extra in (dict(cluster=16), dict(grid=3), {}):
        out = fk.fused_blocked_frame(*args, **kw, **extra)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
