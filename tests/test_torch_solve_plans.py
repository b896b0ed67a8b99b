# coding=utf-8
"""The launch plans of K11a (the edge-matrix CG) and K3 (the blocked
operator apply) on the host, and K3's binding.

K11a (``experiments/edge_cg.py``) plans with K11b's planner
(``fused_frame.fused_frame_plan``, four local vectors a cluster CTA) over
the elements and the per-particle plan it recovers from S (``edge_plan``):
the cluster variant of 16 CTAs on the flagship's S and of 1 CTA on
``default.json``'s, the single variant under tighter limits, forced and
refused variants, and the barrier formula ``edge_cg_barriers``.  K3
(``ops/blocked_kernels.py``): ``blocked_plan`` picks the cluster variant of
16 CTAs (two thread groups) on the flagship's 17 blocks, 1 on
``default.json``'s one block and 16 on the 40-subdivision grid's 16, the
two-kernel variant for many blocks or tight limits, forced and refused
variants, ``blocked_barriers``; a numpy emulation of the cluster variant's
two sums — each block slot's rows through the block's local plan, stored
into its particle owner's receive slot (``explicit_assignment``), then
each owner's receive slots in order — equals the plain version's terms
summed in the two-kernel variant's order bit for bit, and
``blocked_graph_apply_plain`` itself bit for bit wherever its torch.sum
adds a particle's slots in order (at most four; to f32 rounding
elsewhere), on the flagship, the 40-subdivision grid and a cube of many
blocks, in both transpose modes; and the binding (``blocked_binding``) is
built once a blocking and again when it is replaced or changed in place.

The JAX package has no counterpart of a plan (its Pallas kernels run on one
core); the plain versions the plans sum as are held to the JAX package by
``tests/test_torch_edge_cg.py`` and ``tests/test_torch_blocked_kernels.py``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from fem_tpu_torch import entry, scene
from fem_tpu_torch.experiments import edge_cg
from fem_tpu_torch.experiments import fused_frame as ff
from fem_tpu_torch.ops import blocked_kernels as bk
from fem_tpu_torch.ops import blocking, cg_kernels
from fem_tpu_torch.ops import frame_kernels as fk
from fem_tpu_torch.ops import smallmat as sm
from fem_tpu_torch.ops.assembly import element_contrib_full
from fem_tpu_torch.solvers.implicit import build_edge_matrix
from fem_tpu_torch.utils.config import read_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = ff.H100_LIMITS


def _default_2d(subdivisions=None):
    cfg = read_config(os.path.join(REPO, "configs", "default.json"))
    if subdivisions is not None:
        ocfg = dataclasses.replace(cfg.objects[0], subdivisions=subdivisions)
        cfg = dataclasses.replace(cfg, objects=(ocfg,))
    (body,), _ = scene.load_scene(cfg, device="cpu")
    return body.obj, body.state


@pytest.fixture(scope="module")
def flagship():
    _, obj, state, _ = entry.flagship("cpu")
    return obj, entry.deformed(state)


@pytest.fixture(scope="module")
def default_2d():
    return _default_2d()


@pytest.fixture(scope="module")
def grid_2d():
    return _default_2d(40)


@pytest.fixture(scope="module")
def cube():
    """A small cube blocked over many small blocks (Eb = Pb = 32)."""
    from tests.test_blocked import _cube_mesh

    nodes, _, tets = _cube_mesh(spacing=0.3)
    rng = np.random.default_rng(0)
    blk = blocking.build_blocking(
        tets, rng.normal(size=(tets.shape[0], 3, 3)).astype(np.float32),
        rng.uniform(0.5, 1.0, tets.shape[0]).astype(np.float32),
        nodes.astype(np.float32), eb=32, pb=32, device="cpu")
    return blk, nodes.shape[0]


# -- K11a -------------------------------------------------------------------


def _edge_host(obj):
    """The host arrays K11a plans from: S's recovered elements and plan."""
    s_mat = torch.as_tensor(build_edge_matrix(
        obj.element_indices.numpy(), obj.particle_cnt))
    ep = edge_cg.edge_plan(s_mat, obj.dim)
    assert torch.equal(ep.element_indices, obj.element_indices)
    return (ep.element_indices.numpy(), ep.plan.ptr.numpy(),
            ep.plan.rows.numpy())


@pytest.fixture(scope="module")
def edge_hosts(flagship, default_2d):
    return {3: (flagship[0], _edge_host(flagship[0])),
            2: (default_2d[0], _edge_host(default_2d[0]))}


@pytest.mark.parametrize("dim,size", [(3, 16), (2, 1)])
def test_edge_cg_plan_picks_the_cluster_variant(edge_hosts, dim, size):
    """K11a's plan on S: the cluster variant of 16 CTAs on the flagship, 1
    on default.json, each CTA four local vectors of d floats (x, r, d, q)
    and 1/m — K4's CTA less its velocities."""
    obj, host = edge_hosts[dim]
    n = obj.particle_cnt
    plan = ff.fused_frame_plan(*host, n, dim, H100,
                               vectors=edge_cg.CLUSTER_VECTORS)
    asg = ff.cluster_assignment(*host, n, size)
    assert plan == ff.FusedPlan("cluster", size, ff.cluster_smem(
        *asg.sizes(), dim, 4))
    k4 = ff.fused_frame_plan(*host, n, dim, H100,
                             vectors=cg_kernels.CLUSTER_VECTORS)
    assert k4.size == size
    assert k4.smem - plan.smem == 4 * dim * asg.sizes()[1]


def test_edge_cg_forced_and_refused_variants(edge_hosts):
    """Forced variants as fused_frame_plan's: single, a cluster of 8 on the
    flagship and of 3 on default.json; a cluster above the device's 16
    CTAs or beyond its shared memory (3 CTAs on the flagship), and cluster
    with single, raise ValueError; under limits too tight for any cluster
    the automatic plan is the single variant."""
    obj, host = edge_hosts[3]
    n = obj.particle_cnt
    kw = dict(vectors=edge_cg.CLUSTER_VECTORS)
    assert ff.fused_frame_plan(*host, n, 3, H100, single=True, **kw) == (
        ff.FusedPlan("single", 1, 0))
    assert ff.fused_frame_plan(*host, n, 3, H100, cluster=8, **kw).size == 8
    obj2, host2 = edge_hosts[2]
    assert ff.fused_frame_plan(*host2, obj2.particle_cnt, 2, H100, cluster=3,
                               **kw).size == 3
    for c in (3, 17):
        with pytest.raises(ValueError, match="does not fit"):
            ff.fused_frame_plan(*host, n, 3, H100, cluster=c, **kw)
    with pytest.raises(ValueError, match="not both"):
        ff.fused_frame_plan(*host, n, 3, H100, cluster=3, single=True, **kw)
    tight = fk.FrameLimits(max_cluster=16, smem_optin=20_000, sms=132)
    assert ff.fused_frame_plan(*host, n, 3, tight, **kw).variant == "single"
    with pytest.raises(ValueError, match="does not fit"):
        ff.fused_frame_plan(*host, n, 3, tight, cluster=16, **kw)


def test_edge_cg_on_the_cpu_ignores_the_launch_options(edge_hosts):
    """On the CPU cg_solve_edge runs the plain version whatever variant is
    asked for, and counts no launch."""
    obj, _ = edge_hosts[2]
    s_mat = torch.as_tensor(build_edge_matrix(
        obj.element_indices.numpy(), obj.particle_cnt))
    rng = np.random.default_rng(5)
    e, n = obj.element_cnt, obj.particle_cnt
    k = torch.as_tensor(rng.normal(size=(e, 2, 2)).astype(np.float32))
    b = torch.as_tensor(rng.normal(size=(n, 2)).astype(np.float32))
    kw = dict(dim=2, dt2=1e-6, preconditioned=True)
    before = edge_cg.cg_solve_edge.launches
    ref = edge_cg.cg_solve_edge_plain(s_mat, k, b, obj.mass, **kw)
    for opts in ({}, dict(cluster=3), dict(single=True)):
        x, it = edge_cg.cg_solve_edge(s_mat, k, b, obj.mass, **kw, **opts)
        assert torch.equal(x, ref[0]) and int(it) == int(ref[1])
    assert edge_cg.cg_solve_edge.launches == before


@pytest.mark.parametrize("variant,normal,per_solve,per_it", [
    ("cluster", True, 5, 5), ("cluster", False, 3, 3),
    ("single", True, 13, 12), ("single", False, 7, 9)])
def test_edge_cg_barrier_formula(variant, normal, per_solve, per_it):
    """K11a meets K4's barriers less K4's element pass: two cluster
    barriers (the force rows and their sums), or one __syncthreads (the
    single variant's rhs assembly has two, K11a's copy-in one).  (The CUDA
    tests and chip_smoke.py hold the count each kernel makes of its own
    barriers to this one.)"""
    for it in (0, 2, 6, 30):
        want = per_solve + per_it * it
        assert edge_cg.edge_cg_barriers(variant, normal, it) == want
        k4 = cg_kernels.fused_cg_barriers(variant, normal, it)
        assert k4 - want == (2 if variant == "cluster" else 1)


# -- K3 ---------------------------------------------------------------------


def _blk_host(blk):
    return (blk.block_particles.numpy(), blk.slot_plan.ptr.numpy(),
            blk.slot_plan.rows.numpy())


@pytest.mark.parametrize("variant,ctas,want", [
    ("cluster", 16, 2), ("cluster", 3, 2), ("cluster", 1, 1),
    ("grid", 17, 0), ("grid", 1, 0)])
def test_matvec_barrier_formula(variant, ctas, want):
    """K3's cluster variant: one cluster barrier before any store into
    another CTA (none in a cluster of one) and one after the slot sums; the
    two-kernel variant none inside a kernel."""
    assert bk.blocked_barriers(variant, ctas) == want
    with pytest.raises(ValueError):
        bk.blocked_barriers("single", ctas)


@pytest.mark.parametrize("scene_name,size,threads", [
    ("flagship", 16, 512), ("default", 1, 256), ("grid", 16, 256)])
def test_matvec_plan_picks_the_cluster_variant(flagship, default_2d, grid_2d,
                                               scene_name, size, threads):
    """The cluster variant, one CTA a block up to 16: the flagship's 17
    blocks on 16 CTAs of two thread groups (rank 0 holds two blocks),
    default.json's one block on one CTA, the 40-subdivision grid's 16 on
    16; each CTA its rank's receive slots and one working set a group."""
    obj = {"flagship": flagship, "default": default_2d,
           "grid": grid_2d}[scene_name][0]
    blk = obj.blocking
    host = _blk_host(blk)
    n, d = obj.particle_cnt, obj.dim
    plan = bk.blocked_plan(*host, n, blk.eb, d, H100)
    asg = fk.explicit_assignment(*host, n, size)
    groups = threads // 256
    assert plan == bk.BlockedPlan("cluster", size, bk.cluster_smem(
        "apply", blk.eb, blk.pb, d, groups, asg.sizes()[1]), threads)
    # A group's share: its block's rows and contribution rows, and the
    # block's plus, minus, local plan rows and offsets and destinations.
    eb, pb = blk.eb, blk.pb
    assert bk.cluster_smem("apply", eb, pb, d, groups, 0) == 4 * groups * (
        d * pb + (d + 1) * d * eb + 2 * d * eb + (d + 1) * eb + pb + 1 + pb)


def test_matvec_forced_and_refused_variants(flagship, cube):
    """grid=True gives the two kernels, cluster=3 three CTAs; a cluster of
    more CTAs than blocks or than the device takes, a CTA beyond the shared
    memory, and grid with cluster raise ValueError; under tight limits, and
    for more blocks than 16 CTAs of two groups take at once, the automatic
    plan is the two-kernel variant."""
    obj = flagship[0]
    blk = obj.blocking
    host = _blk_host(blk)
    n = obj.particle_cnt
    grid = bk.blocked_plan(*host, n, blk.eb, 3, H100, grid=True)
    assert grid == bk.BlockedPlan("grid", 17, 4 * (3 * 128 + 12 * 256))
    assert bk.blocked_plan(*host, n, blk.eb, 3, H100).smem == (
        bk.cluster_smem("apply", blk.eb, blk.pb, 3, 2,
                        fk.explicit_assignment(*host, n, 16).sizes()[1]))
    assert bk.blocked_plan(*host, n, blk.eb, 3, H100, cluster=3).size == 3
    for c in (17, 32):
        with pytest.raises(ValueError):
            bk.blocked_plan(*host, n, blk.eb, 3, H100, cluster=c)
    with pytest.raises(ValueError, match="not both"):
        bk.blocked_plan(*host, n, blk.eb, 3, H100, cluster=3, grid=True)
    tight = fk.FrameLimits(max_cluster=16, smem_optin=20_000, sms=132)
    assert bk.blocked_plan(*host, n, blk.eb, 3, tight) == grid
    with pytest.raises(ValueError, match="does not fit"):
        bk.blocked_plan(*host, n, blk.eb, 3, tight, cluster=16)
    cblk, cn = cube
    chost = _blk_host(cblk)
    assert cblk.num_blocks > 32
    assert bk.blocked_plan(*chost, cn, cblk.eb, 3, H100).variant == "grid"
    forced = bk.blocked_plan(*chost, cn, cblk.eb, 3, H100, cluster=16)
    assert forced.variant == "cluster" and forced.threads == 512
    small = fk.FrameLimits(max_cluster=4, smem_optin=232_304, sms=132)
    assert bk.blocked_plan(*host, n, blk.eb, 3, small) == grid


def _cluster_sums(blk, rows, n, cluster):
    """K3's cluster variant's two sums in numpy float32 (csrc/blocked.cu,
    cluster_slots.cuh): ``rows`` (B·Eb·(d+1), d) the elements' contribution
    rows in block order; each real block slot's sum through its block's
    local plan, in order, into its owner's receive slot; each owned
    particle's receive slots summed in order."""
    host = _blk_host(blk)
    asg = fk.explicit_assignment(*host, n, cluster)
    b_cnt, pb = blk.block_particles.shape
    d = rows.shape[1]
    eb = blk.eb
    lptr = blk.local_ptr.numpy()
    lrows = blk.local_rows.numpy()
    bufs = [np.full((asg.recv_ptr[asg.owned_ptr[r + 1]]
                     - asg.recv_ptr[asg.owned_ptr[r]], d), np.nan,
                    np.float32) for r in range(cluster)]
    for b in range(b_cnt):
        block_rows = rows[b * eb * (d + 1):(b + 1) * eb * (d + 1)]
        for p in range(pb):
            to = int(asg.slot_dest[b * pb + p])
            if to < 0:
                continue
            acc = np.zeros(d, np.float32)
            for q in range(lptr[b, p], lptr[b, p + 1]):
                acc = acc + block_rows[lrows[b, q]]
            bufs[to >> 16][to & 0xFFFF] = acc
    y = np.full((n, d), np.nan, np.float32)
    for r in range(cluster):
        first = asg.owned_ptr[r]
        base = asg.recv_ptr[first]
        owned = asg.local_ids[asg.local_ptr[r]:asg.local_ptr[r]
                              + asg.owned_ptr[r + 1] - first]
        for k, g in enumerate(owned):
            acc = np.zeros(d, np.float32)
            for s in range(asg.recv_ptr[first + k] - base,
                           asg.recv_ptr[first + k + 1] - base):
                acc = acc + bufs[r][s]
            y[g] = acc
    return y


def _plain_terms(blk, K, x, transpose_k):
    """The plain version's terms of G(K)·x: the elements' contribution rows
    in block order (zero on padded slots) and its per-slot partials
    (B·Pb, d), as blocked_graph_apply_plain computes them."""
    s = bk.block_edge_matrices(blk, blocking.blocked_gather(x, blk))
    t = sm.matmul(sm.mT(K) if transpose_k else K, s)
    t = torch.where(bk._real_slots(blk), t, 0.0)
    rows = element_contrib_full(t).reshape(-1, x.shape[1]).numpy()
    part = bk._slot_partials(blk, t).reshape(-1, x.shape[1]).numpy()
    return rows, part


def _slot_plan_sums(blk, part, n):
    """The two-kernel variant's second sum (blocked_common.cuh:
    particle_slot_sum) in numpy float32: each particle's block slots'
    partials, in the slot plan's order."""
    ptr = blk.slot_plan.ptr.numpy()
    rows = blk.slot_plan.rows.numpy()
    y = np.zeros((n, part.shape[1]), np.float32)
    for g in range(n):
        for q in range(ptr[g], ptr[g + 1]):
            y[g] = y[g] + part[rows[q]]
    return y


@pytest.mark.parametrize("transpose_k", [False, True])
@pytest.mark.parametrize("case", ["flagship", "grid", "cube"])
def test_cluster_sums_equal_the_plain_apply(flagship, grid_2d, cube, case,
                                            transpose_k):
    """The cluster variant's sums (16 CTAs on the flagship and the grid, 5
    on the cube, some ranks with several blocks) give G(K)·x bit for bit as
    the plain version's terms summed in the two-kernel variant's order: its
    per-slot partials (index_add_ in row order, the local plan's order)
    and then each particle's partials in the slot plan's order.  Against
    blocked_graph_apply_plain itself they are bit-equal wherever a particle
    has at most four block slots; its torch.sum over a particle's gathered
    slots reduces five or more in an order of its own (16 of the
    flagship's 1,007 particles), so there they agree to f32 rounding."""
    rng = np.random.default_rng(11)
    if case == "cube":
        blk, n = cube
        d, cluster = 3, 5
    else:
        obj = (flagship if case == "flagship" else grid_2d)[0]
        blk, n, d, cluster = obj.blocking, obj.particle_cnt, obj.dim, 16
    K = torch.as_tensor(rng.normal(
        size=(blk.num_blocks * blk.eb, d, d)).astype(np.float32))
    x = torch.as_tensor(rng.uniform(-1, 1, (n, d)).astype(np.float32))
    rows, part = _plain_terms(blk, K, x, transpose_k)
    got = _cluster_sums(blk, rows, n, cluster)
    assert np.array_equal(got, _slot_plan_sums(blk, part, n))
    want = bk.blocked_graph_apply_plain(blk, K, x, transpose_k).numpy()
    top = float(np.abs(want).max())
    assert top > 0
    few = np.diff(blk.slot_plan.ptr.numpy()) <= 4
    assert np.array_equal(got[few], want[few])
    assert float(np.abs(got - want).max()) <= 1e-6 * top


def test_matvec_binding_is_built_once_and_again_when_changed(default_2d):
    """The binding of a blocking is found again while it is unchanged, and
    built again when the blocking is replaced or one of its tables is
    changed in place, or another variant is forced; on the CPU it runs the
    plain apply."""
    obj, state = default_2d
    blk = dataclasses.replace(obj.blocking,
                              local_rows=obj.blocking.local_rows.clone())
    builds = bk.BlockedBinding.builds
    first = bk.blocked_binding(blk)
    assert bk.blocked_binding(blk) is first
    assert bk.BlockedBinding.builds == builds + 1
    blk.local_rows.add_(0)  # in place: a new version, the same values
    second = bk.blocked_binding(blk)
    assert second is not first and not first.matches(blk)
    blk2 = dataclasses.replace(blk)
    assert bk.blocked_binding(blk2) is not second
    assert bk.blocked_binding(blk, cluster=1) is not second
    assert bk.BlockedBinding.builds == builds + 4
    K, _ = bk.blocked_prep_plain(blk, state.pos, obj.mu, obj.s_lambda)
    before = bk.blocked_graph_apply.launches
    for tr in (False, True):
        ref = bk.blocked_graph_apply_plain(blk, K, state.vel, tr)
        assert torch.equal(second(K, state.vel, tr), ref)
        assert torch.equal(bk.blocked_graph_apply(
            blk, K, state.vel, tr, cluster=3), ref)
    assert bk.blocked_graph_apply.launches == before
