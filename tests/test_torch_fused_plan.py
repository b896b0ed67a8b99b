# coding=utf-8
"""K11b's launch plan on the host: the choice between the cluster and the
single variant (``fused_frame.fused_frame_plan``, a function of the mesh
and the device's limits, here the H100's), forced variants and the refusal
of a cluster that does not fit, the cluster assignment of elements and
particles to ranks (``fused_frame.cluster_assignment``), its shared-memory
size and the barrier formula, on the flagship (1,007 particles, 4,068
tets), ``default.json`` (121 particles, 200 triangles) and path L's
40-subdivision grid (1,681 particles, 3,200 triangles).

The JAX package has no counterpart (its Pallas kernel runs on one core), so
the assignment is held to the CSR plan it is built from: every owned
particle's sum through its rank's receive slots equals the sum through the
plan, exactly (the same terms in the same order, in float64), and every
rank that holds a particle but does not own it receives the owner's sum."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from fem_tpu_torch import entry, scene
from fem_tpu_torch.experiments import fused_frame as ff
from fem_tpu_torch.ops import frame_kernels as fk
from fem_tpu_torch.utils.config import read_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = ff.H100_LIMITS


def _host(obj):
    return (obj.element_indices.numpy(), obj.plan.ptr.numpy(),
            obj.plan.rows.numpy())


@pytest.fixture(scope="module")
def flagship():
    _, obj, _, _ = entry.flagship("cpu")
    return obj


def _default_2d(subdivisions=None):
    cfg = read_config(os.path.join(REPO, "configs", "default.json"))
    if subdivisions is not None:
        ocfg = dataclasses.replace(cfg.objects[0], subdivisions=subdivisions)
        cfg = dataclasses.replace(cfg, objects=(ocfg,))
    (body,), _ = scene.load_scene(cfg, device="cpu")
    return body.obj


@pytest.fixture(scope="module")
def default_2d():
    return _default_2d()


@pytest.fixture(scope="module")
def grid_2d():
    return _default_2d(40)


def test_shipped_meshes_pick_the_cluster_variant(flagship, default_2d,
                                                 grid_2d):
    """Under the H100's limits: one CTA per 256 elements, at most 16 — the
    flagship 16, default.json 1, the 40-subdivision grid 13 — each CTA's
    state within its shared memory."""
    for obj, cnt, size in ((flagship, (1007, 4068), 16),
                           (default_2d, (121, 200), 1),
                           (grid_2d, (1681, 3200), 13)):
        assert (obj.particle_cnt, obj.element_cnt) == cnt
        plan = ff.fused_frame_plan(*_host(obj), obj.particle_cnt, obj.dim,
                                   H100)
        sizes = ff.cluster_assignment(*_host(obj), obj.particle_cnt,
                                      size).sizes()
        assert plan == ff.FusedPlan("cluster", size,
                                    ff.cluster_smem(*sizes, obj.dim))
        assert plan.smem <= H100.smem_optin


@pytest.mark.parametrize("limits,expect", [
    (fk.FrameLimits(max_cluster=8, smem_optin=232304, sms=132),
     ("cluster", 8)),
    (fk.FrameLimits(max_cluster=16, smem_optin=80_000, sms=132),
     ("single", 1)),
    (fk.FrameLimits(max_cluster=4, smem_optin=232304, sms=132),
     ("single", 1)),
])
def test_plan_follows_the_device_limits(flagship, limits, expect):
    """Fewer CTAs a cluster, or less shared memory a CTA, than the
    flagship's state needs: more CTAs where the limits allow, else the
    single variant (one CTA, the state in device memory)."""
    plan = ff.fused_frame_plan(*_host(flagship), flagship.particle_cnt, 3,
                               limits)
    assert (plan.variant, plan.size) == expect
    if plan.variant == "single":
        assert plan == ff.FusedPlan("single", 1, 0)


def test_plan_takes_more_ctas_until_a_cta_fits(grid_2d):
    """The grid's 13 CTAs need ~56 KB each; under a 50 KB limit the plan
    adds CTAs until one fits."""
    host = _host(grid_2d)
    at13 = ff.fused_frame_plan(*host, grid_2d.particle_cnt, 2, H100,
                               cluster=13)
    limits = fk.FrameLimits(16, at13.smem - 1, 132)
    plan = ff.fused_frame_plan(*host, grid_2d.particle_cnt, 2, limits)
    assert plan.variant == "cluster" and 13 < plan.size <= 16
    assert plan.smem <= limits.smem_optin


def test_forced_variants_and_refusals(flagship, default_2d):
    host, n = _host(flagship), flagship.particle_cnt
    assert ff.fused_frame_plan(*host, n, 3, H100, single=True) == \
        ff.FusedPlan("single", 1, 0)
    assert ff.fused_frame_plan(*host, n, 3, H100, cluster=16).size == 16
    # One CTA (959 KB of state) or three (382 KB) do not fit the H100's
    # 227 KB, nor does a cluster of 17: refused before any launch.
    for cluster in (1, 3, 17):
        with pytest.raises(ValueError, match="does not fit"):
            ff.fused_frame_plan(*host, n, 3, H100, cluster=cluster)
    for cluster in (1, 3, 16):
        plan = ff.fused_frame_plan(*_host(default_2d), 121, 2, H100,
                                   cluster=cluster)
        assert (plan.variant, plan.size) == ("cluster", cluster)
    for kw in (dict(cluster=2, single=True), dict(cluster=-1)):
        with pytest.raises(ValueError):
            ff.fused_frame_plan(*host, n, 3, H100, **kw)
    with pytest.raises(ValueError):
        ff.fused_frame_plan(*host, n, 4, H100)
    with pytest.raises(ValueError):
        ff.cluster_assignment(*_host(default_2d), 121, 201)


def _check_assignment(obj, cluster):
    host = _host(obj)
    elem, ptr, rows = host
    n, d1 = obj.particle_cnt, elem.shape[1]
    asg = ff.cluster_assignment(*host, n, cluster)
    # Elements: contiguous ranges covering [0, E) once, in the mesh order.
    assert asg.elem_ptr[0] == 0 and asg.elem_ptr[-1] == len(elem)
    assert np.all(np.diff(asg.elem_ptr) > 0)
    owned_all, holders = [], {}
    for r in range(cluster):
        lo, hi = asg.elem_ptr[r], asg.elem_ptr[r + 1]
        local = asg.local_ids[asg.local_ptr[r]:asg.local_ptr[r + 1]]
        no = asg.owned_ptr[r + 1] - asg.owned_ptr[r]
        owned_all.extend(local[:no].tolist())
        # Local = owned (ascending) then the others the elements touch.
        assert np.all(np.diff(local[:no]) > 0)
        assert set(local.tolist()) == set(local[:no].tolist()) | set(
            np.unique(elem[lo:hi]).tolist())
        assert np.array_equal(
            local[asg.elem_local[d1 * lo:d1 * hi]].reshape(-1, d1),
            elem[lo:hi])
        for li, g in enumerate(local.tolist()):
            holders.setdefault(g, set()).add((r, li))
    # Particles: each owned exactly once.
    assert sorted(owned_all) == list(range(n))
    # Every plan row has one receive slot; each owner's slots, summed in
    # order, give the plan's sum exactly.
    t = np.random.default_rng(cluster).standard_normal((d1 * len(elem), 3))
    recv = {r: {} for r in range(cluster)}
    for row in range(d1 * len(elem)):
        dest = int(asg.row_dest[row])
        assert (dest & 0xffff) not in recv[dest >> 16]
        recv[dest >> 16][dest & 0xffff] = t[row]
    assert sum(len(v) for v in recv.values()) == d1 * len(elem)
    for r in range(cluster):
        base = asg.recv_ptr[asg.owned_ptr[r]]
        local = asg.local_ids[asg.local_ptr[r]:asg.local_ptr[r + 1]]
        for li in range(asg.owned_ptr[r + 1] - asg.owned_ptr[r]):
            i = asg.owned_ptr[r] + li
            g = int(local[li])
            got = np.zeros(3)
            for k in range(asg.recv_ptr[i] - base, asg.recv_ptr[i + 1] - base):
                got = got + recv[r][k]
            want = np.zeros(3)
            for q in range(ptr[g], ptr[g + 1]):
                want = want + t[rows[q]]
            assert np.array_equal(got, want)
            pushed = {(int(c) >> 16, int(c) & 0xffff) for c in
                      asg.push_codes[asg.push_ptr[i]:asg.push_ptr[i + 1]]}
            assert pushed == holders[g] - {(r, li)}
    return asg


@pytest.mark.parametrize("cluster", [1, 3, 16])
def test_flagship_assignment(flagship, cluster):
    asg = _check_assignment(flagship, cluster)
    if cluster == 16:
        # Ownership by the middle plan row spreads the sums over the ranks.
        assert asg.sizes() == (255, 252, 1360, 236)


@pytest.mark.parametrize("cluster", [1, 3, 16])
def test_2d_assignments(default_2d, grid_2d, cluster):
    _check_assignment(default_2d, cluster)
    _check_assignment(grid_2d, cluster)


def test_assignment_with_particles_in_no_element():
    """Particles no element touches (no plan rows) are owned round-robin,
    local only to their owner, and receive nothing."""
    elem = np.array([[0, 1, 2], [1, 2, 3], [2, 3, 4]])
    n = 7
    rows_of = [[] for _ in range(n)]
    for e, tri in enumerate(elem):
        for j, p in enumerate(tri):
            rows_of[p].append(3 * e + j)
    ptr = np.concatenate([[0], np.cumsum([len(r) for r in rows_of])])
    rows = np.concatenate([np.array(r, np.int64) for r in rows_of])
    asg = ff.cluster_assignment(elem, ptr, rows, n, 2)
    owned = [asg.local_ids[asg.local_ptr[r]:asg.local_ptr[r]
                           + asg.owned_ptr[r + 1] - asg.owned_ptr[r]]
             for r in range(2)]
    assert sorted(np.concatenate(owned).tolist()) == list(range(n))
    assert 5 in owned[0] and 6 in owned[1]
    i5 = asg.owned_ptr[0] + owned[0].tolist().index(5)
    assert asg.recv_ptr[i5 + 1] == asg.recv_ptr[i5]


def test_shared_memory_sizes():
    """A 3D CTA of 255 elements and 252 local particles whose owned ones
    take 1,360 receive slots and push to 236 holders: two copies of the
    slots and two receive buffers (rows of 4 floats), K, 7 vectors of 3 and
    1/m, 32 dot partials, local vertex ids and row destinations, ids, two
    spans of 253 and the push codes."""
    words = (2 * 4 * 1360 + 2 * 4 * 252 + 9 * 255 + 22 * 252 + 32
             + 2 * 4 * 255 + 252 + 2 * 253 + 236)
    assert ff.cluster_smem(255, 252, 1360, 236, 3) == 4 * words
    words_2d = (2 * 2 * 600 + 2 * 2 * 121 + 4 * 200 + 15 * 121 + 32
                + 2 * 3 * 200 + 121 + 2 * 122)
    assert ff.cluster_smem(200, 121, 600, 0, 2) == 4 * words_2d


@pytest.mark.parametrize("normal", [True, False])
def test_barrier_counts(normal):
    """A frame of substeps with 2, 3 and 0 iterations: the cluster variant's
    6 + 5·it (4 + 3·it plain) a substep and two a frame, the single
    variant's 16 + 12·it (10 + 9·it) and one.  (The CUDA tests hold the
    count each kernel makes of its own barriers to this one.)"""
    its = [2, 3, 0]
    step, per_it = (6, 5) if normal else (4, 3)
    single_step, single_it = (16, 12) if normal else (10, 9)
    assert ff.frame_barriers("cluster", normal, its) == (
        3 * step + 5 * per_it + 2)
    assert ff.frame_barriers("single", normal, its) == (
        3 * single_step + 5 * single_it + 1)
    # The flagship's frame at 29 iterations (10 substeps).
    assert ff.frame_barriers("cluster", True, [2] + [3] * 9) == 207
    assert ff.frame_barriers("single", True, [2] + [3] * 9) == 509


def test_cpu_frame_ignores_the_launch_options(default_2d):
    """On the CPU the wrapper runs the plain frame whatever the options."""
    obj = default_2d
    rng = np.random.default_rng(0)
    n, d = obj.particle_cnt, obj.dim
    pos = torch.as_tensor(rng.uniform(0.3, 0.7, (n, d)).astype(np.float32))
    vel = torch.as_tensor(rng.normal(0, 0.1, (n, d)).astype(np.float32))
    args = (pos, vel, torch.zeros_like(vel), obj.ref_inv, obj.volume,
            obj.element_indices, obj.plan, obj.mass,
            torch.zeros((0, d)), torch.zeros((0,)))
    kw = dict(dt=1e-3, damping=1.0, g_dir=(0.0, -1.0), mu=obj.mu,
              s_lambda=obj.s_lambda, preconditioned=True, sim_count=2)
    plain = ff.fused_frame_plain(*args, **kw)
    for opts in (dict(cluster=16), dict(single=True)):
        out = ff.fused_frame(*args, **kw, **opts)
        assert all(torch.equal(a, b) for a, b in zip(out, plain))
