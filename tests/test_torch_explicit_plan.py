# coding=utf-8
"""K8's and K4's launch plans on the host, and K8's host wrapper.

K8 (``frame_kernels.explicit_frame_plan``, a function of the blocking's
host arrays and the device's limits, here the H100's): the cluster variant
on the flagship (17 blocks), ``default.json`` and each body of
``demo_plastic.json`` (1 block each) and path L's 40-subdivision grid (16
blocks), the grid variant under tighter limits, forced and refused
variants, the shared memory, the barrier formula, and the assignment of
block slots to their particles' owners (``explicit_assignment``): every
owned particle's sum through its receive slots equals the sum through the
slot plan, exactly (the same terms in the same order, in float64), and
every other holder of a particle is named once with its local index.  K4
(``fused_frame.fused_frame_plan`` with K4's five local vectors): the
cluster variant on the flagship and ``default.json``.  K8's wrapper
(``explicit_frame_binding``): built once for a blocking, a mass and the
frame's constants, and built again when the mass or the blocking is
replaced or changed in place; every frame's outputs are fresh tensors.

The JAX package has no counterpart (its Pallas kernels run on one core), so
the plans are held to the slot plan and the blockings they are built from;
the frames the bindings run are the plain frames that
``tests/test_torch_explicit_frame.py`` holds to the JAX package."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from fem_tpu_torch import entry, scene, sim
from fem_tpu_torch.experiments import fused_frame as ff
from fem_tpu_torch.ops import blocking, cg_kernels, frame_kernels as fk
from fem_tpu_torch.utils.config import read_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = fk.H100_LIMITS


def _host(blk):
    return (blk.block_particles.numpy(), blk.slot_plan.ptr.numpy(),
            blk.slot_plan.rows.numpy())


def _states(obj):
    return int(obj.plastic_yield > 0.0) + int(obj.viscous_mu > 0.0)


def _load(name, subdivisions=None):
    cfg = read_config(os.path.join(REPO, "configs", name))
    if subdivisions is not None:
        ocfg = dataclasses.replace(cfg.objects[0], subdivisions=subdivisions)
        cfg = dataclasses.replace(cfg, objects=(ocfg,))
    bodies, obstacles = scene.load_scene(cfg, device="cpu")
    return cfg, bodies, obstacles


@pytest.fixture(scope="module")
def flagship():
    return entry.flagship("cpu")


@pytest.fixture(scope="module")
def default_2d():
    return _load("default.json")


@pytest.fixture(scope="module")
def grid_2d():
    return _load("default.json", subdivisions=40)


@pytest.fixture(scope="module")
def plastic():
    return _load("demo_plastic.json")


def _plan(obj, limits=H100, **kw):
    blk = obj.blocking
    return fk.explicit_frame_plan(*_host(blk), obj.particle_cnt, blk.eb,
                                  obj.dim, limits, _states(obj), **kw)


def _smem(obj, cluster, limits=H100):
    blk = obj.blocking
    asg = fk.explicit_assignment(*_host(blk), obj.particle_cnt, cluster)
    return fk.explicit_cluster_smem(blk.num_blocks, blk.eb, blk.pb, obj.dim,
                                    cluster, *asg.sizes(), _states(obj))


def test_shipped_blockings_pick_the_cluster_variant(flagship, default_2d,
                                                    grid_2d, plastic):
    """Under the H100's limits every shipped explicit scene fits one
    cluster of one CTA a block, at most 16: the flagship's 17th block goes
    to rank 0 with a second thread group (512 threads a CTA); default.json,
    both demo_plastic.json bodies (plastic, viscous: one internal state
    each) and path L's grid take 256 threads."""
    cases = [(flagship[1], 17, 16, 512, 0),
             (default_2d[1][0].obj, 1, 1, 256, 0),
             (grid_2d[1][0].obj, 16, 16, 256, 0)]
    cases += [(body.obj, 1, 1, 256, 1) for body in plastic[1]]
    assert len(cases) == 5
    for obj, blocks, size, threads, states in cases:
        assert obj.blocking.num_blocks == blocks
        assert _states(obj) == states
        plan = _plan(obj)
        assert plan == fk.FramePlan("cluster", size, _smem(obj, size),
                                    threads)
        assert plan.smem <= H100.smem_optin
    # The flagship's state at its sizes: 163 local particles, 276 receive
    # slots and 144 push codes at most a rank, 83,860 B a CTA elastic and
    # 120,724 B with both internal states.
    blk = flagship[1].blocking
    asg = fk.explicit_assignment(*_host(blk), 1007, 16)
    assert asg.sizes() == (163, 276, 144)
    assert _plan(flagship[1]).smem == 83_860
    assert fk.explicit_cluster_smem(17, 256, 128, 3, 16, 163, 276, 144,
                                    2) == 120_724


@pytest.mark.parametrize("limits,expect", [
    (fk.FrameLimits(max_cluster=8, smem_optin=232304, sms=132),
     ("cluster", 8, 512)),
    (fk.FrameLimits(max_cluster=16, smem_optin=60_000, sms=132),
     ("grid", 17, 256)),
    (fk.FrameLimits(max_cluster=16, smem_optin=60_000, sms=10),
     ("grid", 10, 256)),
])
def test_plan_follows_the_device_limits(flagship, limits, expect):
    plan = _plan(flagship[1], limits)
    assert (plan.variant, plan.size, plan.threads) == expect
    if plan.variant == "grid":
        assert plan.smem == 4 * (3 * 128 + 12 * 256)


def test_forced_and_refused_variants(flagship, default_2d):
    obj = flagship[1]
    assert _plan(obj, grid=3) == fk.FramePlan("grid", 3,
                                              4 * (3 * 128 + 12 * 256))
    plan = _plan(obj, cluster=3)
    assert plan == fk.FramePlan("cluster", 3, _smem(obj, 3), 512)
    plan = _plan(obj, cluster=9)
    assert (plan.size, plan.threads) == (9, 512)
    # A cluster above the device's most CTAs, or whose CTA exceeds its
    # shared memory, is refused before any launch.
    with pytest.raises(ValueError, match="does not fit"):
        _plan(obj, fk.FrameLimits(16, 232304, 132), cluster=17)
    with pytest.raises(ValueError, match="does not fit"):
        _plan(obj, fk.FrameLimits(16, 60_000, 132), cluster=16)
    with pytest.raises(ValueError, match="without a block"):
        _plan(default_2d[1][0].obj, cluster=2)
    for kw in (dict(grid=2, cluster=2), dict(grid=-1), dict(cluster=-1)):
        with pytest.raises(ValueError):
            _plan(obj, **kw)


def test_shared_memory_size():
    """The flagship at 16 CTAs, elastic: 276 receive slots and 163
    position rows of 4 floats, 2 working sets, the rest-edge inverses and
    volumes of 2 blocks, velocities and 1/m of 163, the tables of 2 blocks
    (plus, minus, the local plan, the slots' local indices and
    destinations), ids and two spans (163 + 2 · 164) and 144 push codes."""
    words = (4 * 276 + 4 * 163 + 2 * (3 * 128 + 12 * 256) + 2 * 256 * 10
             + 163 * 4 + 2 * (10 * 256 + 3 * 128 + 1) + 163 + 2 * 164 + 144)
    assert fk.explicit_cluster_smem(17, 256, 128, 3, 16, 163, 276,
                                    144) == 4 * words
    # Each internal state adds 2 blocks' 256 matrices of 9.
    assert fk.explicit_cluster_smem(17, 256, 128, 3, 16, 163, 276, 144,
                                    1) == 4 * (words + 2 * 256 * 9)


@pytest.mark.parametrize("inelastic", [False, True])
def test_barrier_formula(inelastic):
    """The grid variant: a grid barrier after each substep's partials and
    after each kinematic step but an elastic frame's last; the cluster
    variant one more, after the copy-in.  (The CUDA tests hold the count
    each kernel makes of its own barriers to this one.)"""
    for s in (1, 2, 10):
        grid = fk.explicit_frame_barriers("grid", inelastic, s)
        cluster = fk.explicit_frame_barriers("cluster", inelastic, s)
        assert grid == 2 * s - (0 if inelastic else 1)
        assert cluster == grid + 1
    # The flagship's frame of 10 substeps: 19 grid barriers, 20 cluster
    # barriers (21 and 20 with the inelastic update).
    assert fk.explicit_frame_barriers("cluster", inelastic, 10) == (
        21 if inelastic else 20)
    with pytest.raises(ValueError):
        fk.explicit_frame_barriers("single", inelastic, 10)


def _check_assignment(bp, ptr, rows, n, cluster):
    """K8's assignment against the slot plan: ownership, receive slots
    (random partials, float64 sums in slot order) and push codes."""
    asg = fk.explicit_assignment(bp, ptr, rows, n, cluster)
    base = fk.cluster_assignment(bp, ptr, rows, n, cluster)
    b_cnt, pb = bp.shape
    for name in ("local_ptr", "local_ids", "block_local"):
        assert np.array_equal(getattr(asg, name), getattr(base, name))
    assert np.array_equal(np.diff(asg.owned_ptr), base.owned)
    # Every particle is owned exactly once.
    owned = [asg.local_ids[asg.local_ptr[r]:asg.local_ptr[r]
                           + base.owned[r]] for r in range(cluster)]
    flat = np.concatenate(owned)
    assert np.array_equal(np.sort(flat), np.arange(n))
    # Every real block slot goes to exactly one receive slot, every padded
    # slot nowhere.
    real = np.zeros(b_cnt * pb, bool)
    real[rows] = True
    assert np.array_equal(asg.slot_dest >= 0, real)
    dests = asg.slot_dest[real]
    assert np.unique(dests).size == dests.size
    # The sums: rank r's receive buffer gets each block slot's partial at
    # its destination; owned particle i sums its span in order.
    rng = np.random.default_rng(cluster)
    partials = rng.normal(size=(b_cnt * pb, 3))
    bufs = [np.full((asg.recv_ptr[asg.owned_ptr[r + 1]]
                     - asg.recv_ptr[asg.owned_ptr[r]], 3), np.nan)
            for r in range(cluster)]
    for s in np.nonzero(real)[0]:
        d = int(asg.slot_dest[s])
        bufs[d >> 16][d & 0xFFFF] = partials[s]
    for r in range(cluster):
        first = asg.recv_ptr[asg.owned_ptr[r]]
        for k, p in enumerate(owned[r]):
            i = asg.owned_ptr[r] + k
            got = np.zeros(3)
            for row in bufs[r][asg.recv_ptr[i] - first:
                               asg.recv_ptr[i + 1] - first]:
                got = got + row
            want = np.zeros(3)
            for q in range(ptr[p], ptr[p + 1]):
                want = want + partials[rows[q]]
            assert np.array_equal(got, want), (r, p)
    # The push codes: each owned particle's other holders, ascending by
    # rank, with its local index there.
    for r in range(cluster):
        for k, p in enumerate(owned[r]):
            i = asg.owned_ptr[r] + k
            codes = asg.push_codes[asg.push_ptr[i]:asg.push_ptr[i + 1]]
            ranks = [c >> 16 for c in codes]
            holders = [q for q in range(cluster) if q != r and p in
                       asg.local_ids[asg.local_ptr[q]:asg.local_ptr[q + 1]]]
            assert ranks == holders
            for c in codes:
                q, loc = c >> 16, c & 0xFFFF
                assert asg.local_ids[asg.local_ptr[q] + loc] == p
    return asg


@pytest.mark.parametrize("cluster", [1, 3, 16])
def test_flagship_assignment_sums_as_the_slot_plan(flagship, cluster):
    blk = flagship[1].blocking
    asg = _check_assignment(*_host(blk), 1007, cluster)
    if cluster == 1:
        assert asg.sizes()[2] == 0  # one CTA pushes nowhere


def test_grid_and_cube_assignments_sum_as_the_slot_plan(grid_2d):
    obj = grid_2d[1][0].obj
    _check_assignment(*_host(obj.blocking), obj.particle_cnt, 16)
    # A small cube blocked over many blocks, some ranks with several.
    from tests.test_blocked import _cube_mesh

    nodes, _, tets = _cube_mesh(spacing=0.3)
    rng = np.random.default_rng(0)
    blk = blocking.build_blocking(
        tets, rng.normal(size=(tets.shape[0], 3, 3)).astype(np.float32),
        rng.uniform(0.5, 1.0, tets.shape[0]).astype(np.float32),
        nodes.astype(np.float32), eb=32, pb=32, device="cpu")
    assert blk.num_blocks > 6
    _check_assignment(*_host(blk), nodes.shape[0], 5)


def test_k4_plan_picks_the_cluster_variant(flagship, default_2d):
    """K4's cluster variant (five local vectors: vel, x, r, d, q) on the
    flagship (16 CTAs) and default.json (1 CTA), each CTA smaller than
    K11b's on the same mesh by two vectors of d floats a local particle."""
    for obj, size in ((flagship[1], 16), (default_2d[1][0].obj, 1)):
        host = (obj.element_indices.numpy(), obj.plan.ptr.numpy(),
                obj.plan.rows.numpy())
        plan = ff.fused_frame_plan(*host, obj.particle_cnt, obj.dim,
                                   ff.H100_LIMITS,
                                   vectors=cg_kernels.CLUSTER_VECTORS)
        frame = ff.fused_frame_plan(*host, obj.particle_cnt, obj.dim,
                                    ff.H100_LIMITS)
        asg = ff.cluster_assignment(*host, obj.particle_cnt, size)
        cap = asg.sizes()[1]
        assert plan == ff.FusedPlan("cluster", size, ff.cluster_smem(
            *asg.sizes(), obj.dim, 5))
        assert frame.size == size
        assert frame.smem - plan.smem == 4 * 2 * obj.dim * cap
        single = ff.fused_frame_plan(*host, obj.particle_cnt, obj.dim,
                                     ff.H100_LIMITS, single=True,
                                     vectors=5)
        assert single.variant == "single"


@pytest.mark.parametrize("normal,per_solve,per_it,single", [
    (True, 7, 5, (14, 12)), (False, 5, 3, (8, 9))])
def test_k4_barrier_formula(normal, per_solve, per_it, single):
    for it in (0, 2, 30):
        assert cg_kernels.fused_cg_barriers("cluster", normal, it) == (
            per_solve + per_it * it)
        assert cg_kernels.fused_cg_barriers("single", normal, it) == (
            single[0] + single[1] * it)


def _frame_kw(cfg, obj):
    return dict(dt=cfg.delta_time, damping=obj.damping,
                g_dir=tuple(cfg.g_dir), mu=obj.mu, s_lambda=obj.s_lambda,
                sim_count=cfg.sim_count, material=obj.material,
                plastic_yield=obj.plastic_yield, viscous_mu=obj.viscous_mu,
                viscous_tau=obj.viscous_tau)


def test_binding_is_built_once_and_again_when_replaced(default_2d):
    """The binding of a blocking, a mass and the frame's constants is found
    again while they are unchanged, and built again when the mass is
    replaced or changed in place, when the blocking is replaced, or when a
    constant differs."""
    cfg, (body,), obs = default_2d
    obj, state = body.obj, body.state
    kw = _frame_kw(cfg, obj)
    blk, mass = obj.blocking, obj.mass.clone()
    builds = fk.ExplicitFrameBinding.builds
    first = fk.explicit_frame_binding(blk, mass, **kw)
    assert fk.explicit_frame_binding(blk, mass, **kw) is first
    assert fk.ExplicitFrameBinding.builds == builds + 1
    mass.mul_(1.0)  # in place: a new version, the same values
    second = fk.explicit_frame_binding(blk, mass, **kw)
    assert second is not first and second.matches(blk, mass)
    assert not first.matches(blk, mass)
    third = fk.explicit_frame_binding(blk, mass.clone(), **kw)
    assert third is not second
    blk2 = dataclasses.replace(blk)
    fourth = fk.explicit_frame_binding(blk2, mass, **kw)
    assert fourth is not second and not second.matches(blk2, mass)
    fifth = fk.explicit_frame_binding(blk, mass, **dict(kw, sim_count=3))
    assert fifth is not second
    assert fk.ExplicitFrameBinding.builds == builds + 5
    # A binding's frame is the plain frame (on the CPU), in fresh tensors.
    out = second(state.pos, state.vel, obs.centers, obs.radii)
    ref = fk.fused_explicit_frame_plain(blk, state.pos, state.vel, mass,
                                        obs.centers, obs.radii, **kw)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert out[0].data_ptr() != state.pos.data_ptr()


def test_frame_function_binds_once_and_returns_fresh_states(default_2d):
    """make_explicit_blocked_frame_fn passes the same constants every frame
    (so K8's binding is found again), and each frame returns new tensors:
    a caller's earlier states stay as they were."""
    cfg, (body,), obs = default_2d
    obj, state = body.obj, body.state
    cfg = dataclasses.replace(cfg, frame_backend="blocked_explicit")
    frame = sim.make_frame_fn(obj, cfg)
    s1, _ = frame(state, obs)
    keep = s1.pos.clone()
    s2, _ = frame(s1, obs)
    assert torch.equal(s1.pos, keep)
    assert s2.pos.data_ptr() != s1.pos.data_ptr()
    assert not torch.equal(s2.pos, s1.pos)
