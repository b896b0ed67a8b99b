# coding=utf-8
"""K5 and K8, the whole frame: ``sim_count`` substeps in one launch.

``fused_blocked_frame`` (K5: implicit-CG substeps) and
``fused_explicit_frame`` (K8: explicit substeps, also for autodiff configs)
launch ``fem_tpu_torch/csrc/blocked_frame.cu`` and
``fem_tpu_torch/csrc/explicit_frame.cu`` for tensors on a CUDA device (each
as one thread-block cluster, or as a cooperative grid when the frame's
state does not fit one cluster: :func:`frame_plan`,
:func:`explicit_frame_plan`); they replace the JAX package's Pallas kernels
``ops/pallas_blocked_frame.py:_frame_kernel`` (entry ``fused_blocked_frame``)
and ``_explicit_frame_kernel`` (entry ``fused_explicit_frame``), for every
material of ``ops/element.py`` (K5 also ``robust``), with their plastic and
Maxwell branches, in the blocking's dimension (2 or 3; one kernel template
per kernel, an instance per dimension, material and elastic or inelastic,
each material's instances in a library of their own).  For tensors on the
CPU each runs its plain version: ``fused_blocked_frame_plain`` runs per substep the plain blocked
prep, the slot-sum assembly, the reference CG over the plain blocked
operator and the plain advection; ``fused_explicit_frame_plain`` per
substep the plain blocked gradient prep, the slot sum and the plain
kinematic step.  On CUDA each launches its kernel or raises — also when the
grid cannot be co-resident, since a grid barrier in a grid that is not
would hang.

K5's two variants.  :func:`frame_plan` chooses, from the sizes alone and
the device's limits (:class:`FrameLimits`), the **cluster** variant when
the frame's state fits the shared memory of one cluster of at most
``max_cluster`` CTAs (the H100's 16), and the **grid** variant otherwise;
``cluster=`` or ``grid=`` on :func:`fused_blocked_frame` forces one (tests
and ``chip_smoke.py``; the config schema has neither).  A plan the device
cannot run raises: a cluster that cannot be scheduled never retries as the
grid kernel or the plain version.  :func:`cluster_assignment` gives each
cluster rank its blocks (b ≡ rank mod C) and its local particles (those
its blocks touch, each particle owned by exactly one rank), once per
blocking and cluster size, on the host.

K8's two variants likewise (:func:`explicit_frame_plan`: the cluster
variant whenever a CTA's state fits, the grid variant otherwise;
``cluster=`` or ``grid=`` force one), on the same ownership; its
assignment (:func:`explicit_assignment`) adds where each block slot's sum
goes (a receive slot of the CTA that owns the slot's particle) and which
other CTAs hold each owned particle (its new position is stored into
them).  What K8 needs that is fixed per blocking, mass and frame constants
— the plan, its device checks and tables, the checked operands, the
material's parameters, gravity, the decay and a prebuilt argument struct —
is bound once (:class:`ExplicitFrameBinding`, found again by
:func:`explicit_frame_binding` while the tensors and their version
counters are unchanged); a frame patches its inputs, allocates fresh
outputs and launches.

Inelastic materials (ops/inelastic.py): ``plastic_inv`` (F_p⁻¹, when
``plastic_yield`` > 0) and ``viscous_inv`` (F_v⁻¹, when ``viscous_mu`` > 0)
enter and leave in mesh element order, (E, d, d); each frame returns them
after the ones it returns for an elastic material.  The kernels keep them
per element slot through ``Blocking.element_perm``, run the base chain on
R⁻¹·F_p⁻¹ and add the stable Neo-Hookean branch (λ = 0, μ_v) on R⁻¹·F_v⁻¹,
and update both after each substep's advection (csrc/inelastic.cuh).  The
plain frames do the same through ``ops/inelastic.advance_blocked`` with the
plain edge matrices.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from fem_tpu_torch.models.state import Obstacles, SimState
from fem_tpu_torch.ops.blocked_kernels import (
    BlockTablesC,
    block_tables,
    blocked_edges_plain,
    blocked_grad_prep_layers_plain,
    blocked_graph_apply_plain,
    blocked_prep_layers_plain,
    blocked_velocity_solve,
    check_slot_plan,
)
from fem_tpu_torch.ops.blocking import Blocking, blocked_scatter_sum
from fem_tpu_torch.ops.element import kernel_material_id
from fem_tpu_torch.ops.element_kernels import (
    MaterialParamsC,
    count_launch,
    material_params,
)
from fem_tpu_torch.ops.inelastic import (
    BRANCH_MATERIAL,
    advance_blocked,
    layer_ref_inv_blocked,
    relax_decay,
)
from fem_tpu_torch.solvers.advect import (
    advect_implicit_step,
    damping_decay,
    gravity_vector,
    kinematic_step,
)
from fem_tpu_torch.utils import cuda_build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


# The inelastic tail both frames' argument structs share
# (csrc/inelastic.cuh: InelasticArgs).
_INELASTIC_FIELDS = [
    ("element_perm", _P), ("plastic_in", _P), ("viscous_in", _P),
    ("plastic", _P), ("viscous", _P),
    ("plastic_yield", _F), ("viscous_mu", _F), ("relax", _F),
]


class FrameArgsC(ctypes.Structure):
    """Mirror of ``FemFrameArgs`` (csrc/blocked_frame.cu)."""

    _fields_ = [
        ("T", BlockTablesC),
        ("slot_ptr", _P), ("slot_rows", _P),
        ("pos_in", _P), ("vel_in", _P), ("velg_in", _P),
        ("mass", _P), ("centers", _P), ("radii", _P),
        ("n", _I), ("n_obst", _I), ("sim_count", _I), ("max_iter", _I),
        ("normal", _I), ("material", _I),
        ("dt", _F), ("dt2", _F), ("decay", _F),
        ("g0", _F), ("g1", _F), ("g2", _F),
        ("mat", MaterialParamsC), ("tol", _F),
        ("pos", _P), ("vel", _P), ("velg", _P), ("scratch", _P),
        ("iters", _P), ("res", _P),
    ] + _INELASTIC_FIELDS + [
        ("cl_local_ptr", _P), ("cl_local_ids", _P), ("cl_owned", _P),
        ("cl_block_local", _P), ("cl_slot_ptr", _P), ("cl_slot_code", _P),
        ("cl_cap", _I), ("barriers", _P),
    ]


def _gravity3(g_dir, d):
    """9.8·g_dir as the kernels' three gravity floats (the third is 0 and
    unused in 2D), after checking that ``g_dir`` has ``d`` components."""
    if len(g_dir) != d:
        raise ValueError(f"g_dir has {len(g_dir)} components, expected {d}")
    grav = gravity_vector(tuple(g_dir), torch.device("cpu")).tolist()
    return grav + [0.0] * (3 - d)


class _Internal:
    """The material and inelastic state of one frame call: which branches
    are on, their constants, and the plain versions' layers and update."""

    def __init__(self, blk, mu, s_lambda, plastic_inv, plastic_yield,
                 viscous_inv, viscous_mu, viscous_tau, dt,
                 material="neo_hookean"):
        self.plastic = plastic_yield > 0.0
        self.viscous = viscous_mu > 0.0
        for on, fi, name in ((self.plastic, plastic_inv, "plastic_inv"),
                             (self.viscous, viscous_inv, "viscous_inv")):
            if on != (fi is not None):
                raise ValueError(
                    f"{name} must be given exactly when its branch is on")
        self.blk, self.mu, self.lam = blk, mu, s_lambda
        self.material = material
        self.plastic_yield, self.viscous_mu = plastic_yield, viscous_mu
        self.relax = relax_decay(dt, viscous_tau) if self.viscous else 0.0
        self.state = (plastic_inv, viscous_inv)

    @property
    def on(self):
        return self.plastic or self.viscous

    def layers(self):
        plastic, viscous = self.state
        out = [(layer_ref_inv_blocked(self.blk, plastic), self.mu, self.lam,
                self.material)]
        if viscous is not None:
            out.append((layer_ref_inv_blocked(self.blk, viscous),
                        self.viscous_mu, 0.0, BRANCH_MATERIAL))
        return out

    def advance(self, pos):
        if self.on:
            self.state = advance_blocked(
                self.blk, pos, *self.state, self.plastic_yield, self.relax,
                edges=blocked_edges_plain)

    def outputs(self):
        return tuple(fi for fi in self.state if fi is not None)


def fused_blocked_frame_plain(
    blk: Blocking, pos, vel, vel_g, mass, centers, radii, *, dt, damping,
    g_dir, mu, s_lambda, preconditioned, sim_count, max_iter=500, tol=1e-5,
    robust=False, material="neo_hookean", plastic_inv=None,
    plastic_yield=0.0, viscous_inv=None, viscous_mu=0.0, viscous_tau=0.1,
):
    """Plain PyTorch version of :func:`fused_blocked_frame`."""
    internal = _Internal(blk, mu, s_lambda, plastic_inv, plastic_yield,
                         viscous_inv, viscous_mu, viscous_tau, dt, material)
    state = SimState(pos=pos, vel=vel, vel_g=vel_g, force=torch.zeros_like(pos))
    obstacles = Obstacles(centers=centers, radii=radii)
    decay = damping_decay(dt, damping, pos.dtype)
    gravity = gravity_vector(tuple(g_dir), pos.device)
    iters, res = [], []
    for _ in range(sim_count):
        K, partials = blocked_prep_layers_plain(blk, state.pos,
                                                internal.layers(), robust)
        sol = blocked_velocity_solve(
            blk, (K, blocked_scatter_sum(partials, blk)),
            state.vel, mass, dt, bool(preconditioned),
            apply=blocked_graph_apply_plain, max_iter=max_iter, tol=tol,
        )
        state = advect_implicit_step(
            state.replace(vel=sol.x), obstacles, dt, decay, gravity
        )
        internal.advance(state.pos)
        iters.append(sol.iterations)
        res.append(sol.residual)
    return (state.pos, state.vel, state.vel_g, torch.stack(iters),
            torch.stack(res)) + internal.outputs()


def _inelastic_args(blk, internal, n_elem, d):
    """(C field values of the inelastic tail, output tensors) of a launch;
    null pointers and no outputs for an elastic material."""
    if not internal.on:
        return [None, None, None, None, None, 0.0, 0.0, 0.0], ()
    dev = blk.volume.device
    ins, outs = [], []
    for on, fi, name in zip((internal.plastic, internal.viscous),
                            internal.state, ("plastic_inv", "viscous_inv")):
        if not on:
            ins.append(None)
            outs.append(None)
            continue
        cuda_build.check_operand(name, fi, (n_elem, d, d), torch.float32, dev)
        ins.append(fi.data_ptr())
        outs.append(torch.empty_like(fi))
    cuda_build.check_operand("blocking.element_perm", blk.element_perm,
                             (blk.num_blocks * blk.eb,), torch.int32, dev)
    fields = [blk.element_perm.data_ptr(), *ins,
              *(None if o is None else o.data_ptr() for o in outs),
              internal.plastic_yield, internal.viscous_mu, internal.relax]
    return fields, tuple(o for o in outs if o is not None)


def _library(material_id: int):
    lib = cuda_build.load("blocked_frame", material_id)
    if lib.fem_blocked_frame.argtypes is None:
        lib.fem_blocked_frame_scratch_floats.argtypes = [_I, _I, _I, _I, _I]
        lib.fem_blocked_frame_scratch_floats.restype = ctypes.c_longlong
        out = ctypes.POINTER(_I)
        lib.fem_blocked_frame_plan.argtypes = [
            _I, _I, _I, _I, _I, _I, _I, out, out, out,
        ]
        lib.fem_blocked_frame_plan.restype = _I
        lib.fem_blocked_frame.argtypes = [
            ctypes.POINTER(FrameArgsC), _I, _I, _P,
        ]
        lib.fem_blocked_frame.restype = _I
        lib.fem_blocked_frame_error.argtypes = [_I]
        lib.fem_blocked_frame_error.restype = ctypes.c_char_p
        lib.fem_blocked_frame_limits.argtypes = [_I, _I, _I, out, out, out]
        lib.fem_blocked_frame_limits.restype = _I
        lib.fem_blocked_frame_cluster_smem.argtypes = [_I] * 7
        lib.fem_blocked_frame_cluster_smem.restype = ctypes.c_longlong
        lib.fem_blocked_frame_cluster_fit.argtypes = [_I] * 6 + [out]
        lib.fem_blocked_frame_cluster_fit.restype = _I
        lib.fem_blocked_frame_cluster.argtypes = [
            ctypes.POINTER(FrameArgsC), _I, _I, _I, _P,
        ]
        lib.fem_blocked_frame_cluster.restype = _I
    return lib


def _plan(lib, plan_fn, error_fn, what, device_index, num_blocks, eb, pb,
          grid, dim, material_id, inelastic):
    g, smem, most = _I(0), _I(0), _I(0)
    with torch.cuda.device(device_index):
        rc = plan_fn(
            num_blocks, eb, pb, grid, dim, material_id, int(inelastic),
            ctypes.byref(g), ctypes.byref(smem), ctypes.byref(most),
        )
    if rc != 0:
        msg = error_fn(rc).decode()
        raise RuntimeError(
            f"{what}: {msg} (grid {g.value} CTAs, at most "
            f"{most.value} co-resident, {smem.value} B of shared memory each)"
        )
    return g.value, smem.value


class FrameLimits(NamedTuple):
    """What K5's plan needs of a device: the most CTAs one cluster of the
    kernel can have, the most dynamic shared memory a CTA of it can take
    (bytes: the opt-in limit less its 144 B of static shared memory) and
    the SMs."""

    max_cluster: int
    smem_optin: int
    sms: int


# An H100 SXM (sm_90): clusters of up to 16 CTAs with the non-portable size
# allowed, 227 KB (232,448 B) of shared memory a CTA less K5's static 144 B,
# 132 SMs.  The wrapper reads the device's own (device_limits); this is for
# planning without a card.
H100_LIMITS = FrameLimits(max_cluster=16, smem_optin=232304, sms=132)


class FramePlan(NamedTuple):
    """K5's launch: ``variant`` "cluster" (one cluster of ``size`` CTAs) or
    "grid" (a cooperative grid of ``size`` CTAs), with ``smem`` bytes of
    dynamic shared memory and ``threads`` threads a CTA."""

    variant: str
    size: int
    smem: int
    threads: int = 256


# Threads of a CTA's group (csrc/blocked_frame.cu: kThreads); a cluster CTA
# has one group per block it owns, at most two.
GROUP_THREADS = 256
MAX_GROUPS = 2


_F32 = 4


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def grid_smem(num_blocks: int, eb: int, pb: int, dim: int, grid: int) -> int:
    """Bytes of dynamic shared memory of the grid variant's CTA: its
    blocks' K and one block's working set (csrc/blocked_frame.cu:
    frame_smem)."""
    bpc = _ceil_div(num_blocks, grid)
    return _F32 * (dim * dim * bpc * eb + dim * pb + (dim + 1) * dim * eb)


def cluster_capacity(num_blocks: int, pb: int, n: int, cluster: int,
                     n_free: int = 0) -> int:
    """Rows of each local vector of a cluster rank: the particles its
    ⌈B/C⌉ blocks can touch, plus the particles in no block (``n_free``),
    at most ``n``."""
    return min(n, _ceil_div(num_blocks, cluster) * pb + n_free)


def cluster_groups(num_blocks: int, cluster: int) -> int:
    """Thread groups of a cluster CTA: one per block it owns, at most
    ``MAX_GROUPS`` (the groups then take the blocks in rounds)."""
    return min(_ceil_div(num_blocks, cluster), MAX_GROUPS)


def cluster_smem(num_blocks: int, eb: int, pb: int, n: int, dim: int,
                 cluster: int, n_free: int = 0) -> int:
    """Bytes of dynamic shared memory of the cluster variant's CTA: its
    blocks' K, one block's working set per thread group, three copies of
    its slot partials, seven local vectors of d floats and 1/m, then its
    blocks' tables (plus, minus, the local plan, the slots' local
    indices), the local particles' ids and slot lists
    (csrc/blocked_frame.cu: cluster_smem_words)."""
    bpc = _ceil_div(num_blocks, cluster)
    cap = cluster_capacity(num_blocks, pb, n, cluster, n_free)
    groups = cluster_groups(num_blocks, cluster)
    return _F32 * (dim * dim * bpc * eb
                   + groups * (dim * pb + (dim + 1) * dim * eb)
                   + 3 * bpc * pb * dim + cap * (7 * dim + 1)
                   + bpc * ((3 * dim + 1) * eb + 2 * pb + 1)
                   + 2 * cap + 1 + num_blocks * pb)


def _cluster_plan(num_blocks, eb, pb, n, dim, cluster, n_free):
    return FramePlan("cluster", cluster,
                     cluster_smem(num_blocks, eb, pb, n, dim, cluster, n_free),
                     GROUP_THREADS * cluster_groups(num_blocks, cluster))


def frame_plan(num_blocks: int, eb: int, pb: int, n: int, dim: int,
               limits: FrameLimits, grid: int = 0, cluster: int = 0,
               n_free: int = 0) -> FramePlan:
    """K5's variant, its CTAs and their shared memory, from the sizes and
    the device's ``limits`` alone.

    Forced: ``grid`` > 0 gives the grid variant of that many CTAs,
    ``cluster`` > 0 the cluster variant of that many (checked on the device
    at launch).  Otherwise the cluster variant with one CTA per block, at
    most ``max_cluster`` (17 blocks: 16 CTAs, one of them with two blocks
    and two thread groups), when a CTA's state fits ``smem_optin``; else
    the grid variant, one CTA per block and at most one per SM.  (A CTA's
    phases take the longer the more blocks and particles it holds, so the
    most CTAs are the fastest; ``tools/torch_k5_sweep.py`` times the
    flagship at 6 to 16.)"""
    if grid < 0 or cluster < 0:
        raise ValueError(f"grid {grid} and cluster {cluster} must be >= 0")
    if grid and cluster:
        raise ValueError("give grid or cluster, not both")
    if num_blocks < 1 or dim not in (2, 3):
        raise ValueError(f"no frame of {num_blocks} blocks in {dim}D")
    if grid:
        return FramePlan("grid", grid, grid_smem(num_blocks, eb, pb, dim,
                                                 grid))
    if cluster:
        return _cluster_plan(num_blocks, eb, pb, n, dim, cluster, n_free)
    plan = _cluster_plan(num_blocks, eb, pb, n, dim,
                         min(num_blocks, limits.max_cluster), n_free)
    if plan.smem <= limits.smem_optin:
        return plan
    size = min(num_blocks, limits.sms)
    return FramePlan("grid", size, grid_smem(num_blocks, eb, pb, dim, size))


def frame_barriers(variant: str, normal: bool, iterations) -> int:
    """Barriers of one K5 frame whose substeps took ``iterations``: per
    substep and per CG iteration, as csrc/blocked_frame.cu places them,
    plus one a frame (the grid variant's after the copy-in, the cluster
    variant's before exit).  The kernel counts the barriers it meets
    (``fused_blocked_frame.last_barriers``); the CUDA tests and
    ``chip_smoke.py`` hold that count to this one."""
    per_step, per_it = {("grid", True): (8, 6), ("grid", False): (5, 4),
                        ("cluster", True): (4, 4),
                        ("cluster", False): (3, 3)}[(variant, bool(normal))]
    return sum(per_step + per_it * int(it) for it in iterations) + 1


class ClusterAssignment(NamedTuple):
    """Blocks and particles of a cluster of ``C`` CTAs (numpy int32).

    Rank r owns blocks b ≡ r (mod C).  Its local particles are
    ``local_ids[local_ptr[r]:local_ptr[r+1]]``: first the ``owned[r]`` it
    owns (ascending), then the others its blocks touch (ascending).  A
    particle is owned by the rank of the block of its first slot; one in no
    block by rank (its index among those, mod C).  ``block_local[b·Pb+p]``
    is the local index, in block b's rank, of slot p's particle (0 for a
    padded slot).  Local particle i (flat over the ranks) has its block
    slots, ascending, in ``slot_code[slot_ptr[i]:slot_ptr[i+1]]``, each as
    rank·65536 + (b // C)·Pb + p: where its partial sits in the rank that
    owns block b."""

    local_ptr: np.ndarray
    local_ids: np.ndarray
    owned: np.ndarray
    block_local: np.ndarray
    slot_ptr: np.ndarray
    slot_code: np.ndarray


def cluster_assignment(block_particles, slot_ptr, slot_rows, n: int,
                       cluster: int) -> ClusterAssignment:
    """The assignment of a blocking's blocks and particles to ``cluster``
    ranks (host, numpy): ``block_particles`` (B, Pb) and the CSR slot plan
    (``slot_ptr`` (N+1,), ``slot_rows``, flat slots b·Pb+p) of
    :class:`~fem_tpu_torch.ops.blocking.Blocking`."""
    bp = np.asarray(block_particles, np.int64)
    ptr = np.asarray(slot_ptr, np.int64)
    rows = np.asarray(slot_rows, np.int64)
    b_cnt, pb = bp.shape
    real = np.zeros(b_cnt * pb, bool)
    real[rows] = True
    real = real.reshape(b_cnt, pb)
    counts = np.diff(ptr)
    owner = np.empty(n, np.int64)
    has = counts > 0
    owner[has] = (rows[ptr[:-1][has]] // pb) % cluster
    free = np.nonzero(~has)[0]
    owner[free] = np.arange(free.size) % cluster
    local_ptr, local_ids, owned = [0], [], []
    block_local = np.zeros((b_cnt, pb), np.int32)
    lookup = np.full(n, -1, np.int64)
    for r in range(cluster):
        blocks = np.arange(r, b_cnt, cluster)
        mine = np.nonzero(owner == r)[0]
        touched = np.unique(bp[blocks][real[blocks]])
        local = np.concatenate([mine, np.setdiff1d(touched, mine)])
        lookup[local] = np.arange(local.size)
        for b in blocks:
            block_local[b] = np.where(real[b], lookup[bp[b]], 0)
        lookup[local] = -1
        local_ids.append(local)
        owned.append(mine.size)
        local_ptr.append(local_ptr[-1] + local.size)
    if _ceil_div(b_cnt, cluster) * pb > 65536 or cluster > 32767:
        raise ValueError("a rank's slots exceed the 16-bit slot index")
    ids = np.concatenate(local_ids)
    counts_l = counts[ids]
    slot_ptr = np.concatenate([[0], np.cumsum(counts_l)])
    # Entry k of local particle i is slot plan entry ptr[ids[i]] + k.
    within = np.arange(slot_ptr[-1]) - np.repeat(slot_ptr[:-1], counts_l)
    slots = rows[np.repeat(ptr[ids], counts_l) + within]
    blocks = slots // pb
    code = (blocks % cluster) * 65536 + (blocks // cluster) * pb + slots % pb
    return ClusterAssignment(
        local_ptr=np.asarray(local_ptr, np.int32),
        local_ids=ids.astype(np.int32),
        owned=np.asarray(owned, np.int32),
        block_local=block_local.reshape(-1),
        slot_ptr=slot_ptr.astype(np.int32),
        slot_code=code.astype(np.int32))


@functools.lru_cache(maxsize=64)
def device_limits(device_index: int, dim: int, material_id: int = 0,
                  inelastic: bool = False) -> FrameLimits:
    """The :class:`FrameLimits` of CUDA device ``device_index`` for K5's
    cluster instance (``dim``, ``material_id``, elastic or inelastic)."""
    lib = _library(material_id)
    mc, optin, sms = _I(0), _I(0), _I(0)
    with torch.cuda.device(device_index):
        rc = lib.fem_blocked_frame_limits(dim, material_id, int(inelastic),
                                          ctypes.byref(mc),
                                          ctypes.byref(optin),
                                          ctypes.byref(sms))
    if rc != 0:
        raise RuntimeError("whole-frame kernel: reading the device's limits "
                           f"failed: {lib.fem_blocked_frame_error(rc).decode()}")
    return FrameLimits(mc.value, optin.value, sms.value)


# id(blocking) → (blocking, its particles in no block, {C: its assignment's
# device tensors}); the blocking is held so that its id is not reused.
_CLUSTER_CACHE: dict = {}


def _cluster_entry(blk: Blocking, n: int):
    hit = _CLUSTER_CACHE.get(id(blk))
    if hit is None or hit[0] is not blk:
        counts = torch.diff(blk.slot_plan.ptr.cpu())[:n]
        hit = (blk, int((counts == 0).sum()), {})
        if len(_CLUSTER_CACHE) >= 32:
            _CLUSTER_CACHE.pop(next(iter(_CLUSTER_CACHE)))
        _CLUSTER_CACHE[id(blk)] = hit
    return hit


def cluster_tables(blk: Blocking, n: int, cluster: int):
    """The fields of :func:`cluster_assignment` for ``blk`` as int32
    tensors on its device,
    computed on the host once per blocking and cluster size."""
    _, _, by_size = _cluster_entry(blk, n)
    if cluster not in by_size:
        asg = cluster_assignment(blk.block_particles.cpu().numpy(),
                                 blk.slot_plan.ptr.cpu().numpy(),
                                 blk.slot_plan.rows.cpu().numpy(), n, cluster)
        by_size[cluster] = tuple(torch.as_tensor(a, device=blk.volume.device)
                                 for a in asg)
    return by_size[cluster]


# Device → the (1,) int32 tensor K5's launches there write their barrier
# count to.
_BARRIERS: dict = {}


def _barrier_count(dev: torch.device) -> torch.Tensor:
    buf = _BARRIERS.get(dev)
    if buf is None:
        buf = _BARRIERS[dev] = torch.zeros((1,), dtype=torch.int32,
                                           device=dev)
    return buf


@functools.lru_cache(maxsize=256)
def _check_cluster(device_index: int, plan: FramePlan, num_blocks: int,
                   eb: int, pb: int, n: int, d: int, n_free: int, mid: int,
                   inelastic: bool) -> int:
    """Raise unless the device can run ``plan`` (cluster variant); else
    return the rows of its local vectors.  Once per plan and instance on a
    device: a plan that fits is remembered, one that does not raises
    again (the kernel's attributes, set here, stay set on the device)."""
    lib = _library(mid)
    cap = cluster_capacity(num_blocks, pb, n, plan.size, n_free)
    want = lib.fem_blocked_frame_cluster_smem(num_blocks, eb, pb, cap,
                                              plan.size, d, plan.threads)
    if want != plan.smem:
        raise RuntimeError(f"whole-frame kernel: the plan's {plan.smem} B of "
                           f"shared memory differ from the kernel's {want}")
    most = _I(0)
    with torch.cuda.device(device_index):
        rc = lib.fem_blocked_frame_cluster_fit(plan.size, plan.threads,
                                               plan.smem, d, mid,
                                               int(inelastic),
                                               ctypes.byref(most))
    if rc != 0:
        raise RuntimeError(
            f"whole-frame kernel: {lib.fem_blocked_frame_error(rc).decode()} "
            f"(one cluster of {plan.size} CTAs of {plan.threads} threads, "
            f"{plan.smem} B of shared memory each; {most.value} such "
            f"clusters fit at once)")
    return cap


def fused_blocked_frame(
    blk: Blocking,
    pos: torch.Tensor,
    vel: torch.Tensor,
    vel_g: torch.Tensor,
    mass: torch.Tensor,
    centers: torch.Tensor,
    radii: torch.Tensor,
    *,
    dt: float,
    damping: float,
    g_dir: Tuple[float, ...],
    mu: float,
    s_lambda: float,
    preconditioned: bool,
    sim_count: int,
    max_iter: int = 500,
    tol: float = 1e-5,
    grid: int = 0,
    cluster: int = 0,
    robust: bool = False,
    material: str = "neo_hookean",
    plastic_inv=None,
    plastic_yield: float = 0.0,
    viscous_inv=None,
    viscous_mu: float = 0.0,
    viscous_tau: float = 0.1,
):
    """One rendered frame of ``sim_count`` implicit-CG substeps: returns
    (pos', vel', vel_g' (N, d), iterations (S,) int32, ‖r‖² (S,) f32), then
    plastic_inv' and viscous_inv' (E, d, d) for the branches that are on —
    the contract of the JAX package's ``fused_blocked_frame``.

    CUDA tensors: one launch of the whole-frame kernel's instance of
    ``material`` (robust Neo-Hookean when ``robust``; ``robust`` leaves
    every other material's chain as it is), with its plastic and Maxwell
    branches when they are on, 2D or 3D, with no host synchronisation
    after the first call on a blocking (which plans the cluster on the
    host).  The variant is :func:`frame_plan`'s; ``cluster`` forces the
    cluster variant with that many CTAs, ``grid`` the cooperative grid
    variant with that many (tests and ``chip_smoke.py`` set them to walk
    blocks several a CTA and to ask for what cannot be scheduled, which
    raises).  The launch's plan is left in ``fused_blocked_frame.last_plan``
    and counted by (variant, size) in ``variant_launches``; the barriers
    its kernel met in ``fused_blocked_frame.last_barriers``, a (1,) int32
    tensor on the device that the next launch there overwrites
    (:func:`frame_barriers` says what it must hold).  CPU tensors:
    :func:`fused_blocked_frame_plain`."""
    inelastic = dict(plastic_inv=plastic_inv, plastic_yield=plastic_yield,
                     viscous_inv=viscous_inv, viscous_mu=viscous_mu,
                     viscous_tau=viscous_tau)
    mid = kernel_material_id(material, robust)
    if pos.device.type == "cpu":
        return fused_blocked_frame_plain(
            blk, pos, vel, vel_g, mass, centers, radii, dt=dt,
            damping=damping, g_dir=g_dir, mu=mu, s_lambda=s_lambda,
            preconditioned=preconditioned, sim_count=sim_count,
            max_iter=max_iter, tol=tol, robust=robust, material=material,
            **inelastic,
        )
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    internal = _Internal(blk, mu, s_lambda, dt=dt, material=material,
                         **inelastic)
    tables = block_tables(blk)
    dev = pos.device
    n, d = pos.shape[0], tables.dim
    o = radii.shape[0]
    plan = blk.slot_plan
    f32 = torch.float32
    for name, t, shape in (
        ("pos", pos, (n, d)), ("vel", vel, (n, d)), ("vel_g", vel_g, (n, d)),
        ("mass", mass, (n,)), ("centers", centers, (o, d)),
        ("radii", radii, (o,)),
    ):
        cuda_build.check_operand(name, t, shape, f32, blk.volume.device)
    check_slot_plan(blk, n, dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    lib = _library(mid)
    _, n_free, _ = _cluster_entry(blk, n)
    fplan = frame_plan(blk.num_blocks, blk.eb, blk.pb, n, d,
                       device_limits(index, d, mid, internal.on), int(grid),
                       int(cluster), n_free)
    if fplan.variant == "cluster":
        cap = _check_cluster(index, fplan, blk.num_blocks, blk.eb, blk.pb,
                             n, d, n_free, mid, internal.on)
        cl = cluster_tables(blk, n, fplan.size)
        cl_fields = [t.data_ptr() for t in cl] + [cap]
        scratch = None
    else:
        g, smem = _plan(lib, lib.fem_blocked_frame_plan,
                        lib.fem_blocked_frame_error, "whole-frame kernel",
                        index, blk.num_blocks, blk.eb, blk.pb, fplan.size, d,
                        mid, internal.on)
        fplan = FramePlan("grid", g, smem)
        cl_fields = [None] * len(ClusterAssignment._fields) + [0]
        scratch = torch.empty(
            lib.fem_blocked_frame_scratch_floats(n, blk.num_blocks, blk.pb, g,
                                                 d),
            dtype=f32, device=dev,
        )
    out = [torch.empty((n, d), dtype=f32, device=dev) for _ in range(3)]
    barriers = _barrier_count(dev)
    iters = torch.empty((sim_count,), dtype=torch.int32, device=dev)
    res = torch.empty((sim_count,), dtype=f32, device=dev)
    grav = _gravity3(g_dir, d)
    tail, state_out = _inelastic_args(blk, internal, blk.element_slot.shape[0],
                                      d)
    args = FrameArgsC(
        tables, plan.ptr.data_ptr(), plan.rows.data_ptr(), pos.data_ptr(),
        vel.data_ptr(), vel_g.data_ptr(), mass.data_ptr(), centers.data_ptr(),
        radii.data_ptr(), n, o, int(sim_count), int(max_iter),
        int(bool(preconditioned)), mid, dt, dt * dt,
        damping_decay(dt, damping), *grav, material_params(material, mu,
                                                           s_lambda, d),
        tol, out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        iters.data_ptr(), res.data_ptr(), *tail, *cl_fields,
        barriers.data_ptr(),
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if fplan.variant == "cluster":
            rc = lib.fem_blocked_frame_cluster(ctypes.byref(args), fplan.size,
                                               fplan.threads, fplan.smem,
                                               stream)
        else:
            rc = lib.fem_blocked_frame(ctypes.byref(args), fplan.size,
                                       fplan.smem, stream)
    if rc != 0:
        msg = lib.fem_blocked_frame_error(rc).decode()
        raise RuntimeError(f"whole-frame kernel launch failed ({fplan.variant} "
                           f"variant, {fplan.size} CTAs): {msg}")
    count_launch(fused_blocked_frame, d, mid, internal.on)
    fused_blocked_frame.last_plan = fplan
    fused_blocked_frame.last_barriers = barriers
    key = (fplan.variant, fplan.size)
    fused_blocked_frame.variant_launches[key] = (
        fused_blocked_frame.variant_launches.get(key, 0) + 1)
    return (out[0], out[1], out[2], iters, res) + state_out


fused_blocked_frame.launches = 0
fused_blocked_frame.instance_launches = {}
fused_blocked_frame.variant_launches = {}
fused_blocked_frame.last_plan = None
fused_blocked_frame.last_barriers = None


class ExplicitFrameArgsC(ctypes.Structure):
    """Mirror of ``FemExplicitFrameArgs`` (csrc/explicit_frame.cu)."""

    _fields_ = [
        ("T", BlockTablesC),
        ("slot_ptr", _P), ("slot_rows", _P),
        ("pos_in", _P), ("vel_in", _P),
        ("mass", _P), ("centers", _P), ("radii", _P),
        ("n", _I), ("n_obst", _I), ("sim_count", _I), ("material", _I),
        ("dt", _F), ("decay", _F),
        ("g0", _F), ("g1", _F), ("g2", _F),
        ("mat", MaterialParamsC),
        ("pos", _P), ("vel", _P), ("partials", _P),
    ] + _INELASTIC_FIELDS + [
        ("cl_local_ptr", _P), ("cl_local_ids", _P), ("cl_owned_ptr", _P),
        ("cl_block_local", _P), ("cl_slot_dest", _P), ("cl_recv_ptr", _P),
        ("cl_push_ptr", _P), ("cl_push_codes", _P),
        ("cl_cap", _I), ("cl_entries", _I), ("cl_pushes", _I),
        ("barriers", _P),
    ]


def fused_explicit_frame_plain(
    blk: Blocking, pos, vel, mass, centers, radii, *, dt, damping, g_dir,
    mu, s_lambda, sim_count, material="neo_hookean", plastic_inv=None,
    plastic_yield=0.0, viscous_inv=None, viscous_mu=0.0, viscous_tau=0.1,
):
    """Plain PyTorch version of :func:`fused_explicit_frame`: it multiplies
    the gradient by m⁻¹, as the kernel does."""
    internal = _Internal(blk, mu, s_lambda, plastic_inv, plastic_yield,
                         viscous_inv, viscous_mu, viscous_tau, dt, material)
    state = SimState(pos=pos, vel=vel, vel_g=torch.zeros_like(vel),
                     force=torch.zeros_like(pos))
    obstacles = Obstacles(centers=centers, radii=radii)
    decay = damping_decay(dt, damping, pos.dtype)
    gravity = gravity_vector(tuple(g_dir), pos.device, pos.dtype)
    inv_mass = 1.0 / mass
    for _ in range(sim_count):
        grad = blocked_scatter_sum(
            blocked_grad_prep_layers_plain(blk, state.pos, internal.layers()),
            blk)
        state = kinematic_step(state, grad, mass, obstacles, dt, decay,
                               gravity, inv_mass=inv_mass)
        internal.advance(state.pos)
    return (state.pos, state.vel) + internal.outputs()


def _explicit_library(material_id: int):
    lib = cuda_build.load("explicit_frame", material_id)
    if lib.fem_explicit_frame.argtypes is None:
        out = ctypes.POINTER(_I)
        lib.fem_explicit_frame_plan.argtypes = [
            _I, _I, _I, _I, _I, _I, _I, out, out, out,
        ]
        lib.fem_explicit_frame_plan.restype = _I
        lib.fem_explicit_frame.argtypes = [
            ctypes.POINTER(ExplicitFrameArgsC), _I, _I, _P,
        ]
        lib.fem_explicit_frame.restype = _I
        lib.fem_explicit_frame_error.argtypes = [_I]
        lib.fem_explicit_frame_error.restype = ctypes.c_char_p
        lib.fem_explicit_frame_limits.argtypes = [_I, _I, _I, out, out, out]
        lib.fem_explicit_frame_limits.restype = _I
        lib.fem_explicit_frame_cluster_smem.argtypes = [_I] * 10
        lib.fem_explicit_frame_cluster_smem.restype = ctypes.c_longlong
        lib.fem_explicit_frame_cluster_fit.argtypes = [_I] * 6 + [out]
        lib.fem_explicit_frame_cluster_fit.restype = _I
        lib.fem_explicit_frame_cluster.argtypes = [
            ctypes.POINTER(ExplicitFrameArgsC), _I, _I, _I, _P,
        ]
        lib.fem_explicit_frame_cluster.restype = _I
    return lib


class ExplicitAssignment(NamedTuple):
    """K8's cluster of ``C`` CTAs (numpy int32), on K5's ownership
    (:func:`cluster_assignment`: rank r owns blocks b ≡ r (mod C); a
    particle is owned by the rank of the block of its first slot).

    Rank r's local particles are ``local_ids[local_ptr[r]:local_ptr[r+1]]``,
    its owned ones first; owned particle i, flat over the ranks (rank r's
    are [owned_ptr[r], owned_ptr[r+1])), receives its block slots' sums, in
    the slot plan's order, in its rank's receive slots
    [recv_ptr[i], recv_ptr[i+1]) − recv_ptr[owned_ptr[r]].
    ``block_local[b·Pb+p]`` is the local index, in block b's rank, of slot
    p's particle (0 for a padded slot) and ``slot_dest[b·Pb+p]`` where the
    slot's sum goes: owner rank·65536 + receive slot there (−1 for a padded
    slot).  The other ranks that hold owned particle i, ascending, are
    ``push_codes[push_ptr[i]:push_ptr[i+1]]``, each as rank·65536 + its
    local index there."""

    local_ptr: np.ndarray
    local_ids: np.ndarray
    owned_ptr: np.ndarray
    block_local: np.ndarray
    slot_dest: np.ndarray
    recv_ptr: np.ndarray
    push_ptr: np.ndarray
    push_codes: np.ndarray

    def sizes(self):
        """(most local particles, most receive slots, most push codes) of a
        rank's: what a CTA's shared memory must hold."""
        return (int(np.diff(self.local_ptr).max()),
                int(np.diff(self.recv_ptr[self.owned_ptr]).max()),
                int(np.diff(self.push_ptr[self.owned_ptr]).max()))


def explicit_assignment(block_particles, slot_ptr, slot_rows, n: int,
                        cluster: int) -> ExplicitAssignment:
    """K8's assignment of a blocking's blocks and particles to ``cluster``
    ranks (host, numpy), from the arrays of :func:`cluster_assignment`."""
    base = cluster_assignment(block_particles, slot_ptr, slot_rows, n,
                              cluster)
    b_cnt, pb = np.asarray(block_particles).shape
    ptr = np.asarray(slot_ptr, np.int64)
    rows = np.asarray(slot_rows, np.int64)
    local_ptr = base.local_ptr.astype(np.int64)
    ids = base.local_ids.astype(np.int64)
    owned_ptr = np.concatenate([[0], np.cumsum(base.owned)])
    # The owned particles, flat: rank r's first owned[r] local ones.
    sel = np.concatenate([np.arange(local_ptr[r], local_ptr[r] + base.owned[r])
                          for r in range(cluster)]).astype(np.int64)
    own = ids[sel]
    counts = np.diff(ptr)[own]
    recv_ptr = np.concatenate([[0], np.cumsum(counts)])
    rank = np.repeat(np.repeat(np.arange(cluster), base.owned), counts)
    slot = np.arange(recv_ptr[-1]) - recv_ptr[owned_ptr[rank]]
    if slot.size and int(slot.max()) >= 65536:
        raise ValueError("a rank's receive slots exceed the 16-bit index")
    within = np.arange(recv_ptr[-1]) - np.repeat(recv_ptr[:-1], counts)
    slots = rows[np.repeat(ptr[own], counts) + within]
    slot_dest = np.full(b_cnt * pb, -1, np.int64)
    slot_dest[slots] = rank * 65536 + slot
    lookup = np.full((cluster, n), -1, np.int64)
    for r in range(cluster):
        lookup[r, ids[local_ptr[r]:local_ptr[r + 1]]] = np.arange(
            local_ptr[r + 1] - local_ptr[r])
    held = lookup[:, own] >= 0
    held[np.repeat(np.arange(cluster), base.owned), np.arange(own.size)] = False
    hr, hi = np.nonzero(held.T)  # (owned index, rank), by owned index
    push_ptr = np.concatenate([[0], np.cumsum(held.sum(axis=0))])
    push_codes = hi * 65536 + lookup[hi, own[hr]]
    i32 = functools.partial(np.asarray, dtype=np.int32)
    return ExplicitAssignment(
        local_ptr=base.local_ptr, local_ids=base.local_ids,
        owned_ptr=i32(owned_ptr), block_local=base.block_local,
        slot_dest=i32(slot_dest), recv_ptr=i32(recv_ptr),
        push_ptr=i32(push_ptr), push_codes=i32(push_codes))


_ROW_STRIDE = {2: 2, 3: 4}


def explicit_cluster_smem(num_blocks: int, eb: int, pb: int, dim: int,
                          cluster: int, cap: int, entries: int, pushes: int,
                          states: int = 0) -> int:
    """Bytes of dynamic shared memory of K8's cluster CTA: its receive
    slots and local positions (rows padded to 4 floats in 3D), one block's
    working set per thread group, its blocks' rest-edge inverses and
    volumes and (``states`` of 0-2) their elements' internal state, the
    owned particles' velocities and 1/m, then its blocks' tables (plus,
    minus, the local plan, the slots' local indices and destinations), the
    local particles' ids, the owned particles' spans of receive slots and
    push codes, and the push codes (csrc/explicit_frame.cu:
    cluster_smem_words)."""
    bpc = _ceil_div(num_blocks, cluster)
    groups = cluster_groups(num_blocks, cluster)
    rs = _ROW_STRIDE[dim]
    return _F32 * (rs * entries + rs * cap
                   + groups * (dim * pb + (dim + 1) * dim * eb)
                   + bpc * eb * (dim * dim + 1)
                   + states * bpc * eb * dim * dim + cap * (dim + 1)
                   + bpc * ((3 * dim + 1) * eb + 3 * pb + 1)
                   + cap + 2 * (cap + 1) + pushes)


def explicit_frame_plan(block_particles, slot_ptr, slot_rows, n: int,
                        eb: int, dim: int, limits: FrameLimits,
                        states: int = 0, grid: int = 0,
                        cluster: int = 0) -> FramePlan:
    """K8's variant, its CTAs, threads and shared memory, from the
    blocking's host arrays (those of :func:`cluster_assignment`), its
    element slots a block ``eb``, the internal states an element carries
    (``states``: plastic and/or viscous) and the device's ``limits``.

    Forced: ``grid`` > 0 gives the grid variant of that many CTAs (its
    co-residency is checked on the device before the launch), ``cluster``
    > 0 the cluster variant of that many, refused (``ValueError``) when it
    exceeds ``max_cluster`` or its CTA ``smem_optin`` (and checked on the
    device once more before the launch).  Otherwise the cluster variant
    with one CTA per block, at most ``max_cluster`` (the flagship's 17
    blocks: 16 CTAs, one of them with two blocks and two thread groups),
    when a CTA's state fits ``smem_optin``; else the grid variant, one CTA
    per block and at most one per SM."""
    if grid < 0 or cluster < 0:
        raise ValueError(f"grid {grid} and cluster {cluster} must be >= 0")
    if grid and cluster:
        raise ValueError("give grid or cluster, not both")
    b_cnt, pb = np.asarray(block_particles).shape
    if b_cnt < 1 or dim not in (2, 3):
        raise ValueError(f"no frame of {b_cnt} blocks in {dim}D")
    grid_bytes = _F32 * (dim * pb + (dim + 1) * dim * eb)
    if grid:
        return FramePlan("grid", grid, grid_bytes)

    def plan(c):
        asg = explicit_assignment(block_particles, slot_ptr, slot_rows, n, c)
        return FramePlan("cluster", c, explicit_cluster_smem(
            b_cnt, eb, pb, dim, c, *asg.sizes(), states),
            GROUP_THREADS * cluster_groups(b_cnt, c))

    if cluster:
        if cluster > b_cnt:
            raise ValueError(f"a cluster of {cluster} CTAs over {b_cnt} "
                             "blocks leaves a CTA without a block")
        forced = plan(cluster)
        if cluster > limits.max_cluster or forced.smem > limits.smem_optin:
            raise ValueError(
                f"a cluster of {cluster} CTAs does not fit the device: "
                f"{forced.smem} B of shared memory a CTA (at most "
                f"{limits.smem_optin}), at most {limits.max_cluster} CTAs")
        return forced
    auto = plan(min(b_cnt, limits.max_cluster))
    if auto.smem <= limits.smem_optin:
        return auto
    return FramePlan("grid", min(b_cnt, limits.sms), grid_bytes)


def explicit_frame_barriers(variant: str, inelastic: bool,
                            sim_count: int) -> int:
    """Barriers of one K8 frame of ``sim_count`` substeps, as
    csrc/explicit_frame.cu places them.  The grid variant: a grid barrier
    after each substep's partials and one after its kinematic step but the
    last (elastic; inelastic one after every kinematic step, before the
    state update) — 2 S − 1 or 2 S.  The cluster variant: one after the
    copy-in, one after each substep's gradient (the slot sums stored into
    their owners) and one after each kinematic step (the positions stored
    into their holders) but the last of an elastic frame — 2 S or 2 S + 1.
    The kernel counts the barriers it meets
    (``fused_explicit_frame.last_barriers``); the CUDA tests and
    ``chip_smoke.py`` hold that count to this one."""
    s = int(sim_count)
    if variant == "grid":
        return 2 * s - (0 if inelastic else 1)
    if variant == "cluster":
        return 2 * s + (1 if inelastic else 0)
    raise ValueError(f"unknown variant {variant!r}")


@functools.lru_cache(maxsize=64)
def explicit_device_limits(device_index: int, dim: int, material_id: int = 0,
                           inelastic: bool = False) -> FrameLimits:
    """The :class:`FrameLimits` of CUDA device ``device_index`` for K8's
    cluster instance (``dim``, ``material_id``, elastic or inelastic)."""
    lib = _explicit_library(material_id)
    mc, optin, sms = _I(0), _I(0), _I(0)
    with torch.cuda.device(device_index):
        rc = lib.fem_explicit_frame_limits(dim, material_id, int(inelastic),
                                           ctypes.byref(mc),
                                           ctypes.byref(optin),
                                           ctypes.byref(sms))
    if rc != 0:
        raise RuntimeError(
            "explicit whole-frame kernel: reading the device's limits failed: "
            f"{lib.fem_explicit_frame_error(rc).decode()}")
    return FrameLimits(mc.value, optin.value, sms.value)


@functools.lru_cache(maxsize=256)
def _check_explicit(device_index: int, plan: FramePlan, num_blocks: int,
                    eb: int, pb: int, d: int, sizes, states: int, mid: int,
                    inelastic: bool) -> FramePlan:
    """Raise unless the device can run ``plan``; else return it (the grid
    variant's with the grid the device takes).  Once per plan and instance
    on a device: a plan that fits is remembered, one that does not raises
    again (the kernel's attributes, set here, stay set on the device)."""
    lib = _explicit_library(mid)
    if plan.variant == "grid":
        g, smem = _plan(lib, lib.fem_explicit_frame_plan,
                        lib.fem_explicit_frame_error,
                        "explicit whole-frame kernel", device_index,
                        num_blocks, eb, pb, plan.size, d, mid, inelastic)
        return FramePlan("grid", g, smem)
    groups = plan.threads // GROUP_THREADS
    want = lib.fem_explicit_frame_cluster_smem(num_blocks, eb, pb, *sizes,
                                               plan.size, d, groups, states)
    if want != plan.smem:
        raise RuntimeError(f"explicit whole-frame kernel: the plan's "
                           f"{plan.smem} B of shared memory differ from the "
                           f"kernel's {want}")
    most = _I(0)
    with torch.cuda.device(device_index):
        rc = lib.fem_explicit_frame_cluster_fit(plan.size, plan.threads,
                                                plan.smem, d, mid,
                                                int(inelastic),
                                                ctypes.byref(most))
    if rc != 0:
        raise RuntimeError(
            "explicit whole-frame kernel: "
            f"{lib.fem_explicit_frame_error(rc).decode()} (one cluster of "
            f"{plan.size} CTAs of {plan.threads} threads, {plan.smem} B of "
            f"shared memory each; {most.value} such clusters fit at once)")
    return plan


def _blocking_versions(blk: Blocking, mass) -> tuple:
    """The version counters of every tensor of ``blk`` and ``mass`` that K8
    reads: an in-place change to one of them invalidates a binding."""
    return (blk.block_particles._version, blk.plus._version,
            blk.minus._version, blk.ref_inv._version, blk.volume._version,
            blk.element_perm._version, blk.block_elements._version,
            blk.local_ptr._version, blk.local_rows._version,
            blk.slot_plan.ptr._version, blk.slot_plan.rows._version,
            mass._version)


class ExplicitFrameBinding:
    """K8's launch for one (blocking, mass, frame constants), built once:
    on a CUDA device the plan (:func:`explicit_frame_plan`), its device
    checks and assignment tables, the library, the checked operands, the
    material's parameters, gravity, the decay, the grid variant's partials
    and a prebuilt :class:`ExplicitFrameArgsC`; each call then checks and
    patches only the frame's inputs (pos, vel, the obstacles, the internal
    state), allocates fresh outputs and launches.  On the CPU a call runs
    :func:`fused_explicit_frame_plain`.  ``matches`` tells whether the
    binding still holds for a blocking and a mass: the same tensors,
    unchanged since (their version counters); ``ExplicitFrameBinding.builds``
    counts the bindings built."""

    builds = 0

    def __init__(self, blk: Blocking, mass: torch.Tensor, *, dt, damping,
                 g_dir, mu, s_lambda, sim_count, material="neo_hookean",
                 plastic_yield=0.0, viscous_mu=0.0, viscous_tau=0.1, grid=0,
                 cluster=0):
        ExplicitFrameBinding.builds += 1
        self.blk, self.mass = blk, mass
        self.versions = _blocking_versions(blk, mass)
        self.plastic, self.viscous = plastic_yield > 0.0, viscous_mu > 0.0
        self.kw = dict(dt=dt, damping=damping, g_dir=g_dir, mu=mu,
                       s_lambda=s_lambda, sim_count=sim_count,
                       material=material, plastic_yield=plastic_yield,
                       viscous_mu=viscous_mu, viscous_tau=viscous_tau)
        self.dev = mass.device
        if self.dev.type == "cpu":
            return
        if self.dev.type != "cuda":
            raise ValueError(f"unsupported device {self.dev}")
        if sim_count < 1:
            raise ValueError(f"sim_count must be at least 1 (got {sim_count})")
        on = self.plastic or self.viscous
        mid = kernel_material_id(material)
        tables = block_tables(blk)
        dev = self.dev
        n, d = mass.shape[0], tables.dim
        self.n, self.d = n, d
        cuda_build.check_operand("mass", mass, (n,), torch.float32,
                                 blk.volume.device)
        check_slot_plan(blk, n, dev)
        index = dev.index if dev.index is not None else (
            torch.cuda.current_device())
        self.index = index
        states = int(self.plastic) + int(self.viscous)
        if on:
            cuda_build.check_operand(
                "blocking.element_perm", blk.element_perm,
                (blk.num_blocks * blk.eb,), torch.int32, dev)
        host = (blk.block_particles.cpu().numpy(),
                blk.slot_plan.ptr.cpu().numpy(),
                blk.slot_plan.rows.cpu().numpy())
        limits = (explicit_device_limits(index, d, mid, on)
                  if not grid else FrameLimits(0, 0, 0))
        plan = explicit_frame_plan(*host, n, blk.eb, d, limits, states,
                                   int(grid), int(cluster))
        lib = _explicit_library(mid)
        self.lib = lib
        self.e = blk.element_slot.shape[0]
        if plan.variant == "cluster":
            asg = explicit_assignment(*host, n, plan.size)
            sizes = asg.sizes()
            self.tables = tuple(torch.as_tensor(t, device=dev) for t in asg)
            cl_fields = [t.data_ptr() for t in self.tables] + list(sizes)
            self.partials = None
        else:
            sizes = (0, 0, 0)
            self.tables = ()
            cl_fields = [None] * len(ExplicitAssignment._fields) + [0, 0, 0]
            self.partials = torch.empty((blk.num_blocks * blk.pb, d),
                                        dtype=torch.float32, device=dev)
        self.plan = _check_explicit(index, plan, blk.num_blocks, blk.eb,
                                    blk.pb, d, sizes, states, mid, on)
        self.barriers = _barrier_count(dev)
        self.instance = (d, mid, on)
        relax = relax_decay(dt, viscous_tau) if self.viscous else 0.0
        self.args = ExplicitFrameArgsC(
            tables, blk.slot_plan.ptr.data_ptr(), blk.slot_plan.rows.data_ptr(),
            None, None, mass.data_ptr(), None, None, n, 0, int(sim_count),
            mid, dt, damping_decay(dt, damping), *_gravity3(g_dir, d),
            material_params(material, mu, s_lambda, d), None, None,
            None if self.partials is None else self.partials.data_ptr(),
            blk.element_perm.data_ptr() if on else None, None, None, None,
            None, plastic_yield if self.plastic else 0.0,
            viscous_mu if self.viscous else 0.0, relax, *cl_fields,
            self.barriers.data_ptr())
        self.args_ref = ctypes.byref(self.args)
        if self.plan.variant == "cluster":
            launch = lib.fem_explicit_frame_cluster
            size, threads, smem = self.plan.size, self.plan.threads, \
                self.plan.smem
            self._launch = lambda stream: launch(self.args_ref, size, threads,
                                                 smem, stream)
        else:
            launch = lib.fem_explicit_frame
            size, smem = self.plan.size, self.plan.smem
            self._launch = lambda stream: launch(self.args_ref, size, smem,
                                                 stream)

    def matches(self, blk: Blocking, mass: torch.Tensor) -> bool:
        return (blk is self.blk and mass is self.mass
                and _blocking_versions(blk, mass) == self.versions)

    def __call__(self, pos, vel, centers, radii, plastic_inv=None,
                 viscous_inv=None):
        """(pos', vel') (N, d), then plastic_inv' and viscous_inv' (E, d, d)
        for the branches that are on: :func:`fused_explicit_frame`."""
        if self.dev.type == "cpu":
            return fused_explicit_frame_plain(
                self.blk, pos, vel, self.mass, centers, radii,
                plastic_inv=plastic_inv, viscous_inv=viscous_inv, **self.kw)
        for on, fi, name in ((self.plastic, plastic_inv, "plastic_inv"),
                             (self.viscous, viscous_inv, "viscous_inv")):
            if on != (fi is not None):
                raise ValueError(
                    f"{name} must be given exactly when its branch is on")
        n, d, dev, f32 = self.n, self.d, self.dev, torch.float32
        o = radii.shape[0]
        check = cuda_build.check_operand
        check("pos", pos, (n, d), f32, dev)
        check("vel", vel, (n, d), f32, dev)
        check("centers", centers, (o, d), f32, dev)
        check("radii", radii, (o,), f32, dev)
        a = self.args
        out = (torch.empty((n, d), dtype=f32, device=dev),
               torch.empty((n, d), dtype=f32, device=dev))
        a.pos_in, a.vel_in = pos.data_ptr(), vel.data_ptr()
        a.centers, a.radii, a.n_obst = centers.data_ptr(), radii.data_ptr(), o
        a.pos, a.vel = out[0].data_ptr(), out[1].data_ptr()
        state = ()
        if self.plastic or self.viscous:
            ins = []
            for on, fi, name in ((self.plastic, plastic_inv, "plastic_inv"),
                                 (self.viscous, viscous_inv, "viscous_inv")):
                if on:
                    check(name, fi, (self.e, d, d), f32, dev)
                    fo = torch.empty_like(fi)
                    state += (fo,)
                    ins.append((fi.data_ptr(), fo.data_ptr()))
                else:
                    ins.append((None, None))
            a.plastic_in, a.plastic = ins[0]
            a.viscous_in, a.viscous = ins[1]
        rc = cuda_build.launch_on_stream(dev, self.index, self._launch)
        if rc != 0:
            msg = self.lib.fem_explicit_frame_error(rc).decode()
            raise RuntimeError(
                f"explicit whole-frame kernel launch failed "
                f"({self.plan.variant} variant, {self.plan.size} CTAs): {msg}")
        fn = fused_explicit_frame
        count_launch(fn, *self.instance)
        fn.last_plan = self.plan
        fn.last_barriers = self.barriers
        key = (self.plan.variant, self.plan.size)
        fn.variant_launches[key] = fn.variant_launches.get(key, 0) + 1
        return out + state


# (id(blocking), id(mass), the frame constants) → the ExplicitFrameBinding
# built for them, which holds the blocking and the mass so that their ids
# are not reused while it is kept.
_BINDINGS: dict = {}


def explicit_frame_binding(blk: Blocking, mass: torch.Tensor, *, dt, damping,
                           g_dir, mu, s_lambda, sim_count,
                           material="neo_hookean", plastic_yield=0.0,
                           viscous_mu=0.0, viscous_tau=0.1, grid=0,
                           cluster=0) -> ExplicitFrameBinding:
    """The :class:`ExplicitFrameBinding` of ``blk``, ``mass`` and the frame
    constants (the keyword arguments of :func:`fused_explicit_frame` but
    the internal state), built once and built again when the blocking or
    the mass is replaced or changed in place."""
    g_dir = tuple(g_dir)
    key = (id(blk), id(mass), dt, damping, g_dir, mu, s_lambda, sim_count,
           material, plastic_yield, viscous_mu, viscous_tau, grid, cluster)
    hit = _BINDINGS.get(key)
    if hit is None or not hit.matches(blk, mass):
        hit = ExplicitFrameBinding(
            blk, mass, dt=dt, damping=damping, g_dir=g_dir, mu=mu,
            s_lambda=s_lambda, sim_count=sim_count, material=material,
            plastic_yield=plastic_yield, viscous_mu=viscous_mu,
            viscous_tau=viscous_tau, grid=grid, cluster=cluster)
        if key not in _BINDINGS and len(_BINDINGS) >= 32:
            _BINDINGS.pop(next(iter(_BINDINGS)))
        _BINDINGS[key] = hit
    return hit


def fused_explicit_frame(
    blk: Blocking,
    pos: torch.Tensor,
    vel: torch.Tensor,
    mass: torch.Tensor,
    centers: torch.Tensor,
    radii: torch.Tensor,
    *,
    dt: float,
    damping: float,
    g_dir: Tuple[float, ...],
    mu: float,
    s_lambda: float,
    sim_count: int,
    grid: int = 0,
    cluster: int = 0,
    material: str = "neo_hookean",
    plastic_inv=None,
    plastic_yield: float = 0.0,
    viscous_inv=None,
    viscous_mu: float = 0.0,
    viscous_tau: float = 0.1,
):
    """One rendered frame of ``sim_count`` explicit substeps: returns
    (pos', vel') (N, d), then plastic_inv' and viscous_inv' (E, d, d) for
    the branches that are on — the contract of the JAX package's
    ``fused_explicit_frame``.  Every output is a fresh tensor.

    CUDA tensors: one launch of the explicit whole-frame kernel's instance
    of ``material``, with its plastic and Maxwell branches when they are
    on, 2D or 3D, with no host synchronisation after the first call on a
    blocking (which plans on the host).  The variant is
    :func:`explicit_frame_plan`'s; ``cluster`` forces the cluster variant
    with that many CTAs, ``grid`` the cooperative grid variant with that
    many (tests and ``chip_smoke.py``; a plan the device cannot run
    raises).  What is fixed per (blocking, mass, constants) is bound once
    (:func:`explicit_frame_binding`).  The launch's plan is left in
    ``fused_explicit_frame.last_plan`` and counted by (variant, size) in
    ``variant_launches``; the barriers its kernel met in
    ``fused_explicit_frame.last_barriers``, a (1,) int32 tensor on the
    device that the next whole-frame launch there overwrites
    (:func:`explicit_frame_barriers` says what it must hold).  CPU tensors:
    :func:`fused_explicit_frame_plain`."""
    if pos.device.type == "cpu":
        return fused_explicit_frame_plain(
            blk, pos, vel, mass, centers, radii, dt=dt, damping=damping,
            g_dir=g_dir, mu=mu, s_lambda=s_lambda, sim_count=sim_count,
            material=material, plastic_inv=plastic_inv,
            plastic_yield=plastic_yield, viscous_inv=viscous_inv,
            viscous_mu=viscous_mu, viscous_tau=viscous_tau,
        )
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    binding = explicit_frame_binding(
        blk, mass, dt=dt, damping=damping, g_dir=g_dir, mu=mu,
        s_lambda=s_lambda, sim_count=sim_count, material=material,
        plastic_yield=plastic_yield, viscous_mu=viscous_mu,
        viscous_tau=viscous_tau, grid=grid, cluster=cluster)
    return binding(pos, vel, centers, radii, plastic_inv, viscous_inv)


fused_explicit_frame.launches = 0
fused_explicit_frame.instance_launches = {}
fused_explicit_frame.variant_launches = {}
fused_explicit_frame.last_plan = None
fused_explicit_frame.last_barriers = None
