# coding=utf-8
"""K11b, the whole frame over the unblocked mesh (``frame_backend="fused"``).

``fused_frame`` launches the hand-written CUDA kernel
``fem_tpu_torch/csrc/fused_frame.cu`` for tensors on a CUDA device; it
replaces the JAX package's Pallas kernel
``experiments/pallas_frame.py:_frame_kernel`` (entries ``fused_frame`` and
``make_fused_frame_fn``), 2D or 3D.  Its two variants:
:func:`fused_frame_plan` chooses, from the mesh and the device's limits,
the **cluster** variant (one thread-block cluster, each CTA a contiguous
range of elements with the frame's state in shared memory, element rows
and per-particle sums stored into the CTAs that read them through
distributed shared memory: every frame whose state fits one cluster) or
else the **single** variant (one CTA of 1,024 threads, the state in
device memory: any mesh); ``cluster=`` or ``single=True`` force one.  A
plan the device cannot run raises; nothing retries as the other variant
or the plain version.  For tensors on the CPU it runs
``fused_frame_plain``: per substep the plain element chain
(``element_kernels.hessian_and_force_plain``), the plain whole solve
(``cg_kernels.fused_cg_solve_plain``) and the plain fused advection
(``advect_kernels.advect_implicit_plain``, the Pallas form with
1/max(|disp|², 1e-30) multiplied).  On CUDA it launches the kernel or
raises; it never falls back.

Semantics (the JAX kernel's), per substep: K and the force columns of the
non-robust Neo-Hookean chain at pos; b = vel + dt·f/m with no gravity
(gravity lives in ``vel_g``); the reference CG (x₀ = b, normal equations
when ``preconditioned``); vel ← x; then the implicit advection: decay
exp(−dt·damping) in f32, vel_g ← (vel_g + 9.8·g·dt)·decay, the lower wall
zeroes vel, vel_g and v_tot, the upper wall vel and v_tot but not vel_g,
the circles in order (radius 0 skipped), pos += v_tot·dt.  The frame
returns each substep's iterations and final ‖r‖².
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from fem_tpu_torch.ops.advect_kernels import advect_implicit_plain
from fem_tpu_torch.ops.assembly import GatherPlan
from fem_tpu_torch.ops.cg_kernels import fused_cg_solve_plain
from fem_tpu_torch.ops.element_kernels import (
    hessian_and_force_plain,
    material_params,
)
from fem_tpu_torch.ops.frame_kernels import FrameLimits
from fem_tpu_torch.solvers.advect import damping_decay, gravity_vector
from fem_tpu_torch.utils import cuda_build
from fem_tpu_torch.utils.config import CONJUGATE_GRADIENT_METHOD

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# The JAX kernel writes each substep's iterations into one (1, 128) row.
MAX_SIM_COUNT = 128


class FusedFrameArgsC(ctypes.Structure):
    """Mirror of ``FemFusedFrameArgs`` (csrc/fused_frame.cu)."""

    _fields_ = [
        ("pos_in", _P), ("vel_in", _P), ("velg_in", _P), ("ref_inv", _P),
        ("volume", _P), ("elem", _P), ("ptr", _P), ("rows", _P),
        ("mass", _P), ("centers", _P), ("radii", _P), ("gravity", _P),
        ("n", _I), ("e", _I), ("n_obst", _I), ("sim_count", _I),
        ("max_iter", _I), ("normal", _I), ("dim", _I),
        ("dt", _F), ("dt2", _F), ("decay", _F), ("mu", _F), ("lam", _F),
        ("half_lam", _F), ("tol", _F),
        ("pos", _P), ("vel", _P), ("velg", _P), ("scratch", _P),
        ("iters", _P), ("res", _P),
        ("cl_elem_ptr", _P), ("cl_local_ptr", _P), ("cl_local_ids", _P),
        ("cl_owned_ptr", _P), ("cl_elem_local", _P), ("cl_row_dest", _P),
        ("cl_recv_ptr", _P), ("cl_push_ptr", _P), ("cl_push_codes", _P),
        ("cl_cap", _I), ("cl_elements", _I), ("cl_entries", _I),
        ("cl_pushes", _I), ("barriers", _P),
    ]


# The elements a cluster CTA (256 threads, csrc/fused_frame.cu:
# kClusterThreads) is planned for.
ELEMENTS_PER_CTA = 256
# Copies of a cluster CTA's receive slots (csrc/fused_frame.cu: kParts).
_PARTS = 2
# The most CTAs of a cluster (csrc/fused_frame.cu: kMaxRanks).
MAX_RANKS = 16
# Floats of one contribution row there: d padded to a 16- or 8-byte load.
_ROW_STRIDE = {2: 2, 3: 4}
_F32 = 4

# An H100 SXM (sm_90): clusters of up to 16 CTAs with the non-portable size
# allowed, 227 KB (232,448 B) of shared memory a CTA less the cluster
# kernel's static 144 B, 132 SMs.  The wrapper reads the device's own
# (device_limits); this is for planning without a card.
H100_LIMITS = FrameLimits(max_cluster=16, smem_optin=232304, sms=132)


class FusedPlan(NamedTuple):
    """K11b's launch: ``variant`` "cluster" (one cluster of ``size`` CTAs
    of 256 threads, ``smem`` bytes of dynamic shared memory each) or
    "single" (one CTA of 1,024 threads, its state in device memory)."""

    variant: str
    size: int
    smem: int


class FusedAssignment(NamedTuple):
    """Elements and particles of a cluster of ``C`` CTAs (numpy int32).

    Rank r owns the elements [elem_ptr[r], elem_ptr[r+1]) — contiguous, in
    the mesh's order, ⌊r·E/C⌋ on.  Its local particles are
    ``local_ids[local_ptr[r]:local_ptr[r+1]]``: first the ones it owns
    (ascending), then the others its elements touch (ascending).  A
    particle is owned by the rank of the element of its middle plan row
    (entry ⌊(count − 1)/2⌋, so that ownership spreads over the ranks); one
    in no element by rank (its index among those, mod C).  Owned particle
    i, flat over the ranks (rank r's are [owned_ptr[r], owned_ptr[r+1]),
    its first local ones), receives its plan rows, in the plan's order, in
    its rank's slots [recv_ptr[i], recv_ptr[i+1]) − recv_ptr[owned_ptr[r]];
    row (D+1)·e + j of the plan goes to ``row_dest[(D+1)·e + j]`` =
    owner rank·65536 + slot.  The other ranks that hold owned particle i,
    ascending, are ``push_codes[push_ptr[i]:push_ptr[i+1]]``, each as
    rank·65536 + its local index there.  ``elem_local[(D+1)·e + j]`` is
    the local index, in e's rank, of vertex j."""

    elem_ptr: np.ndarray
    local_ptr: np.ndarray
    local_ids: np.ndarray
    owned_ptr: np.ndarray
    elem_local: np.ndarray
    row_dest: np.ndarray
    recv_ptr: np.ndarray
    push_ptr: np.ndarray
    push_codes: np.ndarray

    def sizes(self):
        """(most elements, most local particles, most receive slots, most
        push codes) of a rank's: what a CTA's shared memory must hold."""
        return (int(np.diff(self.elem_ptr).max()),
                int(np.diff(self.local_ptr).max()),
                int(np.diff(self.recv_ptr[self.owned_ptr]).max()),
                int(np.diff(self.push_ptr[self.owned_ptr]).max()))


def cluster_assignment(element_indices, ptr, rows, n: int,
                       cluster: int) -> FusedAssignment:
    """The assignment of a mesh's elements and particles to ``cluster``
    ranks (host, numpy): ``element_indices`` (E, D+1) and the CSR plan
    (``ptr`` (N+1,), ``rows`` ((D+1)·E,), row (D+1)·e + j for vertex j of
    element e) of :class:`~fem_tpu_torch.ops.assembly.GatherPlan`."""
    elem = np.asarray(element_indices, np.int64)
    ptr = np.asarray(ptr, np.int64)
    rows = np.asarray(rows, np.int64)
    e_cnt, v = elem.shape
    if cluster < 1 or cluster > max(e_cnt, 1):
        raise ValueError(f"no cluster of {cluster} CTAs over {e_cnt} "
                         "elements")
    elem_ptr = np.arange(cluster + 1) * e_cnt // cluster
    rank_of = np.repeat(np.arange(cluster), np.diff(elem_ptr))
    counts = np.diff(ptr)
    owner = np.empty(n, np.int64)
    has = counts > 0
    owner[has] = rank_of[rows[ptr[:-1][has] + (counts[has] - 1) // 2] // v]
    free = np.nonzero(~has)[0]
    owner[free] = np.arange(free.size) % cluster
    local_ptr, local_ids, owned = [0], [], []
    elem_local = np.zeros_like(elem)
    lookup = np.full((cluster, n), -1, np.int64)
    for r in range(cluster):
        lo, hi = elem_ptr[r], elem_ptr[r + 1]
        mine = np.nonzero(owner == r)[0]
        local = np.concatenate([mine, np.setdiff1d(np.unique(elem[lo:hi]),
                                                   mine)])
        lookup[r, local] = np.arange(local.size)
        elem_local[lo:hi] = lookup[r, elem[lo:hi]]
        local_ids.append(local)
        owned.append(mine)
        local_ptr.append(local_ptr[-1] + local.size)
    if int(np.diff(local_ptr).max()) > 65536:
        raise ValueError("a rank's particles exceed the 16-bit local index")
    own = np.concatenate(owned)
    owned_ptr = np.concatenate([[0], np.cumsum([m.size for m in owned])])
    cnt = counts[own]
    recv_ptr = np.concatenate([[0], np.cumsum(cnt)])
    # Slot k of owned particle i takes plan entry ptr[own[i]] + k.
    within = np.arange(recv_ptr[-1]) - np.repeat(recv_ptr[:-1], cnt)
    row = rows[np.repeat(ptr[own], cnt) + within]
    rank = np.repeat(np.repeat(np.arange(cluster), np.diff(owned_ptr)), cnt)
    slot = np.arange(recv_ptr[-1]) - recv_ptr[owned_ptr[rank]]
    if slot.size and int(slot.max()) >= 65536:
        raise ValueError("a rank's receive slots exceed the 16-bit index")
    row_dest = np.zeros(v * e_cnt, np.int64)
    row_dest[row] = rank * 65536 + slot
    # The holders of each owned particle but its owner, ascending by rank.
    held = lookup[:, own] >= 0
    held[owner[own], np.arange(own.size)] = False
    hr, hi = np.nonzero(held.T)  # (owned index, rank), by owned index
    push_ptr = np.concatenate([[0], np.cumsum(held.sum(axis=0))])
    push_codes = hi * 65536 + lookup[hi, own[hr]]
    i32 = functools.partial(np.asarray, dtype=np.int32)
    return FusedAssignment(
        elem_ptr=i32(elem_ptr), local_ptr=i32(local_ptr),
        local_ids=i32(np.concatenate(local_ids)), owned_ptr=i32(owned_ptr),
        elem_local=i32(elem_local.reshape(-1)), row_dest=i32(row_dest),
        recv_ptr=i32(recv_ptr), push_ptr=i32(push_ptr),
        push_codes=i32(push_codes))


def cluster_smem(elements: int, cap: int, entries: int, pushes: int,
                 dim: int, vectors: int = 7) -> int:
    """Bytes of dynamic shared memory of a cluster CTA holding ``elements``
    elements and ``cap`` local particles, whose owned particles have
    ``entries`` plan rows and ``pushes`` other holders: two copies of the
    receive slots (rows padded to 4 floats in 3D), two receive buffers of
    per-particle sums (padded rows), the elements' K, ``vectors`` local
    vectors of d floats (K11b's seven: pos, vel, vel_g, x, r, d, q; K4's
    five) and 1/m, the ranks' dot partials (two copies of 16), the
    elements' local vertex ids and row destinations, the local particles'
    ids, the owned particles' spans of slots and push codes, and the push
    codes (csrc/cluster_cg.cuh: smem_words)."""
    rs = _ROW_STRIDE[dim]
    return _F32 * (_PARTS * rs * entries + 2 * rs * cap
                   + dim * dim * elements + cap * (vectors * dim + 1)
                   + 2 * MAX_RANKS + 2 * (dim + 1) * elements + cap
                   + 2 * (cap + 1) + pushes)


def fused_frame_plan(element_indices, ptr, rows, n: int, dim: int,
                     limits: FrameLimits, cluster: int = 0,
                     single: bool = False, vectors: int = 7) -> FusedPlan:
    """K11b's variant, its CTAs and their shared memory, from the mesh (the
    host arrays of :func:`cluster_assignment`) and the device's
    ``limits``; with ``vectors`` 5 K4's (ops/cg_kernels.fused_cg_solve),
    whose CTA holds two local vectors fewer (:func:`cluster_smem`).

    Forced: ``single`` gives the single variant, ``cluster`` > 0 the
    cluster variant of that many CTAs, refused (``ValueError``) when its CTA
    exceeds ``smem_optin`` or it exceeds ``max_cluster`` (and checked on
    the device once more before the launch).
    Otherwise the cluster variant with one CTA per ``ELEMENTS_PER_CTA``
    elements, at least 1 and at most ``max_cluster`` (the flagship's 4,068
    tets: 16 CTAs; ``default.json``'s 200 triangles: 1), or more CTAs up
    to ``max_cluster`` until a CTA's state fits ``smem_optin``; else the
    single variant.  Under the H100's 227 KB a CTA (:func:`cluster_smem`
    grows about linearly with the mesh), 16 CTAs take meshes up to about
    2.4 times the flagship's — some 10,000 tets and 2,500 particles of its
    locality — in 3D, and a 110-subdivision square grid (24,200 triangles,
    12,321 particles) in 2D; beyond that the single variant runs."""
    if cluster < 0:
        raise ValueError(f"cluster {cluster} must be >= 0")
    if cluster and single:
        raise ValueError("give cluster or single, not both")
    if dim not in (2, 3):
        raise ValueError(f"no frame in {dim}D")
    e_cnt = len(element_indices)
    if single:
        return FusedPlan("single", 1, 0)

    def plan(c):
        asg = cluster_assignment(element_indices, ptr, rows, n, c)
        return FusedPlan("cluster", c, cluster_smem(*asg.sizes(), dim,
                                                    vectors))

    if cluster:
        forced = plan(cluster)
        if cluster > limits.max_cluster or forced.smem > limits.smem_optin:
            raise ValueError(
                f"a cluster of {cluster} CTAs does not fit the device: "
                f"{forced.smem} B of shared memory a CTA (at most "
                f"{limits.smem_optin}), at most {limits.max_cluster} CTAs")
        return forced
    first = min(limits.max_cluster,
                max(1, -(-e_cnt // ELEMENTS_PER_CTA)))
    for c in range(first, min(limits.max_cluster, e_cnt) + 1):
        p = plan(c)
        if p.smem <= limits.smem_optin:
            return p
    return FusedPlan("single", 1, 0)


def frame_barriers(variant: str, normal: bool, iterations) -> int:
    """Barriers of one K11b frame whose substeps took ``iterations``: per
    substep and per CG iteration, as csrc/fused_frame.cu places them, plus
    two a frame in the cluster variant (after the copy-in, so that no CTA
    stores into one that has not started, and before exit, so that none
    leaves while another may store into it) and one in the single variant
    (after the copy-in).  The cluster variant's phases: an operator apply
    is a barrier after the products (rows sent to their owners) and one
    after the owners' sums pushed to the holders (which also carries a dot
    product's partials where one follows), a further dot one barrier —
    normal equations 6 a substep and 5 an iteration, plain 4 and 3; the
    single variant's are its every ``__syncthreads``.  The kernel counts
    the barriers it meets (``fused_frame.last_barriers``); the CUDA tests
    and ``chip_smoke.py`` hold that count to this one."""
    per_step, per_it = {("cluster", True): (6, 5), ("cluster", False): (4, 3),
                        ("single", True): (16, 12),
                        ("single", False): (10, 9)}[(variant, bool(normal))]
    return sum(per_step + per_it * int(it) for it in iterations) + (
        2 if variant == "cluster" else 1)


def supports_fused_frame(obj, cfg) -> bool:
    """Eligibility for K11b: every semantic gate of the JAX package's
    ``supports_fused_frame`` — the implicit CG, the reference Hessian,
    Neo-Hookean, not robust, elastic, no pins, β = 0, sphere obstacles
    only, ``sim_count`` ≤ 128 — and what the kernel also leaves out, which
    the JAX kernel would skip without a word: loads, friction, any CG but
    the reference one, and the time-stepping extensions.  Its VMEM gates
    (the one-hot mask set and the element planes within Mosaic's scoped
    VMEM) are Mosaic's: a mesh too large for one cluster's shared memory
    runs the single variant, whose O(E + N) scratch is device memory, so
    the card takes any mesh size, and a large mesh only costs time."""
    return (
        obj.dim in (2, 3)
        and not cfg.auto_diff
        and not cfg.use_explicit_method
        and cfg.implicit_method == CONJUGATE_GRADIENT_METHOD
        and not cfg.robust_inversion
        and cfg.hessian == "reference"
        and cfg.cg_precond == "reference"
        and obj.material == "neo_hookean"
        and all(o.material == "neo_hookean" for o in cfg.objects)
        and obj.plastic_yield == 0.0
        and obj.viscous_mu == 0.0
        and obj.free_mask is None
        and obj.static_load is None
        and obj.damping_beta == 0.0
        and all(o.type == "sphere" and o.friction == 0.0
                for o in cfg.obstacles)
        and cfg.wall_friction == 0.0
        and cfg.sim_count <= MAX_SIM_COUNT
        and not cfg.adaptive_dt
        and cfg.integrator == "semi_implicit"
        and cfg.contact == "none"
    )


def fused_frame_plain(
    pos, vel, vel_g, ref_inv, volume, element_indices, plan: GatherPlan,
    mass, centers, radii, *, dt, damping, g_dir, mu, s_lambda,
    preconditioned, sim_count, max_iter=500, tol=1e-5,
):
    """Plain PyTorch version of :func:`fused_frame`."""
    decay = damping_decay(dt, damping, pos.dtype)
    gravity = gravity_vector(tuple(g_dir), pos.device)
    iters, res = [], []
    for _ in range(sim_count):
        K, cols = hessian_and_force_plain(pos, element_indices, ref_inv,
                                          volume, mu, s_lambda)
        x, it, r = fused_cg_solve_plain(K, cols, element_indices, plan, vel,
                                        mass, dt, preconditioned, max_iter,
                                        tol)
        pos, vel, vel_g = advect_implicit_plain(
            pos, x, vel_g, centers, radii, dt=dt, decay=decay,
            gravity=gravity)
        iters.append(it)
        res.append(r)
    return pos, vel, vel_g, torch.stack(iters), torch.stack(res)


def _library():
    lib = cuda_build.load("fused_frame")
    if lib.fem_fused_frame.argtypes is None:
        out = ctypes.POINTER(_I)
        lib.fem_fused_frame_scratch_floats.argtypes = [_I, _I, _I]
        lib.fem_fused_frame_scratch_floats.restype = ctypes.c_longlong
        lib.fem_fused_frame.argtypes = [ctypes.POINTER(FusedFrameArgsC), _P]
        lib.fem_fused_frame.restype = _I
        lib.fem_fused_frame_limits.argtypes = [_I, out, out, out]
        lib.fem_fused_frame_limits.restype = _I
        lib.fem_fused_frame_cluster_smem.argtypes = [_I] * 5
        lib.fem_fused_frame_cluster_smem.restype = ctypes.c_longlong
        lib.fem_fused_frame_cluster_fit.argtypes = [_I, _I, _I, out]
        lib.fem_fused_frame_cluster_fit.restype = _I
        lib.fem_fused_frame_cluster.argtypes = [
            ctypes.POINTER(FusedFrameArgsC), _I, _I, _P]
        lib.fem_fused_frame_cluster.restype = _I
        lib.fem_fused_frame_error.argtypes = [_I]
        lib.fem_fused_frame_error.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=16)
def device_limits(device_index: int, dim: int) -> FrameLimits:
    """The :class:`FrameLimits` of CUDA device ``device_index`` for the
    cluster variant's instance of ``dim``."""
    lib = _library()
    mc, optin, sms = _I(0), _I(0), _I(0)
    with torch.cuda.device(device_index):
        rc = lib.fem_fused_frame_limits(dim, ctypes.byref(mc),
                                        ctypes.byref(optin),
                                        ctypes.byref(sms))
    if rc != 0:
        raise RuntimeError("unblocked whole-frame kernel: reading the "
                           "device's limits failed: "
                           f"{lib.fem_fused_frame_error(rc).decode()}")
    return FrameLimits(mc.value, optin.value, sms.value)


@functools.lru_cache(maxsize=64)
def _check_cluster(device_index: int, plan: FusedPlan, sizes, dim: int):
    """Raise unless the device can run ``plan`` (cluster variant) for a
    rank of ``sizes`` (elements, local particles, receive slots, push
    codes).  Once per plan on a device: a plan that fits is remembered,
    one that does not raises again."""
    lib = _library()
    want = lib.fem_fused_frame_cluster_smem(*sizes, dim)
    if want != plan.smem:
        raise RuntimeError(f"unblocked whole-frame kernel: the plan's "
                           f"{plan.smem} B of shared memory differ from the "
                           f"kernel's {want}")
    most = _I(0)
    with torch.cuda.device(device_index):
        rc = lib.fem_fused_frame_cluster_fit(plan.size, plan.smem, dim,
                                             ctypes.byref(most))
    if rc != 0:
        raise RuntimeError(
            "unblocked whole-frame kernel: "
            f"{lib.fem_fused_frame_error(rc).decode()} (one cluster of "
            f"{plan.size} CTAs, {plan.smem} B of "
            f"shared memory each; {most.value} such clusters fit at once)")


# (id(element_indices), id(plan)) → (the two, their version counters,
# {(limits, cluster, single, vectors): (plan, its assignment's sizes and
# device tensors)}); the tensors are held so that their ids are not reused,
# and a change in place (a new version) plans again.
_PLANS: dict = {}


def _planned(element_indices, plan, n, dim, limits, cluster, single,
             vectors=7):
    key = (id(element_indices), id(plan))
    versions = (element_indices._version, plan.ptr._version,
                plan.rows._version)
    hit = _PLANS.get(key)
    if (hit is None or hit[0] is not element_indices or hit[1] is not plan
            or hit[2] != versions):
        if key not in _PLANS and len(_PLANS) >= 32:
            _PLANS.pop(next(iter(_PLANS)))
        hit = _PLANS[key] = (element_indices, plan, versions, {})
    by_launch = hit[3]
    opts = (limits, cluster, single, vectors)
    if opts not in by_launch:
        host = (element_indices.cpu().numpy(), plan.ptr.cpu().numpy(),
                plan.rows.cpu().numpy())
        fplan = fused_frame_plan(*host, n, dim, limits, cluster, single,
                                 vectors)
        tables = None
        if fplan.variant == "cluster":
            asg = cluster_assignment(*host, n, fplan.size)
            tables = (asg.sizes(), tuple(
                torch.as_tensor(t, device=element_indices.device)
                for t in asg))
        by_launch[opts] = (fplan, tables)
    return by_launch[opts]


# Device → the (1,) int32 tensor K11b's launches there write their barrier
# count to.
_BARRIERS: dict = {}


def fused_frame(
    pos: torch.Tensor,
    vel: torch.Tensor,
    vel_g: torch.Tensor,
    ref_inv: torch.Tensor,
    volume: torch.Tensor,
    element_indices: torch.Tensor,
    plan: GatherPlan,
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
    cluster: int = 0,
    single: bool = False,
):
    """One rendered frame of ``sim_count`` implicit-CG substeps over the
    unblocked mesh: returns (pos', vel', vel_g' (N, d), iterations (S,)
    int32, ‖r‖² (S,) f32).  CUDA tensors: one launch of the whole-frame
    kernel, with no host synchronisation after the first call on a mesh
    (which plans on the host).  The variant is :func:`fused_frame_plan`'s;
    ``cluster`` forces the cluster variant with that many CTAs, ``single``
    the single variant (tests and ``chip_smoke.py``; a cluster the device
    cannot run raises).  The launch's plan is left in
    ``fused_frame.last_plan`` and counted by (variant, size) in
    ``variant_launches``; the barriers its kernel met in
    ``fused_frame.last_barriers``, a (1,) int32 tensor on the device that
    the next launch there overwrites (:func:`frame_barriers` says what it
    must hold).  CPU tensors: :func:`fused_frame_plain`."""
    kw = dict(dt=dt, damping=damping, g_dir=g_dir, mu=mu, s_lambda=s_lambda,
              preconditioned=preconditioned, sim_count=sim_count,
              max_iter=max_iter, tol=tol)
    if pos.device.type == "cpu":
        return fused_frame_plain(pos, vel, vel_g, ref_inv, volume,
                                 element_indices, plan, mass, centers, radii,
                                 **kw)
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    n, d = pos.shape
    if d not in (2, 3):
        raise ValueError(f"the whole-frame kernel takes dim 2 or 3, not {d}")
    if len(g_dir) != d:
        raise ValueError(f"g_dir has {len(g_dir)} components, expected {d}")
    e = element_indices.shape[0]
    o = radii.shape[0]
    dev, f32 = pos.device, torch.float32
    for name, t, shape, dtype in (
        ("pos", pos, (n, d), f32), ("vel", vel, (n, d), f32),
        ("vel_g", vel_g, (n, d), f32), ("ref_inv", ref_inv, (e, d, d), f32),
        ("volume", volume, (e,), f32),
        ("element_indices", element_indices, (e, d + 1), torch.int32),
        ("plan.ptr", plan.ptr, (n + 1,), torch.int32),
        ("plan.rows", plan.rows, ((d + 1) * e,), torch.int32),
        ("mass", mass, (n,), f32), ("centers", centers, (o, d), f32),
        ("radii", radii, (o,), f32),
    ):
        cuda_build.check_operand(name, t, shape, dtype, dev)
    if d == 3 and element_indices.data_ptr() % 16:
        raise ValueError("element_indices must be 16-byte aligned (int4 loads)")
    lib = _library()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    fplan, tables = _planned(element_indices, plan, n, d,
                             device_limits(index, d), int(cluster),
                             bool(single))
    if fplan.variant == "cluster":
        sizes, cl = tables
        _check_cluster(index, fplan, sizes, d)
        elements, cap, entries, pushes = sizes
        cl_fields = [t.data_ptr() for t in cl] + [cap, elements, entries,
                                                  pushes]
        scratch = None
    else:
        cl_fields = [None] * len(FusedAssignment._fields) + [0, 0, 0, 0]
        scratch = torch.empty(lib.fem_fused_frame_scratch_floats(d, e, n),
                              dtype=f32, device=dev)
    barriers = _BARRIERS.get(dev)
    if barriers is None:
        barriers = _BARRIERS[dev] = torch.zeros((1,), dtype=torch.int32,
                                                device=dev)
    gravity = gravity_vector(tuple(g_dir), dev)
    out = [torch.empty((n, d), dtype=f32, device=dev) for _ in range(3)]
    iters = torch.empty((sim_count,), dtype=torch.int32, device=dev)
    res = torch.empty((sim_count,), dtype=f32, device=dev)
    mat = material_params("neo_hookean", mu, s_lambda, d)
    args = FusedFrameArgsC(
        pos.data_ptr(), vel.data_ptr(), vel_g.data_ptr(), ref_inv.data_ptr(),
        volume.data_ptr(), element_indices.data_ptr(), plan.ptr.data_ptr(),
        plan.rows.data_ptr(), mass.data_ptr(), centers.data_ptr(),
        radii.data_ptr(), gravity.data_ptr(), n, e, o, int(sim_count),
        int(max_iter), int(bool(preconditioned)), d, dt, dt * dt,
        damping_decay(dt, damping), mat.mu, mat.lam, mat.half_lam, tol,
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        None if scratch is None else scratch.data_ptr(), iters.data_ptr(),
        res.data_ptr(), *cl_fields, barriers.data_ptr(),
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if fplan.variant == "cluster":
            rc = lib.fem_fused_frame_cluster(ctypes.byref(args), fplan.size,
                                             fplan.smem, stream)
        else:
            rc = lib.fem_fused_frame(ctypes.byref(args), stream)
    if rc != 0:
        msg = lib.fem_fused_frame_error(rc).decode()
        raise RuntimeError(f"unblocked whole-frame kernel launch failed "
                           f"({fplan.variant} variant, {fplan.size} CTAs): "
                           f"{msg}")
    fused_frame.launches += 1
    fused_frame.last_plan = fplan
    fused_frame.last_barriers = barriers
    key = (fplan.variant, fplan.size)
    fused_frame.variant_launches[key] = (
        fused_frame.variant_launches.get(key, 0) + 1)
    return out[0], out[1], out[2], iters, res


fused_frame.launches = 0
fused_frame.variant_launches = {}
fused_frame.last_plan = None
fused_frame.last_barriers = None


def make_fused_frame_fn(obj, cfg):
    """Frame function backed by K11b: ``frame(state, obstacles)`` →
    ``(state', StepAux)`` with per-substep iterations and final ‖r‖² of
    shape ``(sim_count,)`` left on the device, the contract of
    ``sim.make_frame_fn``.  The circles are read from the obstacles each
    frame, as device tensors."""
    from fem_tpu_torch.sim import StepAux

    kw = dict(dt=cfg.delta_time, damping=obj.damping, g_dir=tuple(cfg.g_dir),
              mu=obj.mu, s_lambda=obj.s_lambda,
              preconditioned=cfg.preconditioned == 1,
              sim_count=cfg.sim_count)

    def frame(state, obstacles):
        pos, vel, vel_g, iters, res = fused_frame(
            state.pos, state.vel, state.vel_g, obj.ref_inv, obj.volume,
            obj.element_indices, obj.plan, obj.mass, obstacles.centers,
            obstacles.radii, **kw)
        return state.replace(pos=pos, vel=vel, vel_g=vel_g), StepAux(
            iters, res)

    return frame
