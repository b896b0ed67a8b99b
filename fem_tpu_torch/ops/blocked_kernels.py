# coding=utf-8
"""K2, K7b, K3 and K7a: the blocked element prep, the blocked operator and
the blocked assembly.

``blocked_prep`` and ``blocked_grad_prep`` launch
``fem_tpu_torch/csrc/blocked.cu``'s prep kernels for tensors on a CUDA
device; they replace the JAX package's Pallas kernel
``ops/blocking.py:_prep_kernel`` in its implicit mode (entry
``blocked_prep``, K2) and its explicit mode (entry ``blocked_grad_prep``,
K7b).  ``blocked_graph_apply`` launches the same file's operator apply; it
replaces ``ops/blocking.py:_matvec_kernel`` (entry ``blocked_graph_apply``,
K3), in one of two variants that :func:`matvec_plan` chooses before the
launch: the **cluster** variant (one thread-block cluster on K8's
ownership, block slot sums stored into their particles' owners through
distributed shared memory: every blocking whose receive slots fit one
cluster) or the **grid** variant (two kernels: per-block partials through
device memory, then per-particle slot sums); ``cluster=`` or ``grid=True``
force one.  Both give bit-identical outputs.  What is fixed per blocking
(the tables, the plan, its assignment, the partials) is bound once
(:func:`matvec_binding`).  ``blocked_assemble`` launches its assembly
and slot-sum kernels; it replaces ``ops/blocking.py:_scatter_kernel``
(entry ``blocked_assemble``, K7a).  Each launches the instance of the
blocking's dimension (2 or 3; one kernel template, two instances).  For
tensors on the CPU each runs its plain PyTorch version (``*_plain``); on
CUDA each launches its kernel or raises.

``blocked_edges`` launches the same file's edges kernel; it replaces the
edges mode of ``ops/blocking.py:_prep_kernel`` (entry
``blocked_edge_planes``, K7b edges): the edge matrix of every element slot
in block order, for the inelastic update (``ops/inelastic.py``).

The preps take a material layer (ops/inelastic.py): an optional dynamic
rest-edge inverse per slot (``ref_inv``, (B·Eb, d, d); the blocking's own
when None) and the material, any of ``ops/element.py``'s (and for K2
``robust``).  The dynamic inverse is the same table pointer the kernel
reads anyway, the material a template parameter chosen at launch
(``kernel_material_id``, one library per material), and its numbers a
kernel argument, so the static Neo-Hookean launch runs the arithmetic it
always ran.  The preps count their launches in total and by (dimension,
material instance), as ``ops/element_kernels`` does.

Layouts: K blocks and element columns are ``(B·Eb, d, d)`` in block order
(the JAX package's ``kplane_to_kflat`` of its (B, d², Eb·d) planes);
per-slot partials are ``(B, Pb, d)`` (the JAX package's (B, d, Pb)
transposed).  Padded element slots give K = 0 and contribute nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from fem_tpu_torch.ops import smallmat as sm
from fem_tpu_torch.ops.assembly import element_contrib_full
from fem_tpu_torch.ops.blocking import (
    Blocking,
    blocked_gather,
    blocked_scatter_sum,
)
from fem_tpu_torch.ops.cg_kernels import (
    CGResult,
    cg_solve_dispatch,
    system_coeff,
)
from fem_tpu_torch.ops.element import (
    MATERIAL_IDS,
    grad_cols_chain,
    k_and_h_chain,
    kernel_material_id,
)
from fem_tpu_torch.ops.element_kernels import (
    MaterialParamsC,
    count_launch,
    material_params,
)
from fem_tpu_torch.utils import cuda_build

_P = ctypes.c_void_p
_I = ctypes.c_int


class BlockTablesC(ctypes.Structure):
    """Mirror of ``fem::BlockTables`` (csrc/blocked_common.cuh)."""

    _fields_ = [
        ("block_particles", _P),
        ("plus", _P),
        ("minus", _P),
        ("ref_inv", _P),
        ("volume", _P),
        ("block_elements", _P),
        ("local_ptr", _P),
        ("local_rows", _P),
        ("num_blocks", ctypes.c_int),
        ("eb", ctypes.c_int),
        ("pb", ctypes.c_int),
        ("dim", ctypes.c_int),
    ]


def block_tables(blk: Blocking, ref_inv=None) -> BlockTablesC:
    """The C view of ``blk``'s device tables (which ``blk`` keeps alive),
    with its dimension d (2 or 3); ``ref_inv`` (B·Eb, d, d), when given,
    stands in for the blocking's rest-edge inverses (the caller keeps it
    alive)."""
    d = blk.dim
    if d not in (2, 3):
        raise ValueError(f"the blocked kernels take dim 2 or 3, not {d}")
    dev = blk.volume.device
    b, eb, pb = blk.num_blocks, blk.eb, blk.pb
    i32, f32 = torch.int32, torch.float32
    for name, shape, dtype in (
        ("block_particles", (b, pb), i32), ("plus", (b, eb * d), i32),
        ("minus", (b, eb * d), i32), ("ref_inv", (b * eb, d, d), f32),
        ("volume", (b * eb,), f32), ("block_elements", (b,), i32),
        ("local_ptr", (b, pb + 1), i32),
        ("local_rows", (b, eb * (d + 1)), i32),
    ):
        cuda_build.check_operand(
            f"blocking.{name}", getattr(blk, name), shape, dtype, dev
        )
    if ref_inv is None:
        ref_inv = blk.ref_inv
    else:
        cuda_build.check_operand("ref_inv", ref_inv, (b * eb, d, d), f32, dev)
    return BlockTablesC(
        blk.block_particles.data_ptr(), blk.plus.data_ptr(),
        blk.minus.data_ptr(), ref_inv.data_ptr(), blk.volume.data_ptr(),
        blk.block_elements.data_ptr(), blk.local_ptr.data_ptr(),
        blk.local_rows.data_ptr(), b, eb, pb, d,
    )


def block_edge_matrices(blk: Blocking, xb: torch.Tensor) -> torch.Tensor:
    """(B·Eb, d, d) edge matrices (columns x_{v_{j+1}} − x_{v_0}) of every
    element slot from block-local rows ``xb`` (B, Pb, d); padded slots give
    0 (callers mask them)."""
    b, pb, d = xb.shape
    flat = xb.reshape(b * pb, d)
    off = (torch.arange(b, device=xb.device) * pb)[:, None]
    xp = flat[(blk.plus + off).reshape(-1)]
    xm = flat[(blk.minus + off).reshape(-1)]
    return (xp - xm).reshape(b * blk.eb, d, d).transpose(-1, -2)


def _real_slots(blk: Blocking) -> torch.Tensor:
    """(B·Eb, 1, 1) bool: element slots that hold a real element."""
    e = torch.arange(blk.eb, device=blk.volume.device)
    return (e[None, :] < blk.block_elements[:, None]).reshape(-1, 1, 1)


def _slot_partials(blk: Blocking, columns: torch.Tensor) -> torch.Tensor:
    """(B, Pb, d) per-slot sums of the element contributions of ``columns``
    (B·Eb, d, d): column j to local vertex j+1, −Σ_j to vertex 0."""
    d = columns.shape[-1]
    rows = element_contrib_full(columns).reshape(-1, d)
    out = columns.new_zeros((blk.num_blocks * blk.pb, d))
    out.index_add_(0, blk.row_slot, rows)
    return out.reshape(blk.num_blocks, blk.pb, d)


def blocked_prep_layers_plain(blk: Blocking, pos, layers, robust=False):
    """(K (B·Eb, d, d), force partials (B, Pb, d)) of material ``layers``
    — (rest-edge inverse (B·Eb, d, d), μ, λ, material) tuples — with each
    element's k and h summed over the layers before the −V scaling, as the
    whole-frame kernel K5 sums them; ``robust`` as in ``k_and_h_chain``."""
    x = block_edge_matrices(blk, blocked_gather(pos, blk))
    k = h = None
    for r, mu, lam, material in layers:
        k_l, h_l = k_and_h_chain(sm.matmul(x, r), r, mu, lam, material,
                                 robust)
        k = k_l if k is None else k + k_l
        h = h_l if h is None else h + h_l
    real = _real_slots(blk)
    nv = -blk.volume[:, None, None]
    k = torch.where(real, nv * k, 0.0)
    h = torch.where(real, nv * h, 0.0)
    return k, _slot_partials(blk, h)


def blocked_grad_columns_layers_plain(blk: Blocking, pos, layers):
    """Block-ordered explicit gradient columns (B·Eb, d, d) of material
    ``layers`` (as :func:`blocked_prep_layers_plain`), summed over the
    layers before the +V scaling, as K8 sums them.  Padded slots (X = 0,
    NaN through the unclamped log) are dropped by the mask."""
    x = block_edge_matrices(blk, blocked_gather(pos, blk))
    g = None
    for r, mu, lam, material in layers:
        g_l = grad_cols_chain(sm.matmul(x, r), r, mu, lam, material)
        g = g_l if g is None else g + g_l
    return torch.where(_real_slots(blk), blk.volume[:, None, None] * g, 0.0)


def blocked_grad_prep_layers_plain(blk: Blocking, pos, layers):
    """Per-slot partials (B, Pb, d) of :func:`blocked_grad_columns_layers_plain`."""
    return _slot_partials(blk, blocked_grad_columns_layers_plain(blk, pos,
                                                                 layers))


def blocked_prep_plain(blk: Blocking, pos, mu: float, lam: float,
                       ref_inv=None, material: str = "neo_hookean",
                       robust: bool = False):
    """Plain PyTorch version of :func:`blocked_prep`."""
    r = blk.ref_inv if ref_inv is None else ref_inv
    return blocked_prep_layers_plain(blk, pos, [(r, mu, lam, material)],
                                     robust)


def blocked_grad_prep_plain(blk: Blocking, pos, mu: float, lam: float,
                            ref_inv=None, material: str = "neo_hookean"):
    """Plain PyTorch version of :func:`blocked_grad_prep`."""
    r = blk.ref_inv if ref_inv is None else ref_inv
    return blocked_grad_prep_layers_plain(blk, pos, [(r, mu, lam, material)])


def blocked_edges_plain(blk: Blocking, pos) -> torch.Tensor:
    """Plain PyTorch version of :func:`blocked_edges`."""
    x = block_edge_matrices(blk, blocked_gather(pos, blk))
    return torch.where(_real_slots(blk), x, sm.inv(blk.ref_inv))


def blocked_assemble_plain(blk: Blocking, cols):
    """Plain PyTorch version of :func:`blocked_assemble`."""
    cols = torch.where(_real_slots(blk), cols, 0.0)
    return blocked_scatter_sum(_slot_partials(blk, cols), blk)


def blocked_graph_apply_plain(blk: Blocking, K, x, transpose_k: bool = False):
    """Plain PyTorch version of :func:`blocked_graph_apply`."""
    s = block_edge_matrices(blk, blocked_gather(x, blk))
    t = sm.matmul(sm.mT(K) if transpose_k else K, s)
    t = torch.where(_real_slots(blk), t, 0.0)
    return blocked_scatter_sum(_slot_partials(blk, t), blk)


def _library(material_id: int = MATERIAL_IDS["neo_hookean"]):
    """The blocked kernels' library of one material's preps; the
    material-independent kernels (K3, K7a, K7b edges) are in each, and
    their wrappers take the Neo-Hookean one."""
    lib = cuda_build.load("blocked", material_id)
    if lib.fem_blocked_prep.argtypes is None:
        tables = ctypes.POINTER(BlockTablesC)
        params = ctypes.POINTER(MaterialParamsC)
        lib.fem_blocked_prep.argtypes = [
            tables, _P, params, ctypes.c_int, _P, _P, _P,
        ]
        lib.fem_blocked_prep.restype = ctypes.c_int
        out = ctypes.POINTER(_I)
        lib.fem_blocked_matvec.argtypes = [ctypes.POINTER(MatvecArgsC), _P]
        lib.fem_blocked_matvec.restype = _I
        lib.fem_blocked_matvec_limits.argtypes = [_I, out, out, out]
        lib.fem_blocked_matvec_limits.restype = _I
        lib.fem_blocked_matvec_cluster_smem.argtypes = [_I] * 5
        lib.fem_blocked_matvec_cluster_smem.restype = ctypes.c_longlong
        lib.fem_blocked_matvec_cluster_fit.argtypes = [_I] * 4 + [out]
        lib.fem_blocked_matvec_cluster_fit.restype = _I
        lib.fem_blocked_matvec_cluster.argtypes = [
            ctypes.POINTER(MatvecArgsC), _I, _I, _I, _P]
        lib.fem_blocked_matvec_cluster.restype = _I
        lib.fem_blocked_grad_prep.argtypes = [
            tables, _P, params, ctypes.c_int, _P, _P,
        ]
        lib.fem_blocked_grad_prep.restype = ctypes.c_int
        lib.fem_blocked_edges.argtypes = [tables, _P, _P, _P]
        lib.fem_blocked_edges.restype = ctypes.c_int
        lib.fem_blocked_assemble.argtypes = [
            tables, _P, _P, _P, ctypes.c_int, _P, _P, _P,
        ]
        lib.fem_blocked_assemble.restype = ctypes.c_int
        lib.fem_blocked_error.argtypes = [ctypes.c_int]
        lib.fem_blocked_error.restype = ctypes.c_char_p
    return lib


def _check_rc(lib, rc, what):
    if rc != 0:
        msg = lib.fem_blocked_error(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg}")


def blocked_prep(blk: Blocking, pos: torch.Tensor, mu: float, lam: float,
                 ref_inv=None, material: str = "neo_hookean",
                 robust: bool = False):
    """(K (B·Eb, d, d), force partials (B, Pb, d)) of the implicit substep
    at ``pos``: K_e = −V·k and the slot sums of the −V·h force columns, of
    one material layer (``ref_inv``: a dynamic rest-edge inverse per slot,
    the blocking's own when None).

    CUDA tensors: one launch of the blocked prep kernel's instance of
    ``material`` (robust Neo-Hookean when ``robust``), 2D or 3D.  CPU
    tensors: :func:`blocked_prep_plain`."""
    mid = kernel_material_id(material, robust)
    if pos.device.type == "cpu":
        return blocked_prep_plain(blk, pos, mu, lam, ref_inv, material, robust)
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    tables = block_tables(blk, ref_inv)
    n, d = pos.shape[0], tables.dim
    cuda_build.check_operand("pos", pos, (n, d), torch.float32, blk.volume.device)
    dev = pos.device
    k = torch.empty((blk.num_blocks * blk.eb, d, d), dtype=torch.float32,
                    device=dev)
    partials = torch.empty((blk.num_blocks, blk.pb, d), dtype=torch.float32,
                           device=dev)
    params = material_params(material, mu, lam, d)
    lib = _library(mid)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fem_blocked_prep(
            ctypes.byref(tables), pos.data_ptr(), ctypes.byref(params), mid,
            k.data_ptr(), partials.data_ptr(), stream,
        )
    _check_rc(lib, rc, "blocked prep")
    count_launch(blocked_prep, d, mid)
    return k, partials


blocked_prep.launches = 0
blocked_prep.instance_launches = {}


def blocked_grad_prep(blk: Blocking, pos: torch.Tensor, mu: float,
                      lam: float, ref_inv=None,
                      material: str = "neo_hookean") -> torch.Tensor:
    """Per-slot partials (B, Pb, d) of the explicit energy gradient at
    ``pos``: the slot sums of the +V·P(F)·R⁻ᵀ columns (unclamped log), of
    one material layer (``ref_inv`` as in :func:`blocked_prep`); feed them
    to ``blocked_scatter_sum``.

    CUDA tensors: one launch of the blocked prep kernel in its explicit mode,
    the instance of ``material``, 2D or 3D.  CPU tensors:
    :func:`blocked_grad_prep_plain`."""
    mid = kernel_material_id(material)
    if pos.device.type == "cpu":
        return blocked_grad_prep_plain(blk, pos, mu, lam, ref_inv, material)
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    tables = block_tables(blk, ref_inv)
    n, d = pos.shape[0], tables.dim
    cuda_build.check_operand("pos", pos, (n, d), torch.float32, blk.volume.device)
    partials = torch.empty((blk.num_blocks, blk.pb, d), dtype=torch.float32,
                           device=pos.device)
    params = material_params(material, mu, lam, d)
    lib = _library(mid)
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        rc = lib.fem_blocked_grad_prep(
            ctypes.byref(tables), pos.data_ptr(), ctypes.byref(params), mid,
            partials.data_ptr(), stream,
        )
    _check_rc(lib, rc, "blocked gradient prep")
    count_launch(blocked_grad_prep, d, mid)
    return partials


blocked_grad_prep.launches = 0
blocked_grad_prep.instance_launches = {}


def blocked_edges(blk: Blocking, pos: torch.Tensor) -> torch.Tensor:
    """Edge matrices (B·Eb, d, d) of every element slot at ``pos``, in
    block order (x[s, i, j] = p_{j+1}[i] − p_0[i]); padded slots carry the
    rest edge matrix (the inverse of their R⁻¹), so F = I downstream.

    CUDA tensors: one launch of the blocked prep kernel's edges mode (2D or
    3D).  CPU tensors: :func:`blocked_edges_plain`."""
    if pos.device.type == "cpu":
        return blocked_edges_plain(blk, pos)
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    tables = block_tables(blk)
    n, d = pos.shape[0], tables.dim
    cuda_build.check_operand("pos", pos, (n, d), torch.float32, blk.volume.device)
    x = torch.empty((blk.num_blocks * blk.eb, d, d), dtype=torch.float32,
                    device=pos.device)
    lib = _library()
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        rc = lib.fem_blocked_edges(ctypes.byref(tables), pos.data_ptr(),
                                   x.data_ptr(), stream)
    _check_rc(lib, rc, "blocked edges")
    blocked_edges.launches += 1
    return x


blocked_edges.launches = 0


def check_slot_plan(blk: Blocking, n: int, dev) -> None:
    """Raise unless ``blk``'s CSR slot plan is what the kernels take for
    ``n`` particles on ``dev``."""
    plan = blk.slot_plan
    cuda_build.check_operand("slot_plan.ptr", plan.ptr, (n + 1,), torch.int32, dev)
    cuda_build.check_operand("slot_plan.rows", plan.rows, tuple(plan.rows.shape),
                             torch.int32, dev)


def blocked_assemble(blk: Blocking, cols: torch.Tensor) -> torch.Tensor:
    """(N, d) assembly of block-ordered element columns ``cols`` (B·Eb, d, d):
    column j of each real slot to its local vertex j+1, −Σ_j to vertex 0,
    summed per block and then per particle over its block slots (padded
    slots contribute nothing).

    CUDA tensors: one launch of the blocked assembly (two kernels: per-block
    partials, per-particle slot sums).  CPU tensors:
    :func:`blocked_assemble_plain`."""
    if cols.device.type == "cpu":
        return blocked_assemble_plain(blk, cols)
    if cols.device.type != "cuda":
        raise ValueError(f"unsupported device {cols.device}")
    tables = block_tables(blk)
    dev = cols.device
    n, d = blk.slot_plan.ptr.shape[0] - 1, tables.dim
    cuda_build.check_operand("cols", cols, (blk.num_blocks * blk.eb, d, d),
                             torch.float32, blk.volume.device)
    check_slot_plan(blk, n, dev)
    partials = torch.empty((blk.num_blocks * blk.pb, d), dtype=torch.float32,
                           device=dev)
    y = torch.empty((n, d), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fem_blocked_assemble(
            ctypes.byref(tables), cols.data_ptr(), blk.slot_plan.ptr.data_ptr(),
            blk.slot_plan.rows.data_ptr(), n, partials.data_ptr(),
            y.data_ptr(), stream,
        )
    _check_rc(lib, rc, "blocked assembly")
    blocked_assemble.launches += 1
    return y


blocked_assemble.launches = 0


class MatvecArgsC(ctypes.Structure):
    """Mirror of ``FemMatvecArgs`` (csrc/blocked.cu): K3's arguments, both
    variants."""

    _fields_ = [
        ("T", BlockTablesC), ("k", _P), ("x", _P), ("transpose", _I),
        ("n", _I), ("slot_ptr", _P), ("slot_rows", _P), ("partials", _P),
        ("y", _P), ("cl_owned_ptr", _P), ("cl_owned_ids", _P),
        ("cl_recv_ptr", _P), ("cl_slot_dest", _P), ("cl_entries", _I),
        ("barriers", _P),
    ]


class MatvecPlan(NamedTuple):
    """K3's launch: ``variant`` "cluster" (one cluster of ``size`` CTAs of
    ``threads`` threads, ``smem`` bytes of dynamic shared memory each) or
    "grid" (the two kernels: ``size`` = B CTAs of 256 threads for the
    per-block partials, each with ``smem`` bytes of working set, then one
    thread a particle)."""

    variant: str
    size: int
    smem: int
    threads: int = 256


# Floats of a receive slot (csrc/cluster_slots.cuh: slot_stride).
_ROW_STRIDE = {2: 2, 3: 4}
_F32 = 4


def matvec_cluster_smem(eb: int, pb: int, dim: int, groups: int,
                        entries: int) -> int:
    """Bytes of dynamic shared memory of K3's cluster CTA: its ``entries``
    receive slots (rows padded to 4 floats in 3D), then per thread group
    one block's working set (its particles' rows and its elements'
    contribution rows) and the block's staged tables (plus, minus, the
    local plan's rows and offsets, the slots' destinations)
    (csrc/blocked.cu: matvec_cluster_words)."""
    return _F32 * (_ROW_STRIDE[dim] * entries
                   + groups * (dim * pb + (dim + 1) * dim * eb
                               + (3 * dim + 1) * eb + 2 * pb + 1))


def matvec_plan(block_particles, slot_ptr, slot_rows, n: int, eb: int,
                dim: int, limits, cluster: int = 0,
                grid: bool = False) -> MatvecPlan:
    """K3's variant, its CTAs, threads and shared memory, from the
    blocking's host arrays (those of ``frame_kernels.cluster_assignment``),
    its element slots a block ``eb`` and the device's ``limits``
    (``frame_kernels.FrameLimits``).

    Forced: ``grid`` gives the two-kernel variant, ``cluster`` > 0 the
    cluster variant of that many CTAs, refused (``ValueError``) when it
    exceeds the blocks, ``max_cluster`` or, per CTA, ``smem_optin`` (and
    checked on the device once more before the launch).  Otherwise the
    cluster variant with one CTA per block, at most ``max_cluster`` (the
    flagship's 17 blocks: 16 CTAs, one of them with two blocks and two
    thread groups; ``default.json``'s one block: 1), when every CTA's
    blocks fit its thread groups at once (B ≤ 2·``max_cluster``: a CTA
    takes its blocks one after another beyond that, where the two-kernel
    variant spreads them over the SMs) and a CTA's receive slots and
    working sets fit ``smem_optin``; else the two-kernel variant."""
    from fem_tpu_torch.ops.frame_kernels import (
        GROUP_THREADS,
        MAX_GROUPS,
        cluster_groups,
        explicit_assignment,
    )

    if cluster < 0:
        raise ValueError(f"cluster {cluster} must be >= 0")
    if cluster and grid:
        raise ValueError("give grid or cluster, not both")
    b_cnt, pb = np.asarray(block_particles).shape
    if b_cnt < 1 or dim not in (2, 3):
        raise ValueError(f"no operator of {b_cnt} blocks in {dim}D")
    two_kernels = MatvecPlan("grid", b_cnt,
                             _F32 * (dim * pb + (dim + 1) * dim * eb))
    if grid:
        return two_kernels

    def plan(c):
        asg = explicit_assignment(block_particles, slot_ptr, slot_rows, n, c)
        groups = cluster_groups(b_cnt, c)
        return MatvecPlan("cluster", c, matvec_cluster_smem(
            eb, pb, dim, groups, asg.sizes()[1]), GROUP_THREADS * groups)

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
    if b_cnt > MAX_GROUPS * limits.max_cluster:
        return two_kernels
    auto = plan(min(b_cnt, limits.max_cluster))
    return auto if auto.smem <= limits.smem_optin else two_kernels


def matvec_barriers(variant: str, ctas: int) -> int:
    """Barriers of one K3 apply of ``ctas`` CTAs, as csrc/blocked.cu places
    them.  The cluster variant: one cluster barrier before the first store
    into another CTA (none in a cluster of one) and one after the slot sums
    are stored into their owners — 2, or 1 for one CTA.  The two-kernel
    variant meets none inside a kernel: its launch boundary orders the
    partials before the slot sums — 0.  The cluster kernel counts the
    barriers it meets (``blocked_graph_apply.last_barriers``); the CUDA
    tests and ``chip_smoke.py`` hold that count to this one."""
    if variant == "grid":
        return 0
    if variant == "cluster":
        return 2 if ctas > 1 else 1
    raise ValueError(f"unknown variant {variant!r}")


@functools.lru_cache(maxsize=16)
def matvec_device_limits(device_index: int, dim: int):
    """The ``frame_kernels.FrameLimits`` of CUDA device ``device_index``
    for K3's cluster instance of ``dim``."""
    from fem_tpu_torch.ops.frame_kernels import FrameLimits

    lib = _library()
    mc, optin, sms = _I(0), _I(0), _I(0)
    with torch.cuda.device(device_index):
        rc = lib.fem_blocked_matvec_limits(dim, ctypes.byref(mc),
                                           ctypes.byref(optin),
                                           ctypes.byref(sms))
    _check_rc(lib, rc, "blocked matvec (reading the device's limits)")
    return FrameLimits(mc.value, optin.value, sms.value)


@functools.lru_cache(maxsize=64)
def _check_matvec_cluster(device_index: int, plan: MatvecPlan, eb: int,
                          pb: int, dim: int, entries: int) -> None:
    """Raise unless the device can run K3's cluster ``plan`` for CTAs of
    ``entries`` receive slots.  Once per plan on a device."""
    from fem_tpu_torch.ops.frame_kernels import GROUP_THREADS

    lib = _library()
    groups = plan.threads // GROUP_THREADS
    want = lib.fem_blocked_matvec_cluster_smem(eb, pb, dim, groups, entries)
    if want != plan.smem:
        raise RuntimeError(f"blocked matvec: the plan's {plan.smem} B of "
                           f"shared memory differ from the kernel's {want}")
    most = _I(0)
    with torch.cuda.device(device_index):
        rc = lib.fem_blocked_matvec_cluster_fit(plan.size, plan.threads,
                                                plan.smem, dim,
                                                ctypes.byref(most))
    if rc != 0:
        raise RuntimeError(
            f"blocked matvec: {lib.fem_blocked_error(rc).decode()} (one "
            f"cluster of {plan.size} CTAs of {plan.threads} threads, "
            f"{plan.smem} B of shared memory each; {most.value} such "
            f"clusters fit at once)")


def _matvec_versions(blk: Blocking) -> tuple:
    """The version counters of every tensor of ``blk`` that K3 reads: an
    in-place change to one of them invalidates a binding."""
    return (blk.block_particles._version, blk.plus._version,
            blk.minus._version, blk.block_elements._version,
            blk.local_ptr._version, blk.local_rows._version,
            blk.slot_plan.ptr._version, blk.slot_plan.rows._version)


# Device → the (1,) int32 tensor K3's cluster launches there write their
# barrier count to.
_BARRIERS: dict = {}


class MatvecBinding:
    """K3's launch for one blocking, built once: on a CUDA device the
    checked block tables and slot plan, the plan (:func:`matvec_plan`), its
    device check and assignment tables (the cluster variant) or the
    partials (the two-kernel variant), the library and a prebuilt
    :class:`MatvecArgsC`; each call then checks and patches only K, x and
    the transpose, allocates y and launches.  On the CPU a call runs
    :func:`blocked_graph_apply_plain`.  ``matches`` tells whether the
    binding still holds for a blocking: the same one, its tensors unchanged
    since (their version counters); ``MatvecBinding.builds`` counts the
    bindings built."""

    builds = 0

    def __init__(self, blk: Blocking, cluster: int = 0, grid: bool = False):
        from fem_tpu_torch.ops.frame_kernels import (
            FrameLimits,
            explicit_assignment,
        )

        MatvecBinding.builds += 1
        self.blk = blk
        self.versions = _matvec_versions(blk)
        dev = self.dev = blk.volume.device
        if dev.type == "cpu":
            return
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        self.tables = block_tables(blk)
        n = self.n = blk.slot_plan.ptr.shape[0] - 1
        d = self.d = self.tables.dim
        check_slot_plan(blk, n, dev)
        self.index = dev.index if dev.index is not None else (
            torch.cuda.current_device())
        host = (blk.block_particles.cpu().numpy(),
                blk.slot_plan.ptr.cpu().numpy(),
                blk.slot_plan.rows.cpu().numpy())
        limits = (FrameLimits(0, 0, 0) if grid
                  else matvec_device_limits(self.index, d))
        self.plan = matvec_plan(*host, n, blk.eb, d, limits, int(cluster),
                                bool(grid))
        self.lib = lib = _library()
        self.k_shape = (blk.num_blocks * blk.eb, d, d)
        if self.plan.variant == "cluster":
            asg = explicit_assignment(*host, n, self.plan.size)
            owned = np.diff(asg.owned_ptr)
            owned_ids = np.concatenate([
                asg.local_ids[asg.local_ptr[r]:asg.local_ptr[r] + owned[r]]
                for r in range(self.plan.size)])
            entries = asg.sizes()[1]
            _check_matvec_cluster(self.index, self.plan, blk.eb, blk.pb, d,
                                  entries)
            self.cl = tuple(torch.as_tensor(t, dtype=torch.int32, device=dev)
                            for t in (asg.owned_ptr, owned_ids, asg.recv_ptr,
                                      asg.slot_dest))
            cl_fields = [t.data_ptr() for t in self.cl] + [entries]
            self.partials = None
            barriers = _BARRIERS.get(dev)
            if barriers is None:
                barriers = _BARRIERS[dev] = torch.zeros(
                    (1,), dtype=torch.int32, device=dev)
            self.barriers = barriers
        else:
            self.cl = ()
            cl_fields = [None] * 4 + [0]
            self.partials = torch.empty((blk.num_blocks * blk.pb, d),
                                        dtype=torch.float32, device=dev)
            self.barriers = None
        self.args = MatvecArgsC(
            self.tables, None, None, 0, n, blk.slot_plan.ptr.data_ptr(),
            blk.slot_plan.rows.data_ptr(),
            None if self.partials is None else self.partials.data_ptr(),
            None, *cl_fields,
            None if self.barriers is None else self.barriers.data_ptr())
        ref = ctypes.byref(self.args)
        if self.plan.variant == "cluster":
            launch = lib.fem_blocked_matvec_cluster
            size, threads, smem = (self.plan.size, self.plan.threads,
                                   self.plan.smem)
            self._launch = lambda stream: launch(ref, size, threads, smem,
                                                 stream)
        else:
            launch = lib.fem_blocked_matvec
            self._launch = lambda stream: launch(ref, stream)

    def matches(self, blk: Blocking) -> bool:
        return blk is self.blk and _matvec_versions(blk) == self.versions

    def __call__(self, K: torch.Tensor, x: torch.Tensor,
                 transpose_k: bool) -> torch.Tensor:
        """G(K)·x or G(Kᵀ)·x (N, d), a fresh tensor: one launch (on the
        CPU :func:`blocked_graph_apply_plain`)."""
        dev = self.dev
        if dev.type == "cpu":
            return blocked_graph_apply_plain(self.blk, K, x, transpose_k)
        cuda_build.check_operand("x", x, (self.n, self.d), torch.float32, dev)
        cuda_build.check_operand("K", K, self.k_shape, torch.float32, dev)
        y = torch.empty((self.n, self.d), dtype=torch.float32, device=dev)
        a = self.args
        a.k, a.x, a.y = K.data_ptr(), x.data_ptr(), y.data_ptr()
        a.transpose = int(bool(transpose_k))
        if torch.cuda.current_device() == self.index:
            rc = self._launch(torch.cuda.current_stream(dev).cuda_stream)
        else:
            with torch.cuda.device(dev):
                rc = self._launch(torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(
                f"blocked matvec kernel launch failed ({self.plan.variant} "
                f"variant, {self.plan.size} CTAs): "
                f"{self.lib.fem_blocked_error(rc).decode()}")
        fn = blocked_graph_apply
        fn.launches += 1
        fn.last_plan = self.plan
        fn.last_barriers = self.barriers
        key = (self.plan.variant, self.plan.size)
        fn.variant_launches[key] = fn.variant_launches.get(key, 0) + 1
        return y


# (id(blocking), cluster, grid) → the MatvecBinding built for them, which
# holds the blocking so that its id is not reused while it is kept.
_BINDINGS: dict = {}


def matvec_binding(blk: Blocking, cluster: int = 0,
                   grid: bool = False) -> MatvecBinding:
    """The :class:`MatvecBinding` of ``blk`` and the forced variant, built once and built again when the blocking is
    replaced or changed in place."""
    key = (id(blk), int(cluster), bool(grid))
    hit = _BINDINGS.get(key)
    if hit is None or not hit.matches(blk):
        hit = MatvecBinding(blk, cluster, grid)
        if key not in _BINDINGS and len(_BINDINGS) >= 32:
            _BINDINGS.pop(next(iter(_BINDINGS)))
        _BINDINGS[key] = hit
    return hit


def blocked_graph_apply(blk: Blocking, K: torch.Tensor, x: torch.Tensor,
                        transpose_k: bool = False, cluster: int = 0,
                        grid: bool = False) -> torch.Tensor:
    """G(K)·x (G(Kᵀ)·x when ``transpose_k``), (N, d): per block the
    element-Laplacian product of its K blocks, then each particle's sum over
    its block slots.

    CUDA tensors: one launch of the blocked operator, in the variant of
    :func:`matvec_plan` (``cluster`` forces the cluster variant with that
    many CTAs, ``grid`` the two-kernel variant; tests and
    ``chip_smoke.py``; a plan the device cannot run raises), with what is
    fixed per blocking bound once (:func:`matvec_binding`).  The launch's
    plan is left in ``blocked_graph_apply.last_plan`` and counted by
    (variant, CTAs) in ``variant_launches``; the barriers the cluster
    kernel met in ``blocked_graph_apply.last_barriers``, a (1,) int32
    tensor on the device that the next cluster launch there overwrites
    (None after the two-kernel variant; :func:`matvec_barriers` says what
    it must hold).  CPU tensors: :func:`blocked_graph_apply_plain`."""
    if x.device.type == "cpu":
        return blocked_graph_apply_plain(blk, K, x, transpose_k)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return matvec_binding(blk, cluster, grid)(K, x, transpose_k)


blocked_graph_apply.launches = 0
blocked_graph_apply.variant_launches = {}
blocked_graph_apply.last_plan = None
blocked_graph_apply.last_barriers = None


def blocked_velocity_solve(
    blk: Blocking, prepped, vel, mass, dt: float, normal: bool, *,
    apply=blocked_graph_apply, beta: float = 0.0,
    cg_precond: str = "reference", diag_fn=None, free=None, pin_vel=None,
    max_iter: int = 500, tol: float = 1e-5,
) -> CGResult:
    """One implicit velocity solve over the blocks (the JAX package's
    blocked branch, solvers/implicit.py:1080-1101) from the prep's
    ``prepped`` = (K, force partials): the slot-sum assembly,
    b = v + dt·f/m, then ``cg_solve_dispatch`` over A·v = v − c·G(K)·v/m and
    Aᵀ·v = v − c·G(Kᵀ)·(v/m), c = dt·(dt + ``beta``): the reference CG
    (x₀ = b; normal equations when ``normal``), or with ``cg_precond``
    ``"block_jacobi"`` the PCG on the blocks ``diag_fn()``, and the pin
    projection by ``free``/``pin_vel``.  ``apply`` defaults to the kernel's
    wrapper; the plain frame passes its plain version."""
    K, partials = prepped
    f = blocked_scatter_sum(partials, blk)
    minv = (1.0 / mass)[:, None]
    c = system_coeff(dt, beta)
    b = vel + dt * f * minv

    def apply_a(v):
        return v - c * apply(blk, K, v, False) * minv

    def apply_at(v):
        return v - c * apply(blk, K, v * minv, True)

    return cg_solve_dispatch(
        apply_a, lambda: apply_at, b, int(bool(normal)), cg_precond, diag_fn,
        mass, free, pin_vel, max_iter, tol)
