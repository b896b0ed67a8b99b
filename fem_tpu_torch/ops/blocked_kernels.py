# coding=utf-8
"""K2, K7b, K3 and K7a: the blocked element prep, the blocked operator and
the blocked assembly.

``fem_tpu_torch/csrc/blocked.cu`` holds one cluster kernel template with
four row sources — what a block's element computes before the slot sums —
and each launch of it ends in the per-particle sum:

* ``blocked_prep_force`` (K2, source "prep"): K_e = −V·k and the assembled
  −V·h force of one material layer, what the implicit substep consumes;
  it replaces ``ops/blocking.py:_prep_kernel`` in its implicit mode
  (entry ``blocked_prep``) with the JAX package's scatter after it;
* ``blocked_grad_force`` (K7b, "grad"): the assembled explicit gradient;
  ``_prep_kernel``'s explicit mode (entry ``blocked_grad_prep``) and the
  scatter;
* ``blocked_graph_apply`` (K3, "apply"): G(K)·x; ``_matvec_kernel``
  (entry ``blocked_graph_apply``);
* ``blocked_assemble`` (K7a, "columns"): the assembly of block-ordered
  columns; ``_scatter_kernel`` (entry ``blocked_assemble``).

Each runs in one of two variants that :func:`blocked_plan` chooses before
the launch: the **cluster** variant (one thread-block cluster on K8's
ownership, block slot sums stored into their particles' owners through
distributed shared memory: every blocking whose receive slots fit one
cluster) or the **grid** variant (two kernels: per-block partials through
device memory, then per-particle slot sums); ``cluster=`` or ``grid=True``
force one.  Both variants give bit-identical outputs.  What is fixed per blocking, source and
material (the tables, the plan, its assignment, the partials) is bound
once (:func:`blocked_binding`).  Each launches the instance of the
blocking's dimension (2 or 3).  For tensors on the CPU each runs its plain
PyTorch version (``*_plain``); on CUDA each launches its kernel or raises.

``blocked_prep`` and ``blocked_grad_prep`` are the preps' partials forms
(K and per-slot partials, one CTA a block: the grid variant's first
kernel), which the tests and ``chip_smoke.py`` hold to their plain
versions.  ``blocked_edges`` launches the edges kernel, two CTAs a
block; it replaces the edges mode of ``ops/blocking.py:_prep_kernel``
(entry ``blocked_edge_planes``, K7b edges): the edge matrix of every
element slot in block order, for the inelastic update
(``ops/inelastic.py``).

The preps take a material layer (ops/inelastic.py): an optional dynamic
rest-edge inverse per slot (``ref_inv``, (B·Eb, d, d); the blocking's own
when None) and the material, any of ``ops/element.py``'s (and for K2
``robust``).  The dynamic inverse is the same table pointer the kernel
reads anyway, the material a template parameter chosen at launch
(``kernel_material_id``, one library per material), and its numbers a
kernel argument.  Both forms of a prep count their launches on the
partials form's function (``blocked_prep``, ``blocked_grad_prep``), in
total and by (dimension, material instance), as ``ops/element_kernels``
does; the one-launch forms also by (variant, CTAs).

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
from fem_tpu_torch.ops.assembly import all_reduce_sum, element_contrib_full
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


def blocked_prep_force_plain(blk: Blocking, pos, mu: float, lam: float,
                             ref_inv=None, material: str = "neo_hookean",
                             robust: bool = False):
    """Plain PyTorch version of :func:`blocked_prep_force`: K and the
    slot-sum assembly of :func:`blocked_prep_plain`'s force partials."""
    K, partials = blocked_prep_plain(blk, pos, mu, lam, ref_inv, material,
                                     robust)
    return K, blocked_scatter_sum(partials, blk)


def blocked_grad_force_plain(blk: Blocking, pos, mu: float, lam: float,
                             ref_inv=None, material: str = "neo_hookean"):
    """Plain PyTorch version of :func:`blocked_grad_force`: the slot-sum
    assembly of :func:`blocked_grad_prep_plain`'s partials."""
    return blocked_scatter_sum(
        blocked_grad_prep_plain(blk, pos, mu, lam, ref_inv, material), blk)


def _library(material_id: int = MATERIAL_IDS["neo_hookean"]):
    """The blocked kernels' library of one material's preps; the
    material-independent kernels (K3, K7a, K7b edges) are in each, and
    their wrappers take the Neo-Hookean one."""
    lib = cuda_build.load("blocked", material_id)
    if lib.fem_blocked_prep.argtypes is None:
        tables = ctypes.POINTER(BlockTablesC)
        params = ctypes.POINTER(MaterialParamsC)
        args = ctypes.POINTER(BlockedArgsC)
        out = ctypes.POINTER(_I)
        lib.fem_blocked_prep.argtypes = [tables, _P, params, _I, _P, _P, _P]
        lib.fem_blocked_prep.restype = _I
        lib.fem_blocked_grad_prep.argtypes = [tables, _P, params, _I, _P, _P]
        lib.fem_blocked_grad_prep.restype = _I
        lib.fem_blocked_grid.argtypes = [args, _I, _I, _P]
        lib.fem_blocked_grid.restype = _I
        lib.fem_blocked_cluster_limits.argtypes = [_I] * 3 + [out] * 3
        lib.fem_blocked_cluster_limits.restype = _I
        lib.fem_blocked_cluster_smem.argtypes = [_I] * 6
        lib.fem_blocked_cluster_smem.restype = ctypes.c_longlong
        lib.fem_blocked_cluster_fit.argtypes = [_I] * 6 + [out]
        lib.fem_blocked_cluster_fit.restype = _I
        lib.fem_blocked_cluster.argtypes = [args] + [_I] * 5 + [_P]
        lib.fem_blocked_cluster.restype = _I
        lib.fem_blocked_edges.argtypes = [tables, _P, _P, _P]
        lib.fem_blocked_edges.restype = _I
        lib.fem_blocked_error.argtypes = [_I]
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
    the blocking's own when None) — the partials form, which the tests and
    ``chip_smoke.py`` hold to the plain version; the substep takes
    :func:`blocked_prep_force`.

    CUDA tensors: one launch of the blocked prep kernel's instance of
    ``material`` (robust Neo-Hookean when ``robust``), 2D or 3D, one CTA a
    block.  CPU tensors: :func:`blocked_prep_plain`."""
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


def blocked_grad_prep(blk: Blocking, pos: torch.Tensor, mu: float,
                      lam: float, ref_inv=None,
                      material: str = "neo_hookean") -> torch.Tensor:
    """Per-slot partials (B, Pb, d) of the explicit energy gradient at
    ``pos``: the slot sums of the +V·P(F)·R⁻ᵀ columns (unclamped log), of
    one material layer (``ref_inv`` as in :func:`blocked_prep`) — the
    partials form; the substep takes :func:`blocked_grad_force`.

    CUDA tensors: one launch of the blocked prep kernel in its explicit mode,
    the instance of ``material``, 2D or 3D, one CTA a block.  CPU tensors:
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


def blocked_edges(blk: Blocking, pos: torch.Tensor) -> torch.Tensor:
    """Edge matrices (B·Eb, d, d) of every element slot at ``pos``, in
    block order (x[s, i, j] = p_{j+1}[i] − p_0[i]); padded slots carry the
    rest edge matrix (the inverse of their R⁻¹), so F = I downstream.

    CUDA tensors: one launch of the blocked prep kernel's edges mode (2D or
    3D), two CTAs a block of ⌈Eb/2⌉ threads each (csrc/blocked.cu:
    kEdgeParts).  CPU tensors: :func:`blocked_edges_plain`."""
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


# The cluster kernel's row sources (csrc/blocked.cu: BlockedSource): apply
# (K3), prep (K2), grad (K7b), columns (K7a).
SOURCES = {"apply": 0, "prep": 1, "grad": 2, "columns": 3}


class BlockedArgsC(ctypes.Structure):
    """Mirror of ``FemBlockedArgs`` (csrc/blocked.cu): the arguments of
    every source, both variants."""

    _fields_ = [
        ("T", BlockTablesC), ("k", _P), ("x", _P), ("transpose", _I),
        ("n", _I), ("slot_ptr", _P), ("slot_rows", _P), ("partials", _P),
        ("y", _P), ("cl_owned_ptr", _P), ("cl_owned_ids", _P),
        ("cl_recv_ptr", _P), ("cl_slot_dest", _P), ("cl_entries", _I),
        ("barriers", _P), ("k_out", _P), ("m", MaterialParamsC),
    ]


class BlockedPlan(NamedTuple):
    """A blocked launch: ``variant`` "cluster" (one cluster of ``size`` CTAs
    of ``threads`` threads, ``smem`` bytes of dynamic shared memory each) or
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


def _pad4(words: int) -> int:
    return (words + 3) & ~3


def cluster_group_words(source: str, eb: int, pb: int, dim: int) -> int:
    """4-byte words of one thread group's share of the cluster CTA of
    ``source`` (csrc/blocked.cu: group_layout): apply packs its block's
    rows and contribution rows and the block's plus, minus, local plan rows
    and offsets and slot destinations; the other sources put each segment
    on a 16-byte boundary (for the TMA bulk copies), with the layer's R⁻¹
    and the volumes (prep, grad) or the block's columns (columns), and no
    gathered rows, plus or minus for columns."""
    gather = source != "columns"
    chain = source in ("prep", "grad")
    words = []
    if gather:
        words.append(dim * pb)
    words.append((dim + 1) * dim * eb)
    if chain or source == "columns":
        words.append(dim * dim * eb)
    if chain:
        words.append(eb)
    if gather:
        words += [dim * eb, dim * eb]
    words += [(dim + 1) * eb, pb + 1, pb]
    return sum(words) if source == "apply" else sum(map(_pad4, words))


def cluster_smem(source: str, eb: int, pb: int, dim: int, groups: int,
                 entries: int) -> int:
    """Bytes of dynamic shared memory of the cluster CTA of ``source``: its
    ``entries`` receive slots (rows padded to 4 floats in 3D), then one
    share per thread group (csrc/blocked.cu: cluster_words)."""
    recv = _ROW_STRIDE[dim] * entries
    if source != "apply":
        recv = _pad4(recv)
    return _F32 * (recv + groups * cluster_group_words(source, eb, pb, dim))


def blocked_plan(block_particles, slot_ptr, slot_rows, n: int, eb: int,
                dim: int, limits, cluster: int = 0, grid: bool = False,
                source: str = "apply") -> BlockedPlan:
    """The variant, CTAs, threads and shared memory of a blocked launch of
    ``source`` (K3 "apply", K2 "prep", K7b "grad", K7a "columns"), from the
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

    if source not in SOURCES:
        raise ValueError(f"unknown source {source!r}")
    if cluster < 0:
        raise ValueError(f"cluster {cluster} must be >= 0")
    if cluster and grid:
        raise ValueError("give grid or cluster, not both")
    b_cnt, pb = np.asarray(block_particles).shape
    if b_cnt < 1 or dim not in (2, 3):
        raise ValueError(f"no operator of {b_cnt} blocks in {dim}D")
    rows = (dim + 1) * dim * eb
    two_kernels = BlockedPlan("grid", b_cnt, _F32 * (
        rows if source == "columns" else dim * pb + rows))
    if grid:
        return two_kernels

    def plan(c):
        asg = explicit_assignment(block_particles, slot_ptr, slot_rows, n, c)
        groups = cluster_groups(b_cnt, c)
        return BlockedPlan("cluster", c, cluster_smem(
            source, eb, pb, dim, groups, asg.sizes()[1]),
            GROUP_THREADS * groups)

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


def blocked_barriers(variant: str, ctas: int) -> int:
    """Barriers of one blocked launch of ``ctas`` CTAs (every source), as
    csrc/blocked.cu places them.  The cluster variant: one cluster barrier
    before the first store into another CTA (none in a cluster of one) and
    one after the slot sums are stored into their owners — 2, or 1 for one
    CTA.  The two-kernel variant meets none inside a kernel: its launch
    boundary orders the partials before the slot sums — 0.  The cluster
    kernel counts the barriers it meets (``last_barriers`` of
    ``blocked_graph_apply``, ``blocked_prep``, ``blocked_grad_prep`` and
    ``blocked_assemble``); the CUDA tests and ``chip_smoke.py`` hold that
    count to this one."""
    if variant == "grid":
        return 0
    if variant == "cluster":
        return 2 if ctas > 1 else 1
    raise ValueError(f"unknown variant {variant!r}")


@functools.lru_cache(maxsize=64)
def blocked_device_limits(device_index: int, dim: int, source: str = "apply",
                          material_id: int = 0):
    """The ``frame_kernels.FrameLimits`` of CUDA device ``device_index``
    for the cluster kernel of ``source`` in ``dim`` (of ``material_id``
    for prep and grad)."""
    from fem_tpu_torch.ops.frame_kernels import FrameLimits

    lib = _library(material_id)
    mc, optin, sms = _I(0), _I(0), _I(0)
    with torch.cuda.device(device_index):
        rc = lib.fem_blocked_cluster_limits(
            SOURCES[source], dim, material_id, ctypes.byref(mc),
            ctypes.byref(optin), ctypes.byref(sms))
    _check_rc(lib, rc, f"blocked {source} (reading the device's limits)")
    return FrameLimits(mc.value, optin.value, sms.value)


@functools.lru_cache(maxsize=64)
def _check_cluster(device_index: int, plan: BlockedPlan, eb: int, pb: int,
                   dim: int, entries: int, source: str,
                   material_id: int) -> None:
    """Raise unless the device can run the cluster ``plan`` of ``source``
    for CTAs of ``entries`` receive slots.  Once per plan on a device."""
    from fem_tpu_torch.ops.frame_kernels import GROUP_THREADS

    lib = _library(material_id)
    sid = SOURCES[source]
    groups = plan.threads // GROUP_THREADS
    want = lib.fem_blocked_cluster_smem(sid, eb, pb, dim, groups, entries)
    if want != plan.smem:
        raise RuntimeError(f"blocked {source}: the plan's {plan.smem} B of "
                           f"shared memory differ from the kernel's {want}")
    most = _I(0)
    with torch.cuda.device(device_index):
        rc = lib.fem_blocked_cluster_fit(sid, material_id, plan.size,
                                         plan.threads, plan.smem, dim,
                                         ctypes.byref(most))
    if rc != 0:
        raise RuntimeError(
            f"blocked {source}: {lib.fem_blocked_error(rc).decode()} (one "
            f"cluster of {plan.size} CTAs of {plan.threads} threads, "
            f"{plan.smem} B of shared memory each; {most.value} such "
            f"clusters fit at once)")


def _blocking_versions(blk: Blocking) -> tuple:
    """The version counters of every tensor of ``blk`` that the plan reads:
    an in-place change to one of them invalidates a binding."""
    return (blk.block_particles._version, blk.plus._version,
            blk.minus._version, blk.block_elements._version,
            blk.local_ptr._version, blk.local_rows._version,
            blk.slot_plan.ptr._version, blk.slot_plan.rows._version)


# Device → the (1,) int32 tensor the cluster launches there write their
# barrier count to.
_BARRIERS: dict = {}


class BlockedBinding:
    """A blocked launch of one source for one blocking, built once: on a
    CUDA device the checked block tables and slot plan, the plan
    (:func:`blocked_plan`), its device check and assignment tables (the
    cluster variant) or the partials (the two-kernel variant), the library
    and a prebuilt :class:`BlockedArgsC`; each call then checks and patches
    only its operands, allocates its outputs and launches.  ``source`` is
    "apply" (K3, :meth:`__call__`), "prep" (K2, :meth:`prep`), "grad" (K7b,
    :meth:`grad`) or "columns" (K7a, :meth:`columns`), of material
    ``material_id`` for prep and grad.  On the CPU :meth:`__call__` runs :func:`blocked_graph_apply_plain`.
    ``matches`` tells whether the binding still holds for a blocking: the
    same one, its tensors unchanged since (their version counters);
    ``BlockedBinding.builds`` counts the bindings built."""

    builds = 0

    def __init__(self, blk: Blocking, cluster: int = 0, grid: bool = False,
                 source: str = "apply", material_id: int = 0):
        from fem_tpu_torch.ops.frame_kernels import (
            FrameLimits,
            explicit_assignment,
        )

        BlockedBinding.builds += 1
        self.blk = blk
        self.source = source
        self.versions = _blocking_versions(blk)
        dev = self.dev = blk.volume.device
        if dev.type == "cpu":
            return
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        self.sid, self.mid = SOURCES[source], int(material_id)
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
                  else blocked_device_limits(self.index, d, source, self.mid))
        self.plan = blocked_plan(*host, n, blk.eb, d, limits, int(cluster),
                                bool(grid), source)
        self.lib = lib = _library(self.mid)
        self.k_shape = (blk.num_blocks * blk.eb, d, d)
        if self.plan.variant == "cluster":
            asg = explicit_assignment(*host, n, self.plan.size)
            owned = np.diff(asg.owned_ptr)
            owned_ids = np.concatenate([
                asg.local_ids[asg.local_ptr[r]:asg.local_ptr[r] + owned[r]]
                for r in range(self.plan.size)])
            entries = asg.sizes()[1]
            _check_cluster(self.index, self.plan, blk.eb, blk.pb, d, entries,
                           source, self.mid)
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
        self.args = BlockedArgsC(
            self.tables, None, None, 0, n, blk.slot_plan.ptr.data_ptr(),
            blk.slot_plan.rows.data_ptr(),
            None if self.partials is None else self.partials.data_ptr(),
            None, *cl_fields,
            None if self.barriers is None else self.barriers.data_ptr(),
            None, MaterialParamsC())
        ref = ctypes.byref(self.args)
        sid, mid = self.sid, self.mid
        if self.plan.variant == "cluster":
            launch = lib.fem_blocked_cluster
            size, threads, smem = (self.plan.size, self.plan.threads,
                                   self.plan.smem)
            self._launch = lambda stream: launch(ref, sid, mid, size, threads,
                                                 smem, stream)
        else:
            launch = lib.fem_blocked_grid
            self._launch = lambda stream: launch(ref, sid, mid, stream)

    def matches(self, blk: Blocking) -> bool:
        return blk is self.blk and _blocking_versions(blk) == self.versions

    def _run(self, fn, *instance) -> None:
        """Launch on the device's current stream and count the launch on
        ``fn`` (by instance when given), its plan and barriers."""
        rc = cuda_build.launch_on_stream(self.dev, self.index, self._launch)
        if rc != 0:
            raise RuntimeError(
                f"blocked {self.source} kernel launch failed "
                f"({self.plan.variant} variant, {self.plan.size} CTAs): "
                f"{self.lib.fem_blocked_error(rc).decode()}")
        if instance:
            count_launch(fn, *instance)
        else:
            fn.launches += 1
        fn.last_plan = self.plan
        fn.last_barriers = self.barriers
        key = (self.plan.variant, self.plan.size)
        fn.variant_launches[key] = fn.variant_launches.get(key, 0) + 1

    def _check_source(self, source: str) -> None:
        if source != self.source:
            raise ValueError(f"a binding of {self.source!r} launched as "
                             f"{source!r}")

    def __call__(self, K: torch.Tensor, x: torch.Tensor,
                 transpose_k: bool) -> torch.Tensor:
        """G(K)·x or G(Kᵀ)·x (N, d), a fresh tensor: one launch (on the
        CPU :func:`blocked_graph_apply_plain`)."""
        dev = self.dev
        if dev.type == "cpu":
            return blocked_graph_apply_plain(self.blk, K, x, transpose_k)
        self._check_source("apply")
        cuda_build.check_operand("x", x, (self.n, self.d), torch.float32, dev)
        cuda_build.check_operand("K", K, self.k_shape, torch.float32, dev)
        y = torch.empty((self.n, self.d), dtype=torch.float32, device=dev)
        a = self.args
        a.k, a.x, a.y = K.data_ptr(), x.data_ptr(), y.data_ptr()
        a.transpose = int(bool(transpose_k))
        self._run(blocked_graph_apply)
        return y

    def _layer(self, pos, ref_inv, params) -> None:
        """Patch a prep's or gradient's operands: positions, the layer's
        rest-edge inverses (the blocking's own when None), its numbers."""
        dev = self.dev
        cuda_build.check_operand("pos", pos, (self.n, self.d), torch.float32,
                                 dev)
        r = self.blk.ref_inv if ref_inv is None else ref_inv
        cuda_build.check_operand("ref_inv", r, self.k_shape, torch.float32,
                                 dev)
        a = self.args
        a.x, a.T.ref_inv, a.m = pos.data_ptr(), r.data_ptr(), params

    def prep(self, pos: torch.Tensor, ref_inv, params):
        """(K (B·Eb, d, d), the assembled −V·h force (N, d)) of one layer:
        one launch."""
        self._check_source("prep")
        self._layer(pos, ref_inv, params)
        k = torch.empty(self.k_shape, dtype=torch.float32, device=self.dev)
        f = torch.empty((self.n, self.d), dtype=torch.float32,
                        device=self.dev)
        self.args.k_out, self.args.y = k.data_ptr(), f.data_ptr()
        self._run(blocked_prep, self.d, self.mid)
        return k, f

    def grad(self, pos: torch.Tensor, ref_inv, params) -> torch.Tensor:
        """The assembled explicit gradient (N, d) of one layer: one
        launch."""
        self._check_source("grad")
        self._layer(pos, ref_inv, params)
        g = torch.empty((self.n, self.d), dtype=torch.float32,
                        device=self.dev)
        self.args.y = g.data_ptr()
        self._run(blocked_grad_prep, self.d, self.mid)
        return g

    def columns(self, cols: torch.Tensor) -> torch.Tensor:
        """The assembly (N, d) of block-ordered columns: one launch."""
        self._check_source("columns")
        cuda_build.check_operand("cols", cols, self.k_shape, torch.float32,
                                 self.dev)
        y = torch.empty((self.n, self.d), dtype=torch.float32,
                        device=self.dev)
        self.args.x, self.args.y = cols.data_ptr(), y.data_ptr()
        self._run(blocked_assemble)
        return y


# (id(blocking), cluster, grid, source, material) → the
# BlockedBinding built for them, which holds the blocking so that its id is
# not reused while it is kept.
_BINDINGS: dict = {}


def blocked_binding(blk: Blocking, cluster: int = 0, grid: bool = False,
                   source: str = "apply",
                   material_id: int = 0) -> BlockedBinding:
    """The :class:`BlockedBinding` of ``blk``, the source, its material and
    the forced variant, built once and built again when the blocking is
    replaced or changed in place."""
    key = (id(blk), int(cluster), bool(grid), source, int(material_id))
    hit = _BINDINGS.get(key)
    if hit is None or not hit.matches(blk):
        hit = BlockedBinding(blk, cluster, grid, source, material_id)
        if key not in _BINDINGS and len(_BINDINGS) >= 64:
            _BINDINGS.pop(next(iter(_BINDINGS)))
        _BINDINGS[key] = hit
    return hit


def _cuda(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the kernel (CUDA) rather than the plain version
    (CPU); raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def blocked_graph_apply(blk: Blocking, K: torch.Tensor, x: torch.Tensor,
                        transpose_k: bool = False, cluster: int = 0,
                        grid: bool = False) -> torch.Tensor:
    """G(K)·x (G(Kᵀ)·x when ``transpose_k``), (N, d): per block the
    element-Laplacian product of its K blocks, then each particle's sum over
    its block slots.

    CUDA tensors: one launch of the blocked operator, in the variant of
    :func:`blocked_plan` (``cluster`` forces the cluster variant with that
    many CTAs, ``grid`` the two-kernel variant; tests and
    ``chip_smoke.py``; a plan the device cannot run raises), with what is fixed per blocking bound once
    (:func:`blocked_binding`).  The launch's plan is left in
    ``blocked_graph_apply.last_plan`` and counted by (variant, CTAs) in
    ``variant_launches``; the barriers the cluster kernel met in
    ``blocked_graph_apply.last_barriers``, a (1,) int32 tensor on the device
    that the next cluster launch there overwrites (None after the
    two-kernel variant; :func:`blocked_barriers` says what it must hold).
    CPU tensors: :func:`blocked_graph_apply_plain`."""
    if not _cuda(x):
        return blocked_graph_apply_plain(blk, K, x, transpose_k)
    return blocked_binding(blk, cluster, grid, "apply", 0)(
        K, x, transpose_k)


def blocked_prep_force(blk: Blocking, pos: torch.Tensor, mu: float,
                       lam: float, ref_inv=None,
                       material: str = "neo_hookean", robust: bool = False,
                       cluster: int = 0, grid: bool = False):
    """(K (B·Eb, d, d), f (N, d)) of the implicit substep at ``pos``, of one
    material layer (``ref_inv`` as in :func:`blocked_prep`): K_e = −V·k and
    the assembled −V·h force — what the substep consumes.

    CUDA tensors: one launch of K2 (the instance of ``material``, robust
    Neo-Hookean when ``robust``) that ends in the per-particle sum, in the
    variant of :func:`blocked_plan` (``cluster`` and ``grid`` as in
    :func:`blocked_graph_apply`), bound once a blocking and material
    (:func:`blocked_binding`); counted on ``blocked_prep`` (its
    ``launches``, ``instance_launches``, ``variant_launches``,
    ``last_plan`` and ``last_barriers``).  CPU tensors:
    :func:`blocked_prep_force_plain`."""
    mid = kernel_material_id(material, robust)
    if not _cuda(pos):
        return blocked_prep_force_plain(blk, pos, mu, lam, ref_inv, material,
                                        robust)
    return blocked_binding(blk, cluster, grid, "prep", mid).prep(
        pos, ref_inv, material_params(material, mu, lam, blk.dim))


def blocked_grad_force(blk: Blocking, pos: torch.Tensor, mu: float,
                       lam: float, ref_inv=None,
                       material: str = "neo_hookean", cluster: int = 0,
                       grid: bool = False) -> torch.Tensor:
    """The assembled explicit energy gradient g (N, d) at ``pos``, of one
    material layer (``ref_inv`` as in :func:`blocked_prep`).

    CUDA tensors: one launch of K7b (the instance of ``material``) that
    ends in the per-particle sum, in the variant of :func:`blocked_plan`
    (``cluster`` and ``grid`` as in :func:`blocked_graph_apply`); counted on ``blocked_grad_prep`` as
    :func:`blocked_prep_force` is on ``blocked_prep``.  CPU tensors:
    :func:`blocked_grad_force_plain`."""
    mid = kernel_material_id(material)
    if not _cuda(pos):
        return blocked_grad_force_plain(blk, pos, mu, lam, ref_inv, material)
    return blocked_binding(blk, cluster, grid, "grad", mid).grad(
        pos, ref_inv, material_params(material, mu, lam, blk.dim))


def blocked_assemble(blk: Blocking, cols: torch.Tensor, cluster: int = 0,
                     grid: bool = False) -> torch.Tensor:
    """(N, d) assembly of block-ordered element columns ``cols`` (B·Eb, d, d):
    column j of each real slot to its local vertex j+1, −Σ_j to vertex 0,
    summed per block and then per particle over its block slots (padded
    slots contribute nothing).

    CUDA tensors: one launch of K7a in the variant of :func:`blocked_plan`
    (the cluster variant one kernel, the grid variant the per-block
    partials and the per-particle slot sums; ``cluster`` and ``grid`` as
    in :func:`blocked_graph_apply`), counted, with its plan and
    barriers, on ``blocked_assemble``.  CPU tensors:
    :func:`blocked_assemble_plain`."""
    if not _cuda(cols):
        return blocked_assemble_plain(blk, cols)
    return blocked_binding(blk, cluster, grid, "columns", 0).columns(cols)


for _fn in (blocked_graph_apply, blocked_prep, blocked_grad_prep,
            blocked_assemble):
    _fn.launches = 0
    _fn.variant_launches = {}
    _fn.last_plan = None
    _fn.last_barriers = None
blocked_prep.instance_launches = {}
blocked_grad_prep.instance_launches = {}


def blocked_system_applies(blk: Blocking, K, mass, dt: float,
                           beta: float = 0.0, apply=None, group=None):
    """(apply_a, apply_at) of the blocked operator A = I − c·M⁻¹·G(K),
    c = dt·(dt + ``beta``): A·v = v − c·G(K)·v/m and Aᵀ·v = v −
    c·G(Kᵀ)·(v/m), G through ``apply`` (the kernel's wrapper,
    :func:`blocked_graph_apply`, when None; the plain frame passes its
    plain version) on the block-ordered K (B·Eb, d, d).  With ``group``
    (element sharding: ``blk`` a rank's blocks, ``ops/blocking.
    shard_blocking``) each G·v is summed over the ranks, one all-reduce an
    apply."""
    if apply is None:
        apply = blocked_graph_apply
    if group is not None:
        local_apply = apply

        def apply(b, k, v, transpose_k):
            return all_reduce_sum(local_apply(b, k, v, transpose_k), group)

    minv = (1.0 / mass)[:, None]
    c = system_coeff(dt, beta)

    def apply_a(v):
        return v - c * apply(blk, K, v, False) * minv

    def apply_at(v):
        return v - c * apply(blk, K, v * minv, True)

    return apply_a, apply_at


def blocked_velocity_solve(
    blk: Blocking, prepped, vel, mass, dt: float, normal: bool, *,
    apply=None, beta: float = 0.0,
    cg_precond: str = "reference", diag_fn=None, free=None, pin_vel=None,
    max_iter: int = 500, tol: float = 1e-5, two_level_fn=None, group=None,
) -> CGResult:
    """One implicit velocity solve over the blocks (the JAX package's
    blocked branch, solvers/implicit.py:1080-1101) from the prep's
    ``prepped`` = (K, the assembled force f): b = v + dt·f/m, then
    ``cg_solve_dispatch`` over :func:`blocked_system_applies`: the
    reference CG (x₀ = b; normal equations when ``normal``), or with
    ``cg_precond`` ``"block_jacobi"`` the PCG on the blocks ``diag_fn()``,
    or ``"two_level…"`` the two-level PCG on them and ``two_level_fn()``,
    and the pin projection by ``free``/``pin_vel``.  ``apply`` and
    ``group`` as in :func:`blocked_system_applies` (``f`` is already
    summed over the ranks)."""
    K, f = prepped
    b = vel + dt * f * (1.0 / mass)[:, None]
    apply_a, apply_at = blocked_system_applies(blk, K, mass, dt, beta, apply,
                                               group)
    return cg_solve_dispatch(
        apply_a, lambda: apply_at, b, int(bool(normal)), cg_precond, diag_fn,
        mass, free, pin_vel, max_iter, tol, two_level_fn)
