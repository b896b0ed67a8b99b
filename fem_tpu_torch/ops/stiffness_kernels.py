# coding=utf-8
"""H1: the exact elastic stiffness applied to a block of columns, one call
of the kernel library an apply.

``stiffness_apply`` launches the hand-written CUDA kernel of
``fem_tpu_torch/csrc/stiffness_apply.cu`` for tensors on a CUDA device.  It
replaces no TPU kernel: the JAX package takes the same product as
``jax.jvp`` of the assembled analytic force (its solvers/modal.py:68,
``make_stiffness_hvp``), vmapped over a block of columns, which XLA
compiles.  The port forms each element's Jacobian J of its force (or
gradient) columns in its d edge vectors once
(``solvers/implicit.element_linearization``), and an apply is then

    dw    = the edge differences of W     (E, d², c): w_{j+1} − w_0
    dcols = J · dw                        (E, d², c), read as (E, d, d, c)
    rows  = element_contrib_full(dcols)   row 0 = −Σ columns, rows 1..d
    out   = each particle's rows summed in the order of its plan slots

for W of shape (N, d, c), or (N, d) for one column.  The modal analyses,
buckling, the static solve and exact Newton all apply it through
``element_linearization``.

For tensors on the CPU it runs its plain PyTorch version,
:func:`stiffness_apply_plain`: the gather and edge differences, a batched
``torch.matmul``, the vertex-0 sum and ``gather_assemble`` through the
padded plan.  On CUDA
``stiffness_apply`` launches the kernel or raises; it never falls back.
``stiffness_apply.launches`` counts the launched applies (one C call
each: the rows variant's two kernels, the slots variant's one),
``variant_launches`` by (dtype, d), and ``last_plan`` holds the last
launch's :class:`StiffnessPlan`.

The kernel takes float32 and float64 (the H100 has native f64: the f64
modal refinement and residuals run it on the card), d ∈ {2, 3}, any column
count.  Two variants, bit-identical (:data:`VARIANTS`): ``"rows"``, the
default, computes each element's rows once into a scratch buffer in the
plan's slot order (through the binding's ``slot_of_row``, the inverse of
the plan's rows), then sums each particle's contiguous slots in order;
``"slots"``, the first design, runs one thread an output entry that walks
its particle's plan slots in order and recomputes each slot's element row
from J_e and the element's edge differences of W.  Both take each row in
the plain version's order within the row; no atomics, so two runs are
bit-identical.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from fem_tpu_torch.ops.assembly import element_contrib_full, gather_assemble
from fem_tpu_torch.utils import cuda_build

_P = ctypes.c_void_p
_I = ctypes.c_int

THREADS = 128  # csrc/stiffness_apply.cu: kThreads
DTYPES = {torch.float32: 0, torch.float64: 1}
_NAMES = {torch.float32: "f32", torch.float64: "f64"}
# The element rows once into slot order, then the per-particle sums (the
# default); the first design, each slot's row recomputed by its particle.
VARIANTS = ("rows", "slots")
_GRID = 2 ** 31 - 1


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown H1 variant {variant!r}; one of "
                         f"{VARIANTS}")


class StiffnessPlan(NamedTuple):
    dim: int
    columns: int
    dtype: str  # "f32" or "f64"
    threads: int  # a CTA
    ctas: int  # one thread an output entry: phase B's, or the slots kernel's
    variant: str
    row_ctas: int  # phase A's, one thread an (element, component, column)


@functools.lru_cache(maxsize=256)
def stiffness_plan(n: int, d: int, columns: int, dtype: torch.dtype,
                   elements: int, variant: str = "rows") -> StiffnessPlan:
    """H1's launch for ``n`` particles and ``elements`` elements in ``d``
    dimensions and ``columns`` columns of ``dtype``, CTAs of
    :data:`THREADS`: the slots variant one thread an output entry; the
    rows variant phase A's thread an (element, component, column), then
    phase B's thread an output entry.  Raises ``ValueError`` for what the
    kernels do not take: d ∉ {2, 3}, no particle, element or column, a
    dtype other than float32 or float64, a variant not in
    :data:`VARIANTS`, or more CTAs than a grid holds.  Pure: no device is
    asked."""
    _check_variant(variant)
    if elements < 1:
        raise ValueError(f"H1 needs an element, got {elements}")
    if d not in (2, 3):
        raise ValueError(f"H1 takes dim 2 or 3, not {d}")
    if n < 1:
        raise ValueError(f"H1 needs a particle, got {n}")
    if columns < 1:
        raise ValueError(f"H1 needs a column, got {columns}")
    if dtype not in DTYPES:
        raise ValueError(f"H1 takes float32 or float64, not {dtype}")
    ctas = -(-n * d * columns // THREADS)
    if ctas > _GRID:
        raise ValueError(f"H1: {n} x {d} x {columns} entries pass a grid")
    row_ctas = 0
    if variant == "rows":
        row_ctas = -(-elements * d * columns // THREADS)
        if row_ctas > _GRID:
            raise ValueError(f"H1: {elements} x {d} x {columns} element "
                             "rows pass a grid")
    return StiffnessPlan(d, columns, _NAMES[dtype], THREADS, ctas, variant,
                         row_ctas)


def stiffness_apply_plain(jac: torch.Tensor, w: torch.Tensor,
                          element_indices: torch.Tensor,
                          plan_idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`stiffness_apply`: K·w for ``w`` of
    shape (N, d) or (N, d, c), from the element Jacobians ``jac`` (E, d²,
    d²) in the edge vectors, through the padded gather plan ``plan_idx``."""
    e, dp1 = element_indices.shape
    d = dp1 - 1
    we = w[element_indices.long()]  # (E, d+1, d[, c])
    dw = we[:, 1:] - we[:, :1]  # edge j, component a: row j·d + a
    if w.dim() == 2:
        dcols = torch.matmul(jac, dw.reshape(e, d * d, 1)).reshape(e, d, d)
        return gather_assemble(element_contrib_full(dcols), plan_idx)
    c = w.shape[-1]
    dcols = torch.matmul(jac, dw.reshape(e, d * d, c)).reshape(e, d, d, c)
    v0 = dcols[:, :, 0]
    for j in range(1, d):
        v0 = v0 + dcols[:, :, j]
    # Row l ≥ 1 is column l − 1, row 0 −Σ columns: (E, d+1, d, c).
    rows = torch.cat([-v0[:, None], dcols.permute(0, 2, 1, 3)], dim=1)
    return gather_assemble(rows.reshape(e, dp1, d * c),
                           plan_idx).reshape(-1, d, c)


def slot_order(rows: torch.Tensor) -> torch.Tensor:
    """The inverse of the gather plan's ``rows`` (E·(d+1),) int32, on its
    device: ``slot_order(rows)[r]`` is the slot that holds row r, so that
    ``rows[slot_order(rows)[r]] == r``.  One scatter of ``arange``."""
    slot = torch.empty_like(rows)
    slot[rows.long()] = torch.arange(rows.numel(), dtype=rows.dtype,
                                     device=rows.device)
    return slot


class StiffnessBinding:
    """One linearization's operands, checked and laid out once: the element
    Jacobians ``jac`` (E, d², d²), the element table (int32) and the
    gather plan (its padded form for the plain version, its CSR form for
    the kernels), all on ``jac``'s device, with the rows variant's slot
    order (``slot_of_row``, the inverse of the plan's rows), built here
    once."""

    def __init__(self, jac: torch.Tensor, element_indices: torch.Tensor,
                 plan):
        e, dp1 = element_indices.shape
        self.d = dp1 - 1
        self.e = e
        self.n = plan.idx.shape[0]
        self.plan_idx = plan.idx
        self.element_indices = element_indices
        self.jac = jac
        self.slot_of_row = slot_order(plan.rows)
        if jac.device.type == "cuda":
            dev = jac.device
            d, k = self.d, self.d * self.d
            if jac.dtype not in DTYPES:
                raise TypeError(f"H1 takes float32 or float64, not "
                                f"{jac.dtype}")
            self.jac = jac.contiguous()
            self.elem = element_indices.to(torch.int32).contiguous()
            cuda_build.check_operand("jac", self.jac, (e, d * d, k),
                                     jac.dtype, dev)
            cuda_build.check_operand("element_indices", self.elem, (e, dp1),
                                     torch.int32, dev)
            cuda_build.check_operand("ptr", plan.ptr, (self.n + 1,),
                                     torch.int32, dev)
            cuda_build.check_operand("rows", plan.rows, (e * dp1,),
                                     torch.int32, dev)
            self.ptr, self.rows = plan.ptr, plan.rows


# The stiffness_apply library with its entry's argument types, loaded at
# the first launch.
_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("stiffness_apply")
        lib.fem_stiffness_apply.argtypes = [_I, _I, _P, _P, _P, _P, _P, _I,
                                            _I, _P, _P]
        lib.fem_stiffness_apply.restype = _I
        lib.fem_stiffness_apply_two_phase.argtypes = [
            _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P]
        lib.fem_stiffness_apply_two_phase.restype = _I
        lib.fem_stiffness_threads.argtypes = []
        lib.fem_stiffness_threads.restype = _I
        lib.fem_stiffness_error.argtypes = [_I]
        lib.fem_stiffness_error.restype = ctypes.c_char_p
        if lib.fem_stiffness_threads() != THREADS:
            raise RuntimeError("csrc/stiffness_apply.cu's kThreads differs "
                               f"from THREADS = {THREADS}")
        _LIB = lib
    return _LIB


def stiffness_apply(binding: StiffnessBinding, w: torch.Tensor,
                    variant: str = "rows") -> torch.Tensor:
    """K·w for ``w`` (N, d) or (N, d, c) of the binding's dtype, the same
    shape out.  CUDA tensors: one launch of H1 in ``variant`` (the rows
    variant's two kernels from one call, the slots variant's one kernel)
    on :func:`stiffness_plan`'s plan (left in
    ``stiffness_apply.last_plan``); nothing is read back.  CPU tensors:
    :func:`stiffness_apply_plain`."""
    _check_variant(variant)
    if w.device.type == "cpu":
        return stiffness_apply_plain(binding.jac, w, binding.element_indices,
                                     binding.plan_idx)
    dev = w.device
    if dev.type != "cuda" or binding.jac.device != dev:
        raise ValueError(f"H1: w on {dev}, the linearization on "
                         f"{binding.jac.device}")
    n, d, e = binding.n, binding.d, binding.e
    c = 1 if w.dim() == 2 else w.shape[-1]
    shape = (n, d) if w.dim() == 2 else (n, d, c)
    dtype = binding.jac.dtype
    cuda_build.check_operand("w", w, shape, dtype, dev)
    plan = stiffness_plan(n, d, c, dtype, e, variant)
    out = torch.empty_like(w)
    lib = _library()
    if variant == "rows":
        scratch = torch.empty((e * (d + 1), d, c), dtype=dtype, device=dev)
        rc = cuda_build.launch_on_stream(
            dev, dev.index, lib.fem_stiffness_apply_two_phase, d,
            DTYPES[dtype], binding.jac.data_ptr(), w.data_ptr(),
            binding.elem.data_ptr(), binding.slot_of_row.data_ptr(),
            binding.ptr.data_ptr(), e, n, c, scratch.data_ptr(),
            out.data_ptr())
    else:
        rc = cuda_build.launch_on_stream(
            dev, dev.index, lib.fem_stiffness_apply, d, DTYPES[dtype],
            binding.jac.data_ptr(), w.data_ptr(), binding.elem.data_ptr(),
            binding.ptr.data_ptr(), binding.rows.data_ptr(), n, c,
            out.data_ptr())
    if rc != 0:
        raise RuntimeError(
            f"H1 kernel launch failed: {lib.fem_stiffness_error(rc).decode()}")
    stiffness_apply.launches += 1
    key = (plan.dtype, d)
    stiffness_apply.variant_launches[key] = (
        stiffness_apply.variant_launches.get(key, 0) + 1)
    stiffness_apply.last_plan = plan
    return out


stiffness_apply.launches = 0
stiffness_apply.variant_launches = {}  # launches by (dtype, d)
stiffness_apply.last_plan = None
