# coding=utf-8
"""J1: the serial weighted-Jacobi solve, one launch a solve.

``jacobi_serial`` launches the hand-written CUDA kernels of
``fem_tpu_torch/csrc/jacobi_serial.cu`` for tensors on a CUDA device.  They
replace no TPU kernel: the JAX package runs the same solve as one XLA
program (``_jacobi_outer_loop`` around the row ``lax.scan`` of
``jacobi_solve_serial_sparse`` or ``jacobi_solve_serial``, its
solvers/implicit.py:737, :888 and :801), and the kernels keep that solve on
the device: the outer loop, every sweep, the error, the rollback and the
stop test, with no host read before it ends.  Its two row sources are the
block-sparse rows ``(nb_ids (N, max_nb), blocks (N, max_nb, d, d))`` of
``solvers/implicit.sparse_system_rows`` and the dense rows ``a_dense``
(N·d, N·d) of ``solvers/dense.assemble_dense_system``.  Two variants, the
choice :func:`jacobi_plan`'s:

* ``"levels"`` (the sparse rows, and the dense rows given their
  structural pattern): the sweep follows :func:`level_plan`'s level
  schedule — the rows whose lower neighbours are all done run together,
  a warp a row, one CTA barrier a level — and reads the x values the
  serial sweep reads, so its outputs are bit-identical to the serial
  variant's (the flagship: 70 dependent levels a sweep, not 1,007 rows).
  A dense row reads every column, so over the dense rows the schedule
  relies on the pattern: every nonzero block of A lies in it (row i's
  blocks in the columns ``pattern[i]``), besides the diagonal block of a
  particle that belongs to no element, which the row reads as the serial
  sweep does.  The other columns are structural zeros, where the old and
  the new x_j give the same zero (x finite; a zero's sign aside).
  ``solvers/dense`` builds A from exactly those rows and passes its
  Jacobi table;
* ``"serial"`` (the dense rows with no pattern, and the rows whose level
  tables would not fit beside x in one CTA): the sweep on one warp, one
  row after another.

For tensors on the CPU it runs its plain PyTorch version,
``jacobi_serial_plain``: the JAX scan's row loop inside the outer loop,
which reads the error on the host once a sweep.  ``jacobi_levels_plain``
is the level schedule in PyTorch, one batched update a level, which shows
on the CPU that the schedule keeps the serial semantics; it is no path's.
On CUDA ``jacobi_serial`` launches a kernel or raises; it never falls
back.  ``jacobi_serial.launches`` counts the launches.

The module also holds the outer loop the port's other Jacobi solves share
(:func:`jacobi_outer_loop`: the snapshot sweep of ``solvers/implicit`` and
of the dense backend).

Semantics (reference solver/implicit.py:226-261, 391-404; PARITY.md):
x₀ = 0.5·b; the error ‖b − A·x‖ (not squared) against ``tol``, at most
``max_iter`` sweeps; a sweep whose error does not fall is rolled back to the
last accepted iterate and ends the solve; the accepted iterate is the next
solve's relaxation anchor ``past_x``.  In the serial sweep row i reads the
x_j already updated this sweep for j < i and the full old x_i, adds back
only the scalar diagonal A_ii[k,k], relaxes by ω = 0.75 anchored on
``past_x``, and zeroes the components with |A_ii[k,k]| < 1e-6.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from fem_tpu_torch.utils import cuda_build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

OMEGA = 0.75
TOL = 1e-5
MAX_ITER = 20000


class JacobiResult(NamedTuple):
    x: torch.Tensor
    past_x: torch.Tensor  # the accepted iterate: the next solve's anchor
    iterations: torch.Tensor  # int32 scalar
    error: torch.Tensor  # final ‖b − A·x‖, scalar of x's dtype


def jacobi_outer_loop(
    once: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    error: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    past_x: torch.Tensor,
    tol: float = TOL,
    max_iter: int = MAX_ITER,
) -> JacobiResult:
    """The reference's outer iteration (the JAX package's
    ``_jacobi_outer_loop``): x₀ = 0.5·b, ``error`` recomputed each sweep
    ``once(x, past)``, the rollback-and-stop when it does not fall, the
    accepted iterate kept as the next anchor.  A Python loop that reads the
    error on the host once a sweep."""
    x = 0.5 * b
    err = error(x)
    p_err = err
    past = past_x
    it = 0
    done = False
    while not done and bool(err > tol) and it < max_iter:
        x1 = once(x, past)
        e1 = error(x1)
        done = bool(e1 >= p_err)
        if done:
            x = past
        else:
            x = past = x1
            p_err = e1
        err = e1
        it += 1
    return JacobiResult(
        x, past, torch.tensor(it, dtype=torch.int32, device=b.device), err)


def _row_matrices(rows: torch.Tensor, nb_ids, n: int, d: int):
    """(R (N, d, K), cols (N, K) or None): row i's product is
    R[i] @ x_flat[cols[i]] (sparse: K = max_nb·d, R[i][k, s·d + j] =
    blocks[i, s, k, j], cols the flat x index of each slot's components;
    padded slots, nb −1, read x₀ through zero blocks) or R[i] @ x_flat
    (dense: K = N·d)."""
    if nb_ids is None:
        return rows.reshape(n, d, n * d), None
    max_nb = nb_ids.shape[1]
    r = rows.permute(0, 2, 1, 3).reshape(n, d, max_nb * d)
    nb = nb_ids.long().clamp(min=0)
    cols = (nb[:, :, None] * d + torch.arange(d, device=nb.device))
    return r, cols.reshape(n, -1)


def _diagonal_of(rows: torch.Tensor, nb_ids, n: int, d: int) -> torch.Tensor:
    """(N, d): the scalar diagonal A_ii[k,k] — of the self slot's block
    (nb_ids == i; zero for a particle in no element) or of a_dense."""
    if nb_ids is None:
        return torch.diagonal(rows).reshape(n, d)
    ids = torch.arange(n, dtype=nb_ids.dtype, device=nb_ids.device)
    self_slot = (nb_ids == ids[:, None])[..., None, None]
    diag_blocks = torch.where(self_slot, rows, 0.0).sum(dim=1)
    return torch.diagonal(diag_blocks, dim1=-2, dim2=-1)


def jacobi_serial_plain(rows, b, past_x, nb_ids=None, omega: float = OMEGA,
                        tol: float = TOL, max_iter: int = MAX_ITER
                        ) -> JacobiResult:
    """Plain PyTorch version of :func:`jacobi_serial`: the row loop of the
    JAX package's scan inside :func:`jacobi_outer_loop`.  Row i is three
    in-place ops on views: b_i − R_i·x (one ``addmv`` of its (d, K) row
    matrix on the x it gathers), + A_ii[k,k]·x_i, then (ω·num)/A_ii[k,k] +
    (1 − ω)·past_i written over x_i (one ``addcdiv``); a row with a
    component under the 1e-6 diagonal takes a ``where`` that zeroes it."""
    n, d = b.shape
    r_mat, cols = _row_matrices(rows, nb_ids, n, d)
    diag = _diagonal_of(rows, nb_ids, n, d)
    safe = diag.abs() >= 1e-6
    safe_diag = torch.where(safe, diag, 1.0)
    per_row = list(zip(range(n), r_mat.unbind(0), b.unbind(0),
                       diag.unbind(0), safe_diag.unbind(0), safe.unbind(0),
                       safe.all(dim=1).tolist(),
                       [None] * n if cols is None else cols.unbind(0)))

    def once(x, past):
        xf = x.reshape(-1).clone()
        rest = ((1.0 - omega) * past).unbind(0)
        for i, r_i, b_i, dg_i, sd_i, sf_i, all_safe, c_i in per_row:
            xi = xf[i * d:(i + 1) * d]
            num = torch.addmv(b_i, r_i, xf if c_i is None else xf[c_i],
                              alpha=-1.0)
            num = torch.addcmul(num, dg_i, xi)
            if all_safe:
                torch.addcdiv(rest[i], num, sd_i, value=omega, out=xi)
            else:
                xi.copy_(torch.where(
                    sf_i, torch.addcdiv(rest[i], num, sd_i, value=omega),
                    0.0))
        return xf.reshape(n, d)

    if nb_ids is None:
        def error(x):
            r = b.reshape(-1) - rows @ x.reshape(-1)
            return torch.sqrt(torch.sum(r * r))
    else:
        nb = nb_ids.long().clamp(min=0)

        def error(x):
            r = b - torch.einsum("nkij,nkj->ni", rows, x[nb])
            return torch.sqrt(torch.sum(r * r))

    return jacobi_outer_loop(once, error, b, past_x, tol, max_iter)


class LevelPlan(NamedTuple):
    """The level schedule of a neighbour table (:func:`level_plan`) and the
    rows each of the kernel's 32 warps takes: within a level warp w takes
    the level's rows w, w + 32, ...; positions index ``order``."""

    order: np.ndarray  # (N,) int32: the rows by level, ascending in a level
    level_start: np.ndarray  # (L + 1,) int32: level l's rows' positions
    levels: int  # L
    next_row: np.ndarray  # (N,) int32: the next position of p's warp, or -1
    first_row: np.ndarray  # (32,) int32: each warp's first position, or -1


LEVEL_WARPS = 32  # csrc/jacobi_serial.cu: kLevelThreads / 32


def level_plan(nb_ids) -> LevelPlan:
    """The level schedule of the serial sweep over the neighbour table
    ``nb_ids`` (N, max_nb), padded with −1: level(i) = 1 + the largest
    level of the j < i with j ∈ nb[i] or i ∈ nb[j], 0 when there is none.
    Rows of one level share no entry, and each row's lower neighbours lie
    in earlier levels and its upper ones in later levels, so running a
    level's rows together reads the same x values as the serial sweep: the
    new x_j for j < i, the old x_j for j > i.  Both directions are taken,
    so an asymmetric table keeps that too.  Pure: a host numpy pass, no
    device asked."""
    nb = np.asarray(nb_ids.cpu() if isinstance(nb_ids, torch.Tensor)
                    else nb_ids, dtype=np.int64)
    n = nb.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), nb.shape[1])
    cols = nb.reshape(-1)
    keep = (cols >= 0) & (cols != rows)
    lo = np.minimum(rows[keep], cols[keep])
    hi = np.maximum(rows[keep], cols[keep])
    by_hi = np.lexsort((lo, hi))
    lo, hi = lo[by_hi], hi[by_hi]
    ptr = np.searchsorted(hi, np.arange(n + 1))
    level = np.zeros(n, dtype=np.int64)
    for i in range(n):
        lower = lo[ptr[i]:ptr[i + 1]]
        if lower.size:
            level[i] = level[lower].max() + 1
    order = np.argsort(level, kind="stable").astype(np.int32)
    counts = np.bincount(level, minlength=1)
    start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    # Position p of level l is warp (p − start[l]) % 32's; a warp takes its
    # positions in ascending order.
    pos = np.arange(n, dtype=np.int64)
    warp = (pos - np.repeat(start[:-1], counts)) % LEVEL_WARPS
    by_warp = np.lexsort((pos, warp))
    same = warp[by_warp[1:]] == warp[by_warp[:-1]]
    next_row = np.full(n, -1, dtype=np.int32)
    next_row[by_warp[:-1][same]] = by_warp[1:][same]
    first_row = np.full(LEVEL_WARPS, -1, dtype=np.int32)
    firsts = by_warp[np.concatenate([[True], ~same])]
    first_row[warp[firsts]] = firsts
    return LevelPlan(order, start, int(counts.size), next_row, first_row)


def jacobi_levels_plain(rows, b, past_x, nb_ids, omega: float = OMEGA,
                        tol: float = TOL, max_iter: int = MAX_ITER,
                        plan: Optional[LevelPlan] = None,
                        pattern=None) -> JacobiResult:
    """The serial sweep run level by level (:func:`level_plan`, or
    ``plan``), in plain PyTorch inside :func:`jacobi_outer_loop`: over the
    sparse rows of ``nb_ids``, or with ``nb_ids`` None over the dense rows
    ``rows`` (N·d, N·d) on the schedule of their structural ``pattern``
    (module docstring).  A level is one batched product b − R·x (over the
    gathered x, or every column), + A_ii[k,k]·x_i and one update.  It shows
    on the CPU that the level schedule keeps the serial semantics; its sums
    are batched, so it agrees with :func:`jacobi_serial_plain` to
    rounding."""
    if nb_ids is None and pattern is None:
        raise ValueError("the level schedule takes the sparse rows "
                         "(nb_ids), or the dense rows with their pattern")
    if nb_ids is not None and pattern is not None:
        raise ValueError("a pattern goes with the dense rows, not with "
                         "nb_ids")
    n, d = b.shape
    plan = level_plan(pattern if nb_ids is None else nb_ids) \
        if plan is None else plan
    r_mat, cols = _row_matrices(rows, nb_ids, n, d)
    diag = _diagonal_of(rows, nb_ids, n, d)
    safe = diag.abs() >= 1e-6
    safe_diag = torch.where(safe, diag, 1.0)
    order = torch.as_tensor(plan.order, dtype=torch.int64, device=b.device)
    per_level = []
    for lo, hi in zip(plan.level_start[:-1].tolist(),
                      plan.level_start[1:].tolist()):
        r = order[lo:hi]
        per_level.append((r, r_mat[r], None if cols is None else cols[r],
                          b[r], diag[r], safe_diag[r], safe[r]))

    def once(x, past):
        x = x.clone()
        xf = x.reshape(-1)
        rest = (1.0 - omega) * past
        for r, r_r, c_r, b_r, dg_r, sd_r, sf_r in per_level:
            if c_r is None:
                prod = torch.matmul(r_r, xf)
            else:
                prod = torch.bmm(r_r, xf[c_r].unsqueeze(-1)).squeeze(-1)
            num = torch.addcmul(b_r - prod, dg_r, x[r])
            new = torch.addcdiv(rest[r], num, sd_r, value=omega)
            x[r] = torch.where(sf_r, new, 0.0)
        return x

    if nb_ids is None:
        def error(x):
            res = b.reshape(-1) - rows @ x.reshape(-1)
            return torch.sqrt(torch.sum(res * res))
    else:
        nb = nb_ids.long().clamp(min=0)

        def error(x):
            res = b - torch.einsum("nkij,nkj->ni", rows, x[nb])
            return torch.sqrt(torch.sum(res * res))

    return jacobi_outer_loop(once, error, b, past_x, tol, max_iter)


class JacobiPlan(NamedTuple):
    """A launch of J1: one CTA of ``threads``."""

    dense: bool
    slots: int  # a lane's slots of a sparse row (0 for the dense rows)
    threads: int
    smem: int  # dynamic shared memory: x, b, past, the diagonal and more
    variant: str = "serial"  # "serial" or "levels"
    levels: int = 0  # the level variant's L
    staged: bool = False  # the level variant's rows staged in shared memory


# csrc/jacobi_serial.cu's kThreads and kLevelThreads, and the dynamic shared
# memory limit (a CTA's 227 KB less 1 KB kept for the static reduction).
SERIAL_THREADS = 512
LEVEL_THREADS = 1024
SERIAL_MAX_SMEM = 232448 - 1024
VARIANTS = ("levels", "serial")


@functools.lru_cache(maxsize=64)
def serial_plan(n: int, d: int, max_nb: Optional[int]) -> JacobiPlan:
    """The serial variant's launch for ``n`` particles in ``d`` dimensions
    over the sparse rows of ``max_nb`` slots (None: the dense rows).
    Raises ``ValueError`` for what the kernel does not take: d ∉ {2, 3}, no
    particle, more than 128 slots a row, or x, b, past and the diagonal
    past a CTA's shared memory (4·N·d floats: N·d ≤ 14,464).  Pure: no
    device is asked."""
    if d not in (2, 3):
        raise ValueError(f"J1 takes dim 2 or 3, not {d}")
    if n < 1:
        raise ValueError(f"J1 needs a particle, got {n}")
    smem = 4 * 4 * n * d
    if smem > SERIAL_MAX_SMEM:
        raise ValueError(
            f"J1 keeps x, b, past and the diagonal in one CTA's shared "
            f"memory: {smem} bytes for {n} particles in {d}D, past "
            f"{SERIAL_MAX_SMEM}")
    if max_nb is None:
        return JacobiPlan(True, 0, SERIAL_THREADS, smem)
    slots = next((s for s in (1, 2, 4) if max_nb <= 32 * s), None)
    if slots is None or max_nb < 1:
        raise ValueError(f"J1 takes 1-128 slots a row, not {max_nb}")
    return JacobiPlan(False, slots, SERIAL_THREADS, smem)


@functools.lru_cache(maxsize=64)
def jacobi_plan(n: int, d: int, max_nb: Optional[int],
                levels: Optional[int] = None,
                variant: Optional[str] = None) -> JacobiPlan:
    """J1's launch for ``n`` particles in ``d`` dimensions over the sparse
    rows of ``max_nb`` slots and ``levels`` levels (:func:`level_plan`), or
    with ``max_nb`` None over the dense rows, on the schedule of their
    pattern's ``levels`` levels where it is given.

    The level variant takes the rows whenever x, b, past, the diagonal,
    the residual (5·N·d floats) and the level tables (the order, the next
    rows, the first rows and the level starts: 2·N + L + 33 ints) fit one
    CTA's shared memory, the sparse rows staged there too where they also
    fit (``default.json``'s 13.5 KB; the flagship's 1.05 MB are read from
    L2); the dense rows are read from L2 (``default.json``'s 234 KB pass a
    CTA's 227 KB).  The dense rows with no level count (no pattern) stay
    serial: a dense row reads every column, so its schedule is exact only
    through A's structural zeros, which only the pattern shows.  Over the
    dense rows a warp's product reads every x_j while other warps of its
    level write theirs; that gives the serial bits only because those
    columns are zeros and 0·x_j is a zero for a finite x_j.  Once x holds
    an inf or a NaN, 0·x_j is a NaN or a zero depending on the timing, so
    a solve that diverges runs nondeterministically there and may part
    from the serial variant and the JAX package.  The serial variant also
    takes the rows whose level tables do not fit.
    ``variant`` forces one ("serial" or "levels"); a variant that cannot
    run raises ``ValueError``, as does anything :func:`serial_plan`
    refuses.  Pure: no device is asked."""
    if variant not in (None,) + VARIANTS:
        raise ValueError(f"unknown J1 variant {variant!r}; one of "
                         f"{VARIANTS}")
    base = serial_plan(n, d, max_nb)
    if variant == "serial":
        return base
    dense = max_nb is None
    if dense and levels is None:
        if variant == "levels":
            raise ValueError("J1's level variant takes the sparse rows, or "
                             "the dense rows with their pattern; the dense "
                             "rows alone run the serial variant")
        return base
    if levels is None or levels < 1:
        raise ValueError(f"J1's level variant needs the level count, not "
                         f"{levels}")
    smem = 4 * (5 * n * d + 2 * n + levels + 1 + LEVEL_WARPS)
    if smem > SERIAL_MAX_SMEM:
        if variant == "levels":
            raise ValueError(
                f"J1's level variant keeps x, b, past, the diagonal, the "
                f"residual and the level tables in one CTA's shared memory: "
                f"{smem} bytes for {n} particles and {levels} levels, past "
                f"{SERIAL_MAX_SMEM}")
        return base
    if dense:
        return JacobiPlan(True, 0, LEVEL_THREADS, smem, "levels", levels)
    rows_bytes = 4 * n * max_nb * (d * d + 1)
    staged = smem + rows_bytes <= SERIAL_MAX_SMEM
    return JacobiPlan(False, base.slots, LEVEL_THREADS,
                      smem + (rows_bytes if staged else 0), "levels", levels,
                      staged)


class LevelBinding:
    """A neighbour table's :func:`level_plan` and its tables (the order, the
    next and first rows, the level starts) as int32 tensors on the table's
    device, built once a table and built again when the table is replaced
    or changed in place."""

    def __init__(self, nb_ids: torch.Tensor):
        self.nb_ids = nb_ids
        self.version = nb_ids._version
        self.plan = level_plan(nb_ids)
        dev = nb_ids.device
        self.order = torch.as_tensor(self.plan.order, device=dev)
        self.next_row = torch.as_tensor(self.plan.next_row, device=dev)
        self.first_row = torch.as_tensor(self.plan.first_row, device=dev)
        self.level_start = torch.as_tensor(self.plan.level_start,
                                           device=dev)

    def matches(self, nb_ids: torch.Tensor) -> bool:
        return nb_ids is self.nb_ids and nb_ids._version == self.version


# Level bindings by the id of their table (which each binding holds, so
# that the id is not reused while it is kept).
_LEVEL_BINDINGS: dict = {}


def level_binding(nb_ids: torch.Tensor) -> LevelBinding:
    """The :class:`LevelBinding` of ``nb_ids``, built once a table."""
    hit = _LEVEL_BINDINGS.get(id(nb_ids))
    if hit is None or not hit.matches(nb_ids):
        hit = LevelBinding(nb_ids)
        if id(nb_ids) not in _LEVEL_BINDINGS and len(_LEVEL_BINDINGS) >= 32:
            _LEVEL_BINDINGS.pop(next(iter(_LEVEL_BINDINGS)))
        _LEVEL_BINDINGS[id(nb_ids)] = hit
    return hit


# The jacobi_serial library with its entries' argument types, loaded at
# the first launch.
_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("jacobi_serial")
        lib.fem_jacobi_serial.argtypes = [
            _I, _I, _I, _P, _P, _P, _P, _I, _I, _F, _F, _I, _P, _P, _P, _P,
            _P,
        ]
        lib.fem_jacobi_serial.restype = _I
        lib.fem_jacobi_levels.argtypes = [
            _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
            _F, _I, _P, _P, _P, _P, _P, _P, _P,
        ]
        lib.fem_jacobi_levels.restype = _I
        lib.fem_jacobi_error.argtypes = [_I]
        lib.fem_jacobi_error.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(rows, b, past_x, nb_ids):
    """(N, d, max_nb or None, device) of a launch, after checking what the
    kernel takes: f32 rows, b and past_x, int32 nb_ids, contiguous, on one
    CUDA device, of the module's shapes."""
    dev = b.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n, d = b.shape
    f32 = torch.float32
    cuda_build.check_operand("b", b, (n, d), f32, dev)
    cuda_build.check_operand("past_x", past_x, (n, d), f32, dev)
    if nb_ids is None:
        cuda_build.check_operand("a_dense", rows, (n * d, n * d), f32, dev)
        return n, d, None, dev
    max_nb = nb_ids.shape[1] if nb_ids.dim() == 2 else -1
    cuda_build.check_operand("nb_ids", nb_ids, (n, max_nb), torch.int32, dev)
    cuda_build.check_operand("blocks", rows, (n, max_nb, d, d), f32, dev)
    return n, d, max_nb, dev


def jacobi_serial(rows: torch.Tensor, b: torch.Tensor, past_x: torch.Tensor,
                  nb_ids: Optional[torch.Tensor] = None,
                  omega: float = OMEGA, tol: float = TOL,
                  max_iter: int = MAX_ITER,
                  variant: Optional[str] = None,
                  clocks: Optional[torch.Tensor] = None,
                  pattern: Optional[torch.Tensor] = None) -> JacobiResult:
    """The serial weighted-Jacobi solve of A·x = b (module docstring) over
    the block-sparse rows ``rows`` (N, max_nb, d, d) of the neighbours
    ``nb_ids`` (N, max_nb) int32, or with ``nb_ids`` None over the dense
    rows ``rows`` (N·d, N·d), whose structural ``pattern`` (N, k) int32,
    where given, is a neighbour table that holds every nonzero block of A
    (module docstring); ``b`` and ``past_x`` (N, d).  Returns
    :class:`JacobiResult`, its iterations and error device tensors.

    CUDA tensors: one launch of J1 on :func:`jacobi_plan`'s plan (the
    level variant for the sparse rows and for the dense rows with a
    pattern, the table's :func:`level_plan` bound once; ``variant`` forces
    one), left in ``jacobi_serial.last_plan``; the levels the level
    variant ran (L a sweep), counted by the kernel, in
    ``jacobi_serial.last_levels`` (an int32 device tensor; None after a
    serial launch), the launches by variant in
    ``jacobi_serial.variant_launches``; nothing is read back.  ``clocks``,
    a (5,) int64 CUDA tensor, receives the level variant's SM clocks: its
    set-up, its error passes, its sweeps, and warp 0's clocks at its rows
    and at the level barriers (``tools/torch_j1_probe.py``).  CPU tensors:
    :func:`jacobi_serial_plain` (the serial row loop, with or without a
    pattern)."""
    if variant not in (None,) + VARIANTS:
        raise ValueError(f"unknown J1 variant {variant!r}; one of "
                         f"{VARIANTS}")
    if pattern is not None and nb_ids is not None:
        raise ValueError("J1 takes a pattern with the dense rows only")
    if b.device.type == "cpu":
        return jacobi_serial_plain(rows, b, past_x, nb_ids, omega, tol,
                                   max_iter)
    n, d, max_nb, dev = _check(rows, b, past_x, nb_ids)
    table = nb_ids if max_nb is not None else pattern
    if max_nb is None and pattern is not None:
        k = pattern.shape[1] if pattern.dim() == 2 else -1
        cuda_build.check_operand("pattern", pattern, (n, k), torch.int32,
                                 dev)
    binding = (level_binding(table)
               if table is not None and variant != "serial" else None)
    plan = jacobi_plan(n, d, max_nb,
                       None if binding is None else binding.plan.levels,
                       variant)
    x = torch.empty_like(b)
    past = torch.empty_like(b)
    it = torch.empty((), dtype=torch.int32, device=dev)
    err = torch.empty((), dtype=torch.float32, device=dev)
    lib = _library()
    if clocks is not None:
        if plan.variant != "levels":
            raise ValueError("J1 reads clocks in its level variant only")
        cuda_build.check_operand("clocks", clocks, (5,), torch.int64, dev)
        clocks = clocks.data_ptr()
    if plan.variant == "levels":
        levels_run = torch.empty((), dtype=torch.int32, device=dev)
        rc = cuda_build.launch_on_stream(
            dev, dev.index, lib.fem_jacobi_levels, d, int(plan.dense),
            plan.slots, int(plan.staged),
            None if nb_ids is None else nb_ids.data_ptr(), rows.data_ptr(),
            b.data_ptr(), past_x.data_ptr(), binding.order.data_ptr(),
            binding.next_row.data_ptr(), binding.first_row.data_ptr(),
            binding.level_start.data_ptr(), n,
            0 if max_nb is None else max_nb, plan.levels, omega, tol,
            max_iter, x.data_ptr(), past.data_ptr(), it.data_ptr(),
            err.data_ptr(), levels_run.data_ptr(), clocks)
    else:
        levels_run = None
        rc = cuda_build.launch_on_stream(
            dev, dev.index, lib.fem_jacobi_serial, d, int(plan.dense),
            plan.slots, None if nb_ids is None else nb_ids.data_ptr(),
            rows.data_ptr(), b.data_ptr(), past_x.data_ptr(), n,
            0 if max_nb is None else max_nb, omega, tol, max_iter,
            x.data_ptr(), past.data_ptr(), it.data_ptr(), err.data_ptr())
    if rc != 0:
        raise RuntimeError(
            f"J1 kernel launch failed: {lib.fem_jacobi_error(rc).decode()}")
    jacobi_serial.launches += 1
    jacobi_serial.variant_launches[plan.variant] = (
        jacobi_serial.variant_launches.get(plan.variant, 0) + 1)
    jacobi_serial.last_plan = plan
    jacobi_serial.last_levels = levels_run
    return JacobiResult(x, past, it, err)


jacobi_serial.launches = 0
jacobi_serial.variant_launches = {}  # launches by variant
jacobi_serial.last_plan = None
jacobi_serial.last_levels = None
