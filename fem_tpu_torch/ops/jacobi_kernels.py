# coding=utf-8
"""J1: the serial weighted-Jacobi solve, one launch a solve.

``jacobi_serial`` launches the hand-written CUDA kernel
``fem_tpu_torch/csrc/jacobi_serial.cu`` for tensors on a CUDA device.  It
replaces no TPU kernel: the JAX package runs the same solve as one XLA
program (``_jacobi_outer_loop`` around the row ``lax.scan`` of
``jacobi_solve_serial_sparse`` or ``jacobi_solve_serial``, its
solvers/implicit.py:737, :888 and :801), and the kernel keeps that solve on
the device: the outer loop, every sweep, the error, the rollback and the
stop test, with no host read before it ends.  Its two row sources are the
block-sparse rows ``(nb_ids (N, max_nb), blocks (N, max_nb, d, d))`` of
``solvers/implicit.sparse_system_rows`` and the dense rows ``a_dense``
(N·d, N·d) of ``solvers/dense.assemble_dense_system``.  For tensors on the
CPU it runs its plain PyTorch version, ``jacobi_serial_plain``: the JAX
scan's row loop inside the outer loop, which reads the error on the host
once a sweep.  On CUDA it launches the kernel or raises; it never falls
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


class SerialPlan(NamedTuple):
    """A launch of J1: one CTA of ``threads``."""

    dense: bool
    slots: int  # a lane's slots of a sparse row (0 for the dense rows)
    threads: int
    smem: int  # dynamic shared memory: x, b, past and the diagonal


# csrc/jacobi_serial.cu's kThreads and its dynamic shared memory limit (a
# CTA's 227 KB less 1 KB kept for the static reduction).
SERIAL_THREADS = 512
SERIAL_MAX_SMEM = 232448 - 1024


@functools.lru_cache(maxsize=64)
def serial_plan(n: int, d: int, max_nb: Optional[int]) -> SerialPlan:
    """J1's launch for ``n`` particles in ``d`` dimensions over the sparse
    rows of ``max_nb`` slots (None: the dense rows).  Raises ``ValueError``
    for what the kernel does not take: d ∉ {2, 3}, no particle, more than
    128 slots a row, or x, b, past and the diagonal past a CTA's shared
    memory (4·N·d floats: N·d ≤ 14,464).  Pure: no device is asked."""
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
        return SerialPlan(True, 0, SERIAL_THREADS, smem)
    slots = next((s for s in (1, 2, 4) if max_nb <= 32 * s), None)
    if slots is None or max_nb < 1:
        raise ValueError(f"J1 takes 1-128 slots a row, not {max_nb}")
    return SerialPlan(False, slots, SERIAL_THREADS, smem)


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
                  max_iter: int = MAX_ITER) -> JacobiResult:
    """The serial weighted-Jacobi solve of A·x = b (module docstring) over
    the block-sparse rows ``rows`` (N, max_nb, d, d) of the neighbours
    ``nb_ids`` (N, max_nb) int32, or with ``nb_ids`` None over the dense
    rows ``rows`` (N·d, N·d); ``b`` and ``past_x`` (N, d).  Returns
    :class:`JacobiResult`, its iterations and error device tensors.

    CUDA tensors: one launch of J1 on :func:`serial_plan`'s plan, left in
    ``jacobi_serial.last_plan``; nothing is read back.  CPU tensors:
    :func:`jacobi_serial_plain`."""
    if b.device.type == "cpu":
        return jacobi_serial_plain(rows, b, past_x, nb_ids, omega, tol,
                                   max_iter)
    n, d, max_nb, dev = _check(rows, b, past_x, nb_ids)
    plan = serial_plan(n, d, max_nb)
    x = torch.empty_like(b)
    past = torch.empty_like(b)
    it = torch.empty((), dtype=torch.int32, device=dev)
    err = torch.empty((), dtype=torch.float32, device=dev)
    lib = _library()
    rc = cuda_build.launch_on_stream(
        dev, dev.index, lib.fem_jacobi_serial, d, int(plan.dense), plan.slots,
        None if nb_ids is None else nb_ids.data_ptr(), rows.data_ptr(),
        b.data_ptr(), past_x.data_ptr(), n, 0 if max_nb is None else max_nb,
        omega, tol, max_iter, x.data_ptr(), past.data_ptr(), it.data_ptr(),
        err.data_ptr())
    if rc != 0:
        raise RuntimeError(
            f"J1 kernel launch failed: {lib.fem_jacobi_error(rc).decode()}")
    jacobi_serial.launches += 1
    jacobi_serial.last_plan = plan
    return JacobiResult(x, past, it, err)


jacobi_serial.launches = 0
jacobi_serial.last_plan = None
