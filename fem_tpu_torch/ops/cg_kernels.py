# coding=utf-8
"""K4, the whole implicit velocity solve: rhs assembly + reference CG.

``fused_cg_solve`` launches the hand-written CUDA kernel
``fem_tpu_torch/csrc/fused_cg.cu`` for tensors on a CUDA device; it replaces
the JAX package's Pallas kernel ``ops/pallas_blocked_cg.py:_fused_cg_kernel``
(entry ``fused_blocked_cg_solve``), in the dimension of the velocities (2
or 3; one kernel template, two instances).  For tensors on the CPU it runs
``fused_cg_solve_plain``, a Python loop over the same operator.  On CUDA it
launches the kernel or raises; it never falls back.

Semantics (the reference CG, solver/implicit.py:289-341):

* b = v + dt·f/m with f assembled from the rhs force columns;
* A·v = v − dt²·G(K)·v/m and Aᵀ·v = v − dt²·G(Kᵀ)·(v/m);
* normal equations AᵀA·x = Aᵀb when ``preconditioned``, else A·x = b;
* x₀ = b — not the normal-equations rhs — and the loop runs while
  ``it < max_iter`` and ``‖r‖² > tol`` (absolute tolerance, strict ``>``).
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch

from fem_tpu_torch.ops import smallmat as sm
from fem_tpu_torch.ops.assembly import (
    GatherPlan,
    element_contrib_full,
    gather_assemble,
    gather_edge_diffs,
)
from fem_tpu_torch.utils import cuda_build

_P = ctypes.c_void_p


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: torch.Tensor  # int32 scalar
    residual: torch.Tensor  # final ‖r‖², f32 scalar


def graph_apply(
    K: torch.Tensor, x: torch.Tensor, element_indices: torch.Tensor,
    plan_idx: torch.Tensor,
) -> torch.Tensor:
    """G(K)·x with the element-Laplacian pattern: per element
    t_j = K_e·(x_{v_{j+1}} − x_{v_0}) to vertex j+1, −Σ_j t_j to vertex 0."""
    s = gather_edge_diffs(x, element_indices)  # columns = edge diffs
    return gather_assemble(element_contrib_full(sm.matmul(K, s)), plan_idx)


def system_applies(
    K: torch.Tensor, element_indices: torch.Tensor, plan_idx: torch.Tensor,
    minv: torch.Tensor, dt: float,
):
    """(apply_a, apply_at) of A = I − dt²·M⁻¹·G(K), ``minv`` = 1/m (N,)."""
    dt2 = dt * dt
    minv = minv[:, None]
    k_t = sm.mT(K)

    def apply_a(v):
        return v - dt2 * graph_apply(K, v, element_indices, plan_idx) * minv

    def apply_at(v):
        return v - dt2 * graph_apply(k_t, v * minv, element_indices, plan_idx)

    return apply_a, apply_at


def conjugate_gradient(
    operator: Callable[[torch.Tensor], torch.Tensor],
    rhs: torch.Tensor,
    x0: torch.Tensor,
    max_iter: int = 500,
    tol: float = 1e-5,
) -> CGResult:
    """The reference CG loop: absolute tolerance on ‖r‖², no restart.  A
    Python loop that reads ‖r‖² on the host every iteration."""
    x = x0
    r = rhs - operator(x0)
    d = r
    delta = torch.sum(r * r)
    it = 0
    while it < max_iter and bool(delta > tol):
        q = operator(d)
        alpha = delta / torch.sum(d * q)
        x = x + alpha * d
        r = r - alpha * q
        delta_next = torch.sum(r * r)
        beta = delta_next / delta
        d = r + beta * d
        delta = delta_next
        it += 1
    return CGResult(
        x, torch.tensor(it, dtype=torch.int32, device=x.device), delta
    )


def fused_cg_solve_plain(
    K, cols, element_indices, plan: GatherPlan, vel, mass, dt,
    preconditioned, max_iter=500, tol=1e-5,
):
    """Plain PyTorch version of :func:`fused_cg_solve`."""
    minv = 1.0 / mass
    apply_a, apply_at = system_applies(
        K, element_indices, plan.idx, minv, dt
    )
    f = gather_assemble(element_contrib_full(cols), plan.idx)
    b = vel + dt * f * minv[:, None]
    if preconditioned:
        res = conjugate_gradient(
            lambda v: apply_at(apply_a(v)), apply_at(b), b, max_iter, tol
        )
    else:
        res = conjugate_gradient(apply_a, b, b, max_iter, tol)
    return res.x, res.iterations, res.residual


def _library():
    lib = cuda_build.load("fused_cg")
    if lib.fem_fused_cg.argtypes is None:
        lib.fem_fused_cg_scratch_floats.argtypes = [ctypes.c_int] * 3
        lib.fem_fused_cg_scratch_floats.restype = ctypes.c_longlong
        lib.fem_fused_cg.argtypes = [
            ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int,
            ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, _P, _P, _P, _P, _P,
        ]
        lib.fem_fused_cg.restype = ctypes.c_int
        lib.fem_fused_cg_error.argtypes = [ctypes.c_int]
        lib.fem_fused_cg_error.restype = ctypes.c_char_p
    return lib


def fused_cg_solve(
    K: torch.Tensor,
    cols: torch.Tensor,
    element_indices: torch.Tensor,
    plan: GatherPlan,
    vel: torch.Tensor,
    mass: torch.Tensor,
    dt: float,
    preconditioned: bool,
    max_iter: int = 500,
    tol: float = 1e-5,
):
    """Returns (vel_next (N, d), iterations int32 scalar, ‖r‖² f32 scalar),
    all on the input's device.  CUDA tensors: one launch of the whole-solve
    kernel (2D or 3D), with no host synchronisation.  CPU tensors:
    :func:`fused_cg_solve_plain`."""
    if vel.device.type == "cpu":
        return fused_cg_solve_plain(
            K, cols, element_indices, plan, vel, mass, dt, preconditioned,
            max_iter, tol,
        )
    if vel.device.type != "cuda":
        raise ValueError(f"unsupported device {vel.device}")
    n, d = vel.shape
    if d not in (2, 3):
        raise ValueError(f"the whole-solve kernel takes dim 2 or 3, not {d}")
    e = element_indices.shape[0]
    dev = vel.device
    cuda_build.check_operand("K", K, (e, d, d), torch.float32, dev)
    cuda_build.check_operand("cols", cols, (e, d, d), torch.float32, dev)
    cuda_build.check_operand(
        "element_indices", element_indices, (e, d + 1), torch.int32, dev
    )
    cuda_build.check_operand("plan.ptr", plan.ptr, (n + 1,), torch.int32, dev)
    cuda_build.check_operand("plan.rows", plan.rows, ((d + 1) * e,),
                             torch.int32, dev)
    cuda_build.check_operand("vel", vel, (n, d), torch.float32, dev)
    cuda_build.check_operand("mass", mass, (n,), torch.float32, dev)
    if d == 3 and element_indices.data_ptr() % 16:
        raise ValueError("element_indices must be 16-byte aligned (int4 loads)")
    lib = _library()
    x = torch.empty((n, d), dtype=torch.float32, device=dev)
    scratch = torch.empty(lib.fem_fused_cg_scratch_floats(d, e, n),
                          dtype=torch.float32, device=dev)
    it = torch.empty((), dtype=torch.int32, device=dev)
    res = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fem_fused_cg(
            d, K.data_ptr(), cols.data_ptr(), element_indices.data_ptr(),
            plan.ptr.data_ptr(), plan.rows.data_ptr(), vel.data_ptr(),
            mass.data_ptr(), e, n, dt, dt * dt, int(bool(preconditioned)),
            max_iter, tol, x.data_ptr(), scratch.data_ptr(), it.data_ptr(),
            res.data_ptr(), stream,
        )
    if rc != 0:
        msg = lib.fem_fused_cg_error(rc).decode()
        raise RuntimeError(f"whole-solve CG kernel launch failed: {msg}")
    fused_cg_solve.launches += 1
    return x, it, res


fused_cg_solve.launches = 0
