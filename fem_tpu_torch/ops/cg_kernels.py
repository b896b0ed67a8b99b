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

The module also holds the port's one CG loop for the op-composed solves,
:func:`conjugate_gradient`, and what routes a solve to it
(:func:`cg_solve_dispatch`): the reference CG (plain or normal equations),
the block-Jacobi PCG (:func:`preconditioned_conjugate_gradient`, the one
preconditioned loop) and the pin projection around either; and the
operator's pieces: Rayleigh β in the system coefficient
(:func:`system_coeff`) and the per-particle diagonal blocks of A
(:func:`diagonal_blocks_from`).
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


def system_coeff(dt: float, beta: float = 0.0) -> float:
    """Coefficient c of M⁻¹·G(K) in A = I − c·M⁻¹·G(K): dt² (reference
    implicit.py:183-194), or dt·(dt + β) with stiffness-proportional Rayleigh
    damping β, whose backward-Euler force β·G(K)·v' folds into the same
    operator (the JAX package's ``system_coeff``)."""
    return dt * (dt + beta)


def system_applies(
    K: torch.Tensor, element_indices: torch.Tensor, plan_idx: torch.Tensor,
    minv: torch.Tensor, dt: float, beta: float = 0.0,
):
    """(apply_a, apply_at) of A = I − c·M⁻¹·G(K), ``minv`` = 1/m (N,), c =
    :func:`system_coeff` (dt² without β)."""
    c = system_coeff(dt, beta)
    minv = minv[:, None]
    k_t = sm.mT(K)

    def apply_a(v):
        return v - c * graph_apply(K, v, element_indices, plan_idx) * minv

    def apply_at(v):
        return v - c * graph_apply(k_t, v * minv, element_indices, plan_idx)

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


def preconditioned_conjugate_gradient(
    operator: Callable[[torch.Tensor], torch.Tensor],
    diag: torch.Tensor,
    mass: torch.Tensor,
    rhs: torch.Tensor,
    x0: torch.Tensor,
    max_iter: int = 500,
    tol: float = 1e-5,
) -> CGResult:
    """Block-Jacobi PCG, the ``cg_precond="block_jacobi"`` extension (the
    JAX package's ``preconditioned_conjugate_gradient``).

    The Krylov process runs on the mass-symmetrized operator
    Ã = M^{1/2}·A·M^{-1/2} (A is nonsymmetric through its M⁻¹ row scaling),
    whose diagonal blocks are A's ``diag`` (N, d, d).  The preconditioner
    is the inverse of each symmetrized block where the block passes a
    Gershgorin test (its smallest Gershgorin bound at least 0.05 of its
    mean absolute diagonal) and of that mean times I where it does not, so
    that near-singular blocks fall back to plain CG locally.  Termination
    is the reference's absolute rᵀr > ``tol`` on the original residual
    b − A·x; x₀ = ``x0``.  The block products are written as elementwise
    sums, so no matmul (and no TF32) is involved."""
    sq = torch.sqrt(mass)[:, None]
    dsym = 0.5 * (diag + sm.mT(diag))
    main = torch.diagonal(dsym, dim1=-2, dim2=-1)
    absdiag = torch.abs(main)
    offdiag = torch.sum(torch.abs(dsym), dim=-1) - absdiag
    gersh_min = torch.min(main - offdiag, dim=-1).values
    scale = torch.mean(absdiag, dim=-1) + 1e-30
    ok = (gersh_min >= 0.05 * scale)[:, None, None]
    eye = torch.eye(diag.shape[-1], dtype=diag.dtype, device=diag.device)
    minv = sm.inv(torch.where(ok, dsym, scale[:, None, None] * eye[None]))

    def op(y):
        return sq * operator(y / sq)

    def apply_m(r):
        return torch.sum(minv * r[:, None, :], dim=-1)

    def rr_orig(r):
        q = r / sq
        return torch.sum(q * q)

    y = sq * x0
    r = sq * rhs - op(y)
    d = apply_m(r)
    delta = torch.sum(r * d)
    rr = rr_orig(r)
    it = 0
    while it < max_iter and bool(rr > tol):
        q = op(d)
        alpha = delta / torch.sum(d * q)
        y = y + alpha * d
        r = r - alpha * q
        z = apply_m(r)
        delta_next = torch.sum(r * z)
        beta = delta_next / delta
        d = z + beta * d
        delta = delta_next
        rr = rr_orig(r)
        it += 1
    return CGResult(
        y / sq, torch.tensor(it, dtype=torch.int32, device=y.device), rr
    )


def cg_solve_dispatch(
    apply_a: Callable[[torch.Tensor], torch.Tensor],
    apply_at_fn: Callable[[], Callable[[torch.Tensor], torch.Tensor]],
    b: torch.Tensor,
    preconditioned: int,
    cg_precond: str,
    diag_fn: Callable[[], torch.Tensor] | None,
    mass: torch.Tensor | None = None,
    free: torch.Tensor | None = None,
    pin_vel: torch.Tensor | None = None,
    max_iter: int = 500,
    tol: float = 1e-5,
) -> CGResult:
    """One CG solve of A·x = b routed by ``cg_precond`` (the JAX package's
    ``_cg_solve_dispatch``): ``"reference"`` normal equations AᵀA·x = Aᵀb
    when ``preconditioned`` is 1, else plain CG; ``"none"`` plain CG;
    ``"block_jacobi"`` :func:`preconditioned_conjugate_gradient` on the
    blocks of ``diag_fn()``.  x₀ = b in every mode.  ``apply_at_fn`` and
    ``diag_fn`` are thunks, so Aᵀ and the blocks are built only when the
    mode needs them.

    ``free`` (N, 1), the pins' mask, solves the projected system
    Â = P·A·P + (I − P), b̂ = P·b with P = diag(free) instead: identity rows
    on pinned vertices, whose solution is 0 there; Âᵀ and Â's diagonal
    blocks project alike.  With ``pin_vel`` (N, d) the projection is
    inhomogeneous: b̂ = P·(b − A·x_h) + x_h with x_h = (I − P)·pin_vel, so
    pinned vertices solve to their prescribed velocity and the free ones
    see the constraint's reaction."""
    if free is not None:
        base_a, base_at_fn, base_diag = apply_a, apply_at_fn, diag_fn
        held = 1.0 - free

        def apply_a(x):
            return free * base_a(free * x) + held * x

        def apply_at_fn():
            at = base_at_fn()
            return lambda y: free * at(free * y) + held * y

        if base_diag is not None:

            def diag_fn():
                diag = base_diag()
                eye = torch.eye(diag.shape[-1], dtype=diag.dtype,
                                device=diag.device)[None]
                f3 = free[..., None]
                return f3 * diag + (1.0 - f3) * eye

        if pin_vel is not None:
            x_h = held * pin_vel
            b = free * (b - base_a(x_h)) + x_h
        else:
            b = free * b
    if cg_precond == "block_jacobi":
        if diag_fn is None:
            raise ValueError(
                "cg_precond='block_jacobi' requires explicit diagonal "
                "blocks; unavailable for hessian='exact_jvp' (use "
                "cg_precond='none' there)"
            )
        return preconditioned_conjugate_gradient(
            apply_a, diag_fn(), mass, b, b, max_iter, tol)
    if cg_precond not in ("reference", "none"):
        raise ValueError(f"unknown cg_precond {cg_precond!r}")
    if cg_precond == "reference" and preconditioned == 1:
        apply_at = apply_at_fn()
        return conjugate_gradient(lambda v: apply_at(apply_a(v)),
                                  apply_at(b), b, max_iter, tol)
    return conjugate_gradient(apply_a, b, b, max_iter, tol)


def diagonal_blocks_from(
    element_indices: torch.Tensor, K: torch.Tensor, mass: torch.Tensor,
    dt: float, plan_idx: torch.Tensor, beta: float = 0.0,
) -> torch.Tensor:
    """Per-particle diagonal d×d blocks (N, d, d) of A = I − c·M⁻¹·G(K)
    (the JAX package's ``diagonal_blocks_from``): vertex 0 of element e
    receives d·K_e, vertices 1..d receive K_e each, assembled through the
    gather plan ``plan_idx`` of ``element_indices`` (deterministic: a gather
    and a sum, no atomics); c = :func:`system_coeff`."""
    e, dp1 = element_indices.shape
    d = dp1 - 1
    w = torch.ones((1, dp1, 1), dtype=K.dtype, device=K.device)
    w[0, 0, 0] = float(d)
    contrib = w * K.reshape(e, 1, d * d)
    diag_k = gather_assemble(contrib, plan_idx).reshape(-1, d, d)
    eye = torch.eye(d, dtype=K.dtype, device=K.device)[None]
    return eye - system_coeff(dt, beta) * diag_k / mass[:, None, None]


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
