# coding=utf-8
"""K4, the whole implicit velocity solve: rhs assembly + reference CG.

``fused_cg_solve`` launches the hand-written CUDA kernel
``fem_tpu_torch/csrc/fused_cg.cu`` for tensors on a CUDA device; it replaces
the JAX package's Pallas kernel ``ops/pallas_blocked_cg.py:_fused_cg_kernel``
(entry ``fused_blocked_cg_solve``), in the dimension of the velocities (2
or 3; one kernel template, two instances).  Its two variants, chosen by
K11b's plan (``experiments/fused_frame.fused_frame_plan``) before the
launch: the **cluster** variant (one thread-block cluster, each CTA a
contiguous range of elements with the solve's state in shared memory:
every mesh whose state fits one cluster) or else the **single** variant
(one CTA of 1,024 threads, the state in device memory: any mesh);
``cluster=`` or ``single=True`` force one.  For tensors on the CPU it runs
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
the block-Jacobi PCG (:func:`preconditioned_conjugate_gradient`), the
two-level PCG (``solvers/multilevel.py``) and the pin projection around
each; and the
operator's pieces: Rayleigh β in the system coefficient
(:func:`system_coeff`) and the per-particle diagonal blocks of A
(:func:`diagonal_blocks_from`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from fem_tpu_torch.ops import smallmat as sm
from fem_tpu_torch.ops.assembly import (
    GatherPlan,
    all_reduce_sum,
    element_contrib_full,
    gather_assemble,
    gather_edge_diffs,
)
from fem_tpu_torch.utils import cuda_build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: torch.Tensor  # int32 scalar
    residual: torch.Tensor  # final ‖r‖², f32 scalar


def graph_apply(
    K: torch.Tensor, x: torch.Tensor, element_indices: torch.Tensor,
    plan_idx: torch.Tensor, group=None,
) -> torch.Tensor:
    """G(K)·x with the element-Laplacian pattern: per element
    t_j = K_e·(x_{v_{j+1}} − x_{v_0}) to vertex j+1, −Σ_j t_j to vertex 0;
    with ``group`` (element sharding: each rank's elements a slice of the
    mesh) summed over its ranks, one all-reduce."""
    s = gather_edge_diffs(x, element_indices)  # columns = edge diffs
    return all_reduce_sum(
        gather_assemble(element_contrib_full(sm.matmul(K, s)), plan_idx),
        group)


def system_coeff(dt: float, beta: float = 0.0) -> float:
    """Coefficient c of M⁻¹·G(K) in A = I − c·M⁻¹·G(K): dt² (reference
    implicit.py:183-194), or dt·(dt + β) with stiffness-proportional Rayleigh
    damping β, whose backward-Euler force β·G(K)·v' folds into the same
    operator (the JAX package's ``system_coeff``)."""
    return dt * (dt + beta)


def system_applies(
    K: torch.Tensor, element_indices: torch.Tensor, plan_idx: torch.Tensor,
    minv: torch.Tensor, dt: float, beta: float = 0.0, group=None,
):
    """(apply_a, apply_at) of A = I − c·M⁻¹·G(K), ``minv`` = 1/m (N,), c =
    :func:`system_coeff` (dt² without β); ``group`` as in
    :func:`graph_apply`."""
    c = system_coeff(dt, beta)
    minv = minv[:, None]
    k_t = sm.mT(K)

    def apply_a(v):
        return v - c * graph_apply(K, v, element_indices, plan_idx,
                                   group) * minv

    def apply_at(v):
        return v - c * graph_apply(k_t, v * minv, element_indices, plan_idx,
                                   group)

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
    two_level_fn=None,
) -> CGResult:
    """One CG solve of A·x = b routed by ``cg_precond`` (the JAX package's
    ``_cg_solve_dispatch``): ``"reference"`` normal equations AᵀA·x = Aᵀb
    when ``preconditioned`` is 1, else plain CG; ``"none"`` plain CG;
    ``"block_jacobi"`` :func:`preconditioned_conjugate_gradient` on the
    blocks of ``diag_fn()``; ``"two_level"`` and ``"two_level_cheb<k>"``
    the two-level PCG (``solvers/multilevel.two_level_pcg``) on those
    blocks and the coarse space and matrix ``two_level_fn()`` gives.  x₀ =
    b in every mode.  ``apply_at_fn``, ``diag_fn`` and ``two_level_fn`` are
    thunks, so Aᵀ, the blocks and the coarse matrix are built only when the
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
    from fem_tpu_torch.solvers.multilevel import (
        parse_two_level_precond,
        two_level_pcg,
    )

    tl, tl_smoother, tl_degree = parse_two_level_precond(cg_precond)
    if tl:
        if two_level_fn is None or diag_fn is None:
            raise ValueError(
                "cg_precond='two_level' requires explicit K blocks and the "
                "attached coarse space; unavailable for "
                "hessian='exact_jvp' (use cg_precond='none' there)"
            )
        coarse, c_mat = two_level_fn()
        return two_level_pcg(
            apply_a, diag_fn(), mass, coarse, c_mat, b, b, max_iter, tol,
            free_mask=free, smoother=tl_smoother, cheb_degree=tl_degree)
    if cg_precond not in ("reference", "none"):
        raise ValueError(f"unknown cg_precond {cg_precond!r}")
    if cg_precond == "reference" and preconditioned == 1:
        apply_at = apply_at_fn()
        return conjugate_gradient(lambda v: apply_at(apply_a(v)),
                                  apply_at(b), b, max_iter, tol)
    return conjugate_gradient(apply_a, b, b, max_iter, tol)


def diagonal_blocks_from(
    element_indices: torch.Tensor, K: torch.Tensor, mass: torch.Tensor,
    dt: float, plan_idx: torch.Tensor, beta: float = 0.0, group=None,
) -> torch.Tensor:
    """Per-particle diagonal d×d blocks (N, d, d) of A = I − c·M⁻¹·G(K)
    (the JAX package's ``diagonal_blocks_from``): vertex 0 of element e
    receives d·K_e, vertices 1..d receive K_e each, assembled through the
    gather plan ``plan_idx`` of ``element_indices`` (deterministic: a gather
    and a sum, no atomics); c = :func:`system_coeff`.  With ``group`` the
    assembled diagonal of K is summed over its ranks."""
    e, dp1 = element_indices.shape
    d = dp1 - 1
    w = torch.ones((1, dp1, 1), dtype=K.dtype, device=K.device)
    w[0, 0, 0] = float(d)
    contrib = w * K.reshape(e, 1, d * d)
    diag_k = all_reduce_sum(gather_assemble(contrib, plan_idx),
                            group).reshape(-1, d, d)
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


class FusedCgArgsC(ctypes.Structure):
    """Mirror of ``FemFusedCgArgs`` (csrc/fused_cg.cu): the cluster
    variant's arguments, its plan's fields flat (``fem::cluster_cg::Plan``,
    the fields of ``experiments/fused_frame.FusedAssignment`` and the four
    sizes)."""

    _fields_ = [
        ("k", _P), ("cols", _P), ("vel", _P), ("mass", _P),
        ("normal", _I), ("max_iter", _I), ("dt", _F), ("dt2", _F),
        ("tol", _F), ("x", _P), ("it", _P), ("res", _P),
        ("cl_elem_ptr", _P), ("cl_local_ptr", _P), ("cl_local_ids", _P),
        ("cl_owned_ptr", _P), ("cl_elem_local", _P), ("cl_row_dest", _P),
        ("cl_recv_ptr", _P), ("cl_push_ptr", _P), ("cl_push_codes", _P),
        ("cl_cap", _I), ("cl_elements", _I), ("cl_entries", _I),
        ("cl_pushes", _I), ("barriers", _P),
    ]


# Local vectors of a cluster CTA of K4 (csrc/fused_cg.cu: kVectors): vel,
# x, r, d, q.
CLUSTER_VECTORS = 5


def fused_cg_barriers(variant: str, normal: bool, iterations: int) -> int:
    """Barriers of one K4 solve of ``iterations`` iterations, as
    csrc/fused_cg.cu places them.  The cluster variant: one after the
    copy-in, then csrc/cluster_cg.cuh's solve — normal equations 6 and 5 an
    iteration, plain 4 and 3 — so 7 + 5·it or 5 + 3·it.  The single
    variant: its every ``__syncthreads`` (whole_cg.cuh: an apply 3, a dot
    3; the rhs assembly 2) — 14 + 12·it or 8 + 9·it.  The kernel counts the
    barriers it meets (``fused_cg_solve.last_barriers``); the CUDA tests
    and ``chip_smoke.py`` hold that count to this one."""
    per_solve, per_it = {("cluster", True): (7, 5), ("cluster", False): (5, 3),
                         ("single", True): (14, 12),
                         ("single", False): (8, 9)}[(variant, bool(normal))]
    return per_solve + per_it * int(iterations)


def _library():
    lib = cuda_build.load("fused_cg")
    if lib.fem_fused_cg.argtypes is None:
        out = ctypes.POINTER(_I)
        lib.fem_fused_cg_scratch_floats.argtypes = [_I] * 3
        lib.fem_fused_cg_scratch_floats.restype = ctypes.c_longlong
        lib.fem_fused_cg.argtypes = [
            _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _I, _I, _F,
            _P, _P, _P, _P, _P, _P,
        ]
        lib.fem_fused_cg.restype = _I
        lib.fem_fused_cg_limits.argtypes = [_I, out, out, out]
        lib.fem_fused_cg_limits.restype = _I
        lib.fem_fused_cg_cluster_smem.argtypes = [_I] * 5
        lib.fem_fused_cg_cluster_smem.restype = ctypes.c_longlong
        lib.fem_fused_cg_cluster_fit.argtypes = [_I, _I, _I, out]
        lib.fem_fused_cg_cluster_fit.restype = _I
        lib.fem_fused_cg_cluster.argtypes = [
            ctypes.POINTER(FusedCgArgsC), _I, _I, _I, _P]
        lib.fem_fused_cg_cluster.restype = _I
        lib.fem_fused_cg_error.argtypes = [_I]
        lib.fem_fused_cg_error.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=16)
def device_limits(device_index: int, dim: int):
    """The ``FrameLimits`` of CUDA device ``device_index`` for K4's cluster
    instance of ``dim``."""
    from fem_tpu_torch.ops.frame_kernels import FrameLimits

    lib = _library()
    mc, optin, sms = _I(0), _I(0), _I(0)
    with torch.cuda.device(device_index):
        rc = lib.fem_fused_cg_limits(dim, ctypes.byref(mc),
                                     ctypes.byref(optin), ctypes.byref(sms))
    if rc != 0:
        raise RuntimeError("whole-solve CG kernel: reading the device's "
                           f"limits failed: {lib.fem_fused_cg_error(rc).decode()}")
    return FrameLimits(mc.value, optin.value, sms.value)


@functools.lru_cache(maxsize=64)
def _check_cluster(device_index: int, size: int, smem: int, sizes, dim: int):
    """Raise unless the device can run K4's cluster of ``size`` CTAs with
    ``smem`` bytes each for a rank of ``sizes`` (elements, local particles,
    receive slots, push codes).  Once per plan on a device."""
    lib = _library()
    want = lib.fem_fused_cg_cluster_smem(*sizes, dim)
    if want != smem:
        raise RuntimeError(f"whole-solve CG kernel: the plan's {smem} B of "
                           f"shared memory differ from the kernel's {want}")
    most = _I(0)
    with torch.cuda.device(device_index):
        rc = lib.fem_fused_cg_cluster_fit(size, smem, dim, ctypes.byref(most))
    if rc != 0:
        raise RuntimeError(
            f"whole-solve CG kernel: {lib.fem_fused_cg_error(rc).decode()} "
            f"(one cluster of {size} CTAs, {smem} B of shared memory each; "
            f"{most.value} such clusters fit at once)")


# Device → the (1,) int32 tensor K4's launches there write their barrier
# count to.
_BARRIERS: dict = {}


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
    cluster: int = 0,
    single: bool = False,
):
    """Returns (vel_next (N, d), iterations int32 scalar, ‖r‖² f32 scalar),
    all on the input's device.  CUDA tensors: one launch of the whole-solve
    kernel (2D or 3D), with no host synchronisation after the first call on
    a mesh (which plans on the host; the plan and its assignment are kept
    on ``element_indices`` and ``plan``, by identity and version counter).
    The variant is K11b's plan's (``fused_frame_plan`` with K4's five local
    vectors); ``cluster`` forces the cluster variant with that many CTAs,
    ``single`` the single variant (tests and ``chip_smoke.py``; a plan the
    device cannot run raises).  The launch's variant and CTAs are left in
    ``fused_cg_solve.last_plan`` and counted in ``variant_launches``; the
    barriers its kernel met in ``fused_cg_solve.last_barriers``, a (1,)
    int32 tensor on the device that the next launch there overwrites
    (:func:`fused_cg_barriers` says what it must hold).  CPU tensors:
    :func:`fused_cg_solve_plain`."""
    if vel.device.type == "cpu":
        return fused_cg_solve_plain(
            K, cols, element_indices, plan, vel, mass, dt, preconditioned,
            max_iter, tol,
        )
    if vel.device.type != "cuda":
        raise ValueError(f"unsupported device {vel.device}")
    from fem_tpu_torch.experiments import fused_frame as ff

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
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    fplan, tables = ff._planned(element_indices, plan, n, d,
                                device_limits(index, d), int(cluster),
                                bool(single), CLUSTER_VECTORS)
    barriers = _BARRIERS.get(dev)
    if barriers is None:
        barriers = _BARRIERS[dev] = torch.zeros((1,), dtype=torch.int32,
                                                device=dev)
    x = torch.empty((n, d), dtype=torch.float32, device=dev)
    it = torch.empty((), dtype=torch.int32, device=dev)
    res = torch.empty((), dtype=torch.float32, device=dev)
    normal = int(bool(preconditioned))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if fplan.variant == "cluster":
            sizes, cl = tables
            _check_cluster(index, fplan.size, fplan.smem, sizes, d)
            elements, cap, entries, pushes = sizes
            args = FusedCgArgsC(
                K.data_ptr(), cols.data_ptr(), vel.data_ptr(),
                mass.data_ptr(), normal, int(max_iter), dt, dt * dt, tol,
                x.data_ptr(), it.data_ptr(), res.data_ptr(),
                *(t.data_ptr() for t in cl), cap, elements, entries, pushes,
                barriers.data_ptr())
            rc = lib.fem_fused_cg_cluster(ctypes.byref(args), d, fplan.size,
                                          fplan.smem, stream)
        else:
            scratch = torch.empty(lib.fem_fused_cg_scratch_floats(d, e, n),
                                  dtype=torch.float32, device=dev)
            rc = lib.fem_fused_cg(
                d, K.data_ptr(), cols.data_ptr(), element_indices.data_ptr(),
                plan.ptr.data_ptr(), plan.rows.data_ptr(), vel.data_ptr(),
                mass.data_ptr(), e, n, dt, dt * dt, normal, max_iter, tol,
                x.data_ptr(), scratch.data_ptr(), it.data_ptr(),
                res.data_ptr(), barriers.data_ptr(), stream,
            )
    if rc != 0:
        msg = lib.fem_fused_cg_error(rc).decode()
        raise RuntimeError(f"whole-solve CG kernel launch failed "
                           f"({fplan.variant} variant, {fplan.size} CTAs): "
                           f"{msg}")
    fused_cg_solve.launches += 1
    fused_cg_solve.last_plan = fplan
    fused_cg_solve.last_barriers = barriers
    key = (fplan.variant, fplan.size)
    fused_cg_solve.variant_launches[key] = (
        fused_cg_solve.variant_launches.get(key, 0) + 1)
    return x, it, res


fused_cg_solve.launches = 0
fused_cg_solve.variant_launches = {}
fused_cg_solve.last_plan = None
fused_cg_solve.last_barriers = None
