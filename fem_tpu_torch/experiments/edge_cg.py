# coding=utf-8
"""K11a, the whole reference CG over the edge-matrix operator.

``cg_solve_edge`` launches the hand-written CUDA kernel
``fem_tpu_torch/csrc/edge_cg.cu`` for tensors on a CUDA device; it replaces
the JAX package's Pallas kernel ``experiments/pallas_cg.py:_cg_kernel``
(entry ``cg_solve_pallas``), in the dimension of the velocities (2 or 3).
Its two variants are K4's: the **cluster** variant (one thread-block
cluster on ``csrc/cluster_cg.cuh``, the solve's state in shared memory:
every mesh whose state fits one cluster) or else the **single** variant
(one CTA of 1,024 threads on ``csrc/whole_cg.cuh``, the state in device
memory: any mesh), chosen before the launch by K11b's planner
(``fused_frame.fused_frame_plan``); ``cluster=`` or ``single=True`` force
one.  For tensors on the CPU it runs ``cg_solve_edge_plain``, the JAX
kernel's formulation: the operator as products with the dense S
(``torch.matmul``, TF32 off) and the port's reference CG loop.  On CUDA it
launches the kernel or raises; it never falls back.

Semantics (the JAX kernel's): with S the dense ±1 edge matrix (E·d, N) of
``solvers/implicit.build_edge_matrix`` and 1/m in f32,

* A·x = x − dt²·M⁻¹·Sᵀ(K∘(S·x)) and Aᵀ·y = y − dt²·Sᵀ(Kᵀ∘(S·(M⁻¹y)));
* normal equations AᵀA·x = Aᵀb when ``preconditioned``, else A·x = b;
* x₀ = b in both modes, and the loop runs while ``it < max_iter`` and
  ‖r‖² > ``tol`` (absolute);
* ``dt2`` arrives as a Python float and is rounded to f32 once.

The kernel does not multiply by S, which costs O(E·d·N): when the wrapper
first sees an S it recovers each row's +1 and −1 columns — row e·d+j is +1
at vertex j+1 and −1 at vertex 0 of element e — checks that S has that
structure (``ValueError`` otherwise), and builds the element vertex ids
and the per-particle CSR plan once (:func:`edge_plan`), memoized on the S
tensor.  The kernel then applies G(K) by direct gathers, as K4 does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from fem_tpu_torch.experiments import fused_frame as ff
from fem_tpu_torch.ops.assembly import GatherPlan, make_gather_plan
from fem_tpu_torch.ops.cg_kernels import conjugate_gradient
from fem_tpu_torch.ops.frame_kernels import FrameLimits
from fem_tpu_torch.utils import cuda_build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# Local vectors of a cluster CTA of K11a (csrc/edge_cg.cu: kVectors): x,
# which starts as b (x₀ = b), r, d, q — one fewer than K4's, which keeps
# the velocities beside x.
CLUSTER_VECTORS = 4


class EdgeCgArgsC(ctypes.Structure):
    """Mirror of ``FemEdgeCgArgs`` (csrc/edge_cg.cu): the cluster variant's
    arguments, its plan's fields flat (``fem::cluster_cg::Plan``, the
    fields of ``fused_frame.FusedAssignment`` and the four sizes)."""

    _fields_ = [
        ("k", _P), ("b", _P), ("mass", _P), ("normal", _I),
        ("max_iter", _I), ("dt2", _F), ("tol", _F), ("x", _P), ("it", _P),
        ("res", _P),
        ("cl_elem_ptr", _P), ("cl_local_ptr", _P), ("cl_local_ids", _P),
        ("cl_owned_ptr", _P), ("cl_elem_local", _P), ("cl_row_dest", _P),
        ("cl_recv_ptr", _P), ("cl_push_ptr", _P), ("cl_push_codes", _P),
        ("cl_cap", _I), ("cl_elements", _I), ("cl_entries", _I),
        ("cl_pushes", _I), ("barriers", _P),
    ]


class EdgePlan(NamedTuple):
    """What the kernel needs of an S: the element vertex ids (E, d+1) int32
    (vertex 0 is every row's −1 column) and their per-particle plan."""

    element_indices: torch.Tensor
    plan: GatherPlan


def _recover(s_mat: torch.Tensor, dim: int) -> torch.Tensor:
    """The element vertex ids (E, d+1) int32 of an edge matrix, or
    ``ValueError`` when S is not one."""
    if s_mat.dim() != 2 or s_mat.shape[0] % dim:
        raise ValueError(
            f"edge matrix of shape {tuple(s_mat.shape)}: expected (E·{dim}, N)")
    plus = s_mat == 1.0
    minus = s_mat == -1.0
    if bool(((s_mat != 0.0) & ~plus & ~minus).any()):
        raise ValueError("edge matrix entries must be 0, +1 or -1")
    if bool((plus.sum(dim=1) != 1).any() or (minus.sum(dim=1) != 1).any()):
        raise ValueError(
            "every edge matrix row needs exactly one +1 and one -1")
    cols_p = plus.to(torch.int8).argmax(dim=1).reshape(-1, dim)
    cols_m = minus.to(torch.int8).argmax(dim=1).reshape(-1, dim)
    if bool((cols_m != cols_m[:, :1]).any()):
        raise ValueError(
            "the rows of an element must share their -1 column (vertex 0)")
    return torch.cat([cols_m[:, :1], cols_p], dim=1).to(torch.int32)


def edge_plan(s_mat: torch.Tensor, dim: int) -> EdgePlan:
    """The :class:`EdgePlan` of ``s_mat``, on its device, built once per S
    (and again if S was changed in place).  The plan is kept on the S
    tensor itself, with S's version counter: a memo keyed by ``id(S)``
    would hand a new S an old mesh's plan once CPython reuses the id of a
    collected tensor, and this one lives and dies with its S."""
    memo = getattr(s_mat, "_fem_edge_plan", None)
    if memo is not None and memo[0] == (s_mat._version, dim):
        return memo[1]
    idx = _recover(s_mat, dim)
    plan = EdgePlan(idx.contiguous(), make_gather_plan(
        idx.cpu().numpy(), s_mat.shape[1], s_mat.device))
    s_mat._fem_edge_plan = ((s_mat._version, dim), plan)
    return plan


def supports_edge_cg(obj) -> bool:
    """Whether ``obj`` carries the edge matrix K11a consumes (the JAX
    package's ``supports_pallas_cg`` keeps this test).  Its TPU-backend
    test and its VMEM gate (S within 12 MB) are Mosaic's limits and have no
    counterpart: the kernel never holds S, and a mesh whose state does not
    fit one cluster's shared memory runs the single variant, whose scratch
    is O(E + N) floats of device memory and whose one CTA walks elements
    and particles in grid-stride loops, so every mesh whose S
    ``build_object`` attaches (E·d·N ≤ 16,000,000) fits the card."""
    return obj.edge_matrix is not None


def cg_solve_edge_plain(
    s_mat, k_blocks, b, mass, *, dim, dt2, preconditioned, max_iter=500,
    tol=1e-5,
):
    """Plain PyTorch version of :func:`cg_solve_edge`: the JAX kernel's
    products with the dense S."""
    e = k_blocks.shape[0]
    c = float(np.float32(dt2))
    minv = (1.0 / mass)[:, None]
    s_t = s_mat.T

    def g_apply(kb, v):
        s = torch.matmul(s_mat, v).reshape(e, dim, dim)  # row j: edge j
        t = torch.einsum("eik,ejk->eji", kb, s).reshape(e * dim, dim)
        return torch.matmul(s_t, t)

    k_t = k_blocks.transpose(-1, -2)

    def apply_a(v):
        return v - c * g_apply(k_blocks, v) * minv

    def apply_at(v):
        return v - c * g_apply(k_t, v * minv)

    if preconditioned:
        res = conjugate_gradient(lambda v: apply_at(apply_a(v)), apply_at(b),
                                 b, max_iter, tol)
    else:
        res = conjugate_gradient(apply_a, b, b, max_iter, tol)
    return res.x, res.iterations


def edge_cg_barriers(variant: str, normal: bool, iterations: int) -> int:
    """Barriers of one K11a solve of ``iterations`` iterations, as
    csrc/edge_cg.cu places them.  The cluster variant: one after the
    copy-in, then csrc/cluster_cg.cuh's solve from x₀ = b — normal
    equations 4 and 5 an iteration, plain 2 and 3 — so 5 + 5·it or
    3 + 3·it (K4's less its element pass and its sums).  The single
    variant: its every ``__syncthreads`` (one after the copy-in; whole_cg.cuh:
    an apply 3, a dot 3) — 13 + 12·it or 7 + 9·it.  The kernel counts the
    barriers it meets (``cg_solve_edge.last_barriers``); the CUDA tests and
    ``chip_smoke.py`` hold that count to this one."""
    per_solve, per_it = {("cluster", True): (5, 5), ("cluster", False): (3, 3),
                         ("single", True): (13, 12),
                         ("single", False): (7, 9)}[(variant, bool(normal))]
    return per_solve + per_it * int(iterations)


def _library():
    lib = cuda_build.load("edge_cg")
    if lib.fem_edge_cg.argtypes is None:
        out = ctypes.POINTER(_I)
        lib.fem_edge_cg_scratch_floats.argtypes = [_I] * 3
        lib.fem_edge_cg_scratch_floats.restype = ctypes.c_longlong
        lib.fem_edge_cg.argtypes = [
            _I, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _F, _P, _P, _P,
            _P, _P, _P,
        ]
        lib.fem_edge_cg.restype = _I
        lib.fem_edge_cg_limits.argtypes = [_I, out, out, out]
        lib.fem_edge_cg_limits.restype = _I
        lib.fem_edge_cg_cluster_smem.argtypes = [_I] * 5
        lib.fem_edge_cg_cluster_smem.restype = ctypes.c_longlong
        lib.fem_edge_cg_cluster_fit.argtypes = [_I, _I, _I, out]
        lib.fem_edge_cg_cluster_fit.restype = _I
        lib.fem_edge_cg_cluster.argtypes = [
            ctypes.POINTER(EdgeCgArgsC), _I, _I, _I, _P]
        lib.fem_edge_cg_cluster.restype = _I
        lib.fem_edge_cg_error.argtypes = [_I]
        lib.fem_edge_cg_error.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=16)
def device_limits(device_index: int, dim: int) -> FrameLimits:
    """The ``FrameLimits`` of CUDA device ``device_index`` for K11a's
    cluster instance of ``dim``."""
    lib = _library()
    mc, optin, sms = _I(0), _I(0), _I(0)
    with torch.cuda.device(device_index):
        rc = lib.fem_edge_cg_limits(dim, ctypes.byref(mc), ctypes.byref(optin),
                                    ctypes.byref(sms))
    if rc != 0:
        raise RuntimeError("edge-matrix CG kernel: reading the device's "
                           f"limits failed: {lib.fem_edge_cg_error(rc).decode()}")
    return FrameLimits(mc.value, optin.value, sms.value)


@functools.lru_cache(maxsize=64)
def _check_cluster(device_index: int, size: int, smem: int, sizes, dim: int):
    """Raise unless the device can run K11a's cluster of ``size`` CTAs with
    ``smem`` bytes each for a rank of ``sizes`` (elements, local particles,
    receive slots, push codes).  Once per plan on a device."""
    lib = _library()
    want = lib.fem_edge_cg_cluster_smem(*sizes, dim)
    if want != smem:
        raise RuntimeError(f"edge-matrix CG kernel: the plan's {smem} B of "
                           f"shared memory differ from the kernel's {want}")
    most = _I(0)
    with torch.cuda.device(device_index):
        rc = lib.fem_edge_cg_cluster_fit(size, smem, dim, ctypes.byref(most))
    if rc != 0:
        raise RuntimeError(
            f"edge-matrix CG kernel: {lib.fem_edge_cg_error(rc).decode()} "
            f"(one cluster of {size} CTAs, {smem} B of shared memory each; "
            f"{most.value} such clusters fit at once)")


# Device → the (1,) int32 tensor K11a's launches there write their barrier
# count to.
_BARRIERS: dict = {}


def cg_solve_edge(
    s_mat: torch.Tensor,
    k_blocks: torch.Tensor,
    b: torch.Tensor,
    mass: torch.Tensor,
    *,
    dim: int,
    dt2: float,
    preconditioned: bool,
    max_iter: int = 500,
    tol: float = 1e-5,
    cluster: int = 0,
    single: bool = False,
):
    """Returns (x (N, d), iterations int32 scalar), on the input's device —
    the contract of the JAX package's ``cg_solve_pallas``.  S is checked
    (and its plan built) on every device.  CUDA tensors: one launch of the
    whole-solve kernel, with no host synchronisation once the plan exists
    (the first call on an S plans on the host; the plan and its assignment
    are kept with S's :class:`EdgePlan`).  The variant is K11b's planner's
    (``fused_frame_plan`` with K11a's four local vectors); ``cluster``
    forces the cluster variant with that many CTAs, ``single`` the single
    variant (tests and ``chip_smoke.py``; a plan the device cannot run
    raises).  The launch's variant and CTAs are left in
    ``cg_solve_edge.last_plan`` and counted in ``variant_launches``; the
    barriers its kernel met in ``cg_solve_edge.last_barriers``, a (1,)
    int32 tensor on the device that the next launch there overwrites
    (:func:`edge_cg_barriers` says what it must hold).  CPU tensors:
    :func:`cg_solve_edge_plain`."""
    if dim not in (2, 3):
        raise ValueError(f"the edge-matrix CG takes dim 2 or 3, not {dim}")
    ep = edge_plan(s_mat, dim)
    if b.device.type == "cpu":
        return cg_solve_edge_plain(
            s_mat, k_blocks, b, mass, dim=dim, dt2=dt2,
            preconditioned=preconditioned, max_iter=max_iter, tol=tol)
    if b.device.type != "cuda":
        raise ValueError(f"unsupported device {b.device}")
    e = s_mat.shape[0] // dim
    n = s_mat.shape[1]
    dev = b.device
    f32 = torch.float32
    cuda_build.check_operand("k_blocks", k_blocks, (e, dim, dim), f32, dev)
    cuda_build.check_operand("b", b, (n, dim), f32, dev)
    cuda_build.check_operand("mass", mass, (n,), f32, dev)
    idx = ep.element_indices
    cuda_build.check_operand("element ids", idx, (e, dim + 1), torch.int32,
                             dev)
    if dim == 3 and idx.data_ptr() % 16:
        raise ValueError("element ids must be 16-byte aligned (int4 loads)")
    lib = _library()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    fplan, tables = ff._planned(idx, ep.plan, n, dim,
                                device_limits(index, dim), int(cluster),
                                bool(single), CLUSTER_VECTORS)
    barriers = _BARRIERS.get(dev)
    if barriers is None:
        barriers = _BARRIERS[dev] = torch.zeros((1,), dtype=torch.int32,
                                                device=dev)
    x = torch.empty((n, dim), dtype=f32, device=dev)
    it = torch.empty((), dtype=torch.int32, device=dev)
    res = torch.empty((), dtype=f32, device=dev)
    normal = int(bool(preconditioned))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if fplan.variant == "cluster":
            sizes, cl = tables
            _check_cluster(index, fplan.size, fplan.smem, sizes, dim)
            elements, cap, entries, pushes = sizes
            args = EdgeCgArgsC(
                k_blocks.data_ptr(), b.data_ptr(), mass.data_ptr(), normal,
                int(max_iter), dt2, tol, x.data_ptr(), it.data_ptr(),
                res.data_ptr(), *(t.data_ptr() for t in cl), cap, elements,
                entries, pushes, barriers.data_ptr())
            rc = lib.fem_edge_cg_cluster(ctypes.byref(args), dim, fplan.size,
                                         fplan.smem, stream)
        else:
            scratch = torch.empty(lib.fem_edge_cg_scratch_floats(dim, e, n),
                                  dtype=f32, device=dev)
            rc = lib.fem_edge_cg(
                dim, k_blocks.data_ptr(), idx.data_ptr(),
                ep.plan.ptr.data_ptr(), ep.plan.rows.data_ptr(), b.data_ptr(),
                mass.data_ptr(), e, n, dt2, normal, max_iter, tol,
                x.data_ptr(), scratch.data_ptr(), it.data_ptr(),
                res.data_ptr(), barriers.data_ptr(), stream,
            )
    if rc != 0:
        msg = lib.fem_edge_cg_error(rc).decode()
        raise RuntimeError(f"edge-matrix CG kernel launch failed "
                           f"({fplan.variant} variant, {fplan.size} CTAs): "
                           f"{msg}")
    cg_solve_edge.launches += 1
    cg_solve_edge.last_plan = fplan
    cg_solve_edge.last_barriers = barriers
    key = (fplan.variant, fplan.size)
    cg_solve_edge.variant_launches[key] = (
        cg_solve_edge.variant_launches.get(key, 0) + 1)
    return x, it


cg_solve_edge.launches = 0
cg_solve_edge.variant_launches = {}
cg_solve_edge.last_plan = None
cg_solve_edge.last_barriers = None
