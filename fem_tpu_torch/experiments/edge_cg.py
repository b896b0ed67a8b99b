# coding=utf-8
"""K11a, the whole reference CG over the edge-matrix operator.

``cg_solve_edge`` launches the hand-written CUDA kernel
``fem_tpu_torch/csrc/edge_cg.cu`` for tensors on a CUDA device; it replaces
the JAX package's Pallas kernel ``experiments/pallas_cg.py:_cg_kernel``
(entry ``cg_solve_pallas``), in the dimension of the velocities (2 or 3).
For tensors on the CPU it runs ``cg_solve_edge_plain``, the JAX kernel's
formulation: the operator as products with the dense S (``torch.matmul``,
TF32 off) and the port's reference CG loop.  On CUDA it launches the kernel
or raises; it never falls back.

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
from typing import NamedTuple

import numpy as np
import torch

from fem_tpu_torch.ops.assembly import GatherPlan, make_gather_plan
from fem_tpu_torch.ops.cg_kernels import conjugate_gradient
from fem_tpu_torch.utils import cuda_build

_P = ctypes.c_void_p


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
    counterpart: the kernel never holds S, its scratch is O(E + N) floats
    of device memory, and its one CTA walks elements and particles in
    grid-stride loops, so every mesh whose S ``build_object`` attaches
    (E·d·N ≤ 16,000,000) fits the card."""
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


def _library():
    lib = cuda_build.load("edge_cg")
    if lib.fem_edge_cg.argtypes is None:
        lib.fem_edge_cg_scratch_floats.argtypes = [ctypes.c_int] * 3
        lib.fem_edge_cg_scratch_floats.restype = ctypes.c_longlong
        lib.fem_edge_cg.argtypes = [
            ctypes.c_int, _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, _P,
            _P, _P, _P, _P,
        ]
        lib.fem_edge_cg.restype = ctypes.c_int
        lib.fem_edge_cg_error.argtypes = [ctypes.c_int]
        lib.fem_edge_cg_error.restype = ctypes.c_char_p
    return lib


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
):
    """Returns (x (N, d), iterations int32 scalar), on the input's device —
    the contract of the JAX package's ``cg_solve_pallas``.  S is checked
    (and its plan built) on every device.  CUDA tensors: one launch of the
    whole-solve kernel, with no host synchronisation once the plan exists.
    CPU tensors: :func:`cg_solve_edge_plain`."""
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
    x = torch.empty((n, dim), dtype=f32, device=dev)
    scratch = torch.empty(lib.fem_edge_cg_scratch_floats(dim, e, n),
                          dtype=f32, device=dev)
    it = torch.empty((), dtype=torch.int32, device=dev)
    res = torch.empty((), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fem_edge_cg(
            dim, k_blocks.data_ptr(), idx.data_ptr(), ep.plan.ptr.data_ptr(),
            ep.plan.rows.data_ptr(), b.data_ptr(), mass.data_ptr(), e, n,
            dt2, int(bool(preconditioned)), max_iter, tol, x.data_ptr(),
            scratch.data_ptr(), it.data_ptr(), res.data_ptr(), stream,
        )
    if rc != 0:
        msg = lib.fem_edge_cg_error(rc).decode()
        raise RuntimeError(f"edge-matrix CG kernel launch failed: {msg}")
    cg_solve_edge.launches += 1
    return x, it


cg_solve_edge.launches = 0
