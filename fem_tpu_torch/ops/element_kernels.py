# coding=utf-8
"""K1 and K6, the element chains over the mesh's elements (tets in 3D,
triangles in 2D).

``hessian_and_force`` (K1: per-element system blocks K_e and rhs force
columns) and ``explicit_grad_columns`` (K6: per-element explicit
energy-gradient columns) launch the hand-written CUDA kernels of
``fem_tpu_torch/csrc/element_chain.cu`` for tensors on a CUDA device; they
replace the JAX package's Pallas kernels ``ops/pallas_kernels.py:
_hessian_and_force_kernel`` (entry ``hessian_and_force_pallas``) and
``_grad_cols_kernel`` (entry ``explicit_grad_columns_pallas``), in the
dimension of the positions (2 or 3; one kernel template, two instances).
For tensors on the CPU each runs its plain PyTorch version (``*_plain``).  On
CUDA each launches its kernel or raises; it never falls back.  Both take the
material of one layer (ops/inelastic.py): Neo-Hookean, or stable
Neo-Hookean for the Maxwell branch, a template parameter of the kernel
chosen at launch; the rest-edge inverses are per element already, so a
layer's dynamic R⁻¹·F_i⁻¹ passes as ``ref_inv``.
"""

from __future__ import annotations

import ctypes

import torch

from fem_tpu_torch.ops.element import (
    MATERIAL_IDS,
    check_material,
    deformation_gradients,
    k_and_h_chain,
)
# The plain version of K6 is the element module's +V·P(F)·R⁻ᵀ columns.
from fem_tpu_torch.ops.element import (  # noqa: F401
    explicit_grad_columns as explicit_grad_columns_plain,
)
from fem_tpu_torch.utils import cuda_build

_P = ctypes.c_void_p


def hessian_and_force_plain(pos, element_indices, ref_inv, volume, mu, lam,
                            material="neo_hookean"):
    """(K (E, d, d), rhs force columns (E, d, d)) in plain PyTorch: one F
    chain shared by both outputs, as in the kernel."""
    f = deformation_gradients(pos, element_indices, ref_inv)
    k, h = k_and_h_chain(f, ref_inv, mu, lam, material)
    nv = -volume[:, None, None]
    return nv * k, nv * h


def _library():
    lib = cuda_build.load("element_chain")
    if lib.fem_hessian_and_force.argtypes is None:
        lib.fem_hessian_and_force.argtypes = [
            ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, _P, _P, _P,
        ]
        lib.fem_hessian_and_force.restype = ctypes.c_int
        lib.fem_explicit_grad_columns.argtypes = [
            ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, _P, _P,
        ]
        lib.fem_explicit_grad_columns.restype = ctypes.c_int
        lib.fem_element_chain_error.argtypes = [ctypes.c_int]
        lib.fem_element_chain_error.restype = ctypes.c_char_p
    return lib


def _check_elements(pos, element_indices, ref_inv, volume):
    """(E, d, device) of a CUDA launch over the elements, after checking
    what the kernels take: d 2 or 3, f32 and int32, contiguous, and in 3D
    int4-aligned indices."""
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    n, d = pos.shape
    if d not in (2, 3):
        raise ValueError(f"the element-chain kernels take dim 2 or 3, not {d}")
    e = element_indices.shape[0]
    dev = pos.device
    cuda_build.check_operand("pos", pos, (n, d), torch.float32, dev)
    cuda_build.check_operand(
        "element_indices", element_indices, (e, d + 1), torch.int32, dev
    )
    cuda_build.check_operand("ref_inv", ref_inv, (e, d, d), torch.float32, dev)
    cuda_build.check_operand("volume", volume, (e,), torch.float32, dev)
    if d == 3 and element_indices.data_ptr() % 16:
        raise ValueError("element_indices must be 16-byte aligned (int4 loads)")
    return e, d, dev


def hessian_and_force(
    pos: torch.Tensor,
    element_indices: torch.Tensor,
    ref_inv: torch.Tensor,
    volume: torch.Tensor,
    mu: float,
    lam: float,
    robust: bool = False,
    material: str = "neo_hookean",
):
    """(K (E, d, d), rhs force columns (E, d, d)) of the implicit substep.

    CUDA tensors: one launch of the element-chain kernel (Neo-Hookean or
    stable Neo-Hookean, non-robust, 2D or 3D).  CPU tensors:
    :func:`hessian_and_force_plain`."""
    check_material(material)
    if robust:
        raise NotImplementedError(
            "robust_inversion is not ported yet (ROADMAP M11)"
        )
    if pos.device.type == "cpu":
        return hessian_and_force_plain(
            pos, element_indices, ref_inv, volume, mu, lam, material
        )
    e, d, dev = _check_elements(pos, element_indices, ref_inv, volume)
    k = torch.empty((e, d, d), dtype=torch.float32, device=dev)
    h = torch.empty((e, d, d), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fem_hessian_and_force(
            d, MATERIAL_IDS[material], pos.data_ptr(),
            element_indices.data_ptr(), ref_inv.data_ptr(), volume.data_ptr(),
            e, mu, lam, lam / 2.0, k.data_ptr(), h.data_ptr(), stream,
        )
    if rc != 0:
        msg = lib.fem_element_chain_error(rc).decode()
        raise RuntimeError(f"element-chain kernel launch failed: {msg}")
    hessian_and_force.launches += 1
    return k, h


hessian_and_force.launches = 0


def explicit_grad_columns(
    pos: torch.Tensor,
    element_indices: torch.Tensor,
    ref_inv: torch.Tensor,
    volume: torch.Tensor,
    mu: float,
    lam: float,
    material: str = "neo_hookean",
) -> torch.Tensor:
    """Explicit energy-gradient columns (E, d, d): column j of element e
    goes to its vertex j+1, −Σ_j to vertex 0.

    CUDA tensors: one launch of the gradient-columns kernel (Neo-Hookean or
    stable Neo-Hookean, 2D or 3D).  CPU tensors:
    :func:`explicit_grad_columns_plain`."""
    check_material(material)
    if pos.device.type == "cpu":
        return explicit_grad_columns_plain(
            pos, element_indices, ref_inv, volume, mu, lam, material
        )
    e, d, dev = _check_elements(pos, element_indices, ref_inv, volume)
    g = torch.empty((e, d, d), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fem_explicit_grad_columns(
            d, MATERIAL_IDS[material], pos.data_ptr(),
            element_indices.data_ptr(), ref_inv.data_ptr(), volume.data_ptr(),
            e, mu, lam, g.data_ptr(), stream,
        )
    if rc != 0:
        msg = lib.fem_element_chain_error(rc).decode()
        raise RuntimeError(f"gradient-columns kernel launch failed: {msg}")
    explicit_grad_columns.launches += 1
    return g


explicit_grad_columns.launches = 0
