# coding=utf-8
"""K1, K6, K9a and K9b, the element chains over the mesh's elements (tets in
3D, triangles in 2D).

``hessian_and_force`` (K1: per-element system blocks K_e and rhs force
columns) and ``explicit_grad_columns`` (K6: per-element explicit
energy-gradient columns) launch the hand-written CUDA kernels of
``fem_tpu_torch/csrc/element_chain.cu`` for tensors on a CUDA device; they
replace the JAX package's Pallas kernels ``ops/pallas_kernels.py:
_hessian_and_force_kernel`` (entry ``hessian_and_force_pallas``) and
``_grad_cols_kernel`` (entry ``explicit_grad_columns_pallas``), in the
dimension of the positions (2 or 3).  For tensors on the CPU each runs its
plain PyTorch version (``*_plain``).  On CUDA each launches its kernel or
raises; it never falls back.  Both take every material of
``ops/element.py`` (and K1 ``robust``): the material is a template parameter
of the kernel chosen at launch (``kernel_material_id``), its numbers a
kernel argument (:class:`MaterialParamsC`), and each material's instances
live in a library of their own (``utils/cuda_build.load``).  The
rest-edge inverses are per element already, so an inelastic layer's
dynamic R⁻¹·F_i⁻¹ passes as ``ref_inv``.  Each wrapper counts its launches
in total (``launches``) and by (dimension, material instance)
(``instance_launches``).

All four element kernels (K1, K6, K9a, K9b) run one thread an element in
CTAs of ``ELEMENT_TILE`` (32) elements, a tile: :func:`element_plan` gives
the CTAs and the ragged last tile of a launch, and each wrapper leaves its
launch's plan in ``last_plan``.  What a launch keeps fixed for a
(material, ``robust``, μ, λ, d) — the material's numbers as the kernel
argument and the library's entry — is bound once (:func:`element_binding`).

``hessian_blocks`` (K9a: the blocks K_e alone) and ``implicit_force_columns``
(K9b: the rhs force columns alone) launch the two halves of K1's
Neo-Hookean chain, entries of the same CUDA source; they replace
``ops/pallas_kernels.py:_hessian_kernel`` (entry ``hessian_blocks_pallas``)
and ``_implicit_force_kernel`` (entry ``implicit_force_columns_pallas``).
Like those, they take the non-robust Neo-Hookean material only.  Their
plain versions are ``ops/element``'s ``hessian_blocks`` and
``implicit_force_columns`` with ``robust=False``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from fem_tpu_torch.ops import element
from fem_tpu_torch.ops.element import (
    MATERIAL_IDS,
    ROBUST_NEO_HOOKEAN_ID,
    deformation_gradients,
    k_and_h_chain,
    kernel_material_id,
    material_constants,
)
# The plain version of K6 is the element module's +V·P(F)·R⁻ᵀ columns.
from fem_tpu_torch.ops.element import (  # noqa: F401
    explicit_grad_columns as explicit_grad_columns_plain,
)
from fem_tpu_torch.utils import cuda_build

_P = ctypes.c_void_p


class MaterialParamsC(ctypes.Structure):
    """Mirror of ``fem::MaterialParams`` (csrc/element_chain.cuh)."""

    _fields_ = [(name, ctypes.c_float) for name in (
        "mu", "lam", "half_lam", "lam_p", "two_mu", "c1x2", "c2x2",
        "lam_log", "k_log", "a0", "a1", "a2", "two_k")]


def material_params(material: str, mu: float, lam: float,
                    d: int) -> MaterialParamsC:
    """The kernel argument of ``material``'s numbers: computed in float64
    (``ops/element.material_constants``), rounded once to f32 here."""
    return MaterialParamsC(**material_constants(material, mu, lam, d))


def count_launch(fn, *instance) -> None:
    """One launch of ``fn``'s kernel: its total count, and its count by
    instance — (dimension, material id), and for the whole frames whether
    the inelastic branches are on — in ``fn.instance_launches``."""
    fn.launches += 1
    fn.instance_launches[instance] = fn.instance_launches.get(instance, 0) + 1


def hessian_and_force_plain(pos, element_indices, ref_inv, volume, mu, lam,
                            material="neo_hookean", robust=False):
    """(K (E, d, d), rhs force columns (E, d, d)) in plain PyTorch: one F
    chain shared by both outputs, as in the kernel."""
    f = deformation_gradients(pos, element_indices, ref_inv)
    k, h = k_and_h_chain(f, ref_inv, mu, lam, material, robust)
    nv = -volume[:, None, None]
    return nv * k, nv * h


def _library(material_id: int):
    lib = cuda_build.load("element_chain", material_id)
    if lib.fem_hessian_and_force.argtypes is None:
        params = ctypes.POINTER(MaterialParamsC)
        lib.fem_hessian_and_force.argtypes = [
            ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, ctypes.c_int, params,
            _P, _P, _P,
        ]
        lib.fem_hessian_and_force.restype = ctypes.c_int
        lib.fem_explicit_grad_columns.argtypes = [
            ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, ctypes.c_int, params,
            _P, _P,
        ]
        lib.fem_explicit_grad_columns.restype = ctypes.c_int
        for fn in (lib.fem_hessian_blocks, lib.fem_implicit_force):
            fn.argtypes = [ctypes.c_int, _P, _P, _P, _P, ctypes.c_int,
                           params, _P, _P]
            fn.restype = ctypes.c_int
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


# Elements a CTA of K1, K6, K9a and K9b: csrc/element_chain.cu's kTile.
# The fastest of 32-256 elements a CTA in 2D and 3D at every size swept on
# the H100 (200-4,068 elements; PERF.md §6).
ELEMENT_TILE = 32

# The material instances each element kernel takes: K1 every material and
# robust Neo-Hookean, K6 the base materials (its chain has no robust
# variant), K9a and K9b the non-robust Neo-Hookean alone.
_NEO_HOOKEAN = frozenset({MATERIAL_IDS["neo_hookean"]})
KERNEL_MATERIALS = {
    "K1": frozenset(MATERIAL_IDS.values()) | {ROBUST_NEO_HOOKEAN_ID},
    "K6": frozenset(MATERIAL_IDS.values()),
    "K9a": _NEO_HOOKEAN,
    "K9b": _NEO_HOOKEAN,
}


class ElementPlan(NamedTuple):
    """A launch of K1, K6, K9a or K9b over E elements."""

    tile: int  # elements a CTA, one thread each
    ctas: int  # ⌈E / tile⌉
    last: int  # elements of the last, ragged tile (0 when E = 0)


@functools.lru_cache(maxsize=256)
def element_plan(num_elements: int, dim: int, material_id: int,
                 kernel: str) -> ElementPlan:
    """The launch of ``kernel`` (K1, K6, K9a or K9b) in its instance
    ``material_id`` over ``num_elements`` elements in ``dim`` dimensions; a
    launch the kernels do not take (``KERNEL_MATERIALS``) raises
    ``ValueError``.  Pure: no device is asked."""
    if dim not in (2, 3):
        raise ValueError(f"the element-chain kernels take dim 2 or 3, not "
                         f"{dim}")
    if num_elements < 0:
        raise ValueError(f"{num_elements} elements")
    if material_id not in KERNEL_MATERIALS.get(kernel, ()):
        raise ValueError(f"no element-chain kernel {kernel!r} for material "
                         f"instance {material_id}")
    ctas = -(-num_elements // ELEMENT_TILE)
    last = num_elements - (ctas - 1) * ELEMENT_TILE if ctas else 0
    return ElementPlan(ELEMENT_TILE, ctas, last)


class ElementBinding:
    """What every launch of K1, K6, K9a or K9b keeps fixed for one (material,
    ``robust``, μ, λ, d): the material's numbers as the kernel argument
    (:class:`MaterialParamsC`, computed once) and the library of its
    instance with its entries' argument types (loaded at the first
    launch).  Built by :func:`element_binding`."""

    def __init__(self, material: str, robust: bool, mu: float, lam: float,
                 d: int):
        self.mid = kernel_material_id(material, robust)
        self.d = d
        self.params = material_params(material, mu, lam, d)
        self.ref = ctypes.byref(self.params)
        self._lib = None

    @property
    def lib(self):
        if self._lib is None:
            self._lib = _library(self.mid)
        return self._lib

    def launch(self, fn, what: str, dev: torch.device, entry: str,
               *args) -> None:
        """``entry(*args, stream)`` on ``dev``'s current stream; raises on a
        launch error, else counts the launch on ``fn``."""
        rc = cuda_build.launch_on_stream(dev, dev.index,
                                         getattr(self.lib, entry), *args)
        if rc != 0:
            msg = self.lib.fem_element_chain_error(rc).decode()
            raise RuntimeError(f"{what} kernel launch failed: {msg}")
        count_launch(fn, self.d, self.mid)


# (material, robust, μ, λ, d) → its ElementBinding.
_BINDINGS: dict = {}


def element_binding(material: str, robust: bool, mu: float, lam: float,
                    d: int) -> ElementBinding:
    """The :class:`ElementBinding` of (material, ``robust``, μ, λ, d),
    built once."""
    key = (material, bool(robust), float(mu), float(lam), int(d))
    hit = _BINDINGS.get(key)
    if hit is None:
        hit = ElementBinding(material, robust, mu, lam, d)
        if len(_BINDINGS) >= 64:
            _BINDINGS.pop(next(iter(_BINDINGS)))
        _BINDINGS[key] = hit
    return hit


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

    CUDA tensors: one launch of the element-chain kernel's instance of
    ``material`` (robust Neo-Hookean when ``robust``; ``robust`` leaves every
    other material's chain as it is), 2D or 3D, in tiles of
    ``ELEMENT_TILE`` elements, the plan left in
    ``hessian_and_force.last_plan``.  CPU tensors:
    :func:`hessian_and_force_plain`."""
    if pos.device.type == "cpu":
        kernel_material_id(material, robust)
        return hessian_and_force_plain(
            pos, element_indices, ref_inv, volume, mu, lam, material, robust
        )
    e, d, dev = _check_elements(pos, element_indices, ref_inv, volume)
    b = element_binding(material, robust, mu, lam, d)
    plan = element_plan(e, d, b.mid, "K1")
    k = torch.empty((e, d, d), dtype=torch.float32, device=dev)
    h = torch.empty((e, d, d), dtype=torch.float32, device=dev)
    b.launch(hessian_and_force, "element-chain", dev, "fem_hessian_and_force",
             d, b.mid, pos.data_ptr(), element_indices.data_ptr(),
             ref_inv.data_ptr(), volume.data_ptr(), e, b.ref, k.data_ptr(),
             h.data_ptr())
    hessian_and_force.last_plan = plan
    return k, h


hessian_and_force.launches = 0
hessian_and_force.instance_launches = {}
hessian_and_force.last_plan = None


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

    CUDA tensors: one launch of K6's instance of ``material``, 2D or 3D,
    in tiles of ``ELEMENT_TILE`` elements, the plan left in
    ``explicit_grad_columns.last_plan``.  CPU tensors:
    :func:`explicit_grad_columns_plain`."""
    if pos.device.type == "cpu":
        kernel_material_id(material)
        return explicit_grad_columns_plain(
            pos, element_indices, ref_inv, volume, mu, lam, material
        )
    e, d, dev = _check_elements(pos, element_indices, ref_inv, volume)
    b = element_binding(material, False, mu, lam, d)
    plan = element_plan(e, d, b.mid, "K6")
    g = torch.empty((e, d, d), dtype=torch.float32, device=dev)
    b.launch(explicit_grad_columns, "gradient-columns", dev,
             "fem_explicit_grad_columns", d, b.mid, pos.data_ptr(),
             element_indices.data_ptr(), ref_inv.data_ptr(),
             volume.data_ptr(), e, b.ref, g.data_ptr())
    explicit_grad_columns.last_plan = plan
    return g


explicit_grad_columns.launches = 0
explicit_grad_columns.instance_launches = {}
explicit_grad_columns.last_plan = None


def hessian_blocks_plain(pos, element_indices, ref_inv, volume, mu, lam):
    """Plain PyTorch version of :func:`hessian_blocks`."""
    return element.hessian_blocks(pos, element_indices, ref_inv, volume, mu,
                                  lam, False)


def implicit_force_columns_plain(pos, element_indices, ref_inv, volume, mu,
                                 lam):
    """Plain PyTorch version of :func:`implicit_force_columns`."""
    return element.implicit_force_columns(pos, element_indices, ref_inv,
                                          volume, mu, lam, False)


def hessian_blocks(pos: torch.Tensor, element_indices: torch.Tensor,
                   ref_inv: torch.Tensor, volume: torch.Tensor, mu: float,
                   lam: float) -> torch.Tensor:
    """The Neo-Hookean implicit system blocks K_e (E, d, d), non-robust.

    CUDA tensors: one launch of K9a, 2D or 3D, in tiles of
    ``ELEMENT_TILE`` elements as K1's, the plan left in
    ``hessian_blocks.last_plan``.  CPU tensors:
    :func:`hessian_blocks_plain`."""
    if pos.device.type == "cpu":
        return hessian_blocks_plain(pos, element_indices, ref_inv, volume,
                                    mu, lam)
    e, d, dev = _check_elements(pos, element_indices, ref_inv, volume)
    b = element_binding("neo_hookean", False, mu, lam, d)
    plan = element_plan(e, d, b.mid, "K9a")
    out = torch.empty((e, d, d), dtype=torch.float32, device=dev)
    b.launch(hessian_blocks, "K9a blocks", dev, "fem_hessian_blocks", d,
             pos.data_ptr(), element_indices.data_ptr(), ref_inv.data_ptr(),
             volume.data_ptr(), e, b.ref, out.data_ptr())
    hessian_blocks.last_plan = plan
    return out


hessian_blocks.launches = 0
hessian_blocks.instance_launches = {}
hessian_blocks.last_plan = None


def implicit_force_columns(pos: torch.Tensor, element_indices: torch.Tensor,
                           ref_inv: torch.Tensor, volume: torch.Tensor,
                           mu: float, lam: float) -> torch.Tensor:
    """The Neo-Hookean implicit rhs force columns (E, d, d), non-robust
    (the λ/2·log det F² form).

    CUDA tensors: one launch of K9b, 2D or 3D, in tiles of
    ``ELEMENT_TILE`` elements as K1's, the plan left in
    ``implicit_force_columns.last_plan``.  CPU tensors:
    :func:`implicit_force_columns_plain`."""
    if pos.device.type == "cpu":
        return implicit_force_columns_plain(pos, element_indices, ref_inv,
                                            volume, mu, lam)
    e, d, dev = _check_elements(pos, element_indices, ref_inv, volume)
    b = element_binding("neo_hookean", False, mu, lam, d)
    plan = element_plan(e, d, b.mid, "K9b")
    out = torch.empty((e, d, d), dtype=torch.float32, device=dev)
    b.launch(implicit_force_columns, "K9b force-columns", dev,
             "fem_implicit_force", d, pos.data_ptr(),
             element_indices.data_ptr(), ref_inv.data_ptr(),
             volume.data_ptr(), e, b.ref, out.data_ptr())
    implicit_force_columns.last_plan = plan
    return out


implicit_force_columns.launches = 0
implicit_force_columns.instance_launches = {}
implicit_force_columns.last_plan = None
