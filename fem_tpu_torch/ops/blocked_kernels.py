# coding=utf-8
"""K2, K7b, K3 and K7a: the blocked element prep, the blocked operator and
the blocked assembly.

``blocked_prep`` and ``blocked_grad_prep`` launch
``fem_tpu_torch/csrc/blocked.cu``'s prep kernels for tensors on a CUDA
device; they replace the JAX package's Pallas kernel
``ops/blocking.py:_prep_kernel`` in its implicit mode (entry
``blocked_prep``, K2) and its explicit mode (entry ``blocked_grad_prep``,
K7b).  ``blocked_graph_apply`` launches the same file's matvec and slot-sum
kernels; it replaces ``ops/blocking.py:_matvec_kernel`` (entry
``blocked_graph_apply``, K3).  ``blocked_assemble`` launches its assembly
and slot-sum kernels; it replaces ``ops/blocking.py:_scatter_kernel``
(entry ``blocked_assemble``, K7a).  Each launches the instance of the
blocking's dimension (2 or 3; one kernel template, two instances).  For
tensors on the CPU each runs its plain PyTorch version (``*_plain``); on
CUDA each launches its kernel or raises.

``blocked_edges`` launches the same file's edges kernel; it replaces the
edges mode of ``ops/blocking.py:_prep_kernel`` (entry
``blocked_edge_planes``, K7b edges): the edge matrix of every element slot
in block order, for the inelastic update (``ops/inelastic.py``).

The preps take a material layer (ops/inelastic.py): an optional dynamic
rest-edge inverse per slot (``ref_inv``, (B·Eb, d, d); the blocking's own
when None) and the material, any of ``ops/element.py``'s (and for K2
``robust``).  The dynamic inverse is the same table pointer the kernel
reads anyway, the material a template parameter chosen at launch
(``kernel_material_id``, one library per material), and its numbers a
kernel argument, so the static Neo-Hookean launch runs the arithmetic it
always ran.  The preps count their launches in total and by (dimension,
material instance), as ``ops/element_kernels`` does.

Layouts: K blocks and element columns are ``(B·Eb, d, d)`` in block order
(the JAX package's ``kplane_to_kflat`` of its (B, d², Eb·d) planes);
per-slot partials are ``(B, Pb, d)`` (the JAX package's (B, d, Pb)
transposed).  Padded element slots give K = 0 and contribute nothing.
"""

from __future__ import annotations

import ctypes

import torch

from fem_tpu_torch.ops import smallmat as sm
from fem_tpu_torch.ops.assembly import element_contrib_full
from fem_tpu_torch.ops.blocking import (
    Blocking,
    blocked_gather,
    blocked_scatter_sum,
)
from fem_tpu_torch.ops.cg_kernels import (
    CGResult,
    cg_solve_dispatch,
    system_coeff,
)
from fem_tpu_torch.ops.element import (
    MATERIAL_IDS,
    grad_cols_chain,
    k_and_h_chain,
    kernel_material_id,
)
from fem_tpu_torch.ops.element_kernels import (
    MaterialParamsC,
    count_launch,
    material_params,
)
from fem_tpu_torch.utils import cuda_build

_P = ctypes.c_void_p


class BlockTablesC(ctypes.Structure):
    """Mirror of ``fem::BlockTables`` (csrc/blocked_common.cuh)."""

    _fields_ = [
        ("block_particles", _P),
        ("plus", _P),
        ("minus", _P),
        ("ref_inv", _P),
        ("volume", _P),
        ("block_elements", _P),
        ("local_ptr", _P),
        ("local_rows", _P),
        ("num_blocks", ctypes.c_int),
        ("eb", ctypes.c_int),
        ("pb", ctypes.c_int),
        ("dim", ctypes.c_int),
    ]


def block_tables(blk: Blocking, ref_inv=None) -> BlockTablesC:
    """The C view of ``blk``'s device tables (which ``blk`` keeps alive),
    with its dimension d (2 or 3); ``ref_inv`` (B·Eb, d, d), when given,
    stands in for the blocking's rest-edge inverses (the caller keeps it
    alive)."""
    d = blk.dim
    if d not in (2, 3):
        raise ValueError(f"the blocked kernels take dim 2 or 3, not {d}")
    dev = blk.volume.device
    b, eb, pb = blk.num_blocks, blk.eb, blk.pb
    i32, f32 = torch.int32, torch.float32
    for name, shape, dtype in (
        ("block_particles", (b, pb), i32), ("plus", (b, eb * d), i32),
        ("minus", (b, eb * d), i32), ("ref_inv", (b * eb, d, d), f32),
        ("volume", (b * eb,), f32), ("block_elements", (b,), i32),
        ("local_ptr", (b, pb + 1), i32),
        ("local_rows", (b, eb * (d + 1)), i32),
    ):
        cuda_build.check_operand(
            f"blocking.{name}", getattr(blk, name), shape, dtype, dev
        )
    if ref_inv is None:
        ref_inv = blk.ref_inv
    else:
        cuda_build.check_operand("ref_inv", ref_inv, (b * eb, d, d), f32, dev)
    return BlockTablesC(
        blk.block_particles.data_ptr(), blk.plus.data_ptr(),
        blk.minus.data_ptr(), ref_inv.data_ptr(), blk.volume.data_ptr(),
        blk.block_elements.data_ptr(), blk.local_ptr.data_ptr(),
        blk.local_rows.data_ptr(), b, eb, pb, d,
    )


def block_edge_matrices(blk: Blocking, xb: torch.Tensor) -> torch.Tensor:
    """(B·Eb, d, d) edge matrices (columns x_{v_{j+1}} − x_{v_0}) of every
    element slot from block-local rows ``xb`` (B, Pb, d); padded slots give
    0 (callers mask them)."""
    b, pb, d = xb.shape
    flat = xb.reshape(b * pb, d)
    off = (torch.arange(b, device=xb.device) * pb)[:, None]
    xp = flat[(blk.plus + off).reshape(-1)]
    xm = flat[(blk.minus + off).reshape(-1)]
    return (xp - xm).reshape(b * blk.eb, d, d).transpose(-1, -2)


def _real_slots(blk: Blocking) -> torch.Tensor:
    """(B·Eb, 1, 1) bool: element slots that hold a real element."""
    e = torch.arange(blk.eb, device=blk.volume.device)
    return (e[None, :] < blk.block_elements[:, None]).reshape(-1, 1, 1)


def _slot_partials(blk: Blocking, columns: torch.Tensor) -> torch.Tensor:
    """(B, Pb, d) per-slot sums of the element contributions of ``columns``
    (B·Eb, d, d): column j to local vertex j+1, −Σ_j to vertex 0."""
    d = columns.shape[-1]
    rows = element_contrib_full(columns).reshape(-1, d)
    out = columns.new_zeros((blk.num_blocks * blk.pb, d))
    out.index_add_(0, blk.row_slot, rows)
    return out.reshape(blk.num_blocks, blk.pb, d)


def blocked_prep_layers_plain(blk: Blocking, pos, layers, robust=False):
    """(K (B·Eb, d, d), force partials (B, Pb, d)) of material ``layers``
    — (rest-edge inverse (B·Eb, d, d), μ, λ, material) tuples — with each
    element's k and h summed over the layers before the −V scaling, as the
    whole-frame kernel K5 sums them; ``robust`` as in ``k_and_h_chain``."""
    x = block_edge_matrices(blk, blocked_gather(pos, blk))
    k = h = None
    for r, mu, lam, material in layers:
        k_l, h_l = k_and_h_chain(sm.matmul(x, r), r, mu, lam, material,
                                 robust)
        k = k_l if k is None else k + k_l
        h = h_l if h is None else h + h_l
    real = _real_slots(blk)
    nv = -blk.volume[:, None, None]
    k = torch.where(real, nv * k, 0.0)
    h = torch.where(real, nv * h, 0.0)
    return k, _slot_partials(blk, h)


def blocked_grad_columns_layers_plain(blk: Blocking, pos, layers):
    """Block-ordered explicit gradient columns (B·Eb, d, d) of material
    ``layers`` (as :func:`blocked_prep_layers_plain`), summed over the
    layers before the +V scaling, as K8 sums them.  Padded slots (X = 0,
    NaN through the unclamped log) are dropped by the mask."""
    x = block_edge_matrices(blk, blocked_gather(pos, blk))
    g = None
    for r, mu, lam, material in layers:
        g_l = grad_cols_chain(sm.matmul(x, r), r, mu, lam, material)
        g = g_l if g is None else g + g_l
    return torch.where(_real_slots(blk), blk.volume[:, None, None] * g, 0.0)


def blocked_grad_prep_layers_plain(blk: Blocking, pos, layers):
    """Per-slot partials (B, Pb, d) of :func:`blocked_grad_columns_layers_plain`."""
    return _slot_partials(blk, blocked_grad_columns_layers_plain(blk, pos,
                                                                 layers))


def blocked_prep_plain(blk: Blocking, pos, mu: float, lam: float,
                       ref_inv=None, material: str = "neo_hookean",
                       robust: bool = False):
    """Plain PyTorch version of :func:`blocked_prep`."""
    r = blk.ref_inv if ref_inv is None else ref_inv
    return blocked_prep_layers_plain(blk, pos, [(r, mu, lam, material)],
                                     robust)


def blocked_grad_prep_plain(blk: Blocking, pos, mu: float, lam: float,
                            ref_inv=None, material: str = "neo_hookean"):
    """Plain PyTorch version of :func:`blocked_grad_prep`."""
    r = blk.ref_inv if ref_inv is None else ref_inv
    return blocked_grad_prep_layers_plain(blk, pos, [(r, mu, lam, material)])


def blocked_edges_plain(blk: Blocking, pos) -> torch.Tensor:
    """Plain PyTorch version of :func:`blocked_edges`."""
    x = block_edge_matrices(blk, blocked_gather(pos, blk))
    return torch.where(_real_slots(blk), x, sm.inv(blk.ref_inv))


def blocked_assemble_plain(blk: Blocking, cols):
    """Plain PyTorch version of :func:`blocked_assemble`."""
    cols = torch.where(_real_slots(blk), cols, 0.0)
    return blocked_scatter_sum(_slot_partials(blk, cols), blk)


def blocked_graph_apply_plain(blk: Blocking, K, x, transpose_k: bool = False):
    """Plain PyTorch version of :func:`blocked_graph_apply`."""
    s = block_edge_matrices(blk, blocked_gather(x, blk))
    t = sm.matmul(sm.mT(K) if transpose_k else K, s)
    t = torch.where(_real_slots(blk), t, 0.0)
    return blocked_scatter_sum(_slot_partials(blk, t), blk)


def _library(material_id: int = MATERIAL_IDS["neo_hookean"]):
    """The blocked kernels' library of one material's preps; the
    material-independent kernels (K3, K7a, K7b edges) are in each, and
    their wrappers take the Neo-Hookean one."""
    lib = cuda_build.load("blocked", material_id)
    if lib.fem_blocked_prep.argtypes is None:
        tables = ctypes.POINTER(BlockTablesC)
        params = ctypes.POINTER(MaterialParamsC)
        lib.fem_blocked_prep.argtypes = [
            tables, _P, params, ctypes.c_int, _P, _P, _P,
        ]
        lib.fem_blocked_prep.restype = ctypes.c_int
        lib.fem_blocked_matvec.argtypes = [
            tables, _P, _P, ctypes.c_int, _P, _P, ctypes.c_int, _P, _P, _P,
        ]
        lib.fem_blocked_matvec.restype = ctypes.c_int
        lib.fem_blocked_grad_prep.argtypes = [
            tables, _P, params, ctypes.c_int, _P, _P,
        ]
        lib.fem_blocked_grad_prep.restype = ctypes.c_int
        lib.fem_blocked_edges.argtypes = [tables, _P, _P, _P]
        lib.fem_blocked_edges.restype = ctypes.c_int
        lib.fem_blocked_assemble.argtypes = [
            tables, _P, _P, _P, ctypes.c_int, _P, _P, _P,
        ]
        lib.fem_blocked_assemble.restype = ctypes.c_int
        lib.fem_blocked_error.argtypes = [ctypes.c_int]
        lib.fem_blocked_error.restype = ctypes.c_char_p
    return lib


def _check_rc(lib, rc, what):
    if rc != 0:
        msg = lib.fem_blocked_error(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg}")


def blocked_prep(blk: Blocking, pos: torch.Tensor, mu: float, lam: float,
                 ref_inv=None, material: str = "neo_hookean",
                 robust: bool = False):
    """(K (B·Eb, d, d), force partials (B, Pb, d)) of the implicit substep
    at ``pos``: K_e = −V·k and the slot sums of the −V·h force columns, of
    one material layer (``ref_inv``: a dynamic rest-edge inverse per slot,
    the blocking's own when None).

    CUDA tensors: one launch of the blocked prep kernel's instance of
    ``material`` (robust Neo-Hookean when ``robust``), 2D or 3D.  CPU
    tensors: :func:`blocked_prep_plain`."""
    mid = kernel_material_id(material, robust)
    if pos.device.type == "cpu":
        return blocked_prep_plain(blk, pos, mu, lam, ref_inv, material, robust)
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    tables = block_tables(blk, ref_inv)
    n, d = pos.shape[0], tables.dim
    cuda_build.check_operand("pos", pos, (n, d), torch.float32, blk.volume.device)
    dev = pos.device
    k = torch.empty((blk.num_blocks * blk.eb, d, d), dtype=torch.float32,
                    device=dev)
    partials = torch.empty((blk.num_blocks, blk.pb, d), dtype=torch.float32,
                           device=dev)
    params = material_params(material, mu, lam, d)
    lib = _library(mid)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fem_blocked_prep(
            ctypes.byref(tables), pos.data_ptr(), ctypes.byref(params), mid,
            k.data_ptr(), partials.data_ptr(), stream,
        )
    _check_rc(lib, rc, "blocked prep")
    count_launch(blocked_prep, d, mid)
    return k, partials


blocked_prep.launches = 0
blocked_prep.instance_launches = {}


def blocked_grad_prep(blk: Blocking, pos: torch.Tensor, mu: float,
                      lam: float, ref_inv=None,
                      material: str = "neo_hookean") -> torch.Tensor:
    """Per-slot partials (B, Pb, d) of the explicit energy gradient at
    ``pos``: the slot sums of the +V·P(F)·R⁻ᵀ columns (unclamped log), of
    one material layer (``ref_inv`` as in :func:`blocked_prep`); feed them
    to ``blocked_scatter_sum``.

    CUDA tensors: one launch of the blocked prep kernel in its explicit mode,
    the instance of ``material``, 2D or 3D.  CPU tensors:
    :func:`blocked_grad_prep_plain`."""
    mid = kernel_material_id(material)
    if pos.device.type == "cpu":
        return blocked_grad_prep_plain(blk, pos, mu, lam, ref_inv, material)
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    tables = block_tables(blk, ref_inv)
    n, d = pos.shape[0], tables.dim
    cuda_build.check_operand("pos", pos, (n, d), torch.float32, blk.volume.device)
    partials = torch.empty((blk.num_blocks, blk.pb, d), dtype=torch.float32,
                           device=pos.device)
    params = material_params(material, mu, lam, d)
    lib = _library(mid)
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        rc = lib.fem_blocked_grad_prep(
            ctypes.byref(tables), pos.data_ptr(), ctypes.byref(params), mid,
            partials.data_ptr(), stream,
        )
    _check_rc(lib, rc, "blocked gradient prep")
    count_launch(blocked_grad_prep, d, mid)
    return partials


blocked_grad_prep.launches = 0
blocked_grad_prep.instance_launches = {}


def blocked_edges(blk: Blocking, pos: torch.Tensor) -> torch.Tensor:
    """Edge matrices (B·Eb, d, d) of every element slot at ``pos``, in
    block order (x[s, i, j] = p_{j+1}[i] − p_0[i]); padded slots carry the
    rest edge matrix (the inverse of their R⁻¹), so F = I downstream.

    CUDA tensors: one launch of the blocked prep kernel's edges mode (2D or
    3D).  CPU tensors: :func:`blocked_edges_plain`."""
    if pos.device.type == "cpu":
        return blocked_edges_plain(blk, pos)
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    tables = block_tables(blk)
    n, d = pos.shape[0], tables.dim
    cuda_build.check_operand("pos", pos, (n, d), torch.float32, blk.volume.device)
    x = torch.empty((blk.num_blocks * blk.eb, d, d), dtype=torch.float32,
                    device=pos.device)
    lib = _library()
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        rc = lib.fem_blocked_edges(ctypes.byref(tables), pos.data_ptr(),
                                   x.data_ptr(), stream)
    _check_rc(lib, rc, "blocked edges")
    blocked_edges.launches += 1
    return x


blocked_edges.launches = 0


def check_slot_plan(blk: Blocking, n: int, dev) -> None:
    """Raise unless ``blk``'s CSR slot plan is what the kernels take for
    ``n`` particles on ``dev``."""
    plan = blk.slot_plan
    cuda_build.check_operand("slot_plan.ptr", plan.ptr, (n + 1,), torch.int32, dev)
    cuda_build.check_operand("slot_plan.rows", plan.rows, tuple(plan.rows.shape),
                             torch.int32, dev)


def blocked_assemble(blk: Blocking, cols: torch.Tensor) -> torch.Tensor:
    """(N, d) assembly of block-ordered element columns ``cols`` (B·Eb, d, d):
    column j of each real slot to its local vertex j+1, −Σ_j to vertex 0,
    summed per block and then per particle over its block slots (padded
    slots contribute nothing).

    CUDA tensors: one launch of the blocked assembly (two kernels: per-block
    partials, per-particle slot sums).  CPU tensors:
    :func:`blocked_assemble_plain`."""
    if cols.device.type == "cpu":
        return blocked_assemble_plain(blk, cols)
    if cols.device.type != "cuda":
        raise ValueError(f"unsupported device {cols.device}")
    tables = block_tables(blk)
    dev = cols.device
    n, d = blk.slot_plan.ptr.shape[0] - 1, tables.dim
    cuda_build.check_operand("cols", cols, (blk.num_blocks * blk.eb, d, d),
                             torch.float32, blk.volume.device)
    check_slot_plan(blk, n, dev)
    partials = torch.empty((blk.num_blocks * blk.pb, d), dtype=torch.float32,
                           device=dev)
    y = torch.empty((n, d), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fem_blocked_assemble(
            ctypes.byref(tables), cols.data_ptr(), blk.slot_plan.ptr.data_ptr(),
            blk.slot_plan.rows.data_ptr(), n, partials.data_ptr(),
            y.data_ptr(), stream,
        )
    _check_rc(lib, rc, "blocked assembly")
    blocked_assemble.launches += 1
    return y


blocked_assemble.launches = 0


def blocked_graph_apply(blk: Blocking, K: torch.Tensor, x: torch.Tensor,
                        transpose_k: bool = False) -> torch.Tensor:
    """G(K)·x (G(Kᵀ)·x when ``transpose_k``), (N, d): per block the
    element-Laplacian product of its K blocks, then each particle's sum over
    its block slots.

    CUDA tensors: one launch of the blocked matvec (two kernels: per-block
    partials, per-particle slot sums).  CPU tensors:
    :func:`blocked_graph_apply_plain`."""
    if x.device.type == "cpu":
        return blocked_graph_apply_plain(blk, K, x, transpose_k)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    tables = block_tables(blk)
    n, d = x.shape[0], tables.dim
    dev = x.device
    plan = blk.slot_plan
    cuda_build.check_operand("x", x, (n, d), torch.float32, blk.volume.device)
    cuda_build.check_operand("K", K, (blk.num_blocks * blk.eb, d, d),
                             torch.float32, dev)
    check_slot_plan(blk, n, dev)
    partials = torch.empty((blk.num_blocks * blk.pb, d), dtype=torch.float32,
                           device=dev)
    y = torch.empty((n, d), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fem_blocked_matvec(
            ctypes.byref(tables), K.data_ptr(), x.data_ptr(),
            int(bool(transpose_k)), plan.ptr.data_ptr(), plan.rows.data_ptr(),
            n, partials.data_ptr(), y.data_ptr(), stream,
        )
    _check_rc(lib, rc, "blocked matvec")
    blocked_graph_apply.launches += 1
    return y


blocked_graph_apply.launches = 0


def blocked_velocity_solve(
    blk: Blocking, prepped, vel, mass, dt: float, normal: bool, *,
    apply=blocked_graph_apply, beta: float = 0.0,
    cg_precond: str = "reference", diag_fn=None, free=None, pin_vel=None,
    max_iter: int = 500, tol: float = 1e-5,
) -> CGResult:
    """One implicit velocity solve over the blocks (the JAX package's
    blocked branch, solvers/implicit.py:1080-1101) from the prep's
    ``prepped`` = (K, force partials): the slot-sum assembly,
    b = v + dt·f/m, then ``cg_solve_dispatch`` over A·v = v − c·G(K)·v/m and
    Aᵀ·v = v − c·G(Kᵀ)·(v/m), c = dt·(dt + ``beta``): the reference CG
    (x₀ = b; normal equations when ``normal``), or with ``cg_precond``
    ``"block_jacobi"`` the PCG on the blocks ``diag_fn()``, and the pin
    projection by ``free``/``pin_vel``.  ``apply`` defaults to the kernel's
    wrapper; the plain frame passes its plain version."""
    K, partials = prepped
    f = blocked_scatter_sum(partials, blk)
    minv = (1.0 / mass)[:, None]
    c = system_coeff(dt, beta)
    b = vel + dt * f * minv

    def apply_a(v):
        return v - c * apply(blk, K, v, False) * minv

    def apply_at(v):
        return v - c * apply(blk, K, v * minv, True)

    return cg_solve_dispatch(
        apply_a, lambda: apply_at, b, int(bool(normal)), cg_precond, diag_fn,
        mass, free, pin_vel, max_iter, tol)
