# coding=utf-8
"""K11b, the whole frame over the unblocked mesh (``frame_backend="fused"``).

``fused_frame`` launches the hand-written CUDA kernel
``fem_tpu_torch/csrc/fused_frame.cu`` for tensors on a CUDA device; it
replaces the JAX package's Pallas kernel
``experiments/pallas_frame.py:_frame_kernel`` (entries ``fused_frame`` and
``make_fused_frame_fn``), 2D or 3D.  For tensors on the CPU it runs
``fused_frame_plain``: per substep the plain element chain
(``element_kernels.hessian_and_force_plain``), the plain whole solve
(``cg_kernels.fused_cg_solve_plain``) and the plain fused advection
(``advect_kernels.advect_implicit_plain``, the Pallas form with
1/max(|disp|², 1e-30) multiplied).  On CUDA it launches the kernel or
raises; it never falls back.

Semantics (the JAX kernel's), per substep: K and the force columns of the
non-robust Neo-Hookean chain at pos; b = vel + dt·f/m with no gravity
(gravity lives in ``vel_g``); the reference CG (x₀ = b, normal equations
when ``preconditioned``); vel ← x; then the implicit advection: decay
exp(−dt·damping) in f32, vel_g ← (vel_g + 9.8·g·dt)·decay, the lower wall
zeroes vel, vel_g and v_tot, the upper wall vel and v_tot but not vel_g,
the circles in order (radius 0 skipped), pos += v_tot·dt.  The frame
returns each substep's iterations and final ‖r‖².
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from fem_tpu_torch.ops.advect_kernels import advect_implicit_plain
from fem_tpu_torch.ops.assembly import GatherPlan
from fem_tpu_torch.ops.cg_kernels import fused_cg_solve_plain
from fem_tpu_torch.ops.element_kernels import (
    hessian_and_force_plain,
    material_params,
)
from fem_tpu_torch.solvers.advect import damping_decay, gravity_vector
from fem_tpu_torch.utils import cuda_build
from fem_tpu_torch.utils.config import CONJUGATE_GRADIENT_METHOD

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# The JAX kernel writes each substep's iterations into one (1, 128) row.
MAX_SIM_COUNT = 128


class FusedFrameArgsC(ctypes.Structure):
    """Mirror of ``FemFusedFrameArgs`` (csrc/fused_frame.cu)."""

    _fields_ = [
        ("pos_in", _P), ("vel_in", _P), ("velg_in", _P), ("ref_inv", _P),
        ("volume", _P), ("elem", _P), ("ptr", _P), ("rows", _P),
        ("mass", _P), ("centers", _P), ("radii", _P), ("gravity", _P),
        ("n", _I), ("e", _I), ("n_obst", _I), ("sim_count", _I),
        ("max_iter", _I), ("normal", _I), ("dim", _I),
        ("dt", _F), ("dt2", _F), ("decay", _F), ("mu", _F), ("lam", _F),
        ("half_lam", _F), ("tol", _F),
        ("pos", _P), ("vel", _P), ("velg", _P), ("scratch", _P),
        ("iters", _P), ("res", _P),
    ]


def supports_fused_frame(obj, cfg) -> bool:
    """Eligibility for K11b: every semantic gate of the JAX package's
    ``supports_fused_frame`` — the implicit CG, the reference Hessian,
    Neo-Hookean, not robust, elastic, no pins, β = 0, sphere obstacles
    only, ``sim_count`` ≤ 128 — and what the kernel also leaves out, which
    the JAX kernel would skip without a word: loads, friction, any CG but
    the reference one, and the time-stepping extensions.  Its VMEM gates
    (the one-hot mask set and the element planes within Mosaic's scoped
    VMEM) are Mosaic's: the port's kernel keeps its O(E + N) scratch in
    device memory and walks elements and particles in loops, so the card
    takes any mesh size, and a large mesh only costs time."""
    return (
        obj.dim in (2, 3)
        and not cfg.auto_diff
        and not cfg.use_explicit_method
        and cfg.implicit_method == CONJUGATE_GRADIENT_METHOD
        and not cfg.robust_inversion
        and cfg.hessian == "reference"
        and cfg.cg_precond == "reference"
        and obj.material == "neo_hookean"
        and all(o.material == "neo_hookean" for o in cfg.objects)
        and obj.plastic_yield == 0.0
        and obj.viscous_mu == 0.0
        and obj.free_mask is None
        and obj.static_load is None
        and obj.damping_beta == 0.0
        and all(o.type == "sphere" and o.friction == 0.0
                for o in cfg.obstacles)
        and cfg.wall_friction == 0.0
        and cfg.sim_count <= MAX_SIM_COUNT
        and not cfg.adaptive_dt
        and cfg.integrator == "semi_implicit"
        and cfg.contact == "none"
    )


def fused_frame_plain(
    pos, vel, vel_g, ref_inv, volume, element_indices, plan: GatherPlan,
    mass, centers, radii, *, dt, damping, g_dir, mu, s_lambda,
    preconditioned, sim_count, max_iter=500, tol=1e-5,
):
    """Plain PyTorch version of :func:`fused_frame`."""
    decay = damping_decay(dt, damping, pos.dtype)
    gravity = gravity_vector(tuple(g_dir), pos.device)
    iters, res = [], []
    for _ in range(sim_count):
        K, cols = hessian_and_force_plain(pos, element_indices, ref_inv,
                                          volume, mu, s_lambda)
        x, it, r = fused_cg_solve_plain(K, cols, element_indices, plan, vel,
                                        mass, dt, preconditioned, max_iter,
                                        tol)
        pos, vel, vel_g = advect_implicit_plain(
            pos, x, vel_g, centers, radii, dt=dt, decay=decay,
            gravity=gravity)
        iters.append(it)
        res.append(r)
    return pos, vel, vel_g, torch.stack(iters), torch.stack(res)


def _library():
    lib = cuda_build.load("fused_frame")
    if lib.fem_fused_frame.argtypes is None:
        lib.fem_fused_frame_scratch_floats.argtypes = [_I, _I, _I]
        lib.fem_fused_frame_scratch_floats.restype = ctypes.c_longlong
        lib.fem_fused_frame.argtypes = [ctypes.POINTER(FusedFrameArgsC), _P]
        lib.fem_fused_frame.restype = _I
        lib.fem_fused_frame_error.argtypes = [_I]
        lib.fem_fused_frame_error.restype = ctypes.c_char_p
    return lib


def fused_frame(
    pos: torch.Tensor,
    vel: torch.Tensor,
    vel_g: torch.Tensor,
    ref_inv: torch.Tensor,
    volume: torch.Tensor,
    element_indices: torch.Tensor,
    plan: GatherPlan,
    mass: torch.Tensor,
    centers: torch.Tensor,
    radii: torch.Tensor,
    *,
    dt: float,
    damping: float,
    g_dir: Tuple[float, ...],
    mu: float,
    s_lambda: float,
    preconditioned: bool,
    sim_count: int,
    max_iter: int = 500,
    tol: float = 1e-5,
):
    """One rendered frame of ``sim_count`` implicit-CG substeps over the
    unblocked mesh: returns (pos', vel', vel_g' (N, d), iterations (S,)
    int32, ‖r‖² (S,) f32).  CUDA tensors: one launch of the whole-frame
    kernel, with no host synchronisation.  CPU tensors:
    :func:`fused_frame_plain`."""
    kw = dict(dt=dt, damping=damping, g_dir=g_dir, mu=mu, s_lambda=s_lambda,
              preconditioned=preconditioned, sim_count=sim_count,
              max_iter=max_iter, tol=tol)
    if pos.device.type == "cpu":
        return fused_frame_plain(pos, vel, vel_g, ref_inv, volume,
                                 element_indices, plan, mass, centers, radii,
                                 **kw)
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    n, d = pos.shape
    if d not in (2, 3):
        raise ValueError(f"the whole-frame kernel takes dim 2 or 3, not {d}")
    if len(g_dir) != d:
        raise ValueError(f"g_dir has {len(g_dir)} components, expected {d}")
    e = element_indices.shape[0]
    o = radii.shape[0]
    dev, f32 = pos.device, torch.float32
    for name, t, shape, dtype in (
        ("pos", pos, (n, d), f32), ("vel", vel, (n, d), f32),
        ("vel_g", vel_g, (n, d), f32), ("ref_inv", ref_inv, (e, d, d), f32),
        ("volume", volume, (e,), f32),
        ("element_indices", element_indices, (e, d + 1), torch.int32),
        ("plan.ptr", plan.ptr, (n + 1,), torch.int32),
        ("plan.rows", plan.rows, ((d + 1) * e,), torch.int32),
        ("mass", mass, (n,), f32), ("centers", centers, (o, d), f32),
        ("radii", radii, (o,), f32),
    ):
        cuda_build.check_operand(name, t, shape, dtype, dev)
    if d == 3 and element_indices.data_ptr() % 16:
        raise ValueError("element_indices must be 16-byte aligned (int4 loads)")
    lib = _library()
    gravity = gravity_vector(tuple(g_dir), dev)
    scratch = torch.empty(lib.fem_fused_frame_scratch_floats(d, e, n),
                          dtype=f32, device=dev)
    out = [torch.empty((n, d), dtype=f32, device=dev) for _ in range(3)]
    iters = torch.empty((sim_count,), dtype=torch.int32, device=dev)
    res = torch.empty((sim_count,), dtype=f32, device=dev)
    mat = material_params("neo_hookean", mu, s_lambda, d)
    args = FusedFrameArgsC(
        pos.data_ptr(), vel.data_ptr(), vel_g.data_ptr(), ref_inv.data_ptr(),
        volume.data_ptr(), element_indices.data_ptr(), plan.ptr.data_ptr(),
        plan.rows.data_ptr(), mass.data_ptr(), centers.data_ptr(),
        radii.data_ptr(), gravity.data_ptr(), n, e, o, int(sim_count),
        int(max_iter), int(bool(preconditioned)), d, dt, dt * dt,
        damping_decay(dt, damping), mat.mu, mat.lam, mat.half_lam, tol,
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        scratch.data_ptr(), iters.data_ptr(), res.data_ptr(),
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fem_fused_frame(ctypes.byref(args), stream)
    if rc != 0:
        msg = lib.fem_fused_frame_error(rc).decode()
        raise RuntimeError(f"unblocked whole-frame kernel launch failed: {msg}")
    fused_frame.launches += 1
    return out[0], out[1], out[2], iters, res


fused_frame.launches = 0


def make_fused_frame_fn(obj, cfg):
    """Frame function backed by K11b: ``frame(state, obstacles)`` →
    ``(state', StepAux)`` with per-substep iterations and final ‖r‖² of
    shape ``(sim_count,)`` left on the device, the contract of
    ``sim.make_frame_fn``.  The circles are read from the obstacles each
    frame, as device tensors."""
    from fem_tpu_torch.sim import StepAux

    kw = dict(dt=cfg.delta_time, damping=obj.damping, g_dir=tuple(cfg.g_dir),
              mu=obj.mu, s_lambda=obj.s_lambda,
              preconditioned=cfg.preconditioned == 1,
              sim_count=cfg.sim_count)

    def frame(state, obstacles):
        pos, vel, vel_g, iters, res = fused_frame(
            state.pos, state.vel, state.vel_g, obj.ref_inv, obj.volume,
            obj.element_indices, obj.plan, obj.mass, obstacles.centers,
            obstacles.radii, **kw)
        return state.replace(pos=pos, vel=vel, vel_g=vel_g), StepAux(
            iters, res)

    return frame
