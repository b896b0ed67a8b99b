# coding=utf-8
"""K10a and K10b: the fused advection steps.

``kinematic`` (K10a, the explicit kinematic step) and ``advect_implicit``
(K10b, the implicit advection with its ``vel_g`` channel) launch the
hand-written CUDA kernels of ``fem_tpu_torch/csrc/advect.cu`` for tensors on
a CUDA device; they replace the JAX package's Pallas kernels
``ops/pallas_advect.py:_kinematic_kernel`` (entry ``kinematic_pallas``) and
``_advect_implicit_kernel`` (entry ``advect_implicit_pallas``), in the
dimension of the positions (2 or 3).  For tensors on the CPU each runs its
plain PyTorch version (``*_plain``), which follows the Pallas kernel: walls
and circles only, m⁻¹ multiplied, and in K10b 1/max(|disp|², 1e-30)
multiplied where the XLA step divides.  On CUDA each launches its kernel or
raises; it never falls back.  ``solvers/advect`` reaches them with
``backend="pallas"``; the frames keep ``"xla"``, as the JAX package's do.
Each wrapper counts its launches (``launches``).

Both kernels run one thread a particle in CTAs of ``ADVECT_TILE``
particles: :func:`advect_plan` gives the tile, the CTAs and the ragged last
tile of a launch, and each wrapper leaves its launch's plan in
``last_plan``.  The library and its entries' argument types are loaded
once, at the first launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from fem_tpu_torch.utils import cuda_build

_P = ctypes.c_void_p


def _circle_project(pos, v, center, radius):
    """One circle of the Pallas kernels: particles inside it, moving toward
    its center, lose their radial velocity component (kinematic.py:36-41);
    a radius-0 circle never hits.  Returns (hit (N, 1), disp, |disp|²)."""
    disp = pos - center[None, :]
    dist_sq = torch.sum(disp * disp, dim=1, keepdim=True)
    inside = dist_sq < radius * radius
    toward = torch.sum(v * (-disp), dim=1, keepdim=True) > 0.0
    return inside & toward & (radius > 0.0), disp, dist_sq


def kinematic_plain(pos, vel, grad, minv, centers, radii, *, dt, decay,
                    gravity):
    """Plain PyTorch version of :func:`kinematic`."""
    v = (vel + (gravity[None, :] - grad * minv[:, None]) * dt) * decay
    v = torch.where((pos < 0.0) & (v < 0.0), 0.0, v)
    v = torch.where((pos > 1.0) & (v > 0.0), 0.0, v)
    for b in range(radii.shape[0]):
        hit, disp, dist_sq = _circle_project(pos, v, centers[b], radii[b])
        coeff = torch.sum(v * disp, dim=1, keepdim=True) / torch.clamp(
            dist_sq, min=1e-30)
        v = torch.where(hit, v - coeff * disp, v)
    return pos + v * dt, v


def advect_implicit_plain(pos, vel, vel_g, centers, radii, *, dt, decay,
                          gravity):
    """Plain PyTorch version of :func:`advect_implicit`."""
    vel = vel * decay
    vel_g = (vel_g + gravity[None, :] * dt) * decay
    v = vel + vel_g
    lower = (pos < 0.0) & (v < 0.0)
    vel = torch.where(lower, 0.0, vel)
    vel_g = torch.where(lower, 0.0, vel_g)
    v = torch.where(lower, 0.0, v)
    upper = (pos > 1.0) & (v > 0.0)
    vel = torch.where(upper, 0.0, vel)  # NOT vel_g (implicit.py:422)
    v = torch.where(upper, 0.0, v)
    for b in range(radii.shape[0]):
        hit, disp, dist_sq = _circle_project(pos, v, centers[b], radii[b])
        inv_d = 1.0 / torch.clamp(dist_sq, min=1e-30)

        def proj(u):
            coeff = torch.sum(u * disp, dim=1, keepdim=True) * inv_d
            return torch.where(hit, u - coeff * disp, u)

        v, vel, vel_g = proj(v), proj(vel), proj(vel_g)
    return pos + v * dt, vel, vel_g


# The advect library with its entries' argument types, loaded at the first
# launch.
_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("advect")
        lib.fem_kinematic.argtypes = [
            ctypes.c_int, _P, _P, _P, _P, _P, _P, ctypes.c_int, _P,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, _P, _P, _P,
        ]
        lib.fem_kinematic.restype = ctypes.c_int
        lib.fem_advect_implicit.argtypes = [
            ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_int, _P,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, _P, _P, _P, _P,
        ]
        lib.fem_advect_implicit.restype = ctypes.c_int
        lib.fem_advect_error.argtypes = [ctypes.c_int]
        lib.fem_advect_error.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


# Particles a CTA of csrc/advect.cu's kernels (its kTile).  On the H100
# (121-1,048,576 particles, 2D and 3D; PERF.md, section 6) 64 was within
# 6 % of the fastest of 32, 64, 128 and 256 at every size but K10b in 3D
# from 262,144 particles on, where 32 was 9-13 % faster; 32 lost 26-41 %
# in 2D from 262,144 particles on.
ADVECT_TILE = 64


class AdvectPlan(NamedTuple):
    """A launch of K10a or K10b over N particles."""

    tile: int  # particles a CTA, one thread each
    ctas: int  # ⌈N / tile⌉
    last: int  # particles of the last, ragged tile (0 when N = 0)


@functools.lru_cache(maxsize=256)
def advect_plan(n: int, d: int) -> AdvectPlan:
    """The launch of K10a or K10b over ``n`` particles in ``d`` dimensions:
    CTAs of ``ADVECT_TILE`` particles.  Raises ``ValueError`` for a launch
    the kernels do not take.  Pure: no device is asked."""
    if d not in (2, 3):
        raise ValueError(f"the advection kernels take dim 2 or 3, not {d}")
    if n < 0:
        raise ValueError(f"{n} particles")
    ctas = -(-n // ADVECT_TILE)
    last = n - (ctas - 1) * ADVECT_TILE if ctas else 0
    return AdvectPlan(ADVECT_TILE, ctas, last)


def _launch(fn, what: str, dev: torch.device, entry: str, *args) -> None:
    """``entry(*args, stream)`` on ``dev``'s current stream; raises on a
    launch error, else counts the launch on ``fn``."""
    lib = _library()
    rc = cuda_build.launch_on_stream(dev, dev.index, getattr(lib, entry),
                                     *args)
    if rc != 0:
        msg = lib.fem_advect_error(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg}")
    fn.launches += 1


def _check(pos, centers, radii, gravity, **per_particle):
    """(N, d, device) of a launch, after checking what the kernels take:
    d 2 or 3, f32, contiguous, the shapes of the module's functions.  One
    pass over the operands; ``cuda_build.check_operand`` names the first
    that fails."""
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    n, d = pos.shape
    if d not in (2, 3):
        raise ValueError(f"the advection kernels take dim 2 or 3, not {d}")
    dev, f32, b = pos.device, torch.float32, radii.shape[0]
    operands = (("pos", pos, (n, d)), *(
        (name, t, shape) for name, (t, shape) in per_particle.items()),
        ("centers", centers, (b, d)), ("radii", radii, (b,)),
        ("gravity", gravity, (d,)))
    for name, t, shape in operands:
        if not (t.device == dev and t.dtype == f32 and t.shape == shape
                and t.is_contiguous()):
            cuda_build.check_operand(name, t, shape, f32, dev)
    return n, d, dev


def kinematic(pos: torch.Tensor, vel: torch.Tensor, grad: torch.Tensor,
              minv: torch.Tensor, centers: torch.Tensor, radii: torch.Tensor,
              *, dt: float, decay: float, gravity: torch.Tensor):
    """(pos', vel') of the explicit kinematic step: ``grad`` the assembled
    energy gradient (N, d), ``minv`` = 1/m (N,), circles ``centers`` (B, d)
    and ``radii`` (B,), ``decay`` = exp(−dt·damping) and ``gravity`` =
    9.8·g_dir (d,).

    CUDA tensors: one launch of K10a (2D or 3D) on :func:`advect_plan`'s
    plan, left in ``kinematic.last_plan``.  CPU tensors:
    :func:`kinematic_plain`."""
    if pos.device.type == "cpu":
        return kinematic_plain(pos, vel, grad, minv, centers, radii, dt=dt,
                               decay=decay, gravity=gravity)
    n, d, dev = _check(pos, centers, radii, gravity, vel=(vel, pos.shape),
                       grad=(grad, pos.shape), minv=(minv, (pos.shape[0],)))
    plan = advect_plan(n, d)
    pos_out = torch.empty_like(pos)
    vel_out = torch.empty_like(pos)
    _launch(
        kinematic, "kinematic", dev, "fem_kinematic", d, pos.data_ptr(),
        vel.data_ptr(), grad.data_ptr(), minv.data_ptr(),
        centers.data_ptr(), radii.data_ptr(), radii.shape[0],
        gravity.data_ptr(), dt, decay, n, pos_out.data_ptr(),
        vel_out.data_ptr())
    kinematic.last_plan = plan
    return pos_out, vel_out


kinematic.launches = 0
kinematic.last_plan = None


def advect_implicit(pos: torch.Tensor, vel: torch.Tensor, vel_g: torch.Tensor,
                    centers: torch.Tensor, radii: torch.Tensor, *, dt: float,
                    decay: float, gravity: torch.Tensor):
    """(pos', vel', vel_g') of the implicit advection, the arguments as in
    :func:`kinematic`.

    CUDA tensors: one launch of K10b (2D or 3D) on :func:`advect_plan`'s
    plan, left in ``advect_implicit.last_plan``.  CPU tensors:
    :func:`advect_implicit_plain`."""
    if pos.device.type == "cpu":
        return advect_implicit_plain(pos, vel, vel_g, centers, radii, dt=dt,
                                     decay=decay, gravity=gravity)
    n, d, dev = _check(pos, centers, radii, gravity, vel=(vel, pos.shape),
                       vel_g=(vel_g, pos.shape))
    plan = advect_plan(n, d)
    outs = [torch.empty_like(pos) for _ in range(3)]
    _launch(
        advect_implicit, "implicit advection", dev, "fem_advect_implicit", d,
        pos.data_ptr(), vel.data_ptr(), vel_g.data_ptr(),
        centers.data_ptr(), radii.data_ptr(), radii.shape[0],
        gravity.data_ptr(), dt, decay, n, *(o.data_ptr() for o in outs))
    advect_implicit.last_plan = plan
    return tuple(outs)


advect_implicit.launches = 0
advect_implicit.last_plan = None
