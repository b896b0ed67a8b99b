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
"""

from __future__ import annotations

import ctypes

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


def _library():
    lib = cuda_build.load("advect")
    if lib.fem_kinematic.argtypes is None:
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
    return lib


def _check(pos, centers, radii, gravity, **per_particle):
    """(N, d, device) of a launch, after checking what the kernels take:
    d 2 or 3, f32, contiguous, the shapes of the module's functions."""
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    n, d = pos.shape
    if d not in (2, 3):
        raise ValueError(f"the advection kernels take dim 2 or 3, not {d}")
    dev, f32 = pos.device, torch.float32
    cuda_build.check_operand("pos", pos, (n, d), f32, dev)
    for name, (t, shape) in per_particle.items():
        cuda_build.check_operand(name, t, shape, f32, dev)
    b = radii.shape[0]
    cuda_build.check_operand("centers", centers, (b, d), f32, dev)
    cuda_build.check_operand("radii", radii, (b,), f32, dev)
    cuda_build.check_operand("gravity", gravity, (d,), f32, dev)
    return n, d, dev


def _raise_on(lib, rc, what):
    if rc != 0:
        msg = lib.fem_advect_error(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg}")


def kinematic(pos: torch.Tensor, vel: torch.Tensor, grad: torch.Tensor,
              minv: torch.Tensor, centers: torch.Tensor, radii: torch.Tensor,
              *, dt: float, decay: float, gravity: torch.Tensor):
    """(pos', vel') of the explicit kinematic step: ``grad`` the assembled
    energy gradient (N, d), ``minv`` = 1/m (N,), circles ``centers`` (B, d)
    and ``radii`` (B,), ``decay`` = exp(−dt·damping) and ``gravity`` =
    9.8·g_dir (d,).

    CUDA tensors: one launch of K10a (2D or 3D).  CPU tensors:
    :func:`kinematic_plain`."""
    if pos.device.type == "cpu":
        return kinematic_plain(pos, vel, grad, minv, centers, radii, dt=dt,
                               decay=decay, gravity=gravity)
    n, d, dev = _check(pos, centers, radii, gravity, vel=(vel, pos.shape),
                       grad=(grad, pos.shape), minv=(minv, (pos.shape[0],)))
    pos_out = torch.empty_like(pos)
    vel_out = torch.empty_like(pos)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fem_kinematic(
            d, pos.data_ptr(), vel.data_ptr(), grad.data_ptr(),
            minv.data_ptr(), centers.data_ptr(), radii.data_ptr(),
            radii.shape[0], gravity.data_ptr(), dt, decay, n,
            pos_out.data_ptr(), vel_out.data_ptr(), stream)
    _raise_on(lib, rc, "kinematic")
    kinematic.launches += 1
    return pos_out, vel_out


kinematic.launches = 0


def advect_implicit(pos: torch.Tensor, vel: torch.Tensor, vel_g: torch.Tensor,
                    centers: torch.Tensor, radii: torch.Tensor, *, dt: float,
                    decay: float, gravity: torch.Tensor):
    """(pos', vel', vel_g') of the implicit advection, the arguments as in
    :func:`kinematic`.

    CUDA tensors: one launch of K10b (2D or 3D).  CPU tensors:
    :func:`advect_implicit_plain`."""
    if pos.device.type == "cpu":
        return advect_implicit_plain(pos, vel, vel_g, centers, radii, dt=dt,
                                     decay=decay, gravity=gravity)
    n, d, dev = _check(pos, centers, radii, gravity, vel=(vel, pos.shape),
                       vel_g=(vel_g, pos.shape))
    outs = [torch.empty_like(pos) for _ in range(3)]
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fem_advect_implicit(
            d, pos.data_ptr(), vel.data_ptr(), vel_g.data_ptr(),
            centers.data_ptr(), radii.data_ptr(), radii.shape[0],
            gravity.data_ptr(), dt, decay, n, *(o.data_ptr() for o in outs),
            stream)
    _raise_on(lib, rc, "implicit advection")
    advect_implicit.launches += 1
    return tuple(outs)


advect_implicit.launches = 0
