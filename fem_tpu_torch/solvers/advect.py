# coding=utf-8
"""Advection with walls, circle obstacles and the typed SDF obstacles.

The port of the JAX package's ``solvers/advect.py``: ``kinematic_step`` (the
explicit path, reference solver/kinematic.py:14-45) and
``advect_implicit_step`` (reference solver/implicit.py:407-438), each with
the extensions of the JAX package: wall friction (a Coulomb cone on the
walls' zeroing), the typed obstacles of ``obstacles.py`` after the circles,
and pins (``free_mask`` zeroes a pinned vertex's velocity; ``pin_vel``
prescribes it).  ``backend="xla"`` (the default; the JAX package's frames
always take it) is plain PyTorch; ``backend="pallas"`` sends the reference
part of the step to the fused advection kernels K10a/K10b
(``ops/advect_kernels``), which take circles only, as the Pallas ones do:
typed obstacles and wall friction raise there, and pins apply after the
kernel.  The
explicit step adds (9.8·g − ∂U/∂x / m)·dt to the velocity, decays it, zeroes
components pushing through the unit-box walls (tested on the old
positions), projects circles in order on the old positions and moves the
positions by the new velocity; it has no ``vel_g`` channel.  Quirks kept
on the implicit path:

* gravity lives in the separate ``vel_g`` channel outside the linear solve;
* the exp(−dt·damping) decay applies to both channels before the walls;
* the unit-box walls zero velocity components per component, lower wall then
  upper wall, and the upper wall zeroes ``vel`` but **not** ``vel_g``
  (commented out in the reference at implicit.py:422);
* circle obstacles are processed in sequence, each seeing the velocity the
  previous one left, and a radius-0 circle never hits (kinematic.py:34-35).

Everything stays on the state's device; nothing is read back to the host.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from fem_tpu_torch.models.state import Obstacles, SimState
from fem_tpu_torch.obstacles import (
    apply_extensions_explicit,
    apply_extensions_implicit,
    has_extensions,
)
from fem_tpu_torch.ops import advect_kernels


def damping_decay(dt: float, damping, dtype=torch.float32):
    """exp(−dt·damping) evaluated in float32, as the JAX package does, or in
    float64 for a float64 state.  A tensor ``damping`` (a differentiable
    rollout's parameter) gives the 0-d tensor ``torch.exp(−dt·damping)`` in
    its own dtype, on its device, as the JAX package traces it."""
    if torch.is_tensor(damping):
        return torch.exp(-dt * damping)
    if dtype == torch.float64:
        return math.exp(-dt * damping)
    return float(np.exp(np.float32(-dt * damping)))


@functools.lru_cache(maxsize=16)
def gravity_vector(g_dir: Tuple[float, ...], device: torch.device,
                   dtype=torch.float32) -> torch.Tensor:
    """9.8·g_dir as a (d,) tensor of ``dtype`` on ``device``, made once per
    (g_dir, device, dtype) so that a substep copies nothing from the host."""
    return 9.8 * torch.tensor(g_dir, dtype=dtype, device=device)


def _circle_hit(pos, v, center, radius):
    """(hit (N, 1), disp (N, d), |disp|² (N, 1)) of one circle: inside it and
    moving toward its center; a radius-0 circle never hits."""
    disp = pos - center[None, :]
    dist_sq = torch.sum(disp * disp, dim=-1, keepdim=True)
    inside = dist_sq < radius * radius
    toward = torch.sum(v * (-disp), dim=-1, keepdim=True) > 0.0
    return inside & toward & (radius > 0.0), disp, dist_sq


def _sticky_walls(pos, v, wall_friction: float = 0.0):
    """Zero velocity components pushing through the unit-box walls
    (kinematic.py:25-30).  ``wall_friction`` μ > 0 scales the remaining
    (tangential) components by max(0, 1 − μ·j_n/|v_t|), j_n = Σ|v_k| of
    the zeroed ones: an impulse-level Coulomb cone."""
    hit = ((pos < 0.0) & (v < 0.0)) | ((pos > 1.0) & (v > 0.0))
    v_t = torch.where(hit, 0.0, v)
    if wall_friction > 0.0:
        jn = torch.sum(torch.abs(v) * hit, dim=-1, keepdim=True)
        t_speed = torch.sqrt(torch.sum(v_t * v_t, dim=-1, keepdim=True))
        s = torch.clamp(
            1.0 - wall_friction * jn / torch.clamp(t_speed, min=1e-20),
            min=0.0)
        v_t = torch.where(jn > 0.0, s * v_t, v_t)
    return v_t


def _check_pallas(obstacles: Obstacles, wall_friction: float,
                  decay) -> None:
    if torch.is_tensor(decay):
        raise ValueError(
            "a tensor decay (a traced damping) requires the XLA advection "
            "path (backend='xla'); the fused advection kernel takes a float")
    if has_extensions(obstacles) or wall_friction > 0.0:
        raise ValueError(
            "SDF obstacle extensions / wall friction require the XLA "
            "advection path (backend='xla'); the fused advection kernel "
            "implements reference circles only"
        )


def _pin_after_kernel(state, pos, free_mask, pin_vel, dt, *channels):
    """Pins applied to a fused kernel's outputs: pinned channels zeroed,
    ``pin_vel`` added to the first channel, pinned positions held or moved
    by ``pin_vel``·dt."""
    channels = [c * free_mask for c in channels]
    if pin_vel is not None:
        channels[0] = channels[0] + pin_vel
        pos = torch.where(free_mask > 0.0, pos, state.pos + pin_vel * dt)
    else:
        pos = torch.where(free_mask > 0.0, pos, state.pos)
    return pos, channels


def kinematic_step(
    state: SimState,
    grad: torch.Tensor,
    mass: torch.Tensor,
    obstacles: Obstacles,
    dt: float,
    decay: float,
    gravity: torch.Tensor,
    inv_mass: torch.Tensor | None = None,
    *,
    backend: str = "xla",
    free_mask: torch.Tensor | None = None,
    pin_vel: torch.Tensor | None = None,
    wall_friction: float = 0.0,
) -> SimState:
    """One explicit-path advection with the assembled energy gradient
    ``grad``, subtracted as −grad/m; ``force`` is reset to zeros.  With
    ``inv_mass`` (N,) the step multiplies by m⁻¹ instead of dividing by m,
    as the JAX package's whole-frame kernel does; the substep divides, as
    its kinematic step does.  ``decay`` and ``gravity`` as in
    :func:`advect_implicit_step`.  ``backend="pallas"`` runs the step as
    K10a (which multiplies by m⁻¹, as the Pallas kernel does); the typed
    obstacles, wall friction and pins as the module says."""
    pos = state.pos
    if backend == "pallas":
        _check_pallas(obstacles, wall_friction, decay)
        new_pos, vel = advect_kernels.kinematic(
            pos, state.vel, grad, 1.0 / mass, obstacles.centers,
            obstacles.radii, dt=dt, decay=decay, gravity=gravity)
        if free_mask is not None:
            new_pos, (vel,) = _pin_after_kernel(state, new_pos, free_mask,
                                                pin_vel, dt, vel)
        return state.replace(pos=new_pos, vel=vel,
                             force=torch.zeros_like(grad))
    if backend != "xla":
        raise ValueError(f"unknown advection backend {backend!r}")
    if inv_mass is None:
        accel = grad / mass[:, None]
    else:
        accel = grad * inv_mass[:, None]
    vel = state.vel + (gravity[None, :] - accel) * dt
    vel = vel * decay
    vel = _sticky_walls(pos, vel, wall_friction)
    for b in range(obstacles.radii.shape[0]):
        hit, disp, dist_sq = _circle_hit(
            pos, vel, obstacles.centers[b], obstacles.radii[b]
        )
        coeff = torch.sum(vel * disp, dim=-1, keepdim=True) / torch.clamp(
            dist_sq, min=1e-30
        )
        vel = torch.where(hit, vel - coeff * disp, vel)
    if has_extensions(obstacles):
        vel = apply_extensions_explicit(pos, vel, obstacles)
    if free_mask is not None:
        vel = vel * free_mask
        if pin_vel is not None:
            vel = vel + pin_vel
    return state.replace(
        pos=pos + vel * dt, vel=vel, force=torch.zeros_like(grad)
    )


def advect_implicit_step(
    state: SimState,
    obstacles: Obstacles,
    dt: float,
    decay: float,
    gravity: torch.Tensor,
    *,
    backend: str = "xla",
    free_mask: torch.Tensor | None = None,
    pin_vel: torch.Tensor | None = None,
    wall_friction: float = 0.0,
    theta: float = 1.0,
    vel_pos_old: torch.Tensor | None = None,
) -> SimState:
    """One implicit-path advection.  ``gravity`` is the (d,) acceleration
    9.8·g_dir on the state's device and ``decay`` the f32 value of
    exp(−dt·damping), or its 0-d tensor for a traced damping (see
    :func:`damping_decay`).  ``backend="pallas"`` runs the step as K10b
    (a float decay only); the typed obstacles, wall friction and pins as
    the module says.

    ``theta`` < 1 (the θ-scheme) moves positions by
    dt·((1−θ)·``vel_pos_old`` + θ·v) on the components no wall, obstacle or
    pin touched, and by dt·v on the others; θ = 1 is the reference's
    pos += v·dt."""
    if backend == "pallas":
        if theta != 1.0:
            raise ValueError(
                "the θ-scheme (newton_theta != 1) requires the XLA "
                "advection path (backend='xla')")
        _check_pallas(obstacles, wall_friction, decay)
        pos, vel, vel_g = advect_kernels.advect_implicit(
            state.pos, state.vel, state.vel_g, obstacles.centers,
            obstacles.radii, dt=dt, decay=decay, gravity=gravity)
        if free_mask is not None:
            pos, (vel, vel_g) = _pin_after_kernel(state, pos, free_mask,
                                                  pin_vel, dt, vel, vel_g)
        return state.replace(pos=pos, vel=vel, vel_g=vel_g)
    if backend != "xla":
        raise ValueError(f"unknown advection backend {backend!r}")
    vel_g = state.vel_g + gravity[None, :] * dt
    vel = state.vel * decay
    vel_g = vel_g * decay
    v = vel + vel_g

    v_pre = v
    lower = (state.pos < 0.0) & (v < 0.0)
    vel = torch.where(lower, 0.0, vel)
    vel_g = torch.where(lower, 0.0, vel_g)
    v = torch.where(lower, 0.0, v)

    upper = (state.pos > 1.0) & (v > 0.0)
    vel = torch.where(upper, 0.0, vel)
    v = torch.where(upper, 0.0, v)

    if wall_friction > 0.0:
        # The zeroing removed j_n of normal speed from the combined v; the
        # tangential (not hit) components of every channel scale by the
        # Coulomb factor, the hit ones keep their zeroed values (the vel_g
        # upper-wall quirk included).
        hit = lower | upper
        jn = torch.sum(torch.abs(v_pre) * hit, dim=-1, keepdim=True)
        t_speed = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
        s = torch.clamp(
            1.0 - wall_friction * jn / torch.clamp(t_speed, min=1e-20),
            min=0.0)
        scale = torch.where(jn > 0.0, s, 1.0)
        vel = torch.where(hit, vel, scale * vel)
        vel_g = torch.where(hit, vel_g, scale * vel_g)
        v = torch.where(hit, v, scale * v)

    for b in range(obstacles.radii.shape[0]):
        hit, disp, dist_sq = _circle_hit(
            state.pos, v, obstacles.centers[b], obstacles.radii[b]
        )
        denom = torch.clamp(dist_sq, min=1e-30)

        def proj(u):
            return (torch.sum(u * disp, dim=-1, keepdim=True) / denom) * disp

        v = torch.where(hit, v - proj(v), v)
        vel = torch.where(hit, vel - proj(vel), vel)
        vel_g = torch.where(hit, vel_g - proj(vel_g), vel_g)

    if has_extensions(obstacles):
        v, vel, vel_g = apply_extensions_implicit(state.pos, v, vel, vel_g,
                                                  obstacles)
    if free_mask is not None:
        vel = vel * free_mask
        vel_g = vel_g * free_mask
        v = v * free_mask
        if pin_vel is not None:
            vel = vel + pin_vel
            v = v + pin_vel
    if theta == 1.0:
        pos = state.pos + v * dt
    else:
        touched = v != v_pre
        v_theta = (1.0 - theta) * vel_pos_old + theta * v
        pos = state.pos + torch.where(touched, v, v_theta) * dt
    return state.replace(pos=pos, vel=vel, vel_g=vel_g)
