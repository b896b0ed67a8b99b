# coding=utf-8
"""Advection with walls and circle obstacles (plain PyTorch).

The port of the JAX package's ``solvers/advect.py`` reference branches:
``kinematic_step`` (the explicit path, reference solver/kinematic.py:14-45)
and ``advect_implicit_step`` (reference solver/implicit.py:407-438).  The
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


def damping_decay(dt: float, damping: float, dtype=torch.float32) -> float:
    """exp(−dt·damping) evaluated in float32, as the JAX package does, or in
    float64 for a float64 state."""
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


def kinematic_step(
    state: SimState,
    grad: torch.Tensor,
    mass: torch.Tensor,
    obstacles: Obstacles,
    dt: float,
    decay: float,
    gravity: torch.Tensor,
    inv_mass: torch.Tensor | None = None,
) -> SimState:
    """One explicit-path advection with the assembled energy gradient
    ``grad``, subtracted as −grad/m; ``force`` is reset to zeros.  With
    ``inv_mass`` (N,) the step multiplies by m⁻¹ instead of dividing by m,
    as the JAX package's whole-frame kernel does; the substep divides, as
    its kinematic step does.  ``decay`` and ``gravity`` as in
    :func:`advect_implicit_step`."""
    pos = state.pos
    if inv_mass is None:
        accel = grad / mass[:, None]
    else:
        accel = grad * inv_mass[:, None]
    vel = state.vel + (gravity[None, :] - accel) * dt
    vel = vel * decay
    wall = ((pos < 0.0) & (vel < 0.0)) | ((pos > 1.0) & (vel > 0.0))
    vel = torch.where(wall, 0.0, vel)
    for b in range(obstacles.radii.shape[0]):
        hit, disp, dist_sq = _circle_hit(
            pos, vel, obstacles.centers[b], obstacles.radii[b]
        )
        coeff = torch.sum(vel * disp, dim=-1, keepdim=True) / torch.clamp(
            dist_sq, min=1e-30
        )
        vel = torch.where(hit, vel - coeff * disp, vel)
    return state.replace(
        pos=pos + vel * dt, vel=vel, force=torch.zeros_like(grad)
    )


def advect_implicit_step(
    state: SimState,
    obstacles: Obstacles,
    dt: float,
    decay: float,
    gravity: torch.Tensor,
) -> SimState:
    """One implicit-path advection.  ``gravity`` is the (d,) acceleration
    9.8·g_dir on the state's device and ``decay`` the f32 value of
    exp(−dt·damping) (see :func:`damping_decay`)."""
    vel_g = state.vel_g + gravity[None, :] * dt
    vel = state.vel * decay
    vel_g = vel_g * decay
    v = vel + vel_g

    lower = (state.pos < 0.0) & (v < 0.0)
    vel = torch.where(lower, 0.0, vel)
    vel_g = torch.where(lower, 0.0, vel_g)
    v = torch.where(lower, 0.0, v)

    upper = (state.pos > 1.0) & (v > 0.0)
    vel = torch.where(upper, 0.0, vel)
    v = torch.where(upper, 0.0, v)

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

    return state.replace(pos=state.pos + v * dt, vel=vel, vel_g=vel_g)
