# coding=utf-8
"""Implicit-path advection with walls and circle obstacles (plain PyTorch).

The port of the JAX package's ``solvers/advect.py:advect_implicit_step``
reference branch (reference solver/implicit.py:407-438).  Quirks kept:

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
from typing import Tuple

import numpy as np
import torch

from fem_tpu_torch.models.state import Obstacles, SimState


def damping_decay(dt: float, damping: float) -> float:
    """exp(−dt·damping) evaluated in float32, as the JAX package does."""
    return float(np.exp(np.float32(-dt * damping)))


@functools.lru_cache(maxsize=16)
def gravity_vector(g_dir: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """9.8·g_dir as a (d,) f32 tensor on ``device``, made once per
    (g_dir, device) so that a substep copies nothing from the host."""
    return 9.8 * torch.tensor(g_dir, dtype=torch.float32, device=device)


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
        center, radius = obstacles.centers[b], obstacles.radii[b]
        disp = state.pos - center[None, :]
        dist_sq = torch.sum(disp * disp, dim=-1, keepdim=True)
        inside = dist_sq < radius * radius
        toward = torch.sum(v * (-disp), dim=-1, keepdim=True) > 0.0
        hit = inside & toward & (radius > 0.0)
        denom = torch.clamp(dist_sq, min=1e-30)

        def proj(u):
            return (torch.sum(u * disp, dim=-1, keepdim=True) / denom) * disp

        v = torch.where(hit, v - proj(v), v)
        vel = torch.where(hit, vel - proj(vel), vel)
        vel_g = torch.where(hit, vel_g - proj(vel_g), vel_g)

    return state.replace(pos=state.pos + v * dt, vel=vel, vel_g=vel_g)
