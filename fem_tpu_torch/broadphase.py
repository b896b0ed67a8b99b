# coding=utf-8
"""Uniform-grid broad phase for penalty contact at scale: the port of the
JAX package's ``broadphase.py``.

A uniform grid of cell size = contact radius over the unit domain, one
margin cell each side, rebuilt every substep:

1. positions → margin-shifted cell coordinates, clamped into the grid, and
   one int32 cell id;
2. a STABLE sort of the ids (``torch.argsort(stable=True)``, as
   ``jnp.argsort`` is stable: truncation at ``cap`` depends on the order
   within a cell);
3. each sorted vertex's run table (``ops/contact_kernels.grid_runs``:
   one ``torch.searchsorted``, side left, as ``jnp.searchsorted``): the
   first rank of every cell of its 3^d neighbourhood and the rank past
   each row of three, the neighbours found by LINEARIZED id offsets,
   wrap-around at the margin included, as in the JAX package; its forward
   cells' columns are the JAX package's starts in the (3^d − 1)/2 forward
   neighbour cells;
4. the narrow phase, C2 (``ops/contact_kernels.grid_pair_forces``): the
   forward stencil's pairs, +f on the finder and −f on the candidate.

Body ids stay int32 (the JAX package packs them as f32, exact only below
2^24 vertices: ROADMAP F2, repaired here).  ``grid_shape`` sizes the grid
for the unit domain and clamps every coordinate outside it into the
margin cells, as the JAX package does (ROADMAP F8: a body off the unit
domain collapses into a few cells and the cap drops most of its pairs,
which ``grid_overflow_count`` shows); kept for parity.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from fem_tpu_torch.ops.contact_kernels import grid_pair_forces, grid_runs


def grid_shape(radius: float, dim: int) -> Tuple[int, int]:
    """(cells per axis M, id stride base) for cell size = radius over the
    unit domain with one margin cell each side."""
    m = int(np.ceil(1.0 / radius)) + 2
    if m ** dim >= 2 ** 31:
        raise ValueError(
            f"contact radius {radius:g} too small for the int32 grid "
            f"({m}^{dim} cells); raise contact_radius or use the dense path"
        )
    return m, m


@functools.lru_cache(maxsize=16)
def _grid_strides(m: int, d: int, device: torch.device) -> torch.Tensor:
    """The linearized id's strides (d,) as an int32 tensor on ``device``,
    made once a grid."""
    return torch.tensor([m ** k for k in range(d - 1, -1, -1)],
                        dtype=torch.int32, device=device)


def grid_cells(pos: torch.Tensor, radius: float):
    """(cell ids (ns,) int32, M): each vertex's margin-shifted, clamped
    cell, linearized."""
    d = pos.shape[1]
    m, _ = grid_shape(radius, d)
    strides = _grid_strides(m, d, pos.device)
    ic = torch.clamp(torch.floor(pos * (1.0 / radius)).to(torch.int32) + 1,
                     0, m - 1)
    return torch.sum(ic * strides, dim=1, dtype=torch.int32), m


def grid_contact_forces(
    pos: torch.Tensor,
    body_id: torch.Tensor,
    rest_pos: Optional[torch.Tensor],
    radius: float,
    stiffness: float,
    vel: Optional[torch.Tensor] = None,
    friction_c: float = 0.0,
    cap: int = 8,
    self_contact: bool = False,
    excl_radius: Optional[float] = None,
    mu: float = 0.0,
    mu_slope: float = 0.0,
) -> torch.Tensor:
    """Penalty contact forces (ns, d), in the input order, over the vertex
    soup ``pos`` through the uniform grid.  Pairs of different ``body_id``
    (int32) are admitted always; same-body pairs only with
    ``self_contact`` and a rest distance past ``excl_radius`` (default
    2.5·radius, as the dense path's mask).  Each admitted pair is found at
    most once and puts ±f on its two vertices.  ``mu`` > 0 adds the
    regularized Coulomb cone (the dense path's semantics)."""
    d = pos.shape[1]
    cell, m = grid_cells(pos, radius)
    order = torch.argsort(cell, stable=True)
    cell_s = cell[order]
    return grid_pair_forces(
        pos, vel, rest_pos if self_contact else None, body_id, cell_s,
        order, grid_runs(cell_s, m, d), m, radius, stiffness, cap,
        friction_c, mu, mu_slope, self_contact, excl_radius)


def grid_overflow_count(pos: np.ndarray, radius: float, cap: int) -> int:
    """Host-side diagnostic: the number of occupied cells holding more than
    ``cap`` vertices at these positions — 0 means the grid pass finds
    exactly the dense pair set."""
    pos = np.asarray(pos)
    ns, d = pos.shape
    m, _ = grid_shape(radius, d)
    ic = np.clip(np.floor(pos / radius).astype(np.int64) + 1, 0, m - 1)
    strides = np.array([m ** k for k in range(d - 1, -1, -1)])
    cell = (ic * strides[None, :]).sum(1)
    _, counts = np.unique(cell, return_counts=True)
    return int((counts > cap).sum())
