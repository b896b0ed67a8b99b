# coding=utf-8
"""Typed SDF obstacles: half-spaces, solid boxes, spheres, mesh SDFs.

The port of the JAX package's ``obstacles.py``.  The reference's only
obstacles are circles (circle_blocks.py:6-25) plus the sticky unit-box walls
(solver/kinematic.py:25-30); these generalize its circle *slide* (inside and
moving inward → remove the radial velocity component) to a signed distance
field φ with outward normal n:

    hit = (φ(x) < 0) ∧ (v·n < 0);      v ← v − (v·n)·n

with an optional impulse-level Coulomb cone per obstacle (``friction``).

* ``halfspace``: φ(x) = n̂·(x − p), any orientation;
* ``box``: a SOLID axis-aligned box [lo, hi], the normal its nearest face;
* ``sphere``: frictionless ones fold into the circle arrays, frictional ones
  take the slide here;
* ``mesh`` (3D): a rigid triangle mesh through a signed distance grid built
  on the host (KD-tree unsigned distance to a surface sampling, signed by
  the ray-parity inside test of ``models/mesh.points_inside_mesh``); on the
  device φ is a trilinear sample and the normal a central difference.

Obstacles apply in sequence, each seeing the velocity the previous one left,
class by class: half-spaces, boxes, frictional spheres, meshes (after the
circles, in ``solvers/advect.py``).  Everything on the device is plain
PyTorch on the state's device; nothing is read back to the host.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Host-side builders
# ---------------------------------------------------------------------------


def build_mesh_sdf(
    path: str,
    scale: float = 1.0,
    offset: Sequence[float] = (0.0, 0.0, 0.0),
    resolution: int = 48,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Signed-distance grid of a closed triangle mesh obstacle:
    ``(grid (nx, ny, nz) float32, origin (3,) float32, spacing)``, cubic
    cells of ``max_extent / resolution`` with a 3-cell margin all around (so
    clamped samples of out-of-grid points read positive φ).  The unsigned
    distance is the KD-tree distance to a surface sampling as dense as the
    grid, so its error is O(spacing), as is the trilinear reconstruction's."""
    from scipy.spatial import cKDTree

    from fem_tpu_torch.models.mesh import load_obj_file, points_inside_mesh

    v, f = load_obj_file(path)
    v = v * float(scale) + np.asarray(offset, np.float64)[None, :]
    lo, hi = v.min(0), v.max(0)
    spacing = float((hi - lo).max()) / float(resolution)
    margin = 3
    origin = lo - margin * spacing
    counts = np.ceil((hi - lo) / spacing).astype(int) + 2 * margin + 1

    # Surface sampling: each triangle subdivided until its sample spacing is
    # below the grid spacing, at most 24 times.
    tri = v[f]  # (F, 3, 3)
    edge = np.linalg.norm(tri - np.roll(tri, 1, axis=1), axis=-1).max(axis=1)
    samples = [v]
    cap = 24
    n_sub_f = np.clip(np.ceil(edge / spacing).astype(int), 1, cap)
    for n_sub in range(1, cap + 1):
        sel = n_sub_f == n_sub
        if not sel.any():
            continue
        ij = [(i, j) for i in range(n_sub + 1) for j in range(n_sub + 1 - i)]
        w = np.array(
            [(i / n_sub, j / n_sub, 1.0 - (i + j) / n_sub) for i, j in ij],
            np.float64,
        )  # (S, 3) barycentric
        samples.append(np.einsum("sk,fkd->fsd", w, tri[sel]).reshape(-1, 3))
    surf = np.concatenate(samples, axis=0)

    ax = [origin[i] + spacing * np.arange(counts[i]) for i in range(3)]
    gx, gy, gz = np.meshgrid(*ax, indexing="ij")
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    dist, _ = cKDTree(surf).query(pts, workers=-1)
    # A tiny irrational xy shift of the sign queries (distance unaffected)
    # keeps grid points off the shared diagonals of coplanar triangles,
    # where the +z ray-parity test can miss.
    eps = spacing * np.array([1.37e-4, 2.71e-4, 0.0])
    inside = points_inside_mesh(pts + eps[None, :], v, f)
    phi = np.where(inside, -dist, dist).astype(np.float32)
    return phi.reshape(tuple(counts)), origin.astype(np.float32), spacing


def build_extension_arrays(obstacle_cfgs, dim: int, device) -> Tuple[dict, list]:
    """``(fields, extra_spheres)`` of the typed obstacles on ``device``:
    ``fields`` the :class:`~fem_tpu_torch.models.state.Obstacles` extension
    fields (None for an absent class), ``extra_spheres`` the
    ``(center, radius)`` of each frictionless sphere, for the circle
    arrays.  A sphere with ``friction > 0`` stays here (``sph_c``/``sph_r``),
    since the circle arrays carry no friction."""
    halves_p, halves_n, box_lo, box_hi = [], [], [], []
    grids, origins, spacings = [], [], []
    half_f, box_f, sdf_f, sph_f = [], [], [], []
    sph_c, sph_r = [], []
    spheres = []
    for oc in obstacle_cfgs:
        kind = oc.type
        mu = float(getattr(oc, "friction", 0.0))
        if mu < 0.0:
            raise ValueError("obstacle friction must be >= 0")
        if kind == "sphere":
            if mu > 0.0:
                sph_c.append(np.asarray(oc.center, np.float32))
                sph_r.append(float(oc.radius))
                sph_f.append(mu)
            else:
                spheres.append((tuple(oc.center), float(oc.radius)))
        elif kind == "halfspace":
            n = np.asarray(oc.normal, np.float32)
            norm = float(np.linalg.norm(n))
            if norm == 0.0:
                raise ValueError("halfspace obstacle needs a nonzero normal")
            halves_p.append(np.asarray(oc.point, np.float32))
            halves_n.append(n / norm)
            half_f.append(mu)
        elif kind == "box":
            box_lo.append(np.asarray(oc.lo, np.float32))
            box_hi.append(np.asarray(oc.hi, np.float32))
            box_f.append(mu)
        elif kind == "mesh":
            if dim != 3:
                raise ValueError("mesh obstacles are 3D only")
            g, o, s = build_mesh_sdf(oc.obj, oc.scale, oc.offset,
                                     oc.resolution)
            grids.append(g)
            origins.append(o)
            spacings.append(s)
            sdf_f.append(mu)
        else:
            raise ValueError(f"unknown obstacle type {kind!r}")

    def t(a):
        return torch.as_tensor(np.stack(a), device=device)

    fields = dict(half_f=tuple(half_f), box_f=tuple(box_f),
                  sdf_f=tuple(sdf_f), sph_f=tuple(sph_f))
    if halves_p:
        fields.update(half_p=t(halves_p), half_n=t(halves_n))
    if box_lo:
        fields.update(box_lo=t(box_lo), box_hi=t(box_hi))
    if sph_c:
        fields.update(sph_c=t(sph_c), sph_r=torch.as_tensor(
            np.asarray(sph_r, np.float32), device=device))
    if grids:
        shapes = {g.shape for g in grids}
        if len(shapes) > 1:
            raise ValueError(
                f"all mesh obstacles must share one grid shape, got {shapes}"
            )
        fields.update(sdf_grid=t(grids), sdf_origin=t(origins),
                      sdf_spacing=torch.as_tensor(
                          np.asarray(spacings, np.float32), device=device))
    return fields, spheres


# ---------------------------------------------------------------------------
# Signed distance and normals on the device
# ---------------------------------------------------------------------------


def sample_sdf_grid(grid: torch.Tensor, origin: torch.Tensor,
                    spacing: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Trilinear sample (N,) of one SDF grid (nx, ny, nz) at ``pts`` (N, 3);
    out-of-grid points clamp to the (positive) margin cells."""
    n = torch.tensor(grid.shape, dtype=pts.dtype, device=pts.device)
    u = (pts - origin[None, :]) / spacing
    u = torch.minimum(torch.clamp(u, min=0.0), n[None, :] - 1.001)
    i0 = torch.floor(u).to(torch.int64)
    f = u - i0.to(pts.dtype)
    flat = grid.reshape(-1)
    sy, sz = grid.shape[1] * grid.shape[2], grid.shape[2]
    out = torch.zeros_like(pts[:, 0])
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = 1.0
                for fc, dd in ((f[:, 0], dx), (f[:, 1], dy), (f[:, 2], dz)):
                    w = w * (fc if dd == 1 else 1.0 - fc)
                idx = ((i0[:, 0] + dx) * sy + (i0[:, 1] + dy) * sz
                       + (i0[:, 2] + dz))
                out = out + w * flat[idx]
    return out


def _mesh_phi_normal(grid, origin, spacing, pos):
    """(φ (N, 1), outward unit normal (N, 3)) of one mesh-SDF obstacle, the
    normal from central differences at half-cell offsets."""
    phi = sample_sdf_grid(grid, origin, spacing, pos)[:, None]
    h = 0.5 * spacing
    comps = []
    for ax in range(3):
        e = torch.zeros((1, 3), dtype=pos.dtype, device=pos.device)
        e[0, ax] = h
        comps.append(sample_sdf_grid(grid, origin, spacing, pos + e)
                     - sample_sdf_grid(grid, origin, spacing, pos - e))
    g = torch.stack(comps, dim=-1)
    norm = torch.sqrt(torch.sum(g * g, dim=-1, keepdim=True))
    return phi, g / torch.clamp(norm, min=1e-20)


def _box_phi_normal(lo, hi, pos):
    """(φ (N, 1), outward unit normal (N, d)) of one SOLID axis-aligned box:
    inside, φ is minus the distance to the nearest face and the normal that
    face's axis (only φ < 0 matters to the slide)."""
    d = pos.shape[1]
    d2 = torch.cat([pos - lo[None, :], hi[None, :] - pos], dim=1)  # (N, 2d)
    inside = torch.all(d2 > 0.0, dim=1, keepdim=True)
    mind = torch.min(d2, dim=1, keepdim=True).values
    phi = torch.where(inside, -mind, torch.clamp(-mind, min=1e-6))
    face = torch.argmin(d2, dim=1)  # first nearest face, as jnp.argmin
    axis = face % d
    sign = torch.where(face < d, -1.0, 1.0).to(pos.dtype)
    eye = torch.eye(d, dtype=pos.dtype, device=pos.device)
    return phi, sign[:, None] * eye[axis]


def _slide(v, phi, normal, mu: float = 0.0):
    """The circle slide on an SDF: ``(v', hit (N, 1), normal, s)`` with s
    the tangential Coulomb scale max(0, 1 − μ·|v_n|/|v_t|) for μ > 0 (the
    normal impulse removed |v_n|), None for μ = 0 (the exact slide)."""
    vn = torch.sum(v * normal, dim=-1, keepdim=True)
    hit = (phi < 0.0) & (vn < 0.0)
    v_t = v - vn * normal
    if mu > 0.0:
        t_speed = torch.sqrt(torch.sum(v_t * v_t, dim=-1, keepdim=True))
        s = torch.clamp(1.0 - mu * (-vn) / torch.clamp(t_speed, min=1e-20),
                        min=0.0)
        return torch.where(hit, s * v_t, v), hit, normal, s
    return torch.where(hit, v_t, v), hit, normal, None


def _iter_obstacles(obstacles, pos):
    """(φ, normal, μ) of each typed obstacle, in the JAX order: half-spaces,
    boxes, frictional spheres, mesh SDFs."""

    def _mu(fric, k):
        return float(fric[k]) if k < len(fric) else 0.0

    if obstacles.half_p is not None:
        for k in range(obstacles.half_p.shape[0]):
            p, n = obstacles.half_p[k], obstacles.half_n[k]
            phi = torch.sum((pos - p[None, :]) * n[None, :], dim=-1,
                            keepdim=True)
            yield phi, n[None, :].expand(pos.shape), _mu(obstacles.half_f, k)
    if obstacles.box_lo is not None:
        for k in range(obstacles.box_lo.shape[0]):
            phi, normal = _box_phi_normal(obstacles.box_lo[k],
                                          obstacles.box_hi[k], pos)
            yield phi, normal, _mu(obstacles.box_f, k)
    if obstacles.sph_c is not None:
        for k in range(obstacles.sph_c.shape[0]):
            disp = pos - obstacles.sph_c[k][None, :]
            dist = torch.sqrt(torch.sum(disp * disp, dim=-1, keepdim=True))
            yield (dist - obstacles.sph_r[k],
                   disp / torch.clamp(dist, min=1e-20),
                   _mu(obstacles.sph_f, k))
    if obstacles.sdf_grid is not None:
        for k in range(obstacles.sdf_grid.shape[0]):
            phi, normal = _mesh_phi_normal(
                obstacles.sdf_grid[k], obstacles.sdf_origin[k],
                obstacles.sdf_spacing[k], pos)
            yield phi, normal, _mu(obstacles.sdf_f, k)


def has_extensions(obstacles) -> bool:
    return (obstacles.half_p is not None or obstacles.box_lo is not None
            or obstacles.sph_c is not None or obstacles.sdf_grid is not None)


def apply_extensions_explicit(pos: torch.Tensor, v: torch.Tensor,
                              obstacles) -> torch.Tensor:
    """The slides of every typed obstacle in sequence (explicit
    advection), each seeing the velocity the previous one left."""
    for phi, normal, mu in _iter_obstacles(obstacles, pos):
        v = _slide(v, phi, normal, mu)[0]
    return v


def apply_extensions_implicit(pos, v, vel, vel_g, obstacles):
    """Implicit-advection slides: the hit test on the combined velocity
    v = vel + vel_g, and on a hit the normal component removed from each
    channel on its own (the reference's implicit circle structure); with
    friction each channel maps u → s·(u − (u·n)n), linear, so the channels
    still sum to v.  Returns (v, vel, vel_g)."""
    for phi, normal, mu in _iter_obstacles(obstacles, pos):
        v, hit, n, s = _slide(v, phi, normal, mu)
        scale = 1.0 if s is None else s

        def chan(u, hit=hit, n=n, scale=scale):
            u_t = u - torch.sum(u * n, dim=-1, keepdim=True) * n
            return torch.where(hit, scale * u_t, u)

        vel = chan(vel)
        vel_g = chan(vel_g)
    return v, vel, vel_g
