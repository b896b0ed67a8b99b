# coding=utf-8
"""The plain reference of the benchmark's frames: Neo-Hookean tetrahedra (or
triangles) under the semi-implicit CG method and the explicit method, with
the unit-box walls and circle obstacles of the scene's advection.

A frozen statement of the semantics the benchmark holds the program to,
written from the published method (Jukgei/Finite-Element-Method:
solver/implicit.py, solver/explicit.py, solver/kinematic.py) as the program
documents it.  Plain PyTorch, elementwise products only (no matmul, so no
TF32), and nothing imported from the program.  Every function takes the
precision it computes in from its tensors; ``chain_dtype`` runs the element
chain and the operator's products in a lower precision (the control).

One substep, implicit (``implicit_method`` 1, ``preconditioned`` 1):

* per element F = X·R⁻¹ (X the edge matrix, columns x_{j+1} − x_0), the
  block K_e = −V·[μR⁻¹ + (μ − λ·log max(J, 1e-4))·F⁻ᵀR⁻ᵀF⁻ᵀ +
  λ·tr(F⁻¹R⁻¹)·F⁻ᵀ]·R⁻ᵀ and the force columns −V·[μF + (λ/2·log J² −
  μ)·F⁻ᵀ]·R⁻ᵀ, column j to vertex j+1 and −Σ_j to vertex 0;
* b = v + dt·f/m, A·x = x − dt²·G(K)·x/m with G(K)·x the same assembly of
  K_e·(x_{j+1} − x_0), and CG on the normal equations AᵀA·x = Aᵀb from
  x₀ = b while ‖r‖² > 1e-5 (absolute), at most 500 iterations;
* advection: the gravity channel v_g += g·dt, both channels decay by
  exp(−dt·damping), components moving out through the lower walls are
  zeroed in both channels and through the upper walls in v only (not v_g),
  circles project the combined velocity and both channels, and
  x += (v + v_g)·dt.

One substep, explicit: the gradient columns +V·[μF + (λ·log J − μ)·F⁻ᵀ]·R⁻ᵀ
assembled alike, v += (g − ∇U/m)·dt, the decay, the walls on v, the
circles, and x += v·dt.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

CG_TOL = 1e-5
CG_MAX_ITER = 500


class Body(NamedTuple):
    """What the reference needs of one body, in its own precision."""

    tets: torch.Tensor  # (E, d+1) int64
    ref_inv: torch.Tensor  # (E, d, d)
    volume: torch.Tensor  # (E,)
    mass: torch.Tensor  # (N,)
    mu: float
    lam: float
    damping: float
    dim: int


class Scene(NamedTuple):
    dt: float
    sim_count: int
    gravity: torch.Tensor  # (d,) = 9.8·g_dir
    centers: torch.Tensor  # (O, d)
    radii: torch.Tensor  # (O,)
    explicit: bool


class State(NamedTuple):
    pos: torch.Tensor
    vel: torch.Tensor
    vel_g: torch.Tensor


def lame(E: float, nu: float):
    """(μ, λ) from Young's modulus and Poisson's ratio."""
    return E / 2.0 / (1.0 + nu), E * nu / (1.0 + nu) / (1.0 - 2.0 * nu)


# -- small matrices, elementwise ------------------------------------------

def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a·b of (…, d, d) matrices as a sum of products."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def mt(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-1, -2)


def det(a: torch.Tensor) -> torch.Tensor:
    if a.shape[-1] == 2:
        return a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    return (a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2]
                            - a[..., 1, 2] * a[..., 2, 1])
            - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2]
                              - a[..., 1, 2] * a[..., 2, 0])
            + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1]
                              - a[..., 1, 1] * a[..., 2, 0]))


def adjugate(a: torch.Tensor) -> torch.Tensor:
    if a.shape[-1] == 2:
        return torch.stack([torch.stack([a[..., 1, 1], -a[..., 0, 1]], -1),
                            torch.stack([-a[..., 1, 0], a[..., 0, 0]], -1)],
                           -2)
    c = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            r = [k for k in range(3) if k != i]
            s = [k for k in range(3) if k != j]
            minor = (a[..., r[0], s[0]] * a[..., r[1], s[1]]
                     - a[..., r[0], s[1]] * a[..., r[1], s[0]])
            c[j][i] = minor if (i + j) % 2 == 0 else -minor  # transposed
    return torch.stack([torch.stack(row, -1) for row in c], -2)


def inv(a: torch.Tensor, d: Optional[torch.Tensor] = None) -> torch.Tensor:
    d = det(a) if d is None else d
    return adjugate(a) / d[..., None, None]


def trace(a: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(a, dim1=-2, dim2=-1).sum(-1)


# -- the mesh ---------------------------------------------------------------

def edge_matrix(x: torch.Tensor, tets: torch.Tensor) -> torch.Tensor:
    """(E, d, d) with column j = x[v_{j+1}] − x[v_0]."""
    p = x[tets]
    return mt(p[:, 1:, :] - p[:, :1, :])


def assemble(cols: torch.Tensor, tets: torch.Tensor, n: int) -> torch.Tensor:
    """Column j of each element to its vertex j+1, −Σ_j to its vertex 0."""
    c = mt(cols)  # row j = column j
    rows = torch.cat([-c.sum(dim=1, keepdim=True), c], dim=1)  # (E, d+1, d)
    out = torch.zeros((n, cols.shape[-1]), dtype=cols.dtype,
                      device=cols.device)
    out.index_add_(0, tets.reshape(-1), rows.reshape(-1, cols.shape[-1]))
    return out


def make_body(rest_pos: np.ndarray, tets: np.ndarray, rho: float, E: float,
              nu: float, damping: float, dtype=torch.float64,
              device="cpu") -> Body:
    """Rest volumes |det X|/d!, lumped masses V·ρ/(d+1) and R⁻¹ = X⁻¹ of
    the rest edge matrices, from the rest positions as given."""
    x = torch.as_tensor(np.asarray(rest_pos, np.float64))
    t = torch.as_tensor(np.asarray(tets, np.int64))
    d = x.shape[1]
    X = edge_matrix(x, t)
    vol = det(X).abs() / math.factorial(d)
    mass = torch.zeros(x.shape[0], dtype=torch.float64)
    mass.index_add_(0, t.reshape(-1),
                    (vol * rho / (d + 1)).repeat_interleave(d + 1))
    mu, lam = lame(E, nu)
    return Body(t.to(device), inv(X).to(device, dtype),
                vol.to(device, dtype), mass.to(device, dtype), mu, lam,
                damping, d)


# -- the element chains ----------------------------------------------------

def implicit_chain(F, R, mu, lam):
    """Unscaled (K_e, force column) chain of the implicit method."""
    J = det(F)
    f_inv = inv(F, J)
    f_inv_t = mt(f_inv)
    r_t = mt(R)
    log_j = torch.log(torch.clamp(J, min=1e-4))[..., None, None]
    term2 = mm(mm(f_inv_t, r_t), f_inv_t)
    tr = trace(mm(f_inv, R))[..., None, None]
    k = mm(mu * R + (mu - lam * log_j) * term2 + (lam * tr) * f_inv_t, r_t)
    p = mu * F + (lam / 2.0 * torch.log(J * J)[..., None, None] - mu) * f_inv_t
    return k, mm(p, r_t)


def explicit_chain(F, R, mu, lam):
    """Unscaled energy-gradient columns of the explicit method."""
    J = det(F)
    f_inv_t = mt(inv(F, J))
    p = mu * F + (lam * torch.log(J)[..., None, None] - mu) * f_inv_t
    return mm(p, mt(R))


# -- advection ----------------------------------------------------------------

def _circles(pos, channels, centers, radii):
    """Each circle in order: where a vertex is inside it and the combined
    velocity (channel 0) points toward its center, every channel loses its
    component along the offset.  A radius-0 circle never hits."""
    for b in range(radii.shape[0]):
        if float(radii[b]) <= 0.0:
            continue
        disp = pos - centers[b][None, :]
        dist_sq = (disp * disp).sum(-1, keepdim=True)
        hit = ((dist_sq < radii[b] ** 2)
               & ((channels[0] * (-disp)).sum(-1, keepdim=True) > 0.0))
        denom = torch.clamp(dist_sq, min=1e-30)
        channels = [torch.where(hit, u - ((u * disp).sum(-1, keepdim=True)
                                          / denom) * disp, u)
                    for u in channels]
    return channels


def advect_implicit(s: State, vel: torch.Tensor, scene: Scene,
                    decay: float) -> State:
    vel_g = (s.vel_g + scene.gravity * scene.dt) * decay
    vel = vel * decay
    v = vel + vel_g
    lower = (s.pos < 0.0) & (v < 0.0)
    vel, vel_g, v = (torch.where(lower, 0.0, u) for u in (vel, vel_g, v))
    upper = (s.pos > 1.0) & (v > 0.0)
    vel, v = (torch.where(upper, 0.0, u) for u in (vel, v))
    v, vel, vel_g = _circles(s.pos, [v, vel, vel_g], scene.centers,
                             scene.radii)
    return State(s.pos + v * scene.dt, vel, vel_g)


def advect_explicit(s: State, grad: torch.Tensor, mass: torch.Tensor,
                    scene: Scene, decay: float) -> State:
    vel = (s.vel + (scene.gravity - grad / mass[:, None]) * scene.dt) * decay
    out = ((s.pos < 0.0) & (vel < 0.0)) | ((s.pos > 1.0) & (vel > 0.0))
    vel = torch.where(out, 0.0, vel)
    (vel,) = _circles(s.pos, [vel], scene.centers, scene.radii)
    return State(s.pos + vel * scene.dt, vel, s.vel_g)


# -- the solve ------------------------------------------------------------------

def graph_apply(K, x, tets, chain_dtype=None):
    """G(K)·x: K_e·(x_{j+1} − x_0) to vertex j+1, −Σ_j to vertex 0."""
    S = edge_matrix(x, tets)
    if chain_dtype is not None:
        S = S.to(chain_dtype)
    return assemble(mm(K, S).to(x.dtype), tets, x.shape[0])


def cg(op, rhs, x0, tol=CG_TOL, max_iter=CG_MAX_ITER):
    """CG from x0 while ‖r‖² > tol (absolute); returns (x, iterations)."""
    x = x0
    r = rhs - op(x0)
    d = r
    delta = (r * r).sum()
    it = 0
    while it < max_iter and float(delta) > tol:
        q = op(d)
        alpha = delta / (d * q).sum()
        x = x + alpha * d
        r = r - alpha * q
        delta_next = (r * r).sum()
        d = r + (delta_next / delta) * d
        delta = delta_next
        it += 1
    return x, it


def substep(body: Body, scene: Scene, s: State, chain_dtype=None):
    """One substep; returns (state, CG iterations)."""
    dt, n = scene.dt, s.pos.shape[0]
    decay = math.exp(-dt * body.damping)
    X = edge_matrix(s.pos, body.tets)
    R = body.ref_inv
    if chain_dtype is not None:
        X, R = X.to(chain_dtype), R.to(chain_dtype)
    F = mm(X, R)
    vol = body.volume.to(F.dtype)[:, None, None]
    if scene.explicit:
        cols = (vol * explicit_chain(F, R, body.mu, body.lam)).to(s.pos.dtype)
        grad = assemble(cols, body.tets, n)
        return advect_explicit(s, grad, body.mass, scene, decay), 0
    k, h = implicit_chain(F, R, body.mu, body.lam)
    K = -vol * k
    f = assemble((-vol * h).to(s.pos.dtype), body.tets, n)
    minv = (1.0 / body.mass)[:, None]
    b = s.vel + dt * f * minv
    c = dt * dt
    K_t = mt(K)

    def apply_a(v):
        return v - c * graph_apply(K, v, body.tets, chain_dtype) * minv

    def apply_at(v):
        return v - c * graph_apply(K_t, v * minv, body.tets, chain_dtype)

    x, it = cg(lambda v: apply_at(apply_a(v)), apply_at(b), b)
    return advect_implicit(s, x, scene, decay), it


def frame(body: Body, scene: Scene, s: State, chain_dtype=None):
    """``sim_count`` substeps; returns (state, [iterations a substep])."""
    iters = []
    for _ in range(scene.sim_count):
        s, it = substep(body, scene, s, chain_dtype)
        iters.append(it)
    return s, iters
