# coding=utf-8
"""Linearized (eigenvalue) buckling analysis.

The port of the JAX package's ``solvers/buckling.py``: with K₀ the exact
tangent at the unloaded pose x₀, K₁ the tangent at the equilibrium x₁ of
the unit load (``solvers/static.solve_static``) and K_g = K₁ − K₀, the
critical multipliers are λ = −1/μ of the most negative pencil eigenvalues
K_g φ = μ K₀ φ.  Pins are projected (K₀ ← P·K₀·P + (I−P), K_g ←
P·K_g·P); the smallest μ come from shifted block subspace iteration on
σI − K₀⁻¹K_g (σ the largest Ritz value of the last round), K₀⁻¹ by a
blocked inner CG, and a kq×kq Rayleigh–Ritz on the projected pencil each
round, with the host-side early stop on the wanted residuals.

K₀·V and K₁·V are ``modal.make_stiffness_hvp`` products (one launch of the
stiffness kernel H1 each on a CUDA object); K_g·V keeps the JAX package's
form K₁·V − K₀·V, which cancels in f32 as it does there.  A round at
``inner_iters`` = 400 makes 405 block products: 400 inner-CG products of
K₀, K₁ and K₀ on X, then K₀ twice and K₁ once on Q.

The random start comes from a CPU ``torch.Generator`` seeded with ``seed``
and is moved to the device, so the card and the CPU start from the same
block.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from fem_tpu_torch.models.state import FemObject
from fem_tpu_torch.solvers.modal import _block_cg, _start_vectors
from fem_tpu_torch.solvers.modal import make_stiffness_hvp
from fem_tpu_torch.solvers.static import StaticResult, solve_static


class BucklingResult(NamedTuple):
    """Critical load multipliers sorted ascending (most critical first).

    ``load_factors``: (k,) multipliers λ at which K₀ + λ·K_g goes singular;
    +inf where no destabilizing direction was found.  ``mu``: (k,) pencil
    eigenvalues (λ = −1/μ).  ``modes``: (k, N, dim) buckling mode shapes,
    K₀-orthonormal, zero on pinned DOFs up to the QR's rounding.  ``residuals``: (k,) relative
    pencil residuals.  ``base``: the unit-load equilibrium
    (``StaticResult``) the stress stiffness was linearized at.
    """

    load_factors: torch.Tensor
    mu: torch.Tensor
    modes: torch.Tensor
    residuals: torch.Tensor
    base: StaticResult


def linear_buckling(
    obj: FemObject,
    pos0: torch.Tensor,
    f_ext: Optional[torch.Tensor] = None,
    g_dir: Optional[Tuple[float, ...]] = None,
    k: int = 4,
    rounds: int = 16,
    inner_iters: int = 400,
    target_tol: float = 1e-3,
    seed: int = 0,
    base: Optional[StaticResult] = None,
    static_kwargs: Optional[dict] = None,
) -> BucklingResult:
    """Smallest-``k`` critical load factors of ``obj`` under ``f_ext``
    (N, d) plus gravity along ``g_dir`` plus the built-in ``static_load``,
    all scaled together by λ.  Requires pins (``obj.free_mask``).  ``base``
    re-uses a solved unit-load equilibrium; otherwise :func:`solve_static`
    runs first (``static_kwargs`` forwarded).  Each round costs
    ``inner_iters`` + 5 block products; the rounds run are left in
    ``linear_buckling.last_rounds``."""
    if obj.free_mask is None:
        raise ValueError(
            "linear_buckling requires Dirichlet constraints "
            "(ObjectConfig.pin_boxes / obj.free_mask), same as solve_static")
    n, d = pos0.shape
    nd = n * d
    kq = min(k + max(4, k), max(k + 1, nd // 3))
    if kq < k:
        raise ValueError(f"mesh too small for k={k} buckling modes (nd={nd})")
    if base is None:
        base = solve_static(obj, pos0, f_ext=f_ext, g_dir=g_dir,
                            **(static_kwargs or {}))
    pos1 = base.pos

    kv0 = make_stiffness_hvp(obj, pos0)
    kv1 = make_stiffness_hvp(obj, pos1)
    free = obj.free_mask.to(pos0.dtype)  # (N, 1)
    free_flat = free[:, 0].repeat_interleave(d)[:, None]  # (nd, 1)
    f3 = free[..., None]

    def a0_block(y):
        """P·K₀·P + (I−P) on a block (nd, c)."""
        c = y.shape[1]
        v = (y * free_flat).reshape(n, d, c)
        w = (kv0(v) * f3).reshape(nd, c)
        return w + (y - y * free_flat)

    def g_block(y):
        """P·(K₁ − K₀)·P on a block (nd, c)."""
        c = y.shape[1]
        v = (y * free_flat).reshape(n, d, c)
        return ((kv1(v) - kv0(v)) * f3).reshape(nd, c)

    def one_round(x, sigma):
        y = sigma * x - _block_cg(a0_block, g_block(x), inner_iters)
        y = y / (torch.linalg.vector_norm(y, dim=0, keepdim=True) + 1e-30)
        q, _ = torch.linalg.qr(y)
        aq = a0_block(q)
        gq = g_block(q)
        k_hat = q.T @ aq
        g_hat = q.T @ gq
        k_hat = 0.5 * (k_hat + k_hat.T)
        g_hat = 0.5 * (g_hat + g_hat.T)
        eye = torch.eye(kq, dtype=k_hat.dtype, device=k_hat.device)
        jitter = 1e-6 * (torch.trace(k_hat) / kq)
        chol = torch.linalg.cholesky(k_hat + jitter * eye)
        inv_l = torch.linalg.solve_triangular(chol, eye, upper=False)
        mu, s = torch.linalg.eigh(inv_l @ g_hat @ inv_l.T)  # ascending
        s = inv_l.T @ s
        x_new = q @ s
        gx = gq @ s
        ax = aq @ s
        num = torch.linalg.vector_norm(gx - mu[None, :] * ax, dim=0)
        den = (torch.linalg.vector_norm(gx, dim=0)
               + torch.abs(mu) * torch.linalg.vector_norm(ax, dim=0))
        res = num / (den + 1e-30)
        sigma_next = torch.clamp(mu[-1], min=0.0)
        return x_new, mu, res, sigma_next

    (x,) = _start_vectors(seed, [(nd, kq)], pos0.dtype, pos0.device)
    x = x * free_flat
    sigma = torch.zeros((), dtype=pos0.dtype, device=pos0.device)
    mu = res = None
    rounds_run = 0
    for r in range(rounds):
        x, mu, res, sigma = one_round(x, sigma)
        rounds_run = r + 1
        if r >= 2 and bool(torch.max(res[:k]) < target_tol):
            break
    linear_buckling.last_rounds = rounds_run

    mu_k = mu[:k]
    tiny = 1e-12
    neg = mu_k < -tiny
    factors = torch.where(
        neg, -1.0 / torch.where(neg, mu_k, -torch.ones_like(mu_k)),
        torch.full_like(mu_k, float("inf")))
    modes = x[:, :k].reshape(n, d, k).permute(2, 0, 1)
    return BucklingResult(load_factors=factors, mu=mu_k, modes=modes,
                          residuals=res[:k], base=base)


linear_buckling.last_rounds = 0
