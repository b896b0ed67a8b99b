# coding=utf-8
"""Batched closed-form small-matrix primitives (dim ∈ {2, 3}) on tensors.

The port of the JAX package's ``ops/smallmat.py``, its Jacobi eigensolve
(``sym_eigh``) included. Every formula follows the component order of the
element kernel it stands beside (``fem_tpu_torch/csrc/element_chain.cu``,
itself the port of the Pallas ``k_and_h_chain``): products sum k = 0, 1, 2
left to right and the inverse multiplies the adjugate by ``1/det`` — so the
plain version and the CUDA kernel round alike. All functions take tensors
whose last two axes are the matrix axes and batch over any leading axes."""

from __future__ import annotations

import torch


def mT(m: torch.Tensor) -> torch.Tensor:
    return m.transpose(-1, -2)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(…, d, d) @ (…, d, d) as Σ_k a[:, k]·b[k, :] accumulated in k order
    (no BLAS: a batched 3×3 GEMM would sum in an order of its own)."""
    d = a.shape[-1]
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, d):
        out = out + a[..., :, k : k + 1] * b[..., k : k + 1, :]
    return out


def det(m: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., d, d), d in {2, 3}, closed form."""
    d = m.shape[-1]
    if d == 2:
        return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    if d == 3:
        return (
            m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
        )
    raise ValueError(f"unsupported matrix dim {d}")


def adjugate(m: torch.Tensor) -> torch.Tensor:
    """Adjugate (cofactor transpose) of (..., d, d)."""
    d = m.shape[-1]
    if d == 2:
        rows = [[m[..., 1, 1], -m[..., 0, 1]], [-m[..., 1, 0], m[..., 0, 0]]]
    elif d == 3:
        rows = [
            [
                m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1],
                m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2],
                m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1],
            ],
            [
                m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2],
                m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0],
                m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2],
            ],
            [
                m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0],
                m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1],
                m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0],
            ],
        ]
    else:
        raise ValueError(f"unsupported matrix dim {d}")
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def inv(m: torch.Tensor, det_m: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse of (..., d, d) as adjugate·(1/det) — the reference's raw
    determinant, no clamp (a singular element gives inf, as in the
    reference)."""
    if det_m is None:
        det_m = det(m)
    return adjugate(m) * (1.0 / det_m)[..., None, None]


def safe_inv(m: torch.Tensor, det_eps: float = 1e-6) -> torch.Tensor:
    """Inverse with the determinant clamped away from zero, sign kept
    (|det| ≥ ``det_eps``): the ``robust_inversion`` extension's F⁻¹ (the JAX
    package's ``safe_inv``)."""
    dt = det(m)
    dt_safe = torch.where(dt < 0, -1.0, 1.0).to(m.dtype) * torch.clamp(
        dt.abs(), min=det_eps)
    return inv(m, dt_safe)


def _cof2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The symmetrized bilinear 3×3 cofactor form: cof2(m, m) = 2·cof(m),
    cof2(m, d) = Dcof(m)[d] (the JAX package's ``_planar_cof2``)."""
    idx = [0, 1, 2]
    rows = []
    for i in range(3):
        p, q = [r for r in idx if r != i]
        row = []
        for j in range(3):
            r, s = [c for c in idx if c != j]
            sign = 1.0 if (i + j) % 2 == 0 else -1.0
            row.append(sign * (
                a[..., p, r] * b[..., q, s] + b[..., p, r] * a[..., q, s]
                - a[..., p, s] * b[..., q, r] - b[..., p, s] * a[..., q, r]
            ))
        rows.append(torch.stack(row, dim=-1))
    return torch.stack(rows, dim=-2)


def cofactor(m: torch.Tensor) -> torch.Tensor:
    """cof(M) = adj(M)ᵀ = ∂det M/∂M, polynomial in the entries (finite for
    every M, singular and inverted ones included)."""
    if m.shape[-1] == 2:
        return torch.stack([torch.stack([m[..., 1, 1], -m[..., 1, 0]], -1),
                            torch.stack([-m[..., 0, 1], m[..., 0, 0]], -1)],
                           dim=-2)
    return 0.5 * _cof2(m, m)


def d_cofactor(m: torch.Tensor, d_dir: torch.Tensor) -> torch.Tensor:
    """The directional derivative Dcof(M)[D]: cof(D) in 2D (cof is linear),
    the product rule of each 2×2 minor in 3D."""
    return cofactor(d_dir) if m.shape[-1] == 2 else _cof2(m, d_dir)


def polar_rotation(m: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Rotation factor R of the polar decomposition M = R·S by Higham's
    iteration R ← ½(R + R⁻ᵀ), exactly ``iters`` times (no convergence exit;
    the JAX package's ``polar_rotation`` and its planar twin
    ``_planar_polar``), the inverse as the adjugate times 1/det.  Smooth at
    the rest pose, so autograd runs through it; for det M < 0 the limit is
    the orthogonal, not special-orthogonal, factor."""
    r = m
    for _ in range(iters):
        r = 0.5 * (r + mT(inv(r)))
    return r


def trace(m: torch.Tensor) -> torch.Tensor:
    d = m.shape[-1]
    out = m[..., 0, 0]
    for i in range(1, d):
        out = out + m[..., i, i]
    return out


def gram(f: torch.Tensor) -> torch.Tensor:
    """FᵀF of (..., d, d), each entry Σ_k f[k, i]·f[k, j] in k order."""
    return matmul(mT(f), f)


def _jacobi_t_plain(app, aqq, apq, off, one, zero):
    tau = (aqq - app) / (2.0 * torch.where(off, apq, one))
    sgn = torch.where(tau >= 0.0, one, -one)
    return torch.where(
        off, sgn / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau)), zero)


class _JacobiT(torch.autograd.Function):
    """The Jacobi rotation's t = tan θ, its forward :func:`_jacobi_t_plain`
    unchanged, its backward the closed form dt = (1 + t²)·dθ with
    dθ = (δ·da_pq − a_pq·dδ)/(δ² + 4a_pq²), δ = a_qq − a_pp (0 where
    a_pq = 0, where t is 0): autograd of τ = δ/2a_pq meets 0·∞ once a_pq is
    tiny and its square underflows."""

    @staticmethod
    def forward(ctx, app, aqq, apq):
        off = torch.abs(apq) > 0.0
        one = torch.ones_like(app)
        t = _jacobi_t_plain(app, aqq, apq, off, one, torch.zeros_like(one))
        ctx.save_for_backward(app, aqq, apq, t)
        return t

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        app, aqq, apq, t = ctx.saved_tensors
        delta = aqq - app
        den = delta * delta + 4.0 * apq * apq
        off = (torch.abs(apq) > 0.0) & (den > 0.0)
        w = torch.where(off, g * (1.0 + t * t)
                        / torch.where(off, den, torch.ones_like(den)), 0.0)
        return w * apq, -w * apq, w * delta


def sym_eigh_core(a: dict, d: int, sweeps: int = 6):
    """Cyclic-Jacobi eigendecomposition on component planes (the JAX
    package's ``sym_eigh_core``, its ops/smallmat.py:204-251, step for
    step): ``a`` maps (i, j), i ≤ j, to the symmetric matrix's components
    (tensors of any one shape).  Returns the rotated dict (eigenvalues at
    (i, i)) and the rotation dict v[(i, j)] with A = V·diag(w)·Vᵀ.  2D is
    one exact rotation; 3D ``sweeps`` sweeps over (0, 1), (0, 2), (1, 2).
    The guards stay as they are: a_pq = 0 is the identity rotation, τ = 0
    with a_pq ≠ 0 a 45° one (a ±1 sign, not sign(τ)).  Under autograd the
    rotation's t takes its closed-form derivative (:class:`_JacobiT`), so
    that a tiny a_pq gives no NaN gradient."""
    pairs = [(0, 1)] if d == 2 else [(0, 1), (0, 2), (1, 2)]
    a = dict(a)
    one = torch.ones_like(a[(0, 0)])
    zero = torch.zeros_like(one)
    v = {(i, j): (one if i == j else zero) for i in range(d) for j in range(d)}

    def sym(i, j):
        return (i, j) if i <= j else (j, i)

    for _ in range(1 if d == 2 else sweeps):
        for p, q in pairs:
            app, aqq, apq = a[(p, p)], a[(q, q)], a[(p, q)]
            if torch.is_grad_enabled() and any(
                    x.requires_grad for x in (app, aqq, apq)):
                t = _JacobiT.apply(app, aqq, apq)
            else:
                t = _jacobi_t_plain(app, aqq, apq, torch.abs(apq) > 0.0,
                                    one, zero)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            a[(p, p)] = c * c * app - 2.0 * s * c * apq + s * s * aqq
            a[(q, q)] = s * s * app + 2.0 * s * c * apq + c * c * aqq
            a[(p, q)] = zero
            for r in range(d):
                if r == p or r == q:
                    continue
                apr, aqr = a[sym(p, r)], a[sym(q, r)]
                a[sym(p, r)] = c * apr - s * aqr
                a[sym(q, r)] = s * apr + c * aqr
            for i in range(d):
                vip, viq = v[(i, p)], v[(i, q)]
                v[(i, p)] = c * vip - s * viq
                v[(i, q)] = s * vip + c * viq
    return a, v


def sym_eigh(m: torch.Tensor, sweeps: int = 6):
    """Eigendecomposition of symmetric (..., d, d), d ∈ {2, 3}, by
    :func:`sym_eigh_core`: ``(w (..., d), V (..., d, d))`` with
    m ≈ V·diag(w)·Vᵀ, eigenvalues not sorted."""
    d = m.shape[-1]
    if d not in (2, 3):
        raise ValueError(f"unsupported matrix dim {d}")
    a = {(i, j): m[..., i, j] for i in range(d) for j in range(i, d)}
    a, v = sym_eigh_core(a, d, sweeps)
    w = torch.stack([a[(i, i)] for i in range(d)], dim=-1)
    vm = torch.stack(
        [torch.stack([v[(i, j)] for j in range(d)], dim=-1) for i in range(d)],
        dim=-2,
    )
    return w, vm
