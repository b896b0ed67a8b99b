# coding=utf-8
"""Blocked LOBPCG for the top eigenpairs of a symmetric operator.

The port's own copy, in plain PyTorch, of the algorithm of JAX's
``jax.experimental.sparse.linalg.lobpcg_standard`` (its
``_lobpcg_standard_callable`` with ``_svqb``, ``_project_out``,
``_orthonormalize``, ``_rayleigh_ritz_orth`` and ``_extend_basis``;
Copyright 2022 The JAX Authors, Apache License 2.0), which the JAX
package's shift-invert modal analysis runs (its solvers/modal.py:206).  The
port imports nothing of JAX, so it keeps this copy.  ``torch.lobpcg`` is no
substitute: it takes a matrix, not an operator, and has another algorithm
and another stopping rule.

The iterates follow the JAX routine step for step: X, the search
directions P and the residuals R kept orthonormal, the residual basis
projected out of [X, P] ("twice is enough"), Rayleigh-Ritz on [X, P, R],
P from the orthogonalized complement of the Ritz block, and the stopping
rule on each residual against ``tol``·10·n·(‖A x‖ + θ).  The JAX routine's
``lax.while_loop`` becomes a Python loop that reads the converged count on
the host once an iteration.  Its input check calls A once on a zero column
only to trace shapes, a call XLA removes; here the shapes are checked on
the first real product instead.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def lobpcg_standard(
    A: Callable[[torch.Tensor], torch.Tensor],
    X: torch.Tensor,
    m: int = 100,
    tol: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The top-k eigenpairs of the symmetric operator ``A`` (a callable on
    (n, c) blocks) from the start block ``X`` (n, k), 0 < 5·k < n, in at
    most ``m`` iterations.  Returns (θ (k,) descending, U (n, k), the
    iterations run).  ``tol`` None is the float epsilon of X's dtype."""
    n, k = X.shape
    if k == 0:
        raise ValueError(f"must have search dim > 0, got {k}")
    if k * 5 >= n:
        raise ValueError(
            f"expected search dim * 5 < matrix dim (got {k * 5}, {n})")
    if tol is None:
        tol = float(torch.finfo(X.dtype).eps)

    def apply(s):
        out = A(s)
        if out.dtype != X.dtype or tuple(out.shape) != tuple(s.shape):
            raise ValueError(
                f"A must map ({n}, c) blocks of {X.dtype} to the same, got "
                f"{tuple(out.shape)} {out.dtype}")
        return out

    X = _orthonormalize(X)
    P = _extend_basis(X, X.shape[1])
    AX = apply(X)
    theta = torch.sum(X * AX, dim=0, keepdim=True)
    R = AX - theta * X
    i = 0
    converged = 0
    while i < m and converged < k:
        R = _project_out(torch.cat((X, P), dim=1), R)
        XPR = torch.cat((X, P, R), dim=1)
        theta, Q = _rayleigh_ritz_orth(apply, XPR)
        B = Q[:, :k]
        B = B / torch.linalg.vector_norm(B, dim=0, keepdim=True)
        X = XPR @ B
        X = X / torch.linalg.vector_norm(X, dim=0, keepdim=True)
        q, _ = torch.linalg.qr(Q[:k, k:].T)
        P = XPR @ (Q[:, k:] @ q)
        norm_p = torch.linalg.vector_norm(P, dim=0, keepdim=True)
        P = P / torch.where(norm_p == 0, torch.ones_like(norm_p), norm_p)
        AX = apply(X)
        R = AX - theta[None, :k] * X
        resid_norms = torch.linalg.vector_norm(R, dim=0)
        reltol = torch.linalg.vector_norm(AX, dim=0) + theta[:k]
        reltol = reltol * n
        reltol = reltol * 10
        converged = int(torch.sum(resid_norms < tol * reltol))
        theta = theta[None, :k]
        i += 1
    return theta[0, :], X, i


def _eigh_descending(a: torch.Tensor):
    w, v = torch.linalg.eigh(a)
    return w.flip(0), v.flip(1)


def _svqb(X: torch.Tensor) -> torch.Tensor:
    """A truncated orthonormal basis of X's columns (SVQB): columns of a
    numerically rank-deficient X come back zero."""
    norms = torch.linalg.vector_norm(X, dim=0, keepdim=True)
    X = X / torch.where(norms == 0, torch.ones_like(norms), norms)
    inner = X.T @ X
    w, V = _eigh_descending(inner)
    tau = torch.finfo(X.dtype).eps * w[0]
    padded = torch.maximum(w, tau)
    sqrted = torch.where(tau > 0, padded, torch.ones_like(padded)) ** (-0.5)
    ortho = X @ (V * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    ortho = ortho * keep.to(ortho.dtype)
    norms = torch.linalg.vector_norm(ortho, dim=0, keepdim=True)
    keep = keep & (norms > 0.0)
    return ortho / torch.where(keep, norms, torch.ones_like(norms))


def _project_out(basis: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """U's component in the orthogonal complement of the orthonormal (zero
    columns allowed) ``basis``, its nonzero columns orthonormal; columns
    that lose more than 1 % of their norm in the last subtraction are
    zeroed."""
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
        U = _orthonormalize(U)
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
    norm_u = torch.linalg.vector_norm(U, dim=0, keepdim=True)
    return U * (norm_u >= 0.99).to(U.dtype)


def _orthonormalize(basis: torch.Tensor) -> torch.Tensor:
    for _ in range(2):
        basis = _svqb(basis)
    return basis


def _rayleigh_ritz_orth(A, S: torch.Tensor):
    """(w descending, V) of Sᵀ·A·S for the orthonormal (zero columns
    allowed) S."""
    return _eigh_descending(S.T @ A(S))


def _extend_basis(X: torch.Tensor, m: int) -> torch.Tensor:
    """m more orthonormal columns orthogonal to the orthonormal (n, k) X,
    from a block Householder reflector (deterministic)."""
    n, k = X.shape
    x_upper, x_lower = X[:k], X[k:]
    u, s, vt = torch.linalg.svd(x_upper)
    y = torch.cat([x_upper + u @ vt, x_lower], dim=0)
    other = torch.cat([torch.eye(m, dtype=X.dtype, device=X.device),
                       torch.zeros((n - k - m, m), dtype=X.dtype,
                                   device=X.device)], dim=0)
    w = y @ (vt.T * ((2 * (1 + s)) ** (-1 / 2))[None, :])
    h = -2 * (w @ (w[k:, :].T @ other))
    h = h.clone()
    h[k:] = h[k:] + other
    return h
