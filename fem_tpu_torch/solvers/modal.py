# coding=utf-8
"""Modal analysis: natural frequencies and vibration mode shapes.

The port of the JAX package's ``solvers/modal.py``: the generalized
eigenproblem

    K φ = ω² M φ

at a configuration ``pos``, K = −∂f/∂x the exact material-generic elastic
stiffness and M the lumped diagonal mass, solved matrix-free on the
mass-symmetrized operator C = M^{−1/2} K M^{−1/2} with the pinned DOFs
projected out (C ← P·C·P, parked at the top of the spectrum).

K·W for a block of columns is ``make_stiffness_hvp``: each element's
Jacobian of its force columns formed once at ``pos``
(``implicit.element_linearization``), every product then one launch of the
stiffness kernel H1 (``ops/stiffness_kernels.py``) on a CUDA object, its
plain version on the CPU; the JAX package takes ``jax.jvp`` of the
assembled force, vmapped over the block.  The JAX package's jitted
programs and ``fori_loop``s become Python loops of PyTorch operations on
the object's device; its host-side stopping tests read the same values.

Random starts come from a CPU ``torch.Generator`` seeded with ``seed`` and
are moved to the device, so the card and the CPU start from the same
vectors (the JAX package's ``PRNGKey`` streams cannot be reproduced without
JAX; ``modal_analysis_chebyshev``'s ``x0_modes`` hands both packages the
same start).

Float64: the JAX package moves the f64 refinement, the f64 residuals and
the sparse oracle to the host CPU because a TPU has no f64.  The H100 has,
so here the f64 Chebyshev refinement and the f64 residuals run on the
object's device in float64 (H1's double instance on the card); only
scipy's ARPACK (``eigsh``) runs on the host, on element Hessians formed on
the object's device in float64 and copied over, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from fem_tpu_torch.convert import to_dtype
from fem_tpu_torch.models.state import FemObject
from fem_tpu_torch.solvers.implicit import (
    _force_columns,
    element_linearization,
)
from fem_tpu_torch.solvers.lobpcg import lobpcg_standard


class ModalResult(NamedTuple):
    """Eigenpairs sorted by ascending frequency.

    ``omega_sq``: (k,) eigenvalues ω² of K φ = ω² M φ.
    ``frequencies``: (k,) natural frequencies f = ω / 2π in Hz.
    ``modes``: (k, N, dim) M-orthonormal mode shapes (φᵢᵀ M φⱼ = δᵢⱼ).
    ``residuals``: (k,) relative residuals ‖Kφ − ω²Mφ‖ / (‖Kφ‖ + ω²‖Mφ‖).
    """

    omega_sq: torch.Tensor
    frequencies: torch.Tensor
    modes: torch.Tensor
    residuals: torch.Tensor


def make_stiffness_hvp(obj: FemObject, pos: torch.Tensor):
    """Exact elastic stiffness product v ↦ K·v = −(∂f/∂x)·v at ``pos``, for
    v of shape (N, d) or a block (N, d, c): the Jacobians of the force
    columns (``implicit._force_columns``, the JAX package's
    ``_material_force_columns``) formed once here, negated, and each
    product one ``stiffness_kernels.stiffness_apply``."""
    return element_linearization(_force_columns(obj, False, None), pos,
                                 obj.element_indices, obj.plan, negate=True)


def _start_vectors(seed: int, shapes, dtype, device):
    """Gaussian blocks of ``shapes`` drawn in turn from a CPU generator
    seeded with ``seed``, moved to ``device``."""
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen, dtype=dtype).to(device)
            for s in shapes]


def _operator(obj: FemObject, pos: torch.Tensor):
    """(c_apply, kv, inv_sqrt_m (N, 1), free (N, 1), free_flat (N·d,)):
    C·Y on a flat vector (N·d,) or a block (N·d, c), pinned DOFs projected
    out, and the stiffness product it wraps."""
    n, d = pos.shape
    kv = make_stiffness_hvp(obj, pos)
    inv_sqrt_m = (1.0 / torch.sqrt(obj.mass))[:, None]
    free = (obj.free_mask if obj.free_mask is not None
            else torch.ones((n, 1), dtype=pos.dtype, device=pos.device))
    free = free.to(pos.dtype)
    free_flat = free[:, 0].repeat_interleave(d)

    def c_apply(y):
        if y.dim() == 1:
            v = (y.reshape(n, d) * inv_sqrt_m) * free
            return (kv(v) * free * inv_sqrt_m).reshape(n * d)
        c = y.shape[1]
        s = inv_sqrt_m[..., None]
        f3 = free[..., None]
        v = (y.reshape(n, d, c) * s) * f3
        return (kv(v) * f3 * s).reshape(n * d, c)

    return c_apply, kv, inv_sqrt_m, free, free_flat


def _power_lam_max(c_apply, v0, steps):
    """|vᵀ C v| after ``steps`` normalized power steps from v0 (steps + 1
    applies)."""
    v = v0
    for _ in range(steps):
        w = c_apply(v)
        v = w / (torch.linalg.vector_norm(w) + 1e-30)
    return torch.abs(torch.dot(v, c_apply(v)))


def _block_cg(op_block, rhs, iters):
    """op⁻¹·RHS by blocked CG, every column together, a fixed ``iters``
    iterations (one block apply each)."""
    x = torch.zeros_like(rhs)
    r = rhs
    p = r
    rs = torch.sum(r * r, dim=0)
    for _ in range(iters):
        ap = op_block(p)
        denom = torch.sum(p * ap, dim=0)
        alpha = rs / torch.where(denom > 0, denom, torch.ones_like(denom))
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * ap
        rs_new = torch.sum(r * r, dim=0)
        beta = rs_new / torch.where(rs > 0, rs, torch.ones_like(rs))
        p = r + beta[None, :] * p
        rs = rs_new
    return x


def _result(omega_sq, modes, residuals) -> ModalResult:
    omega = torch.sqrt(torch.clamp(omega_sq, min=0.0))
    return ModalResult(omega_sq=omega_sq, frequencies=omega / (2.0 * math.pi),
                       modes=modes, residuals=residuals)


def modal_analysis(
    obj: FemObject,
    pos: torch.Tensor,
    k: int = 6,
    m: int = 100,
    tol: Optional[float] = None,
    inner_iters: int = 400,
    eps_rel: float = 1e-4,
    seed: int = 0,
    chunk_m: Optional[int] = None,
) -> ModalResult:
    """Smallest-``k`` vibration modes of ``obj`` linearized at ``pos`` by
    LOBPCG (``solvers/lobpcg.py``) on the shift-inverted operator
    (Ĉ + εI)⁻¹, Ĉ = P·C·P + λmax(I − P), ε = ``eps_rel``·λmax, λmax from 30
    power steps; each LOBPCG product an inner blocked CG of ``inner_iters``
    block applies.  ``k`` must satisfy 5·k < N·dim.  ``chunk_m`` restarts
    the LOBPCG every that many steps from its Ritz vectors, as the JAX
    package does (which changes the iterates).  The LOBPCG steps run, over
    every chunk, are left in ``modal_analysis.last_steps``."""
    n, d = pos.shape
    nd = n * d
    if 5 * k >= nd:
        raise ValueError(
            f"modal_analysis: 5*k={5 * k} must be < N*dim={nd} "
            "(LOBPCG blocking constraint) — reduce k or refine the mesh")
    kq = k + max(2, k // 2)
    while 5 * kq >= nd and kq > k:
        kq -= 1
    c_apply, kv, inv_sqrt_m, free, free_flat = _operator(obj, pos)
    v0, x = _start_vectors(seed, [(nd,), (nd, kq)], pos.dtype, pos.device)
    lam_max = _power_lam_max(c_apply, v0, 30) + 1.0
    eps = eps_rel * lam_max
    ff = free_flat[:, None]

    def op_block(y):
        return c_apply(y * ff) + lam_max * (y - y * ff) + eps * y

    def inv_block(y):
        return _block_cg(op_block, y, inner_iters)

    steps = m if chunk_m is None else min(chunk_m, m)
    done = 0
    total = 0
    theta = None
    while done < m:
        theta, x, its = lobpcg_standard(inv_block, x, min(steps, m - done),
                                        tol)
        done += steps
        total += its
    modal_analysis.last_steps = total
    lam = 1.0 / torch.clamp(theta, min=1e-30) - eps
    order = torch.argsort(lam)[:k]
    lam = lam[order]
    u = x[:, order]
    phi = u.reshape(n, d, k) * inv_sqrt_m[..., None] * free[..., None]
    res = _residuals(obj, kv, phi, lam, free)
    return _result(lam, phi.permute(2, 0, 1), res)


modal_analysis.last_steps = 0


def _residuals(obj, kv, phi, lam, free):
    """‖P·Kφᵢ − λᵢMφᵢ‖ / (‖P·Kφᵢ‖ + |λᵢ|‖Mφᵢ‖) of the (N, d, k) modes, one
    block product."""
    n, d, k = phi.shape
    k_p = kv(phi) * free[..., None]
    m_p = obj.mass[:, None, None] * phi
    num = torch.linalg.vector_norm((k_p - lam * m_p).reshape(n * d, k),
                                   dim=0)
    den = (torch.linalg.vector_norm(k_p.reshape(n * d, k), dim=0)
           + torch.abs(lam) * torch.linalg.vector_norm(
               m_p.reshape(n * d, k), dim=0))
    return num / (den + 1e-30)


def modal_analysis_chebyshev(
    obj: FemObject,
    pos: torch.Tensor,
    k: int = 6,
    rounds: int = 8,
    degree: int = 150,
    seed: int = 0,
    target_tol: float = 1e-3,
    x0_modes: Optional[torch.Tensor] = None,
) -> ModalResult:
    """Smallest-``k`` modes by Chebyshev-filtered subspace iteration (the
    JAX package's ``modal_analysis_chebyshev``): λmax from 40 power steps;
    each round the filter T_degree((2C − (a+b))/(b − a)) by the three-term
    recurrence with per-column rescaling, one QR, Rayleigh–Ritz on C and
    the cutoff ``a`` re-adapted from the Ritz values.  Converges when the
    k wanted residuals drop below ``target_tol`` (at least 3 rounds).

    Applies: 41 single-column, then 152 blocks a round at degree 150 (t₁,
    149 recurrence steps, C·Q and C·X) — each one H1 launch on a CUDA
    object.  The rounds run are left in
    ``modal_analysis_chebyshev.last_rounds``.  ``x0_modes`` (k₀, N, d)
    warm-starts the subspace from physical mode shapes (Y = M^{1/2}φ),
    padded with random columns.  All arithmetic follows ``pos.dtype``."""
    n, d = pos.shape
    nd = n * d
    if 2 * k >= nd:
        raise ValueError(
            f"modal_analysis_chebyshev: need 2*k < N*dim, got {2 * k} vs "
            f"{nd}")
    kq = min(k + max(2, k // 2), nd // 2)
    c_apply, kv, inv_sqrt_m, free, free_flat = _operator(obj, pos)
    ff = free_flat[:, None]
    v0, x = _start_vectors(seed, [(nd,), (nd, kq)], pos.dtype, pos.device)
    lam_max = _power_lam_max(c_apply, v0, 40) * 1.05 + 1.0
    if x0_modes is not None:
        k0 = min(x0_modes.shape[0], kq)
        y = (x0_modes[:k0].to(device=pos.device, dtype=pos.dtype)
             * torch.sqrt(obj.mass)[None, :, None]).reshape(k0, nd).T
        x = torch.cat([y, x[:, k0:]], dim=1)

    def cb(y):
        return c_apply(y * ff) + lam_max * (y - y * ff)

    a = 1e-4 * lam_max
    theta = res = None
    rounds_run = 0
    for r in range(rounds):
        b = lam_max
        e = (b - a) / 2.0
        c0 = (b + a) / 2.0
        tj = (cb(x) - c0 * x) / e
        tjm1 = x
        for _ in range(degree - 1):
            tnext = (cb(tj) - c0 * tj) * (2.0 / e) - tjm1
            s = 1.0 / (torch.amax(torch.abs(tnext), dim=0, keepdim=True)
                       + 1e-30)
            tj, tjm1 = tnext * s, tj * s
        q, _ = torch.linalg.qr(tj)
        h = q.T @ cb(q)
        h = 0.5 * (h + h.T)
        theta, s = torch.linalg.eigh(h)  # ascending
        x = q @ s
        cx = cb(x)
        res = torch.linalg.vector_norm(cx - theta[None, :] * x, dim=0) / \
            torch.clamp(torch.abs(theta), min=1e-7 * lam_max)
        a = torch.clamp(1.5 * theta[kq - 1], min=1e-6 * lam_max,
                        max=0.5 * lam_max)
        rounds_run = r + 1
        if r >= 2 and bool(torch.max(res[:k]) < target_tol):
            break
    modal_analysis_chebyshev.last_rounds = rounds_run
    theta_k = theta[:k]
    phi = x[:, :k].reshape(n, d, k) * inv_sqrt_m[..., None] * free[..., None]
    return _result(theta_k, phi.permute(2, 0, 1), res[:k])


modal_analysis_chebyshev.last_rounds = 0


def _to_f64(obj: FemObject, pos: torch.Tensor):
    """(obj, pos) in float64 on the object's device: the f32 values cast."""
    return to_dtype(obj, torch.float64), pos.to(torch.float64)


def modal_residuals_f64(obj: FemObject, pos: torch.Tensor,
                        result: ModalResult) -> ModalResult:
    """Direct f64 residuals of a modal solve: the mode shapes exactly as
    computed, cast to f64 with the mesh and ``pos``, re-evaluated in double
    on the object's device (one f64 block product, H1's double instance on
    the card): λᵢ = φᵢᵀKφᵢ/φᵢᵀMφᵢ and rᵢ = ‖P(Kφᵢ − λᵢMφᵢ)‖ / (‖Kφᵢ‖ +
    λᵢ‖Mφᵢ‖).  The JAX package runs this on the host CPU only because a TPU
    has no f64."""
    obj64, pos64 = _to_f64(obj, pos)
    phi = result.modes.to(device=pos.device, dtype=torch.float64)
    k, n, d = phi.shape
    kv = make_stiffness_hvp(obj64, pos64)
    mass = obj64.mass[:, None, None]
    free = obj64.free_mask
    p = phi.permute(1, 2, 0)  # (N, d, k)
    if free is not None:
        p = free[..., None] * p
    k_phi = kv(p.contiguous())
    if free is not None:
        k_phi = free[..., None] * k_phi
    m_phi = mass * p
    lam = torch.sum(p * k_phi, dim=(0, 1)) / torch.sum(p * m_phi, dim=(0, 1))
    r = k_phi - lam * m_phi
    nrm = torch.linalg.vector_norm(r.reshape(n * d, k), dim=0) / (
        torch.linalg.vector_norm(k_phi.reshape(n * d, k), dim=0)
        + torch.abs(lam) * torch.linalg.vector_norm(m_phi.reshape(n * d, k),
                                                    dim=0))
    return _result(lam, phi, nrm)


def modal_refine_f64(
    obj: FemObject,
    pos: torch.Tensor,
    result: Optional[ModalResult] = None,
    k: int = 6,
    rounds: int = 2,
    degree: int = 120,
    seed: int = 0,
    target_tol: float = 1e-10,
) -> ModalResult:
    """Float64 refinement of an f32 modal solve: :func:`
    modal_analysis_chebyshev` in double precision on the object's device
    (H1's double instance on the card), seeded with the f32 mode shapes of
    ``result`` (None: a random start).  The JAX package runs it on the host
    CPU only because a TPU has no f64.  Returns f64 tensors."""
    obj64, pos64 = _to_f64(obj, pos)
    x0 = (None if result is None
          else result.modes.to(device=pos.device, dtype=torch.float64))
    return modal_analysis_chebyshev(obj64, pos64, k=k, rounds=rounds,
                                    degree=degree, seed=seed,
                                    target_tol=target_tol, x0_modes=x0)


def modal_analysis_sparse_f64(obj: FemObject, pos: torch.Tensor,
                              k: int = 6) -> ModalResult:
    """Direct f64 sparse shift-invert modal solve, the oracle at any
    conditioning: exact f64 element Hessians (``riks.make_element_hessian_fn``)
    formed on the object's device in float64 and copied to the host, sparse
    assembly on the free DOFs and scipy's ARPACK generalized shift-invert
    (``eigsh``, σ at or just below the spectrum's bottom) on the host, as in
    the JAX package.  Returns f64 tensors on the object's device."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from fem_tpu_torch.solvers.riks import make_element_hessian_fn

    d = int(pos.shape[-1])
    n = int(obj.particle_cnt)
    obj64, pos64 = _to_f64(obj, pos)
    h = make_element_hessian_fn(obj64)(pos64).cpu().numpy()  # (E, m, m)
    elem = obj.element_indices.cpu().numpy().astype(np.int64)
    m = (d + 1) * d
    gdof = (elem[:, :, None] * d + np.arange(d)[None, None, :]).reshape(-1, m)
    rows = np.repeat(gdof, m, axis=1).ravel()
    cols = np.tile(gdof, (1, m)).ravel()
    k_full = sp.coo_matrix((h.ravel(), (rows, cols)),
                           shape=(n * d, n * d)).tocsr()
    mass = np.repeat(obj.mass.cpu().numpy().astype(np.float64), d)
    free = (np.repeat(obj.free_mask.cpu().numpy()[:, 0].astype(bool), d)
            if obj.free_mask is not None else np.ones(n * d, bool))
    kf = k_full[free][:, free]
    mf = mass[free]
    m_op = sp.diags(mf).tocsc()
    sigma = 0.0 if obj.free_mask is not None else -1e-3
    w, v = spla.eigsh(kf, k=k, M=m_op, sigma=sigma, which="LM")
    order = np.argsort(w)
    w, v = w[order], v[:, order]
    kv = kf @ v
    mv = mf[:, None] * v
    resid = np.linalg.norm(kv - w[None, :] * mv, axis=0) / (
        np.linalg.norm(kv, axis=0) + np.abs(w) * np.linalg.norm(mv, axis=0))
    modes = np.zeros((k, n * d))
    modes[:, free] = v.T
    nrm = np.sqrt(np.einsum("ki,i,ki->k", modes, mass, modes))
    modes = modes / nrm[:, None]

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=pos.device)

    return ModalResult(
        omega_sq=dev(w),
        frequencies=dev(np.sqrt(np.maximum(w, 0.0)) / (2 * np.pi)),
        modes=dev(modes.reshape(k, n, d)), residuals=dev(resid))
