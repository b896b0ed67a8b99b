# coding=utf-8
"""Batched Neo-Hookean element math (plain PyTorch).

The port of the JAX package's ``ops/element.py`` subset the reference
substeps need.  On the implicit path each element contributes one d×d block
``K_e`` in a graph-Laplacian pattern (the reference's decoupled Hessian,
solver/implicit.py:131-147) and one set of rhs force columns
(solver/implicit.py:87-88); on the explicit path one set of energy-gradient
columns (solver/explicit.py:23-49), and on the autodiff path the energy
itself (solver/explicit_auto_diff.py:24-30).

The formulas follow the Pallas element chain ``k_and_h_chain`` of the JAX
package term for term — the chain the CUDA element kernel ports — including
its two logarithms: ``K`` uses the clamped ``log(max(det F, 1e-4))`` and the
rhs uses ``log(det F · det F)``, which stays finite for inverted elements.
The explicit chain ``grad_cols_chain`` follows the Pallas chain of the same
name and uses the unclamped ``log(det F)``: an inverted element gives NaN,
as in the reference.  The two agree only where det F > 0, and only to
rounding, so neither stands in for the other.

Both chains also take ``material="stable_neo_hookean"``, the material of
the inelastic extension's Maxwell branch (ops/inelastic.py; as a base
material it is not ported, ROADMAP M11): the planar chains of the JAX
package's ``_material_p_dp_chain`` (its ops/pallas_kernels.py:123-155,
:247-259), with k = DP(F)[R⁻¹]·R⁻ᵀ — R⁻¹ as the direction, as the reference
quirk of the Neo-Hookean K has it — and h = P(F)·R⁻ᵀ.
"""

from __future__ import annotations

import torch

from fem_tpu_torch.ops import smallmat as sm
from fem_tpu_torch.ops.assembly import gather_edge_diffs


def deformation_gradients(
    pos: torch.Tensor, element_indices: torch.Tensor, ref_inv: torch.Tensor
) -> torch.Tensor:
    """F = X @ R_inv for all elements: ``(E, d, d)`` (solver/explicit.py:12-19)."""
    return sm.matmul(gather_edge_diffs(pos, element_indices), ref_inv)


MATERIALS = ("neo_hookean", "stable_neo_hookean")
# The kernels' material selector (csrc/element_chain.cuh: Material).
MATERIAL_IDS = {"neo_hookean": 0, "stable_neo_hookean": 1}


def check_material(material: str) -> None:
    if material not in MATERIALS:
        raise NotImplementedError(
            f"material {material!r}: only neo_hookean (and stable_neo_hookean "
            "as the Maxwell branch layer) is ported (ROADMAP M11)"
        )


def _cof2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The symmetrized bilinear 3×3 cofactor form (the JAX package's
    ``_planar_cof2``): cof2(m, m) = 2·cof(m), cof2(m, d) = Dcof(m)[d]."""
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


def _cof(m: torch.Tensor) -> torch.Tensor:
    if m.shape[-1] == 2:
        return torch.stack([torch.stack([m[..., 1, 1], -m[..., 1, 0]], -1),
                            torch.stack([-m[..., 0, 1], m[..., 0, 0]], -1)],
                           dim=-2)
    return 0.5 * _cof2(m, m)


def _dcof(m: torch.Tensor, d_dir: torch.Tensor) -> torch.Tensor:
    return _cof(d_dir) if m.shape[-1] == 2 else _cof2(m, d_dir)


def stable_nh_p_dp(f: torch.Tensor, d_dir, mu: float, lam: float):
    """Stable Neo-Hookean (P(F), DP(F)[D]) with λ' = λ + μ:
    P = μF + (λ'(J − 1) − μ)·cof F,
    DP[D] = μD + λ'(cof F : D)·cof F + (λ'(J − 1) − μ)·Dcof(F)[D].
    ``d_dir`` None skips DP."""
    lam_p = lam + mu
    g = _cof(f)
    s = (lam_p * (sm.det(f) - 1.0) - mu)[..., None, None]
    p = mu * f + s * g
    if d_dir is None:
        return p, None
    d2 = f.shape[-1] ** 2
    gf, df = g.reshape(*g.shape[:-2], d2), d_dir.reshape(*g.shape[:-2], d2)
    dj = gf[..., 0] * df[..., 0]
    for i in range(1, d2):
        dj = dj + gf[..., i] * df[..., i]
    dp = mu * d_dir + lam_p * dj[..., None, None] * g + s * _dcof(f, d_dir)
    return p, dp


def k_and_h_chain(f: torch.Tensor, r: torch.Tensor, mu: float, lam: float,
                  material: str = "neo_hookean"):
    """Unscaled (K_e, rhs column) chain from deformation gradients ``f`` and
    rest-edge inverses ``r``, both ``(E, d, d)``; callers apply ``−V``.

    K = [μR⁻¹ + (μ − λ·log max(det F, 1e-4))·F⁻ᵀR⁻ᵀF⁻ᵀ + λ·tr(F⁻¹R⁻¹)·F⁻ᵀ]·R⁻ᵀ
    h = [μF + (λ/2·log(det F²) − μ)·F⁻ᵀ]·R⁻ᵀ

    Stable Neo-Hookean: K = DP(F)[R⁻¹]·R⁻ᵀ, h = P(F)·R⁻ᵀ.
    """
    if material == "stable_neo_hookean":
        p, dp = stable_nh_p_dp(f, r, mu, lam)
        r_t = sm.mT(r)
        return sm.matmul(dp, r_t), sm.matmul(p, r_t)
    det_f = sm.det(f)
    f_inv = sm.inv(f, det_f)
    f_inv_t = sm.mT(f_inv)
    r_t = sm.mT(r)
    log_j = torch.log(torch.clamp(det_f, min=1e-4))[..., None, None]
    term2 = sm.matmul(sm.matmul(f_inv_t, r_t), f_inv_t)
    tr = sm.trace(sm.matmul(f_inv, r))[..., None, None]
    blk = mu * r + (mu - lam * log_j) * term2 + (lam * tr) * f_inv_t
    k = sm.matmul(blk, r_t)
    log_gram = torch.log(det_f * det_f)[..., None, None]
    p = mu * f + (lam / 2.0 * log_gram - mu) * f_inv_t
    h = sm.matmul(p, r_t)
    return k, h


def hessian_blocks(
    pos: torch.Tensor,
    element_indices: torch.Tensor,
    ref_inv: torch.Tensor,
    volume: torch.Tensor,
    mu: float,
    s_lambda: float,
) -> torch.Tensor:
    """The per-element implicit system block ``K_e``: ``(E, d, d)``."""
    f = deformation_gradients(pos, element_indices, ref_inv)
    k, _ = k_and_h_chain(f, ref_inv, mu, s_lambda)
    return -volume[:, None, None] * k


def implicit_force_columns(
    pos: torch.Tensor,
    element_indices: torch.Tensor,
    ref_inv: torch.Tensor,
    volume: torch.Tensor,
    mu: float,
    s_lambda: float,
) -> torch.Tensor:
    """Elastic force columns for the implicit rhs b: ``(E, d, d)``."""
    f = deformation_gradients(pos, element_indices, ref_inv)
    _, h = k_and_h_chain(f, ref_inv, mu, s_lambda)
    return -volume[:, None, None] * h


def grad_cols_chain(f: torch.Tensor, r: torch.Tensor, mu: float, lam: float,
                    material: str = "neo_hookean"):
    """Unscaled explicit gradient columns from deformation gradients ``f``
    and rest-edge inverses ``r``, both ``(E, d, d)``; callers apply ``+V``.

    P = μF + (λ·log det F − μ)·F⁻ᵀ,  h = P·R⁻ᵀ, with the log unclamped;
    stable Neo-Hookean: its P, h = P·R⁻ᵀ.
    """
    if material == "stable_neo_hookean":
        return sm.matmul(stable_nh_p_dp(f, None, mu, lam)[0], sm.mT(r))
    det_f = sm.det(f)
    f_inv_t = sm.mT(sm.inv(f, det_f))
    log_j = torch.log(det_f)[..., None, None]
    p = mu * f + (lam * log_j - mu) * f_inv_t
    return sm.matmul(p, sm.mT(r))


def explicit_grad_columns(
    pos: torch.Tensor,
    element_indices: torch.Tensor,
    ref_inv: torch.Tensor,
    volume: torch.Tensor,
    mu: float,
    s_lambda: float,
    material: str = "neo_hookean",
) -> torch.Tensor:
    """Energy-gradient columns of the explicit path, ``(E, d, d)``: column j
    goes to local vertex j+1 and −Σ_j to vertex 0.  They are +∂U/∂x
    contributions (the reference subtracts the gradient in its kinematic
    step, solver/kinematic.py:19)."""
    f = deformation_gradients(pos, element_indices, ref_inv)
    return volume[:, None, None] * grad_cols_chain(f, ref_inv, mu, s_lambda,
                                                   material)


def energy_density(f: torch.Tensor, mu: float, s_lambda: float,
                   material: str = "neo_hookean") -> torch.Tensor:
    """Neo-Hookean φ(F) = μ/2·(tr FᵀF − d) − μ·logJ + λ/2·logJ², logJ =
    log det F unclamped (solver/explicit_auto_diff.py:24-28); stable
    Neo-Hookean φ = μ/2·(tr FᵀF − d) − μ(J − 1) + λ'/2·(J − 1)², λ' = λ + μ."""
    d = f.shape[-1]
    if material == "stable_neo_hookean":
        j = sm.det(f)
        i_c = (f * f).sum(dim=(-2, -1))
        lam_p = s_lambda + mu
        return (mu / 2.0 * (i_c - d) - mu * (j - 1.0)
                + lam_p / 2.0 * (j - 1.0) * (j - 1.0))
    log_j = torch.log(sm.det(f))
    i_c = (f * f).sum(dim=(-2, -1))
    return mu / 2.0 * (i_c - d) - mu * log_j + s_lambda / 2.0 * log_j * log_j


def element_energies(
    pos: torch.Tensor,
    element_indices: torch.Tensor,
    ref_inv: torch.Tensor,
    volume: torch.Tensor,
    mu: float,
    s_lambda: float,
) -> torch.Tensor:
    """Per-element V·φ, ``(E,)``."""
    f = deformation_gradients(pos, element_indices, ref_inv)
    return volume * energy_density(f, mu, s_lambda)


def total_energy(
    pos: torch.Tensor,
    element_indices: torch.Tensor,
    ref_inv: torch.Tensor,
    volume: torch.Tensor,
    mu: float,
    s_lambda: float,
) -> torch.Tensor:
    """U = Σ_e V_e·φ(F_e), the autodiff loss (a 0-d tensor)."""
    return element_energies(
        pos, element_indices, ref_inv, volume, mu, s_lambda
    ).sum()
