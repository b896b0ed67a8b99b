# coding=utf-8
"""Batched element math of every material (plain PyTorch).

The port of the JAX package's ``ops/element.py``.  On the implicit path each
element contributes one d×d block ``K_e`` in a graph-Laplacian pattern (the
reference's decoupled Hessian, solver/implicit.py:131-147) and one set of rhs
force columns (solver/implicit.py:87-88); on the explicit path one set of
energy-gradient columns (solver/explicit.py:23-49), and on the autodiff path
the energy itself (solver/explicit_auto_diff.py:24-30).

Materials (``material``): the reference's ``neo_hookean``, and the JAX
package's extensions ``stvk``, ``linear``, ``corotated`` (R from 12 Higham
iterations, ``smallmat.polar_rotation``), ``stable_neo_hookean``,
``mooney_rivlin[:β]`` and ``fiber:a1,a2[,a3][:κ]`` (a stable Neo-Hookean base
plus k/2·(I₄ − 1)²).  :func:`energy_density`, :func:`first_piola` and
:func:`first_piola_dp` are the JAX functions of those names;
:func:`material_p_dp` computes P and DP in the order of the Pallas chains'
``_material_p_dp_chain`` (its ops/pallas_kernels.py:158-300), which the CUDA
chains (csrc/element_chain.cuh) follow.

The Neo-Hookean chains follow the Pallas chain ``k_and_h_chain`` term for
term, including its two logarithms: ``K`` uses the clamped
``log(max(det F, 1e-4))`` and the rhs uses ``log(det F · det F)``, which
stays finite for inverted elements.  The explicit chain ``grad_cols_chain``
uses the unclamped ``log(det F)``: an inverted element gives NaN, as in the
reference.  ``robust`` (the ``robust_inversion`` extension) clamps |det F| ≥
1e-6, sign kept, inside F⁻¹ and det F² ≥ 1e-8 in the rhs log; in the chains
it acts on Neo-Hookean only, as the Pallas chain's does.  The other
materials' chains are k = DP(F)[R⁻¹]·R⁻ᵀ — R⁻¹ as the direction, the
reference quirk of the Neo-Hookean K — and h = P(F)·R⁻ᵀ.  Where the JAX
package's XLA function applies ``robust`` to another material
(``first_piola_dp`` of Mooney-Rivlin, its element.py:522) the plain function
here does too; its Pallas chain does not (ROADMAP F5).
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


MATERIALS = ("neo_hookean", "stable_neo_hookean", "stvk", "linear",
             "corotated", "mooney_rivlin", "fiber")
# The kernels' material selector (csrc/element_chain.cuh: Material), by base
# name; Neo-Hookean under ``robust`` is an instance of its own.
MATERIAL_IDS = {name: i for i, name in enumerate(MATERIALS)}
ROBUST_NEO_HOOKEAN_ID = len(MATERIALS)
_PARAMETERISED = ("mooney_rivlin", "fiber")


def material_base(material: str) -> str:
    """``mooney_rivlin:0.3`` → ``mooney_rivlin``; other names unchanged."""
    return material.partition(":")[0]


def check_material(material: str) -> None:
    """Raise ``ValueError`` for a material name the JAX package does not
    know (the parameters of ``mooney_rivlin`` and ``fiber`` are checked
    where they are parsed, :func:`mooney_params` and :func:`fiber_params`)."""
    base = material_base(material)
    if base not in MATERIALS or (base not in _PARAMETERISED
                                 and material != base):
        raise ValueError(f"unknown material {material!r}")


def kernel_material_id(material: str, robust: bool = False) -> int:
    """The kernels' instance of ``material``: robust Neo-Hookean has its own;
    ``robust`` leaves every other material's chain unchanged."""
    check_material(material)
    base = material_base(material)
    if robust and base == "neo_hookean":
        return ROBUST_NEO_HOOKEAN_ID
    return MATERIAL_IDS[base]


def mooney_params(mu: float, s_lambda: float, d: int, material: str) -> tuple:
    """(C1, C2, λ_log) of ``mooney_rivlin[:β]`` (β ∈ [0, 1), default 0.5):
    C2 = β·μ/2, C1 = μ/2 − (d − 2)·C2, λ_log = λ − 4·C2, so that DP(I) is
    linear elasticity with (μ, λ).  Raises ``ValueError`` for β out of range
    or λ_log < 0 or C1 ≤ 0, as the JAX package's ``mooney_params`` does.
    With a tensor μ or λ (a differentiable rollout's parameters) the
    calibration is not checked here, which would read it back to the host:
    the caller checks it once on the object's floats."""
    base, _, arg = material.partition(":")
    assert base == "mooney_rivlin"
    beta = float(arg) if arg else 0.5
    if not 0.0 <= beta < 1.0:
        raise ValueError(f"mooney_rivlin beta must be in [0, 1): {material!r}")
    c2 = beta * mu / 2.0
    c1 = mu / 2.0 - (d - 2) * c2
    lam_log = s_lambda - 4.0 * c2
    if torch.is_tensor(lam_log) or torch.is_tensor(c1):
        return c1, c2, lam_log
    if lam_log < 0.0 or c1 <= 0.0:
        raise ValueError(
            f"mooney_rivlin calibration infeasible for {material!r}: "
            f"needs lambda >= 4*C2 (= 2*beta*mu) and C1 > 0; got "
            f"mu={mu}, lambda={s_lambda}, d={d} -> C1={c1}, "
            f"lam_log={lam_log}. Lower beta or raise poisson_ratio."
        )
    return c1, c2, lam_log


def fiber_params(mu: float, d: int, material: str) -> tuple:
    """(unit fiber direction a (d floats), k = κ·μ) of
    ``fiber:a1,a2[,a3][:κ]`` (κ default 1).  Raises ``ValueError`` for a
    direction of another length than d, a zero direction or κ ≤ 0, as the
    JAX package's ``fiber_params`` does."""
    base, _, rest = material.partition(":")
    assert base == "fiber"
    dir_str, _, kap_str = rest.partition(":")
    comps = tuple(float(x) for x in dir_str.split(",") if x != "")
    if len(comps) != d:
        raise ValueError(
            f"fiber direction has {len(comps)} components for dim={d}: "
            f"{material!r}"
        )
    norm = sum(x * x for x in comps) ** 0.5
    if norm == 0.0:
        raise ValueError(f"fiber direction must be nonzero: {material!r}")
    kappa = float(kap_str) if kap_str else 1.0
    if kappa <= 0.0:
        raise ValueError(f"fiber kappa must be > 0: {material!r}")
    return tuple(x / norm for x in comps), kappa * mu


def material_constants(material: str, mu: float, lam: float, d: int) -> dict:
    """The numbers a kernel's chain of ``material`` closes over, computed
    here in float64 as the Pallas chains compute their Python floats (each
    is rounded once to f32 where it enters the kernel): the fields of
    ``MaterialParams`` (csrc/element_chain.cuh)."""
    check_material(material)
    c = dict(mu=mu, lam=lam, half_lam=lam / 2.0, lam_p=lam + mu,
             two_mu=2.0 * mu, c1x2=0.0, c2x2=0.0, lam_log=0.0, k_log=0.0,
             a0=0.0, a1=0.0, a2=0.0, two_k=0.0)
    base = material_base(material)
    if base == "mooney_rivlin":
        c1, c2, lam_log = mooney_params(mu, lam, d, material)
        c.update(c1x2=2.0 * c1, c2x2=2.0 * c2, lam_log=lam_log,
                 k_log=2.0 * c1 + 2.0 * (d - 1) * c2)
    elif base == "fiber":
        a, k = fiber_params(mu, d, material)
        c.update(two_k=2.0 * k, **{f"a{i}": v for i, v in enumerate(a)})
    return c


def _sum_entries(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ_ij a_ij·b_ij over the last two axes, entries in row-major order."""
    d2 = a.shape[-1] * a.shape[-2]
    af = a.reshape(*a.shape[:-2], d2)
    bf = b.reshape(*b.shape[:-2], d2)
    s = af[..., 0] * bf[..., 0]
    for i in range(1, d2):
        s = s + af[..., i] * bf[..., i]
    return s


def _eye_like(f: torch.Tensor) -> torch.Tensor:
    return torch.eye(f.shape[-1], dtype=f.dtype, device=f.device).expand_as(f)


def stable_nh_p_dp(f: torch.Tensor, d_dir, mu: float, lam: float):
    """Stable Neo-Hookean (P(F), DP(F)[D]) with λ' = λ + μ:
    P = μF + (λ'(J − 1) − μ)·cof F,
    DP[D] = μD + λ'(cof F : D)·cof F + (λ'(J − 1) − μ)·Dcof(F)[D].
    ``d_dir`` None skips DP."""
    lam_p = lam + mu
    g = sm.cofactor(f)
    s = (lam_p * (sm.det(f) - 1.0) - mu)[..., None, None]
    p = mu * f + s * g
    if d_dir is None:
        return p, None
    dj = _sum_entries(g, d_dir)
    dp = mu * d_dir + lam_p * dj[..., None, None] * g + s * sm.d_cofactor(f, d_dir)
    return p, dp


def _fiber_vec(m: torch.Tensor, a) -> list:
    """(M a)_i = Σ_j a_j·M_ij, j in order, as d tensors."""
    d = m.shape[-1]
    out = []
    for i in range(d):
        s = a[0] * m[..., i, 0]
        for j in range(1, d):
            s = s + a[j] * m[..., i, j]
        out.append(s)
    return out


def _outer_a(vec: list, a, scale) -> torch.Tensor:
    """(scale·v_i)·a_j as a (…, d, d) tensor."""
    d = len(vec)
    return torch.stack([torch.stack([(scale * vec[i]) * a[j]
                                     for j in range(d)], -1)
                        for i in range(d)], -2)


def material_p_dp(f: torch.Tensor, d_dir, mu: float, lam: float,
                  material: str, robust: bool = False):
    """(P(F), DP(F)[D]) of ``material``, every material but Neo-Hookean, in
    the order of the Pallas chains' ``_material_p_dp_chain``: stvk and
    linear exact, corotated with R held fixed in DP, stable Neo-Hookean and
    fiber exact polynomials, Mooney-Rivlin with P's log unclamped and DP's
    clamped at det F ≥ 1e-4.  ``d_dir`` None skips DP.  ``robust`` takes
    Mooney-Rivlin's F⁻¹ in DP through ``safe_inv``, as the JAX package's
    ``first_piola_dp`` does (its Pallas chain does not, ROADMAP F5)."""
    d = f.shape[-1]
    base = material_base(material)
    check_material(material)
    eye = _eye_like(f)
    if base == "stable_neo_hookean":
        return stable_nh_p_dp(f, d_dir, mu, lam)
    if base == "fiber":
        a, k = fiber_params(mu, d, material)
        p0, dp0 = stable_nh_p_dp(f, d_dir, mu, lam)
        fa = _fiber_vec(f, a)
        i4 = fa[0] * fa[0]
        for i in range(1, d):
            i4 = i4 + fa[i] * fa[i]
        p = p0 + _outer_a(fa, a, 2.0 * k * (i4 - 1.0))
        if d_dir is None:
            return p, None
        da = _fiber_vec(d_dir, a)
        w_dot = fa[0] * da[0]
        for i in range(1, d):
            w_dot = w_dot + fa[i] * da[i]
        vec = [2.0 * w_dot * fa[i] + (i4 - 1.0) * da[i] for i in range(d)]
        return p, dp0 + _outer_a(vec, a, 2.0 * k)
    if base == "mooney_rivlin":
        c1, c2, lam_log = mooney_params(mu, lam, d, material)
        k_log = 2.0 * c1 + 2.0 * (d - 1) * c2
        c = sm.gram(f)
        i1 = sm.trace(c)[..., None, None]
        det_f = sm.det(f)
        f_inv = sm.inv(f, det_f)
        f_inv_t = sm.mT(f_inv)
        coef_p = (lam_log * torch.log(det_f) - k_log)[..., None, None]
        p = (2.0 * c1 * f + 2.0 * c2 * (i1 * f - sm.matmul(f, c))
             + coef_p * f_inv_t)
        if d_dir is None:
            return p, None
        if robust:
            f_inv = sm.safe_inv(f)
            f_inv_t = sm.mT(f_inv)
        fd = _sum_entries(f, d_dir)[..., None, None]
        dtf = sm.matmul(sm.mT(d_dir), f)
        dc = dtf + sm.mT(dtf)
        inv_term = sm.matmul(sm.matmul(f_inv_t, sm.mT(d_dir)), f_inv_t)
        tr_fid = sm.trace(sm.matmul(f_inv, d_dir))[..., None, None]
        log_j_cl = torch.log(torch.clamp(det_f, min=1e-4))[..., None, None]
        coef = k_log - lam_log * log_j_cl
        dp = (2.0 * c1 * d_dir
              + 2.0 * c2 * (2.0 * fd * f + i1 * d_dir - sm.matmul(d_dir, c)
                            - sm.matmul(f, dc))
              + coef * inv_term + lam_log * tr_fid * f_inv_t)
        return p, dp
    if base == "corotated":
        rot = sm.polar_rotation(f)
        rot_t = sm.mT(rot)
        s_tr = (sm.trace(sm.matmul(rot_t, f)) - float(d))[..., None, None]
        p = 2.0 * mu * (f - rot) + lam * s_tr * rot
        if d_dir is None:
            return p, None
        tr_rd = sm.trace(sm.matmul(rot_t, d_dir))[..., None, None]
        return p, 2.0 * mu * d_dir + lam * tr_rd * rot
    if base == "linear":
        eps = 0.5 * (f + sm.mT(f)) - eye
        p = 2.0 * mu * eps + lam * sm.trace(eps)[..., None, None] * eye
        if d_dir is None:
            return p, None
        return p, (mu * (d_dir + sm.mT(d_dir))
                   + lam * sm.trace(d_dir)[..., None, None] * eye)
    if base == "stvk":
        g = 0.5 * (sm.gram(f) - eye)
        s = 2.0 * mu * g + lam * sm.trace(g)[..., None, None] * eye
        p = sm.matmul(f, s)
        if d_dir is None:
            return p, None
        dtf = sm.matmul(sm.mT(d_dir), f)
        ds = mu * (dtf + sm.mT(dtf)) + lam * sm.trace(dtf)[..., None, None] * eye
        return p, sm.matmul(d_dir, s) + sm.matmul(f, ds)
    raise ValueError(f"material {material!r} has no P/DP chain here")


def first_piola(f: torch.Tensor, mu: float, s_lambda: float,
                material: str = "neo_hookean") -> torch.Tensor:
    """P(F) = ∂φ/∂F of ``material`` (Neo-Hookean: μF − μF⁻ᵀ + λ·log(det F)
    ·F⁻ᵀ, the log unclamped)."""
    check_material(material)
    if material == "neo_hookean":
        f_inv_t = sm.mT(sm.inv(f))
        log_j = torch.log(sm.det(f))[..., None, None]
        return mu * f - mu * f_inv_t + s_lambda * log_j * f_inv_t
    return material_p_dp(f, None, mu, s_lambda, material)[0]


def first_piola_dp(f: torch.Tensor, d_dir: torch.Tensor, mu: float,
                   s_lambda: float, material: str = "neo_hookean",
                   robust: bool = False) -> torch.Tensor:
    """DP(F)[D] of ``material`` (Neo-Hookean: μD + (μ − λ·log max(det F,
    1e-4))·F⁻ᵀDᵀF⁻ᵀ + λ·tr(F⁻¹D)·F⁻ᵀ, F⁻¹ through ``safe_inv`` when
    ``robust``), summed in the order of the chain :func:`k_and_h_chain`."""
    check_material(material)
    if material != "neo_hookean":
        return material_p_dp(f, d_dir, mu, s_lambda, material, robust)[1]
    f_inv = sm.safe_inv(f) if robust else sm.inv(f)
    f_inv_t = sm.mT(f_inv)
    log_j = torch.log(torch.clamp(sm.det(f), min=1e-4))[..., None, None]
    term2 = sm.matmul(sm.matmul(f_inv_t, sm.mT(d_dir)), f_inv_t)
    tr = sm.trace(sm.matmul(f_inv, d_dir))[..., None, None]
    return mu * d_dir + (mu - s_lambda * log_j) * term2 + (s_lambda * tr) * f_inv_t


def k_and_h_chain(f: torch.Tensor, r: torch.Tensor, mu: float, lam: float,
                  material: str = "neo_hookean", robust: bool = False):
    """Unscaled (K_e, rhs column) chain from deformation gradients ``f`` and
    rest-edge inverses ``r``, both ``(E, d, d)``; callers apply ``−V``.

    K = [μR⁻¹ + (μ − λ·log max(det F, 1e-4))·F⁻ᵀR⁻ᵀF⁻ᵀ + λ·tr(F⁻¹R⁻¹)·F⁻ᵀ]·R⁻ᵀ
    h = [μF + (λ/2·log(det F²) − μ)·F⁻ᵀ]·R⁻ᵀ

    ``robust``: |det F| ≥ 1e-6 (sign kept) in F⁻¹, det F² ≥ 1e-8 in the log.
    Other materials: K = DP(F)[R⁻¹]·R⁻ᵀ, h = P(F)·R⁻ᵀ (``robust`` unused,
    as in the Pallas chain).
    """
    check_material(material)
    r_t = sm.mT(r)
    if material != "neo_hookean":
        p, dp = material_p_dp(f, r, mu, lam, material)
        return sm.matmul(dp, r_t), sm.matmul(p, r_t)
    det_f = sm.det(f)
    if robust:
        det_inv = torch.where(det_f < 0, -1.0, 1.0).to(f.dtype) * torch.clamp(
            det_f.abs(), min=1e-6)
    else:
        det_inv = det_f
    f_inv = sm.inv(f, det_inv)
    f_inv_t = sm.mT(f_inv)
    log_j = torch.log(torch.clamp(det_f, min=1e-4))[..., None, None]
    term2 = sm.matmul(sm.matmul(f_inv_t, r_t), f_inv_t)
    tr = sm.trace(sm.matmul(f_inv, r))[..., None, None]
    blk = mu * r + (mu - lam * log_j) * term2 + (lam * tr) * f_inv_t
    k = sm.matmul(blk, r_t)
    gram = det_f * det_f
    if robust:
        gram = torch.clamp(gram, min=1e-8)
    p = mu * f + (lam / 2.0 * torch.log(gram)[..., None, None] - mu) * f_inv_t
    return k, sm.matmul(p, r_t)


def hessian_blocks(
    pos: torch.Tensor,
    element_indices: torch.Tensor,
    ref_inv: torch.Tensor,
    volume: torch.Tensor,
    mu: float,
    s_lambda: float,
    robust: bool = False,
    material: str = "neo_hookean",
) -> torch.Tensor:
    """The per-element implicit system block ``K_e`` = −V·DP(F)[R⁻¹]·R⁻ᵀ:
    ``(E, d, d)``."""
    f = deformation_gradients(pos, element_indices, ref_inv)
    dp = first_piola_dp(f, ref_inv, mu, s_lambda, material, robust)
    return -volume[:, None, None] * sm.matmul(dp, sm.mT(ref_inv))


def implicit_force_columns(
    pos: torch.Tensor,
    element_indices: torch.Tensor,
    ref_inv: torch.Tensor,
    volume: torch.Tensor,
    mu: float,
    s_lambda: float,
    robust: bool = False,
) -> torch.Tensor:
    """Neo-Hookean force columns for the implicit rhs b: ``(E, d, d)``, with
    the λ/2·log(det F²) form (finite for inverted elements)."""
    f = deformation_gradients(pos, element_indices, ref_inv)
    _, h = k_and_h_chain(f, ref_inv, mu, s_lambda, robust=robust)
    return -volume[:, None, None] * h


def grad_cols_chain(f: torch.Tensor, r: torch.Tensor, mu: float, lam: float,
                    material: str = "neo_hookean"):
    """Unscaled explicit gradient columns from deformation gradients ``f``
    and rest-edge inverses ``r``, both ``(E, d, d)``; callers apply ``+V``.

    Neo-Hookean: P = μF + (λ·log det F − μ)·F⁻ᵀ, the log unclamped; other
    materials their P; h = P·R⁻ᵀ.
    """
    check_material(material)
    if material != "neo_hookean":
        return sm.matmul(material_p_dp(f, None, mu, lam, material)[0],
                         sm.mT(r))
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
    """φ(F) of ``material`` (the JAX package's ``energy_density``):
    Neo-Hookean μ/2·(tr FᵀF − d) − μ·logJ + λ/2·logJ², logJ = log det F
    unclamped; stable Neo-Hookean μ/2·(tr FᵀF − d) − μ(J − 1) +
    λ'/2·(J − 1)², λ' = λ + μ; corotated μ‖F − R‖² + λ/2·tr(RᵀF − I)²;
    linear μ‖ε‖² + λ/2·tr(ε)²; stvk μ‖G‖² + λ/2·tr(G)²; fiber the stable
    Neo-Hookean base + k/2·(I₄ − 1)²; Mooney-Rivlin C1(I₁ − d) +
    C2(I₂ − d(d − 1)/2) − (2C1 + 2(d − 1)C2)·logJ + λ_log/2·logJ²."""
    check_material(material)
    d = f.shape[-1]
    base = material_base(material)
    eye = _eye_like(f)
    if base == "stable_neo_hookean":
        j = sm.det(f)
        lam_p = s_lambda + mu
        return (mu / 2.0 * ((f * f).sum(dim=(-2, -1)) - d) - mu * (j - 1.0)
                + lam_p / 2.0 * (j - 1.0) * (j - 1.0))
    if base == "corotated":
        r = sm.polar_rotation(f)
        diff = f - r
        s_tr = sm.trace(sm.matmul(sm.mT(r), f)) - d
        return (mu * (diff * diff).sum(dim=(-2, -1))
                + s_lambda / 2.0 * s_tr * s_tr)
    if base in ("linear", "stvk"):
        g = (0.5 * (f + sm.mT(f)) - eye if base == "linear"
             else 0.5 * (sm.gram(f) - eye))
        tr = sm.trace(g)
        return mu * (g * g).sum(dim=(-2, -1)) + s_lambda / 2.0 * tr * tr
    if base == "fiber":
        a, k = fiber_params(mu, d, material)
        fa = _fiber_vec(f, a)
        i4 = fa[0] * fa[0]
        for i in range(1, d):
            i4 = i4 + fa[i] * fa[i]
        return (energy_density(f, mu, s_lambda, "stable_neo_hookean")
                + 0.5 * k * (i4 - 1.0) * (i4 - 1.0))
    if base == "mooney_rivlin":
        c1, c2, lam_log = mooney_params(mu, s_lambda, d, material)
        c = sm.gram(f)
        i1 = sm.trace(c)
        i2 = 0.5 * (i1 * i1 - (c * c).sum(dim=(-2, -1)))
        log_j = torch.log(sm.det(f))
        return (c1 * (i1 - d) + c2 * (i2 - d * (d - 1) / 2.0)
                - (2.0 * c1 + 2.0 * (d - 1) * c2) * log_j
                + lam_log / 2.0 * log_j * log_j)
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
    material: str = "neo_hookean",
) -> torch.Tensor:
    """Per-element V·φ, ``(E,)``."""
    f = deformation_gradients(pos, element_indices, ref_inv)
    return volume * energy_density(f, mu, s_lambda, material)


def total_energy(
    pos: torch.Tensor,
    element_indices: torch.Tensor,
    ref_inv: torch.Tensor,
    volume: torch.Tensor,
    mu: float,
    s_lambda: float,
    material: str = "neo_hookean",
) -> torch.Tensor:
    """U = Σ_e V_e·φ(F_e), the autodiff loss (a 0-d tensor)."""
    return element_energies(
        pos, element_indices, ref_inv, volume, mu, s_lambda, material
    ).sum()


def cauchy_stress(f: torch.Tensor, mu: float, s_lambda: float,
                  material: str = "neo_hookean") -> torch.Tensor:
    """True (Cauchy) stress σ = P(F)·Fᵀ / det F per element, ``(…, d, d)``
    (the JAX package's ``cauchy_stress``, a post-processing extension: the
    reference exposes no stress field).  Symmetric and objective for every
    isotropic hyperelastic material here; the small-strain ``linear``
    model is not objective, by construction, and its σ is reported the
    same way."""
    p = first_piola(f, mu, s_lambda, material)
    return sm.matmul(p, sm.mT(f)) / sm.det(f)[..., None, None]


def von_mises(sigma: torch.Tensor) -> torch.Tensor:
    """Von Mises equivalent stress √(3/2 · s:s) of the deviatoric part
    s = σ − tr(σ)/d·I; for a uniaxial σ = diag(s, 0, 0) in 3D it is |s|."""
    d = sigma.shape[-1]
    dev = sigma - (sm.trace(sigma) / d)[..., None, None] * _eye_like(sigma)
    return torch.sqrt(1.5 * (dev * dev).sum(dim=(-2, -1)))


def element_stresses(
    pos: torch.Tensor,
    element_indices: torch.Tensor,
    ref_inv: torch.Tensor,
    mu: float,
    s_lambda: float,
    material: str = "neo_hookean",
) -> torch.Tensor:
    """Per-element Cauchy stress tensors at the current positions, (E, d, d)."""
    f = deformation_gradients(pos, element_indices, ref_inv)
    return cauchy_stress(f, mu, s_lambda, material)
