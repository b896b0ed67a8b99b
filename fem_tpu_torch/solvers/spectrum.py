# coding=utf-8
"""Response-spectrum analysis (seismic base excitation).

The port of the JAX package's ``solvers/spectrum.py``:

* :func:`response_spectrum` — the displacement response spectrum
  Sd(ω, ζ) of a ground-acceleration record: each oscillator
  q̈ + 2ζω q̇ + ω² q = −ü_g(t) rolled with its exact 2×2 one-step map (the
  augmented-matrix exponential of ``harmonic.modal_transient``, taken in
  float64: ``harmonic.exact_propagators``), tracking
  the running max |q|.  The JAX package's ``lax.scan`` over samples,
  vmapped over frequencies, becomes a Python loop over the samples, each
  step vectorised over the oscillator frequencies;
* :func:`response_spectrum_analysis` — the peak modal responses
  R_i = Γ_i·Sd(ω_i)·φ_i combined by SRSS, CQC (Der Kiureghian's
  correlation) or the absolute sum.

Float32 throughout, as in the JAX package; plain PyTorch on the modal
basis's device, no kernel.  Rigid modes (ω ≈ 0) are rejected.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from fem_tpu_torch.solvers.harmonic import (
    exact_propagators,
    participation_factors,
)
from fem_tpu_torch.solvers.modal import ModalResult


class SpectrumResult(NamedTuple):
    """Response spectrum of one ground-motion record: ``omegas`` (nw,),
    ``zeta`` (nw,), ``sd`` (nw,) peak relative displacement, ``sv``/``sa``
    ω·Sd and ω²·Sd."""

    omegas: torch.Tensor
    zeta: torch.Tensor
    sd: torch.Tensor
    sv: torch.Tensor
    sa: torch.Tensor


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def response_spectrum(accel, dt: float, omegas,
                      zeta=0.05) -> SpectrumResult:
    """Displacement, pseudo-velocity and pseudo-acceleration spectrum of
    the ground-acceleration record ``accel`` (nt,) sampled at ``dt``, at
    the oscillator circular frequencies ``omegas`` (nw,) with damping
    ratios ``zeta`` (scalar or (nw,)).  The oscillators start at rest.
    Runs on ``omegas``' device (the CPU when it is not a tensor)."""
    device = omegas.device if isinstance(omegas, torch.Tensor) else "cpu"
    accel = _f32(accel, device)
    omegas = torch.atleast_1d(_f32(omegas, device))
    zeta_v = torch.broadcast_to(_f32(zeta, device), omegas.shape)
    if accel.dim() != 1:
        raise ValueError(f"accel must be (nt,), got {tuple(accel.shape)}")
    e_mat, s_vec = exact_propagators(omegas * omegas, 2.0 * zeta_v * omegas,
                                     float(dt))
    y = torch.zeros((omegas.shape[0], 2), dtype=torch.float32, device=device)
    peak = torch.zeros_like(omegas)
    for t in range(accel.shape[0]):
        y = torch.einsum("wij,wj->wi", e_mat, y) + s_vec * (-accel[t])
        peak = torch.maximum(peak, torch.abs(y[:, 0]))
    return SpectrumResult(omegas=omegas, zeta=zeta_v, sd=peak,
                          sv=omegas * peak, sa=omegas * omegas * peak)


def cqc_correlation(omegas, zeta) -> torch.Tensor:
    """Der Kiureghian's CQC modal-correlation matrix ρᵢⱼ (r = ωⱼ/ωᵢ):
    8√(ζᵢζⱼ)(ζᵢ + rζⱼ)r^{3/2} / ((1−r²)² + 4ζᵢζⱼr(1+r²) + 4(ζᵢ²+ζⱼ²)r²),
    with an exact unit diagonal."""
    device = omegas.device if isinstance(omegas, torch.Tensor) else "cpu"
    w = _f32(omegas, device)
    z = torch.broadcast_to(_f32(zeta, device), w.shape)
    r = w[None, :] / torch.clamp(w[:, None], min=1e-30)
    zi, zj = z[:, None], z[None, :]
    num = 8.0 * torch.sqrt(zi * zj) * (zi + r * zj) * r ** 1.5
    den = ((1.0 - r * r) ** 2 + 4.0 * zi * zj * r * (1.0 + r * r)
           + 4.0 * (zi * zi + zj * zj) * r * r)
    rho = num / torch.clamp(den, min=1e-30)
    k = w.shape[0]
    idx = torch.arange(k, device=device)
    rho = rho.clone()
    rho[idx, idx] = 1.0
    return rho


class RSResult(NamedTuple):
    """Response-spectrum combination: ``peak`` (N, d) combined peak
    displacement, ``modal_peaks`` (k, N, d) signed Γᵢ·Sd(ωᵢ)·φᵢ, ``sd``
    (k,), ``factors`` (k,) Γᵢ, ``rho`` (k, k) the correlation used,
    ``captured`` Σ Γᵢ²/M_total."""

    peak: torch.Tensor
    modal_peaks: torch.Tensor
    sd: torch.Tensor
    factors: torch.Tensor
    rho: torch.Tensor
    captured: torch.Tensor


def response_spectrum_analysis(
    modal: ModalResult,
    mass: torch.Tensor,
    direction,
    spectrum: Optional[SpectrumResult] = None,
    sd: Optional[torch.Tensor] = None,
    zeta=0.05,
    combination: str = "cqc",
    omega_floor: float = 1e-4,
) -> RSResult:
    """Peak response to a rigid base excitation along ``direction``,
    combined from per-mode spectral peaks: ``spectrum`` evaluated at the
    modal frequencies, or ``sd`` (k,) directly; ``zeta`` as the spectrum
    was computed with (it enters CQC); ``combination`` "srss" | "cqc" |
    "abssum"."""
    omega_sq = modal.omega_sq
    omegas = torch.sqrt(torch.clamp(omega_sq, min=0.0))
    if bool(torch.any(omegas <= omega_floor)):
        raise ValueError(
            "response-spectrum analysis needs strictly positive modal "
            "frequencies (rigid ω ≈ 0 modes have unbounded relative "
            "displacement); pin the structure or drop rigid modes")
    if (spectrum is None) == (sd is None):
        raise ValueError("pass exactly one of spectrum= or sd=")
    if sd is None:
        sd = spectrum.sd
    sd = _f32(sd, omegas.device)
    if sd.shape != omegas.shape:
        raise ValueError(
            f"sd shape {tuple(sd.shape)} must match the {omegas.shape[0]} "
            "modes (evaluate the spectrum at the modal frequencies)")
    part = participation_factors(modal, mass, direction)
    modes = modal.modes
    r_fields = (part.factors * sd)[:, None, None] * modes  # (k, N, d)
    k = omegas.shape[0]
    eye = torch.eye(k, dtype=torch.float32, device=omegas.device)
    if combination == "abssum":
        peak = torch.sum(torch.abs(r_fields), dim=0)
        rho = eye
    elif combination == "srss":
        peak = torch.sqrt(torch.sum(r_fields * r_fields, dim=0))
        rho = eye
    elif combination == "cqc":
        rho = cqc_correlation(omegas, zeta)
        quad = torch.einsum("ij,ind,jnd->nd", rho.to(r_fields.dtype),
                            r_fields, r_fields)
        peak = torch.sqrt(torch.clamp(quad, min=0.0))
    else:
        raise ValueError(f"unknown combination {combination!r} "
                         "(srss | cqc | abssum)")
    return RSResult(peak=peak, modal_peaks=r_fields, sd=sd,
                    factors=part.factors, rho=rho, captured=part.captured)
