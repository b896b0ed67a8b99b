# coding=utf-8
"""Harmonic (steady-state frequency response) and modal transient analysis.

The port of the JAX package's ``solvers/harmonic.py``, on a modal basis
from ``solvers/modal.py``:

* :func:`harmonic_response` — the steady-state complex response of
  M ẍ + C ẋ + K x = F̂ cos(ωt), C = α·M + β·K, by modal superposition:
  q̂ᵢ(ω) = φᵢᵀF̂ / (ωᵢ² − ω² + i·ω·cᵢ), cᵢ = α + β·ωᵢ² (or 2ζᵢωᵢ);
* :func:`modal_transient` — the reduced system advanced by the exact
  one-step propagator of each mode, the augmented 3×3 matrix exponential
  ``torch.linalg.matrix_exp([[A, B], [0, 0]]·dt)`` (finite for the rigid
  modes, ω = 0; taken in float64, :func:`exact_propagators`); the JAX
  package's ``lax.scan`` over time steps becomes a Python loop over them,
  each step vectorised over the modes.

Plain PyTorch on the modal basis's device; no kernel (the JAX package's
are XLA too).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from fem_tpu_torch.solvers.modal import ModalResult


class HarmonicResult(NamedTuple):
    """Steady-state response over a frequency sweep.

    ``freqs``: (nf,) excitation frequencies in Hz.
    ``coeffs``: (nf, k) complex modal coordinates q̂ᵢ(ω).
    ``amplitude``: (nf, N, dim) |x̂| per DOF, or None with ``fields=False``.
    ``phase``: (nf, N, dim) arg(x̂) in radians, or None with
    ``fields=False``.
    """

    freqs: torch.Tensor
    coeffs: torch.Tensor
    amplitude: Optional[torch.Tensor]
    phase: Optional[torch.Tensor]


def _as(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a tensor of ``like``'s dtype on its device."""
    return torch.as_tensor(x).to(device=like.device, dtype=like.dtype)


def _modal_damping(omega_sq: torch.Tensor, alpha: float, beta: float,
                   zeta) -> torch.Tensor:
    """Per-mode viscous coefficient cᵢ: α + β·ωᵢ², or 2·ζᵢ·ωᵢ."""
    if zeta is not None:
        z = torch.broadcast_to(_as(zeta, omega_sq), omega_sq.shape)
        return 2.0 * z * torch.sqrt(torch.clamp(omega_sq, min=0.0))
    return alpha + beta * omega_sq


def harmonic_response(
    modal: ModalResult,
    f_hat: torch.Tensor,
    freqs_hz: torch.Tensor,
    alpha: float = 0.0,
    beta: float = 0.0,
    zeta: Optional[torch.Tensor] = None,
    fields: bool = True,
) -> HarmonicResult:
    """Steady-state response to F̂·cos(ωt) over ``freqs_hz`` (nf,), for the
    real load amplitude ``f_hat`` (N, d): Rayleigh damping ``alpha``/
    ``beta``, or per-mode ratios ``zeta``.  ``fields=False`` skips the
    (nf, N, d) field reconstruction (:func:`reconstruct_field` recovers any
    frequency's field from ``coeffs``).  Complex64, as in the JAX
    package."""
    omega_sq = modal.omega_sq
    modes = modal.modes  # (k, N, d)
    freqs = _as(freqs_hz, omega_sq)
    w = 2.0 * math.pi * freqs.to(omega_sq.dtype)
    c = _modal_damping(omega_sq, alpha, beta, zeta)
    p = torch.einsum("knd,nd->k", modes, _as(f_hat, modes))
    denom = torch.complex(
        (omega_sq[None, :] - (w ** 2)[:, None]).to(torch.float32),
        (w[:, None] * c[None, :]).to(torch.float32))
    coeffs = p[None, :].to(torch.complex64) / denom  # (nf, k)
    amplitude = phase = None
    if fields:
        x_hat = torch.einsum("fk,knd->fnd", coeffs,
                             modes.to(torch.complex64))
        amplitude = torch.abs(x_hat)
        phase = torch.angle(x_hat)
    return HarmonicResult(freqs=freqs, coeffs=coeffs, amplitude=amplitude,
                          phase=phase)


def reconstruct_field(modal: ModalResult,
                      coeffs: torch.Tensor) -> torch.Tensor:
    """Physical (complex) displacement field(s) from modal coordinates:
    coeffs (..., k) → (..., N, d)."""
    modes = modal.modes.to(torch.complex64)
    return torch.einsum("...k,knd->...nd", _as(coeffs, modes), modes)


class ModalTransientResult(NamedTuple):
    """Reduced-order rollout: ``q``/``q_dot`` are (steps+1, k) modal
    coordinate trajectories (row 0 = initial condition); ``times``
    (steps+1,)."""

    times: torch.Tensor
    q: torch.Tensor
    q_dot: torch.Tensor


def exact_propagators(omega_sq: torch.Tensor, c: torch.Tensor, dt: float):
    """(E (k, 2, 2), S (k, 2)): each oscillator's exact step for
    q̈ + c q̇ + ω² q = p, p held over the step, from
    expm([[0, 1, 0], [−ω², −c, 1], [0, 0, 0]]·dt).  The exponential is
    taken in float64 and rounded to ``omega_sq``'s dtype: in float32 it
    loses up to ~1e-3 of its largest entry at ω·dt ≫ 1 (the JAX package's
    float32 ``expm`` more), an error the recurrence then carries every
    step."""
    k = omega_sq.shape[0]
    aug = torch.zeros((k, 3, 3), dtype=torch.float64,
                      device=omega_sq.device)
    aug[:, 0, 1] = 1.0
    aug[:, 1, 0] = -omega_sq.to(torch.float64)
    aug[:, 1, 1] = -c.to(torch.float64)
    aug[:, 1, 2] = 1.0
    m = torch.linalg.matrix_exp(aug * dt).to(omega_sq.dtype)
    return m[:, :2, :2], m[:, :2, 2]


def modal_transient(
    modal: ModalResult,
    dt: float,
    steps: int,
    q0: Optional[torch.Tensor] = None,
    q_dot0: Optional[torch.Tensor] = None,
    force: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    f_const: Optional[torch.Tensor] = None,
    alpha: float = 0.0,
    beta: float = 0.0,
    zeta: Optional[torch.Tensor] = None,
) -> ModalTransientResult:
    """Exact-propagator time integration of the modal reduced system:
    each mode advanced by its exact 2×2 map with pᵢ held over the step
    (sampled at its start).  ``force``: callable t → (N, d) load projected
    onto the modes each step; ``f_const``: a constant (N, d) load instead.
    ``q0``/``q_dot0``: (k,) initial modal coordinates."""
    omega_sq = modal.omega_sq
    modes = modal.modes
    k = modes.shape[0]
    c = torch.broadcast_to(_as(_modal_damping(omega_sq, alpha, beta, zeta),
                               omega_sq), omega_sq.shape)
    e_mat, s_vec = exact_propagators(omega_sq, c, dt)
    zeros = torch.zeros((k,), dtype=omega_sq.dtype, device=omega_sq.device)
    q = zeros if q0 is None else _as(q0, omega_sq)
    qd = zeros if q_dot0 is None else _as(q_dot0, omega_sq)
    if f_const is not None and force is not None:
        raise ValueError("pass force= or f_const=, not both")
    p_const = (torch.einsum("knd,nd->k", modes, _as(f_const, modes))
               if f_const is not None else zeros)
    ts = torch.arange(steps, dtype=omega_sq.dtype,
                      device=omega_sq.device) * dt
    qs, qds = [q], [qd]
    for i in range(steps):
        p = p_const
        if force is not None:
            p = p + torch.einsum("knd,nd->k", modes, force(ts[i]))
        y = torch.stack([q, qd], dim=-1)  # (k, 2)
        y_new = torch.einsum("kij,kj->ki", e_mat, y) + s_vec * p[:, None]
        q, qd = y_new[:, 0], y_new[:, 1]
        qs.append(q)
        qds.append(qd)
    times = torch.cat([torch.zeros((1,), dtype=ts.dtype, device=ts.device),
                       ts + dt])
    return ModalTransientResult(times=times, q=torch.stack(qs),
                                q_dot=torch.stack(qds))


def project_field(modal: ModalResult, mass: torch.Tensor,
                  field: torch.Tensor) -> torch.Tensor:
    """Modal coordinates of a physical field: qᵢ = φᵢᵀ·M·x.  ``mass``: (N,)
    lumped masses; ``field``: (N, d)."""
    modes = modal.modes
    return torch.einsum("knd,nd->k", modes,
                        _as(mass, modes)[:, None] * _as(field, modes))


class ParticipationResult(NamedTuple):
    """Modal participation factors for a rigid base-excitation direction.

    ``factors``: (k,) Γᵢ = φᵢᵀ·M·e; ``effective_mass``: (k,) Γᵢ²;
    ``total_mass``: Σ mᵥ; ``captured``: Σ Γᵢ² / total.
    """

    factors: torch.Tensor
    effective_mass: torch.Tensor
    total_mass: torch.Tensor
    captured: torch.Tensor


def participation_factors(modal: ModalResult, mass: torch.Tensor,
                          direction) -> ParticipationResult:
    """Participation factors Γᵢ = φᵢᵀM·e and effective modal masses Γᵢ² for
    a uniform excitation ``direction`` (d,)."""
    modes = modal.modes  # (k, N, d)
    e = _as(direction, modes).to(modes.dtype)
    e = e / torch.linalg.vector_norm(e)
    mass = _as(mass, modes)
    field = mass[:, None] * e[None, :]
    gam = torch.einsum("knd,nd->k", modes, field)
    eff = gam * gam
    total = torch.sum(mass)
    return ParticipationResult(factors=gam, effective_mass=eff,
                               total_mass=total,
                               captured=torch.sum(eff) / total)
