# coding=utf-8
"""Harmonic response, modal transient and response-spectrum analysis
(``fem_tpu_torch/solvers/harmonic.py``, ``spectrum.py``) against the JAX
package's ``fem_tpu.solvers.harmonic`` and ``spectrum`` on one modal basis:
the JAX package's ``modal_analysis_chebyshev`` of tests/test_harmonic.py's
pinned square, carried across as numpy by ``convert.modal_from_arrays``,
so that both packages work from the identical modes.  Also a free body's
basis (rigid modes) through the transient and the spectrum's refusal, and
the argument checks.

Tolerances: every output within 1e-5 of its largest entry (float32 and
complex64 on both sides, the same formulas).  The transient and the
spectrum step an exact propagator that the port takes in float64 and the
JAX package in float32 (its ``expm`` loses up to ~1e-3 of the largest
entry at ω·dt ≫ 1): they are held to the same recurrence in float64 at
1e-5, and to the JAX package within its own distance from that."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu.models.mesh import construct_2d_mesh
from fem_tpu.models.state import build_object
from fem_tpu.solvers import harmonic as jh
from fem_tpu.solvers import modal as jmodal
from fem_tpu.solvers import spectrum as jsp
from fem_tpu.utils.config import ObjectConfig
from fem_tpu_torch import convert
from fem_tpu_torch.solvers import harmonic, spectrum
from tests.utils import make_2d_object

torch.set_num_threads(1)


def _close(got, ref, rel=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def basis():
    """(port ModalResult, JAX ModalResult, mass (N,) numpy, N, d): the
    pinned square's six lowest modes from the JAX package, carried across."""
    cfg = ObjectConfig(center=(0.5, 0.5), side_length=0.2, subdivisions=3,
                       pin_boxes=(((0.0, 0.695), (1.0, 1.0)),))
    jobj, jstate = build_object(cfg, *construct_2d_mesh(cfg))
    jres = jmodal.modal_analysis_chebyshev(jobj, jstate.pos, k=6, rounds=10,
                                           degree=80)
    arrays = {n: np.asarray(getattr(jres, n)) for n in convert.MODAL_FIELDS}
    res = convert.modal_from_arrays(arrays, "cpu")
    back = convert.modal_to_arrays(res)
    assert all(np.array_equal(back[n], arrays[n]) for n in arrays)
    n, d = np.asarray(jstate.pos).shape
    return res, jres, np.asarray(jobj.mass), n, d


@pytest.mark.parametrize("kw", [dict(), dict(alpha=0.3, beta=1e-4),
                                dict(zeta=0.05)])
def test_harmonic_response_matches_jax(basis, kw):
    res, jres, _, n, d = basis
    rng = np.random.default_rng(0)
    f_hat = rng.normal(size=(n, d)).astype(np.float32)
    freqs = np.linspace(0.1, 1.5, 200).astype(np.float32) * float(
        np.asarray(jres.frequencies)[-1])
    got = harmonic.harmonic_response(res, torch.as_tensor(f_hat),
                                     torch.as_tensor(freqs), **kw)
    ref = jh.harmonic_response(jres, jnp.asarray(f_hat), jnp.asarray(freqs),
                               **{k: (jnp.asarray(v) if k == "zeta" else v)
                                  for k, v in kw.items()})
    assert got.coeffs.dtype == torch.complex64
    _close(got.coeffs, ref.coeffs)
    _close(got.amplitude, ref.amplitude)
    field = harmonic.reconstruct_field(res, got.coeffs[17])
    _close(field, jh.reconstruct_field(jres, ref.coeffs[17]))
    # The phase where the amplitude is not negligible.
    amp = np.asarray(ref.amplitude)
    big = amp > 1e-3 * amp.max()
    dphase = np.angle(np.exp(1j * (got.phase.numpy() - np.asarray(
        ref.phase))))
    assert np.abs(dphase[big]).max() < 1e-3
    none = harmonic.harmonic_response(res, torch.as_tensor(f_hat),
                                      torch.as_tensor(freqs), fields=False)
    assert none.amplitude is None and none.phase is None


def _reference_transient(omega_sq, c, dt, steps, q0, p):
    """The same recurrence in float64 numpy: scipy's exponential of each
    mode's augmented matrix, constant modal load ``p``."""
    import scipy.linalg as sla

    q, qd = q0.astype(np.float64), np.zeros_like(q0, np.float64)
    props = []
    for w2, ci in zip(omega_sq.astype(np.float64), c.astype(np.float64)):
        m = sla.expm(np.array([[0.0, 1.0, 0.0], [-w2, -ci, 1.0],
                               [0.0, 0.0, 0.0]]) * dt)
        props.append((m[:2, :2], m[:2, 2]))
    e = np.stack([a for a, _ in props])
    sv = np.stack([b for _, b in props])
    qs = [q]
    for _ in range(steps):
        y = np.einsum("kij,kj->ki", e, np.stack([q, qd], -1)) + sv * p[:, None]
        q, qd = y[:, 0], y[:, 1]
        qs.append(q)
    return np.stack(qs)


def _held(got, ref64, jax_got):
    """``got`` within 1e-5 of the float64 reference's largest entry, and
    within the JAX package's own distance from it (plus that much again)
    of the JAX package's result."""
    top = np.abs(ref64).max()
    np.testing.assert_allclose(got, ref64, rtol=0, atol=1e-5 * top)
    spread = np.abs(np.asarray(jax_got) - ref64).max()
    np.testing.assert_allclose(got, np.asarray(jax_got), rtol=0,
                               atol=2 * spread + 1e-5 * top)


def test_modal_transient_matches_jax(basis):
    """400 steps with a constant load and damping ratios: the float64
    recurrence within 1e-5, the JAX package's within its own float32
    exponential's error (which reaches ~1e-3 of the propagator's largest
    entry at ω·dt ≫ 1)."""
    res, jres, mass, n, d = basis
    rng = np.random.default_rng(1)
    f_const = rng.normal(size=(n, d)).astype(np.float32)
    q0 = rng.normal(size=(6,)).astype(np.float32)
    dt = 2e-3
    got = harmonic.modal_transient(res, dt, 400, q0=torch.as_tensor(q0),
                                   f_const=torch.as_tensor(f_const),
                                   zeta=0.02)
    ref = jh.modal_transient(jres, dt, 400, q0=jnp.asarray(q0),
                             f_const=jnp.asarray(f_const), zeta=0.02)
    w2 = res.omega_sq.numpy()
    p = np.einsum("knd,nd->k", res.modes.double().numpy(), f_const)
    ref64 = _reference_transient(w2, 2 * 0.02 * np.sqrt(w2), dt, 400, q0, p)
    _held(got.q.numpy(), ref64, ref.q)
    _close(got.times, ref.times)
    forced = harmonic.modal_transient(
        res, dt, 50, force=lambda t: torch.sin(30.0 * t) * torch.as_tensor(
            f_const), beta=1e-4)
    jforced = jh.modal_transient(
        jres, dt, 50, force=lambda t: jnp.sin(30.0 * t) * jnp.asarray(
            f_const), beta=1e-4)
    _close(forced.q, jforced.q, 1e-3)
    with pytest.raises(ValueError, match="not both"):
        harmonic.modal_transient(res, dt, 2, f_const=torch.as_tensor(f_const),
                                 force=lambda t: torch.as_tensor(f_const))
    field = rng.normal(size=(n, d)).astype(np.float32)
    _close(harmonic.project_field(res, torch.as_tensor(mass),
                                  torch.as_tensor(field)),
           jh.project_field(jres, jnp.asarray(mass), jnp.asarray(field)))


@pytest.mark.parametrize("direction", [(1.0, 0.0), (0.3, -1.0)])
def test_participation_matches_jax(basis, direction):
    res, jres, mass, _, _ = basis
    got = harmonic.participation_factors(res, torch.as_tensor(mass),
                                         direction)
    ref = jh.participation_factors(jres, jnp.asarray(mass), direction)
    for a, b in zip(got, ref):
        _close(a, b)


def test_rigid_modes_through_the_transient():
    """A free body's basis (three rigid modes at ω ≈ 0): the exact
    propagator stays finite and matches the JAX package's."""
    _, jobj, jstate = make_2d_object(subdivisions=3)
    jres = jmodal.modal_analysis_chebyshev(jobj, jstate.pos, k=5, rounds=6,
                                           degree=60)
    res = convert.modal_from_arrays(
        {n: np.asarray(getattr(jres, n)) for n in convert.MODAL_FIELDS},
        "cpu")
    f = np.ones(np.asarray(jstate.pos).shape, np.float32)
    got = harmonic.modal_transient(res, 1e-3, 100, f_const=torch.as_tensor(f))
    ref = jh.modal_transient(jres, 1e-3, 100, f_const=jnp.asarray(f))
    assert bool(torch.isfinite(got.q).all())
    p = np.einsum("knd,nd->k", res.modes.double().numpy(), f)
    ref64 = _reference_transient(res.omega_sq.numpy(), np.zeros(5), 1e-3,
                                 100, np.zeros(5, np.float32), p)
    _held(got.q.numpy(), ref64, ref.q)
    with pytest.raises(ValueError, match="strictly positive"):
        spectrum.response_spectrum_analysis(
            res, torch.as_tensor(np.asarray(jobj.mass)), (1.0, 0.0),
            sd=torch.ones(5))


def _record(dt=2e-3, dur=3.0):
    """tests/test_spectrum.py's broadband record (30 log-spaced tones,
    random phases, a ramp-in), over 3 s."""
    t = np.arange(int(dur / dt)) * dt
    rng = np.random.default_rng(7)
    ws = np.geomspace(20.0, 400.0, 30)
    phases = rng.uniform(0, 2 * np.pi, ws.shape)
    amps = rng.uniform(0.5, 1.0, ws.shape)
    a = (amps[:, None] * np.sin(ws[:, None] * t[None, :]
                                + phases[:, None])).sum(0)
    a *= np.minimum(t / 0.5, 1.0)
    return a.astype(np.float32), dt


def _reference_spectrum(accel, dt, omegas, zeta):
    """Sd of each oscillator by the float64 recurrence (scipy's
    exponential)."""
    import scipy.linalg as sla

    sd = []
    for w in omegas.astype(np.float64):
        m = sla.expm(np.array([[0.0, 1.0, 0.0], [-w * w, -2 * zeta * w, 1.0],
                               [0.0, 0.0, 0.0]]) * dt)
        y, peak = np.zeros(2), 0.0
        for a in accel.astype(np.float64):
            y = m[:2, :2] @ y - m[:2, 2] * a
            peak = max(peak, abs(y[0]))
        sd.append(peak)
    return np.array(sd)


@pytest.mark.parametrize("zeta", [0.05, 0.0])
def test_response_spectrum_matches_jax(zeta):
    """1,500 samples at 24 frequencies: Sd within 1e-5 of the float64
    recurrence, and within the JAX package's own distance from it of the
    JAX package's; Sv and Sa its multiples; CQC's correlation 1e-5."""
    accel, dt = _record()
    omegas = np.geomspace(5.0, 500.0, 24).astype(np.float32)
    got = spectrum.response_spectrum(accel, dt, torch.as_tensor(omegas),
                                     zeta=zeta)
    ref = jsp.response_spectrum(jnp.asarray(accel), dt, jnp.asarray(omegas),
                                zeta=zeta)
    _held(got.sd.numpy(), _reference_spectrum(accel, dt, omegas, zeta),
          ref.sd)
    _close(got.sv, got.omegas * got.sd)
    _close(got.sa, got.omegas ** 2 * got.sd)
    _close(got.zeta, ref.zeta)
    _close(spectrum.cqc_correlation(torch.as_tensor(omegas), zeta),
           jsp.cqc_correlation(jnp.asarray(omegas), zeta))


@pytest.mark.parametrize("combination", ["cqc", "srss", "abssum"])
def test_response_spectrum_analysis_matches_jax(basis, combination):
    res, jres, mass, _, _ = basis
    accel, dt = _record()
    omegas = torch.sqrt(torch.clamp(res.omega_sq, min=0.0))
    sp = spectrum.response_spectrum(accel, dt, omegas, zeta=0.05)
    got = spectrum.response_spectrum_analysis(
        res, torch.as_tensor(mass), (1.0, 0.0), spectrum=sp, zeta=0.05,
        combination=combination)
    # The same Sd into the JAX package's combination.
    ref = jsp.response_spectrum_analysis(
        jres, jnp.asarray(mass), (1.0, 0.0), sd=jnp.asarray(sp.sd.numpy()),
        zeta=0.05, combination=combination)
    for a, b in zip(got, ref):
        _close(a, b)
    srss = spectrum.response_spectrum_analysis(
        res, torch.as_tensor(mass), (1.0, 0.0), sd=sp.sd,
        combination="srss")
    abssum = spectrum.response_spectrum_analysis(
        res, torch.as_tensor(mass), (1.0, 0.0), sd=sp.sd,
        combination="abssum")
    assert bool((abssum.peak >= srss.peak * (1 - 1e-6)).all())


def test_spectrum_argument_checks(basis):
    res, _, mass, _, _ = basis
    m = torch.as_tensor(mass)
    sd = torch.ones(6)
    with pytest.raises(ValueError, match="exactly one"):
        spectrum.response_spectrum_analysis(res, m, (1.0, 0.0))
    with pytest.raises(ValueError, match="exactly one"):
        spectrum.response_spectrum_analysis(
            res, m, (1.0, 0.0), sd=sd,
            spectrum=spectrum.response_spectrum(np.zeros(4), 1e-3,
                                                torch.ones(6)))
    with pytest.raises(ValueError, match="must match"):
        spectrum.response_spectrum_analysis(res, m, (1.0, 0.0),
                                            sd=torch.ones(4))
    with pytest.raises(ValueError, match="unknown combination"):
        spectrum.response_spectrum_analysis(res, m, (1.0, 0.0), sd=sd,
                                            combination="max")
    with pytest.raises(ValueError, match="accel"):
        spectrum.response_spectrum(np.zeros((3, 2)), 1e-3, torch.ones(2))
