# coding=utf-8
"""Modal analysis (``fem_tpu_torch/solvers/modal.py``, ``lobpcg.py``)
against the JAX package's ``fem_tpu.solvers.modal`` on the same numpy
inputs: the Chebyshev filter from the same start block (``x0_modes``) on a
pinned and a free 2D body and a free 3D cube, the shift-invert LOBPCG
against a dense float64 oracle built from the port's own product, the
LOBPCG copy against ``jax.experimental.sparse.linalg.lobpcg_standard``,
and the float64 paths (refinement, residuals, the sparse oracle).

Tolerances: Chebyshev ω² within 1e-5 of the largest wanted ω² of JAX's,
residuals < 1e-3, M-orthonormal within 1e-3, rigid modes below 1e-4 of
the scale and the first elastic one above 1e-2 (the JAX tests' gates);
shift-invert within 1e-4 of the largest wanted ω² of the oracle; LOBPCG θ
within 1e-5 of the largest; the float64 paths 1e-8 relative.  Rigid modes
span a subspace: only their eigenvalues are compared."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from fem_tpu.models.mesh import construct_2d_mesh
from fem_tpu.models.state import build_object
from fem_tpu.solvers import modal as jmodal
from fem_tpu.utils.config import ObjectConfig
from fem_tpu_torch.solvers import lobpcg, modal
from tests.test_torch_multilevel import port_object
from tests.utils import make_2d_object, make_3d_object

torch.set_num_threads(1)


def _pinned_2d():
    """tests/test_modal.py's pinned square (4 subdivisions, the top rows
    held)."""
    cfg = ObjectConfig(center=(0.5, 0.5), side_length=0.2, subdivisions=4,
                       pin_boxes=(((0.0, 0.595), (1.0, 1.0)),))
    jobj, jstate = build_object(cfg, *construct_2d_mesh(cfg))
    return jobj, np.asarray(jstate.pos)


@pytest.fixture(scope="module")
def bodies():
    """{name: (port object, JAX object, positions)}: the pinned and the
    free 2D square and the free 3D cube (2 subdivisions)."""
    out = {}
    jobj, pos = _pinned_2d()
    out["pinned"] = (port_object(jobj), jobj, pos)
    _, jobj, jstate = make_2d_object(subdivisions=4)
    out["free"] = (port_object(jobj), jobj, np.asarray(jstate.pos))
    _, jobj, jstate = make_3d_object(subdivisions=2)
    out["free3d"] = (port_object(jobj), jobj, np.asarray(jstate.pos))
    return out


def _dense_oracle(obj, pos, k, dtype=torch.float64):
    """K assembled column by column from the port's own product (in
    ``dtype``), the free-DOF pencil solved densely in float64."""
    from fem_tpu_torch.convert import to_dtype

    o = to_dtype(obj, dtype)
    kv = modal.make_stiffness_hvp(o, torch.as_tensor(pos, dtype=dtype))
    n, d = pos.shape
    eye = torch.eye(n * d, dtype=dtype).reshape(n, d, n * d)
    K = kv(eye).reshape(n * d, n * d).double().numpy()
    M = np.repeat(obj.mass.double().numpy(), d)
    if obj.free_mask is not None:
        free = np.repeat(obj.free_mask.numpy()[:, 0], d).astype(bool)
        K, M = K[np.ix_(free, free)], M[free]
    return sla.eigh(0.5 * (K + K.T), np.diag(M), eigvals_only=True)[:k]


def _gram(res, obj):
    phi = res.modes.double().numpy()
    return np.einsum("ind,n,jnd->ij", phi, obj.mass.double().numpy(), phi)


@pytest.mark.parametrize("name,k,rigid", [("pinned", 6, 0), ("free", 8, 3),
                                          ("free3d", 8, 6)])
def test_chebyshev_matches_jax_from_the_same_start(bodies, name, k, rigid):
    obj, jobj, pos = bodies[name]
    n, d = pos.shape
    kq = min(k + max(2, k // 2), n * d // 2)
    x0 = np.random.default_rng(5).normal(size=(kq, n, d)).astype(np.float32)
    res = modal.modal_analysis_chebyshev(
        obj, torch.as_tensor(pos), k=k, rounds=10, degree=80,
        x0_modes=torch.as_tensor(x0))
    jres = jmodal.modal_analysis_chebyshev(
        jobj, jnp.asarray(pos), k=k, rounds=10, degree=80,
        x0_modes=jnp.asarray(x0))
    w, jw = res.omega_sq.numpy(), np.asarray(jres.omega_sq)
    scale = abs(jw[-1])
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(_gram(res, obj), np.eye(k), rtol=0, atol=1e-3)
    assert (np.abs(w[:rigid]) < 1e-4 * scale).all()
    assert w[rigid] > 1e-2 * scale
    if rigid == 0:
        assert (res.residuals.numpy() < 1e-3).all()
        assert res.modes[:, obj.free_mask[:, 0] == 0].abs().max() == 0
        # The separated modes, up to sign (M-inner products of unit modes).
        phi = res.modes.double().numpy()
        jphi = np.asarray(jres.modes, np.float64)
        m = obj.mass.double().numpy()
        dots = np.abs(np.einsum("ind,n,ind->i", phi, m, jphi))
        gaps = np.diff(jw) / scale
        sep = np.ones(k, bool)
        sep[:-1] &= gaps > 1e-3
        sep[1:] &= gaps > 1e-3
        np.testing.assert_allclose(dots[sep], 1.0, atol=1e-3)
    assert 3 <= modal.modal_analysis_chebyshev.last_rounds <= 10


def test_chebyshev_rounds_and_starts_are_deterministic(bodies):
    obj, _, pos = bodies["pinned"]
    a = modal.modal_analysis_chebyshev(obj, torch.as_tensor(pos), k=4,
                                       rounds=2, degree=40, seed=3)
    b = modal.modal_analysis_chebyshev(obj, torch.as_tensor(pos), k=4,
                                       rounds=2, degree=40, seed=3)
    assert modal.modal_analysis_chebyshev.last_rounds == 2
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name,k,rigid", [("pinned", 6, 0), ("free", 8, 3)])
def test_shift_invert_matches_dense_oracle(bodies, name, k, rigid):
    obj, _, pos = bodies[name]
    res = modal.modal_analysis(obj, torch.as_tensor(pos), k=k, m=200,
                               inner_iters=120)
    oracle = _dense_oracle(obj, pos, k)
    scale = abs(oracle[-1])
    np.testing.assert_allclose(res.omega_sq.numpy(), oracle, rtol=0,
                               atol=1e-4 * scale)
    if rigid == 0:
        assert (res.residuals.numpy() < 1e-3).all()
        np.testing.assert_allclose(_gram(res, obj), np.eye(k), rtol=0,
                                   atol=1e-3)
    assert modal.modal_analysis.last_steps > 0


def test_shift_invert_refusals(bodies):
    _, jobj, _ = make_2d_object(subdivisions=2)  # 9 particles, 18 DOFs
    obj = port_object(jobj)
    pos = obj.rest_pos
    with pytest.raises(ValueError, match="LOBPCG"):
        modal.modal_analysis(obj, pos, k=4)
    with pytest.raises(ValueError, match="2\\*k"):
        modal.modal_analysis_chebyshev(obj, pos, k=9)


@pytest.mark.parametrize("m", [5, 40])
def test_lobpcg_copy_matches_jax(m):
    rng = np.random.default_rng(0)
    n, k = 80, 6
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    ev = np.linspace(1.0, 50.0, n) ** 2
    a = ((q * ev) @ q.T).astype(np.float32)
    a = 0.5 * (a + a.T)
    x = rng.normal(size=(n, k)).astype(np.float32)
    from jax.experimental.sparse.linalg import lobpcg_standard

    jth, ju, ji = lobpcg_standard(lambda v: jnp.asarray(a) @ v,
                                  jnp.asarray(x), m=m)
    th, u, i = lobpcg.lobpcg_standard(lambda v: torch.as_tensor(a) @ v,
                                      torch.as_tensor(x), m=m)
    jth = np.asarray(jth)
    np.testing.assert_allclose(th.numpy(), jth, rtol=0,
                               atol=1e-5 * jth.max())
    assert i == int(ji)
    with pytest.raises(ValueError, match="5 < matrix dim"):
        lobpcg.lobpcg_standard(lambda v: v, torch.zeros((10, 2)))


@pytest.fixture(scope="module")
def f32_result(bodies):
    obj, _, pos = bodies["pinned"]
    return modal.modal_analysis_chebyshev(obj, torch.as_tensor(pos), k=6,
                                          rounds=10, degree=80)


def _jax_result(res):
    return jmodal.ModalResult(*(jnp.asarray(t.numpy()) for t in res))


def test_refine_f64_matches_jax(bodies, f32_result):
    obj, jobj, pos = bodies["pinned"]
    res = modal.modal_refine_f64(obj, torch.as_tensor(pos),
                                 result=f32_result, k=6)
    jres = jmodal.modal_refine_f64(jobj, jnp.asarray(pos),
                                   result=_jax_result(f32_result), k=6)
    assert res.omega_sq.dtype == torch.float64
    assert (res.residuals.numpy() < 1e-8).all()
    np.testing.assert_allclose(res.omega_sq.numpy(),
                               np.asarray(jres.omega_sq), rtol=1e-8)
    np.testing.assert_allclose(_gram(res, obj), np.eye(6), rtol=0,
                               atol=1e-10)


def test_residuals_f64_match_jax(bodies, f32_result):
    obj, jobj, pos = bodies["pinned"]
    rr = modal.modal_residuals_f64(obj, torch.as_tensor(pos), f32_result)
    jrr = jmodal.modal_residuals_f64(jobj, jnp.asarray(pos),
                                     _jax_result(f32_result))
    assert rr.omega_sq.dtype == torch.float64
    np.testing.assert_allclose(rr.omega_sq.numpy(),
                               np.asarray(jrr.omega_sq), rtol=1e-8)
    np.testing.assert_allclose(rr.residuals.numpy(),
                               np.asarray(jrr.residuals), rtol=1e-6,
                               atol=1e-12)
    assert (rr.residuals.numpy() < 1e-4).all()


@pytest.mark.parametrize("name,rigid", [("pinned", 0), ("free", 3)])
def test_sparse_f64_matches_jax(bodies, name, rigid):
    obj, jobj, pos = bodies[name]
    res = modal.modal_analysis_sparse_f64(obj, torch.as_tensor(pos), k=4)
    jres = jmodal.modal_analysis_sparse_f64(jobj, jnp.asarray(pos), k=4)
    w, jw = res.omega_sq.numpy(), np.asarray(jres.omega_sq)
    np.testing.assert_allclose(w, jw, rtol=1e-8,
                               atol=1e-8 * np.abs(jw).max())
    # A rigid mode's relative residual at ω² ≈ 0 measures nothing.
    assert res.residuals.numpy()[rigid:].max() < 1e-9
    np.testing.assert_allclose(_gram(res, obj), np.eye(4), atol=1e-8)
