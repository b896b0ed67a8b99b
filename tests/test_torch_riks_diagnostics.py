# coding=utf-8
"""Arc-length continuation (``fem_tpu_torch/solvers/riks.py``) and the
solver-system diagnostics (``solvers/diagnostics.py``) against the JAX
package's ``fem_tpu.solvers.riks`` and ``fem_tpu.solvers.diagnostics`` on
the same numpy inputs: the exact element Hessians (2D and 3D, each base
material), the arc's λ and control history through the snap-through of
tests/test_riks.py's shallow arch, the refusal of an unpinned body, and
the diagnostics on both routes (the dense checks and the matrix-free
symmetry probe).

Tolerances: the element Hessians within 1e-10 of their largest entry (f64
on both sides; 3D corotated against central differences, 1e-6); λ and
the control displacement within 1e-6 of their largest (both run in
float64, their residuals summed in other orders); the diagnostics within
1e-5 (the f32 system; the probe's symmetry error, a difference of two f32
inner products, 1e-4) and the dominance flag equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu.models.state import build_object
from fem_tpu.solvers import diagnostics as jdiag
from fem_tpu.solvers import riks as jriks
from fem_tpu.utils.config import ObjectConfig
from fem_tpu_torch.convert import to_dtype
from fem_tpu_torch.models.state import SimState
from fem_tpu_torch.solvers import diagnostics, riks
from tests.test_torch_multilevel import port_object
from tests.utils import make_2d_object, make_3d_object

torch.set_num_threads(1)

MATERIALS = {
    2: ("neo_hookean", "stvk", "linear", "corotated", "stable_neo_hookean",
        "mooney_rivlin:0.3", "fiber:1,0"),
    3: ("neo_hookean", "stvk", "linear", "corotated", "stable_neo_hookean",
        "mooney_rivlin", "fiber:1,0,0"),
}


def _arch(nx=48, ny=2, span=1.0, t=0.012, rise=0.06):
    """tests/test_riks.py's shallow sine arch, both ends clamped: (port
    object, JAX object, positions, crown vertices)."""
    xs = np.linspace(0.0, span, nx + 1)
    ys = np.linspace(0.0, t, ny + 1)
    v = np.array(np.meshgrid(xs, ys)).T.reshape(-1, 2).astype(np.float32)
    v[:, 1] += (rise * np.sin(np.pi * v[:, 0] / span)).astype(np.float32)
    faces = []
    for i in range(nx):
        for j in range(ny):
            p1 = i * (ny + 1) + j
            p2, p3 = p1 + 1, p1 + ny + 1
            p4 = p3 + 1
            faces += [[p1, p2, p4], [p1, p4, p3]]
    faces = np.array(faces, np.int32)
    eps = span / nx / 4.0
    cfg = ObjectConfig(center=(0.0, 0.0),
                       pin_boxes=(((-1.0, -1.0), (eps, 1.0)),
                                  ((span - eps, -1.0), (span + 1.0, 1.0))))
    jobj, jstate = build_object(cfg, v, faces, faces.copy())
    pos = np.asarray(jstate.pos)
    crown = np.where(np.abs(pos[:, 0] - span / 2.0) < span / nx * 0.6)[0]
    return port_object(jobj), jobj, pos, crown


def _deformed_body(dim, material):
    if dim == 2:
        _, jobj, jstate = make_2d_object(subdivisions=3, E=4e4, nu=0.2)
    else:
        _, jobj, jstate = make_3d_object(subdivisions=2, nu=0.4)
    jobj = jobj.replace(material=material)
    rest = np.asarray(jstate.pos)
    rng = np.random.default_rng(0)
    pos = rest + rng.uniform(-0.01, 0.01, rest.shape) * np.ptp(rest)
    return port_object(jobj), jobj, pos


def _hessians(obj, pos):
    return riks.make_element_hessian_fn(to_dtype(obj, torch.float64))(
        torch.as_tensor(pos, dtype=torch.float64)).numpy()


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mi", range(7))
def test_element_hessians_match_jax(dim, mi):
    """Against ``jax.hessian`` of the JAX package, but 3D corotated, whose
    twelve unrolled Higham steps XLA takes minutes to compile under
    ``jax.hessian``: there against central differences of the port's own
    float64 element gradients (1e-6 of the largest entry)."""
    material = MATERIALS[dim][mi]
    obj, jobj, pos = _deformed_body(dim, material)
    h = _hessians(obj, pos)
    m = (dim + 1) * dim
    assert h.shape == (obj.element_cnt, m, m)
    if (dim, material) == (3, "corotated"):
        o64 = to_dtype(obj, torch.float64)
        x = torch.as_tensor(pos, dtype=torch.float64)[
            obj.element_indices.long()].reshape(-1, m)

        def grads(x_loc):
            def energy(xf, rinv, vol):
                xx = xf.reshape(dim + 1, dim)
                dm = torch.matmul((xx[1:] - xx[0][None, :]).T, rinv)
                return vol * riks.energy_density(dm, o64.mu, o64.s_lambda,
                                                 material)

            return torch.func.vmap(torch.func.grad(energy))(
                x_loc, o64.ref_inv, o64.volume)

        step = 1e-6 * float(np.ptp(pos))
        fd = np.stack([(grads(x + step * torch.eye(m, dtype=x.dtype)[j])
                        - grads(x - step * torch.eye(m, dtype=x.dtype)[j])
                        ).numpy() / (2 * step) for j in range(m)], axis=-1)
        np.testing.assert_allclose(h, fd, rtol=0,
                                   atol=1e-6 * np.abs(h).max())
        return
    with jax.enable_x64(True):
        from fem_tpu.solvers.modal import _cast_inexact

        jobj64 = _cast_inexact(jobj, jnp.float64)
        jh = np.asarray(jriks.make_element_hessian_fn(jobj64)(
            jnp.asarray(pos, jnp.float64)))
    np.testing.assert_allclose(h, jh, rtol=0, atol=1e-10 * np.abs(jh).max())


@pytest.fixture(scope="module")
def arch_runs():
    """Both packages along the arch's first 12 steps from the same scaled
    crown load (tests/test_riks.py's scaling)."""
    obj, jobj, pos, crown = _arch()
    f = np.zeros_like(pos)
    f[crown, 1] = -1.0 / len(crown)
    dx = riks._SparseTangent(to_dtype(obj, torch.float64)).factor(
        torch.as_tensor(pos, dtype=torch.float64))(f.astype(np.float64))
    f = f * (0.10 * 0.06 / abs(float(np.mean(dx[crown, 1]))))
    kw = dict(n_steps=12, dlam0=0.3, tol=1e-6, record_path=False)
    res = riks.arc_length_path(obj, torch.as_tensor(pos), torch.as_tensor(f),
                               **kw)
    jres = jriks.arc_length_path(jobj, jnp.asarray(pos), jnp.asarray(f),
                                 **kw)
    return res, jres


def test_arc_length_history_matches_jax(arch_runs):
    res, jres = arch_runs
    assert res.steps_taken == jres.steps_taken and res.retries == jres.retries
    for a, b in ((res.lam, jres.lam), (res.control, jres.control)):
        b = np.asarray(b)
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-6 * np.abs(b).max())
    np.testing.assert_allclose(res.pos.numpy(), np.asarray(jres.pos),
                               rtol=0, atol=1e-8)
    assert res.tol_used == pytest.approx(jres.tol_used, rel=1e-12)
    assert np.all(res.residuals.numpy()[1:] <= res.tol_used * 1.001)
    assert res.path_pos is None


def test_arc_length_refuses_an_unpinned_body():
    _, jobj, _ = make_2d_object(subdivisions=3)
    obj = port_object(jobj)
    with pytest.raises(ValueError, match="Dirichlet"):
        riks.arc_length_path(obj, obj.rest_pos,
                             torch.zeros_like(obj.rest_pos))


def _state(pos):
    z = torch.zeros_like(pos)
    return SimState(pos=pos, vel=z, vel_g=z, force=z)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dense", [True, False])
def test_system_diagnostics_match_jax(dim, dense):
    if dim == 2:
        _, jobj, jstate = make_2d_object(subdivisions=3)
    else:
        _, jobj, jstate = make_3d_object(subdivisions=2)
    obj = port_object(jobj)
    pos = np.asarray(jstate.pos)
    limit = 8192 if dense else 0
    got = diagnostics.system_diagnostics(
        obj, _state(torch.as_tensor(pos)), dt=5e-4, dense_max_dof=limit)
    ref = jdiag.system_diagnostics(obj=jobj, state=jstate, dt=5e-4,
                                   dense_max_dof=limit)
    # The probe's ⟨x, Ay⟩ − ⟨Ax, y⟩ cancels in f32 sums taken in other
    # orders: 1e-4 there.
    assert got.symmetry_error == pytest.approx(
        ref.symmetry_error, rel=1e-5 if dense else 1e-4, abs=1e-7)
    assert got.diagonally_dominant == ref.diagonally_dominant
    if dense:
        assert got.diag_dominance_margin == pytest.approx(
            ref.diag_dominance_margin, rel=1e-5)
        assert 0.0 < got.symmetry_error < 0.2 and got.diagonally_dominant
    else:
        assert np.isnan(got.diag_dominance_margin)


def test_dense_checks_and_probe_match_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(12, 12))
    a = a + 12 * np.eye(12)
    got, ref = diagnostics.dense_diagnostics(a), jdiag.dense_diagnostics(a)
    assert got == ref
    np.testing.assert_allclose(diagnostics.leading_principal_minors(a, 8),
                               jdiag.leading_principal_minors(a, 8),
                               rtol=1e-12)
    m = np.array([[1.0, 2.0], [0.0, 1.0]], np.float32)
    err = diagnostics.symmetry_probe(lambda v: torch.as_tensor(m) @ v, (2,))
    jerr = jdiag.symmetry_probe(lambda v: jnp.asarray(m) @ v, (2,))
    assert err == pytest.approx(jerr, rel=1e-5) and err > 0.1
