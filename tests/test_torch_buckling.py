# coding=utf-8
"""Linearized buckling (``fem_tpu_torch/solvers/buckling.py``) against the
JAX package's ``fem_tpu.solvers.buckling.linear_buckling`` on
tests/test_buckling.py's clamped strip under axial compression (2D) and a
3D tet column, on the same numpy inputs: the load factors, the pencil
eigenvalues against a dense float64 oracle, tension (no critical factor
near the compressive one), the refusal of an unpinned body, and the count
of rounds.

Tolerances: load factors within 1e-3 relative of the JAX package's (the
two packages start from other random blocks and converge to the same
pencil values); the strip's λ_cr within 2e-3 of the dense float64 pencil
oracle, the column's within 1e-3: K_g·v = K₁·v − K₀·v cancels in f32,
which leaves both packages 1.0e-3 from the oracle on the strip; the
static base state as tests/test_torch_static.py holds it (1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from fem_tpu.models.state import build_object
from fem_tpu.solvers import buckling as jbuckling
from fem_tpu.utils.config import ObjectConfig
from fem_tpu_torch.convert import to_dtype
from fem_tpu_torch.solvers import buckling, modal
from tests.test_torch_multilevel import port_object
from tests.utils import make_2d_object

torch.set_num_threads(1)


def _strip(nx=2, ny=8, width=0.05, height=0.4):
    """tests/test_buckling.py's strip: bottom edge clamped, (port object,
    JAX object, positions, top-edge vertices)."""
    xs = np.linspace(0.0, width, nx + 1)
    ys = np.linspace(0.0, height, ny + 1)
    v = np.array(np.meshgrid(xs, ys)).T.reshape(-1, 2).astype(np.float32)
    faces = []
    for i in range(nx):
        for j in range(ny):
            p1 = i * (ny + 1) + j
            p2, p3 = p1 + 1, p1 + ny + 1
            p4 = p3 + 1
            faces += [[p1, p2, p4], [p1, p4, p3]]
    faces = np.array(faces, np.int32)
    cfg = ObjectConfig(center=(0.0, 0.0),
                       pin_boxes=(((-1.0, -1.0), (width + 1.0, 1e-6)),))
    jobj, jstate = build_object(cfg, v, faces, faces.copy())
    pos = np.asarray(jstate.pos)
    top = np.where(pos[:, 1] > height - 1e-6)[0]
    return port_object(jobj), jobj, pos, top


def _column_3d():
    """tests/test_buckling.py's 3D column: the 3-subdivision grid cube
    stretched 3× in y, clamped at its base, pushed down on its top face by
    10 in all (about a tenth of its critical load; tests/test_buckling.py's
    0.05 is 1/4,000 of it, where f32 resolves K_g = K₁ − K₀ to a few %)."""
    from fem_tpu.models.mesh import construct_3d_grid_mesh

    cfg = ObjectConfig(center=(0.0, 0.0, 0.0), side_length=0.3,
                       subdivisions=3,
                       pin_boxes=(((-1.0, -1.0, -1.0), (1.0, 1e-6, 1.0)),))
    v, f, e = construct_3d_grid_mesh(cfg)
    v = np.asarray(v, np.float32)
    v[:, 1] *= 3.0
    jobj, jstate = build_object(cfg, v, f, e)
    pos = np.asarray(jstate.pos)
    top = np.where(pos[:, 1] > pos[:, 1].max() - 1e-6)[0]
    fext = np.zeros_like(pos)
    fext[top, 1] = -10.0 / len(top)
    return port_object(jobj), jobj, pos, fext


def _axial(pos, top, total):
    f = np.zeros_like(pos)
    f[top, 1] = -total / len(top)
    return f


def _pencil_oracle(obj, pos0, pos1, k):
    """The free-DOF pencil K_g φ = μ K₀ φ in float64, K₀ and K₁ assembled
    column by column from the port's float64 product."""
    o = to_dtype(obj, torch.float64)
    n, d = pos0.shape
    eye = torch.eye(n * d, dtype=torch.float64).reshape(n, d, n * d)
    mats = []
    for p in (pos0, pos1):
        kv = modal.make_stiffness_hvp(
            o, torch.as_tensor(p, dtype=torch.float64))
        m = kv(eye).reshape(n * d, n * d).numpy()
        mats.append(0.5 * (m + m.T))
    free = np.repeat(obj.free_mask.numpy()[:, 0], d).astype(bool)
    k0 = mats[0][np.ix_(free, free)]
    kg = mats[1][np.ix_(free, free)] - k0
    return sla.eigh(kg, k0, eigvals_only=True)[:k]


@pytest.fixture(scope="module")
def strip_runs():
    """The strip under 2.0 of compression, solved by both packages once:
    (port object, port result, JAX result, positions)."""
    obj, jobj, pos, top = _strip()
    f = _axial(pos, top, 2.0)
    res = buckling.linear_buckling(obj, torch.as_tensor(pos),
                                   f_ext=torch.as_tensor(f), k=3, rounds=24,
                                   target_tol=1e-4)
    jres = jbuckling.linear_buckling(jobj, jnp.asarray(pos),
                                     f_ext=jnp.asarray(f), k=3, rounds=24,
                                     target_tol=1e-4)
    return obj, res, jres, pos


def test_strip_matches_jax_and_the_pencil_oracle(strip_runs):
    obj, res, jres, pos = strip_runs
    np.testing.assert_allclose(res.base.pos.numpy(), np.asarray(jres.base.pos),
                               rtol=0, atol=1e-5)
    lam, jlam = res.load_factors.numpy(), np.asarray(jres.load_factors)
    assert np.all(lam[:2] > 0) and lam[0] <= lam[1]
    np.testing.assert_allclose(lam[:2], jlam[:2], rtol=1e-3)
    oracle = _pencil_oracle(obj, pos, res.base.pos.numpy(), 3)
    np.testing.assert_allclose(lam[0], -1.0 / oracle[0], rtol=2e-3)
    np.testing.assert_allclose(res.mu.numpy()[:2], oracle[:2], rtol=2e-3)
    # The QR's reflections leave rounding noise on the held DOFs.
    held = res.modes[:, obj.free_mask[:, 0] == 0].abs().max()
    assert held <= 1e-6 * res.modes.abs().max()
    assert 3 <= buckling.linear_buckling.last_rounds <= 24


def test_given_base_reuses_the_equilibrium(strip_runs):
    obj, res, _, pos = strip_runs
    again = buckling.linear_buckling(obj, torch.as_tensor(pos), k=3,
                                     rounds=24, target_tol=1e-4,
                                     base=res.base)
    assert again.base is res.base
    assert torch.equal(again.load_factors, res.load_factors)


def test_3d_column_matches_jax():
    obj, jobj, pos, fext = _column_3d()
    res = buckling.linear_buckling(obj, torch.as_tensor(pos),
                                   f_ext=torch.as_tensor(fext), k=2,
                                   rounds=16)
    jres = jbuckling.linear_buckling(jobj, jnp.asarray(pos),
                                     f_ext=jnp.asarray(fext), k=2, rounds=16)
    lam, jlam = res.load_factors.numpy(), np.asarray(jres.load_factors)
    assert np.isfinite(lam[0]) and lam[0] > 0
    np.testing.assert_allclose(lam[0], jlam[0], rtol=1e-3)
    oracle = _pencil_oracle(obj, pos, res.base.pos.numpy(), 1)
    np.testing.assert_allclose(lam[0], -1.0 / oracle[0], rtol=1e-3)
    mode = res.modes[0].numpy()
    assert np.linalg.norm(mode[:, [0, 2]]) > 2.0 * np.linalg.norm(mode[:, 1])


def test_tension_gives_no_critical_factor_near_compression(strip_runs):
    _, res_c, _, _ = strip_runs
    obj, jobj, pos, top = _strip()
    f = -_axial(pos, top, 2.0)
    res = buckling.linear_buckling(obj, torch.as_tensor(pos),
                                   f_ext=torch.as_tensor(f), k=2, rounds=8)
    jres = jbuckling.linear_buckling(jobj, jnp.asarray(pos),
                                     f_ext=jnp.asarray(f), k=2, rounds=8)
    lam_c = float(res_c.load_factors[0])
    lam_t, jlam_t = float(res.load_factors[0]), float(jres.load_factors[0])
    assert (not np.isfinite(lam_t)) or lam_t > 10.0 * lam_c
    assert np.isfinite(lam_t) == np.isfinite(jlam_t)
    if not np.isfinite(lam_t):
        assert np.isinf(res.load_factors.numpy()).any()


def test_unpinned_body_is_refused():
    _, jobj, jstate = make_2d_object(subdivisions=3)
    obj = port_object(jobj)
    with pytest.raises(ValueError, match="Dirichlet"):
        buckling.linear_buckling(obj, obj.rest_pos, g_dir=(0.0, -1.0))
