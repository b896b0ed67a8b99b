# coding=utf-8
"""The port's materials (``fem_tpu_torch/ops/element.py``: every base
material of the JAX package, and ``robust_inversion``) against the JAX
package on the same arrays: the small-matrix pieces (``polar_rotation``,
``safe_inv``, the cofactors), P, DP and φ per material and dimension, the
planar chains K1, K2, K6 and K7b follow (against the Pallas chains, and the
Pallas kernels K1 and K6 in interpret mode), the implicit rhs and the
parameter errors (the op-composed substeps of every method per material are
in tests/test_torch_materials_substep.py).

Inputs are made from a seed with numpy.  Tolerances (float32 on both
sides, sums in other orders): P, DP and the chains 1e-5 relative to each
element's largest entry; φ rtol 1e-5; polar rotations 1e-5 (12 iterations of
the same formula, the inverse as a division in the JAX package's XLA
function and as a product with 1/det in its Pallas chain and here);
the implicit rhs 1e-5."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu.ops import element as jelement
from fem_tpu.ops import pallas_kernels as jpk
from fem_tpu.ops import smallmat as jsm
from fem_tpu.solvers import implicit as jimplicit
from fem_tpu_torch.ops import element, element_kernels
from fem_tpu_torch.ops import smallmat as sm
from fem_tpu_torch.solvers import implicit
from tests.test_torch_inelastic import inelastic_pair

torch.set_num_threads(1)

TOL = 1e-5
# Corotated P = 2μ(F − R) + …: F − R cancels, so the rounding of R (the
# division in the JAX package's XLA inverse, a product with 1/det here) is
# amplified by |F|/|F − R|, ~10-100 at these strains.
TOL_COROTATED_P = 1e-4
MU, LAM = 1.0e4, 3.0e4
# Every base material but Neo-Hookean, in the spellings the shipped configs
# and the JAX package's tests use; Mooney-Rivlin and fiber with parameters.
MATERIALS = {
    2: ("stvk", "linear", "corotated", "stable_neo_hookean",
        "mooney_rivlin:0.3", "fiber:1,0.5:2"),
    3: ("stvk", "linear", "corotated", "stable_neo_hookean",
        "mooney_rivlin:0.3", "fiber:1,0.5,0.25"),
}


def _block_rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(axis=1)[:, None, None]
    return float((np.abs(got - ref) / np.maximum(scale, 1e-30)).max())


def _near_identity(rng, n, d, amount):
    return (np.eye(d) + amount * rng.standard_normal((n, d, d))).astype(
        np.float32)


def _planes(a, dim):
    return [jnp.asarray(a.reshape(-1, dim * dim)[:, c])
            for c in range(dim * dim)]


def _unplanes(planes, dim):
    return np.stack([np.asarray(c) for c in planes], 1).reshape(-1, dim, dim)


@pytest.mark.parametrize("dim", [2, 3])
def test_smallmat_matches_jax(dim):
    rng = np.random.default_rng(dim)
    m = _near_identity(rng, 128, dim, 0.4)
    m[0] = np.diag([1.0, 2.0, 3.0][:dim])  # already symmetric
    m[1, :, 0] *= -1.0  # inverted: the orthogonal, not rotation, factor
    m[2] = np.diag([1.0] * (dim - 1) + [0.0])  # singular: safe_inv's clamp
    d_dir = _near_identity(rng, 128, dim, 0.5)
    t, tj = torch.as_tensor(m), jnp.asarray(m)
    r = sm.polar_rotation(t)
    jr = jsm.polar_rotation(tj)
    ok = slice(3, None)  # 12 iterations do not converge for m[2]
    np.testing.assert_allclose(r.numpy()[ok], np.asarray(jr)[ok], rtol=0,
                               atol=TOL)
    eye = np.broadcast_to(np.eye(dim), r[ok].shape)
    np.testing.assert_allclose((r.mT @ r).numpy()[ok], eye, atol=1e-5)
    np.testing.assert_allclose(r.numpy()[0], np.eye(dim), atol=1e-6)
    assert float(torch.det(r[1])) < 0.0
    np.testing.assert_allclose(sm.safe_inv(t).numpy(),
                               np.asarray(jsm.safe_inv(tj)), rtol=1e-5)
    assert torch.isfinite(sm.safe_inv(t)).all()
    assert float(sm.safe_inv(t)[2].abs().max()) == pytest.approx(1e6, rel=1e-5)
    np.testing.assert_allclose(sm.cofactor(t).numpy(),
                               np.asarray(jsm.cofactor(tj)), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        sm.d_cofactor(t, torch.as_tensor(d_dir)).numpy(),
        np.asarray(jsm.d_cofactor(tj, jnp.asarray(d_dir))), rtol=1e-6,
        atol=1e-6)


BASE = ("neo_hookean", "stvk", "linear", "corotated", "stable_neo_hookean",
        "mooney_rivlin", "fiber")


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("material", BASE)
def test_p_dp_and_energy_match_jax(material, dim):
    """P, DP (robust too) and φ of the XLA functions of the JAX package's
    ops/element.py (Mooney-Rivlin at its default β here)."""
    if material == "fiber":
        material = MATERIALS[dim][5]
    rng = np.random.default_rng(10 * BASE.index(material.split(":")[0]) + dim)
    f = _near_identity(rng, 96, dim, 0.2)
    d_dir = _near_identity(rng, 96, dim, 0.3)
    ft, dt = torch.as_tensor(f), torch.as_tensor(d_dir)
    fj, dj = jnp.asarray(f), jnp.asarray(d_dir)
    p = element.first_piola(ft, MU, LAM, material)
    assert _block_rel(p, jelement.first_piola(fj, MU, LAM, material)) <= (
        TOL_COROTATED_P if material == "corotated" else TOL)
    for robust in (False, True):
        dp = element.first_piola_dp(ft, dt, MU, LAM, material, robust)
        ref = jelement.first_piola_dp(fj, dj, MU, LAM, material, robust)
        assert _block_rel(dp, ref) <= TOL, robust
    e = element.energy_density(ft, MU, LAM, material)
    np.testing.assert_allclose(
        e.numpy(), np.asarray(jelement.energy_density(fj, MU, LAM, material)),
        rtol=1e-5, atol=1e-3)
    # P is the gradient of φ: autograd of the port's energy agrees.
    fg = ft.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(
        element.energy_density(fg, MU, LAM, material).sum(), fg)
    assert _block_rel(g, p) <= 1e-4


@pytest.mark.parametrize("robust", [False, True])
@pytest.mark.parametrize("dim", [2, 3])
def test_planar_chains_match_pallas_chains(dim, robust):
    """k, h and the gradient columns of every material against the Pallas
    chains ``k_and_h_chain`` / ``grad_cols_chain`` (their planar twins, whose
    order the CUDA chains follow): robust acts on Neo-Hookean only."""
    rng = np.random.default_rng(40 + dim)
    f = _near_identity(rng, 96, dim, 0.25)
    r = _near_identity(rng, 96, dim, 0.3)
    if robust:
        f[0] = 0.0
        f[0, 0, 0] = 1.0  # det F = 0
        f[1, :, 0] *= -1.0  # inverted
    x = (f @ np.linalg.inv(r)).astype(np.float32)
    xt, rt = torch.as_tensor(x), torch.as_tensor(r)
    ft = sm.matmul(xt, rt)
    for material in ("neo_hookean",) + MATERIALS[dim]:
        k, h = element.k_and_h_chain(ft, rt, MU, LAM, material, robust)
        jk, jh = jpk.k_and_h_chain(_planes(x, dim), _planes(r, dim), dim, MU,
                                   LAM, robust, material)
        for got, ref in ((k, jk), (h, jh)):
            ref, got = _unplanes(ref, dim), got.numpy()
            fin = (np.isfinite(ref).all(axis=(1, 2))
                   & np.isfinite(got).all(axis=(1, 2)))
            assert fin[2:].all(), material  # all but the degenerate two
            assert _block_rel(got[fin], ref[fin]) <= TOL, material
        if robust and material == "neo_hookean":
            assert torch.isfinite(k).all() and torch.isfinite(h).all()
        if robust:
            continue
        g = element.grad_cols_chain(ft, rt, MU, LAM, material)
        jg = _unplanes(jpk.grad_cols_chain(_planes(x, dim), _planes(r, dim),
                                           dim, MU, LAM, material), dim)
        assert _block_rel(g, jg) <= TOL, material


@pytest.mark.parametrize("dim", [2, 3])
def test_element_kernels_match_pallas_kernels(dim):
    """K1 (``hessian_and_force``, robust too) and K6
    (``explicit_grad_columns``) on a stretched mesh against the JAX
    package's Pallas kernels ``hessian_and_force_pallas`` and
    ``explicit_grad_columns_pallas`` in interpret mode."""
    obj, state, _, jstate = inelastic_pair(dim, {}, seed=dim, squash=0.15)
    args = (state.pos, obj.element_indices, obj.ref_inv, obj.volume, MU, LAM)
    jargs = (jstate.pos, jnp.asarray(obj.element_indices.numpy()),
             jnp.asarray(obj.ref_inv.numpy()), jnp.asarray(obj.volume.numpy()),
             MU, LAM)
    for material, robust in ((MATERIALS[dim][0], False),
                             (MATERIALS[dim][5], False),
                             ("neo_hookean", True)):
        k, h = element_kernels.hessian_and_force(*args, robust=robust,
                                                 material=material)
        jk, jh = jpk.hessian_and_force_pallas(*jargs, robust, material)
        assert _block_rel(k, jk) <= TOL and _block_rel(h, jh) <= TOL
        if not robust:
            g = element_kernels.explicit_grad_columns(*args, material)
            jg = jpk.explicit_grad_columns_pallas(*jargs, material)
            assert _block_rel(g, jg) <= TOL


@pytest.mark.parametrize("robust", [False, True])
@pytest.mark.parametrize("dim", [2, 3])
def test_element_functions_and_rhs_match_jax(dim, robust):
    """``hessian_blocks``, ``implicit_force_columns``,
    ``explicit_grad_columns``, ``element_energies`` and ``implicit_rhs`` per
    material against the JAX package's XLA functions."""
    obj, state, jobj, jstate = inelastic_pair(dim, {}, seed=10 + dim,
                                              squash=0.15)
    args = (state.pos, obj.element_indices, obj.ref_inv, obj.volume, MU, LAM)
    jargs = (jstate.pos, jobj.element_indices, jobj.ref_inv, jobj.volume, MU,
             LAM)
    got = element.implicit_force_columns(*args, robust)
    assert _block_rel(got, jelement.implicit_force_columns(*jargs, robust)) \
        <= TOL
    for material in ("neo_hookean",) + MATERIALS[dim]:
        got = element.hessian_blocks(*args, robust, material)
        ref = jelement.hessian_blocks(*jargs, robust, material)
        assert _block_rel(got, ref) <= TOL, material
        got = element.explicit_grad_columns(*args, material)
        assert _block_rel(got, jelement.explicit_grad_columns(
            *jargs, material)) <= (TOL_COROTATED_P if material == "corotated"
                                   else TOL), material
        np.testing.assert_allclose(
            element.element_energies(*args, material).numpy(),
            np.asarray(jelement.element_energies(*jargs, material)),
            rtol=1e-4, atol=1e-6)
        o = dataclasses.replace(obj, mu=MU, s_lambda=LAM, material=material)
        jo = jobj.replace(mu=MU, s_lambda=LAM, material=material)
        b = implicit.implicit_rhs(o, state, 5e-4, robust)
        jb = jimplicit.implicit_rhs(jo, jstate, 5e-4, None, robust, "xla")
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=0,
                                   atol=TOL, err_msg=material)


def test_material_parameter_errors():
    """The JAX package's ``ValueError``s of ``mooney_params`` and
    ``fiber_params``, raised by the port's functions and kernels' wrappers
    alike; unknown names raise too."""
    f = torch.eye(3).expand(4, 3, 3).contiguous()
    for material, lam, what in (
        ("mooney_rivlin:1.0", LAM, "beta must be in"),
        ("mooney_rivlin:-0.1", LAM, "beta must be in"),
        ("mooney_rivlin:0.3", 1e3, "calibration infeasible"),
        ("fiber:1,0", LAM, "components for dim=3"),
        ("fiber:0,0,0", LAM, "must be nonzero"),
        ("fiber:1,0,0:0", LAM, "kappa must be > 0"),
        ("granite", LAM, "unknown material"),
    ):
        for fn in (lambda: element.first_piola(f, MU, lam, material),
                   lambda: element.energy_density(f, MU, lam, material),
                   lambda: element.material_constants(material, MU, lam, 3)):
            with pytest.raises(ValueError, match=what):
                fn()
        if what != "unknown material":
            with pytest.raises(ValueError, match=what):
                jelement.first_piola(jnp.asarray(f.numpy()), MU, lam,
                                     material)
    assert element.mooney_params(MU, LAM, 2, "mooney_rivlin") == \
        jelement.mooney_params(MU, LAM, 2, "mooney_rivlin")
    assert element.fiber_params(MU, 3, "fiber:1,1,0:2") == \
        jelement.fiber_params(MU, 3, "fiber:1,1,0:2")
    c = element.material_constants("fiber:3,4:2", MU, LAM, 2)
    assert (c["a0"], c["a1"], c["two_k"]) == (0.6, 0.8, 4.0 * MU)
    assert element.kernel_material_id("neo_hookean", robust=True) == \
        element.ROBUST_NEO_HOOKEAN_ID
    assert element.kernel_material_id("stvk", robust=True) == \
        element.MATERIAL_IDS["stvk"]
