# coding=utf-8
"""The edge matrix S, the ``operator_mode="mxu"`` operator and solve, and
K11a's plain version against the JAX package on the same arrays.

Tolerances: ``build_edge_matrix`` and the attached S exactly (0/±1
entries); the mxu applies to 1e-5 of the largest entry (the same products
in another summation order); the mxu solve with equal iterations and
velocity atol 1e-5 (short solves: a few to a few tens of iterations); K11a's
plain version against ``cg_solve_pallas`` in interpret mode with equal
iterations and x to 1e-5 of its largest entry (tests/test_pallas_cg.py's
cases)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu.experiments.pallas_cg import cg_solve_pallas
from fem_tpu.models.state import build_object as jax_build_object
from fem_tpu.ops.element import hessian_blocks as jax_hessian_blocks
from fem_tpu.solvers import implicit as jimplicit
from fem_tpu.utils import config as jconfig
from fem_tpu_torch import convert
from fem_tpu_torch.experiments import edge_cg
from fem_tpu_torch.models.state import build_object
from fem_tpu_torch.solvers import implicit
from fem_tpu_torch.utils import config as pconfig
from tests.test_blocked import _cube_mesh
from tests.test_implicit import _perturbed
from tests.utils import make_2d_object, two_tet_object

torch.set_num_threads(1)

DT = 5e-4


def _port(jobj, jstate):
    """The port's (object, state) on the CPU from the JAX package's, S and
    the pins' arrays included."""
    names = convert.OBJECT_ARRAYS + convert.OPTIONAL_OBJECT_ARRAYS
    arrays = {n: None if getattr(jobj, n) is None
              else np.asarray(getattr(jobj, n)) for n in names}
    statics = {n: getattr(jobj, n) for n in convert.OBJECT_STATICS}
    obj = convert.object_from_arrays(arrays, statics, "cpu")
    state = convert.state_from_arrays(
        {n: np.asarray(getattr(jstate, n)) for n in convert.STATE_ARRAYS},
        "cpu")
    return obj, state


def _mesh(dim):
    if dim == 2:
        cfg, obj, _ = make_2d_object(subdivisions=5)
        return np.asarray(obj.element_indices), obj.particle_cnt
    nodes, _, tets = _cube_mesh(spacing=0.45)
    return tets.astype(np.int32), nodes.shape[0]


@pytest.mark.parametrize("dim", [2, 3])
def test_build_edge_matrix_equals_jax(dim):
    idx, n = _mesh(dim)
    got = implicit.build_edge_matrix(idx, n)
    ref = jimplicit.build_edge_matrix(idx, n)
    assert got.dtype == ref.dtype == np.float32
    assert got.shape == (idx.shape[0] * dim, n)
    assert np.array_equal(got, ref)


def _cube_objects(operator_mode="mxu", **ocfg_over):
    """The Delaunay cube (spacing 0.45, scaled 0.35) in both packages, built
    for ``operator_mode``, deformed and moving (numpy seed)."""
    nodes, f, tets = _cube_mesh(spacing=0.45)
    ocfg = jconfig.ObjectConfig(center=(0.3, 0.3, 0.3), rho=1000.0, E=4e5,
                                nu=0.3, damping=10.0, **ocfg_over)
    jobj, jstate = jax_build_object(ocfg, (nodes * 0.35).astype(np.float32),
                                    f, tets, operator_mode=operator_mode)
    jstate = _perturbed(jstate, 0.004)
    return (jobj, jstate) + _port(jobj, jstate)


@pytest.mark.parametrize("beta", [0.0, 2e-3])
@pytest.mark.parametrize("dim", [2, 3])
def test_mxu_applies_match_jax(dim, beta):
    if dim == 3:
        jobj, jstate, obj, state = _cube_objects()
    else:
        from tests.utils import attach_edge_matrix

        _, jobj, jstate = make_2d_object(subdivisions=5)
        jobj = attach_edge_matrix(jobj)
        jstate = _perturbed(jstate, 0.004)
        obj, state = _port(jobj, jstate)
    assert obj.edge_matrix is not None
    K = jax_hessian_blocks(jstate.pos, jobj.element_indices, jobj.ref_inv,
                           jobj.volume, jobj.mu, jobj.s_lambda)
    ja, jat = jimplicit.make_mxu_system_apply(jobj, K, jobj.edge_matrix, DT,
                                              beta)
    pa, pat = implicit.make_mxu_system_apply(
        obj, torch.as_tensor(np.array(K)), obj.edge_matrix, DT, beta)
    x = np.random.default_rng(3).normal(size=(obj.particle_cnt, dim)).astype(
        np.float32)
    for jf, pf in ((ja, pa), (jat, pat)):
        ref = np.asarray(jf(jnp.asarray(x)))
        got = pf(torch.as_tensor(x)).numpy()
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


SOLVE_CASES = {
    "plain": (dict(), dict(preconditioned=0)),
    "normal": (dict(), dict(preconditioned=1)),
    "pins": (dict(pin_boxes=(((0.0, 0.0, 0.0), (1.0, 0.33, 1.0)),)),
             dict(preconditioned=0)),
    "beta": (dict(damping_beta=2e-3), dict(preconditioned=1)),
}


@pytest.mark.parametrize("case", list(SOLVE_CASES))
def test_mxu_solve_matches_jax(case):
    ocfg_over, kw = SOLVE_CASES[case]
    jobj, jstate, obj, state = _cube_objects(**ocfg_over)
    if case == "pins":
        assert obj.free_mask is not None and float(obj.free_mask.min()) == 0.0
    js, jaux = jimplicit.implicit_velocity_solve(
        jobj, jstate, DT, 1, kw["preconditioned"], operator_mode="mxu")
    ps, paux = implicit.implicit_velocity_solve(
        obj, state, DT, 1, kw["preconditioned"], operator_mode="mxu")
    assert int(paux.iterations) == int(jaux.iterations) > 0
    np.testing.assert_allclose(ps.vel.numpy(), np.asarray(js.vel), rtol=0,
                               atol=1e-5)


def test_mxu_mode_routes_through_the_edge_matrix(monkeypatch):
    """``"mxu"`` on an object with S runs the edge-matrix operator; an
    object without S, or ``"auto"`` on one with locality blocks, does not."""
    _, _, obj, state = _cube_objects()
    calls = []
    real = implicit.make_mxu_system_apply

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(implicit, "make_mxu_system_apply", spy)
    implicit.implicit_velocity_solve(obj, state, DT, 1, 1,
                                     operator_mode="mxu")
    assert len(calls) == 1
    implicit.implicit_velocity_solve(obj, state, DT, 1, 1,
                                     operator_mode="auto")
    implicit.implicit_velocity_solve(
        dataclasses.replace(obj, edge_matrix=None), state, DT, 1, 1,
        operator_mode="mxu")
    assert len(calls) == 1


@pytest.mark.parametrize("operator_mode", ["mxu", "auto", "blocked"])
@pytest.mark.parametrize("subdivisions", [3, 10])
def test_build_object_attaches_s_as_jax(operator_mode, subdivisions):
    """S exactly when the JAX package attaches it: ``"mxu"`` forced and
    E·d·N ≤ 16,000,000 (the 10-subdivision grid, 6,000 tets and 1,331
    particles, is past the gate)."""
    pcfg = pconfig.ObjectConfig(subdivisions=subdivisions, side_length=0.2,
                                center=(0.4, 0.1, 0.4))
    jcfg = jconfig.ObjectConfig(subdivisions=subdivisions, side_length=0.2,
                                center=(0.4, 0.1, 0.4))
    from fem_tpu.models.mesh import construct_3d_grid_mesh

    v, f, t = construct_3d_grid_mesh(jcfg)
    jobj, _ = jax_build_object(jcfg, v, f, t, operator_mode=operator_mode)
    obj, _ = build_object(pcfg, v, f, t, device="cpu",
                          operator_mode=operator_mode)
    assert (obj.edge_matrix is None) == (jobj.edge_matrix is None)
    assert (obj.edge_matrix is not None) == (operator_mode == "mxu"
                                             and subdivisions == 3)
    if obj.edge_matrix is not None:
        assert np.array_equal(obj.edge_matrix.numpy(),
                              np.asarray(jobj.edge_matrix))
        assert edge_cg.supports_edge_cg(obj)
        back = convert.object_from_arrays(*convert.object_to_arrays(obj),
                                          "cpu")
        assert torch.equal(back.edge_matrix, obj.edge_matrix)


@pytest.mark.parametrize("precond", [True, False], ids=["precond", "plain"])
@pytest.mark.parametrize(
    "maker,scale", [(make_2d_object, 0.004), (two_tet_object, 0.03)],
    ids=["2d", "3d"],
)
def test_edge_cg_plain_matches_pallas(maker, scale, precond):
    from tests.utils import attach_edge_matrix

    _, jobj, jstate = maker()
    jobj = attach_edge_matrix(jobj)
    jstate = _perturbed(jstate, scale)
    K = jax_hessian_blocks(jstate.pos, jobj.element_indices, jobj.ref_inv,
                           jobj.volume, jobj.mu, jobj.s_lambda)
    b = jimplicit.implicit_rhs(jobj, jstate, DT)
    x_ref, it_ref = cg_solve_pallas(jobj.edge_matrix, K, b, jobj.mass,
                                    dim=jobj.dim, dt2=DT * DT,
                                    preconditioned=precond)
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    x, it = edge_cg.cg_solve_edge(t(jobj.edge_matrix), t(K), t(b),
                                  t(jobj.mass), dim=jobj.dim, dt2=DT * DT,
                                  preconditioned=precond)
    assert it.dtype == torch.int32
    assert int(it) == int(it_ref)
    ref = np.asarray(x_ref)
    assert np.abs(x.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def _two_tet_s():
    idx = np.array([[0, 1, 2, 3], [1, 2, 3, 4]], np.int32)
    return torch.as_tensor(implicit.build_edge_matrix(idx, 5)), idx


def test_edge_plan_recovers_the_elements_and_is_memoized():
    s, idx = _two_tet_s()
    plan = edge_cg.edge_plan(s, 3)
    assert np.array_equal(plan.element_indices.numpy(), idx)
    assert edge_cg.edge_plan(s, 3) is plan
    s[0, 4] = 0.5  # changed in place: the plan is rebuilt, and S refused
    with pytest.raises(ValueError):
        edge_cg.edge_plan(s, 3)


@pytest.mark.parametrize("fault", ["extra +1", "empty row", "half",
                                   "two vertex 0", "rows"])
def test_malformed_edge_matrix_raises(fault):
    s, _ = _two_tet_s()
    if fault == "extra +1":
        s[1, 4] = 1.0
    elif fault == "empty row":
        s[2] = 0.0
    elif fault == "half":
        s[3, 0] = 0.5
    elif fault == "two vertex 0":
        s[1] = 0.0
        s[1, 2] = 1.0
        s[1, 4] = -1.0
    else:
        s = s[:5]
    k = torch.zeros((2, 3, 3))
    b = torch.zeros((5, 3))
    with pytest.raises(ValueError):
        edge_cg.cg_solve_edge(s, k, b, torch.ones(5), dim=3, dt2=1e-6,
                              preconditioned=True)
