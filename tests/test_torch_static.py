# coding=utf-8
"""The quasi-static solve (``fem_tpu_torch/solvers/static.py``) and
``Simulation.solve_static`` against the JAX package's on the same numpy
inputs: the affine patch tests in 3D and 2D, the gravity sag of a pinned
strip and the chunked solve, each with plain CG and the
``two_level_cheb3`` inner solves; the rest state; the loads; the
refusals.

Tolerances: positions within 1e-5 and ``converged``/``stalled`` equal
(the Newton iterations equal where stated); the gravity load exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fem_tpu
import fem_tpu_torch
from fem_tpu.solvers import static as jstatic
from fem_tpu_torch.solvers import static
from tests.test_torch_multilevel import port_object
from tests.utils import make_2d_object

torch.set_num_threads(1)

PRECONDS = ["none", "two_level_cheb3"]


def _surface_pinned(dim):
    """tests/test_static.py's patch-test bodies: a unit 3D tet grid of 3
    subdivisions or a unit 2D square of 6, every boundary vertex pinned
    (free interior), in both packages."""
    from fem_tpu.models.mesh import construct_2d_mesh, construct_3d_grid_mesh
    from fem_tpu.models.state import build_object
    from fem_tpu.utils.config import ObjectConfig

    cfg = ObjectConfig(center=(0.0,) * dim, side_length=1.0,
                       subdivisions=3 if dim == 3 else 6, E=4e4, nu=0.3)
    mesh = (construct_3d_grid_mesh if dim == 3 else construct_2d_mesh)(cfg)
    jobj, jstate = build_object(cfg, *mesh)
    pos = np.asarray(jstate.pos)
    boundary = np.any((pos <= pos.min(0) + 1e-6) | (pos >= pos.max(0) - 1e-6),
                      axis=1)
    jobj = jobj.replace(
        free_mask=jnp.asarray((~boundary).astype(np.float32)[:, None]))
    return port_object(jobj), jobj, pos, boundary


def _compare(res, jres, iterations=True):
    np.testing.assert_allclose(res.pos.numpy(), np.asarray(jres.pos), rtol=0,
                               atol=1e-5)
    assert bool(res.converged) == bool(jres.converged)
    assert bool(res.stalled) == bool(jres.stalled)
    if iterations:
        assert int(res.iterations) == int(jres.iterations)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("cg_precond", PRECONDS)
def test_affine_patch_test_matches_jax(dim, cg_precond):
    """Boundary at F̄·X, interior from rest: both packages land on F̄·X."""
    obj, jobj, pos, boundary = _surface_pinned(dim)
    f_bar = (np.array([[1.05, 0.03, 0.0], [0.0, 0.97, 0.02],
                       [0.01, 0.0, 1.02]]) if dim == 3
             else np.array([[1.06, 0.04], [0.02, 0.95]]))
    target = pos.astype(np.float64) @ f_bar.T
    pos0 = np.where(boundary[:, None], target, pos).astype(np.float32)
    res = static.solve_static(obj, torch.as_tensor(pos0), tol=1e-4,
                              cg_precond=cg_precond)
    jres = jstatic.solve_static(jobj, jnp.asarray(pos0), tol=1e-4,
                                cg_precond=cg_precond)
    _compare(res, jres)
    assert bool(res.converged)
    np.testing.assert_allclose(res.pos.numpy(), target.astype(np.float32),
                               rtol=0, atol=2e-5)
    assert int(res.cg_iterations) > 0


def _strip():
    """tests/test_static.py's hanging strip: a 2D square of 4 subdivisions
    pinned along its top edge, in both packages."""
    _, jobj, jstate = make_2d_object(
        subdivisions=4, center=(0.4, 0.5), E=2e4, damping=40.0,
        pin_boxes=(((0.35, 0.695), (0.65, 0.705)),))
    return port_object(jobj), jobj, jstate


@pytest.mark.parametrize("cg_precond", PRECONDS)
def test_gravity_sag_matches_jax(cg_precond):
    obj, jobj, jstate = _strip()
    pos0 = torch.as_tensor(np.asarray(jstate.pos))
    res = static.solve_static(obj, pos0, g_dir=(0.0, -1.0),
                              cg_precond=cg_precond)
    jres = jstatic.solve_static(jobj, jstate.pos, g_dir=(0.0, -1.0),
                                cg_precond=cg_precond)
    _compare(res, jres, iterations=False)
    assert bool(res.converged) or (bool(res.stalled)
                                   and float(res.grad_norm) < 1e-2)
    sag = res.pos[:, 1] - pos0[:, 1]
    assert float(sag.min()) < -2e-3
    free = obj.free_mask[:, 0] > 0
    assert torch.equal(res.pos[~free], pos0[~free])


def test_rest_state_is_equilibrium():
    obj, jobj, jstate = _strip()
    pos0 = torch.as_tensor(np.asarray(jstate.pos))
    res = static.solve_static(obj, pos0, tol=1e-6)
    assert bool(res.converged) and int(res.iterations) == 0
    assert torch.equal(res.pos, pos0)


def test_loads_and_the_solve_closure_match_jax():
    """``gravity_force`` exactly; ``make_static_solve_fn`` with a point
    load and ``solve_static_chunked`` against the JAX package's."""
    obj, jobj, jstate = _strip()
    np.testing.assert_array_equal(
        static.gravity_force(obj, (0.0, -1.0)).numpy(),
        np.asarray(jstatic.gravity_force(jobj, (0.0, -1.0))))
    f = np.zeros(np.asarray(jstate.pos).shape, np.float32)
    f[:, 1] = -1.0
    pos0 = torch.as_tensor(np.asarray(jstate.pos))
    res = static.make_static_solve_fn(obj, tol=1e-5)(pos0,
                                                     torch.as_tensor(f))
    jres = jstatic.make_static_solve_fn(jobj, tol=1e-5)(jstate.pos,
                                                        jnp.asarray(f))
    _compare(res, jres, iterations=False)
    assert float(res.pos[:, 1].mean()) < float(pos0[:, 1].mean())
    res = static.solve_static_chunked(obj, pos0, g_dir=(0.0, -1.0),
                                      chunk_newton=2)
    jres = jstatic.solve_static_chunked(jobj, jstate.pos, g_dir=(0.0, -1.0),
                                        chunk_newton=2)
    _compare(res, jres, iterations=False)


def test_simulation_solve_static_matches_jax():
    """``Simulation.solve_static`` sets each body at its equilibrium with
    zero velocity, as the JAX package's does."""
    data = {
        "dim": 2, "delta_time": 5e-4, "sim_count": 2,
        "use_explicit_method": False, "implicit_method": 1, "g_dir": [0, -1],
        "objects": [{"center": [0.4, 0.5], "side_length": 0.2,
                     "subdivisions": 4, "E": 2e4, "damping": 40.0,
                     "pin_boxes": [[[0.35, 0.695], [0.65, 0.705]]]}],
    }
    jsim = fem_tpu.Simulation.from_dict(data)
    psim = fem_tpu_torch.Simulation.from_dict(data, device="cpu")
    psim.scene[0].state = psim.scene[0].state.replace(
        vel=torch.ones_like(psim.scene[0].state.vel))
    (res,) = psim.solve_static(cg_precond="two_level_cheb3")
    (jres,) = jsim.solve_static(cg_precond="two_level_cheb3")
    _compare(res, jres, iterations=False)
    state = psim.scene[0].state
    assert torch.equal(state.pos, res.pos)
    for name in ("vel", "vel_g", "force"):
        assert not getattr(state, name).any(), name
    np.testing.assert_allclose(psim.positions(), jsim.positions(), rtol=0,
                               atol=1e-5)
    # Without gravity the rest state is the equilibrium.
    (res,) = psim.solve_static(gravity=False, index=0)
    assert bool(res.converged)


def test_refusals_match_jax():
    """An unpinned body raises (no unique equilibrium), and so does an
    unknown preconditioner or a two-level solve without the coarse space,
    in both packages."""
    _, jobj, jstate = make_2d_object()
    obj = port_object(jobj)
    pos = torch.as_tensor(np.asarray(jstate.pos))
    with pytest.raises(ValueError, match="pin_boxes"):
        static.solve_static(obj, pos)
    with pytest.raises(ValueError, match="pin_boxes"):
        jstatic.solve_static(jobj, jstate.pos)
    pinned, jpinned, jps = _strip()
    pos = torch.as_tensor(np.asarray(jps.pos))
    with pytest.raises(ValueError, match="cg_precond"):
        static.solve_static(pinned, pos, cg_precond="block_jacobi")
    with pytest.raises(ValueError, match="cg_precond"):
        jstatic.solve_static(jpinned, jps.pos, cg_precond="block_jacobi")
    import dataclasses

    bare = dataclasses.replace(pinned, agg_ids=None, agg_basis=None,
                               num_aggregates=0)
    with pytest.raises(ValueError, match="coarse space"):
        static.solve_static(bare, pos, cg_precond="two_level")
    with pytest.raises(ValueError, match="coarse space"):
        jstatic.solve_static(jpinned.replace(agg_ids=None), jps.pos,
                             cg_precond="two_level")
