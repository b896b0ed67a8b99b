# coding=utf-8
"""M10 through the port on the CPU: the Jacobi solver and the dense
backend against the JAX package on the same numpy inputs.

* the Jacobi plan (``build_jacobi_plan``, and the object's copy rebuilt by
  ``convert``) equal to the JAX package's int for int, and its inverse
  (each slot's contributions in ascending order, in two tiers) equal to
  the slots it inverts;
* ``sparse_system_rows`` and ``assemble_dense_system`` within 1e-6 of the
  largest entry;
* the serial sweeps over the sparse and the dense rows (J1's plain
  version) and the snapshot sweep: equal iterations, x and the carried
  anchor within 1e-5, on the FEM systems and on the JAX package's own
  edge cases (tests/test_implicit.py: the zero diagonal, the rollback);
* the method-0 ``implicit_velocity_solve``, serial and snapshot, with and
  without locality blocks, and without the Jacobi plan (the dense
  fallback), and the dense backend's CG (plain and normal equations) and
  Jacobi solves: equal iterations, velocities within 1e-5;
* ``configs/demo_passage_jacobi.json`` through ``make_frame_fn`` for 10
  frames against the JAX package's: as shipped (the body falls, and both
  take 0 sweeps in every substep) positions, velocities and the anchor
  equal to 1e-5 and iterations equal; from a squashed, moving start (13-17
  sweeps a substep) positions within 1e-5, iterations within 1 a substep:
  the stop test (‖b − A·x‖ ≤ 1e-5, and the rollback's e₁ ≥ e₀) meets
  rounding-level ties that the two packages' orders of summation break
  differently (measured: 1 substep of the 100 serial ones and 2 of the
  snapshot ones differ by one), and the velocities and anchor within 2e-3
  (2e-3 over a 5e-4 substep moves a position by 1e-6, the bound
  tests/test_torch_sim.py uses; measured 1.2e-4 and 1.4e-4);
* the JAX package's refusals: pins, inelastic layers and
  ``hessian="exact_jvp"`` with the Jacobi solver;
* in float64, the serial and snapshot substeps against the oracle of
  tests/oracle.py over 120 substeps, within 5e-9, far inside
  tests/test_oracle_parity.py:63's 5e-4 (the port measures 2.0e-9 with
  either sweep, the gap of the f32 damping decay and gravity)."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu import sim as jsim
from fem_tpu.models.mesh import construct_2d_mesh
from fem_tpu.models.state import Obstacles as JaxObstacles
from fem_tpu.models.state import build_object as jax_build_object
from fem_tpu.ops.assembly import build_jacobi_plan as jax_build_jacobi_plan
from fem_tpu.ops.element import hessian_blocks as jax_hessian_blocks
from fem_tpu.solvers import dense as jdense
from fem_tpu.solvers import implicit as jimplicit
from fem_tpu.utils import config as jconfig
from fem_tpu_torch import convert, sim
from fem_tpu_torch.models import mesh as pmesh
from fem_tpu_torch.models.state import Obstacles, build_object
from fem_tpu_torch.ops import assembly, jacobi_kernels
from fem_tpu_torch.solvers import dense, implicit
from fem_tpu_torch.utils import config as pconfig
from fem_tpu_torch.utils.config import BlockConfig, ObjectConfig
from tests.oracle import Oracle
from tests.utils import make_2d_object, make_3d_object, two_tet_object

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT = 5e-4
TOL = 1e-5


def _t(a):
    return torch.tensor(np.asarray(a))


def _twin(maker, scale, seed=9, **kw):
    """(JAX object, JAX state, port object, port state): the maker's body,
    positions and velocities moved with the same numpy noise."""
    _, jobj, jstate = maker(**kw)
    rng = np.random.default_rng(seed)
    shape = jstate.pos.shape
    pos = (np.asarray(jstate.pos) + rng.normal(scale=scale, size=shape)).astype(
        np.float32)
    vel = rng.normal(scale=0.1, size=shape).astype(np.float32)
    past = rng.normal(scale=0.01, size=shape).astype(np.float32)
    jstate = jstate.replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                            jacobi_past_x=jnp.asarray(past))
    arrays = {n: np.asarray(getattr(jobj, n)) for n in convert.OBJECT_ARRAYS}
    statics = {n: getattr(jobj, n) for n in convert.OBJECT_STATICS}
    obj = convert.object_from_arrays(arrays, statics, "cpu")
    state = convert.state_from_arrays(
        {n: np.asarray(getattr(jstate, n)) for n in convert.STATE_ARRAYS},
        "cpu")
    return jobj, jstate, obj, state


BODIES = {
    "2d": (make_2d_object, 0.004, {}),
    "3d": (make_3d_object, 0.004, dict(subdivisions=3)),
    "two tets": (two_tet_object, 0.03, {}),
}


@pytest.fixture(scope="module", params=sorted(BODIES))
def twin(request):
    maker, scale, kw = BODIES[request.param]
    return _twin(maker, scale, **kw)


def _system(jobj, jstate):
    """K (numpy), the JAX sparse rows and the rhs b of the twin's state."""
    K = jax_hessian_blocks(jstate.pos, jobj.element_indices, jobj.ref_inv,
                           jobj.volume, jobj.mu, jobj.s_lambda)
    b = jimplicit.implicit_rhs(jobj, jstate, DT)
    return np.asarray(K), np.asarray(b)


def _assert_result(res, jres, iterations=True):
    if iterations:
        assert int(res.iterations) == int(jres.iterations)
    top = max(float(np.abs(np.asarray(jres.x)).max()), 1.0)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0,
                               atol=TOL * top)
    np.testing.assert_allclose(res.past_x.numpy(), np.asarray(jres.past_x),
                               rtol=0, atol=TOL * top)


# -- the plan ----------------------------------------------------------------

@pytest.mark.parametrize("maker,kw", [(make_2d_object, {}),
                                      (make_3d_object, dict(subdivisions=3)),
                                      (two_tet_object, {})])
def test_jacobi_plan_matches_jax(maker, kw):
    _, jobj, _ = maker(**kw)
    idx = np.asarray(jobj.element_indices)
    n = jobj.particle_cnt
    for got, want in zip(assembly.build_jacobi_plan(idx, n),
                         jax_build_jacobi_plan(idx, n)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    arrays = {k: np.asarray(getattr(jobj, k)) for k in convert.OBJECT_ARRAYS}
    statics = {k: getattr(jobj, k) for k in convert.OBJECT_STATICS}
    obj = convert.object_from_arrays(arrays, statics, "cpu")
    for name in ("jacobi_nb", "jacobi_slots", "jacobi_coeff"):
        np.testing.assert_array_equal(getattr(obj, name).numpy(),
                                      np.asarray(getattr(jobj, name)))
    # The inverse: every slot's contributions, in ascending order, once.
    slots = obj.jacobi_slots.numpy().reshape(-1)
    g = obj.jacobi_gather
    sentinel = slots.size
    lo = g.lo.numpy()
    per_slot = [list(r[r != sentinel]) for r in lo]
    if g.hi is not None:
        for s, r in zip(g.out.numpy(), g.hi.numpy()):
            per_slot[s] += list(r[r != sentinel])
    assert len(per_slot) == obj.jacobi_nb.numel()
    for s, rows in enumerate(per_slot):
        assert rows == sorted(rows)
        np.testing.assert_array_equal(rows, np.nonzero(slots == s)[0])


def test_tiered_gather_splits_a_tet_mesh_plan():
    """A tet mesh's slot counts are skewed (a self slot sums its
    particle's incident elements, d at once where it is vertex 0): the
    plan of the 5×5×5 grid cube splits in two tiers, and the gather sums
    each slot once."""
    ocfg = ObjectConfig(subdivisions=5, side_length=0.2,
                        center=(0.4, 0.2, 0.4))
    v, f, t = pmesh.construct_3d_grid_mesh(ocfg)
    obj, _ = build_object(ocfg, v, f, t, device="cpu")
    g = obj.jacobi_gather
    assert g.hi is not None and g.hi.shape[1] > g.lo.shape[1]
    rng = np.random.default_rng(0)
    vals = torch.as_tensor(rng.normal(size=(obj.jacobi_slots.numel(), 2)))
    got = assembly.gather_tiered(vals, g).numpy()
    want = np.zeros((obj.jacobi_nb.numel(), 2))
    np.add.at(want, obj.jacobi_slots.numpy().reshape(-1), vals.numpy())
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


# -- the rows and the dense system ------------------------------------------

def test_sparse_rows_and_dense_system_match_jax(twin):
    jobj, jstate, obj, state = twin
    K, _ = _system(jobj, jstate)
    rows = implicit.sparse_system_rows(obj, _t(K), DT).numpy()
    jrows = np.asarray(jimplicit.sparse_system_rows(jobj, jnp.asarray(K), DT))
    top = np.abs(jrows).max()
    np.testing.assert_allclose(rows, jrows, rtol=0, atol=1e-6 * top)
    a = dense.assemble_dense_system(obj, _t(K), DT).numpy()
    ja = np.asarray(jdense.assemble_dense_system(jobj, jnp.asarray(K), DT))
    np.testing.assert_allclose(a, ja, rtol=0, atol=1e-6 * np.abs(ja).max())
    # Without the plan the dense system is the same matrix.
    bare = dataclasses.replace(obj, jacobi_nb=None, jacobi_slots=None,
                               jacobi_coeff=None, jacobi_gather=None)
    np.testing.assert_array_equal(
        dense.assemble_dense_system(bare, _t(K), DT).numpy(), a)


# -- the sweeps --------------------------------------------------------------

def test_serial_and_snapshot_solves_match_jax(twin):
    jobj, jstate, obj, state = twin
    K, b = _system(jobj, jstate)
    past = np.asarray(jstate.jacobi_past_x)
    jrows = jimplicit.sparse_system_rows(jobj, jnp.asarray(K), DT)
    ja = jdense.assemble_dense_system(jobj, jnp.asarray(K), DT)
    rows, a = _t(jrows), _t(ja)
    jres = jimplicit.jacobi_solve_serial_sparse(
        jobj.jacobi_nb, jrows, jnp.asarray(b), jnp.asarray(past))
    res = implicit.jacobi_solve_serial_sparse(obj.jacobi_nb, rows, _t(b),
                                              _t(past))
    assert int(jres.iterations) > 1
    _assert_result(res, jres)
    _assert_result(
        implicit.jacobi_solve_serial(a, _t(b), _t(past)),
        jimplicit.jacobi_solve_serial(ja, jnp.asarray(b), jnp.asarray(past)))
    n, d = b.shape
    jdiag = jimplicit.diagonal_blocks(jobj, jnp.asarray(K), DT)
    jres = jimplicit.jacobi_solve(
        lambda v: (ja @ v.reshape(-1)).reshape(n, d), jdiag, jnp.asarray(b),
        jnp.asarray(past))
    res = implicit.jacobi_solve(lambda v: (a @ v.reshape(-1)).reshape(n, d),
                                _t(jdiag), _t(b), _t(past))
    _assert_result(res, jres)


def _hand_serial_sweep(A, b, x, past, omega=0.75):
    """tests/test_implicit.py's numpy transcription of the reference's
    serial in-place sweep, in float64."""
    n, d = b.shape
    xf = x.reshape(-1).astype(np.float64)
    for i in range(n):
        ax = A[i * d:(i + 1) * d].astype(np.float64) @ xf
        for k in range(d):
            r = i * d + k
            a_ii = A[r, r]
            xf[r] = 0.0 if abs(a_ii) < 1e-6 else (
                omega * (b.reshape(-1)[r] - ax[k] + a_ii * xf[r]) / a_ii
                + (1 - omega) * past.reshape(-1)[r])
    return xf.reshape(n, d)


def test_one_serial_sweep_is_the_reference_sweep():
    """One sweep of the plain J1 (dense and sparse rows) is the hand
    transcription's, and differs from the snapshot sweep."""
    jobj, jstate, obj, state = _twin(make_2d_object, 0.004, 3)
    K, b = _system(jobj, jstate)
    A = np.asarray(jdense.assemble_dense_system(jobj, jnp.asarray(K), DT))
    past = np.asarray(jstate.jacobi_past_x)
    want = _hand_serial_sweep(A, b, 0.5 * b, past)
    rows = implicit.sparse_system_rows(obj, _t(K), DT)
    for res in (jacobi_kernels.jacobi_serial(_t(A), _t(b), _t(past),
                                             max_iter=1),
                jacobi_kernels.jacobi_serial(rows, _t(b), _t(past),
                                             obj.jacobi_nb, max_iter=1)):
        assert int(res.iterations) == 1
        np.testing.assert_allclose(res.x.numpy(), want, rtol=1e-5, atol=1e-6)
    n, d = b.shape
    snap = implicit.jacobi_solve(
        lambda v: (_t(A) @ v.reshape(-1)).reshape(n, d),
        torch.diag_embed(torch.diagonal(_t(A)).reshape(n, d)), _t(b),
        _t(past), max_iter=1)
    assert np.abs(snap.x.numpy() - want).max() > 1e-5


EDGE_CASES = {
    # tests/test_implicit.py:199 and :270: |a_ii| < 1e-6 zeroes that row.
    "zero diagonal": (np.diag([1.0, 1e-9]), [[0.0], [0.0]]),
    # tests/test_implicit.py:375: the first sweeps diverge; rollback.
    "rollback": (np.array([[1.0, 4.0], [5.0, 1.0]]), [[7.0], [9.0]]),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_edge_cases_match_jax(case):
    a_np, past_np = EDGE_CASES[case]
    a_np = a_np.astype(np.float32)
    b_np = np.ones((2, 1), np.float32)
    past_np = np.asarray(past_np, np.float32)
    ja, jb, jp = jnp.asarray(a_np), jnp.asarray(b_np), jnp.asarray(past_np)
    diag_np = np.diag(a_np).reshape(2, 1, 1).copy()
    # One dimension, two particles: the sparse rows hold row i's two
    # neighbours, itself and the other particle, in column order.
    nb = np.array([[0, 1], [0, 1]], np.int32)
    blocks = a_np.reshape(2, 2, 1, 1)
    pairs = (
        (implicit.jacobi_solve_serial(_t(a_np), _t(b_np), _t(past_np)),
         jimplicit.jacobi_solve_serial(ja, jb, jp)),
        (implicit.jacobi_solve_serial_sparse(_t(nb), _t(blocks), _t(b_np),
                                             _t(past_np)),
         jimplicit.jacobi_solve_serial_sparse(jnp.asarray(nb),
                                              jnp.asarray(blocks), jb, jp)),
        (implicit.jacobi_solve(lambda v: _t(a_np) @ v, _t(diag_np),
                               _t(b_np), _t(past_np)),
         jimplicit.jacobi_solve(lambda v: ja @ v, jnp.asarray(diag_np), jb,
                                jp)),
    )
    for res, jres in pairs:
        _assert_result(res, jres)
        assert np.isfinite(res.x.numpy()).all()
        if case == "zero diagonal":
            assert res.x.numpy()[1, 0] == 0.0
            assert 0.7 < res.x.numpy()[0, 0] <= 1.0
        else:
            assert int(res.iterations) < jacobi_kernels.MAX_ITER


# -- the method-0 solve and the dense backend --------------------------------

def _blocked_twin(seed):
    """The 3D grid cube (3 subdivisions: one locality block, 64
    particles), deformed and moving."""
    return _twin(make_3d_object, 0.004, seed, subdivisions=3)


@pytest.mark.parametrize("sweep", ["serial", "snapshot"])
@pytest.mark.parametrize("mode", ["auto", "graph", "no plan"])
@pytest.mark.parametrize("dim", [2, 3])
def test_method0_velocity_solve_matches_jax(sweep, mode, dim):
    jobj, jstate, obj, state = (_blocked_twin(4) if dim == 3
                                else _twin(make_2d_object, 0.004, 4))
    assert obj.blocking is not None and jobj.blocking is not None
    op_mode = "graph" if mode == "graph" else "auto"
    if mode == "no plan":
        obj = dataclasses.replace(obj, jacobi_nb=None, jacobi_slots=None,
                                  jacobi_coeff=None, jacobi_gather=None)
        jobj = jobj.replace(jacobi_nb=None, jacobi_slots=None,
                            jacobi_coeff=None)
    s, aux = implicit.implicit_velocity_solve(
        obj, state, DT, 0, 0, operator_mode=op_mode, jacobi_sweep=sweep)
    js, jaux = jimplicit.implicit_velocity_solve(
        jobj, jstate, DT, 0, 0, operator_mode=op_mode, jacobi_sweep=sweep)
    assert int(jaux.iterations) > 1
    assert int(aux.iterations) == int(jaux.iterations)
    for name in ("vel", "jacobi_past_x"):
        np.testing.assert_allclose(getattr(s, name).numpy(),
                                   np.asarray(getattr(js, name)), rtol=0,
                                   atol=TOL, err_msg=name)
    assert float(aux.residual) == pytest.approx(float(jaux.residual),
                                                rel=0.05)


@pytest.mark.parametrize("method,precond,sweep", [
    (1, 1, "serial"), (1, 0, "serial"), (0, 0, "serial"),
    (0, 0, "snapshot")], ids=["cg-normal", "cg-plain", "jacobi-serial",
                              "jacobi-snapshot"])
def test_dense_backend_matches_jax(method, precond, sweep):
    """tests/test_dense_backend.py:47's solves: the port's dense backend
    against the JAX package's, and the substep's dispatch to it."""
    jobj, jstate, obj, state = _twin(make_2d_object, 0.003, 9)
    s, aux = dense.implicit_velocity_solve_dense(obj, state, DT, method,
                                                 precond, jacobi_sweep=sweep)
    js, jaux = jdense.implicit_velocity_solve_dense(jobj, jstate, DT, method,
                                                    precond,
                                                    jacobi_sweep=sweep)
    assert int(aux.iterations) == int(jaux.iterations) > 0
    np.testing.assert_allclose(s.vel.numpy(), np.asarray(js.vel), rtol=0,
                               atol=TOL)
    if method == 0:
        np.testing.assert_allclose(s.jacobi_past_x.numpy(),
                                   np.asarray(js.jacobi_past_x), rtol=0,
                                   atol=TOL)
    # sim.substep takes the dense backend for solver_backend="dense".
    obs = Obstacles.from_configs((), 2, device="cpu")
    kw = dict(dt=DT, g_dir=(0.0, -1.0), implicit_method=method,
              preconditioned=precond, jacobi_sweep=sweep)
    sd, auxd = sim.substep(obj, state, obs, solver_backend="dense", **kw)
    assert int(auxd.solver_iterations) == int(aux.iterations)


def test_jacobi_refusals_match_jax():
    """Pins, inelastic layers and the exact Hessian with the Jacobi
    solver raise ValueError, as in the JAX package."""
    jobj, jstate, obj, state = _twin(make_2d_object, 0.004, 5)
    n = obj.particle_cnt
    free = np.ones((n, 1), np.float32)
    free[:3] = 0.0
    pinned = dataclasses.replace(obj, free_mask=_t(free))
    jpinned = jobj.replace(free_mask=jnp.asarray(free))
    cases = (
        (lambda: implicit.implicit_velocity_solve(pinned, state, DT, 0, 0),
         lambda: jimplicit.implicit_velocity_solve(jpinned, jstate, DT, 0,
                                                   0), "pin_boxes"),
        (lambda: implicit.implicit_velocity_solve(
            obj, state, DT, 0, 0, hessian="exact_jvp"),
         lambda: jimplicit.implicit_velocity_solve(
             jobj, jstate, DT, 0, 0, hessian="exact_jvp"), "exact_jvp"),
        (lambda: implicit.implicit_velocity_solve(
            obj, state, DT, 0, 0, layers=[(None, obj.mu, obj.s_lambda,
                                           obj.material)]),
         lambda: jimplicit.implicit_velocity_solve(
             jobj, jstate, DT, 0, 0, layers=[(None, jobj.mu, jobj.s_lambda,
                                              jobj.material)] * 2),
         "inelastic"),
    )
    for port_call, jax_call, word in cases:
        with pytest.raises(ValueError, match=word) as got:
            port_call()
        with pytest.raises(ValueError) as want:
            jax_call()
        assert str(got.value) == str(want.value)


# -- the shipped config ------------------------------------------------------

def _passage(sweep, squashed):
    """configs/demo_passage_jacobi.json in both packages; ``squashed``
    moves the start state (numpy seed 3) so that the solve iterates."""
    with open(os.path.join(REPO, "configs", "demo_passage_jacobi.json")) as fh:
        data = dict(json.load(fh), jacobi_sweep=sweep)
    pcfg, jcfg = pconfig.parse_config(data), jconfig.parse_config(data)
    v, f, t = construct_2d_mesh(jcfg.objects[0])
    jobj, jstate = jax_build_object(jcfg.objects[0], v, f, t)
    arrays = {n: np.asarray(getattr(jobj, n)) for n in convert.OBJECT_ARRAYS}
    statics = {n: getattr(jobj, n) for n in convert.OBJECT_STATICS}
    obj = convert.object_from_arrays(arrays, statics, "cpu")
    if squashed:
        rng = np.random.default_rng(3)
        pos = np.asarray(jstate.pos)
        c = pos.mean(axis=0, keepdims=True)
        pos = (c + (pos - c) * np.array([1.1, 0.8])
               + rng.uniform(-0.002, 0.002, pos.shape)).astype(np.float32)
        vel = rng.uniform(-0.3, 0.3, pos.shape).astype(np.float32)
        jstate = jstate.replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel))
    state = convert.state_from_arrays(
        {n: np.asarray(getattr(jstate, n)) for n in convert.STATE_ARRAYS},
        "cpu")
    return (pcfg, jcfg, obj, state, Obstacles.from_configs(pcfg.blocks, 2,
                                                           device="cpu"),
            jobj, jstate, JaxObstacles.from_configs(jcfg.blocks, 2))


@pytest.mark.parametrize("squashed", [False, True],
                         ids=["as shipped", "squashed"])
@pytest.mark.parametrize("sweep", ["serial", "snapshot"])
def test_demo_passage_jacobi_frames_match_jax(sweep, squashed):
    pcfg, jcfg, obj, state, obs, jobj, jstate, jobs = _passage(sweep,
                                                               squashed)
    frame, jframe = sim.make_frame_fn(obj, pcfg), jsim.make_frame_fn(jobj,
                                                                     jcfg)
    vel_tol = 2e-3 if squashed else TOL
    total = 0
    for _ in range(10):
        state, aux = frame(state, obs)
        jstate, jaux = jframe(jstate, jobs)
        np.testing.assert_allclose(state.pos.numpy(), np.asarray(jstate.pos),
                                   rtol=0, atol=TOL)
        for name in ("vel", "vel_g", "jacobi_past_x"):
            np.testing.assert_allclose(
                getattr(state, name).numpy(),
                np.asarray(getattr(jstate, name)), rtol=0, atol=vel_tol,
                err_msg=name)
        got = aux.solver_iterations.numpy()
        want = np.asarray(jaux.solver_iterations)
        assert got.shape == (pcfg.sim_count,)
        if squashed:
            assert np.abs(got - want).max() <= 1, (got, want)
        else:
            np.testing.assert_array_equal(got, want)
        total += int(want.sum())
    assert (total > 1000) == squashed, total


def test_jacobi_past_x_carried_substep_by_substep():
    """The squashed start, 10 substeps (``sim.substep`` against the JAX
    package's ``make_substep_fn``): the anchor each substep carries to the
    next within 1e-4 (measured 2.3e-5), equal iterations."""
    pcfg, jcfg, obj, state, obs, jobj, jstate, jobs = _passage("serial",
                                                               True)
    kw = sim.substep_kwargs(pcfg)
    jstep = jsim.make_substep_fn(jobj, jcfg)
    for _ in range(10):
        past = state.jacobi_past_x
        state, aux = sim.substep(obj, state, obs, **kw)
        jstate, jaux = jstep(jstate, jobs)
        assert not torch.equal(state.jacobi_past_x, past)
        np.testing.assert_allclose(state.jacobi_past_x.numpy(),
                                   np.asarray(jstate.jacobi_past_x), rtol=0,
                                   atol=1e-4)
        assert int(aux.solver_iterations) == int(jaux.solver_iterations)


def test_entry_loads_the_shipped_jacobi_config():
    from fem_tpu_torch import entry

    cfg, obj, state, obs = entry.load_config(
        os.path.join(REPO, "configs", "demo_passage_jacobi.json"), "cpu")
    assert cfg.implicit_method == 0 and obj.jacobi_nb.shape == (121, 7)
    sim.check_supported_config(
        dataclasses.replace(cfg, solver_backend="dense"))
    state, aux = sim.make_frame_fn(obj, cfg)(state, obs)
    assert torch.equal(state.jacobi_past_x, torch.zeros_like(state.pos))
    assert aux.solver_iterations.tolist() == [0] * cfg.sim_count


# -- float64 against the oracle ----------------------------------------------

@pytest.mark.parametrize("sweep", ["serial", "snapshot"])
def test_float64_jacobi_substeps_track_the_oracle(sweep):
    """tests/test_oracle_parity.py:63's scene (3 subdivisions, one circle),
    the port's plain substep in float64 over 120 substeps against
    tests/oracle.py's ``solve_jacobi``: within 5e-9 (that test's bound is
    5e-4; measured 2.0e-9)."""
    ocfg = ObjectConfig(center=(0.45, 0.65), side_length=0.2, subdivisions=3,
                        E=4e4, nu=0.2, damping=14.5, rho=500.0)
    blocks = [((0.55, 0.55), 0.12)]
    v, f, t = pmesh.construct_2d_mesh(ocfg)
    obj, state = build_object(ocfg, v, f, t, device="cpu")
    obj = convert.to_dtype(obj, torch.float64)
    state = convert.to_dtype(state, torch.float64)
    obs = convert.to_dtype(Obstacles.from_configs(
        tuple(BlockConfig(block_center=c, block_radius=r) for c, r in blocks),
        2, device="cpu"), torch.float64)
    oracle = Oracle(state.pos.numpy(), t, ocfg.rho, ocfg.mu, ocfg.s_lambda,
                    ocfg.damping)
    worst, sweeps = 0.0, 0
    for _ in range(120):
        state, aux = sim.substep(obj, state, obs, dt=DT, g_dir=(0.0, -1.0),
                                 implicit_method=0, preconditioned=0,
                                 jacobi_sweep=sweep)
        oracle.step_implicit_jacobi(DT, (0.0, -1.0), blocks, sweep=sweep)
        worst = max(worst, float(np.abs(state.pos.numpy() - oracle.pos).max()))
        sweeps += int(aux.solver_iterations)
    assert state.pos.dtype == torch.float64 and sweeps > 0
    assert worst < 5e-9, worst
