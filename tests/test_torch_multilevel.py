# coding=utf-8
"""The two-level preconditioner (``fem_tpu_torch/solvers/multilevel.py``)
against the JAX package's ``solvers/multilevel.py`` on the same numpy
inputs: the aggregates, the coarse matrix (2D and 3D, mesh and block
order, pins, the static form), the static diagonal blocks, the setup and
its Cholesky guard ladder, the PCG in every cycle and smoother, the coarse
space carried through ``convert``, and the semi-implicit substeps with
``cg_precond="two_level"``/``"two_level_cheb3"``.

Tolerances: ``agg_ids`` equal and the basis within 1e-6; the coarse
matrix within 1e-5 of its largest entry; the diagonal blocks and the
setup's pieces (smoother inverse, equilibration, factor, ω, λmax) within
1e-5 (relative to each one's largest entry); the PCG at a small dt with
equal iterations and x within 1e-5, at dt 3.2e-2 both within the
absolute rᵀr ≤ 1e-5 contract, x within 5e-4 and iterations within 2 (the
sums of the power iteration and the factor run in another order, so the
spectral estimate moves by f32 rounding); substeps within 1e-5 in
positions with equal CG iterations (as tests/test_torch_pins.py)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu.ops.element import hessian_blocks as jax_hessian_blocks
from fem_tpu.solvers import implicit as jimplicit
from fem_tpu.solvers import multilevel as jml
from fem_tpu_torch import convert
from fem_tpu_torch.models.state import build_object
from fem_tpu_torch.solvers import implicit, multilevel
from tests.test_torch_pins import (
    PIN_2D,
    PIN_3D,
    assert_states_match,
    bodies,
    configs,
    run_both,
)
from tests.utils import make_2d_object, make_3d_object

torch.set_num_threads(1)


def port_object(jobj):
    """The port's CPU object from a JAX object's arrays (its coarse space
    carried across)."""
    names = convert.OBJECT_ARRAYS + convert.OPTIONAL_OBJECT_ARRAYS
    arrays = {n: None if getattr(jobj, n) is None
              else np.asarray(getattr(jobj, n)) for n in names}
    statics = {n: getattr(jobj, n) for n in convert.OBJECT_STATICS}
    return convert.object_from_arrays(arrays, statics, "cpu")


def _close(got, ref, rel=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def _body(dim):
    """(port object, JAX object, JAX state) of the module's one body per
    dimension (8 subdivisions in 2D, 4 in 3D), built once: each new mesh
    size costs the JAX package a compile of every function it runs."""
    if dim == 2:
        _, jobj, jstate = make_2d_object(subdivisions=8)
    else:
        _, jobj, jstate = make_3d_object(subdivisions=4)
    return port_object(jobj), jobj, jstate


def perturbed_system(dim=2, dt=3.2e-2, seed=0):
    """tests/test_two_level.py's ``_perturbed_system`` in both packages: a
    body at rest with its positions moved by 1e-3 normal noise, its K there
    and a normal rhs b.  Returns (obj, jobj, K (torch), jK, b (numpy),
    dt)."""
    obj, jobj, jstate = _body(dim)
    rng = np.random.default_rng(seed)
    pos = jstate.pos + 0.001 * jnp.asarray(
        rng.standard_normal(jstate.pos.shape), jnp.float32)
    jK = jax_hessian_blocks(pos, jobj.element_indices, jobj.ref_inv,
                            jobj.volume, jobj.mu, jobj.s_lambda)
    b = rng.standard_normal(jstate.pos.shape).astype(np.float32)
    return obj, jobj, torch.as_tensor(np.array(jK)), jK, b, dt


def test_parse_two_level_precond_matches_jax():
    for name in ("two_level", "two_level_cheb", "two_level_cheb2",
                 "two_level_cheb6", "none", "block_jacobi", "reference"):
        assert (multilevel.parse_two_level_precond(name)
                == jml.parse_two_level_precond(name)), name
    for bad in ("two_level_cheb1", "two_level_cheb7"):
        with pytest.raises(ValueError, match="degree"):
            multilevel.parse_two_level_precond(bad)
        with pytest.raises(ValueError, match="degree"):
            jml.parse_two_level_precond(bad)
    assert multilevel.n_rigid_modes(2) == 3 and multilevel.n_rigid_modes(3) == 6
    assert [multilevel.default_aggregate_size(d) for d in (2, 3)] == [
        jml.default_aggregate_size(d) for d in (2, 3)] == [10, 40]


@pytest.mark.parametrize("case", [(2, 537, 10), (3, 537, 40), (3, 1007, 7),
                                  (2, 300, 96), (3, 5, 40)])
def test_build_aggregates_matches_jax(case):
    d, n, size = case
    rng = np.random.default_rng(n + d)
    pos = (0.2 + 0.3 * rng.random((n, d))).astype(np.float32)
    agg, basis = multilevel.build_aggregates(pos, size)
    jagg, jbasis = jml.build_aggregates(pos, size)
    np.testing.assert_array_equal(agg, jagg)
    np.testing.assert_allclose(basis, jbasis, rtol=0, atol=1e-6)
    assert agg.dtype == np.int32 and basis.dtype == np.float32


@pytest.mark.parametrize("dim", [2, 3])
def test_object_carries_the_coarse_space(dim):
    """``build_object`` builds the coarse space for every object, equal to
    the JAX package's; ``convert`` carries the JAX object's across, and
    builds the same when the arrays lack it."""
    pcfg, jcfg = configs(dim)
    (obj, _, _), (jobj, _, _) = bodies(pcfg, jcfg)
    np.testing.assert_array_equal(obj.agg_ids.numpy(),
                                  np.asarray(jobj.agg_ids))
    np.testing.assert_array_equal(obj.agg_basis.numpy(),
                                  np.asarray(jobj.agg_basis))
    assert obj.num_aggregates == jobj.num_aggregates > 1
    arrays, statics = convert.object_to_arrays(obj)
    assert statics["num_aggregates"] == obj.num_aggregates
    for name in ("agg_ids", "agg_basis"):
        arrays.pop(name)
    rebuilt = convert.object_from_arrays(arrays, statics, "cpu")
    assert torch.equal(rebuilt.agg_ids, obj.agg_ids)
    assert torch.equal(rebuilt.agg_basis, obj.agg_basis)
    assert rebuilt.num_aggregates == obj.num_aggregates
    ocfg = pcfg.objects[0]
    from fem_tpu_torch.models import mesh as pmesh

    mesh = (pmesh.construct_2d_mesh(ocfg) if dim == 2
            else pmesh.construct_3d_grid_mesh(ocfg))
    built, _ = build_object(ocfg, *mesh, device="cpu")
    assert torch.equal(built.agg_ids, obj.agg_ids)
    assert torch.equal(built.agg_basis, obj.agg_basis)
    assert built.agg_ids.dtype == torch.int32


@pytest.mark.parametrize("case", [
    ("2D", {}), ("3D", {}), ("3D blocked", {}), ("2D pins", {}),
    ("3D pins blocked", {}), ("2D static", {}), ("3D static", {}),
])
def test_coarse_matrix_matches_jax(case):
    """C on the mesh order and on the block order (padded slots K = 0),
    with the pins' mask, and in the static form (coeff 1, mass 0)."""
    label, _ = case
    dim = 3 if label.startswith("3D") else 2
    obj, jobj, K, jK, _, dt = perturbed_system(dim, dt=8e-3, seed=1)
    free = jfree = None
    if "pins" in label:
        # A band of the body's top vertices pinned.
        pos = np.asarray(jobj.rest_pos)
        band = pos[:, 1] >= pos[:, 1].max() - 0.03
        jfree = jnp.asarray((~band).astype(np.float32)[:, None])
        free = torch.as_tensor(np.asarray(jfree))
        assert 0 < int(band.sum()) < pos.shape[0]
    kw, jkw = {}, {}
    if "static" in label:
        kw = dict(coeff=1.0, mass_vec=torch.zeros_like(obj.mass))
        jkw = dict(coeff=1.0, mass_vec=jnp.zeros_like(jobj.mass))
    coarse = multilevel.make_coarse_space(obj)
    jcoarse = jml.make_coarse_space(jobj)
    if "blocked" in label:
        blk = obj.blocking
        kb = K[blk.element_perm.long()] * (blk.volume > 0)[:, None, None]
        got = multilevel.coarse_matrix(coarse, obj, kb, dt, 2e-3, free,
                                       blk.element_indices, **kw)
        assert blk.num_blocks * blk.eb > obj.element_cnt  # padded slots
    else:
        got = multilevel.coarse_matrix(coarse, obj, K, dt, 2e-3, free, **kw)
    ref = jml.coarse_matrix(jcoarse, jobj, jK, dt, 2e-3, jfree, **jkw)
    g = jobj.num_aggregates * multilevel.n_rigid_modes(dim)
    assert got.shape == (g, g)
    _close(got, ref)
    np.testing.assert_array_equal(got.numpy(), got.numpy().T)


@pytest.mark.parametrize("dim", [2, 3])
def test_static_diag_blocks_matches_jax(dim):
    obj, jobj, K, jK, _, _ = perturbed_system(dim)
    for lam in (0.0, 3.5):
        _close(multilevel.static_diag_blocks(obj, K, lam),
               jml.static_diag_blocks(jobj, jK, jnp.float32(lam)))


def _setups(obj, jobj, K, jK, dt, operator=True):
    """(port setup, JAX setup) of the dynamic system at ``dt``, ω and
    λmax power-iterated on A when ``operator``."""
    coarse = multilevel.make_coarse_space(obj)
    jcoarse = jml.make_coarse_space(jobj)
    c = multilevel.coarse_matrix(coarse, obj, K, dt)
    jc = jml.coarse_matrix(jcoarse, jobj, jK, dt)
    diag = implicit.diagonal_blocks(obj, K, dt)
    jdiag = jimplicit.diagonal_blocks(jobj, jK, dt)
    op = implicit.make_system_apply(obj, K, dt) if operator else None
    jop = jimplicit.make_system_apply(jobj, jK, dt) if operator else None
    return (multilevel.two_level_setup(diag, obj.mass, coarse, c,
                                       operator=op),
            jml.two_level_setup(jdiag, jobj.mass, jcoarse, jc, operator=jop))


@pytest.mark.parametrize("dim", [2, 3])
def test_two_level_setup_matches_jax(dim):
    obj, jobj, K, jK, _, dt = perturbed_system(dim)
    setup, jsetup = _setups(obj, jobj, K, jK, dt)
    for name in ("minv", "basis_t", "dscale", "chol_l", "sq", "omega",
                 "lam_max"):
        _close(getattr(setup, name), getattr(jsetup, name))
    assert bool(setup.chol_ok) and bool(jsetup.chol_ok)
    np.testing.assert_array_equal(setup.agg_ids.numpy(),
                                  np.asarray(jsetup.agg_ids))


def test_cholesky_guard_ladder_matches_jax():
    """The three rungs on C: the plain factor (a healthy C), the
    Gershgorin-shifted factor (C made indefinite) and no coarse correction
    (C with a NaN: no factor exists), with the JAX package's flags and
    factors."""
    obj, jobj, K, jK, _, dt = perturbed_system(2, dt=8e-3)
    coarse = multilevel.make_coarse_space(obj)
    jcoarse = jml.make_coarse_space(jobj)
    c = multilevel.coarse_matrix(coarse, obj, K, dt)
    jc = jml.coarse_matrix(jcoarse, jobj, jK, dt)
    diag = implicit.diagonal_blocks(obj, K, dt)
    jdiag = jimplicit.diagonal_blocks(jobj, jK, dt)
    g = c.shape[0]
    indefinite = np.zeros((g, g), np.float32)
    indefinite[0, 1] = indefinite[1, 0] = 3.0  # a 2×2 minor of det < 0
    nan = np.full((g, g), np.nan, np.float32)
    for label, bump, ok in (("plain", None, True),
                            ("shifted", indefinite, True),
                            ("none", nan, False)):
        cc, jcc = c, jc
        if bump is not None:
            scale = float(np.abs(np.diag(np.asarray(jc))).max())
            cc = c + torch.as_tensor(bump) * scale
            jcc = jc + jnp.asarray(bump) * scale
        setup = multilevel.two_level_setup(diag, obj.mass, coarse, cc)
        jsetup = jml.two_level_setup(jdiag, jobj.mass, jcoarse, jcc)
        assert bool(setup.chol_ok) == bool(jsetup.chol_ok) == ok, label
        if ok:
            _close(setup.chol_l, jsetup.chol_l)
        else:
            np.testing.assert_array_equal(setup.chol_l.numpy(), np.eye(g))
            np.testing.assert_array_equal(np.asarray(jsetup.chol_l),
                                          np.eye(g))
        if label == "shifted":
            # The plain factor of this C fails in both packages.
            _, info = torch.linalg.cholesky_ex(
                cc * setup.dscale[:, None] * setup.dscale[None, :])
            assert int(info) > 0
    # Without a coarse correction the PCG is the smoother's alone, and
    # still converges.
    apply_a = implicit.make_system_apply(obj, K, dt)
    b = torch.ones_like(obj.rest_pos)
    setup = multilevel.two_level_setup(diag, obj.mass, coarse,
                                       c + torch.as_tensor(nan))
    res = multilevel.two_level_pcg(apply_a, None, obj.mass, None, None, b, b,
                                   setup=setup)
    assert float(res.residual) <= 1e-5 and bool(torch.isfinite(res.x).all())


CYCLES = [("multiplicative", "jacobi", 3), ("additive", "jacobi", 3)] + [
    ("multiplicative", "chebyshev", k) for k in range(2, 7)]


@pytest.mark.parametrize("cycle", CYCLES)
def test_two_level_pcg_matches_jax_small_dt(cycle):
    """Every cycle and smoother at dt 2e-3: equal iterations, x within
    1e-5."""
    kind, smoother, degree = cycle
    obj, jobj, K, jK, b, dt = perturbed_system(2, dt=2e-3,
                                               seed=2)
    coarse = multilevel.make_coarse_space(obj)
    jcoarse = jml.make_coarse_space(jobj)
    kw = dict(cycle=kind, smoother=smoother, cheb_degree=degree)
    tb = torch.as_tensor(b)
    res = multilevel.two_level_pcg(
        implicit.make_system_apply(obj, K, dt),
        implicit.diagonal_blocks(obj, K, dt), obj.mass, coarse,
        multilevel.coarse_matrix(coarse, obj, K, dt), tb, tb, **kw)
    jres = jml.two_level_pcg(
        jimplicit.make_system_apply(jobj, jK, dt),
        jimplicit.diagonal_blocks(jobj, jK, dt), jobj.mass, jcoarse,
        jml.coarse_matrix(jcoarse, jobj, jK, dt), jnp.asarray(b),
        jnp.asarray(b), **kw)
    assert int(res.iterations) == int(jres.iterations) > 0
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0,
                               atol=1e-5)
    assert float(res.residual) <= 1e-5


@pytest.mark.parametrize("smoother", [("jacobi", 3), ("chebyshev", 3)])
def test_two_level_pcg_matches_jax_large_dt(smoother):
    """At dt 3.2e-2 (64× the reference dt): both solves meet the absolute
    contract rᵀr ≤ 1e-5, x within 5e-4, iterations within 2 — and far
    below plain CG's."""
    name, degree = smoother
    obj, jobj, K, jK, b, dt = perturbed_system(2)
    coarse = multilevel.make_coarse_space(obj)
    jcoarse = jml.make_coarse_space(jobj)
    tb = torch.as_tensor(b)
    apply_a = implicit.make_system_apply(obj, K, dt)
    res = multilevel.two_level_pcg(
        apply_a, implicit.diagonal_blocks(obj, K, dt), obj.mass, coarse,
        multilevel.coarse_matrix(coarse, obj, K, dt), tb, tb,
        smoother=name, cheb_degree=degree)
    jres = jml.two_level_pcg(
        jimplicit.make_system_apply(jobj, jK, dt),
        jimplicit.diagonal_blocks(jobj, jK, dt), jobj.mass, jcoarse,
        jml.coarse_matrix(jcoarse, jobj, jK, dt), jnp.asarray(b),
        jnp.asarray(b), smoother=name, cheb_degree=degree)
    assert float(res.residual) <= 1e-5 and float(jres.residual) <= 1e-5
    assert abs(int(res.iterations) - int(jres.iterations)) <= 2
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0,
                               atol=5e-4)
    plain = implicit.conjugate_gradient(apply_a, tb, tb)
    assert int(res.iterations) * 3 < int(plain.iterations)


def test_two_level_pcg_with_a_frozen_setup_and_pins():
    """A setup built once (ω hoisted) and reused, on the pin-projected
    operator: the JAX package's iterations and x within 1e-5."""
    obj, jobj, K, jK, b, dt = perturbed_system(2, dt=8e-3,
                                               seed=3)
    pos = np.asarray(jobj.rest_pos)
    band = pos[:, 1] >= pos[:, 1].max() - 0.03
    jfree = jnp.asarray((~band).astype(np.float32)[:, None])
    free = torch.as_tensor(np.asarray(jfree))

    def projected(base, f):
        return lambda w: f * base(f * w) + (1.0 - f) * w

    op = projected(implicit.make_system_apply(obj, K, dt), free)
    jop = projected(jimplicit.make_system_apply(jobj, jK, dt), jfree)
    diag = implicit.diagonal_blocks(obj, K, dt)
    jdiag = jimplicit.diagonal_blocks(jobj, jK, dt)
    f3, jf3 = free[..., None], jfree[..., None]
    diag = f3 * diag + (1.0 - f3) * torch.eye(2)[None]
    jdiag = jf3 * jdiag + (1.0 - jf3) * jnp.eye(2)[None]
    coarse = multilevel.make_coarse_space(obj)
    jcoarse = jml.make_coarse_space(jobj)
    setup = multilevel.two_level_setup(
        diag, obj.mass, coarse,
        multilevel.coarse_matrix(coarse, obj, K, dt, free_mask=free), free,
        operator=op)
    jsetup = jml.two_level_setup(
        jdiag, jobj.mass, jcoarse,
        jml.coarse_matrix(jcoarse, jobj, jK, dt, free_mask=jfree), jfree,
        operator=jop)
    tb = free * torch.as_tensor(b)
    jb = jfree * jnp.asarray(b)
    for smoother in ("jacobi", "chebyshev"):
        res = multilevel.two_level_pcg(
            op, None, obj.mass, None, None, tb, torch.zeros_like(tb),
            free_mask=free, setup=setup, smoother=smoother)
        jres = jml.two_level_pcg(
            jop, None, jobj.mass, None, None, jb, jnp.zeros_like(jb),
            free_mask=jfree, setup=jsetup, smoother=smoother)
        assert int(res.iterations) == int(jres.iterations) > 0, smoother
        np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x),
                                   rtol=0, atol=1e-5)
        assert float(res.x[torch.as_tensor(band)].abs().max()) == 0.0


def test_two_level_pcg_refusals_match_jax():
    obj, jobj, K, jK, b, dt = perturbed_system(2, dt=8e-3)
    tb = torch.as_tensor(b)
    args = (implicit.make_system_apply(obj, K, dt),
            implicit.diagonal_blocks(obj, K, dt), obj.mass,
            multilevel.make_coarse_space(obj), None, tb, tb)
    for kw, match in ((dict(cycle="v"), "cycle"),
                      (dict(smoother="sor"), "smoother"),
                      (dict(cycle="additive", smoother="chebyshev"),
                       "multiplicative")):
        with pytest.raises(ValueError, match=match):
            multilevel.two_level_pcg(*args, **kw)
        with pytest.raises(ValueError, match=match):
            jml.two_level_pcg(None, None, None, None, None, None, None, **kw)


def test_coarse_plans_are_built_once():
    """The segment sums' gather plans are built on the host once for an
    element table and aggregate ids, and again when either changes."""
    obj, _, K, _, _, dt = perturbed_system(2, dt=8e-3)
    coarse = multilevel.make_coarse_space(obj)
    first = multilevel.pair_plan(coarse, obj.element_indices)
    again = multilevel.pair_plan(coarse, obj.element_indices)
    assert first is again
    assert (multilevel.aggregate_plan(coarse)
            is multilevel.aggregate_plan(coarse))
    c1 = multilevel.coarse_matrix(coarse, obj, K, dt)
    c2 = multilevel.coarse_matrix(coarse, obj, K, dt)
    assert torch.equal(c1, c2)
    ids = coarse.agg_ids.clone()
    moved = multilevel.CoarseSpace(ids, coarse.basis, coarse.num_aggregates)
    assert multilevel.pair_plan(moved, obj.element_indices) is not first
    before = multilevel.aggregate_plan(moved)
    ids.add_(0)  # an in-place change: built again
    assert multilevel.aggregate_plan(moved) is not before


@pytest.mark.parametrize("case", [
    (2, dict(cg_precond="two_level"), {}),
    (3, dict(cg_precond="two_level"), {}),
    (3, dict(cg_precond="two_level_cheb3"), dict(pin_boxes=PIN_3D)),
    (2, dict(cg_precond="two_level_cheb3", operator_mode="graph"),
     dict(damping_beta=2e-3)),
    (2, dict(cg_precond="two_level", delta_time=2e-3),
     dict(pin_boxes=PIN_2D)),
])
def test_semi_implicit_two_level_substeps_match_jax(case):
    """Four semi-implicit substeps with the two-level PCG: the blocked
    branch (3D, 2D) and the graph branch, with pins and β, from a
    squashed, moving state."""
    dim, over, obj_over = case
    pcfg, jcfg = configs(dim, obj_over, **over)
    port, jax_side = bodies(pcfg, jcfg, seed=5, squash=1.15)
    state, jstate, its, jits = run_both(pcfg, jcfg, port, jax_side)
    assert_states_match(state, jstate, its, jits)
    assert max(its) > 0


def test_exact_jvp_rejects_two_level():
    """``hessian="exact_jvp"`` assembles no K blocks: the two-level PCG
    raises ``ValueError`` in both packages."""
    from fem_tpu import sim as jsim
    from fem_tpu_torch import sim

    pcfg, jcfg = configs(2, cg_precond="two_level", hessian="exact_jvp")
    (obj, state, obs), (jobj, jstate, jobs) = bodies(pcfg, jcfg, seed=5)
    with pytest.raises(ValueError, match="two_level"):
        sim.substep(obj, state, obs, **sim.substep_kwargs(pcfg))
    with pytest.raises(ValueError, match="two_level"):
        jsim.make_substep_fn(jobj, jcfg)(jstate, jobs)
