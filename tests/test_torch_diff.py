# coding=utf-8
"""Differentiable rollouts (``fem_tpu_torch/diff.py``, M18) against the JAX
package's ``fem_tpu.diff`` on the same numpy inputs: the explicit and
autodiff substeps and their gradients, the extensions on those methods,
the API, and the implicit solve's pieces — :class:`_GraphApply` and
:class:`_NormalSolve` under ``torch.autograd.gradcheck`` in float64, their
closed-form cotangents against autograd of the plain products, the
deterministic gathers — and the count of G(K)·x products that K3 launches
on the card.  The implicit substeps are in
``tests/test_torch_diff_implicit.py``, the material parameters as tensors
in ``tests/test_torch_diff_materials.py``.

Tolerances: forward positions 1e-6 (explicit and autodiff: the same
arithmetic, sums in another order); gradients 1e-3 relative to the JAX
package's ``jax.grad`` (both in float32: the explicit chain has no solve,
so f32 rounding stays near 1e-6 relative and float64 is not needed);
finite differences of the port itself 5e-2 relative, as
``tests/test_diff.py`` holds the JAX package.  gradcheck runs float64 with
``n_cg_iters`` ≥ 2·N·d, so that the CG has converged and the adjoint of the
converged solve is the exact derivative."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu import diff as jdiff
from fem_tpu_torch import convert, diff
from fem_tpu_torch.models.state import Obstacles
from fem_tpu_torch.ops import assembly, blocked_kernels, element
from fem_tpu_torch.ops import smallmat as sm
from fem_tpu_torch.solvers import advect
from fem_tpu_torch.utils import config as pconfig
from tests.utils import (
    default_obstacles,
    default_sim_config,
    make_2d_object,
    make_3d_object,
)

torch.set_num_threads(1)

EXPLICIT = dict(auto_diff=False, use_explicit_method=True)
AUTODIFF = dict(auto_diff=True, use_explicit_method=False)
IMPLICIT = dict(auto_diff=False, use_explicit_method=False,
                implicit_method=1, preconditioned=1)
METHODS = [pytest.param(EXPLICIT, id="explicit"),
           pytest.param(AUTODIFF, id="autodiff")]


# -- shared fixtures (also tests/test_torch_diff_implicit.py) ----------------

def port_config(jcfg):
    """The port's SimConfig with the JAX config's fields (bodies and
    obstacles cross separately)."""
    names = {f.name for f in dataclasses.fields(pconfig.SimConfig)}
    return pconfig.SimConfig(**{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
        if f.name in names and f.name not in ("objects", "blocks",
                                              "obstacles")})


def port_body(jobj, jstate):
    """(obj, state) of the port on the CPU from the JAX package's arrays."""
    names = convert.OBJECT_ARRAYS + convert.OPTIONAL_OBJECT_ARRAYS
    arrays = {n: None if getattr(jobj, n) is None
              else np.asarray(getattr(jobj, n)) for n in names}
    statics = {n: getattr(jobj, n) for n in convert.OBJECT_STATICS}
    obj = convert.object_from_arrays(arrays, statics, "cpu")
    state = convert.state_from_arrays(
        {n: np.asarray(getattr(jstate, n))
         for n in convert.STATE_ARRAYS + convert.INTERNAL_ARRAYS
         if getattr(jstate, n, None) is not None}, "cpu")
    return obj, state


def port_obstacles(jobs):
    return Obstacles(torch.tensor(np.asarray(jobs.centers)),
                     torch.tensor(np.asarray(jobs.radii)))


def squashed(jstate, scale=(1.25, 1.1, 0.85)):
    """``tests/test_diff.py``'s ``_squashed``: a volume-changing deformation
    about the centroid, so that μ and λ carry signal from the first step."""
    pos = np.asarray(jstate.pos)
    c = pos.mean(axis=0, keepdims=True)
    s = np.asarray(scale[:pos.shape[1]], np.float32)[None, :]
    return jstate.replace(pos=jnp.asarray((c + (pos - c) * s)
                                          .astype(np.float32)))


def case(dim=2, subdivisions=3, scale=(1.25, 1.1, 0.85), jobj_fn=None,
         **mat):
    """((obj, state, obstacles) of the port, the same of the JAX package)
    on a squashed 2D square or 3D cube."""
    if dim == 2:
        _, jobj, jstate = make_2d_object(subdivisions=subdivisions, **mat)
        jobs = default_obstacles()
    else:
        _, jobj, jstate = make_3d_object(subdivisions=subdivisions, **mat)
        from fem_tpu.models.state import Obstacles as JaxObstacles
        jobs = JaxObstacles.from_configs((), 3)
    if jobj_fn is not None:
        jobj = jobj_fn(jobj)
    jstate = squashed(jstate, scale)
    obj, state = port_body(jobj, jstate)
    return (obj, state, port_obstacles(jobs)), (jobj, jstate, jobs)


def tensors(values, requires_grad=True):
    return [torch.tensor(float(v), dtype=torch.float32,
                         requires_grad=requires_grad) for v in values]


def port_loss(obj, cfg, state, obs, n_steps, params, n_cg_iters=32,
              remat=True):
    """``tests/test_diff.py``'s ``_loss_at`` functional through the port."""
    final, traj = diff.make_diff_rollout_fn(obj, cfg, n_steps, n_cg_iters,
                                            remat)(params, state, obs)
    return torch.mean(traj ** 2) + torch.mean(final.vel ** 2)


def jax_loss(jobj, jcfg, jstate, jobs, n_steps, params, n_cg_iters=32):
    final, traj = jdiff.make_diff_rollout_fn(jobj, jcfg, n_steps,
                                             n_cg_iters)(params, jstate, jobs)
    return jnp.mean(traj ** 2) + jnp.mean(final.vel ** 2)


def grads_both(port, jax_side, cfg_kwargs, n_steps, n_cg_iters=32,
               yield_strain=None):
    """((loss, grads) of the port, the same of the JAX package) of the
    ``_loss_at`` functional with respect to μ, λ, damping (and the yield
    strain when given) at the object's values."""
    obj, state, obs = port
    jobj, jstate, jobs = jax_side
    jcfg = default_sim_config(**cfg_kwargs) if obj.dim == 2 else \
        _cfg_3d(**cfg_kwargs)
    values = [jobj.mu, jobj.s_lambda, jobj.damping]
    if yield_strain is not None:
        values.append(yield_strain)
    ts = tensors(values)
    params = diff.DiffParams(*ts[:3], plastic_yield=(
        ts[3] if yield_strain is not None else None))
    loss = port_loss(obj, port_config(jcfg), state, obs, n_steps, params,
                     n_cg_iters)
    got = torch.autograd.grad(loss, ts)

    def jloss(*vals):
        p = jdiff.DiffParams(*vals[:3], plastic_yield=(
            vals[3] if yield_strain is not None else None))
        return jax_loss(jobj, jcfg, jstate, jobs, n_steps, p, n_cg_iters)

    jv, jg = jax.value_and_grad(jloss, argnums=tuple(range(len(values))))(
        *[jnp.float32(v) for v in values])
    return ((float(loss), [float(g) for g in got]),
            (float(jv), [float(g) for g in jg]))


def _cfg_3d(**kw):
    from tests.utils import default_sim_config_3d

    return default_sim_config_3d(**kw)


def assert_grads_match(port_res, jax_res, rel=1e-3):
    (loss, got), (jloss, ref) = port_res, jax_res
    assert loss == pytest.approx(jloss, rel=1e-5)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert abs(r) > 0.0, i
        assert g == pytest.approx(r, rel=rel), (i, got, ref)


def states_close(state, jstate, atol):
    np.testing.assert_allclose(state.pos.detach().numpy(),
                               np.asarray(jstate.pos), rtol=0, atol=atol)
    np.testing.assert_allclose(state.vel.detach().numpy(),
                               np.asarray(jstate.vel), rtol=0,
                               atol=100 * atol)


# -- the element functions with tensor parameters ---------------------------

def test_damping_decay_tensor():
    d = torch.tensor(14.5, requires_grad=True)
    decay = advect.damping_decay(5e-4, d)
    assert decay.dtype == torch.float32 and decay.dim() == 0
    # As the JAX package traces it: dt·damping in float32, then exp.
    ref = float(jnp.exp(-5e-4 * jnp.float32(14.5)))
    assert float(decay) == pytest.approx(ref, rel=2e-7)
    (g,) = torch.autograd.grad(decay, d)
    assert float(g) == pytest.approx(-5e-4 * float(decay), rel=1e-6)
    (obj, state, obs), _ = case(dim=2, subdivisions=2)
    with pytest.raises(ValueError, match="tensor decay"):
        advect.kinematic_step(state, torch.zeros_like(state.pos), obj.mass,
                              obs, 5e-4, decay, torch.zeros(2),
                              backend="pallas")
    with pytest.raises(ValueError, match="tensor decay"):
        advect.advect_implicit_step(state, obs, 5e-4, decay, torch.zeros(2),
                                    backend="pallas")


def test_sym_eigh_gradients_stay_finite():
    """The Jacobi rotation's closed-form derivative: gradcheck of the
    eigenpairs in float64, the forward unchanged, and a finite gradient
    where a_pq is tiny and a_pp = a_qq (autograd of τ = δ/2a_pq gives NaN
    there)."""
    rng = np.random.default_rng(4)
    for d in (2, 3):
        m = torch.tensor(rng.normal(size=(16, d, d)))
        m = (m + m.mT).requires_grad_(True)
        assert torch.autograd.gradcheck(
            lambda m: sm.sym_eigh(m)[0], (m,))
        w, v = sm.sym_eigh(m)
        w0, v0 = sm.sym_eigh(m.detach())
        assert torch.equal(w.detach(), w0) and torch.equal(v.detach(), v0)
    m = torch.tensor([[[1.0, 1e-22], [1e-22, 1.0]]], requires_grad=True)
    w, _ = sm.sym_eigh(m)
    (g,) = torch.autograd.grad(torch.sum(w * torch.tensor([1.0, 2.0])), m)
    assert bool(torch.isfinite(g).all())


# -- the deterministic gathers -----------------------------------------------

def test_gather_rows_is_the_index_and_its_transposes():
    """gather_rows/assemble_rows against autograd of plain indexing and of
    gather_assemble: first and second derivatives."""
    (obj, state, _), _ = case(dim=3, subdivisions=2)
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.normal(size=(obj.particle_cnt, 3)),
                     dtype=torch.float64, requires_grad=True)
    w = torch.tensor(rng.normal(size=(obj.element_cnt, 4, 3)),
                     dtype=torch.float64)
    idx, plan = obj.element_indices, obj.plan

    def f_ours(x):
        return torch.sum(torch.sin(assembly.gather_rows(x, idx, plan)) * w)

    def f_plain(x):
        return torch.sum(torch.sin(x[idx.long()]) * w)

    for f in (f_ours, f_plain):
        (g,) = torch.autograd.grad(f(x), x, create_graph=True)
        (h,) = torch.autograd.grad(torch.sum(g * g), x)
        if f is f_ours:
            g0, h0 = g.detach(), h
        else:
            torch.testing.assert_close(g0, g.detach(), rtol=1e-12,
                                       atol=1e-12)
            torch.testing.assert_close(h0, h, rtol=1e-12, atol=1e-12)
    c = torch.tensor(rng.normal(size=(obj.element_cnt, 4, 3)),
                     dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda c: assembly.assemble_rows(c, idx, plan), (c,))
    assert torch.autograd.gradgradcheck(
        lambda c: assembly.assemble_rows(c, idx, plan) ** 2, (c,))
    torch.testing.assert_close(
        assembly.assemble_rows(c, idx, plan),
        assembly.gather_assemble(c, plan.idx), rtol=0, atol=0)


# -- the products and the solve ----------------------------------------------

def _solve_case(blocks=True, pins=False):
    """(obj, the 2D graph, mesh-order K (E, 2, 2) f64, (N, 2) f64 vectors,
    the system) on a 9-particle square, K of a squashed state scaled so
    that A is far from I (AᵀA of condition ~1e4) while the float64 CG
    still converges to ~1e-12."""
    _, jax_side = case(dim=2, subdivisions=2)
    over = dict(pin_boxes=(((0.0, 0.0), (1.0, 0.71)),)) if pins else {}
    (obj, state, _), _ = case(dim=2, subdivisions=2, **over)
    if not blocks:
        obj = dataclasses.replace(obj, blocking=None)
    graph = diff._Graph(obj)
    K = element.hessian_blocks(state.pos, obj.element_indices, obj.ref_inv,
                               obj.volume, obj.mu, obj.s_lambda).double()
    rng = np.random.default_rng(3)
    vecs = [torch.tensor(rng.normal(size=(obj.particle_cnt, 2)))
            for _ in range(3)]
    system = diff._System(graph, obj.mass.double(),
                          None if obj.free_mask is None
                          else obj.free_mask.double(), 5e-4)
    return obj, graph, K, vecs, system


@pytest.mark.parametrize("blocks", [True, False], ids=["blocks", "mesh"])
@pytest.mark.parametrize("transpose", [False, True], ids=["K", "KT"])
def test_graph_apply_gradcheck(blocks, transpose):
    obj, graph, K, (x, _, _), _ = _solve_case(blocks)
    K.requires_grad_(True)
    x.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda K, x: diff._GraphApply.apply(graph.place(K), x, graph,
                                            transpose), (K, x))


@pytest.mark.parametrize("blocks", [True, False], ids=["blocks", "mesh"])
def test_graph_cotangent_matches_autograd_of_plain_apply(blocks):
    """K̄ = U_e·X_eᵀ in K's order (padded block slots 0) against autograd of
    the plain product, both transposes."""
    obj, graph, K, (x, u, _), _ = _solve_case(blocks)
    Kb = graph.place(K).requires_grad_(True)
    for transpose in (False, True):
        (ref,) = torch.autograd.grad(torch.sum(u * graph(Kb, x, transpose)),
                                     Kb)
        got = (graph.k_cotangent(x, u) if transpose
               else graph.k_cotangent(u, x))
        torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("pins", [False, True], ids=["free", "pinned"])
@pytest.mark.parametrize("blocks", [True, False], ids=["blocks", "mesh"])
def test_normal_solve_gradcheck(blocks, pins):
    """The solve Function in float64 with n_cg_iters = 2·N·d + 4: the
    adjoint of the converged solve is the exact derivative."""
    obj, graph, K, (rhs, _, _), system = _solve_case(blocks, pins)
    n_iters = 2 * obj.particle_cnt * 2 + 4
    K.requires_grad_(True)
    rhs.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda K, rhs: diff._NormalSolve.apply(graph.place(K), rhs, system,
                                               n_iters), (K, rhs))


@pytest.mark.parametrize("pins", [False, True], ids=["free", "pinned"])
def test_solve_cotangent_matches_autograd(pins):
    """∂⟨−λ, AᵀA·x⟩/∂K in closed form (through c, M⁻¹ and the projection)
    against autograd of the plain normal operator."""
    obj, graph, K, (x, lam, _), system = _solve_case(True, pins)
    Kb = graph.place(K).requires_grad_(True)
    (ref,) = torch.autograd.grad(torch.sum(-lam * system.normal(Kb)(x)), Kb)
    got = system.k_cotangent(Kb.detach(), x, lam)
    torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-12)


def test_cg_fixed_dead_direction_is_a_no_op():
    """A converged CG (dᵀq = 0) keeps its x: no NaN from 0/0."""
    b = torch.ones(4, 2)
    x = diff._cg_fixed(lambda v: v, b, 5)
    assert torch.equal(x, b)
    x = diff._cg_fixed(lambda v: 2.0 * v, b, 3)
    torch.testing.assert_close(x, 0.5 * b)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "stored"])
def test_graph_product_count(monkeypatch, remat):
    """Every G(K)·x of an implicit rollout and its backward goes through
    ``blocked_kernels.blocked_graph_apply`` (K3 on the card), as many as
    ``implicit_graph_products`` predicts; the forward alone likewise."""
    calls = []
    real = blocked_kernels.blocked_graph_apply

    def counted(*a, **k):
        calls.append(a[3] if len(a) > 3 else k.get("transpose_k", False))
        return real(*a, **k)

    monkeypatch.setattr(blocked_kernels, "blocked_graph_apply", counted)
    for pins in (False, True):
        over = dict(pin_boxes=(((0.0, 0.0), (1.0, 0.71), (0.0, 0.1)),)) \
            if pins else {}
        (obj, state, obs), _ = case(dim=2, subdivisions=2, **over)
        assert (obj.pin_vel is not None) == pins
        cfg = port_config(default_sim_config(**IMPLICIT))
        params = diff.DiffParams(*tensors([obj.mu, obj.s_lambda,
                                           obj.damping]))
        v0 = state.vel.clone().requires_grad_(True)
        calls.clear()
        final, traj = diff.make_diff_rollout_fn(obj, cfg, 3, 5, remat)(
            params, state.replace(vel=v0), obs)
        assert len(calls) == diff.implicit_graph_products(
            obj, 3, 5, remat, backward=False)
        torch.sum(traj ** 2).backward()
        assert len(calls) == diff.implicit_graph_products(obj, 3, 5, remat)
        assert True in calls and False in calls
        assert params.mu.grad is not None and v0.grad is not None


# -- explicit and autodiff against the JAX package ----------------------------

@pytest.mark.parametrize("cfg_kwargs", METHODS)
def test_forward_matches_jax(cfg_kwargs):
    (obj, state, obs), (jobj, jstate, jobs) = case(subdivisions=4)
    jcfg = default_sim_config(**cfg_kwargs)
    sub = diff.make_diff_substep_fn(obj, port_config(jcfg))
    jsub = jax.jit(jdiff.make_diff_substep_fn(jobj, jcfg))
    params = diff.params_from_object(obj)
    jparams = jdiff.params_from_object(jobj)
    for _ in range(20):
        state = sub(params, state, obs)
        jstate = jsub(jparams, jstate, jobs)
    states_close(state, jstate, 1e-6)


@pytest.mark.parametrize("cfg_kwargs", METHODS)
def test_grads_match_jax(cfg_kwargs):
    port, jax_side = case()
    assert_grads_match(*grads_both(port, jax_side, cfg_kwargs, 12))


@pytest.mark.parametrize("cfg_kwargs", METHODS)
def test_grads_match_fd(cfg_kwargs):
    """Central differences of the port's own functional, relative steps
    sized for f32 (tests/test_diff.py:63-94)."""
    (obj, state, obs), _ = case()
    cfg = port_config(default_sim_config(**cfg_kwargs))
    base = [obj.mu, obj.s_lambda, obj.damping]

    def loss(vals, grad=False):
        return port_loss(obj, cfg, state, obs, 12,
                         diff.DiffParams(*tensors(vals, grad)))

    ts = tensors(base)
    got = torch.autograd.grad(port_loss(obj, cfg, state, obs, 12,
                                        diff.DiffParams(*ts)), ts)
    with torch.no_grad():
        for i in (0, 1):
            eps = 1e-3 * base[i]
            hi, lo = list(base), list(base)
            hi[i] += eps
            lo[i] -= eps
            fd = (float(loss(hi)) - float(loss(lo))) / (2 * eps)
            assert abs(float(got[i])) > 0.0
            assert float(got[i]) == pytest.approx(fd, rel=5e-2, abs=1e-12)


def test_grad_wrt_initial_state():
    """The initial velocity is an ordinary tensor of the rollout: its
    gradient against jax.grad and a central difference."""
    (obj, state, obs), (jobj, jstate, jobs) = case(subdivisions=2,
                                                   scale=(1, 1, 1))
    jcfg = default_sim_config(**EXPLICIT)
    rollout = diff.make_diff_rollout_fn(obj, port_config(jcfg), 10)
    jrollout = jdiff.make_diff_rollout_fn(jobj, jcfg, 10)
    params, jparams = diff.params_from_object(obj), \
        jdiff.params_from_object(jobj)

    def loss(v0):
        final, _ = rollout(params, state.replace(vel=v0), obs)
        return torch.mean(final.pos ** 2)

    v0 = torch.zeros_like(state.vel).requires_grad_(True)
    (g,) = torch.autograd.grad(loss(v0), v0)
    jg = jax.grad(lambda v: jnp.mean(
        jrollout(jparams, jstate.replace(vel=v), jobs)[0].pos ** 2))(
            jnp.zeros_like(jstate.vel))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-3 * float(jnp.abs(jg).max()))
    # A step of 1e-2 m/s: at 1e-3 the float32 loss (~0.5) resolves the
    # difference (~8e-7) to a few per cent only; the rollout is smooth in v0.
    e = torch.zeros_like(v0)
    e[3, 1] = 1.0
    with torch.no_grad():
        fd = (float(loss(1e-2 * e)) - float(loss(-1e-2 * e))) / 2e-2
    assert float(g[3, 1]) == pytest.approx(fd, rel=5e-2, abs=1e-10)


def test_plastic_explicit_grads():
    """The traced yield strain through the return map, explicit: gradients
    of μ and ε_y against jax.grad and central differences (rel 8e-2, as
    tests/test_diff.py's plastic test)."""
    port, jax_side = case(plastic_yield=0.05, scale=(1.35, 0.75))
    res = grads_both(port, jax_side, EXPLICIT, 10, yield_strain=0.05)
    assert_grads_match(*res)
    obj, state, obs = port
    cfg = port_config(default_sim_config(**EXPLICIT))

    def loss(mu, y):
        return float(port_loss(obj, cfg, state, obs, 10, diff.DiffParams(
            *tensors([mu, obj.s_lambda, obj.damping], False),
            plastic_yield=torch.tensor(y))))

    with torch.no_grad():
        fd_mu = (loss(obj.mu * 1.001, 0.05) - loss(obj.mu * 0.999, 0.05)) \
            / (2e-3 * obj.mu)
        fd_y = (loss(obj.mu, 0.051) - loss(obj.mu, 0.049)) / 2e-3
    assert res[0][1][0] == pytest.approx(fd_mu, rel=8e-2, abs=1e-10)
    assert res[0][1][3] == pytest.approx(fd_y, rel=8e-2, abs=1e-10)


def test_maxwell_explicit_matches_jax():
    """The Maxwell branch: positions and F_v⁻¹ after 8 substeps, and the
    gradients, against the JAX package."""
    port, jax_side = case(viscous_mu=2e4, viscous_tau=0.01,
                          scale=(1.2, 0.85))
    (obj, state, obs), (jobj, jstate, jobs) = port, jax_side
    jcfg = default_sim_config(**EXPLICIT)
    sub = diff.make_diff_substep_fn(obj, port_config(jcfg))
    jsub = jax.jit(jdiff.make_diff_substep_fn(jobj, jcfg))
    params, jparams = diff.params_from_object(obj), \
        jdiff.params_from_object(jobj)
    for _ in range(8):
        state = sub(params, state, obs)
        jstate = jsub(jparams, jstate, jobs)
    states_close(state, jstate, 1e-6)
    np.testing.assert_allclose(state.viscous_inv.numpy(),
                               np.asarray(jstate.viscous_inv), atol=1e-6)
    assert_grads_match(*grads_both(port, jax_side, EXPLICIT, 8))


@pytest.mark.parametrize("cfg_kwargs", METHODS)
def test_pins_loads_rayleigh_match_jax(cfg_kwargs):
    """Moving pins, a static load and Rayleigh β (through _GraphApply) on
    the explicit and autodiff methods: forward and gradients."""
    over = dict(pin_boxes=(((0.0, 0.0), (1.0, 0.71), (0.0, 0.1)),),
                load_boxes=(((0.0, 0.75), (1.0, 1.0), (0.5, -2.0)),),
                damping_beta=2e-3)
    port, jax_side = case(**over)
    (obj, state, obs), (jobj, jstate, jobs) = port, jax_side
    assert obj.pin_vel is not None and obj.static_load is not None
    jcfg = default_sim_config(**cfg_kwargs)
    sub = diff.make_diff_substep_fn(obj, port_config(jcfg))
    jsub = jax.jit(jdiff.make_diff_substep_fn(jobj, jcfg))
    params, jparams = diff.params_from_object(obj), \
        jdiff.params_from_object(jobj)
    for _ in range(10):
        state = sub(params, state, obs)
        jstate = jsub(jparams, jstate, jobs)
    states_close(state, jstate, 1e-6)
    assert_grads_match(*grads_both(port, jax_side, cfg_kwargs, 8))


@pytest.mark.parametrize("cfg_kwargs", METHODS)
def test_remat_on_and_off_agree(cfg_kwargs):
    (obj, state, obs), _ = case(subdivisions=2)
    cfg = port_config(default_sim_config(**cfg_kwargs))
    out = []
    for remat in (True, False):
        ts = tensors([obj.mu, obj.s_lambda, obj.damping])
        loss = port_loss(obj, cfg, state, obs, 6, diff.DiffParams(*ts),
                         remat=remat)
        out.append((loss.detach(), torch.autograd.grad(loss, ts)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


# -- the API -------------------------------------------------------------------

def test_params_and_lame():
    (obj, _, _), (jobj, _, _) = case(subdivisions=2, plastic_yield=0.05)
    p, jp = diff.params_from_object(obj), jdiff.params_from_object(jobj)
    for a, b in zip(p, jp):
        assert a.dtype == torch.float32 and a.dim() == 0
        assert float(a) == float(b)
    assert diff.params_from_object(
        dataclasses.replace(obj, plastic_yield=0.0)).plastic_yield is None
    E, nu = torch.tensor(4e4, requires_grad=True), 0.2
    mu, lam = diff.lame_from_young(E, nu)
    jmu, jlam = jdiff.lame_from_young(jnp.float32(4e4), nu)
    assert float(mu) == float(jmu) and float(lam) == float(jlam)
    (g,) = torch.autograd.grad(mu + lam, E)
    assert float(g) == pytest.approx(1 / 2.4 + 0.2 / 1.2 / 0.6, rel=1e-6)


def test_refusals_and_inelastic_acceptance():
    (obj, _, _), _ = case(subdivisions=2)
    with pytest.raises(ValueError, match="Jacobi"):
        diff.make_diff_substep_fn(obj, port_config(default_sim_config(
            auto_diff=False, use_explicit_method=False, implicit_method=0)))
    with pytest.raises(ValueError, match="semi_implicit"):
        diff.make_diff_substep_fn(obj, port_config(default_sim_config(
            **IMPLICIT, integrator="newton")))
    # Inelastic objects are accepted on every method, as in the JAX package
    # (its tests/test_inelastic.py::test_loud_gates still expects a refusal:
    # ROADMAP F1).
    (pobj, _, _), _ = case(subdivisions=2, plastic_yield=0.05,
                           viscous_mu=2e4)
    for kw in (EXPLICIT, AUTODIFF, IMPLICIT):
        assert callable(diff.make_diff_substep_fn(
            pobj, port_config(default_sim_config(**kw))))


def test_trajectory_loss_fn_api():
    (obj, state, obs), _ = case(subdivisions=2, scale=(1, 1, 1))
    cfg = port_config(default_sim_config(**EXPLICIT))
    params = diff.params_from_object(obj)
    _, target = diff.make_diff_rollout_fn(obj, cfg, 5)(params, state, obs)
    loss_fn = diff.trajectory_loss_fn(obj, cfg, target)
    ts = tensors([obj.mu, obj.s_lambda, obj.damping])
    loss = loss_fn(diff.DiffParams(*ts), state, obs)
    assert float(loss) == 0.0
    g = torch.autograd.grad(loss, ts)
    assert all(bool(torch.isfinite(x)) for x in g)


def test_per_member_param_gradients():
    """tests/test_diff.py's vmapped gradients, member by member in a loop:
    each equal to jax.vmap's, the base member to the unbatched gradient."""
    (obj, state, obs), (jobj, jstate, jobs) = case(subdivisions=2)
    jcfg = default_sim_config(**EXPLICIT)
    rollout = diff.make_diff_rollout_fn(obj, port_config(jcfg), 8)
    jrollout = jdiff.make_diff_rollout_fn(jobj, jcfg, 8)
    base = jdiff.params_from_object(jobj)

    def jloss(p):
        return jnp.mean(jrollout(p, jstate, jobs)[1] ** 2)

    scales = jnp.asarray([0.5, 1.0, 2.0], jnp.float32)
    batch = jdiff.DiffParams(
        mu=base.mu * scales, s_lambda=base.s_lambda * scales,
        damping=jnp.broadcast_to(base.damping, scales.shape))
    jvals, jgrads = jax.vmap(jax.value_and_grad(jloss))(batch)
    got = []
    for i in range(3):
        ts = tensors([float(batch.mu[i]), float(batch.s_lambda[i]),
                      float(batch.damping[i])])
        val = torch.mean(rollout(diff.DiffParams(*ts), state, obs)[1] ** 2)
        g = torch.autograd.grad(val, ts)
        assert float(val) == pytest.approx(float(jvals[i]), rel=1e-5)
        for j, name in enumerate(("mu", "s_lambda", "damping")):
            assert float(g[j]) == pytest.approx(
                float(getattr(jgrads, name)[i]), rel=1e-3), (i, name)
        got.append(float(g[0]))
    single = diff.params_from_object(obj)
    mu = single.mu.requires_grad_(True)
    (g1,) = torch.autograd.grad(torch.mean(rollout(
        single._replace(mu=mu), state, obs)[1] ** 2), mu)
    assert got[1] == pytest.approx(float(g1), rel=1e-6)
    assert got[0] != got[2]


def test_inverse_material_descends():
    """Five Adam steps on log E from a 2× wrong guess, as
    examples/inverse_material.py takes them: the loss falls."""
    (obj, state, obs), _ = case()
    cfg = port_config(default_sim_config(**EXPLICIT))
    rollout = diff.make_diff_rollout_fn(obj, cfg, 12)
    damping = torch.tensor(obj.damping)

    def traj(log_e):
        mu, lam = diff.lame_from_young(torch.exp(log_e), 0.2)
        return rollout(diff.DiffParams(mu, lam, damping), state, obs)[1]

    with torch.no_grad():
        target = traj(torch.log(torch.tensor(4e4)))
    log_e = torch.log(torch.tensor(8e4)).requires_grad_(True)
    opt = torch.optim.Adam([log_e], lr=0.1)
    losses = []
    for _ in range(5):
        opt.zero_grad()
        loss = torch.mean((traj(log_e) - target) ** 2) * 1e6
        loss.backward()
        opt.step()
        losses.append(float(loss))
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    assert float(torch.exp(log_e)) < 8e4
