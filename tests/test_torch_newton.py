# coding=utf-8
"""The Newton integrator (``fem_tpu_torch/solvers/newton.py``, the
``integrator="newton"`` substep and frame) against the JAX package's
``solvers/newton.py`` and ``sim.py`` on the same numpy inputs: the exact
and decoupled Jacobians, θ = 1 and 0.5, Rayleigh β, pins with
``pin_vel``, a plastic and a Maxwell layer, an external force, the plain
CG, block-Jacobi, ``two_level`` and ``two_level_cheb3`` inner solves;
the refusals; and the contact frame, the adaptive-dt guard, the batched
frame and the CLI around a Newton substep.

Tolerances: in the stable regime (dt 5e-4) positions within 1e-5 and
the inner CG totals within 3 a substep.  The totals are not held equal:
the Newton loop stops at ‖P·r‖∞ ≤ 1e-5, which on these stiff bodies is a
few times the f32 rounding floor of the assembled force, so whether a
last step is taken, or a trial accepted, rests on rounding, and the two
packages sum in different orders (the blocked assembly, the two-level
setup's power iteration and factor, the exact Hessian's per-element
Jacobians); positions stay within 1e-5 all the same.  K2's plain version
(``element_backend="pallas"``), which sums the material layers after
the assembly where the JAX package's XLA route sums them before, is held
alike.  The κ ≫ 1 runs are tests/test_torch_newton_large_dt.py's."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu import sim as jsim
from fem_tpu.solvers import newton as jnewton
from fem_tpu_torch import sim
from fem_tpu_torch.solvers import newton
from tests.test_torch_pins import (
    MOVING_3D,
    PIN_2D,
    PIN_3D,
    LOAD_2D,
    bodies,
    configs,
    run_both,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEWTON = dict(integrator="newton")
DECOUPLED = dict(integrator="newton", newton_hessian="decoupled")


def _states_close(state, jstate, tol=1e-5):
    np.testing.assert_allclose(state.pos.numpy(), np.asarray(jstate.pos),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(
        state.vel.numpy() + state.vel_g.numpy(),
        np.asarray(jstate.vel) + np.asarray(jstate.vel_g), rtol=0,
        atol=2e-3)


def _iterations_match(its, jits):
    assert all(abs(a - b) <= 3 for a, b in zip(its, jits)), (its, jits)


# (dimension, config overrides, object overrides).
CASES = [
    (2, DECOUPLED, {}),
    (3, DECOUPLED, {}),
    (2, NEWTON, {}),
    (3, dict(NEWTON, newton_theta=0.5), {}),
    (3, dict(DECOUPLED, newton_theta=0.5), dict(damping_beta=2e-3)),
    (2, dict(DECOUPLED, cg_precond="block_jacobi"),
     dict(plastic_yield=0.01, viscous_mu=2e4)),
    (3, dict(NEWTON, newton_theta=0.5),
     dict(plastic_yield=0.01, viscous_mu=2e4)),
    (2, dict(DECOUPLED, cg_precond="two_level"),
     dict(pin_boxes=PIN_2D, load_boxes=LOAD_2D)),
    (3, dict(DECOUPLED, cg_precond="two_level_cheb3"),
     dict(pin_boxes=PIN_3D + MOVING_3D)),
    (3, dict(DECOUPLED, newton_theta=0.5, cg_precond="two_level"),
     dict(damping_beta=2e-3)),
    (3, NEWTON, dict(damping_beta=2e-3, pin_boxes=PIN_3D + MOVING_3D)),
    (2, dict(DECOUPLED, operator_mode="graph", cg_precond="reference"), {}),
]


@pytest.mark.parametrize("case", CASES)
def test_newton_substeps_match_jax(case):
    """Five Newton substeps from a squashed, moving state (the blocked
    operator where the body has locality blocks, as both packages take it
    on the CPU)."""
    dim, over, obj_over = case
    pcfg, jcfg = configs(dim, obj_over, **over)
    port, jax_side = bodies(pcfg, jcfg, seed=5, squash=1.15)
    state, jstate, its, jits = run_both(pcfg, jcfg, port, jax_side,
                                        substeps=5)
    _states_close(state, jstate)
    _iterations_match(its, jits)
    assert min(its) > 0
    if obj_over.get("pin_boxes"):
        free = port[0].free_mask.numpy()[:, 0] > 0
        assert not free.all()
        if port[0].pin_vel is not None:
            np.testing.assert_array_equal(
                state.vel.numpy()[~free], port[0].pin_vel.numpy()[~free])
    if obj_over.get("plastic_yield"):
        np.testing.assert_allclose(state.plastic_inv.numpy(),
                                   np.asarray(jstate.plastic_inv), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("mode", ["exact", "decoupled"])
def test_newton_velocity_solve_matches_jax(mode):
    """One solve with an external force folded in: the velocity, the inner
    CG total and ‖P·r‖∞² (its aux), and the steps and trials left on the
    function."""
    pcfg, jcfg = configs(3, {}, **NEWTON)
    (obj, state, _), (jobj, jstate, _) = bodies(pcfg, jcfg, seed=7,
                                                squash=1.2)
    rng = np.random.default_rng(8)
    f_ext = rng.normal(scale=0.05, size=state.pos.shape).astype(np.float32)
    dt = 5e-4
    st = state.replace(vel=state.vel + dt * torch.as_tensor(f_ext)
                       / obj.mass[:, None])
    jst = jstate.replace(vel=jstate.vel + dt * jnp.asarray(f_ext)
                         / jobj.mass[:, None])
    newton.newton_velocity_solve.totals.update(solves=0, steps=0, trials=0,
                                               cg=0)
    out, aux = newton.newton_velocity_solve(obj, st, dt, hessian_mode=mode,
                                            v_n_pos=state.vel)
    jout, jaux = jnewton.newton_velocity_solve(jobj, jst, dt,
                                               hessian_mode=mode,
                                               v_n_pos=jstate.vel)
    np.testing.assert_allclose(out.vel.numpy(), np.asarray(jout.vel), rtol=0,
                               atol=1e-5)
    _iterations_match([int(aux.iterations)], [int(jaux.iterations)])
    assert int(aux.iterations) > 0
    # The final ‖P·r‖∞ of both, at the tolerance's scale.
    assert abs(float(aux.residual) ** 0.5
               - float(jaux.residual) ** 0.5) <= 1e-5
    steps = newton.newton_velocity_solve.last_steps
    trials = newton.newton_velocity_solve.last_trials
    assert 1 <= steps and steps + 1 <= trials
    assert newton.newton_velocity_solve.totals == dict(
        solves=1, steps=steps, trials=trials, cg=int(aux.iterations))


@pytest.mark.parametrize("layers", [False, True])
def test_k2_plain_version_route_matches_jax(layers):
    """``element_backend="pallas"`` on the CPU: K2's plain version per
    layer, each summed after its assembly, against the JAX package's XLA
    route."""
    obj_over = dict(plastic_yield=0.01, viscous_mu=2e4) if layers else {}
    pcfg, jcfg = configs(3, obj_over, **DECOUPLED)
    port, jax_side = bodies(pcfg, jcfg, seed=5, squash=1.15)
    pcfg = dataclasses.replace(pcfg, element_backend="pallas")
    state, jstate, its, jits = run_both(pcfg, jcfg, port, jax_side,
                                        substeps=5)
    _states_close(state, jstate)
    _iterations_match(its, jits)


def test_newton_frame_matches_jax():
    """``make_frame_fn`` with ``integrator="newton"``: ``sim_count``
    op-composed substeps (the whole-frame kernels stay ineligible), one
    frame against the JAX package's."""
    pcfg, jcfg = configs(3, {}, **DECOUPLED)
    (obj, state, obs), (jobj, jstate, jobs) = bodies(pcfg, jcfg, seed=5,
                                                     squash=1.15)
    assert not sim.supports_blocked_frame(obj, pcfg)
    s, aux = sim.make_frame_fn(obj, pcfg)(state, obs)
    js, jaux = jsim.make_frame_fn(jobj, jcfg)(jstate, jobs)
    _states_close(s, js)
    _iterations_match(aux.solver_iterations.tolist(),
                      np.asarray(jaux.solver_iterations).tolist())
    assert aux.solver_iterations.shape == (pcfg.sim_count,)


def test_refusals_match_jax():
    """The JAX package's refusals, with the same exception types."""
    pcfg, jcfg = configs(2, {}, **NEWTON)
    (obj, state, _), (jobj, jstate, _) = bodies(pcfg, jcfg)
    for kw, match in ((dict(hessian_mode="gauss"), "newton_hessian"),
                      (dict(cg_precond="block_jacobi"), "decoupled"),
                      (dict(cg_precond="two_level_cheb3"), "decoupled")):
        with pytest.raises(ValueError, match=match):
            newton.newton_velocity_solve(obj, state, 5e-4, **kw)
        with pytest.raises(ValueError, match=match):
            jnewton.newton_velocity_solve(jobj, jstate, 5e-4, **kw)
    bare = dataclasses.replace(obj, agg_ids=None, agg_basis=None,
                               num_aggregates=0)
    jbare = jobj.replace(agg_ids=None, agg_basis=None)
    for o, s, fn in ((bare, state, newton.newton_velocity_solve),
                     (jbare, jstate, jnewton.newton_velocity_solve)):
        with pytest.raises(ValueError, match="coarse space"):
            fn(o, s, 5e-4, hessian_mode="decoupled", cg_precond="two_level")
    from fem_tpu_torch.utils import config as pconfig

    with pytest.raises(ValueError, match="integrator"):
        pconfig.parse_config(dict(integrator="leapfrog"))
    with pytest.raises(ValueError, match="newton_theta"):
        pconfig.parse_config(dict(integrator="newton", newton_theta=0.3))


def test_newton_in_the_contact_frame_matches_jax():
    """tests/test_newton.py's composition: the Newton substep with the
    pair forces as its external force, one coupled frame of the two
    squares in contact."""
    from fem_tpu import contact as jcontact
    from fem_tpu.models.state import Obstacles as JObstacles
    from fem_tpu_torch import contact
    from fem_tpu_torch.models.state import Obstacles
    from tests.test_torch_contact import _cfgs, _frames, _two_squares

    jo, js, po, ps = _two_squares(gap=0.19)
    jcfg, pcfg = _cfgs(use_explicit_method=False, implicit_method=1,
                       preconditioned=0, **DECOUPLED)
    jf = jcontact.make_contact_frame_fn(jo, jcfg)
    pf = contact.make_contact_frame_fn(po, pcfg)
    forces = contact.contact_forces_all(
        [s.pos for s in ps], *pf.constants[:2], plan=pf.plan)
    assert float(forces[0].abs().max()) > 0.0  # the squares touch
    js, ps, jaux, paux = _frames(jf, pf, js, ps,
                                 JObstacles.from_configs((), 2),
                                 Obstacles.from_configs((), 2, device="cpu"))
    for a, b, ja, pa in zip(js, ps, jaux, paux):
        np.testing.assert_allclose(b.pos.numpy(), np.asarray(a.pos), rtol=0,
                                   atol=1e-5)
        _iterations_match(pa.solver_iterations.tolist(),
                          np.asarray(ja.solver_iterations).tolist())


def test_adaptive_guard_around_a_newton_substep():
    """tests/test_newton.py's composition: a benign κ runs one inner step,
    bit-equal to the unguarded Newton substep, and equal to the JAX
    package's guarded substep within 1e-5."""
    pcfg, jcfg = configs(2, {}, **DECOUPLED)
    (obj, state, obs), (jobj, jstate, jobs) = bodies(pcfg, jcfg, seed=5)
    plain, _ = sim.make_substep_fn(obj, pcfg)(state, obs)
    guarded_cfg = dataclasses.replace(pcfg, adaptive_dt=True)
    guarded, aux = sim.make_substep_fn(obj, guarded_cfg)(state, obs)
    assert torch.equal(plain.pos, guarded.pos)
    jguarded, jaux = jsim.make_substep_fn(
        jobj, dataclasses.replace(jcfg, adaptive_dt=True))(jstate, jobs)
    _states_close(guarded, jguarded)
    _iterations_match([int(aux.solver_iterations)],
                      [int(jaux.solver_iterations)])
    s, faux = sim.make_frame_fn(obj, guarded_cfg)(state, obs)
    assert bool(torch.isfinite(s.pos).all())
    assert faux.solver_iterations.shape == (pcfg.sim_count,)


def test_batched_newton_frame_equals_its_members():
    """``batch.make_batched_frame_fn`` steps each member through the same
    Newton substeps as its own frame."""
    from fem_tpu_torch import batch

    pcfg, jcfg = configs(2, {}, **DECOUPLED)
    pcfg = dataclasses.replace(pcfg, sim_count=2)
    (obj, state, obs), _ = bodies(pcfg, jcfg, seed=5)
    states = batch.perturb_states(state, 2, 1e-3, seed=1)
    out, aux = batch.make_batched_frame_fn(obj, pcfg)(states, obs)
    frame = sim.make_frame_fn(obj, pcfg)
    for b in range(2):
        member = batch._map(states, lambda t: t[b])
        s, a = frame(member, obs)
        assert torch.equal(out.pos[b], s.pos)
        assert torch.equal(aux.solver_iterations[b], a.solver_iterations)


def test_cli_runs_a_newton_config(tmp_path, capsys, monkeypatch):
    """``python -m fem_tpu_torch.main`` on a Newton config (the implicit
    2D block dropped onto two circles): the end state within 1e-5 of the
    JAX CLI's and the printed iterations (a frame's mean a substep) within
    3."""
    import main as jax_cli
    from tests.test_torch_cli import (
        CIRCLES,
        IMPLICIT,
        TWO_BODIES,
        _assert_close,
        _ckpt,
        _iters,
        _port,
        _write_cfg,
    )

    monkeypatch.setenv("FEM_TPU_NO_CACHE", "1")
    obj = dict(json.loads(json.dumps(TWO_BODIES[0])), center=[0.5, 0.68],
               side_length=0.2, subdivisions=4)
    cfg = _write_cfg(tmp_path, delta_time=2e-3, sim_count=5, objects=[obj],
                     blocks=CIRCLES, newton_hessian="decoupled",
                     integrator="newton", **IMPLICIT)
    args = ["--config", cfg, "--frames", "3", "--no-render",
            "--checkpoint-every", "3", "--print-every", "1"]
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_cli.run(args + ["--output", a]) == 0
    jax_out = capsys.readouterr().out
    assert _port(args + ["--output", b]) == 0
    port_out = capsys.readouterr().out
    _assert_close(_ckpt(b, 3), _ckpt(a, 3))
    got, ref = _iters(port_out), _iters(jax_out)
    assert len(got) == len(ref) == 3
    _iterations_match([float(g) for g in got], [float(r) for r in ref])
