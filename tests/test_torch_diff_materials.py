# coding=utf-8
"""Differentiable rollouts with material parameters as tensors
(``fem_tpu_torch/diff.py`` on ``ops/element.py``): the element functions
with μ and λ as 0-d tensors, the Mooney-Rivlin calibration checked once on
the object's floats, and rollouts of corotated autodiff, Mooney-Rivlin,
fiber and robust St. Venant-Kirchhoff against the JAX package's
``fem_tpu.diff`` on the same numpy inputs.

Tolerances as ``tests/test_torch_diff.py``: values 1e-5 relative,
gradients 1e-3 relative to ``jax.grad`` (float32 on both sides), positions
1e-5 on the implicit method, finite differences 5e-2."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu import diff as jdiff
from fem_tpu.ops import element as jelement
from fem_tpu_torch import diff
from fem_tpu_torch.ops import element
from tests.test_torch_diff import (
    AUTODIFF,
    EXPLICIT,
    IMPLICIT,
    assert_grads_match,
    case,
    grads_both,
    port_config,
    port_loss,
    states_close,
    tensors,
)
from tests.test_torch_diff_implicit import _run_both
from tests.utils import default_sim_config

torch.set_num_threads(1)


def test_element_functions_take_tensor_parameters():
    """hessian_blocks, implicit_force_columns, explicit_grad_columns and
    total_energy with μ and λ as 0-d tensors: values and their derivatives
    in μ and λ against the JAX package's under ``jax.grad``."""
    (obj, state, _), (jobj, jstate, _) = case(dim=3, subdivisions=2)
    w = np.random.default_rng(0).normal(size=(obj.element_cnt, 3, 3)) \
        .astype(np.float32)
    args = (state.pos, obj.element_indices, obj.ref_inv, obj.volume)
    jargs = (jstate.pos, jobj.element_indices, jobj.ref_inv, jobj.volume)
    for name, extra in (("hessian_blocks", (False,)),
                        ("implicit_force_columns", (False,)),
                        ("explicit_grad_columns", ()),
                        ("total_energy", ())):
        mu, lam = tensors([jobj.mu, jobj.s_lambda])
        out = getattr(element, name)(*args, mu, lam, *extra)
        red = out if out.dim() == 0 else torch.sum(out * torch.as_tensor(w))
        got = torch.autograd.grad(red, (mu, lam))

        def jred(m, lm, name=name, extra=extra):
            o = getattr(jelement, name)(*jargs, m, lm, *extra)
            return o if o.ndim == 0 else jnp.sum(o * w)

        jv, ref = jax.value_and_grad(jred, argnums=(0, 1))(
            jnp.float32(jobj.mu), jnp.float32(jobj.s_lambda))
        assert float(red.detach()) == pytest.approx(float(jv), rel=1e-5), \
            name
        for g, r in zip(got, ref):
            assert float(g) == pytest.approx(float(r), rel=1e-4), name


def test_mooney_params_tensors_read_nothing_back():
    """A tensor μ or λ skips the calibration check, which would read it to
    the host; ``make_diff_substep_fn`` checks it once on the object's
    floats."""
    mu, lam = torch.tensor(1e4), torch.tensor(1e3)
    c1, c2, lam_log = element.mooney_params(mu, lam, 3, "mooney_rivlin:0.9")
    assert torch.is_tensor(lam_log) and float(lam_log) < 0.0
    with pytest.raises(ValueError, match="infeasible"):
        element.mooney_params(1e4, 1e3, 3, "mooney_rivlin:0.9")
    (obj, _, _), _ = case(dim=2, subdivisions=2)
    bad = dataclasses.replace(obj, material="mooney_rivlin:0.95", mu=1e4,
                              s_lambda=1e3)
    with pytest.raises(ValueError, match="infeasible"):
        diff.make_diff_substep_fn(bad, port_config(default_sim_config(
            **EXPLICIT)))


def test_corotated_autodiff_grads():
    """Autograd through the 12 Higham iterations of the corotated energy
    inside the rollout, against jax.grad and central differences."""
    def corotated(jobj):
        return jobj.replace(material="corotated")

    port, jax_side = case(jobj_fn=corotated)
    res = grads_both(port, jax_side, AUTODIFF, 8)
    assert_grads_match(*res)
    obj, state, obs = port
    cfg = port_config(default_sim_config(**AUTODIFF))
    mu0 = obj.mu
    with torch.no_grad():
        fd = (float(port_loss(obj, cfg, state, obs, 8, diff.DiffParams(
            *tensors([mu0 * 1.001, obj.s_lambda, obj.damping], False))))
            - float(port_loss(obj, cfg, state, obs, 8, diff.DiffParams(
                *tensors([mu0 * 0.999, obj.s_lambda, obj.damping], False))))
        ) / (2e-3 * mu0)
    assert res[0][1][0] == pytest.approx(fd, rel=5e-2, abs=1e-12)


def test_robust_stvk_match_jax():
    """``robust_inversion`` and a material other than Neo-Hookean (its rhs
    through the analytic Piola columns): forward and gradients."""
    def stvk(jobj):
        return jobj.replace(material="stvk")

    port, jax_side = case(jobj_fn=stvk)
    kw = dict(IMPLICIT, robust_inversion=True)
    state, jstate = _run_both(port, jax_side, default_sim_config(**kw), 6)
    states_close(state, jstate, 1e-5)
    assert_grads_match(*grads_both(port, jax_side, kw, 6))


def test_fiber_grads():
    """The fiber's k = κ·μ on tensor μ inside an explicit rollout:
    gradients against jax.grad."""
    def fiber(jobj):
        return jobj.replace(material="fiber:1,1")

    port, jax_side = case(subdivisions=2, jobj_fn=fiber)
    assert_grads_match(*grads_both(port, jax_side, EXPLICIT, 6))


def test_mooney_rivlin_rollout():
    """Mooney-Rivlin with μ and λ as tensors.  The JAX package's diff path
    cannot trace them (its ``mooney_params`` compares them in Python and
    raises ``TracerBoolConversionError`` under ``jax.grad``), so the
    forward substeps are held to its substep run on concrete parameters
    (positions 1e-6) and the gradients to central differences of the
    port."""
    def mooney(jobj):
        return jobj.replace(material="mooney_rivlin:0.3")

    (obj, state, obs), (jobj, jstate, jobs) = case(subdivisions=2,
                                                   jobj_fn=mooney)
    jcfg = default_sim_config(**EXPLICIT)
    cfg = port_config(jcfg)
    sub = diff.make_diff_substep_fn(obj, cfg)
    jsub = jdiff.make_diff_substep_fn(jobj, jcfg)
    params, jparams = diff.params_from_object(obj), \
        jdiff.params_from_object(jobj)
    s, js = state, jstate
    with torch.no_grad():
        for _ in range(6):
            s = sub(params, s, obs)
            js = jsub(jparams, js, jobs)
    states_close(s, js, 1e-6)
    base = [obj.mu, obj.s_lambda, obj.damping]
    ts = tensors(base)
    got = torch.autograd.grad(port_loss(obj, cfg, state, obs, 6,
                                        diff.DiffParams(*ts)), ts)
    with torch.no_grad():
        for i in (0, 1):
            eps = 1e-3 * base[i]
            hi, lo = list(base), list(base)
            hi[i] += eps
            lo[i] -= eps
            fd = (float(port_loss(obj, cfg, state, obs, 6, diff.DiffParams(
                *tensors(hi, False)))) - float(port_loss(
                    obj, cfg, state, obs, 6, diff.DiffParams(
                        *tensors(lo, False))))) / (2 * eps)
            assert abs(float(got[i])) > 0.0
            assert float(got[i]) == pytest.approx(fd, rel=5e-2), i
