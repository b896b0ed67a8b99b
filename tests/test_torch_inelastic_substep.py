# coding=utf-8
"""The port's layered op-composed substep — both inelastic branches on, with
and without locality blocks, 2D and 3D — against ``fem_tpu.sim``'s substep
on the same arrays: here the explicit methods (explicit, autodiff, the
``"xla"`` elements), in tests/test_torch_inelastic_implicit_substep.py the
implicit ones (the inelastic modules' own tests are in
tests/test_torch_inelastic.py).

Tolerances: positions and both internal inverses within 1e-5 after each of
three substeps (the paths sum in other orders); CG iteration counts within
1."""

import dataclasses

import pytest
import torch

from fem_tpu import sim as jsim
from fem_tpu.models.state import Obstacles as JaxObstacles
from fem_tpu_torch import sim
from fem_tpu_torch.models.state import Obstacles
from tests.test_torch_inelastic import (
    MATS,
    assert_state_close,
    inelastic_pair,
    sim_configs,
)

torch.set_num_threads(1)


SUBSTEPS = {
    "explicit": dict(use_explicit_method=True),
    "autodiff": dict(use_explicit_method=True, auto_diff=True),
    "explicit_xla": dict(use_explicit_method=True, element_backend="xla"),
    "implicit": dict(preconditioned=0),
    "implicit_normal": dict(preconditioned=1),
    "implicit_blocked": dict(preconditioned=1, operator_mode="blocked"),
}


def cases(methods):
    """(dim, method, unblocked) of ``methods``, 2D and 3D, with and without
    locality blocks (``operator_mode="blocked"`` needs them)."""
    return [(dim, method, unblocked)
            for dim in (2, 3) for method in methods
            for unblocked in (False, True)
            if not (unblocked and method == "implicit_blocked")]


def check_layered_substep(dim, method, unblocked):
    """Three op-composed substeps with both branches on, against
    ``fem_tpu.sim``'s substep; with locality blocks (the blocked update,
    K7b edges) and without (the row update, the element-order chains)."""
    obj, state, jobj, jstate = inelastic_pair(dim, MATS["both"], seed=7,
                                              squash=0.1)
    if unblocked:
        obj = dataclasses.replace(obj, blocking=None)
        jobj = jobj.replace(blocking=None)
    pcfg, jcfg = sim_configs(dim, **SUBSTEPS[method])
    kw = sim.substep_kwargs(pcfg)
    jstep = jsim.make_substep_fn(jobj, jcfg)
    obs = Obstacles.from_configs((), dim, device="cpu")
    jobs = JaxObstacles.from_configs((), dim)
    start = state
    for i in range(3):
        state, aux = sim.substep(obj, state, obs, **kw)
        jstate, jaux = jstep(jstate, jobs)
        assert_state_close(state, jstate, what=f"substep {i}")
        assert abs(int(aux.solver_iterations)
                   - int(jaux.solver_iterations)) <= 1
    assert float((state.plastic_inv - start.plastic_inv).abs().max()) > 1e-4
    assert float((state.viscous_inv - start.viscous_inv).abs().max()) > 1e-4


@pytest.mark.parametrize("dim,method,unblocked",
                         cases(("autodiff", "explicit", "explicit_xla")))
def test_layered_substep_matches_jax(dim, method, unblocked):
    check_layered_substep(dim, method, unblocked)
