# coding=utf-8
"""The port's op-composed substeps of every method per material, robust
included (``fem_tpu_torch.sim.substep`` with the material of
``fem_tpu_torch/ops/element.py``), against ``fem_tpu.sim``'s substep on the
same arrays (the material pieces themselves are held in
tests/test_torch_materials.py).

Inputs are made from a seed with numpy.  Tolerances: positions after each of
three substeps 1e-5 (float32 on both sides, sums in other orders); CG
iteration counts within 1."""

import dataclasses

import numpy as np
import pytest
import torch

from fem_tpu import sim as jsim
from fem_tpu.models.state import Obstacles as JaxObstacles
from fem_tpu_torch import sim
from fem_tpu_torch.models.state import Obstacles
from tests.test_torch_inelastic import inelastic_pair, sim_configs
from tests.test_torch_materials import MATERIALS, TOL

torch.set_num_threads(1)


SUBSTEPS = {
    "explicit": dict(use_explicit_method=True),
    "autodiff": dict(use_explicit_method=True, auto_diff=True),
    "explicit_xla": dict(use_explicit_method=True, element_backend="xla"),
    "implicit": dict(preconditioned=0),
    "implicit_normal": dict(preconditioned=1),
    "implicit_blocked": dict(preconditioned=1, operator_mode="blocked"),
}
CASES = (
    # Every material through the explicit, autodiff and implicit methods in
    # 3D over several locality blocks ...
    [(3, m, method, False, False) for m in MATERIALS[3]
     for method in ("explicit", "autodiff", "implicit_normal")
     # jax.grad through 12 Higham iterations over the blocks compiles for
     # ~30 s; the 2D cases and demo_passage_corotated.json's arc
     # (test_torch_golden_corotated.py) hold the corotated autograd.
     if (m, method) != ("corotated", "autodiff")]
    # ... and in 2D without blocks (the element-order chains and autograd
    # of the whole energy) ...
    + [(2, m, method, True, False) for m in MATERIALS[2]
       for method in ("autodiff", "implicit")]
    # ... the other settings once each, and robust_inversion on the K1 + K4
    # and K2 + K3 branches.
    + [(2, "corotated", "explicit_xla", False, False),
       (3, "fiber:1,0.5,0.25", "implicit_blocked", False, False),
       (2, "mooney_rivlin:0.3", "implicit_blocked", False, True)]
    + [(dim, "neo_hookean", method, unblocked, True)
       for dim in (2, 3)
       for method, unblocked in (("implicit_normal", False),
                                 ("implicit_blocked", False),
                                 ("implicit", True))]
)


@pytest.mark.parametrize("dim,material,method,unblocked,robust", CASES)
def test_material_substep_matches_jax(dim, material, method, unblocked,
                                      robust):
    """Three op-composed substeps against ``fem_tpu.sim``'s substep from a
    stretched, moving state."""
    obj, state, jobj, jstate = inelastic_pair(dim, dict(material=material),
                                              seed=17, squash=0.1)
    if unblocked:
        obj = dataclasses.replace(obj, blocking=None)
        jobj = jobj.replace(blocking=None)
    pcfg, jcfg = sim_configs(dim, robust_inversion=robust, **SUBSTEPS[method])
    kw = sim.substep_kwargs(pcfg)
    jstep = jsim.make_substep_fn(jobj, jcfg)
    obs = Obstacles.from_configs((), dim, device="cpu")
    jobs = JaxObstacles.from_configs((), dim)
    for i in range(3):
        state, aux = sim.substep(obj, state, obs, **kw)
        jstate, jaux = jstep(jstate, jobs)
        np.testing.assert_allclose(state.pos.numpy(), np.asarray(jstate.pos),
                                   rtol=0, atol=TOL, err_msg=f"substep {i}")
        assert abs(int(aux.solver_iterations)
                   - int(jaux.solver_iterations)) <= 1
