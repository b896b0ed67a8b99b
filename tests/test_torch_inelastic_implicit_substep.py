# coding=utf-8
"""The port's layered op-composed substep of the implicit methods (plain
and normal-equations CG, the blocked operator) — both inelastic branches
on, with and without locality blocks, 2D and 3D — against
``fem_tpu.sim``'s substep on the same arrays (the explicit methods are in
tests/test_torch_inelastic_substep.py, whose check this file runs).

Tolerances: positions and both internal inverses within 1e-5 after each of
three substeps (the paths sum in other orders); CG iteration counts within
1."""

import pytest
import torch

from tests.test_torch_inelastic_substep import cases, check_layered_substep

torch.set_num_threads(1)


@pytest.mark.parametrize("dim,method,unblocked",
                         cases(("implicit", "implicit_blocked",
                                "implicit_normal")))
def test_layered_substep_matches_jax(dim, method, unblocked):
    check_layered_substep(dim, method, unblocked)
