# coding=utf-8
"""``examples/newton_large_dt.py``'s stiff 2D block at κ ≈ 60 through the
port's ``Simulation`` and the JAX package's: the semi-implicit
integrator goes non-finite, in the same frame in both packages, and the
Newton integrator — decoupled with plain CG and with
``two_level_cheb3`` inner solves, exact at θ = 1 and at θ = 0.5 — stays
finite, the two packages' positions within 1e-3 in every frame (the
inner solves stop on rounding-sensitive tests at κ ≫ 1, so the runs are
held at the scale of the example's own check, not at 1e-5)."""

import json
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 6  # the example's frames under FEM_TPU_EXAMPLE_FAST
RUNS = {
    "semi-implicit": {},
    "decoupled": dict(integrator="newton", newton_hessian="decoupled"),
    "decoupled two_level_cheb3": dict(integrator="newton",
                                      newton_hessian="decoupled",
                                      cg_precond="two_level_cheb3"),
    "exact": dict(integrator="newton"),
    "exact midpoint": dict(integrator="newton", newton_theta=0.5),
}


def _runs(label, noise=1e-4):
    """The example's block with the ``RUNS[label]`` settings through both
    packages' ``Simulation`` for ``FRAMES`` frames, its start velocities
    noised alike (numpy seed 0, ``noise``: at rest the block's residual
    force is f32 rounding, which the semi-implicit blow-up grows from and
    which the two packages round differently): (JAX positions by frame,
    the port's)."""
    import fem_tpu
    import fem_tpu_torch

    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import newton_large_dt as ex
    finally:
        sys.path.pop(0)
    cfg = json.loads(json.dumps(dict(ex.BASE, **RUNS[label])))
    runs = []
    for simulation in (fem_tpu.Simulation.from_dict(cfg),
                       fem_tpu_torch.Simulation.from_dict(cfg, device="cpu")):
        s = simulation.scene[0].state
        kick = np.random.default_rng(0).normal(
            scale=noise, size=tuple(s.vel.shape)).astype(np.float32)
        if isinstance(s.vel, torch.Tensor):
            kick = torch.as_tensor(kick)
        simulation.scene[0].state = s.replace(vel=s.vel + kick)
        pos = []
        for _ in range(FRAMES):
            simulation.step_frame()
            pos.append(np.asarray(simulation.positions()))
        runs.append(pos)
    return runs


def test_semi_implicit_goes_non_finite_in_both():
    jpos, ppos = _runs("semi-implicit")
    jfinite = [bool(np.isfinite(p).all()) for p in jpos]
    pfinite = [bool(np.isfinite(p).all()) for p in ppos]
    assert jfinite[0] and not jfinite[-1], jfinite
    assert pfinite == jfinite, (pfinite, jfinite)


@pytest.mark.parametrize("label", [k for k in RUNS if k != "semi-implicit"])
def test_newton_stays_finite_and_matches_jax(label):
    jpos, ppos = _runs(label)
    for j, p in zip(jpos, ppos):
        assert np.isfinite(j).all() and np.isfinite(p).all()
        np.testing.assert_allclose(p, j, rtol=0, atol=1e-3)
    assert np.abs(ppos[-1] - ppos[0]).max() > 1e-3  # the block moved
