# coding=utf-8
"""The 2D golden trajectories of tests/test_golden.py through the port on
the CPU: 200 frames (one virtual second) of the golden scene —
``make_2d_object(subdivisions=6)`` under ``configs/default.json``'s two
circles — per method, held to the JAX package's recorded values with that
file's tolerances (mean and std 5e-3, particles 0, 24 and 48 atol 1e-2).

Each method runs twice: through ``frame_backend="auto"``, which on a CPU
object is the op-composed frame of plain versions, and through the plain
version of the whole-frame kernel the card runs for it (K8 for the
explicit and autodiff methods, K5 for the implicit CG).  The
``implicit_jacobi`` golden (the serial sweep) runs through the op-composed
frame only: on the card that frame runs J1 once a substep, and on the CPU
J1's plain row loop (~30 s)."""

import dataclasses

import numpy as np
import pytest
import torch

from fem_tpu_torch import sim
from fem_tpu_torch.models import mesh as pmesh
from fem_tpu_torch.models.state import Obstacles, build_object
from fem_tpu_torch.utils import config as pconfig
from tests.test_golden import GOLDEN, OVERRIDES

torch.set_num_threads(1)

WHOLE_FRAME = {"explicit_analytic": "blocked_explicit",
               "autodiff": "blocked_explicit", "implicit_cg": "blocked"}


def _golden_run(name, frame_backend):
    """Positions after 200 frames; tests/utils.py's default_sim_config and
    make_2d_object(subdivisions=6), built by the port."""
    cfg = pconfig.parse_config(dict(
        dim=2, delta_time=5e-4, sim_count=10, auto_diff=True,
        use_explicit_method=True, implicit_method=0, preconditioned=1,
        g_dir=[0, -1], objects=[dict(subdivisions=6)],
        blocks=[dict(id=0, block_center=[0.8, 0.5], block_radius=0.21),
                dict(id=1, block_center=[0.2, 0.5], block_radius=0.21)],
    ))
    cfg = dataclasses.replace(cfg, frame_backend=frame_backend,
                              **OVERRIDES[name])
    ocfg = cfg.objects[0]
    assert tuple(ocfg.center) == (0.5, 0.8) and ocfg.side_length == 0.2
    v, f, t = pmesh.construct_2d_mesh(ocfg)
    obj, state = build_object(ocfg, v, f, t, device="cpu")
    assert obj.particle_cnt == 49 and obj.blocking.num_blocks == 1
    obstacles = Obstacles.from_configs(cfg.blocks, 2, device="cpu")
    frame = sim.make_frame_fn(obj, cfg)
    for _ in range(200):
        state, _ = frame(state, obstacles)
    return state.pos.numpy()


@pytest.mark.parametrize("backend", ["auto", "whole frame"])
@pytest.mark.parametrize("name", sorted(WHOLE_FRAME))
def test_golden_trajectory_2d(name, backend):
    _check_golden(name, _golden_run(
        name, WHOLE_FRAME[name] if backend == "whole frame" else "auto"))


def test_golden_trajectory_2d_jacobi():
    _check_golden("implicit_jacobi", _golden_run("implicit_jacobi", "auto"))


def _check_golden(name, p):
    g = GOLDEN[name]
    assert np.isfinite(p).all()
    assert abs(p.mean() - g["mean"]) < 5e-3
    assert abs(p.std() - g["std"]) < 5e-3
    for key, idx in (("p0", 0), ("p24", 24), ("p48", 48)):
        np.testing.assert_allclose(p[idx], g[key], atol=1e-2)
