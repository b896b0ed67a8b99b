# coding=utf-8
"""The plain reference against the port's CPU frames (K5's and K8's plain
versions) on a small mesh from a squashed state, where the CG iterates,
and on the configuration's own mesh."""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import check  # noqa: E402
from portbench.reference import fem  # noqa: E402


@pytest.fixture(autouse=True)
def _mesh_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("FEM_TPU_MESH_CACHE", str(tmp_path / "mesh"))


def _port(sim_cfg):
    from fem_tpu_torch.api import Simulation

    return Simulation.from_dict(sim_cfg, device="cpu")


def _squashed(pos):
    c = pos.mean(axis=0, keepdims=True)
    return ((c + (pos - c) * np.array([[1.15, 0.7, 1.15]]))
            .astype(np.float32))


def _run_both(sim_cfg, frames, squash=True):
    sim = _port(sim_cfg)
    body = sim.scene[0]
    rest = body.obj.rest_pos.numpy()
    tets = body.obj.element_indices.numpy()
    pos = _squashed(rest) if squash else rest
    vel = (np.random.default_rng(5).uniform(-0.5, 0.5, pos.shape)
           .astype(np.float32))
    zero = np.zeros_like(pos)
    body.state = body.state.replace(pos=torch.tensor(pos),
                                    vel=torch.tensor(vel),
                                    vel_g=torch.tensor(zero))
    ref_body, scene = check.reference_scene({"sim": sim_cfg}, rest, tets)
    s = fem.State(*(torch.tensor(a, dtype=torch.float64)
                    for a in (pos, vel, zero)))
    worst = {"pos": 0.0, "vel": 0.0}
    all_its = []
    for _ in range(frames):
        sim.step_frame()
        s, its = fem.frame(ref_body, scene, s)
        st = sim.scene[0].state
        assert sim.last_aux.solver_iterations.tolist() == its
        all_its += its
        worst["pos"] = max(worst["pos"],
                           (st.pos.double() - s.pos).abs().max().item())
        worst["vel"] = max(worst["vel"],
                           (st.vel.double() - s.vel).abs().max().item(),
                           (st.vel_g.double() - s.vel_g).abs().max().item())
    return worst, all_its


def _cube(**over):
    cfg = json.load(open(os.path.join(ROOT, "configs", "demo_3d.json")))
    cfg.update(dict(use_explicit_method=False, implicit_method=1,
                    preconditioned=1), **over)
    # Stiff enough that the unit cube's CG iterates.
    cfg["objects"][0]["E"] = 4e7
    return cfg


def test_implicit_cube_frames_match_k5_plain():
    worst, its = _run_both(_cube(frame_backend="blocked"), 3)
    assert max(its) > 0  # the squashed, stirred state makes the CG iterate
    # float32 against float64, velocities of 0.5 m/s.
    assert worst["pos"] < 2e-6 and worst["vel"] < 1e-3, worst


def test_explicit_cube_frames_match_k8_plain():
    worst, _ = _run_both(_cube(frame_backend="blocked_explicit",
                               use_explicit_method=True, delta_time=1e-4,
                               sim_count=50), 3)
    # 150 float32 substeps of the squashed cube's vibration.
    assert worst["pos"] < 1e-5 and worst["vel"] < 2e-3, worst


@pytest.mark.parametrize("name,backend", [("cube3d_implicit", "blocked"),
                                          ("cube3d_explicit",
                                           "blocked_explicit")])
def test_configuration_mesh_frame_matches_port(name, backend, monkeypatch):
    monkeypatch.chdir(ROOT)
    config = json.load(open(os.path.join(ROOT, "portbench", "configs",
                                         f"{name}.json")))
    worst, its = _run_both(dict(config["sim"], frame_backend=backend), 1)
    assert worst["pos"] < 1e-5 and worst["vel"] < 1e-3, worst


def test_reference_small_matrices():
    a = torch.tensor([[[2.0, 1.0, 0.5], [0.0, 3.0, 1.0], [1.0, 0.0, 1.5]]],
                     dtype=torch.float64)
    assert torch.allclose(fem.inv(a), torch.linalg.inv(a))
    assert torch.allclose(fem.det(a), torch.linalg.det(a))
    b = a[:, :2, :2]
    assert torch.allclose(fem.inv(b), torch.linalg.inv(b))
    assert torch.allclose(fem.mm(a, a.transpose(1, 2)),
                          a @ a.transpose(1, 2))
