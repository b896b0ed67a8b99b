# coding=utf-8
"""The 3D golden canary of tests/test_golden.py through the port on the
CPU: ``assets/cube.stl`` meshed by the port's own
``models/mesh.delaunay_tetrahedralize`` (spacing 0.5), dropped onto the
floor under the implicit CG in normal-equations mode for 100 frames (0.5
virtual seconds), held to the JAX package's recorded values with that
test's tolerances (mean and std 5e-3, particles 0 and 5 atol 1e-2).  The
frame is the op-composed one ("auto" on a CPU object: the plain versions
of K1 and K4); on the card ``chip_smoke.py`` runs the same arc through
K5."""

import os

import numpy as np
import torch

from fem_tpu_torch import sim
from fem_tpu_torch.models import mesh as pmesh
from fem_tpu_torch.models.state import Obstacles, build_object
from fem_tpu_torch.utils.config import ObjectConfig, SimConfig

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_golden.py:93-104 (recorded by the JAX package on the v4 mesher,
# spacing 0.5).
GOLDEN_3D = dict(mean=0.27050927, std=0.16186684,
                 p0=(0.2029982, -0.0001941, 0.1924001),
                 p5=(0.4930525, -0.0001596, 0.5102745))


def test_golden_trajectory_3d_implicit_cg():
    v, f = pmesh.load_surface_mesh(os.path.join(REPO, "assets", "cube.stl"))
    nodes, tets = pmesh.delaunay_tetrahedralize(v, f, 0.5)
    surface, _ = pmesh.extract_surface(nodes, tets)
    ocfg = ObjectConfig(center=(0.2, 0.05, 0.2), rho=1000.0, E=4e4, nu=0.3,
                        damping=10.0)
    obj, state = build_object(ocfg, (0.3 * nodes).astype(np.float32),
                              surface.astype(np.int32), tets.astype(np.int32),
                              device="cpu")
    cfg = SimConfig(dim=3, delta_time=5e-4, sim_count=10, auto_diff=False,
                    use_explicit_method=False, implicit_method=1,
                    preconditioned=1, g_dir=(0.0, -1.0, 0.0), objects=(ocfg,),
                    blocks=())
    assert sim.supports_blocked_frame(obj, cfg)
    obstacles = Obstacles.from_configs((), 3, device="cpu")
    frame = sim.make_frame_fn(obj, cfg)
    for _ in range(100):
        state, _ = frame(state, obstacles)
    p = state.pos.numpy().astype(np.float64)
    assert np.isfinite(p).all()
    assert abs(p.mean() - GOLDEN_3D["mean"]) < 5e-3
    assert abs(p.std() - GOLDEN_3D["std"]) < 5e-3
    np.testing.assert_allclose(p[0], GOLDEN_3D["p0"], atol=1e-2)
    np.testing.assert_allclose(p[5], GOLDEN_3D["p5"], atol=1e-2)
