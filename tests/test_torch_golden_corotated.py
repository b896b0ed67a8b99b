# coding=utf-8
"""``configs/demo_passage_corotated.json`` — ``default.json`` with the
corotated material, 2D, ``auto_diff`` — as shipped through the port on the
CPU for 200 frames (one virtual second), held to the JAX package's run of it:
the op-composed autodiff frame (autograd through the 12 Higham iterations of
``polar_rotation``) and K8's plain version (the analytic corotated P).

Tolerances: tests/test_golden.py's (mean and std 5e-3, particles 1e-2); the
recorded values against the live JAX run 1e-5."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from fem_tpu import scene as jscene
from fem_tpu import sim as jsim
from fem_tpu.utils import config as jconfig
from fem_tpu_torch import scene, sim
from fem_tpu_torch.utils import config as pconfig
from tests.test_torch_inelastic import REPO

torch.set_num_threads(1)


# Recorded from the JAX package on the CPU (200 frames, one virtual second,
# of configs/demo_passage_corotated.json through fem_tpu.sim.make_frame_fn);
# test_demo_passage_corotated_golden_is_the_jax_run holds them to a live
# run, so they cannot go stale.
GOLDEN_COROTATED = dict(mean=0.52271651, std=0.06694287,
                        p0=(0.59543681, 0.45029497),
                        p60=(0.49884495, 0.54849130),
                        p120=(0.39236563, 0.64084446))
GOLDEN_FRAMES = 200
CONFIG = os.path.join(REPO, "configs", "demo_passage_corotated.json")


def _golden_values(pos):
    pos = np.asarray(pos, np.float64)
    return dict(mean=float(pos.mean()), std=float(pos.std()),
                p0=tuple(pos[0]), p60=tuple(pos[60]), p120=tuple(pos[120]))


def test_demo_passage_corotated_golden_is_the_jax_run(capsys):
    jcfg = jconfig.read_config(CONFIG)
    (jb,), jobs = jscene.load_scene(jcfg)
    capsys.readouterr()
    assert jb.obj.material == "corotated" and jcfg.auto_diff
    frame = jsim.make_frame_fn(jb.obj, jcfg)
    s = jb.state
    for _ in range(GOLDEN_FRAMES):
        s, _ = frame(s, jobs)
    got = _golden_values(s.pos)
    for key in ("mean", "std"):
        assert abs(got[key] - GOLDEN_COROTATED[key]) < 1e-5, key
    for key in ("p0", "p60", "p120"):
        np.testing.assert_allclose(got[key], GOLDEN_COROTATED[key], atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("backend", ["auto", "blocked_explicit"])
def test_demo_passage_corotated_through_the_port(backend, capsys):
    """The shipped config's 200-frame arc through the port on the CPU: the
    op-composed autodiff frame (``"auto"`` on a CPU object: autograd through
    the 12 Higham iterations of ``polar_rotation``) and K8's plain version
    (the analytic corotated P), held to the JAX package's run with
    tests/test_golden.py's tolerances."""
    cfg = pconfig.read_config(CONFIG)
    (body,), obs = scene.load_scene(cfg, device="cpu")
    capsys.readouterr()
    assert body.obj.material == "corotated"
    assert (body.obj.particle_cnt, body.obj.element_cnt) == (121, 200)
    assert sim.supports_explicit_blocked_frame(body.obj, cfg)
    frame = sim.make_frame_fn(body.obj, dataclasses.replace(
        cfg, frame_backend=backend))
    s = body.state
    for _ in range(GOLDEN_FRAMES):
        s, _ = frame(s, obs)
    assert torch.isfinite(s.pos).all()
    got = _golden_values(s.pos.numpy())
    for key in ("mean", "std"):
        assert abs(got[key] - GOLDEN_COROTATED[key]) < 5e-3, key
    for key in ("p0", "p60", "p120"):
        np.testing.assert_allclose(got[key], GOLDEN_COROTATED[key], atol=1e-2,
                                   err_msg=key)
