# coding=utf-8
"""The port's ``Simulation`` (``fem_tpu_torch/api.py``) against the JAX
package's ``fem_tpu.Simulation``, on the CPU.

Tolerances: positions, stresses and metrics within 1e-5 (relative for the
energies and stresses, of the largest entry; absolute for positions and
det F); rendered frames pixel-equal on the same positions.
"""

import json
import os

import numpy as np
import pytest
import torch

import fem_tpu
import fem_tpu_torch
from fem_tpu_torch.utils.profiling import (
    SimulationDiverged,
    check_state,
    frame_metrics,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _cfg_dict(**over):
    """tests/test_api.py's 2D scene: a square dropped onto a circle."""
    d = {
        "dim": 2, "delta_time": 5e-4, "sim_count": 2, "auto_diff": True,
        "use_explicit_method": True, "g_dir": [0, -1],
        "objects": [
            {"rho": 500, "center": [0.5, 0.8], "side_length": 0.2,
             "subdivisions": 4, "E": 4e4, "nu": 0.2, "damping": 14.5}
        ],
        "blocks": [{"block_center": [0.5, 0.4], "block_radius": 0.15}],
    }
    d.update(over)
    return d


def _pair(data):
    return (fem_tpu.Simulation.from_dict(data),
            fem_tpu_torch.Simulation.from_dict(data, device="cpu"))


def _squashed(tmp_path, jsim, sim):
    """Load one deformed state into both: body 0 of ``jsim`` squashed about
    its centroid (x 1.15, y 0.7) and moving down at 0.05, written as a JAX
    package checkpoint; the bodies are then on equal inputs."""
    from fem_tpu.utils.io import save_checkpoint
    import jax.numpy as jnp

    state = jsim.scene[0].state
    pos = np.asarray(state.pos)
    c = pos.mean(axis=0, keepdims=True)
    squash = np.asarray([[1.15, 0.7, 1.15][:pos.shape[1]]], np.float32)
    pos = (c + (pos - c) * squash).astype(np.float32)
    vel = np.full_like(pos, -0.05)
    path = str(tmp_path / "squashed.npz")
    save_checkpoint(path, state.replace(pos=jnp.asarray(pos),
                                        vel=jnp.asarray(vel)), 0, 0.0)
    jsim.load_checkpoint(path)
    sim.load_checkpoint(path)


def _close_rel(got, ref, tol=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()))


def test_simulation_lifecycle_matches_jax(tmp_path):
    """tests/test_api.py's lifecycle on both packages: 10 guarded frames,
    the clock, positions, repr, metrics, a checkpoint round trip."""
    jsim, sim = _pair(_cfg_dict())
    assert repr(sim) == repr(jsim)
    y0 = sim.positions()[:, 1].mean()
    jsim.run(frames=10, nan_guard=True)
    sim.run(frames=10, nan_guard=True)
    assert sim.frame_count == jsim.frame_count == 10
    assert sim.virtual_time == jsim.virtual_time
    assert repr(sim) == repr(jsim)
    assert sim.positions()[:, 1].mean() < y0
    np.testing.assert_allclose(sim.positions(), jsim.positions(), rtol=0,
                               atol=TOL)
    ckpt = str(tmp_path / "s.npz")
    sim.save_checkpoint(ckpt)
    sim2 = fem_tpu_torch.Simulation.from_dict(_cfg_dict(), device="cpu")
    sim2.load_checkpoint(ckpt)
    np.testing.assert_array_equal(sim2.positions(), sim.positions())
    assert sim2.frame_count == 10 and sim2.virtual_time == sim.virtual_time
    with pytest.raises(ValueError, match="seconds= or frames="):
        sim.run()
    sim.run(seconds=4 * 2 * 5e-4)
    assert sim.frame_count == 14


def test_checkpoints_cross_with_the_jax_api(tmp_path):
    """A JAX checkpoint loads into the port and a port checkpoint into the
    JAX package, bit-equal; the next 5 frames agree within 1e-5."""
    data = _cfg_dict()
    jsim, sim = _pair(data)
    _squashed(tmp_path, jsim, sim)
    jsim.run(frames=20)
    jsim.save_checkpoint(str(tmp_path / "j.npz"))
    sim.load_checkpoint(str(tmp_path / "j.npz"))
    np.testing.assert_array_equal(sim.positions(), jsim.positions())
    sim.save_checkpoint(str(tmp_path / "p.npz"))
    jsim2 = fem_tpu.Simulation.from_dict(data)
    jsim2.load_checkpoint(str(tmp_path / "p.npz"))
    np.testing.assert_array_equal(jsim2.positions(), jsim.positions())
    assert jsim2.frame_count == sim.frame_count == 20
    jsim.run(frames=5)
    sim.run(frames=5)
    np.testing.assert_allclose(sim.positions(), jsim.positions(), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("material", ["neo_hookean", "stvk"])
def test_metrics_and_stresses_match_jax(tmp_path, material):
    """On one squashed state: ``metrics()`` (U and KE relative, min det F
    and max speed absolute, within 1e-5; the NaN flag), the Cauchy stresses
    and von Mises within 1e-5 of the largest entry."""
    objects = [dict(_cfg_dict()["objects"][0], material=material)]
    jsim, sim = _pair(_cfg_dict(objects=objects))
    _squashed(tmp_path, jsim, sim)
    m, jm = sim.metrics(), jsim.metrics()
    assert m.any_nan is False and jm.any_nan is False
    for name in ("elastic_energy", "kinetic_energy"):
        np.testing.assert_allclose(getattr(m, name), getattr(jm, name),
                                   rtol=TOL, err_msg=name)
    for name in ("min_det_f", "max_speed"):
        np.testing.assert_allclose(getattr(m, name), getattr(jm, name),
                                   rtol=0, atol=TOL, err_msg=name)
    assert m.min_det_f < 0.9
    _close_rel(sim.stress(), jsim.stress())
    _close_rel(sim.von_mises(), jsim.von_mises())


def test_check_state_raises_on_a_diverged_state():
    """The NaN guard: a NaN position, an infinite velocity and an element
    grown past |det F| 1e3 each raise ``SimulationDiverged``, as the JAX
    package's ``check_state`` does; a sound state returns its metrics."""
    from fem_tpu.utils.profiling import SimulationDiverged as JaxDiverged
    from fem_tpu.utils.profiling import check_state as jax_check_state
    import jax.numpy as jnp

    jsim, sim = _pair(_cfg_dict())
    body, jbody = sim.scene[0], jsim.scene[0]
    assert check_state(body.obj, body.state, 0).any_nan is False
    pos = body.state.pos.clone()
    pos[3, 1] = float("nan")
    vel = body.state.vel.clone()
    vel[0, 0] = float("inf")
    grown = body.state.pos * 40.0
    for bad in (body.state.replace(pos=pos), body.state.replace(vel=vel),
                body.state.replace(pos=grown)):
        assert frame_metrics(body.obj, bad).any_nan is True
        with pytest.raises(SimulationDiverged, match="non-finite positions"):
            check_state(body.obj, bad, 7)
        jbad = jbody.state.replace(pos=jnp.asarray(bad.pos.numpy()),
                                   vel=jnp.asarray(bad.vel.numpy()))
        with pytest.raises(JaxDiverged):
            jax_check_state(jbody.obj, jbad, 7)
    sim.scene[0].state = body.state.replace(pos=pos)
    with pytest.raises(SimulationDiverged):
        sim.run(frames=1, nan_guard=True)


def test_unported_features_are_refused():
    """The static solve refuses an unpinned body as the JAX package does.
    ``sharded=True`` runs (ROADMAP M20, ported): on a one-rank process
    group here (gloo on the CPU), the sharded frames of the 2D scene and of
    ``demo_two_bodies_contact.json`` (the sharded contact frame) agree with
    the unsharded ones within 1e-5."""
    sim = fem_tpu_torch.Simulation.from_dict(_cfg_dict(), device="cpu")
    with pytest.raises(ValueError, match="pin_boxes"):
        sim.solve_static()
    with open(os.path.join(REPO, "configs",
                           "demo_two_bodies_contact.json")) as f:
        contact = json.load(f)
    for data in (_cfg_dict(), contact, _cfg_dict(
            auto_diff=False, use_explicit_method=False, implicit_method=1)):
        sharded = fem_tpu_torch.Simulation.from_dict(data, sharded=True,
                                                     device="cpu")
        plain = fem_tpu_torch.Simulation.from_dict(data, device="cpu")
        assert (sharded._contact_frame is None) == (plain._contact_frame
                                                    is None)
        sharded.run(frames=2)
        plain.run(frames=2)
        for i in range(len(plain.scene)):
            np.testing.assert_allclose(sharded.positions(i),
                                       plain.positions(i), rtol=0, atol=TOL)


def test_analyses_match_jax():
    """The five analyses through both ``Simulation``s on a square pinned
    along its top rows (3 subdivisions): ``modes`` (Chebyshev, converged
    ω² within 1e-4 of the largest; ``sparse_f64`` 1e-8), ``buckling``
    under an upward push on the bottom row (load factors 1e-3),
    ``harmonic`` and ``response_spectrum`` on one modal basis carried
    across (1e-5), ``arc_length`` for 3 steps (λ 1e-6)."""
    import jax.numpy as jnp

    from fem_tpu_torch import convert

    data = _cfg_dict(use_explicit_method=False, auto_diff=False)
    data["objects"][0].update(subdivisions=3, pin_boxes=[[[0.0, 0.895],
                                                          [1.0, 1.0]]])
    sim = fem_tpu_torch.Simulation.from_dict(data, device="cpu")
    jsim = fem_tpu.Simulation.from_dict(data)
    pos = sim.positions()
    n, d = pos.shape

    res = sim.modes(k=4, rounds=10, degree=60)
    jres = jsim.modes(k=4, rounds=10, degree=60)
    jw = np.asarray(jres.omega_sq)
    np.testing.assert_allclose(res.omega_sq.numpy(), jw, rtol=0,
                               atol=1e-4 * jw[-1])
    sp = sim.modes(k=4, method="sparse_f64")
    jsp = jsim.modes(k=4, method="sparse_f64")
    np.testing.assert_allclose(sp.omega_sq.numpy(),
                               np.asarray(jsp.omega_sq), rtol=1e-8)

    f = np.zeros((n, d), np.float32)
    bottom = pos[:, 1] < pos[:, 1].min() + 1e-6
    f[bottom, 1] = 2.0 / bottom.sum()
    bk = sim.buckling(k=2, f_ext=f, rounds=24)
    jbk = jsim.buckling(k=2, f_ext=f, rounds=24)
    lam, jlam = bk.load_factors.numpy(), np.asarray(jbk.load_factors)
    assert np.array_equal(np.isfinite(lam), np.isfinite(jlam))
    fin = np.isfinite(jlam)
    np.testing.assert_allclose(lam[fin], jlam[fin], rtol=1e-3)

    basis = convert.modal_from_arrays(
        {k: np.asarray(getattr(jres, k)) for k in convert.MODAL_FIELDS},
        "cpu")
    rng = np.random.default_rng(0)
    f_hat = rng.normal(size=(n, d)).astype(np.float32)
    freqs = np.linspace(0.2, 2.0, 50).astype(np.float32) * float(
        np.asarray(jres.frequencies)[0])
    hr = sim.harmonic(f_hat, freqs, modal=basis, zeta=0.05)
    jhr = jsim.harmonic(f_hat, freqs, modal=jres, zeta=jnp.asarray(0.05))
    np.testing.assert_allclose(hr.amplitude.numpy(),
                               np.asarray(jhr.amplitude), rtol=0,
                               atol=TOL * np.abs(jhr.amplitude).max())
    accel = np.sin(np.arange(400) * 0.05).astype(np.float32)
    rs = sim.response_spectrum(accel, 1e-3, (1.0, 0.0), modal=basis)
    jrs = jsim.response_spectrum(accel, 1e-3, (1.0, 0.0), modal=jres)
    np.testing.assert_allclose(rs.peak.numpy(), np.asarray(jrs.peak),
                               rtol=0, atol=1e-4 * np.abs(jrs.peak).max())

    load = np.zeros((n, d), np.float32)
    load[bottom, 1] = -1.0
    arc = sim.arc_length(load, n_steps=3, dlam0=0.05, record_path=False)
    jarc = jsim.arc_length(load, n_steps=3, dlam0=0.05, record_path=False)
    assert arc.steps_taken == jarc.steps_taken == 3
    np.testing.assert_allclose(arc.lam.numpy(), np.asarray(jarc.lam),
                               rtol=0, atol=1e-6 * np.abs(jarc.lam).max())


def test_contact_config_matches_jax():
    """configs/demo_two_bodies_contact.json through both ``Simulation``s for
    3 frames: every body's positions within 1e-5, one clock advance a frame
    (the API's pacing, not the CLI's), ``last_aux`` the last body's."""
    path = os.path.join(REPO, "configs", "demo_two_bodies_contact.json")
    jsim = fem_tpu.Simulation.from_config(path)
    sim = fem_tpu_torch.Simulation.from_config(path, device="cpu")
    assert sim._contact_frame is not None
    jsim.run(frames=3)
    sim.run(frames=3)
    for i in range(2):
        np.testing.assert_allclose(sim.positions(i), jsim.positions(i),
                                   rtol=0, atol=TOL)
    assert sim.virtual_time == jsim.virtual_time == pytest.approx(0.015)
    assert sim.frame_count == jsim.frame_count == 3
    assert tuple(sim.last_aux.solver_iterations.shape) == (10,)
    moved = [np.abs(sim.positions(i) - np.asarray(s.obj.rest_pos)).max()
             for i, s in enumerate(sim.scene)]
    assert min(moved) > 0.0


@pytest.mark.parametrize("color", ["energy", "stress"])
def test_render_matches_jax_on_the_same_state(tmp_path, color):
    """``render()`` of one squashed 2D state is pixel-equal to the JAX
    package's frame."""
    jsim, sim = _pair(_cfg_dict())
    _squashed(tmp_path, jsim, sim)
    frame = sim.render(msgs=("frame 0",), color=color)
    assert frame.shape == (640, 640, 3) and frame.dtype == np.uint8
    np.testing.assert_array_equal(
        frame, jsim.render(msgs=("frame 0",), color=color))


def test_3d_render_and_exports_match_jax(tmp_path):
    """A 3D body (assets/cube.stl) squashed: ``render()`` pixel-equal on
    the same positions, ``export_obj`` equal and ``export_vtu`` points and
    masses equal, det F within 1e-5, von Mises within 1e-5·μ."""
    from fem_tpu_torch.utils.vtu import read_vtu

    data = {
        "dim": 3, "delta_time": 5e-4, "sim_count": 4, "auto_diff": False,
        "use_explicit_method": True, "g_dir": [0, -1, 0],
        "objects": [{"rho": 1000, "center": [0.3, 0.3, 0.3],
                     "obj": os.path.join(REPO, "assets", "cube.stl"),
                     "E": 4e4, "nu": 0.3, "damping": 10}],
        "blocks": [],
    }
    jsim, sim = _pair(data)
    _squashed(tmp_path, jsim, sim)
    np.testing.assert_array_equal(sim.render(), jsim.render())
    for api, name in ((sim, "p"), (jsim, "j")):
        api.export_obj(str(tmp_path / f"{name}.obj"))
        api.export_vtu(str(tmp_path / f"{name}.vtu"))
    assert (tmp_path / "p.obj").read_text() == (tmp_path / "j.obj").read_text()
    p, j = read_vtu(str(tmp_path / "p.vtu")), read_vtu(str(tmp_path / "j.vtu"))
    np.testing.assert_array_equal(p[0], j[0])
    np.testing.assert_array_equal(p[1], j[1])
    np.testing.assert_array_equal(p[2]["mass"], j[2]["mass"])
    np.testing.assert_allclose(p[3]["det_F"], j[3]["det_F"], rtol=0, atol=TOL)
    mu = 4e4 / (2 * (1 + 0.3))
    np.testing.assert_allclose(p[3]["von_mises"], j[3]["von_mises"], rtol=0,
                               atol=TOL * mu)
    assert float(j[3]["von_mises"].max()) > 100 * TOL * mu
    sim2d = fem_tpu_torch.Simulation.from_dict(_cfg_dict(), device="cpu")
    with pytest.raises(ValueError, match="OBJ export requires"):
        sim2d.export_obj(str(tmp_path / "x.obj"))
