# coding=utf-8
"""The port's inelastic materials (``fem_tpu_torch/ops/inelastic.py``, the
stable Neo-Hookean branch chains, the layered op-composed substep) against
the JAX package on the same arrays, and ``configs/demo_plastic.json``
through the port against the JAX package's run of it (the layered
op-composed substeps of every method are in
tests/test_torch_inelastic_substep.py).

Inputs are made from a seed with numpy.  Tolerances: the Jacobi eigensolve
and the return map 1e-5 (the same f32 steps in the same order, rounded by
two libraries); element chains 1e-5 relative to each block's largest
entry; internal inverses and positions after a few substeps 1e-5 (the
paths sum in other orders).  A yield decision is a threshold, but the
radial return is continuous at the yield surface, so a decision that
rounding flips moves the state by rounding only."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu import scene as jscene
from fem_tpu import sim as jsim
from fem_tpu.models import mesh as jmesh
from fem_tpu.models.state import build_object as jax_build_object
from fem_tpu.ops import blocking as jblocking
from fem_tpu.ops import element as jelement
from fem_tpu.ops import inelastic as jinelastic
from fem_tpu.ops import pallas_kernels as jpk
from fem_tpu.ops import smallmat as jsm
from fem_tpu.utils import config as jconfig
from fem_tpu_torch import convert, scene, sim
from fem_tpu_torch.ops import blocking, element, inelastic
from fem_tpu_torch.ops import smallmat as sm
from fem_tpu_torch.utils import config as pconfig

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
CAPS = dict(eb=16, pb=24)  # re-blocks the 3D cube into several blocks
MATS = {
    "plastic": dict(plastic_yield=0.02),
    "viscous": dict(viscous_mu=1e4, viscous_tau=0.03),
    "both": dict(plastic_yield=0.02, viscous_mu=1e4, viscous_tau=0.03),
}


def _reblock(obj, jobj):
    args = (obj.element_indices.numpy(), obj.ref_inv.numpy(),
            obj.volume.numpy(), obj.rest_pos.numpy())
    jblk = jblocking.build_blocking(*args, **CAPS)
    obj = dataclasses.replace(
        obj, blocking=blocking.build_blocking(*args, **CAPS, device="cpu"))
    assert obj.blocking.num_blocks == jblk.num_blocks >= 3
    return obj, jobj.replace(blocking=jblk)


def inelastic_pair(dim, mat, seed, sub=None, squash=0.2, state_noise=0.03,
                   reblock=None, vel_scale=0.3):
    """(port object, port state, JAX object, JAX state) of one body with the
    material ``mat``: the 2D grid at 16 subdivisions (3 locality blocks;
    side 0.4, so that an element's edge, 0.025, is long beside the
    positions' rounding, which its F⁻¹ divides by) or the 3D grid at 3
    (side 0.2, re-blocked into several blocks with small caps),
    stretched by ``1 + squash`` along x and squashed by ``1 − squash`` along
    y about its centroid, with random velocities (uniform, ±``vel_scale``)
    and internal inverses
    I + ``state_noise``·noise — so that elements yield at once and a state
    applied to the wrong element shows."""
    sub = sub or (16 if dim == 2 else 3)
    center = (0.5, 0.45) if dim == 2 else (0.4, 0.3, 0.4)
    ocfg = jconfig.ObjectConfig(subdivisions=sub,
                                side_length=0.4 if dim == 2 else 0.2,
                                center=center, rho=500.0, E=4e4, nu=0.2,
                                damping=8.0, **mat)
    make = jmesh.construct_2d_mesh if dim == 2 else jmesh.construct_3d_grid_mesh
    jobj, jstate = jax_build_object(ocfg, *make(ocfg))
    arrays = {n: np.asarray(getattr(jobj, n)) for n in convert.OBJECT_ARRAYS}
    statics = {n: getattr(jobj, n) for n in convert.OBJECT_STATICS}
    obj = convert.object_from_arrays(arrays, statics, "cpu")
    if reblock if reblock is not None else dim == 3:
        obj, jobj = _reblock(obj, jobj)
    rng = np.random.default_rng(seed)
    pos = np.asarray(jstate.pos)
    c = pos.mean(axis=0, keepdims=True)
    scale = np.ones(dim, np.float32)
    scale[0], scale[1] = 1.0 + squash, 1.0 - squash
    pos = (c + (pos - c) * scale
           + rng.uniform(-0.002, 0.002, pos.shape)).astype(np.float32)
    vel = rng.uniform(-vel_scale, vel_scale, pos.shape).astype(np.float32)
    changes = dict(pos=jnp.asarray(pos), vel=jnp.asarray(vel))
    e = obj.element_cnt
    for name in convert.INTERNAL_ARRAYS:
        if getattr(jstate, name) is not None:
            fi = np.eye(dim) + state_noise * rng.standard_normal((e, dim, dim))
            changes[name] = jnp.asarray(fi.astype(np.float32))
    jstate = jstate.replace(**changes)
    arrays = {n: np.asarray(getattr(jstate, n)) for n in convert.STATE_ARRAYS}
    for name in convert.INTERNAL_ARRAYS:
        if getattr(jstate, name) is not None:
            arrays[name] = np.asarray(getattr(jstate, name))
    return obj, convert.state_from_arrays(arrays, "cpu"), jobj, jstate


def sim_configs(dim, **over):
    data = dict(dim=dim, delta_time=5e-4, sim_count=4, auto_diff=False,
                use_explicit_method=False, implicit_method=1,
                preconditioned=1, g_dir=[0, -1] if dim == 2 else [0, -1, 0],
                blocks=[])
    data.update(over)
    return pconfig.parse_config(data), jconfig.parse_config(data)


def assert_state_close(state, jstate, tol=TOL, what=""):
    np.testing.assert_allclose(state.pos.numpy(), np.asarray(jstate.pos),
                               rtol=0, atol=tol, err_msg=f"pos {what}")
    for name in convert.INTERNAL_ARRAYS:
        got, ref = getattr(state, name), getattr(jstate, name)
        assert (got is None) == (ref is None), name
        if got is not None:
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                       atol=tol, err_msg=f"{name} {what}")


def _sym(rng, n, d):
    a = rng.standard_normal((n, d, d)).astype(np.float32)
    m = a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(d, dtype=np.float32)
    m[0] = np.diag(np.arange(1, d + 1)).astype(np.float32)  # a_pq = 0
    m[1] = np.array([[2, 1, 0], [1, 2, 0], [0, 0, 3]], np.float32)[:d, :d]
    return m  # m[1]: tau = 0 with a_pq != 0


@pytest.mark.parametrize("dim", [2, 3])
def test_sym_eigh_matches_jax(dim):
    m = _sym(np.random.default_rng(dim), 64, dim)
    w, v = sm.sym_eigh(torch.as_tensor(m))
    jw, jv = jsm.sym_eigh(jnp.asarray(m))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    back = v @ torch.diag_embed(w) @ v.transpose(-1, -2)
    np.testing.assert_allclose(back.numpy(), m, rtol=0, atol=1e-4)


def _strained(rng, n, d, amount):
    return (np.eye(d) + amount * rng.standard_normal((n, d, d))).astype(
        np.float32)


@pytest.mark.parametrize("dim", [2, 3])
def test_return_map_and_relaxation_match_jax(dim):
    rng = np.random.default_rng(10 + dim)
    f = _strained(rng, 128, dim, 0.15)
    got, yielded = inelastic.plastic_return_map(torch.as_tensor(f), 0.02)
    ref, jyielded = jinelastic.plastic_return_map(jnp.asarray(f), 0.02)
    np.testing.assert_array_equal(yielded.numpy(), np.asarray(jyielded))
    assert 0 < int(yielded.sum()) < 128 or bool(yielded.all())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    got = inelastic.viscous_relax(torch.as_tensor(f), 5e-4, 0.03)
    ref = jinelastic.viscous_relax(jnp.asarray(f), 5e-4, 0.03)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    # The plane form is the same arithmetic.
    planes = list(torch.as_tensor(f).reshape(128, -1).unbind(1))
    fe, y2 = inelastic._p_plastic_return(planes, 0.02, dim)
    np.testing.assert_array_equal(y2.numpy(), yielded.numpy())
    np.testing.assert_allclose(torch.stack(fe, 1).reshape(-1, dim, dim),
                               inelastic.plastic_return_map(
                                   torch.as_tensor(f), 0.02)[0],
                               rtol=0, atol=1e-6)


def _block_rel(got, ref):
    ref = np.asarray(ref)
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(axis=1)[:, None, None]
    return float((np.abs(np.asarray(got) - ref) / np.maximum(scale, 1e-30))
                 .max())


@pytest.mark.parametrize("dim", [2, 3])
def test_stable_neo_hookean_chains_match_jax(dim):
    """P and DP against the JAX package's ops/element.py; k, h and the
    gradient columns against its Pallas chains (pallas_kernels.py), whose
    arithmetic the CUDA chains follow."""
    rng = np.random.default_rng(20 + dim)
    f = _strained(rng, 96, dim, 0.3)
    r = _strained(rng, 96, dim, 0.3)
    mu, lam = 3e4, 1e4
    p, dp = element.stable_nh_p_dp(torch.as_tensor(f), torch.as_tensor(r),
                                   mu, lam)
    jp = jelement.first_piola(jnp.asarray(f), mu, lam, "stable_neo_hookean")
    jdp = jelement.first_piola_dp(jnp.asarray(f), jnp.asarray(r), mu, lam,
                                  "stable_neo_hookean")
    assert _block_rel(p.numpy(), jp) <= TOL
    assert _block_rel(dp.numpy(), jdp) <= TOL
    x = (f @ np.linalg.inv(r)).astype(np.float32)
    k, h = element.k_and_h_chain(sm.matmul(torch.as_tensor(x),
                                           torch.as_tensor(r)),
                                 torch.as_tensor(r), mu, lam,
                                 "stable_neo_hookean")
    g = element.grad_cols_chain(sm.matmul(torch.as_tensor(x),
                                          torch.as_tensor(r)),
                                torch.as_tensor(r), mu, lam,
                                "stable_neo_hookean")

    def planes(a):
        return [jnp.asarray(a.reshape(-1, dim * dim)[:, c])
                for c in range(dim * dim)]

    jk, jh = jpk.k_and_h_chain(planes(x), planes(r), dim, mu, lam, False,
                               "stable_neo_hookean")
    jg = jpk.grad_cols_chain(planes(x), planes(r), dim, mu, lam,
                             "stable_neo_hookean")
    for got, ref in ((k, jk), (h, jh), (g, jg)):
        ref = np.stack([np.asarray(c) for c in ref], 1).reshape(-1, dim, dim)
        assert _block_rel(got.numpy(), ref) <= TOL
    # h is the gradient of V·φ: the energy agrees too.
    e = element.energy_density(torch.as_tensor(f), mu, lam,
                               "stable_neo_hookean")
    je = jelement.energy_density(jnp.asarray(f), mu, lam,
                                 "stable_neo_hookean")
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("dim", [2, 3])
def test_inelastic_grad_columns_and_energies_match_jax(dim):
    obj, state, jobj, jstate = inelastic_pair(dim, MATS["both"], seed=dim)
    got = inelastic.inelastic_grad_columns(obj, state, state.pos)
    ref = jinelastic.inelastic_grad_columns(jobj, jstate, jstate.pos)
    assert _block_rel(got.numpy(), ref) <= TOL
    got = inelastic.inelastic_element_energies(obj, state, state.pos)
    ref = jinelastic.inelastic_element_energies(jobj, jstate, jstate.pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-7)


@pytest.mark.parametrize("form", ["row", "blocked"])
@pytest.mark.parametrize("dim", [2, 3])
def test_advance_internal_matches_jax(dim, form):
    """On an over-yield state (30 % stretch), from perturbed internal
    inverses; the blocked form over a mesh whose blocks permute elements."""
    obj, state, jobj, jstate = inelastic_pair(dim, MATS["both"], seed=5,
                                              squash=0.3)
    if form == "row":
        obj = dataclasses.replace(obj, blocking=None)
        jobj = jobj.replace(blocking=None)
    else:
        perm = obj.blocking.element_perm.numpy()[:obj.element_cnt]
        assert not np.array_equal(perm, np.arange(obj.element_cnt))
    got = inelastic.advance_internal(obj, state, 5e-4)
    ref = jinelastic.advance_internal(jobj, jstate, 5e-4)
    assert_state_close(got, ref, what=form)
    moved = np.abs(got.plastic_inv.numpy() - state.plastic_inv.numpy()).max()
    assert moved > 1e-3  # the state yielded
    assert torch.equal(got.pos, state.pos)


def test_advance_internal_freezes_inverted_elements():
    obj, state, _, _ = inelastic_pair(2, MATS["both"], seed=6)
    pos = state.pos.clone()
    i0, i1, i2 = obj.element_indices[0].long().tolist()
    pos[i2] = pos[i0] + (pos[i0] - pos[i2])  # flips element 0
    state = state.replace(pos=pos)
    for o in (obj, dataclasses.replace(obj, blocking=None)):
        out = inelastic.advance_internal(o, state, 5e-4)
        assert torch.equal(out.plastic_inv[0], state.plastic_inv[0])
        assert torch.equal(out.viscous_inv[0], state.viscous_inv[0])
        assert torch.isfinite(out.plastic_inv).all()


def test_convert_round_trips_inelastic_state():
    obj, state, jobj, jstate = inelastic_pair(2, MATS["both"], seed=8)
    arrays, statics = convert.object_to_arrays(obj)
    for name in ("plastic_yield", "viscous_mu", "viscous_tau"):
        assert statics[name] == getattr(jobj, name), name
    again = convert.object_from_arrays(arrays, statics, "cpu")
    assert (again.plastic_yield, again.viscous_mu, again.viscous_tau) == (
        0.02, 1e4, 0.03)
    back = convert.state_to_arrays(state)
    for name in convert.INTERNAL_ARRAYS:
        np.testing.assert_array_equal(back[name],
                                      np.asarray(getattr(jstate, name)))
    s2 = convert.state_from_arrays(back, "cpu")
    assert torch.equal(s2.plastic_inv, state.plastic_inv)
    elastic = convert.state_from_arrays(
        {n: back[n] for n in convert.STATE_ARRAYS}, "cpu")
    assert elastic.plastic_inv is None and elastic.viscous_inv is None
    assert set(convert.state_to_arrays(elastic)) == set(convert.STATE_ARRAYS)


def _demo_plastic(device="cpu"):
    cfg = pconfig.read_config(os.path.join(REPO, "configs",
                                           "demo_plastic.json"))
    bodies, obs = scene.load_scene(cfg, device=device)
    return cfg, bodies, obs


def test_demo_plastic_loads_as_the_jax_package_does(capsys):
    cfg, bodies, obs = _demo_plastic()
    jcfg = jconfig.read_config(os.path.join(REPO, "configs",
                                            "demo_plastic.json"))
    jbodies, _ = jscene.load_scene(jcfg)
    capsys.readouterr()
    assert len(bodies) == len(jbodies) == 2
    for b, jb in zip(bodies, jbodies):
        assert (b.obj.particle_cnt, b.obj.element_cnt,
                b.obj.blocking.num_blocks) == (121, 200, 1)
        for name in ("plastic_yield", "viscous_mu", "viscous_tau", "mu",
                     "s_lambda", "damping"):
            assert getattr(b.obj, name) == getattr(jb.obj, name), name
        for name in convert.INTERNAL_ARRAYS:
            got, ref = getattr(b.state, name), getattr(jb.state, name)
            assert (got is None) == (ref is None), name
            if got is not None:
                np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert bodies[0].state.plastic_inv is not None
    assert bodies[1].state.viscous_inv is not None
    assert cfg.use_explicit_method and sim.supports_explicit_blocked_frame(
        bodies[0].obj, cfg)


# Recorded from the JAX package on the CPU (200 frames of
# configs/demo_plastic.json through fem_tpu.sim.make_frame_fn, each body
# on its own); test_demo_plastic_golden_is_the_jax_run holds them to a live
# run, so they cannot go stale.  max_fi: max |F_i⁻¹ − I| of the body's
# internal inverse (F_p⁻¹ for body 0, F_v⁻¹ for body 1).
GOLDEN_PLASTIC = {
    0: dict(mean=0.26474188, std=0.19676138, p0=(0.30657175, 0.00289933),
            p60=(0.44921011, 0.07068006), p120=(0.54656106, 0.17222811),
            max_fi=0.57151222),
    1: dict(mean=0.42356669, std=0.33236686, p0=(0.64952904, -0.00009840),
            p60=(0.75001907, 0.09686103), p120=(0.84958166, 0.19520803),
            max_fi=0.02481234),
}
GOLDEN_FRAMES = 200


def golden_values(pos, fi):
    pos = np.asarray(pos, np.float64)
    dim = fi.shape[-1]
    return dict(mean=float(pos.mean()), std=float(pos.std()),
                p0=tuple(pos[0]), p60=tuple(pos[60]), p120=tuple(pos[120]),
                max_fi=float(np.abs(np.asarray(fi) - np.eye(dim)).max()))


def assert_golden(got, body):
    g = GOLDEN_PLASTIC[body]
    assert abs(got["mean"] - g["mean"]) < 5e-3
    assert abs(got["std"] - g["std"]) < 5e-3
    for key in ("p0", "p60", "p120"):
        np.testing.assert_allclose(got[key], g[key], atol=1e-2, err_msg=key)
    assert abs(got["max_fi"] - g["max_fi"]) <= 0.1 * g["max_fi"]


def _fi_name(body):
    return "plastic_inv" if body == 0 else "viscous_inv"


@pytest.mark.parametrize("body", [0, 1])
def test_demo_plastic_golden_is_the_jax_run(body, capsys):
    jcfg = jconfig.read_config(os.path.join(REPO, "configs",
                                            "demo_plastic.json"))
    jbodies, jobs = jscene.load_scene(jcfg)
    capsys.readouterr()
    jb = jbodies[body]
    frame = jsim.make_frame_fn(jb.obj, jcfg)
    s = jb.state
    for _ in range(GOLDEN_FRAMES):
        s, _ = frame(s, jobs)
    got = golden_values(s.pos, getattr(s, _fi_name(body)))
    g = GOLDEN_PLASTIC[body]
    assert abs(got["mean"] - g["mean"]) < 1e-5
    assert abs(got["std"] - g["std"]) < 1e-5
    for key in ("p0", "p60", "p120"):
        np.testing.assert_allclose(got[key], g[key], atol=1e-5, err_msg=key)
    assert abs(got["max_fi"] - g["max_fi"]) <= 1e-3 * g["max_fi"]


@pytest.mark.parametrize("backend", ["auto", "blocked_explicit"])
@pytest.mark.parametrize("body", [0, 1])
def test_demo_plastic_golden_through_the_port(body, backend, capsys):
    """The 200-frame arc of each shipped body through the port on the CPU:
    the op-composed frame (``"auto"`` on a CPU object) and K8's plain
    version, held to the goldens with tests/test_golden.py's tolerances
    (mean and std 5e-3, particles 1e-2) and max |F_i⁻¹ − I| within 10 %."""
    cfg, bodies, obs = _demo_plastic()
    capsys.readouterr()
    b = bodies[body]
    frame = sim.make_frame_fn(b.obj, dataclasses.replace(
        cfg, frame_backend=backend))
    s = b.state
    for _ in range(GOLDEN_FRAMES):
        s, _ = frame(s, obs)
    fi = getattr(s, _fi_name(body))
    assert torch.isfinite(s.pos).all() and torch.isfinite(fi).all()
    assert_golden(golden_values(s.pos.numpy(), fi.numpy()), body)
