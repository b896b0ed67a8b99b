# coding=utf-8
"""2D (triangles) through the port on the CPU.  The plain versions of the
eight kernels — K1 and K6 (element chains), K4 (whole CG solve), K2, K3,
K7b and K7a (blocked prep, operator, explicit prep, assembly) and the whole
frames K5 and K8 — against the JAX package's Pallas kernels (interpret
mode) and solvers on the same numpy inputs; the 2D locality blocking
against the JAX package's ``build_blocking``; and ``scene.load_scene`` on
the shipped two-body config against ``fem_tpu.scene.load_scene``.

Scenes: the grid square of ``configs/default.json``'s material at 16
subdivisions (289 particles, 512 triangles, 3 locality blocks), placed
across the floor and the x = 1 wall under a circle, deformed and moving
with numpy noise; and the golden scene of ``tests/test_golden.py`` (6
subdivisions, the two circles of ``default.json``), its velocities
noised so that the solve iterates.

Tolerances, as the 3D tests': element blocks 1e-5 block-relative (atol
1e-6); per-slot partials, assembled vectors and G(K)·x 1e-5 of their
largest entry; K4's velocity rtol 5e-4 / atol 1e-6 with iterations within
1; frames positions atol 1e-5 after each frame, iterations within 1 in
solves of 20 iterations or fewer."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu import scene as jscene
from fem_tpu import sim as jsim
from fem_tpu.models.state import Obstacles as JaxObstacles
from fem_tpu.models.state import build_object as jax_build_object
from fem_tpu.ops import blocking as jblocking
from fem_tpu.ops.pallas_kernels import (
    explicit_grad_columns_pallas,
    hessian_and_force_pallas,
)
from fem_tpu.solvers import implicit as jimplicit
from fem_tpu.utils import config as jconfig
from fem_tpu_torch import convert, scene, sim
from fem_tpu_torch.models import mesh as pmesh
from fem_tpu_torch.models.state import Obstacles, build_object
from fem_tpu_torch.ops import blocked_kernels, blocking, element_kernels
from fem_tpu_torch.solvers import implicit
from fem_tpu_torch.utils import config as pconfig
from tests.test_torch_blocking import (
    _assert_same_partition,
    _slot_pairs_jax,
    _slot_pairs_port,
)
from tests.test_torch_element_kernels import assert_blocks_close

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT = 5e-4
TOL = 1e-5
# default.json's two circles; tests/utils.py:default_obstacles.
DEFAULT_BLOCKS = [dict(id=0, block_center=[0.8, 0.5], block_radius=0.21),
                  dict(id=1, block_center=[0.2, 0.5], block_radius=0.21)]
MATERIAL = dict(E=4e4, nu=0.2, rho=500, damping=14.5, side_length=0.2)


def _configs(obj, blocks, **over):
    """The same 2D SimConfig in both packages (one schema, parsed twice)."""
    data = dict(
        dim=2, delta_time=DT, sim_count=10, auto_diff=False,
        use_explicit_method=False, implicit_method=1, preconditioned=1,
        g_dir=[0, -1], objects=[obj], blocks=blocks,
    )
    data.update(over)
    return pconfig.parse_config(data), jconfig.parse_config(data)


def _both(pcfg, jcfg, noise):
    """Port and JAX objects, states and obstacles from one mesh; ``noise``
    (pos, vel) → (pos, vel) moves the start state the same way in both."""
    v, f, t = pmesh.construct_2d_mesh(pcfg.objects[0])
    jobj, jstate = jax_build_object(jcfg.objects[0], v, f, t)
    arrays = {n: np.asarray(getattr(jobj, n)) for n in convert.OBJECT_ARRAYS}
    statics = {n: getattr(jobj, n) for n in convert.OBJECT_STATICS}
    obj = convert.object_from_arrays(arrays, statics, "cpu")
    pos, vel = noise(np.asarray(jstate.pos), np.asarray(jstate.vel))
    jstate = jstate.replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel))
    state = convert.state_from_arrays(
        {n: np.asarray(getattr(jstate, n)) for n in convert.STATE_ARRAYS},
        "cpu",
    )
    jobs = JaxObstacles.from_configs(jcfg.blocks, 2)
    obs = Obstacles.from_configs(pcfg.blocks, 2, device="cpu")
    return pcfg, jcfg, obj, state, obs, jobj, jstate, jobs


def _grid_scene(seed, sub=16):
    """The grid square across the floor (y < 0) and the x = 1 wall, a
    circle over its top edge, default.json's left circle and a radius-0
    circle (never hits); positions moved by a tenth of an element's size,
    velocities random with a drift into the floor and the wall."""
    blocks = [dict(id=0, block_center=[0.85, 0.2], block_radius=0.08),
              DEFAULT_BLOCKS[1],
              dict(id=2, block_center=[0.9, 0.05], block_radius=0.0)]
    pcfg, jcfg = _configs(dict(center=[0.82, -0.04], subdivisions=sub,
                               **MATERIAL), blocks)
    rng = np.random.default_rng(seed)
    h = 0.2 / sub

    def noise(pos, vel):
        pos = (pos + rng.uniform(-0.1 * h, 0.1 * h, pos.shape)).astype(
            np.float32)
        vel = rng.uniform(-0.3, 0.3, pos.shape).astype(np.float32)
        vel[:, 0] += 0.3
        vel[:, 1] -= 0.5
        return pos, vel

    out = _both(pcfg, jcfg, noise)
    pos = out[3].pos.numpy()
    # Every quirk of the advection is reached: the floor, the x = 1 wall
    # and the circle.
    assert (pos[:, 1] < 0).sum() > 0 and (pos[:, 0] > 1).sum() > 0
    assert (np.linalg.norm(pos - [0.85, 0.2], axis=1) < 0.08).sum() > 0
    return out


def _golden_scene(seed):
    """tests/test_golden.py's scene (make_2d_object(subdivisions=6) under
    default.json's circles), velocities random (numpy seed)."""
    pcfg, jcfg = _configs(dict(subdivisions=6), DEFAULT_BLOCKS)
    rng = np.random.default_rng(seed)

    def noise(pos, vel):
        return pos, rng.uniform(-0.3, 0.3, pos.shape).astype(np.float32)

    return _both(pcfg, jcfg, noise)


@pytest.fixture(scope="module")
def grid():
    out = _grid_scene(seed=0)
    blk = out[2].blocking
    assert (out[2].particle_cnt, out[2].element_cnt) == (289, 512)
    assert blk.num_blocks == 3
    assert int((blk.block_elements < blk.eb).sum()) > 0  # padded slots
    return out


def _rel(got, ref):
    """max |got − ref| / max |ref|."""
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max()
                 / np.abs(np.asarray(ref)).max())


def _block_rel(got, ref):
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(axis=1)
    scale = np.maximum(scale, 1e-30)[:, None, None]
    return float((np.abs(got - ref) / scale).max())


# -- the 2D locality blocking (M7) ------------------------------------------

@pytest.mark.parametrize("sub,blocks", [(10, 1), (16, 3), (40, 16)])
def test_blocking_2d_partition_matches_jax(sub, blocks):
    """default.json's square at 10, 16 and 40 subdivisions: 1, 3 and 16
    blocks of (256, 128), partitioned as the JAX package does."""
    ocfg = pconfig.ObjectConfig(subdivisions=sub, **MATERIAL)
    v, f, t = pmesh.construct_2d_mesh(ocfg)
    obj, _ = build_object(ocfg, v, f, t, device="cpu")
    arrays, _ = convert.object_to_arrays(obj)
    jax_blk = jblocking.build_blocking(
        arrays["element_indices"], arrays["ref_inv"], arrays["volume"],
        arrays["rest_pos"])
    assert obj.blocking.dim == 2
    assert jax_blk.num_blocks == blocks
    _assert_same_partition(obj.blocking, jax_blk)
    assert _slot_pairs_port(obj.blocking) == _slot_pairs_jax(jax_blk)


# -- K1 and K6: the element chains -------------------------------------------

def _squashed(obj, pos):
    """Compressed uniformly to 0.8% of its size, so that every triangle has
    det F ≈ 6.4e-5 (below K's 1e-4 clamp, F well conditioned), and the
    last triangle's vertex 2 mirrored through its edge 0-1 (det F < 0)."""
    c = pos.mean(axis=0, keepdims=True)
    pos = (c + 0.008 * (pos - c)).astype(np.float64)
    idx = obj.element_indices.numpy()[-1]
    p0, p1, p2 = (pos[i] for i in idx)
    t = (p1 - p0) / np.linalg.norm(p1 - p0)
    foot = p0 + np.dot(p2 - p0, t) * t
    pos[idx[2]] = 2.0 * foot - p2
    return pos.astype(np.float32)


def _det_f(obj, pos):
    x = pos[obj.element_indices.numpy()]
    edges = np.stack([x[:, 1] - x[:, 0], x[:, 2] - x[:, 0]], axis=-1)
    return np.linalg.det(edges.astype(np.float64)
                         @ obj.ref_inv.numpy().astype(np.float64))


@pytest.mark.parametrize("case", ["deformed", "squashed"])
def test_element_chain_2d_matches_pallas(grid, case):
    """K1 on triangles; "squashed" reaches the log clamp and an inverted
    triangle (K clamps, the rhs stays finite)."""
    obj, state = grid[2], grid[3]
    pos = state.pos.numpy()
    if case == "squashed":
        pos = _squashed(obj, pos)
        det = _det_f(obj, pos)
        assert 0.0 < det[0] < 1e-4, det[0]
        assert det[-1] < 0.0
    args = (obj.element_indices, obj.ref_inv, obj.volume)
    k, h = element_kernels.hessian_and_force(
        torch.as_tensor(pos), *args, obj.mu, obj.s_lambda)
    assert element_kernels.hessian_and_force.launches == 0  # CPU: plain
    jk, jh = hessian_and_force_pallas(
        jnp.asarray(pos), *(jnp.asarray(a.numpy()) for a in args), obj.mu,
        obj.s_lambda)
    assert k.shape == np.asarray(jk).shape == (obj.element_cnt, 2, 2)
    assert np.isfinite(k.numpy()).all() and np.isfinite(h.numpy()).all()
    assert_blocks_close(k.numpy(), np.asarray(jk), rtol=TOL, atol=1e-6)
    assert_blocks_close(h.numpy(), np.asarray(jh), rtol=TOL, atol=1e-6)


def test_grad_cols_2d_matches_pallas(grid):
    """K6 on triangles."""
    obj, state, jstate = grid[2], grid[3], grid[6]
    args = (obj.element_indices, obj.ref_inv, obj.volume)
    got = element_kernels.explicit_grad_columns(
        state.pos, *args, obj.mu, obj.s_lambda).numpy()
    assert element_kernels.explicit_grad_columns.launches == 0
    ref = np.asarray(explicit_grad_columns_pallas(
        jstate.pos, *(jnp.asarray(a.numpy()) for a in args), obj.mu,
        obj.s_lambda))
    assert got.shape == ref.shape == (obj.element_cnt, 2, 2)
    assert np.isfinite(got).all()
    assert _block_rel(got, ref) <= TOL


# -- K4: the whole CG solve --------------------------------------------------

@pytest.mark.parametrize("preconditioned", [1, 0])
def test_fused_cg_2d_matches_jax(grid, preconditioned):
    """The port's implicit solve (plain K1 + plain K4) against the JAX
    package's through its two Pallas kernels (``operator_mode="fused"``,
    ``element_backend="pallas"``)."""
    _, _, obj, state, _, jobj, jstate, _ = grid
    ref_state, ref_aux = jimplicit.implicit_velocity_solve(
        jobj, jstate, DT, method=1, preconditioned=preconditioned,
        element_backend="pallas", operator_mode="fused")
    got_state, got_aux = implicit.implicit_velocity_solve(
        obj, state, DT, 1, preconditioned)
    np.testing.assert_allclose(got_state.vel.numpy(),
                               np.asarray(ref_state.vel), rtol=5e-4,
                               atol=1e-6)
    ref_it, got_it = int(ref_aux.iterations), int(got_aux.iterations)
    assert 1 < ref_it <= 20
    assert abs(got_it - ref_it) <= 1


# -- K2, K3, K7b, K7a: the blocked kernels -----------------------------------

def test_blocked_prep_2d_matches_jax(grid):
    """K2 on triangles: K blocks and force partials."""
    _, _, obj, state, _, jobj, jstate, _ = grid
    K, part = blocked_kernels.blocked_prep(obj.blocking, state.pos, obj.mu,
                                           obj.s_lambda)
    assert blocked_kernels.blocked_prep.launches == 0
    kplane, yt = jblocking.blocked_prep(jobj.blocking, jstate.pos, 2,
                                        jobj.mu, jobj.s_lambda)
    kflat = np.asarray(jblocking.kplane_to_kflat(jobj.blocking, kplane, 2))
    assert K.shape == kflat.shape == (3 * 256, 2, 2)
    assert _block_rel(K.numpy(), kflat) <= TOL
    ref = np.asarray(yt).transpose(0, 2, 1)
    assert part.shape == ref.shape == (3, 128, 2)
    assert _rel(part.numpy(), ref) <= TOL
    f = blocking.blocked_scatter_sum(part, obj.blocking).numpy()
    ref_f = np.asarray(jblocking.blocked_scatter_sum(yt, jobj.blocking,
                                                     obj.particle_cnt))
    assert _rel(f, ref_f) <= TOL


@pytest.mark.parametrize("transpose_k", [False, True])
def test_blocked_graph_apply_2d_matches_jax(grid, transpose_k):
    """K3 on triangles, both transposes."""
    _, _, obj, state, _, jobj, _, _ = grid
    K, _ = blocked_kernels.blocked_prep_plain(obj.blocking, state.pos,
                                              obj.mu, obj.s_lambda)
    x = np.random.default_rng(3).uniform(
        -1, 1, (obj.particle_cnt, 2)).astype(np.float32)
    got = blocked_kernels.blocked_graph_apply(
        obj.blocking, K, torch.as_tensor(x), transpose_k).numpy()
    assert blocked_kernels.blocked_graph_apply.launches == 0
    kplane = jblocking.make_kplane(jobj.blocking, jnp.asarray(K.numpy()), 2)
    ref = np.asarray(jblocking.blocked_graph_apply(
        jobj.blocking, kplane, jnp.asarray(x), jobj.particle_cnt, 2,
        transpose_k=transpose_k))
    assert np.abs(ref).max() > 0
    assert _rel(got, ref) <= TOL


def test_blocked_grad_prep_2d_matches_jax(grid):
    """K7b on triangles."""
    _, _, obj, state, _, jobj, jstate, _ = grid
    part = blocked_kernels.blocked_grad_prep(obj.blocking, state.pos, obj.mu,
                                             obj.s_lambda)
    assert blocked_kernels.blocked_grad_prep.launches == 0
    yt = jblocking.blocked_grad_prep(jobj.blocking, jstate.pos, 2, jobj.mu,
                                     jobj.s_lambda)
    ref = np.transpose(np.asarray(yt), (0, 2, 1))
    assert part.shape == ref.shape
    assert _rel(part.numpy(), ref) <= TOL
    got = blocking.blocked_scatter_sum(part, obj.blocking).numpy()
    ref_g = np.asarray(jblocking.blocked_scatter_sum(yt, jobj.blocking,
                                                     obj.particle_cnt))
    assert np.isfinite(got).all()
    assert _rel(got, ref_g) <= TOL


def test_blocked_assemble_2d_matches_jax(grid):
    """K7a on triangles: padded element slots contribute nothing."""
    _, _, obj, _, _, jobj, _, _ = grid
    blk = obj.blocking
    cols = np.random.default_rng(3).standard_normal(
        (blk.num_blocks * blk.eb, 2, 2)).astype(np.float32)
    real = (blk.volume.numpy() > 0)[:, None, None]
    ref = np.asarray(jblocking.blocked_assemble(
        jobj.blocking, jnp.asarray(np.where(real, cols, 0.0)),
        obj.particle_cnt, 2))
    got = blocked_kernels.blocked_assemble(blk, torch.as_tensor(cols))
    assert blocked_kernels.blocked_assemble.launches == 0
    assert got.shape == (obj.particle_cnt, 2)
    assert _rel(got.numpy(), ref) <= TOL


# -- K5 and K8: the whole frames ---------------------------------------------

FRAME_MODES = {
    "implicit_cg": dict(frame_backend="blocked"),
    "implicit_cg unpreconditioned": dict(frame_backend="blocked",
                                         preconditioned=0),
    "explicit": dict(frame_backend="blocked_explicit",
                     use_explicit_method=True),
    "autodiff": dict(frame_backend="blocked_explicit",
                     use_explicit_method=True, auto_diff=True),
}


@pytest.mark.parametrize("mode", sorted(FRAME_MODES))
@pytest.mark.parametrize("where", ["golden scene", "16 subdivisions"])
def test_frame_2d_matches_jax(where, mode):
    """Three frames of K5's or K8's plain version (``make_frame_fn`` with
    ``frame_backend="blocked"`` or ``"blocked_explicit"``) against the JAX
    package's whole-frame kernels."""
    scene_ = _golden_scene(1) if where == "golden scene" else _grid_scene(2)
    pcfg, jcfg, obj, state, obs, jobj, jstate, jobs = scene_
    over = FRAME_MODES[mode]
    pcfg = dataclasses.replace(pcfg, **over)
    jcfg = dataclasses.replace(jcfg, **over)
    implicit_ = over["frame_backend"] == "blocked"
    eligible = (sim.supports_blocked_frame if implicit_
                else sim.supports_explicit_blocked_frame)
    assert eligible(obj, pcfg)
    frame = sim.make_frame_fn(obj, pcfg)
    jframe = jsim.make_frame_fn(jobj, jcfg)
    start, most = state.pos.clone(), 0
    for i in range(3):
        state, aux = frame(state, obs)
        jstate, jaux = jframe(jstate, jobs)
        np.testing.assert_allclose(state.pos.numpy(), np.asarray(jstate.pos),
                                   rtol=0, atol=TOL, err_msg=f"frame {i}")
        got = aux.solver_iterations.numpy()
        ref = np.asarray(jaux.solver_iterations)
        assert got.shape == ref.shape == (pcfg.sim_count,)
        if implicit_:
            assert ref.max() <= 20, ref
            assert np.all(np.abs(got - ref) <= 1), (i, got, ref)
            most = max(most, int(got.max()))
    assert torch.isfinite(state.pos).all()
    assert float((state.pos - start).abs().max()) > 1e-3
    assert most > 1 or not implicit_


# -- M12: scene.load_scene ---------------------------------------------------

def test_load_scene_two_bodies_matches_jax(capsys):
    """configs/demo_two_bodies.json: the same bodies (counts, masses,
    positions), obstacles and count prints as fem_tpu.scene.load_scene;
    then one frame of each body, the port's K8 plain frame against the JAX
    package's frame."""
    path = os.path.join(REPO, "configs", "demo_two_bodies.json")
    pcfg = pconfig.read_config(path)
    jcfg = jconfig.read_config(path)
    jbodies, jobs = jscene.load_scene(jcfg)
    jprinted = capsys.readouterr().out
    bodies, obs = scene.load_scene(pcfg, device="cpu")
    assert capsys.readouterr().out == jprinted
    assert jprinted.count("Vertex count") == 2
    assert len(bodies) == len(jbodies) == 2
    np.testing.assert_array_equal(obs.centers.numpy(), np.asarray(jobs.centers))
    np.testing.assert_array_equal(obs.radii.numpy(), np.asarray(jobs.radii))
    for body, jbody in zip(bodies, jbodies):
        for name in ("particle_cnt", "element_cnt", "mesh_cnt", "dim"):
            assert getattr(body.obj, name) == getattr(jbody.obj, name), name
        assert body.obj.blocking.num_blocks == 1
        for name in ("mass", "volume", "ref_inv", "element_indices"):
            np.testing.assert_array_equal(
                getattr(body.obj, name).numpy(),
                np.asarray(getattr(jbody.obj, name)), err_msg=name)
        np.testing.assert_array_equal(body.state.pos.numpy(),
                                      np.asarray(jbody.state.pos))
        cfg = dataclasses.replace(pcfg, frame_backend="blocked_explicit")
        assert sim.supports_explicit_blocked_frame(body.obj, cfg)
        s, _ = sim.make_frame_fn(body.obj, cfg)(body.state, obs)
        js, _ = jsim.make_frame_fn(jbody.obj, jcfg)(jbody.state, jobs)
        np.testing.assert_allclose(s.pos.numpy(), np.asarray(js.pos), rtol=0,
                                   atol=TOL)
        assert float((s.pos - body.state.pos).abs().max()) > 1e-4


def test_load_scene_matches_load_config():
    """A single-body config builds the same body through load_scene as
    through entry.load_config."""
    from fem_tpu_torch import entry

    path = os.path.join(REPO, "configs", "default.json")
    cfg, obj, state, obs = entry.load_config(path, "cpu")
    bodies, sobs = scene.load_scene(cfg, device="cpu")
    assert len(bodies) == 1
    for name in ("mass", "ref_inv", "element_indices", "rest_pos"):
        assert torch.equal(getattr(bodies[0].obj, name), getattr(obj, name))
    assert torch.equal(bodies[0].state.pos, state.pos)
    assert torch.equal(sobs.centers, obs.centers)
