# coding=utf-8
"""Element sharding (``fem_tpu_torch/parallel/sharding.py``, ROADMAP M20)
over gloo ranks on the CPU against the JAX package's ``parallel/
sharding.py`` on as many virtual CPU devices, and against the port's
single-device path.

The ranks run in two worlds started once for the module, as child
processes that never import JAX (tests/torch_shard_ranks.py): every case
of ``torch_shard_ranks.CASES``, the contact frames and the sharded
``Simulation`` in a world of 4 ranks, the (batch × elem) mesh in a world of
2 × 4; each returns its results as numpy.  While they run, each test here
builds the JAX package's reference from the same config dict and seed.
Every process group has a timeout, so a rank that hangs fails the test.

Tolerances, the JAX package's (tests/test_sharding.py): positions rtol
1e-5, atol 1e-6; velocities rtol 1e-4, atol 1e-5; contact 1e-4 / 1e-5;
CG iterations equal (Newton's inner totals within 3 a substep, as
tests/test_torch_newton.py holds them).  Every rank returns the same
state, bit for bit.  The unit tests below hold ``shard_blocking`` and
``pad_elements`` on their own: the ranks' K3 and K2 partials summed equal
the unsharded products, padded blocks and padded elements contribute 0.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu import batch as jbatch
from fem_tpu.api import Simulation as JaxSimulation
from fem_tpu.models import mesh as jmesh
from fem_tpu.models.state import Obstacles as JaxObstacles
from fem_tpu.models.state import build_object as jax_build_object
from fem_tpu.parallel import sharding as jsharding
from fem_tpu.utils import config as jconfig
from fem_tpu_torch.ops.blocked_kernels import (
    blocked_graph_apply_plain,
    blocked_prep_force_plain,
)
from fem_tpu_torch.ops.blocking import shard_blocking
from fem_tpu_torch.parallel import sharding
from fem_tpu_torch.parallel.launch import start_ranks
from tests import torch_shard_ranks as R

torch.set_num_threads(1)

POS = dict(rtol=1e-5, atol=1e-6)
VEL = dict(rtol=1e-4, atol=1e-5)
CONTACT = dict(rtol=1e-4, atol=1e-5)


class _Worlds:
    """The two worlds of ranks, started at once, each collected once."""

    def __init__(self):
        self._runs = {
            "elem": start_ranks(R.element_world, R.WORLD, timeout=240),
            "batch": start_ranks(R.batch_world, int(np.prod(R.BATCH_MESH)),
                                 timeout=240),
        }
        self._results = {}

    def __getitem__(self, name):
        if name not in self._results:
            self._results[name] = self._runs[name].results()
        return self._results[name]

    def stop(self):
        for run in self._runs.values():
            run.stop()


@pytest.fixture(scope="module")
def worlds():
    w = _Worlds()
    yield w
    w.stop()


def _jax_scene(data):
    cfg = jconfig.parse_config(data)
    build = (jmesh.construct_2d_mesh if cfg.dim == 2
             else jmesh.construct_3d_grid_mesh)
    built = [jax_build_object(o, *build(o)) for o in cfg.objects]
    obstacles = JaxObstacles.from_configs(cfg.blocks, cfg.dim, cfg.obstacles)
    return cfg, built, obstacles


def _assert_state(got, ref, iters=True, newton=False):
    np.testing.assert_allclose(got["pos"], np.asarray(ref["pos"]), **POS)
    np.testing.assert_allclose(got["vel"], np.asarray(ref["vel"]), **VEL)
    if "plastic_inv" in ref:
        np.testing.assert_allclose(got["plastic_inv"],
                                   np.asarray(ref["plastic_inv"]), **VEL)
    if iters:
        a = np.atleast_1d(got["iterations"])
        b = np.atleast_1d(np.asarray(ref["iterations"]))
        if newton:
            assert np.all(np.abs(a - b) <= 3), (a, b)
        else:
            np.testing.assert_array_equal(a, b)


def _same_on_every_rank(results, key):
    first = results[0][key][0]
    for rank in results[1:]:
        got = rank[key][0]
        if isinstance(first, dict):
            for k in first:
                np.testing.assert_array_equal(got[k], first[k], err_msg=k)
        else:
            for a, b in zip(got, first):
                a = a if not isinstance(a, dict) else a["pos"]
                b = b if not isinstance(b, dict) else b["pos"]
                np.testing.assert_array_equal(a, b)


def _jax_case(name):
    kind, data, noise = R.CASES[name]
    cfg, [(obj, state)], obstacles = _jax_scene(data)
    vel = R.velocity_noise(tuple(state.pos.shape), noise)
    if vel is not None:
        state = state.replace(vel=jnp.asarray(vel))
    mesh = jsharding.make_element_mesh(R.WORLD)
    make = (jsharding.make_sharded_frame_fn if kind == "frame"
            else jsharding.make_sharded_substep_fn)
    out, aux = make(obj, cfg, mesh)(state, obstacles)
    ref = {"pos": out.pos, "vel": out.vel,
           "iterations": aux.solver_iterations}
    if out.plastic_inv is not None:
        ref["plastic_inv"] = out.plastic_inv
    return ref


@pytest.mark.parametrize("name", list(R.CASES))
def test_sharded_case_matches_jax_and_single_device(worlds, name):
    """One case of the table: the port's 4 ranks against the JAX package's
    sharded function on 4 virtual devices and against the port's
    single-device substep or frame (equal iterations with both)."""
    ref = _jax_case(name)
    results = worlds["elem"]
    got, single = results[0][name]
    newton = "newton" in name
    _assert_state(got, ref, newton=newton)
    _assert_state(got, single, newton=newton)
    _same_on_every_rank(results, name)
    if "cg" in name or name in ("3d-frame", "block-jacobi", "precond-none"):
        assert int(np.max(got["iterations"])) > 0


@pytest.mark.parametrize("name", list(R.CONTACT))
def test_sharded_contact_matches_jax(worlds, name):
    """The 2D pair coupled by penalty contact, 4 frames: the sharded
    contact frame against the JAX package's on 4 devices and against the
    port's single-device contact frame."""
    cfg, built, obstacles = _jax_scene(R.CONTACT[name])
    frame = jsharding.make_sharded_contact_frame_fn(
        [o for o, _ in built], cfg, jsharding.make_element_mesh(R.WORLD))
    states = tuple(s for _, s in built)
    for _ in range(R.CONTACT_FRAMES):
        states, _aux = frame(states, obstacles)
    results = worlds["elem"]
    got, single = results[0][f"contact-{name}"]
    for g, s, j in zip(got, single, states):
        np.testing.assert_allclose(g["pos"], np.asarray(j.pos), **CONTACT)
        np.testing.assert_allclose(g["pos"], s["pos"], **CONTACT)
    _same_on_every_rank(results, f"contact-{name}")


def test_simulation_sharded_contact(worlds):
    """``Simulation(sharded=True)`` with penalty contact on 4 ranks against
    the JAX package's ``Simulation(sharded=True)`` and the port's
    unsharded ``Simulation``, 3 frames."""
    sim = JaxSimulation.from_dict(R.API_SPEC, sharded=True)
    for _ in range(R.API_FRAMES):
        sim.step_frame()
    results = worlds["elem"]
    got, single = results[0]["api-contact"]
    for i, (g, s) in enumerate(zip(got, single)):
        np.testing.assert_allclose(g, sim.positions(i), **CONTACT)
        np.testing.assert_allclose(g, s, **CONTACT)
    _same_on_every_rank(results, "api-contact")


def test_batch_by_elements(worlds):
    """The (batch × elem) = 2 × 4 mesh: 4 members over 2 batch ranks, each
    member's elements over 4, against the JAX package's
    ``make_batched_sharded_frame_fn`` on a 2 × 4 device mesh and the
    port's ``make_batched_frame_fn``; every rank holds all 4 members."""
    cfg, [(obj, state)], obstacles = _jax_scene(R.BATCH_CASE)
    states = jbatch.broadcast_state(state, R.MEMBERS)
    states = states.replace(pos=states.pos + jnp.asarray(
        R.batch_noise(tuple(states.pos.shape))))
    out, aux = jsharding.make_batched_sharded_frame_fn(
        obj, cfg, jsharding.make_2d_mesh(*R.BATCH_MESH))(states, obstacles)
    results = worlds["batch"]
    got, single = results[0]
    assert got["pos"].shape[0] == R.MEMBERS
    ref = {"pos": out.pos, "vel": out.vel,
           "iterations": aux.solver_iterations}
    _assert_state(got, ref)
    _assert_state(got, single)
    assert int(got["iterations"].max()) > 0
    for rank in results[1:]:
        np.testing.assert_array_equal(rank[0]["pos"], got["pos"])


# -- shard_blocking and pad_elements on their own -------------------------

def _port_object(sub=3, dim=3):
    data = R.BASE_3D if dim == 3 else R.BASE_2D
    data = R._with(data, {"subdivisions": sub})
    cfg, [(obj, state)], _ = R._scene(data)
    return obj, state


def _squashed(obj, state, seed=0):
    rng = np.random.default_rng(seed)
    return state.pos + torch.from_numpy(rng.normal(
        scale=2e-3, size=tuple(state.pos.shape)).astype(np.float32))


@pytest.mark.parametrize("world", [2, 4, 8])
def test_shard_blocking_partials_sum_to_the_unsharded_product(world):
    """K3's and K2's plain versions on each rank's blocks, summed over the
    ranks in rank order, equal the unsharded products within 1e-6 of the
    largest entry; each rank's K is the unsharded K's rows of its
    blocks."""
    obj, state = _port_object(sub=5)
    blk = obj.blocking
    pos = _squashed(obj, state)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=tuple(state.pos.shape)).astype(np.float32))
    K, f = blocked_prep_force_plain(blk, pos, obj.mu, obj.s_lambda)
    y = blocked_graph_apply_plain(blk, K, x)
    k_sum = f_sum = y_sum = 0.0
    for rank in range(world):
        local = shard_blocking(blk, rank, world)
        k_r, f_r = blocked_prep_force_plain(local, pos, obj.mu, obj.s_lambda)
        y_sum = y_sum + blocked_graph_apply_plain(local, k_r, x)
        f_sum = f_sum + f_r
        lb = local.num_blocks
        rows = slice(rank * lb * blk.eb, (rank + 1) * lb * blk.eb)
        real = min(rows.stop, K.shape[0])
        if rows.start < real:
            torch.testing.assert_close(k_r[:real - rows.start], K[rows.start:real],
                                       rtol=0, atol=0)
        k_sum = k_sum + float(k_r.abs().sum())
    for got, ref in ((y_sum, y), (f_sum, f)):
        assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
    assert k_sum == pytest.approx(float(K.abs().sum()), rel=1e-6)


def test_shard_blocking_padded_blocks_are_empty():
    """At 8 ranks the 3D grid's blocks pad to 8: the padded blocks hold no
    real element, an empty local plan and zero volume, and a rank of only
    padded blocks has an empty slot plan, so its K3 and K2 sums are 0."""
    obj, state = _port_object(sub=4)
    blk = obj.blocking
    world = 8
    assert blk.num_blocks < world
    last = shard_blocking(blk, world - 1, world)
    assert int(last.block_elements.sum()) == 0
    assert int(last.local_ptr.abs().sum()) == 0
    assert float(last.volume.abs().sum()) == 0.0
    assert int(last.slot_plan.ptr[-1]) == 0 and last.slot_plan.rows.numel() == 0
    pos = _squashed(obj, state)
    K, f = blocked_prep_force_plain(last, pos, obj.mu, obj.s_lambda)
    assert float(K.abs().max()) == 0.0 and float(f.abs().max()) == 0.0
    y = blocked_graph_apply_plain(last, K, pos)
    assert float(y.abs().max()) == 0.0


def test_shard_blocking_particles_outside_a_shard_sum_to_zero():
    """A particle that none of a rank's blocks holds has an empty slot
    range on that rank and its K3 and K2 rows are 0; the others keep their
    slots in ascending order, re-based on the rank's first block."""
    obj, state = _port_object(sub=5)
    blk = obj.blocking
    world = 2
    pos = _squashed(obj, state)
    x = torch.ones_like(pos)
    for rank in range(world):
        local = shard_blocking(blk, rank, world)
        held = torch.zeros(obj.particle_cnt, dtype=torch.bool)
        real = (torch.arange(local.pb)[None, :]
                < torch.bincount(local.slot_plan.rows.long() // local.pb,
                                 minlength=local.num_blocks)[:, None])
        held[local.block_particles[real].long()] = True
        counts = local.slot_plan.ptr[1:] - local.slot_plan.ptr[:-1]
        assert torch.equal(counts > 0, held)
        assert not bool(held.all())
        K, f = blocked_prep_force_plain(local, pos, obj.mu, obj.s_lambda)
        y = blocked_graph_apply_plain(local, K, x)
        assert float(f[~held].abs().max()) == 0.0
        assert float(y[~held].abs().max()) == 0.0
        rows = local.slot_plan.rows.long()
        for p in range(obj.particle_cnt):
            seg = rows[local.slot_plan.ptr[p]:local.slot_plan.ptr[p + 1]]
            assert bool((seg[1:] > seg[:-1]).all())
        assert int(rows.max()) < local.num_blocks * local.pb


def test_pad_elements_zero_contribution():
    """Padding repeats element 0 at volume 0 with zero Jacobi
    coefficients; ``shard_object``'s rows cover the padded range once, and
    the ranks' force assemblies sum to the unsharded one."""
    from fem_tpu_torch.ops.assembly import element_contrib_full
    from fem_tpu_torch.ops.element import implicit_force_columns

    obj, state = _port_object(sub=3, dim=2)  # 18 triangles
    padded = sharding.pad_elements(obj, 8)
    assert padded.element_cnt == 24 and obj.element_cnt == 18
    assert float(padded.volume[18:].abs().sum()) == 0.0
    assert torch.equal(padded.element_indices[18:],
                       obj.element_indices[:1].expand(6, -1))
    assert float(padded.jacobi_coeff[18:].abs().sum()) == 0.0
    assert torch.equal(padded.jacobi_slots[18:],
                       obj.jacobi_slots[:1].expand(6, -1))
    assert padded.edge_matrix is None
    pos = _squashed(obj, state)

    def force(o):
        cols = implicit_force_columns(pos, o.element_indices, o.ref_inv,
                                      o.volume, o.mu, o.s_lambda)
        from fem_tpu_torch.ops.assembly import gather_assemble

        return gather_assemble(element_contrib_full(cols), o.plan.idx)

    total = 0.0
    starts = []
    for rank in range(8):
        local = sharding.shard_object(obj, rank, 8, blocked=False)
        assert local.element_cnt == 3 and local.blocking is None
        starts.append(local.element_start)
        total = total + force(local)
    assert starts == list(range(0, 24, 3))
    ref = force(obj)
    assert float((total - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


def test_sharded_object_keeps_particle_arrays_and_plans():
    """``shard_object`` keeps every particle-space array whole and builds
    the rank's gather plan and Jacobi slot inverse over its rows; the
    sharded blocking is dropped off the blocked operator's configs
    (explicit, Jacobi), as ``_uses_blocked`` says."""
    obj, _ = _port_object(sub=3)
    local = sharding.shard_object(obj, 1, 4)
    assert local.particle_cnt == obj.particle_cnt
    assert torch.equal(local.mass, obj.mass)
    assert local.plan.idx.shape[0] == obj.particle_cnt
    assert int(local.plan.ptr[-1]) == local.element_cnt * 4
    assert local.blocking.num_blocks * 4 >= obj.blocking.num_blocks
    cfg = R.parse_config(R.BASE_3D)
    assert sharding._uses_blocked(obj, cfg)
    for over in (R.METHODS["explicit"], R.METHODS["jacobi"]):
        plain = dataclasses.replace(cfg, **over)
        assert not sharding._uses_blocked(obj, plain)
        assert sharding._prep_body(obj, plain, 1, 4).blocking is None
