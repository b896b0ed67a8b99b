# coding=utf-8
"""J1's level schedule on the CPU: the plan, its plain sweep and the route.

* ``level_plan`` on the flagship (``configs/demo_spot.json``: 1,007 rows,
  70 levels, the widest 100), on ``configs/demo_passage_jacobi.json`` (121
  rows, 20 levels, the widest 11) and on a synthetic asymmetric table: in
  each, every row's lower neighbours (j < i with j ∈ nb[i] or i ∈ nb[j])
  sit in earlier levels and its upper neighbours in later ones, and the
  order lists each row once, ascending within a level;
* ``jacobi_levels_plain`` against ``jacobi_serial_plain`` (J1's plain row
  loop) on those meshes' systems: equal iterations, x and the anchor within
  1e-6 of their largest entry in float32 (the level sweep batches each
  level's products, so the sums round in another order) and 1e-12 in
  float64;
* ``jacobi_levels_plain`` against the JAX package's
  ``jacobi_solve_serial_sparse`` on the passage mesh squashed and moving
  and on a 3D grid cube: equal iterations, x within 1e-5;
* ``jacobi_plan``'s routing (the level variant for the sparse rows, staged
  where they fit, and for the dense rows given their pattern's level
  count; the serial variant for the dense rows alone and where the level
  tables overflow a CTA) and its ``ValueError``s, and the level binding
  built once a table;
* the dense rows on the schedule of their pattern: on ``default.json`` and
  the passage mesh every nonzero block of ``assemble_dense_system``'s A
  lies in ``jacobi_nb``'s pattern or is a lone particle's identity block;
  ``jacobi_levels_plain`` over the dense rows with that pattern against
  ``jacobi_serial_plain`` over them (equal iterations, x and the anchor
  within 1e-6 of their largest entry in float32, 1e-12 in float64) and
  against the JAX package's dense ``jacobi_solve_serial`` on the passage
  mesh squashed and moving (equal iterations, x within 1e-5).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu.models.mesh import construct_2d_mesh
from fem_tpu.models.state import build_object as jax_build_object
from fem_tpu.solvers import dense as jdense
from fem_tpu.ops.element import hessian_blocks as jax_hessian_blocks
from fem_tpu.solvers import implicit as jimplicit
from fem_tpu.utils import config as jconfig
from fem_tpu_torch import convert, entry
from fem_tpu_torch.ops import element_kernels
from fem_tpu_torch.ops import jacobi_kernels as jk
from fem_tpu_torch.ops.assembly import element_contrib_full, gather_assemble
from fem_tpu_torch.solvers import dense, implicit
from tests.utils import make_3d_object

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PASSAGE = os.path.join(REPO, "configs", "demo_passage_jacobi.json")
DEFAULT = os.path.join(REPO, "configs", "default.json")
DT = 5e-4


def _t(a):
    return torch.tensor(np.asarray(a))


def _check_levels(nb, plan):
    """Every row once in the order, ascending within a level; each row's
    lower neighbours in earlier levels, its upper ones in later levels; each
    warp's positions (the level's w, w + 32, ...) chained through
    ``first_row`` and ``next_row`` in ascending order, every position
    once."""
    n = nb.shape[0]
    walked = []
    for w in range(32):
        p, mine = int(plan.first_row[w]), []
        while p >= 0:
            mine.append(p)
            p = int(plan.next_row[p])
        want = [q for lv in range(plan.levels)
                for q in range(plan.level_start[lv] + w,
                               plan.level_start[lv + 1], 32)]
        assert mine == want, w
        walked += mine
    assert sorted(walked) == list(range(n))
    assert plan.next_row.dtype == plan.first_row.dtype == np.int32
    assert sorted(plan.order.tolist()) == list(range(n))
    assert plan.level_start[0] == 0 and plan.level_start[-1] == n
    assert len(plan.level_start) == plan.levels + 1
    level = np.empty(n, np.int64)
    for lv in range(plan.levels):
        rows = plan.order[plan.level_start[lv]:plan.level_start[lv + 1]]
        assert rows.size > 0 and np.all(np.diff(rows) > 0)
        level[rows] = lv
    for i in range(n):
        for j in nb[i]:
            if j < 0 or j == i:
                continue
            lo, hi = min(i, j), max(i, j)
            assert level[lo] < level[hi], (i, j)


@pytest.fixture(scope="module")
def flagship():
    _, obj, state, _ = entry.flagship("cpu")
    return obj, entry.deformed(state)


def _squashed(path, seed):
    """The config's body squashed to 110 % across and 80 % up and moving
    at random (numpy seed): the solve iterates."""
    cfg, obj, state, _ = entry.load_config(path, "cpu")
    rng = np.random.default_rng(seed)
    pos = state.pos.numpy()
    c = pos.mean(axis=0, keepdims=True)
    pos = (c + (pos - c) * np.array([1.1, 0.8])).astype(np.float32)
    vel = rng.uniform(-0.3, 0.3, pos.shape).astype(np.float32)
    return obj, state.replace(pos=_t(pos), vel=_t(vel))


@pytest.fixture(scope="module")
def passage():
    """demo_passage_jacobi.json's body squashed and moving (numpy seed 3)."""
    return _squashed(PASSAGE, 3)


@pytest.fixture(scope="module")
def default_body():
    """default.json's square squashed and moving (numpy seed 7)."""
    return _squashed(DEFAULT, 7)


def _system(obj, state, dtype):
    """The sparse rows, b and a zero anchor of one substep at ``state``."""
    K, H = element_kernels.hessian_and_force(
        state.pos, obj.element_indices, obj.ref_inv, obj.volume, obj.mu,
        obj.s_lambda)
    f = gather_assemble(element_contrib_full(H), obj.plan.idx)
    b = state.vel + DT * f / obj.mass[:, None]
    rows = implicit.sparse_system_rows(obj, K, DT)
    return rows.to(dtype), b.to(dtype), torch.zeros_like(b, dtype=dtype)


def _dense_system(obj, state, dtype):
    """The dense rows (N·d, N·d), b and a numpy-noise anchor of one substep
    at ``state`` (the dense backend's assembly)."""
    K, H = element_kernels.hessian_and_force(
        state.pos, obj.element_indices, obj.ref_inv, obj.volume, obj.mu,
        obj.s_lambda)
    f = gather_assemble(element_contrib_full(H), obj.plan.idx)
    b = state.vel + DT * f / obj.mass[:, None]
    a = dense.assemble_dense_system(obj, K, DT)
    rng = np.random.default_rng(11)
    past = _t(rng.normal(scale=0.01, size=tuple(b.shape)).astype(np.float32))
    return a.to(dtype), b.to(dtype), past.to(dtype)


# -- the plan ----------------------------------------------------------------

@pytest.mark.parametrize("mesh,levels,widest", [("flagship", 70, 100),
                                                ("passage", 20, 11)])
def test_level_plan_of_the_shipped_meshes(request, mesh, levels, widest):
    obj, _ = request.getfixturevalue(mesh)
    nb = obj.jacobi_nb.numpy()
    plan = jk.level_plan(obj.jacobi_nb)
    assert plan.order.dtype == np.int32 and plan.level_start.dtype == np.int32
    assert plan.levels == levels
    assert int(np.diff(plan.level_start).max()) == widest
    _check_levels(nb, plan)
    # The same plan from a numpy table.
    again = jk.level_plan(nb)
    assert np.array_equal(again.order, plan.order)
    assert np.array_equal(again.level_start, plan.level_start)


def test_level_plan_of_an_asymmetric_table():
    """Row 0 names row 5 but row 5 does not name row 0 (and row 3 names row
    1 alone): the plan still puts each below the other's level."""
    nb = np.array([[0, 5, -1], [1, 2, -1], [1, 2, 3], [3, 1, -1],
                   [4, -1, -1], [5, 4, -1]], np.int32)
    plan = jk.level_plan(nb)
    _check_levels(nb, plan)
    level = np.empty(6, np.int64)
    for lv in range(plan.levels):
        level[plan.order[plan.level_start[lv]:plan.level_start[lv + 1]]] = lv
    assert level.tolist() == [0, 0, 1, 2, 0, 1]
    # No lower neighbour at all: one level.
    lone = jk.level_plan(np.array([[0, -1], [1, -1]], np.int32))
    assert lone.levels == 1 and lone.order.tolist() == [0, 1]


# -- the plain level sweep ---------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("mesh", ["flagship", "passage"])
def test_level_sweep_matches_the_serial_row_loop(request, mesh, dtype, tol):
    obj, state = request.getfixturevalue(mesh)
    rows, b, past = _system(obj, state, dtype)
    ref = jk.jacobi_serial_plain(rows, b, past, obj.jacobi_nb)
    got = jk.jacobi_levels_plain(rows, b, past, obj.jacobi_nb)
    assert int(got.iterations) == int(ref.iterations) > 1
    for g, r in ((got.x, ref.x), (got.past_x, ref.past_x)):
        top = float(r.abs().max())
        assert float((g - r).abs().max()) <= tol * top
    assert abs(float(got.error) - float(ref.error)) <= tol * float(
        b.abs().max())
    # On the CPU either variant is the row loop itself.
    cpu = jk.jacobi_serial(rows, b, past, obj.jacobi_nb, variant="levels")
    assert all(torch.equal(x, y) for x, y in zip(cpu, ref))


def _jax_twin_passage():
    """(JAX object, JAX state): the passage body squashed and moving
    (numpy seed 3), as tests/test_torch_jacobi.py moves it."""
    import json

    with open(PASSAGE) as fh:
        jcfg = jconfig.parse_config(json.load(fh))
    v, f, t = construct_2d_mesh(jcfg.objects[0])
    jobj, jstate = jax_build_object(jcfg.objects[0], v, f, t)
    rng = np.random.default_rng(3)
    pos = np.asarray(jstate.pos)
    c = pos.mean(axis=0, keepdims=True)
    pos = (c + (pos - c) * np.array([1.1, 0.8])
           + rng.uniform(-0.002, 0.002, pos.shape)).astype(np.float32)
    vel = rng.uniform(-0.3, 0.3, pos.shape).astype(np.float32)
    return jobj, jstate.replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel))


def _jax_twin_cube():
    """(JAX object, JAX state): the 3×3×3 grid cube moved by numpy noise."""
    _, jobj, jstate = make_3d_object(subdivisions=3)
    rng = np.random.default_rng(9)
    pos = (np.asarray(jstate.pos)
           + rng.normal(scale=0.004, size=jstate.pos.shape)).astype(
               np.float32)
    vel = rng.normal(scale=0.1, size=pos.shape).astype(np.float32)
    return jobj, jstate.replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel))


@pytest.mark.parametrize("twin", ["passage", "cube"])
def test_level_sweep_matches_jax(twin):
    jobj, jstate = {"passage": _jax_twin_passage,
                    "cube": _jax_twin_cube}[twin]()
    arrays = {n: np.asarray(getattr(jobj, n)) for n in convert.OBJECT_ARRAYS}
    statics = {n: getattr(jobj, n) for n in convert.OBJECT_STATICS}
    obj = convert.object_from_arrays(arrays, statics, "cpu")
    K = jax_hessian_blocks(jstate.pos, jobj.element_indices, jobj.ref_inv,
                           jobj.volume, jobj.mu, jobj.s_lambda)
    b = jimplicit.implicit_rhs(jobj, jstate, DT)
    jrows = jimplicit.sparse_system_rows(jobj, K, DT)
    rng = np.random.default_rng(5)
    past = rng.normal(scale=0.01, size=b.shape).astype(np.float32)
    jres = jimplicit.jacobi_solve_serial_sparse(jobj.jacobi_nb, jrows, b,
                                                jnp.asarray(past))
    res = jk.jacobi_levels_plain(_t(jrows), _t(b), _t(past), obj.jacobi_nb)
    assert int(res.iterations) == int(jres.iterations) > 1
    top = max(float(np.abs(np.asarray(jres.x)).max()), 1.0)
    for got, want in ((res.x, jres.x), (res.past_x, jres.past_x)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5 * top)


@pytest.mark.parametrize("path", [DEFAULT, PASSAGE])
def test_dense_rows_lie_in_the_pattern(path):
    """Every nonzero block of the dense backend's A sits at (i,
    jacobi_nb[i, k]) or is the identity block of a particle in no element:
    what the dense level schedule relies on."""
    _, obj, state, _ = entry.load_config(path, "cpu")
    a, _, _ = _dense_system(obj, state, torch.float64)
    n, d = obj.particle_cnt, obj.dim
    blocks = a.reshape(n, d, n, d).permute(0, 2, 1, 3)
    nonzero = (blocks != 0).any(dim=-1).any(dim=-1)
    nb = obj.jacobi_nb.long()
    allowed = torch.zeros((n, n), dtype=torch.bool)
    rows = torch.arange(n)[:, None].expand_as(nb)
    allowed[rows[nb >= 0], nb[nb >= 0]] = True
    lone = ~(nb == torch.arange(n)[:, None]).any(dim=1)
    allowed[lone, lone] = True
    assert bool(nonzero.any()) and not bool((nonzero & ~allowed).any())
    eye = torch.eye(d, dtype=blocks.dtype)
    assert all(torch.equal(blocks[i, i], eye) for i in
               torch.nonzero(lone).flatten().tolist())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("mesh", ["default_body", "passage"])
def test_dense_level_sweep_matches_the_serial_row_loop(request, mesh, dtype,
                                                       tol):
    obj, state = request.getfixturevalue(mesh)
    a, b, past = _dense_system(obj, state, dtype)
    ref = jk.jacobi_serial_plain(a, b, past)
    got = jk.jacobi_levels_plain(a, b, past, None, pattern=obj.jacobi_nb)
    assert int(got.iterations) == int(ref.iterations) > 1
    for g, r in ((got.x, ref.x), (got.past_x, ref.past_x)):
        top = float(r.abs().max())
        assert float((g - r).abs().max()) <= tol * top
    assert abs(float(got.error) - float(ref.error)) <= tol * float(
        b.abs().max())
    # On the CPU the wrapper is the serial row loop, pattern or not; a
    # pattern beside the sparse table is refused.
    cpu = implicit.jacobi_solve_serial(a, b, past, pattern=obj.jacobi_nb)
    assert all(torch.equal(x, y) for x, y in zip(cpu, ref))
    with pytest.raises(ValueError, match="dense rows only"):
        jk.jacobi_serial(a, b, past, obj.jacobi_nb, pattern=obj.jacobi_nb)
    with pytest.raises(ValueError, match="not with nb_ids"):
        jk.jacobi_levels_plain(a, b, past, obj.jacobi_nb,
                               pattern=obj.jacobi_nb)


def test_dense_level_sweep_matches_jax():
    """The passage mesh squashed and moving: the dense rows' level sweep
    against the JAX package's dense serial sweep, equal iterations, x and
    the anchor within 1e-5."""
    jobj, jstate = _jax_twin_passage()
    arrays = {n: np.asarray(getattr(jobj, n)) for n in convert.OBJECT_ARRAYS}
    statics = {n: getattr(jobj, n) for n in convert.OBJECT_STATICS}
    obj = convert.object_from_arrays(arrays, statics, "cpu")
    K = jax_hessian_blocks(jstate.pos, jobj.element_indices, jobj.ref_inv,
                           jobj.volume, jobj.mu, jobj.s_lambda)
    b = jimplicit.implicit_rhs(jobj, jstate, DT)
    a = jdense.assemble_dense_system(jobj, K, DT)
    rng = np.random.default_rng(5)
    past = rng.normal(scale=0.01, size=b.shape).astype(np.float32)
    jres = jimplicit.jacobi_solve_serial(a, b, jnp.asarray(past))
    res = jk.jacobi_levels_plain(_t(a), _t(b), _t(past), None,
                                 pattern=obj.jacobi_nb)
    assert int(res.iterations) == int(jres.iterations) > 1
    top = max(float(np.abs(np.asarray(jres.x)).max()), 1.0)
    for got, want in ((res.x, jres.x), (res.past_x, jres.past_x)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5 * top)


def test_level_sweep_refuses_the_dense_rows():
    with pytest.raises(ValueError, match="sparse rows"):
        jk.jacobi_levels_plain(torch.eye(4), torch.ones(2, 2),
                               torch.zeros(2, 2), None)


# -- the route ---------------------------------------------------------------

def test_jacobi_plan_routes_the_variants():
    # The flagship: 1,007 particles, 29 slots, 70 levels; its rows (1.05
    # MB) read from L2.
    plan = jk.jacobi_plan(1007, 3, 29, 70)
    assert (plan.variant, plan.threads, plan.slots, plan.levels,
            plan.staged) == ("levels", 1024, 1, 70, False)
    assert plan.smem == 4 * (5 * 1007 * 3 + 2 * 1007 + 71 + 32)
    # demo_passage_jacobi.json: its 13.5 KB of rows staged.
    plan = jk.jacobi_plan(121, 2, 7, 20)
    assert (plan.variant, plan.staged) == ("levels", True)
    assert plan.smem == 4 * (5 * 121 * 2 + 2 * 121 + 21 + 32) + 4 * 121 * 7 * 5
    # The dense rows stay serial; so do sparse rows forced serial.
    assert jk.jacobi_plan(121, 2, None).variant == "serial"
    assert jk.jacobi_plan(121, 2, None).dense
    assert jk.jacobi_plan(1007, 3, 29, 70, "serial") == jk.serial_plan(
        1007, 3, 29)
    # Past a CTA with the level tables, within it without: serial.
    n = 4000  # 4·N·d floats fit, 5·N·d + 2·N + L + 33 words do not
    assert 16 * n * 3 <= jk.SERIAL_MAX_SMEM < 4 * (5 * n * 3 + 2 * n + 34)
    assert jk.jacobi_plan(n, 3, 29, 1).variant == "serial"
    # Slots a lane, as the serial variant's.
    assert jk.jacobi_plan(100, 3, 33, 5).slots == 2
    assert jk.jacobi_plan(100, 3, 128, 5).slots == 4


def test_jacobi_plan_routes_the_dense_rows_with_a_pattern():
    # default.json's dense rows with its table's 20 levels: the level
    # variant, the rows read from L2 (234 KB pass a CTA).
    plan = jk.jacobi_plan(121, 2, None, 20)
    assert (plan.variant, plan.dense, plan.threads, plan.slots, plan.levels,
            plan.staged) == ("levels", True, 1024, 0, 20, False)
    assert plan.smem == 4 * (5 * 121 * 2 + 2 * 121 + 21 + 32)
    # No pattern, or forced serial: the serial variant.
    assert jk.jacobi_plan(121, 2, None) == jk.serial_plan(121, 2, None)
    assert jk.jacobi_plan(121, 2, None, 20, "serial") == jk.serial_plan(
        121, 2, None)
    assert jk.jacobi_plan(121, 2, None, 20, "levels") == plan
    # Past a CTA with the level tables: serial, or refused when forced.
    assert jk.jacobi_plan(4000, 3, None, 1).variant == "serial"
    with pytest.raises(ValueError, match="shared memory"):
        jk.jacobi_plan(4000, 3, None, 1, "levels")
    with pytest.raises(ValueError, match="level count"):
        jk.jacobi_plan(121, 2, None, 0)


@pytest.mark.parametrize("args,match", [
    ((121, 2, None, None, "levels"), "sparse rows"),
    ((4000, 3, 29, 1, "levels"), "shared memory"),
    ((100, 3, 29, None), "level count"),
    ((100, 3, 29, 5, "grid"), "unknown J1 variant"),
    ((5000, 3, 29, 5), "shared memory"),
    ((100, 3, 129, 5), "slots"),
    ((100, 4, 29, 5), "dim"),
    ((0, 3, 29, 5), "particle"),
])
def test_jacobi_plan_refusals(args, match):
    with pytest.raises(ValueError, match=match):
        jk.jacobi_plan(*args)


def test_wrapper_refuses_an_unknown_variant(passage):
    obj, state = passage
    rows, b, past = _system(obj, state, torch.float32)
    with pytest.raises(ValueError, match="unknown J1 variant"):
        jk.jacobi_serial(rows, b, past, obj.jacobi_nb, variant="warp")


def test_level_binding_is_built_once_a_table(passage):
    obj, _ = passage
    nb = obj.jacobi_nb.clone()
    first = jk.level_binding(nb)
    assert jk.level_binding(nb) is first
    assert first.order.dtype == torch.int32
    assert first.order.tolist() == first.plan.order.tolist()
    assert first.level_start.tolist() == first.plan.level_start.tolist()
    nb[0, 1] = nb[0, 1]  # changed in place: built again
    assert jk.level_binding(nb) is not first
    assert jk.level_binding(nb.clone()) is not jk.level_binding(nb)


# -- the level variant's warp sums, emulated ---------------------------------

def _butterfly(v):
    """csrc/jacobi_serial.cu's warp_sum over 32 lanes in float32: every
    lane's value after v += shfl_xor(v, m), m = 16, 8, 4, 2, 1."""
    v = v.astype(np.float32)
    for m in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ m]).astype(np.float32)
    return v


def _warp_sums_to_lane(acc):
    """csrc/jacobi_serial.cu's warp_sums_to_lane over 32 lanes of
    acc (32, D) in float32: what lanes 0..D-1 return."""
    lane = np.arange(32)
    d = acc.shape[1]
    hi16 = (lane & 16) != 0
    x16 = lane ^ 16
    if d == 3:
        send0 = np.where(hi16, acc[:, 0], acc[:, 2])
        send1 = np.where(hi16, acc[:, 1], 0.0).astype(np.float32)
        b0 = (np.where(hi16, acc[:, 2], acc[:, 0]) + send0[x16]).astype(
            np.float32)
        b1 = (np.where(hi16, 0.0, acc[:, 1]).astype(np.float32)
              + send1[x16]).astype(np.float32)
        hi8 = (lane & 8) != 0
        send = np.where(hi8, b0, b1)
        c = (np.where(hi8, b1, b0) + send[lane ^ 8]).astype(np.float32)
        steps, stride = (4, 2, 1), 8
    else:
        send = np.where(hi16, acc[:, 0], acc[:, 1])
        c = (np.where(hi16, acc[:, 1], acc[:, 0]) + send[x16]).astype(
            np.float32)
        steps, stride = (8, 4, 2, 1), 16
    for m in steps:
        c = (c + c[lane ^ m]).astype(np.float32)
    return c[(stride * lane[:d]) & 31]


@pytest.mark.parametrize("d", [2, 3])
def test_warp_sums_to_lane_are_the_butterfly_bit_for_bit(d):
    """The level variant's product sums (D + 4 shuffles) equal the serial
    variant's butterfly (5·D shuffles) bit for bit, over values spread
    across 12 decades with cancellations and idle lanes of zeros."""
    rng = np.random.default_rng(4)
    for trial in range(200):
        acc = (rng.standard_normal((32, d))
               * 10.0 ** rng.integers(-6, 6, (32, d))).astype(np.float32)
        acc[rng.integers(29, 33):] = 0.0  # lanes past max_nb add zeros
        want = np.array([_butterfly(acc[:, k])[0] for k in range(d)])
        got = _warp_sums_to_lane(acc)
        assert got.tobytes() == want.astype(np.float32).tobytes(), trial
