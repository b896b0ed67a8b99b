# coding=utf-8
"""C2's warp variant on the CPU: its run table, its plan, its candidate
order and its d² pre-test (``fem_tpu_torch/csrc/contact_grid.cu``,
``ops/contact_kernels.py``).

* ``grid_runs``, the run table: each sorted rank's first rank of every
  cell of its 3^d neighbourhood and the rank past each row of three,
  equal to a numpy brute force (count of ids below the target) on two
  clouds in 2D and 3D, the bent strip, a tied cell past ``cap`` and F8's
  collapsed blob; its forward columns equal the JAX package's forward
  starts (``torch.searchsorted`` on ``cell_s + offs``);
* ``grid_plan``'s choices (the warp variant unless the thread variant is
  asked for, CTAs of 64 and 128) and refusals;
* the warp variant's candidate order, emulated in numpy float32: each
  vertex's segments read from the run table (forward own cell, forward
  cells, backward own cell, backward cells), the d² pre-test, the exact
  test and force, the hits added one after another.  Its candidate lists
  equal the thread variant's scans (``test_torch_broadphase``'s
  emulation) in order, and its forces equal ``grid_pair_forces_plain``
  and the JAX package's ``grid_contact_forces`` within 1e-5 of max |f|,
  with and without friction, the Coulomb cone and self-contact;
* the pre-test's threshold (``d2_threshold``) rejects no squared distance
  that the exact ``pen > 0`` test accepts, at radii 1e-3 to 0.1.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu import broadphase as jbp
from fem_tpu_torch import broadphase as bp
from fem_tpu_torch.ops import contact_kernels as ck
from tests.test_torch_broadphase import _bent_strip, _c2_enumeration, _two_clouds

torch.set_num_threads(1)

TOL = 1e-5
F32 = np.float32


def _tied(seed=2, n=200):
    """test_torch_broadphase's crowded cube: many vertices a cell."""
    rng = np.random.default_rng(seed)
    pos = (0.45 + 0.1 * rng.random((n, 3))).astype(F32)
    return pos, (rng.random(n) < 0.5).astype(np.int32)


def _blob(seed=4, n=150):
    """F8: a body off the unit domain, collapsed into the margin cells."""
    rng = np.random.default_rng(seed)
    return (np.asarray([2.0, 0.75, 2.0])
            + 0.3 * rng.standard_normal((n, 3))).astype(F32)


CASES = {
    "clouds_2d": lambda: (_two_clouds(d=2)[0], 0.06),
    "clouds_3d": lambda: (_two_clouds(d=3)[0], 0.06),
    "strip": lambda: (_bent_strip()[0], 0.05),
    "tied": lambda: (_tied()[0], 0.08),
    "f8_blob": lambda: (_blob(), 0.04),
}


def _sorted(pos, radius):
    cell, m = bp.grid_cells(torch.tensor(pos), radius)
    order = torch.argsort(cell, stable=True)
    return cell[order], order, m


# -- the run table -----------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_run_table_is_the_brute_force(case):
    pos, radius = CASES[case]()
    d = pos.shape[1]
    cell_s, _, m = _sorted(pos, radius)
    runs = ck.grid_runs(cell_s, m, d)
    assert runs.dtype == torch.int32 and runs.shape == (len(pos),
                                                        4 * 3 ** (d - 1))
    ids = cell_s.numpy().astype(np.int64)
    strides = np.array([m ** k for k in range(d - 1, -1, -1)])
    cells = list(itertools.product([-1, 0, 1], repeat=d))
    got = runs.numpy()
    for c, off in enumerate(cells):
        target = ids + int(np.dot(off, strides))
        lo = (ids[None, :] < target[:, None]).sum(1)
        hi = (ids[None, :] <= target[:, None]).sum(1)
        col = ck.run_column(c)
        np.testing.assert_array_equal(got[:, col], lo, err_msg=str(off))
        np.testing.assert_array_equal(got[:, col + 1], hi, err_msg=str(off))
    # The forward columns are the JAX package's forward starts.
    offs = torch.tensor(ck.forward_offsets_host(m, d), dtype=torch.int32)
    start = torch.searchsorted(cell_s, cell_s[:, None] + offs[None, :],
                               out_int32=True)
    assert torch.equal(runs[:, list(ck.forward_columns(d))], start)
    if case in ("tied", "f8_blob"):
        own = ck.run_column((3 ** d - 1) // 2)
        assert int((got[:, own + 1] - got[:, own]).max()) > 8  # past cap


def test_run_deltas_of_a_grid():
    # 2D, m = 22: rows dx = -1, 0, 1, each the cells dy = -1, 0, 1 and one
    # past them.
    assert ck.run_deltas_host(22, 2) == (-23, -22, -21, -20, -1, 0, 1, 2,
                                         21, 22, 23, 24)
    d3 = ck.run_deltas_host(22, 3)
    assert len(d3) == 36 and d3[:4] == (-507, -506, -505, -504)
    assert [d3[c] for c in ck.forward_columns(3)] == list(
        ck.forward_offsets_host(22, 3))
    assert ck.forward_columns(2) == (6, 8, 9, 10)


# -- the plan ----------------------------------------------------------------

def test_grid_plan_routes_the_variants():
    assert ck.grid_plan(304, 3, 8) == ck.GridPlan("warp", 64, 152)
    assert ck.grid_plan(24576, 3, 8) == ck.GridPlan("warp", 64, 12288)
    assert ck.grid_plan(1, 2, 1) == ck.GridPlan("warp", 64, 1)
    assert ck.grid_plan(202, 2, 8, "warp") == ck.grid_plan(202, 2, 8)
    assert ck.grid_plan(304, 3, 8, "thread") == ck.GridPlan("thread", 128, 3)
    assert ck.grid_plan(129, 2, 1, "thread").ctas == 2


@pytest.mark.parametrize("args,match", [
    ((0, 3, 8), "vertex"), ((10, 4, 8), "dim"), ((10, 3, 0), "cap"),
    ((10, 3, 8, "rows"), "unknown C2 variant")])
def test_grid_plan_refusals(args, match):
    with pytest.raises(ValueError, match=match):
        ck.grid_plan(*args)


def test_wrapper_reads_the_run_table_and_refuses_on_the_cpu():
    """On the CPU the wrapper runs the plain version over the run table's
    forward columns: the same forces as the plain version over the forward
    starts of an independent lookup, each variant; an unknown variant is
    refused as on CUDA."""
    pos, body = _two_clouds(d=3)
    pos_t, body_t = torch.tensor(pos), torch.tensor(body)
    cell_s, order, m = _sorted(pos, 0.06)
    runs = ck.grid_runs(cell_s, m, 3)
    offs = torch.tensor(ck.forward_offsets_host(m, 3), dtype=torch.int32)
    start = torch.searchsorted(cell_s, cell_s[:, None] + offs[None, :],
                               out_int32=True)
    args = (pos_t, None, None, body_t, cell_s, order)
    plain = ck.grid_pair_forces_plain(*args, start, offs, 0.06, 1e3, 8)
    by_runs = ck.grid_pair_forces(*args, runs, m, 0.06, 1e3, 8)
    thread = ck.grid_pair_forces(*args, runs, m, 0.06, 1e3, 8,
                                 variant="thread")
    assert torch.equal(by_runs, plain) and torch.equal(by_runs, thread)
    assert float(by_runs.abs().max()) > 0.0
    with pytest.raises(ValueError, match="unknown C2 variant"):
        ck.grid_pair_forces(*args, runs, m, 0.06, 1e3, 8, variant="rows")


# -- the warp variant's order, emulated --------------------------------------

def _dot(a, b):
    """csrc/contact_grid.cu's dot_rn over the last axis, in float32."""
    s = a[..., 0] * b[..., 0]
    for c in range(1, a.shape[-1]):
        s = s + a[..., c] * b[..., c]
    return s


def _warp_candidates(runs, i, cap, d):
    """Vertex i's candidate ranks in the warp variant's order: its
    segments from the run table (grid_warp_kernel's lanes)."""
    centre = (3 ** d - 1) // 2
    run = runs[i]
    own_lo, own_hi = run[ck.run_column(centre)], run[ck.run_column(centre) + 1]
    segs = [(i + 1, min(cap, own_hi - i - 1))]
    for o in range(centre):
        c = ck.run_column(centre + 1 + o)
        segs.append((run[c], min(cap, run[c + 1] - run[c])))
    first = max(own_lo, i - cap)
    segs.append((first, i - first))
    if i - own_lo < cap:
        for o in range(centre):
            c = ck.run_column(centre - 1 - o)
            segs.append((run[c], run[c + 1] - run[c]))
    return [int(f) + t for f, count in segs for t in range(count)]


def _warp_forces(pos, vel, rest, body, radius, k, cap, friction_c=0.0,
                 mu=0.0, mu_slope=0.0, self_contact=False, excl=None):
    """(forces in the input order, each vertex's candidate list): the warp
    variant in numpy float32 — the pre-test d² ≥ d2_threshold, the exact
    test and force of add_pair, the hits added in candidate order."""
    n, d = pos.shape
    excl = 2.5 * radius if excl is None else excl
    cell_s, order, m = _sorted(pos, radius)
    runs = ck.grid_runs(cell_s, m, d).numpy().astype(np.int64)
    order = order.numpy()
    zero = np.zeros((n, d), F32)
    p, b = pos[order], body[order]
    friction = vel is not None and friction_c > 0.0
    coulomb = vel is not None and mu > 0.0
    v = vel[order] if (friction or coulomb) else zero
    r = rest[order] if self_contact else zero
    rad, kk, floor = F32(radius), F32(k), F32(0.1 * radius)
    thr, excl2 = F32(ck.d2_threshold(radius)), F32(excl * excl)
    fc, mu32, slope = F32(friction_c), F32(mu), F32(mu_slope)
    out = np.zeros((n, d), F32)
    lists = []
    for i in range(n):
        js = np.asarray(_warp_candidates(runs, i, cap, d), np.int64)
        lists.append(js.tolist())
        acc = np.zeros(d, F32)
        if js.size:
            diff = p[i] - p[js]
            d2 = _dot(diff, diff)
            same = b[js] == b[i]
            if self_contact:
                rd = r[js] - r[i]
                admit = ~same | (_dot(rd, rd) > excl2)
            else:
                admit = ~same
            dist = np.sqrt(np.maximum(d2, F32(1e-18)))
            pen = np.maximum(rad - dist, F32(0.0))
            hit = ~(d2 >= thr) & admit & (pen > 0.0)
            coef = (kk * pen) / np.maximum(dist, floor)
            fp = coef[:, None] * diff
            dv = v[i] - v[js]
            if friction:
                cw = fc * (pen / rad)
                fp = fp - cw[:, None] * dv
            if coulomb:
                nh = diff / dist[:, None]
                vt = dv - _dot(dv, nh)[:, None] * nh
                speed = np.sqrt(np.maximum(_dot(vt, vt), F32(1e-24)))
                mag = np.minimum(slope * speed, mu32 * (kk * pen))
                fp = fp - (mag / speed)[:, None] * vt
            for q in np.flatnonzero(hit):
                acc = acc + fp[q]
        out[order[i]] = acc
    return out, lists


def _plain(pos, vel, rest, body, radius, k, **kw):
    t = lambda a: None if a is None else torch.tensor(a)  # noqa: E731
    return bp.grid_contact_forces(t(pos), t(body), t(rest), radius, k,
                                  vel=t(vel), **kw).numpy()


def _jax(pos, vel, rest, body, radius, k, **kw):
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    return np.asarray(jbp.grid_contact_forces(j(pos), j(body), j(rest),
                                              radius, k, vel=j(vel), **kw))


SCENES = {
    # (positions, body ids, rest, radius, cap, keywords)
    "clouds_2d": lambda: (*_two_clouds(d=2), None, 0.06, 16, {}),
    "clouds_3d_friction": lambda: (*_two_clouds(d=3), None, 0.06, 16,
                                   dict(friction_c=2.0)),
    "clouds_3d_coulomb": lambda: (*_two_clouds(d=3), None, 0.06, 8,
                                  dict(friction_c=1.5, mu=0.5,
                                       mu_slope=30.0)),
    "tied_cap2": lambda: (*_tied(), None, 0.08, 2, {}),
    "strip_self_coulomb": lambda: (_bent_strip()[0], np.zeros(80, np.int32),
                                   _bent_strip()[1], 0.05, 16,
                                   dict(self_contact=True, mu=0.4,
                                        mu_slope=20.0, friction_c=0.5)),
    "f8_blob_self": lambda: (_blob(), np.zeros(150, np.int32), _blob(),
                             0.04, 8, dict(self_contact=True,
                                           excl_radius=0.0)),
}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_warp_order_matches_plain_and_jax(scene):
    pos, body, rest, radius, cap, kw = SCENES[scene]()
    vel = np.random.default_rng(1).standard_normal(pos.shape).astype(F32)
    self_contact = kw.get("self_contact", False)
    excl = kw.get("excl_radius")
    got, lists = _warp_forces(
        pos, vel, rest, body, radius, 1e3, cap, kw.get("friction_c", 0.0),
        kw.get("mu", 0.0), kw.get("mu_slope", 0.0), self_contact, excl)
    # The warp variant's candidates are the thread variant's scans, in
    # order: forward, then backward.
    cell_s, _, m = _sorted(pos, radius)
    offs = np.asarray(ck.forward_offsets_host(m, pos.shape[1]))
    start = ck.grid_runs(cell_s, m, pos.shape[1])[
        :, list(ck.forward_columns(pos.shape[1]))].numpy()
    fwd, bwd = _c2_enumeration(cell_s.numpy(), start, offs, cap)
    assert lists == [f + b for f, b in zip(fwd, bwd)]
    ref = _plain(pos, vel, rest, body, radius, 1e3, cap=cap, **kw)
    jref = _jax(pos, vel, rest, body, radius, 1e3, cap=cap, **kw)
    top = float(np.abs(ref).max())
    assert top > 0.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * top)
    np.testing.assert_allclose(got, jref, rtol=0, atol=TOL * top)
    assert float(np.abs(got.sum(0)).max()) <= TOL * float(np.abs(got).sum())


# -- the pre-test ------------------------------------------------------------

@pytest.mark.parametrize("radius", np.geomspace(1e-3, 0.1, 9).tolist())
def test_d2_pre_test_rejects_only_what_the_exact_test_rejects(radius):
    """Every float32 d² at or above the threshold gives pen = 0 in the
    exact test (the float32 root, r − dist, max with 0): the 4,096 floats
    from 2,048 below the threshold up, squared lengths of random float32
    difference vectors around the radius, and the first d² the exact test
    rejects lies within 64 ulps below the threshold (whose margin is
    (1 + 2⁻²⁰)² of r², ~16-32 ulps)."""
    thr = F32(ck.d2_threshold(radius))
    r = F32(radius)

    def pen(d2):
        return np.maximum(r - np.sqrt(np.maximum(d2, F32(1e-18))), F32(0.0))

    walk = thr.view(np.int32) + np.arange(-2048, 2048, dtype=np.int32)
    d2 = walk.view(F32)
    assert (pen(d2[d2 >= thr]) == 0.0).all()
    rng = np.random.default_rng(int(radius * 1e6))
    u = rng.standard_normal((20000, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    diff = (u * radius * rng.uniform(0.99, 1.01, (20000, 1))).astype(F32)
    d2v = _dot(diff, diff)
    assert (pen(d2v[d2v >= thr]) == 0.0).all()
    assert (pen(d2v[d2v < thr]) > 0.0).any()
    # Near tight: the exact test also rejects the d² up to 64 ulps below.
    first = d2[np.argmax(pen(d2) == 0.0)]
    assert int(thr.view(np.int32)) - int(first.view(np.int32)) <= 64
