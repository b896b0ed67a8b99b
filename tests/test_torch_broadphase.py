# coding=utf-8
"""The uniform-grid broad phase (``fem_tpu_torch/broadphase.py``, C2's
plain version ``ops/contact_kernels.grid_pair_forces_plain``) against the
JAX package's ``fem_tpu/broadphase.py``, on the CPU.

Tolerances: forces within 1e-5 of the largest force (the same formulas;
the −f scatter sums in another order), truncating caps included: the
stable sort gives tied cell ids the JAX package's order, so the same
pairs are dropped.  C2's enumeration (the forward stencil, and the
backward scan that gives a vertex its −f half without atomics) is
emulated in Python and held to the plain version's pair set exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu import broadphase as jbp
from fem_tpu import contact as jcontact
from fem_tpu.models.mesh import construct_2d_mesh
from fem_tpu.models.state import Obstacles as JObstacles
from fem_tpu.models.state import build_object as jbuild
from fem_tpu.utils import config as jconfig
from fem_tpu_torch import broadphase as bp
from fem_tpu_torch import contact
from fem_tpu_torch.models.state import Obstacles, build_object
from fem_tpu_torch.ops import contact_kernels as ck
from fem_tpu_torch.utils import config as pconfig

torch.set_num_threads(1)

TOL = 1e-5


def _two_clouds(seed=0, na=60, nb=50, d=2):
    rng = np.random.default_rng(seed)
    a = (0.3 + 0.25 * rng.random((na, d))).astype(np.float32)
    b = (0.45 + 0.25 * rng.random((nb, d))).astype(np.float32)
    return np.concatenate([a, b]), np.concatenate(
        [np.zeros(na, np.int32), np.ones(nb, np.int32)])


def _bent_strip(n=80):
    t = np.linspace(0.0, 1.0, n, dtype=np.float32)
    rest = np.stack([0.05 + 0.9 * t, 0.5 * np.ones_like(t)], 1)
    ang = 1.95 * np.pi * t
    bent = np.stack([0.3 + 0.25 * np.sin(ang),
                     0.5 + 0.25 * (1 - np.cos(ang))], 1).astype(np.float32)
    return bent, rest.astype(np.float32)


def _both(pos, body, rest, radius, k, vel=None, **kw):
    """(port forces, JAX forces, scale) of one grid pass."""
    t = lambda a: None if a is None else torch.tensor(a)  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    got = bp.grid_contact_forces(t(pos), t(body), t(rest), radius, k,
                                 vel=t(vel), **kw)
    ref = np.asarray(jbp.grid_contact_forces(j(pos), j(body), j(rest),
                                             radius, k, vel=j(vel), **kw))
    return got.numpy(), ref, float(np.abs(ref).max())


def _assert_close(got, ref, scale):
    assert scale > 0.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * scale)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("fric, mu", [(2.0, 0.0), (1.5, 0.5)])
def test_grid_matches_jax_two_bodies(d, fric, mu):
    pos, body = _two_clouds(d=d)
    vel = np.random.default_rng(1).standard_normal(pos.shape).astype(
        np.float32)
    got, ref, scale = _both(pos, body, pos, 0.06, 1e3, vel=vel,
                            friction_c=fric, cap=16, mu=mu, mu_slope=30.0)
    _assert_close(got, ref, scale)
    assert np.abs(got.sum(0)).max() < 1e-4 * scale


@pytest.mark.parametrize("cap", [1, 2, 3])
def test_truncating_cap_with_tied_cells_matches_jax(cap):
    """Crowded cells (many vertices share each cell id): the cap drops
    pairs, and which ones is decided by the order within a cell — the
    stable sort keeps the input order, as ``jnp.argsort`` does."""
    rng = np.random.default_rng(2)
    pos = (0.45 + 0.1 * rng.random((200, 3))).astype(np.float32)
    body = (rng.random(200) < 0.5).astype(np.int32)
    assert jbp.grid_overflow_count(pos, 0.08, cap) > 0
    assert bp.grid_overflow_count(pos, 0.08, cap) == jbp.grid_overflow_count(
        pos, 0.08, cap)
    got, ref, scale = _both(pos, body, pos, 0.08, 1e3, cap=cap)
    _assert_close(got, ref, scale)
    full, _, _ = _both(pos, body, pos, 0.08, 1e3, cap=64)
    assert np.abs(full - got).max() > 1e-3 * scale  # pairs were dropped
    np.testing.assert_allclose(got.sum(0), 0.0, atol=1e-4 * scale)


@pytest.mark.parametrize("mu", [0.0, 0.4])
def test_self_contact_matches_jax(mu):
    """The bent strip: rest positions exclude neighbours, the fold brings
    the ends together; with and without the Coulomb cone."""
    bent, rest = _bent_strip()
    vel = np.random.default_rng(3).standard_normal(bent.shape).astype(
        np.float32)
    got, ref, scale = _both(bent, np.zeros(80, np.int32), rest, 0.05, 1e3,
                            vel=vel, cap=16, self_contact=True, mu=mu,
                            mu_slope=20.0, friction_c=0.5)
    _assert_close(got, ref, scale)


def test_no_wraparound_ghost_forces():
    pos = np.asarray([[0.5, 0.001], [0.5, 0.999], [0.001, 0.5],
                      [0.999, 0.5]], np.float32)
    body = np.asarray([0, 1, 0, 1], np.int32)
    got, ref, _ = _both(pos, body, pos, 0.05, 1e3, cap=8)
    np.testing.assert_array_equal(got, 0.0)
    np.testing.assert_array_equal(ref, 0.0)


def test_grid_shape_guard():
    with pytest.raises(ValueError, match="too small"):
        bp.grid_shape(1e-4, 3)
    assert bp.grid_shape(0.05, 3) == jbp.grid_shape(0.05, 3) == (22, 22)


def test_off_unit_domain_collapse_f8():
    """ROADMAP F8: the grid covers the unit domain only, so a body at x, z
    ≈ 2 (the self-contact blob's place) collapses into the margin cells:
    every vertex shares one x and z cell, the cap truncates most pairs, and
    both packages count and drop the same ones."""
    rng = np.random.default_rng(4)
    pos = (np.asarray([2.0, 0.75, 2.0])
           + 0.3 * rng.standard_normal((150, 3))).astype(np.float32)
    body = np.zeros(150, np.int32)
    radius = 0.04
    m, _ = bp.grid_shape(radius, 3)
    ic = np.clip(np.floor(pos / radius).astype(np.int64) + 1, 0, m - 1)
    assert (ic[:, 0] == m - 1).all() and (ic[:, 2] == m - 1).all()
    count = bp.grid_overflow_count(pos, radius, 8)
    assert count == jbp.grid_overflow_count(pos, radius, 8) > 0
    got, ref, scale = _both(pos, body, pos.copy(), radius, 1e3, cap=8,
                            self_contact=True, excl_radius=0.0)
    _assert_close(got, ref, scale)


def test_integer_body_ids_f2():
    """ROADMAP F2 repaired: body ids stay int32.  Ids 2^24 and 2^24 + 1
    give the forces of ids 0 and 1 in the port; the JAX package packs
    them as f32, where they are one id, and drops every pair."""
    pos, body = _two_clouds(d=3)
    big = (body + 2 ** 24).astype(np.int32)
    small, ref, scale = _both(pos, body, pos, 0.06, 1e3, cap=16)
    _assert_close(small, ref, scale)
    got, jax_big, _ = _both(pos, big, pos, 0.06, 1e3, cap=16)
    np.testing.assert_array_equal(got, small)
    np.testing.assert_array_equal(jax_big, 0.0)


def test_overflow_count_matches_jax():
    pos, _ = _two_clouds(d=3)
    for cap in (1, 2, 8):
        assert bp.grid_overflow_count(pos, 0.06, cap) == \
            jbp.grid_overflow_count(pos, 0.06, cap)


def _c2_enumeration(cell_s, start, offs, cap):
    """C2's per-thread scans (csrc/contact_grid.cu) over the sorted cell
    ids: forward (own cell, then the forward cells from ``start``) and
    backward (own cell; each backward cell whole when i is among the first
    ``cap`` ranks of its own)."""
    n = len(cell_s)
    fwd, bwd = [[] for _ in range(n)], [[] for _ in range(n)]
    for i in range(n):
        ci = cell_s[i]
        for s in range(cap):
            k = i + 1 + s
            if k >= n or cell_s[k] != ci:
                break
            fwd[i].append(k)
        for o, off in enumerate(offs):
            for s in range(cap):
                k = start[i, o] + s
                if k >= n or cell_s[k] != ci + off:
                    break
                fwd[i].append(k)
        for k in range(max(0, i - cap), i):
            if cell_s[k] == ci:
                bwd[i].append(k)
        if i - np.searchsorted(cell_s, ci) < cap:
            for off in offs:
                lo = np.searchsorted(cell_s, ci - off)
                k = lo
                while k < n and cell_s[k] == ci - off:
                    bwd[i].append(k)
                    k += 1
    return fwd, bwd


@pytest.mark.parametrize("case", ["clouds_cap2", "clouds_cap8", "strip",
                                  "wrap"])
def test_c2_enumeration_is_the_plain_pair_set(case):
    """C2's forward scan finds exactly the plain version's valid candidates
    (truncation at ``cap`` included), and its backward scan finds, for each
    vertex, exactly the vertices whose forward scan holds it: every pair
    gets ±f once."""
    if case == "strip":
        pos, _ = _bent_strip()
        radius, cap = 0.05, 4
    elif case == "wrap":
        # (0.5, 1.02) clamps into the top margin cell (11, 21), whose id + 1
        # is (12, 0): the bottom margin cell of (0.55, −0.01), a wrapped
        # candidate the distance test kills.
        pos = np.asarray([[0.5, 1.02], [0.55, -0.01], [0.5, 0.001],
                          [0.5, 0.999], [0.001, 0.5], [0.999, 0.5]],
                         np.float32)
        radius, cap = 0.05, 2
    else:
        pos, _ = _two_clouds(d=3)
        radius, cap = 0.06, int(case[-1])
    pos_t = torch.tensor(pos)
    cell, m = bp.grid_cells(pos_t, radius)
    order = torch.argsort(cell, stable=True)
    cell_s = cell[order]
    offs = torch.tensor(ck.forward_offsets_host(m, pos.shape[1]),
                        dtype=torch.int32)
    start = torch.searchsorted(cell_s, cell_s[:, None] + offs[None, :],
                               out_int32=True)
    fwd, bwd = _c2_enumeration(cell_s.numpy(), start.numpy(),
                               offs.numpy(), cap)
    # The plain version's candidates (fem_tpu/broadphase.py:171-181).
    n = len(pos)
    slot = np.arange(cap)
    idx = np.concatenate([(np.arange(n)[:, None] + 1 + slot)[:, None, :],
                          start.numpy()[:, :, None] + slot], axis=1)
    tgt = np.concatenate([cell_s.numpy()[:, None],
                          cell_s.numpy()[:, None] + offs.numpy()], axis=1)
    idx_c = np.minimum(idx, n - 1)
    valid = (idx < n) & (cell_s.numpy()[idx_c] == tgt[:, :, None])
    for i in range(n):
        assert sorted(fwd[i]) == sorted(idx_c[i][valid[i]].tolist())
        assert sorted(bwd[i]) == sorted(k for k in range(n) if i in fwd[k])
    assert sum(map(len, fwd)) > 0


def test_contact_frame_grid_matches_jax():
    """The two-body drop of tests/test_broadphase.py with
    ``contact_broadphase="grid"``: 3 frames of 5 substeps, positions within
    1e-5 of the JAX package's."""
    objs = (dict(center=(0.4, 0.25), side_length=0.2, subdivisions=6,
                 E=4e4),
            dict(center=(0.42, 0.43), side_length=0.2, subdivisions=6))
    data = dict(dim=2, delta_time=5e-4, sim_count=5, auto_diff=False,
                use_explicit_method=True, g_dir=(0.0, -1.0), blocks=(),
                contact="penalty", contact_broadphase="grid")
    jo, js, po, ps = [], [], [], []
    for kw in objs:
        jc, pc = jconfig.ObjectConfig(**kw), pconfig.ObjectConfig(**kw)
        mesh = construct_2d_mesh(jc)
        a, b = jbuild(jc, *mesh)
        jo.append(a)
        js.append(b)
        a, b = build_object(pc, *mesh, device="cpu")
        po.append(a)
        ps.append(b)
    jf = jcontact.make_contact_frame_fn(jo, jconfig.SimConfig(**data))
    pf = contact.make_contact_frame_fn(po, pconfig.SimConfig(**data))
    assert pf.plan.mode == "grid"
    js, ps = tuple(js), tuple(ps)
    for _ in range(3):
        js, _ = jf(js, JObstacles.from_configs((), 2))
        ps, _ = pf(ps, Obstacles.from_configs((), 2, device="cpu"))
    forces = contact.contact_forces_all(
        [s.pos for s in ps], *pf.constants[:2], plan=pf.plan)
    assert float(forces[0].abs().max()) > 0.0  # the bodies touch
    for a, b in zip(js, ps):
        np.testing.assert_allclose(b.pos.numpy(), np.asarray(a.pos), rtol=0,
                                   atol=TOL)
