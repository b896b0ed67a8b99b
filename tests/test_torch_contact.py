# coding=utf-8
"""Body-body penalty contact (M17) against the JAX package, on the CPU:
the pair forces, the auto constants, the plan, the coupled frame and the
substep's external force (``fem_tpu_torch/contact.py``,
``ops/contact_kernels.py``; ``fem_tpu/contact.py``).

Tolerances: pair forces within 1e-5 of the largest force (the same f32
formulas; the three-term distance and the sums run in another order);
frames of 10 substeps within 1e-5 in positions with equal CG iterations;
the plans equal (surface sets, masks, routing); far-apart coupled frames
bit-equal to the uncoupled ones, as in tests/test_contact.py.  C1's
arithmetic is also held, at its row formulation over the soup (the body
table and the mask rows the kernel reads), in a float64 emulation.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu import contact as jcontact
from fem_tpu import sim as jsim
from fem_tpu.models.mesh import construct_2d_mesh, construct_3d_grid_mesh
from fem_tpu.models.state import Obstacles as JObstacles
from fem_tpu.models.state import build_object as jbuild
from fem_tpu.utils import config as jconfig
from fem_tpu_torch import contact, convert, sim
from fem_tpu_torch.models.state import Obstacles, build_object
from fem_tpu_torch.ops import contact_kernels as ck
from fem_tpu_torch.utils import config as pconfig

torch.set_num_threads(1)

TOL = 1e-5


def _both_objects(kws, dim=2):
    """The same bodies in both packages, from one mesh each."""
    jo, js, po, ps = [], [], [], []
    for kw in kws:
        jcfg, pcfg = jconfig.ObjectConfig(**kw), pconfig.ObjectConfig(**kw)
        mesh = (construct_2d_mesh(jcfg) if dim == 2
                else construct_3d_grid_mesh(jcfg))
        a, b = jbuild(jcfg, *mesh)
        jo.append(a)
        js.append(b)
        a, b = build_object(pcfg, *mesh, device="cpu")
        po.append(a)
        ps.append(b)
    return jo, js, po, ps


def _two_squares(gap=0.3, damping=10.0, cy0=0.35, cx1=0.5):
    """tests/test_contact.py's scene: two 2D squares, the upper falling."""
    return _both_objects([
        dict(id=i, center=(cx, cy), side_length=0.18, subdivisions=5,
             rho=rho, E=e_mod, nu=0.25, damping=damping)
        for i, (cx, cy, rho, e_mod) in enumerate(
            ((0.5, cy0, 800.0, 8e4), (cx1, cy0 + gap, 500.0, 4e4)))])


def _cfgs(**kw):
    base = dict(dim=2, delta_time=5e-4, sim_count=10, auto_diff=False,
                use_explicit_method=True, g_dir=(0.0, -1.0),
                contact="penalty")
    base.update(kw)
    return jconfig.SimConfig(**base), pconfig.SimConfig(**base)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, ref, scale):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL * scale)


def _clouds(seed=0, na=40, nb=30, d=2, shift=0.05):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 0.2, (na, d)).astype(np.float32)
    b = (a[:nb] + np.float32(shift)).astype(np.float32)
    va = rng.standard_normal((na, d)).astype(np.float32)
    vb = rng.standard_normal((nb, d)).astype(np.float32)
    return a, b, va, vb


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("fric, mu", [(0.0, 0.0), (2.0, 0.0), (0.0, 0.4),
                                      (1.5, 0.4)])
def test_pair_forces_match_jax(d, fric, mu):
    """pair_contact_forces at seeded overlapping clouds: the matmul form,
    the dashpot and the Coulomb cone; Newton's third law."""
    a, b, va, vb = _clouds(d=d)
    args = (0.1, 1e4)
    jf = jcontact.pair_contact_forces(jnp.asarray(a), jnp.asarray(b), *args,
                                      jnp.asarray(va), jnp.asarray(vb), fric,
                                      mu, 30.0)
    pf = ck.pair_contact_forces(_t(a), _t(b), *args, _t(va), _t(vb), fric,
                                mu, 30.0)
    scale = float(np.abs(np.asarray(jf[0])).max())
    assert scale > 0.0
    for got, ref in zip(pf, jf):
        _close(got, ref, scale)
    total = (pf[0].sum(0) + pf[1].sum(0)).abs().max()
    assert float(total) < 1e-5 * float(pf[0].abs().sum())


def test_pair_forces_zero_outside_radius():
    a, _, _, _ = _clouds()
    far = a + np.float32(5.0)
    f_a, f_b = ck.pair_contact_forces(_t(a), _t(far), 0.1, 1e6)
    assert float(f_a.abs().max()) == 0.0 and float(f_b.abs().max()) == 0.0


def test_friction_zero_is_frictionless_bit_equal():
    a, b, va, vb = _clouds(seed=3, shift=0.03)
    f0 = ck.pair_contact_forces(_t(a), _t(b), 0.05, 1e4)
    f1 = ck.pair_contact_forces(_t(a), _t(b), 0.05, 1e4, _t(va), _t(vb), 0.0)
    assert all(torch.equal(x, y) for x, y in zip(f0, f1))


def test_auto_radius_and_stiffness_match_jax():
    jo, _, po, _ = _two_squares()
    assert contact.auto_contact_radius(po) == jcontact.auto_contact_radius(jo)
    assert (contact.auto_contact_stiffness(po, 5e-4)
            == jcontact.auto_contact_stiffness(jo, 5e-4))
    assert 0.02 < contact.auto_contact_radius(po) < 0.08


def _jax_plan_fields(plan):
    return {f: getattr(plan, f) for f in convert.CONTACT_PLAN_FIELDS}


def _assert_plans_equal(pplan, jplan):
    got = convert.contact_plan_to_arrays(pplan)
    ref = convert.contact_plan_to_arrays(
        convert.contact_plan_from_arrays(_jax_plan_fields(jplan), "cpu"))
    for key in ("mode", "sizes", "self_contact"):
        assert got[key] == ref[key], key
    if got["mode"] == "grid":
        assert got["cap"] == ref["cap"]
        np.testing.assert_array_equal(got["body_id"], ref["body_id"])
        np.testing.assert_array_equal(got["rest_cat"], ref["rest_cat"])
    for a, b in zip(got["surf"], ref["surf"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got["self_mask"], ref["self_mask"]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("over", [
    dict(), dict(self_contact=True), dict(contact_broadphase="grid"),
    dict(contact_broadphase="grid", self_contact=True, contact_cell_cap=3),
    dict(contact_mu=0.4), dict(contact_surface_only=False)])
def test_plan_matches_jax(over):
    """The surface sets, the self-contact rest masks (uint8 on the device,
    equal to the JAX package's 0/1 masks), the routing and the grid's soup."""
    jo, _, po, _ = _two_squares()
    jcfg, pcfg = _cfgs(**over)
    r = jcontact.auto_contact_radius(jo)
    jplan = jcontact.build_contact_plan(jo, jcfg, r)
    pplan = contact.build_contact_plan(po, pcfg, r)
    _assert_plans_equal(pplan, jplan)
    if over.get("self_contact") and pplan.mode == "dense":
        assert all(m.dtype == torch.uint8 for m in pplan.self_mask)
        assert all(int(m.min()) == 0 and int(m.max()) == 1
                   for m in pplan.self_mask)
    if pplan.mode == "grid":
        assert pplan.body_id.dtype == torch.int32


def test_auto_routing_matches_jax():
    """``contact_broadphase="auto"``: dense for two small bodies, with and
    without ``contact_mu``; the grid past 8 bodies."""
    jo, _, po, _ = _two_squares()
    for over in (dict(), dict(contact_mu=0.4)):
        jcfg, pcfg = _cfgs(**over)
        for n in (2, 9):
            jplan = jcontact.build_contact_plan(jo[:1] * n, jcfg, 0.03)
            pplan = contact.build_contact_plan(po[:1] * n, pcfg, 0.03)
            assert pplan.mode == jplan.mode == ("grid" if n > 8 else "dense")
    with pytest.raises(ValueError, match="unknown contact_broadphase"):
        contact.build_contact_plan(po, _cfgs(contact_broadphase="kd")[1],
                                   0.03)


def test_surface_culling_3d_matches_jax():
    """Shallow 3D contact: the surface-vertex plan against all pairs, both
    packages; interior vertices get exactly zero force."""
    jo, js, po, ps = _both_objects(
        [dict(center=c, side_length=0.2, subdivisions=3)
         for c in ((0.4, 0.4, 0.4), (0.4, 0.62, 0.4))], dim=3)
    radius = 0.027
    jcfg, pcfg = _cfgs(dim=3, g_dir=(0.0, -1.0, 0.0))
    jfull = jcontact.contact_forces_all([s.pos for s in js], radius, 1e4)
    pfull = contact.contact_forces_all([s.pos for s in ps], radius, 1e4)
    jplan = jcontact.build_contact_plan(jo, jcfg, radius)
    pplan = contact.build_contact_plan(po, pcfg, radius)
    _assert_plans_equal(pplan, jplan)
    jcull = jcontact.contact_forces_all([s.pos for s in js], radius, 1e4,
                                        plan=jplan)
    pcull = contact.contact_forces_all([s.pos for s in ps], radius, 1e4,
                                       plan=pplan)
    scale = max(float(np.abs(np.asarray(f)).max()) for f in jfull)
    assert scale > 0.0
    for pf, jf, pc, jc, obj in zip(pfull, jfull, pcull, jcull, po):
        _close(pf, jf, scale)
        _close(pc, jc, scale)
        _close(pc, pf.numpy(), scale)
        interior = np.setdiff1d(np.arange(obj.particle_cnt),
                                np.unique(obj.faces.numpy().reshape(-1)))
        assert interior.size > 0
        assert float(pf[interior].abs().max()) == 0.0


@pytest.mark.parametrize("mu", [0.0, 0.4])
def test_self_contact_forces_match_jax(mu):
    """A square's rest shape exerts exactly zero self-force; squashed to 15 %
    of its height, its folded rows repel, as in the JAX package."""
    jo, js, po, ps = _two_squares()
    jcfg, pcfg = _cfgs(self_contact=True)
    radius = contact.auto_contact_radius(po[:1])
    jplan = jcontact.build_contact_plan(jo[:1], jcfg, radius)
    pplan = contact.build_contact_plan(po[:1], pcfg, radius)
    sv = pplan.surf[0]
    rest = po[0].rest_pos[sv]
    assert float(ck.self_contact_forces(rest, pplan.self_mask[0], radius,
                                        1e4).abs().max()) == 0.0
    pos = ps[0].pos.numpy().copy()
    cy = pos[:, 1].mean()
    pos[:, 1] = cy + 0.15 * (pos[:, 1] - cy)
    vel = np.random.default_rng(5).standard_normal(pos.shape).astype(
        np.float32)
    jsv = np.asarray(jplan.surf[0])
    jf = jcontact.self_contact_forces(
        jnp.asarray(pos)[jsv], jplan.self_mask[0], radius, 1e4,
        jnp.asarray(vel)[jsv], 1.0, mu, 20.0)
    pf = ck.self_contact_forces(_t(pos)[sv], pplan.self_mask[0], radius, 1e4,
                                _t(vel)[sv], 1.0, mu, 20.0)
    scale = float(np.abs(np.asarray(jf)).max())
    assert scale > 0.0
    _close(pf, jf, scale)
    assert float(pf.sum(0).abs().max()) < 1e-4 * float(pf.abs().sum())


def _c1_row_emulation(tables, pos, vel, radius, k, friction_c, mu, slope,
                      cluster=0):
    """C1's row formulation in float64 (the three-term distance in f32, as
    the plain version rounds it), as csrc/contact_pairs.cu reads its
    tables: vertex i's body from ``body_id``, its body's first row, size
    and mask offset from ``body_table``, a same-body partner admitted by
    ``mask_cat[offset + (i − first)·size + (j − first)]``; the matmul form
    (x_i·S − T) − (v_i·W − V), or the Coulomb pair sum.  ``cluster`` P > 0
    reads as the cluster variant: the mask's bit j − first of row i's words
    from ``mask_bits`` at ``bit_offsets``, the pre-test d2 < thr before the
    exact test, and the partners in P contiguous chunks, each chunk's
    partials summed and the P partials then added in rank order.  Returns
    (forces, each row's accepted partners)."""
    sq = torch.sum(pos * pos, dim=1)
    d2_32 = (sq[:, None] + sq[None, :] - 2.0 * (pos @ pos.T)).numpy()
    pos, vel = pos.double().numpy(), vel.double().numpy()
    body = tables.body_id.numpy()
    table = tables.body_table.numpy()
    masks = None if tables.mask_cat is None else tables.mask_cat.numpy()
    bits = (None if tables.mask_bits is None
            else tables.mask_bits.numpy().view(np.uint32))
    bit_off = tables.bit_offsets.numpy()
    thr = ck.d2_threshold(radius)
    n, d = pos.shape
    chunk = -(-n // max(cluster, 1))
    out = np.zeros_like(pos)
    accepted = np.zeros(n, np.int64)
    for i in range(n):
        first, size, moff = table[body[i]]
        boff = bit_off[body[i]]
        parts = []
        for lo in range(0, n, chunk):
            s = w = 0.0
            t, v, f = (np.zeros(d) for _ in range(3))
            for j in range(lo, min(n, lo + chunk)):
                if body[j] == body[i]:
                    if cluster:
                        words = (size + 31) // 32
                        word = bits[boff + (i - first) * words
                                    + (j - first) // 32] if boff >= 0 else 0
                        if boff < 0 or not (word >> ((j - first) % 32)) & 1:
                            continue
                    elif moff < 0 or masks[moff + (i - first) * size + j
                                           - first] == 0:
                        continue
                if mu == 0.0:  # the three-term distance, in f32 as the kernel
                    d2 = max(float(d2_32[i, j]), 1e-18)
                else:
                    d2 = max(float(((pos[i] - pos[j]) ** 2).sum()), 1e-18)
                if cluster and not d2 < thr:
                    continue
                dist = np.sqrt(d2)
                pen = max(radius - dist, 0.0)
                if pen <= 0.0:
                    continue
                accepted[i] += 1
                coef = k * pen / max(dist, 0.1 * radius)
                if mu == 0.0:
                    s += coef
                    t += coef * pos[j]
                    w += friction_c * pen / radius
                    v += friction_c * pen / radius * vel[j]
                    continue
                diff, dv = pos[i] - pos[j], vel[i] - vel[j]
                fp = coef * diff - friction_c * pen / radius * dv
                nh = diff / dist
                vt = dv - (dv @ nh) * nh
                speed = np.sqrt(max(vt @ vt, 1e-24))
                fp -= min(slope * speed, mu * k * pen) / speed * vt
                f += fp
            parts.append((s, w, t, v, f))
        s, w, t, v, f = parts[0]
        for ps, pw, pt, pv, pf in parts[1:]:
            s, w, t, v, f = s + ps, w + pw, t + pt, v + pv, f + pf
        out[i] = f if mu > 0.0 else (pos[i] * s - t) - (vel[i] * w - v)
    return out, accepted


@pytest.mark.parametrize("mu", [0.0, 0.4])
def test_c1_row_formulation_matches_the_plain_version(mu):
    """C1's reading of its tables (three bodies, two with self-contact
    masks) and its row sums against ``pair_forces`` (the plain version on
    the CPU), within 1e-5 of the largest force."""
    rng = np.random.default_rng(11)
    sizes = (25, 18, 12)
    pos = rng.uniform(0.4, 0.55, (sum(sizes), 2)).astype(np.float32)
    vel = rng.standard_normal(pos.shape).astype(np.float32)
    masks = []
    for n in sizes[:2]:
        m = np.triu(rng.random((n, n)) < 0.6, 1)
        masks.append(m | m.T)
    tables = ck.pair_tables(sizes, masks + [None], "cpu")
    args = (0.05, 1e3, 1.5, mu, 20.0)
    got = ck.pair_forces(tables, _t(pos), _t(vel), *args)
    ref, _ = _c1_row_emulation(tables, _t(pos), _t(vel), *args)
    scale = float(np.abs(ref).max())
    assert scale > 0.0
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL * scale)


def _c1_case(seed=11):
    """Three bodies, two with self-contact masks, in 2D: the soup of
    test_c1_row_formulation_matches_the_plain_version."""
    rng = np.random.default_rng(seed)
    sizes = (25, 18, 12)
    pos = rng.uniform(0.4, 0.55, (sum(sizes), 2)).astype(np.float32)
    vel = rng.standard_normal(pos.shape).astype(np.float32)
    masks = []
    for n in sizes[:2]:
        m = np.triu(rng.random((n, n)) < 0.6, 1)
        masks.append(m | m.T)
    return ck.pair_tables(sizes, masks + [None], "cpu"), pos, vel


@pytest.mark.parametrize("cluster", [1, 2, 8])
@pytest.mark.parametrize("mu", [0.0, 0.4])
def test_c1_cluster_formulation_matches_the_plain_version(mu, cluster):
    """The cluster variant's reading (mask bits, the pre-test, P chunks'
    partials added in rank order) against ``pair_forces`` within 1e-5 of
    the largest force, with each row's accepted partners those of the rows
    variant's reading."""
    tables, pos, vel = _c1_case()
    args = (0.05, 1e3, 1.5, mu, 20.0)
    got = ck.pair_forces(tables, _t(pos), _t(vel), *args)
    ref, taken = _c1_row_emulation(tables, _t(pos), _t(vel), *args,
                                   cluster=cluster)
    _, taken_rows = _c1_row_emulation(tables, _t(pos), _t(vel), *args)
    scale = float(np.abs(ref).max())
    assert scale > 0.0 and taken.sum() > 0
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL * scale)
    np.testing.assert_array_equal(taken, taken_rows)


@pytest.mark.parametrize("n,tiles,cluster", [
    (1284, 41, 8),  # two flagship surfaces (AP)
    (2780, 87, 4),  # the self-contact blob (AQ)
    (24576, 768, 1),  # the shells (AR)
    (8192, 256, 1),
    (202, 7, 8),  # demo_two_bodies_contact.json (AO)
    (1, 1, 8)])
def test_contact_plan_picks_the_cluster(n, tiles, cluster):
    plan = ck.contact_plan(n)
    assert (plan.variant, plan.tiles, plan.cluster) == ("cluster", tiles,
                                                        cluster)
    assert plan.ctas == tiles * cluster
    assert ck.contact_plan(n, cluster=2).cluster == 2
    rows = ck.contact_plan(n, "rows")
    assert (rows.cluster, rows.ctas) == (0, tiles)
    assert ck.PAIR_ROWS == ck.PAIR_THREADS // ck.PAIR_SPLIT == 32


@pytest.mark.parametrize("args,match", [
    ((0,), "vertex"), ((10, "warp"), "unknown C1 variant"),
    ((10, "cluster", 3), "clusters"), ((10, "rows", 2), "no cluster")])
def test_contact_plan_refusals(args, match):
    with pytest.raises(ValueError, match=match):
        ck.contact_plan(*args)
    if args[0] > 0:
        tables, pos, vel = _c1_case()
        with pytest.raises(ValueError, match=match):
            ck.pair_forces(tables, _t(pos), _t(vel), 0.05, 1e3,
                           variant=args[1], cluster=(args + (0,))[2])


def test_packed_masks_hold_the_byte_masks_pairs():
    """Each body's mask bits, unpacked, are its uint8 mask, at the word
    offsets the table gives (a body without a mask: −1), for masks of 1, 31,
    32, 33 and 70 vertices."""
    rng = np.random.default_rng(2)
    sizes = (1, 31, 7, 32, 33, 70)
    masks = []
    for n in sizes:
        m = np.triu(rng.random((n, n)) < 0.5, 1)
        masks.append(m | m.T)
    masks[2] = None
    tables = ck.pair_tables(sizes, masks, "cpu")
    bits = tables.mask_bits.numpy().view(np.uint32)
    assert tables.mask_bits.dtype == torch.int32
    offs = tables.bit_offsets.tolist()
    assert offs[2] == -1
    words_total = 0
    for n, m, off, view in zip(sizes, masks, offs, tables.masks):
        if m is None:
            assert view is None
            continue
        words = (n + 31) // 32
        assert off == words_total
        words_total += n * words
        rows = bits[off:off + n * words].reshape(n, words)
        unpacked = ((rows[:, :, None] >> np.arange(32, dtype=np.uint32))
                    & 1).reshape(n, 32 * words)
        assert not unpacked[:, n:].any()
        np.testing.assert_array_equal(unpacked[:, :n], view.numpy())
        np.testing.assert_array_equal(unpacked[:, :n], m.astype(np.uint8))
    assert bits.size == words_total
    none = ck.pair_tables((4, 5), [None, None], "cpu")
    assert none.mask_bits is None and none.bit_offsets.tolist() == [-1, -1]


@pytest.mark.parametrize("radius", [0.05, 0.0236, 0.1018, 0.0078, 1.0])
def test_d2_threshold_rejects_only_pairs_out_of_the_radius(radius):
    """Every float32 d2 at or above the threshold, up to a few hundred ulps
    past it, gives a rounded root at or above the float32 radius, so the
    exact test rejects it too; the threshold is within 1e-5 of r²."""
    r = np.float32(radius)
    thr = np.float32(ck.d2_threshold(radius))
    assert abs(float(thr) / float(r) ** 2 - 1.0) < 1e-5
    d2 = thr
    for _ in range(400):
        assert np.sqrt(d2) >= r
        d2 = np.nextafter(d2, np.float32(np.inf))


def _frames(jf, pf, js, ps, jobs, pobs, frames=1):
    for _ in range(frames):
        js, jaux = jf(tuple(js), jobs)
        ps, paux = pf(tuple(ps), pobs)
    return js, ps, jaux, paux


@pytest.mark.parametrize("method", [
    dict(), dict(auto_diff=True),
    dict(use_explicit_method=False, implicit_method=1, preconditioned=1),
    dict(use_explicit_method=False, implicit_method=1, preconditioned=0,
         operator_mode="graph"),
    dict(contact_friction=1.0, self_contact=True),
    dict(contact_mu=0.3, contact_friction=0.3)])
def test_contact_frame_matches_jax(method):
    """10 coupled substeps of the two squares in contact: positions within
    1e-5, CG iterations equal, the aux stacked per body over the
    substeps."""
    jo, js, po, ps = _two_squares(gap=0.19)
    jcfg, pcfg = _cfgs(**method)
    jf = jcontact.make_contact_frame_fn(jo, jcfg)
    pf = contact.make_contact_frame_fn(po, pcfg)
    forces = contact.contact_forces_all(
        [s.pos for s in ps], *pf.constants[:2], plan=pf.plan)
    assert float(forces[0].abs().max()) > 0.0  # the squares touch
    jobs = JObstacles.from_configs((), 2)
    pobs = Obstacles.from_configs((), 2, device="cpu")
    js, ps, jaux, paux = _frames(jf, pf, js, ps, jobs, pobs)
    for a, b, ja, pa in zip(js, ps, jaux, paux):
        np.testing.assert_allclose(b.pos.numpy(), np.asarray(a.pos), rtol=0,
                                   atol=TOL)
        assert pa.solver_iterations.shape == (10,)
        np.testing.assert_array_equal(pa.solver_iterations.numpy(),
                                      np.asarray(ja.solver_iterations))


def test_far_apart_bodies_equal_uncoupled_frames():
    """Bodies far outside the radius: zero forces, so the coupled frame is
    bit-equal to each body's own op-composed frame."""
    _, _, po, ps = _two_squares(gap=3.0)
    _, pcfg = _cfgs()
    pobs = Obstacles.from_configs((), 2, device="cpu")
    cframe = contact.make_contact_frame_fn(po, pcfg)
    frames = [sim.make_frame_fn(o, dataclasses.replace(pcfg, contact="none"))
              for o in po]
    s_c, s_u = tuple(ps), list(ps)
    for _ in range(3):
        s_c, _ = cframe(s_c, pobs)
        s_u = [f(s, pobs)[0] for f, s in zip(frames, s_u)]
    for a, b in zip(s_c, s_u):
        assert torch.equal(a.pos, b.pos) and torch.equal(a.vel, b.vel)


@pytest.mark.parametrize("method", [
    dict(), dict(use_explicit_method=False, implicit_method=1,
                 preconditioned=0),
    dict(use_explicit_method=False, implicit_method=1, preconditioned=1,
         solver_backend="dense")])
def test_substep_external_force_matches_jax(method):
    """``substep(external_force=f)`` against the JAX package's, with a load
    box so that the force composes with ``static_load``: explicit, implicit
    CG and the dense backend."""
    kw = dict(center=(0.5, 0.6), side_length=0.2, subdivisions=3,
              load_boxes=(((0.0, 0.0), (1.0, 0.62), (0.0, -40.0)),))
    jo, js, po, ps = _both_objects([kw])
    jcfg, pcfg = _cfgs(contact="none", sim_count=1, **method)
    f = np.random.default_rng(2).standard_normal(
        ps[0].pos.shape).astype(np.float32) * 10.0
    jobs = JObstacles.from_configs((), 2)
    pobs = Obstacles.from_configs((), 2, device="cpu")
    ja, jaux = jsim.substep(jo[0], js[0], jobs, external_force=jnp.asarray(f),
                            **jsim._cfg_kwargs(jcfg))
    pa, paux = sim.substep(po[0], ps[0], pobs, external_force=_t(f),
                           **sim.substep_kwargs(pcfg))
    j0, _ = jsim.substep(jo[0], js[0], jobs, **jsim._cfg_kwargs(jcfg))
    assert float(np.abs(np.asarray(ja.vel) - np.asarray(j0.vel)).max()) > 1e-3
    np.testing.assert_allclose(pa.pos.numpy(), np.asarray(ja.pos), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(pa.vel.numpy(), np.asarray(ja.vel), rtol=0,
                               atol=TOL ** 0.5)
    assert int(paux.solver_iterations) == int(jaux.solver_iterations)


def test_contact_momentum_matches_jax():
    """Gravity-free overlapping bodies with the dashpot: pushed apart, total
    momentum zero, the end positions within 1e-5 of the JAX package's and
    the velocities within √1e-5 (the stiff pair springs amplify the
    rounding of the forces in the velocities)."""
    jo, js, po, ps = _two_squares(gap=0.12, damping=0.0, cy0=0.45)
    jcfg, pcfg = _cfgs(g_dir=(0.0, 0.0), contact_friction=1.0)
    jf = jcontact.make_contact_frame_fn(jo, jcfg)
    pf = contact.make_contact_frame_fn(po, pcfg)
    js, ps, _, _ = _frames(jf, pf, js, ps, JObstacles.from_configs((), 2),
                           Obstacles.from_configs((), 2, device="cpu"),
                           frames=3)
    masses = [o.mass.numpy() for o in po]
    total = sum((m[:, None] * s.vel.numpy()).sum(0)
                for m, s in zip(masses, ps))
    scale = sum((m[:, None] * np.abs(s.vel.numpy())).sum()
                for m, s in zip(masses, ps))
    assert max(float(s.vel.abs().max()) for s in ps) > 1e-4
    assert np.abs(total).max() < 1e-4 * scale
    for a, b in zip(js, ps):
        np.testing.assert_allclose(b.pos.numpy(), np.asarray(a.pos), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(b.vel.numpy(), np.asarray(a.vel), rtol=0,
                                   atol=TOL ** 0.5)
