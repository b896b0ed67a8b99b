# coding=utf-8
"""The blocked prep (K2, K7b) and the blocked assembly (K7a) as one launch
each that ends in the per-particle sum, on the host.

Their cluster variant runs on K3's plan and binding
(``ops/blocked_kernels.py``: ``blocked_plan`` with ``source`` "prep",
"grad" or "columns"): 16 CTAs of two thread groups on the flagship's 17
blocks, 1 CTA on ``default.json``'s one block, 16 on the 40-subdivision
grid, the two-kernel variant past 32 blocks or under tight limits, forced
and refused variants, each source's shared memory (every segment of a
group's share on a 16-byte boundary, for the TMA bulk copies).  A numpy
emulation of the cluster variant's two sums — each block slot's rows
through the block's local plan into its particle owner's receive slot
(``explicit_assignment``), then each owner's receive slots in order —
equals the plain terms summed in the two-kernel variant's order bit for
bit, for each source's rows (the −V·h force columns, the +V·g gradient
columns, given columns), on the three scenes.

``blocked_prep_force`` and ``blocked_grad_force`` (the plain versions on
the CPU) against the JAX package's ``blocked_prep`` / ``blocked_grad_prep``
(Pallas in interpret mode) and its scatter, 2D and 3D, one layer and the
two inelastic layers: within 1e-5 of the largest entry (a layered caller
sums each layer's assembled force, where the JAX package sums the layers'
partials and assembles once: the same terms in another f32 association),
K within 1e-5 block-relative; and the op-composed blocked implicit and
explicit substeps, which take those entries once a layer, against the JAX
package's substeps: positions and internal inverses within 1e-5 after each
of three substeps, equal CG iterations."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu import sim as jsim
from fem_tpu.models.state import Obstacles as JaxObstacles
from fem_tpu.ops import blocking as jblocking
from fem_tpu.ops import inelastic as jinelastic
from fem_tpu_torch import entry, scene, sim
from fem_tpu_torch.models.state import Obstacles
from fem_tpu_torch.ops import blocked_kernels as bk
from fem_tpu_torch.ops import blocking, inelastic
from fem_tpu_torch.ops import frame_kernels as fk
from fem_tpu_torch.ops import smallmat as sm
from fem_tpu_torch.ops.assembly import element_contrib_full
from fem_tpu_torch.ops.element import k_and_h_chain
from fem_tpu_torch.solvers import explicit, implicit
from fem_tpu_torch.utils.config import read_config
from tests.test_torch_inelastic import (
    MATS,
    assert_state_close,
    inelastic_pair,
    sim_configs,
)
from tests.test_torch_solve_plans import (
    _blk_host,
    _cluster_sums,
    _slot_plan_sums,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = fk.H100_LIMITS
TOL = 1e-5
SOURCES = ("prep", "grad", "columns")


def _default_2d(subdivisions=None):
    cfg = read_config(os.path.join(REPO, "configs", "default.json"))
    if subdivisions is not None:
        ocfg = dataclasses.replace(cfg.objects[0], subdivisions=subdivisions)
        cfg = dataclasses.replace(cfg, objects=(ocfg,))
    (body,), _ = scene.load_scene(cfg, device="cpu")
    return body.obj, body.state


@pytest.fixture(scope="module")
def scenes():
    """The flagship deformed (17 blocks), default.json (1) and its
    40-subdivision grid (16), each moved off its rest state."""
    _, obj, state, _ = entry.flagship("cpu")
    out = {"flagship": (obj, entry.deformed(state))}
    rng = np.random.default_rng(5)
    for name, sub in (("default", None), ("grid", 40)):
        o, s = _default_2d(sub)
        c = s.pos.mean(dim=0, keepdim=True)
        pos = c + (s.pos - c) * torch.tensor([[1.1, 0.9]]) + torch.as_tensor(
            rng.uniform(-1e-3, 1e-3, tuple(s.pos.shape)).astype(np.float32))
        out[name] = (o, s.replace(pos=pos))
    return out


# -- the plans ---------------------------------------------------------------


def test_source_group_words():
    """A group's share of each source (csrc/blocked.cu: group_layout): K3's
    packed layout unchanged; prep and grad add the layer's R⁻¹ and the
    volumes, columns the block's columns and no rows, plus or minus; each
    segment but K3's padded to 4 words.  K2's share in 3D at Eb 256, Pb 128
    is 35,344 B."""
    eb, pb = 256, 128
    for d in (2, 3):
        packed = d * pb + (d + 1) * d * eb + 2 * d * eb + (d + 1) * eb + 2 * pb + 1
        assert bk.cluster_group_words("apply", eb, pb, d) == packed
        chain = (d * pb + (d + 1) * d * eb + d * d * eb + eb + 2 * d * eb
                 + (d + 1) * eb + (pb + 4) + pb)
        assert bk.cluster_group_words("prep", eb, pb, d) == chain
        assert bk.cluster_group_words("grad", eb, pb, d) == chain
        assert bk.cluster_group_words("columns", eb, pb, d) == (
            (d + 1) * d * eb + d * d * eb + (d + 1) * eb + (pb + 4) + pb)
    assert 4 * bk.cluster_group_words("prep", eb, pb, 3) == 35_344
    # Receive slots: 4 floats a row in 3D, 2 in 2D, padded to 4 words but
    # for K3.
    assert bk.cluster_smem("apply", eb, pb, 2, 1, 3) == 4 * (
        6 + bk.cluster_group_words("apply", eb, pb, 2))
    assert bk.cluster_smem("prep", eb, pb, 2, 1, 3) == 4 * (
        8 + bk.cluster_group_words("prep", eb, pb, 2))


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("scene_name,size,threads", [
    ("flagship", 16, 512), ("default", 1, 256), ("grid", 16, 256)])
def test_source_plan_picks_the_cluster_variant(scenes, source, scene_name,
                                               size, threads):
    """The cluster variant on K3's plan, for each source: the flagship's
    17 blocks on 16 CTAs of two thread groups, default.json's one block on
    one CTA, the grid's 16 on 16; the source's shared memory, within the
    H100's opt-in."""
    obj = scenes[scene_name][0]
    blk = obj.blocking
    host = _blk_host(blk)
    n, d = obj.particle_cnt, obj.dim
    plan = bk.blocked_plan(*host, n, blk.eb, d, H100, source=source)
    asg = fk.explicit_assignment(*host, n, size)
    assert plan == bk.BlockedPlan("cluster", size, bk.cluster_smem(
        source, blk.eb, blk.pb, d, threads // 256, asg.sizes()[1]), threads)
    assert plan.smem <= H100.smem_optin
    assert bk.blocked_barriers(plan.variant, plan.size) == (
        2 if size > 1 else 1)


@pytest.mark.parametrize("source", SOURCES)
def test_source_forced_and_refused_variants(scenes, source):
    """grid=True gives the two kernels (one CTA a block: K2 and K7b with the
    gathered rows, K7a without), cluster=3 three CTAs; more CTAs than blocks
    or than the device takes, a CTA beyond the shared memory, grid with
    cluster and an unknown source raise ValueError; under tight limits,
    and when the blocks outnumber two groups on each of the device's most
    CTAs, the plan is the two-kernel variant."""
    obj = scenes["flagship"][0]
    blk = obj.blocking
    host = _blk_host(blk)
    n = obj.particle_cnt
    rows = 4 * 12 * 256
    grid = bk.blocked_plan(*host, n, blk.eb, 3, H100, grid=True, source=source)
    assert grid == bk.BlockedPlan(
        "grid", 17, rows if source == "columns" else rows + 4 * 3 * 128)
    assert bk.blocked_plan(*host, n, blk.eb, 3, H100, cluster=3,
                          source=source).size == 3
    for c in (17, 32):
        with pytest.raises(ValueError):
            bk.blocked_plan(*host, n, blk.eb, 3, H100, cluster=c,
                           source=source)
    with pytest.raises(ValueError, match="not both"):
        bk.blocked_plan(*host, n, blk.eb, 3, H100, cluster=3, grid=True,
                       source=source)
    with pytest.raises(ValueError, match="unknown source"):
        bk.blocked_plan(*host, n, blk.eb, 3, H100, source="edges")
    tight = fk.FrameLimits(max_cluster=16, smem_optin=40_000, sms=132)
    assert bk.blocked_plan(*host, n, blk.eb, 3, tight, source=source) == grid
    with pytest.raises(ValueError, match="does not fit"):
        bk.blocked_plan(*host, n, blk.eb, 3, tight, cluster=16, source=source)
    small = fk.FrameLimits(max_cluster=4, smem_optin=232_304, sms=132)
    assert bk.blocked_plan(*host, n, blk.eb, 3, small, source=source) == grid


# -- the cluster variant's sums ----------------------------------------------


def _source_columns(source, blk, obj, pos):
    """Each source's element columns in block order (zero on padded slots),
    as the plain versions compute them: prep the −V·h force columns, grad
    the +V·g gradient columns, columns given ones."""
    real = bk._real_slots(blk)
    if source == "prep":
        x = bk.block_edge_matrices(blk, blocking.blocked_gather(pos, blk))
        r = blk.ref_inv
        _, h = k_and_h_chain(sm.matmul(x, r), r, obj.mu, obj.s_lambda,
                             "neo_hookean", False)
        return torch.where(real, -blk.volume[:, None, None] * h, 0.0)
    if source == "grad":
        return bk.blocked_grad_columns_layers_plain(
            blk, pos, [(blk.ref_inv, obj.mu, obj.s_lambda, "neo_hookean")])
    rng = np.random.default_rng(13)
    cols = torch.as_tensor(rng.normal(size=tuple(blk.ref_inv.shape))
                           .astype(np.float32))
    return torch.where(real, cols, 0.0)


def _plain_output(source, blk, obj, pos, cols):
    if source == "prep":
        return bk.blocked_prep_force_plain(blk, pos, obj.mu, obj.s_lambda)[1]
    if source == "grad":
        return bk.blocked_grad_force_plain(blk, pos, obj.mu, obj.s_lambda)
    return bk.blocked_assemble_plain(blk, cols)


@pytest.mark.parametrize("scene_name", ["flagship", "default", "grid"])
@pytest.mark.parametrize("source", SOURCES)
def test_cluster_sums_of_each_source(scenes, source, scene_name):
    """The cluster variant's two sums of each source's rows, on the plan's
    CTAs (16 on the flagship and the grid, 1 on default.json), equal the
    plain terms summed in the two-kernel variant's order bit for bit (its
    per-slot partials, then each particle's partials in the slot plan's
    order), and the plain version's output bit for bit wherever a particle
    has at most four block slots (to f32 rounding elsewhere, where its
    torch.sum reduces in an order of its own)."""
    obj, state = scenes[scene_name]
    blk, n, d = obj.blocking, obj.particle_cnt, obj.dim
    plan = bk.blocked_plan(*_blk_host(blk), n, blk.eb, d, H100, source=source)
    cols = _source_columns(source, blk, obj, state.pos)
    rows = element_contrib_full(cols).reshape(-1, d).numpy()
    part = bk._slot_partials(blk, cols).reshape(-1, d).numpy()
    got = _cluster_sums(blk, rows, n, plan.size)
    assert np.array_equal(got, _slot_plan_sums(blk, part, n))
    want = _plain_output(source, blk, obj, state.pos, cols).numpy()
    top = float(np.abs(want).max())
    assert top > 0
    few = np.diff(blk.slot_plan.ptr.numpy()) <= 4
    assert np.array_equal(got[few], want[few])
    assert float(np.abs(got - want).max()) <= 1e-6 * top


# -- the force entries against the JAX package -------------------------------


@pytest.fixture(scope="module")
def pairs():
    """(port object, state, JAX object, state) of the 2D grid (3 blocks)
    and the 3D grid (re-blocked into several), elastic and with both
    inelastic branches (two layers on the dynamic R⁻¹·F_i⁻¹)."""
    return {(dim, layered): inelastic_pair(
        dim, MATS["both"] if layered else {}, seed=3 + dim, squash=0.1)
        for dim in (2, 3) for layered in (False, True)}


def _block_rel(got, ref):
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(axis=1)
    return float((np.abs(got - ref) / np.maximum(scale, 1e-30)[:, None,
                                                                None]).max())


@pytest.mark.parametrize("layered", [False, True], ids=["one layer", "layers"])
@pytest.mark.parametrize("dim", [2, 3])
def test_prep_force_plain_matches_jax(pairs, dim, layered):
    """K and f of ``blocked_prep_force`` summed over the material layers
    against the JAX package's ``blocked_prep`` per layer, its partials
    summed and scattered once."""
    obj, state, jobj, jstate = pairs[(dim, layered)]
    blk, jblk = obj.blocking, jobj.blocking
    layers = inelastic.material_layers(obj, state)
    assert len(layers) == (2 if layered else 1)
    K, f = inelastic.sum_layers(
        bk.blocked_prep_force(blk, state.pos, mu, lam,
                              inelastic.layer_ref_inv_blocked(blk, fi),
                              material)
        for fi, mu, lam, material in layers)
    kplane = yt = None
    for fi, mu, lam, material in jinelastic.material_layers(jobj, jstate):
        kp, y = jblocking.blocked_prep(
            jblk, jstate.pos, dim, mu, lam, False, material,
            ref_planes=jinelastic.layer_ref_planes_blocked(jblk, fi, dim))
        kplane = kp if kplane is None else kplane + kp
        yt = y if yt is None else yt + y
    ref = np.asarray(jblocking.blocked_scatter_sum(yt, jblk,
                                                   jobj.particle_cnt))
    np.testing.assert_allclose(f.numpy(), ref, rtol=0,
                               atol=TOL * float(np.abs(ref).max()))
    kflat = np.asarray(jblocking.kplane_to_kflat(jblk, kplane, dim))
    assert _block_rel(K.numpy(), kflat) <= TOL


@pytest.mark.parametrize("layered", [False, True], ids=["one layer", "layers"])
@pytest.mark.parametrize("dim", [2, 3])
def test_grad_force_plain_matches_jax(pairs, dim, layered):
    """g of ``blocked_grad_force`` summed over the layers (the blocked
    branch of ``analytic_energy_gradient``) against the JAX package's
    ``blocked_grad_prep`` per layer, summed and scattered once."""
    obj, state, jobj, jstate = pairs[(dim, layered)]
    blk, jblk = obj.blocking, jobj.blocking
    layers = inelastic.material_layers(obj, state)
    g = explicit.analytic_energy_gradient(obj, state.pos, "pallas", layers)
    yt = None
    for fi, mu, lam, material in jinelastic.material_layers(jobj, jstate):
        y = jblocking.blocked_grad_prep(
            jblk, jstate.pos, dim, mu, lam, material,
            ref_planes=jinelastic.layer_ref_planes_blocked(jblk, fi, dim))
        yt = y if yt is None else yt + y
    ref = np.asarray(jblocking.blocked_scatter_sum(yt, jblk,
                                                   jobj.particle_cnt))
    assert float(np.abs(ref).max()) > 0
    np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                               atol=TOL * float(np.abs(ref).max()))


# -- the substeps through the force entries ----------------------------------


def _spy(monkeypatch, module, name):
    """Count the calls of ``module.name``, which still runs."""
    calls = []
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("layered", [False, True], ids=["one layer", "layers"])
@pytest.mark.parametrize("method", ["implicit_blocked", "explicit"])
@pytest.mark.parametrize("dim", [2, 3])
def test_blocked_substeps_match_jax(pairs, monkeypatch, dim, method,
                                    layered):
    """Three op-composed substeps with locality blocks — the implicit one
    with ``operator_mode="blocked"`` (K2 a layer, then K3 in the CG), the
    explicit analytic one (K7b a layer) — take ``blocked_prep_force`` or
    ``blocked_grad_force`` once a layer a substep, and match the JAX
    package's substeps: positions and internal inverses within 1e-5, equal
    CG iterations."""
    obj, state, jobj, jstate = pairs[(dim, layered)]
    over = (dict(preconditioned=1, operator_mode="blocked")
            if method == "implicit_blocked" else
            dict(use_explicit_method=True))
    pcfg, jcfg = sim_configs(dim, **over)
    jcfg = dataclasses.replace(jcfg, element_backend="pallas")
    pcfg = dataclasses.replace(pcfg, element_backend="pallas")
    calls = (_spy(monkeypatch, implicit, "blocked_prep_force")
             if method == "implicit_blocked"
             else _spy(monkeypatch, explicit, "blocked_grad_force"))
    kw = sim.substep_kwargs(pcfg)
    jstep = jsim.make_substep_fn(jobj, jcfg)
    obs = Obstacles.from_configs((), dim, device="cpu")
    jobs = JaxObstacles.from_configs((), dim)
    iters = []
    for i in range(3):
        state, aux = sim.substep(obj, state, obs, **kw)
        jstate, jaux = jstep(jstate, jobs)
        assert_state_close(state, jstate, what=f"substep {i}")
        assert int(aux.solver_iterations) == int(jaux.solver_iterations)
        iters.append(int(aux.solver_iterations))
    assert len(calls) == 3 * (2 if layered else 1)
    if method == "implicit_blocked":
        assert min(iters) > 1
    assert bool(jnp.isfinite(jstate.pos).all())
