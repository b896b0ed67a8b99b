# coding=utf-8
"""The exact stiffness apply (``solvers/implicit.element_linearization``
and H1's plain version, ``ops/stiffness_kernels.py``) against the JAX
package's ``fem_tpu.solvers.modal.make_stiffness_hvp`` on the same numpy
inputs: 2D and 3D, every base material, pinned and free, column blocks
held column by column to the JAX product; the Jacobians in the edge
vectors against the same product in the vertex coordinates on a smooth
vector; a numpy emulation of H1's per-slot recomputation against the
plain apply; the slot order (``slot_of_row``) inverting the plan on the
flagship and ``demo_hanging.json``'s body; a numpy emulation of H1's two
phases (rows into slot order, then contiguous sums) against the per-slot
emulation; the plan's and the binding's variants and refusals.

Tolerances: the JAX product within 1e-5 of its largest entry (the two
packages sum the same derivative in other orders); H1's emulation within
1e-6 of the largest entry (the per-slot sums run in another order than
the plain gather's sum); the two phases equal to the per-slot emulation
bit for bit (the same row values summed over the same slots in the same
order)."""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fem_tpu.solvers import modal as jmodal
from fem_tpu_torch.ops import stiffness_kernels as sk
from fem_tpu_torch.ops.assembly import element_contrib_full, gather_assemble
from fem_tpu_torch.solvers import modal
from fem_tpu_torch.solvers.implicit import (
    _force_columns,
    element_linearization,
)
from fem_tpu_torch import scene
from fem_tpu_torch.utils.config import read_config
from tests.test_torch_multilevel import port_object
from tests.utils import make_2d_object, make_3d_object

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MATERIALS = {
    2: ("neo_hookean", "stvk", "linear", "corotated", "stable_neo_hookean",
        "mooney_rivlin:0.3", "fiber:1,0"),
    3: ("neo_hookean", "stvk", "linear", "corotated", "stable_neo_hookean",
        "mooney_rivlin", "fiber:1,0,0"),
}


def _body(dim, material, pinned, seed=0):
    """(port object, JAX object, deformed positions (N, d) float32): 2D 4
    subdivisions at E 4e4, ν 0.2 and 3D 2 subdivisions at ν 0.4 (where
    Mooney-Rivlin's calibration is feasible); pinned over the lowest third
    of the body."""
    if dim == 2:
        _, jobj, jstate = make_2d_object(subdivisions=4, E=4e4, nu=0.2)
    else:
        _, jobj, jstate = make_3d_object(subdivisions=2, nu=0.4)
    jobj = jobj.replace(material=material)
    rest = np.asarray(jstate.pos)
    if pinned:
        low = rest[:, 1] <= rest[:, 1].min() + 0.34 * np.ptp(rest[:, 1])
        jobj = jobj.replace(free_mask=jnp.asarray(
            (~low).astype(np.float32)[:, None]))
    rng = np.random.default_rng(seed)
    pos = (rest + rng.uniform(-0.01, 0.01, rest.shape) * np.ptp(rest)
           ).astype(np.float32)
    return port_object(jobj), jobj, pos


def _close(got, ref, rel):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("pinned", [False, True])
@pytest.mark.parametrize("mi", range(7))
def test_block_apply_matches_jax_hvp(dim, pinned, mi):
    """Every column of the (N, d, 5) block against the JAX package's HVP of
    that column, and the (N, d) apply against it too."""
    material = MATERIALS[dim][mi]
    obj, jobj, pos = _body(dim, material, pinned)
    rng = np.random.default_rng(1)
    w = rng.normal(size=pos.shape + (5,)).astype(np.float32)
    kv = modal.make_stiffness_hvp(obj, torch.as_tensor(pos))
    jkv = jmodal.make_stiffness_hvp(jobj, jnp.asarray(pos))
    got = kv(torch.as_tensor(w))
    assert got.shape == w.shape
    for c in range(w.shape[-1]):
        ref = np.asarray(jkv(jnp.asarray(w[..., c])))
        _close(got[..., c], ref, 1e-5)
    _close(kv(torch.as_tensor(w[..., 0])), np.asarray(
        jkv(jnp.asarray(w[..., 0]))), 1e-5)


def _vertex_form_apply(cols_fn, pos, element_indices, plan_idx, w):
    """The same product through each element's Jacobian in its (d+1)·d
    vertex coordinates, applied to the raw vertex values of w (which a
    smooth w's common translation cancels inside)."""
    e, dp1 = element_indices.shape
    d = dp1 - 1
    k = dp1 * d
    table = pos[element_indices.long()].reshape(e * dp1, d)
    local = torch.arange(e * dp1, dtype=torch.int32).reshape(e, dp1)
    tangents = torch.eye(k, dtype=pos.dtype).reshape(k, 1, dp1, d).expand(
        k, e, dp1, d).reshape(k, e * dp1, d)
    jac = torch.func.vmap(lambda t: torch.func.jvp(
        lambda x: cols_fn(x, local), (table,), (t,))[1])(tangents)
    jac = jac.reshape(k, e, d * d).permute(1, 2, 0)
    we = w[element_indices.long()].reshape(e, k, 1)
    dcols = torch.matmul(jac, we).reshape(e, d, d)
    return gather_assemble(element_contrib_full(dcols), plan_idx)


@pytest.mark.parametrize("dim", [2, 3])
def test_edge_form_keeps_a_smooth_vector_s_differences(dim):
    """A smooth w (a unit translation plus 1e-3 of noise): the edge form
    within 1e-5 of the float64 product's largest entry, and the vertex form
    at least 10× further off; the single-column apply equal bit for bit to
    the block apply's one column."""
    from fem_tpu_torch.convert import to_dtype

    obj, _, pos = _body(dim, "neo_hookean", True)
    cols = _force_columns(obj, False, None)
    rng = np.random.default_rng(2)
    w = (1.0 + 1e-3 * rng.normal(size=pos.shape)).astype(np.float32)
    o64 = to_dtype(obj, torch.float64)
    ref = element_linearization(
        _force_columns(o64, False, None), torch.as_tensor(pos).double(),
        obj.element_indices, obj.plan)(torch.as_tensor(w).double()).numpy()
    pos32, w32 = torch.as_tensor(pos), torch.as_tensor(w)
    lin = element_linearization(cols, pos32, obj.element_indices, obj.plan)
    edge = lin(w32)
    vertex = _vertex_form_apply(cols, pos32, obj.element_indices,
                                obj.plan.idx, w32)
    top = np.abs(ref).max()
    err_edge = np.abs(edge.numpy() - ref).max() / top
    err_vertex = np.abs(vertex.numpy() - ref).max() / top
    assert err_edge < 1e-5
    assert err_vertex > 10 * err_edge
    assert torch.equal(lin(w32[..., None])[..., 0], edge)
    neg = element_linearization(cols, pos32, obj.element_indices, obj.plan,
                                negate=True)(w32)
    assert torch.equal(neg, -edge)


def _h1_emulated(jac, w, element_indices, ptr, rows):
    """H1's arithmetic in numpy float32: each output entry (particle,
    component, column) sums its particle's plan slots in order, each slot
    recomputed from J_e and the element's edge differences of w (a dot
    product of length d² for a vertex l ≥ 1; −(col₀ + col₁ + …) for vertex
    0), as csrc/stiffness_apply.cu does."""
    jac = jac.numpy()
    w = w.numpy()
    elem = element_indices.numpy()
    ptr, rows = ptr.numpy(), rows.numpy()
    n, d, c = w.shape
    k = d * d
    out = np.zeros_like(w)
    for p in range(n):
        acc = np.zeros((d, c), np.float32)
        for s in range(ptr[p], ptr[p + 1]):
            e, l = divmod(int(rows[s]), d + 1)
            we = (w[elem[e, 1:]] - w[elem[e, :1]]).reshape(k, c)
            if l > 0:
                val = np.stack([jac[e, i * d + l - 1] @ we for i in range(d)])
            else:
                val = np.zeros((d, c), np.float32)
                for j in range(d):
                    col = np.stack([jac[e, i * d + j] @ we
                                    for i in range(d)])
                    val = col if j == 0 else val + col
                val = -val
            acc = acc + val.astype(np.float32)
        out[p] = acc
    return out


@pytest.mark.parametrize("dim,c", [(2, 1), (2, 9), (3, 1), (3, 8)])
def test_h1_slot_recomputation_matches_plain_apply(dim, c):
    obj, _, pos = _body(dim, "neo_hookean", False)
    pos = torch.as_tensor(pos)
    e, dp1 = obj.element_indices.shape
    d = dp1 - 1
    cols = _force_columns(obj, False, None)
    rng = np.random.default_rng(3)
    jac = torch.as_tensor(rng.normal(size=(e, d * d, d * d)).astype(
        np.float32))
    w = torch.as_tensor(rng.normal(size=(obj.particle_cnt, d, c)).astype(
        np.float32))
    ref = sk.stiffness_apply_plain(jac, w, obj.element_indices, obj.plan.idx)
    got = _h1_emulated(jac, w, obj.element_indices, obj.plan.ptr,
                       obj.plan.rows)
    _close(got, ref, 1e-6)
    # The linearization's own Jacobians, through the wrapper's CPU route.
    lin = element_linearization(cols, pos, obj.element_indices, obj.plan)
    _close(_h1_emulated(lin.binding.jac, w, obj.element_indices,
                        obj.plan.ptr, obj.plan.rows), lin(w), 1e-6)


@pytest.mark.parametrize("dim", [2, 3])
def test_block_apply_equals_columns_applied_one_by_one(dim):
    obj, _, pos = _body(dim, "neo_hookean", True)
    kv = modal.make_stiffness_hvp(obj, torch.as_tensor(pos))
    w = torch.as_tensor(np.random.default_rng(4).normal(
        size=pos.shape + (9,)).astype(np.float32))
    block = kv(w)
    for c in range(9):
        _close(block[..., c], kv(w[..., c].contiguous()), 1e-6)
    assert torch.equal(kv(w), block)


def test_stiffness_plan_and_refusals():
    p = sk.stiffness_plan(1007, 3, 9, torch.float32, 4068)
    assert (p.threads, p.ctas, p.dtype) == (128, -(-1007 * 27 // 128), "f32")
    assert sk.stiffness_plan(121, 2, 1, torch.float64, 200).dtype == "f64"
    for args in ((10, 4, 1, torch.float32, 4), (10, 1, 1, torch.float32, 4),
                 (0, 3, 1, torch.float32, 4), (10, 3, 0, torch.float32, 4),
                 (10, 3, 1, torch.float16, 4), (10, 3, 1, torch.int32, 4)):
        with pytest.raises(ValueError):
            sk.stiffness_plan(*args)


def _config_object(name):
    """The first body of ``configs/<name>`` on the CPU."""
    (body,), _ = scene.load_scene(
        read_config(os.path.join(REPO, "configs", name)), device="cpu")
    return body.obj


@pytest.mark.parametrize("name,dim,slots",
                         [("demo_spot.json", 3, 56),
                          ("demo_hanging.json", 2, 6)])
def test_slot_of_row_inverts_the_plan(name, dim, slots):
    """``slot_order`` (the binding's ``slot_of_row``) is a permutation of
    the slots and inverts the plan's rows both ways; the busiest particle
    holds the slots that set the first design's chain."""
    obj = _config_object(name)
    plan = obj.plan
    e, dp1 = obj.element_indices.shape
    assert dp1 == dim + 1
    rows = plan.rows.numpy()
    slot = sk.slot_order(plan.rows)
    assert slot.dtype == torch.int32 and slot.shape == (e * dp1,)
    slot = slot.numpy()
    assert np.array_equal(np.sort(slot), np.arange(e * dp1))
    assert np.array_equal(rows[slot], np.arange(e * dp1))
    assert np.array_equal(slot[rows], np.arange(e * dp1))
    assert int(np.diff(plan.ptr.numpy()).max()) == slots
    jac = torch.zeros((e, dim * dim, dim * dim))
    b = sk.StiffnessBinding(jac, obj.element_indices, plan)
    assert torch.equal(b.slot_of_row, torch.as_tensor(slot))


def _kernel_batch():
    """Phase B's batch, ``kBatch`` in csrc/stiffness_apply.cu."""
    with open(os.path.join(REPO, "fem_tpu_torch", "csrc",
                           "stiffness_apply.cu"), encoding="utf-8") as f:
        (batch,) = re.findall(r"constexpr int kBatch = (\d+);", f.read())
    return int(batch)


def _h1_two_phase_emulated(jac, w, element_indices, slot_of_row, ptr):
    """H1's rows variant in numpy float32.  Phase A: each element's rows
    once (its edge differences of w, the d columns of J_e's product, vertex
    0's −(col₀ + col₁ + …)), each stored to its slot of a scratch R in the
    plan's slot order.  Phase B: each particle's contiguous slots of R
    summed in order, from zero, in batches of the kernel's ``kBatch``, the
    last batch's surplus added as +0 as the kernel adds it."""
    jac = jac.numpy()
    w = w.numpy()
    elem = element_indices.numpy()
    slot, ptr = slot_of_row.numpy(), ptr.numpy()
    n, d, c = w.shape
    e_cnt = elem.shape[0]
    k = d * d
    r = np.full((e_cnt * (d + 1), d, c), np.nan, np.float32)
    for e in range(e_cnt):
        we = (w[elem[e, 1:]] - w[elem[e, :1]]).reshape(k, c)
        cols = [np.stack([jac[e, i * d + j] @ we for i in range(d)])
                for j in range(d)]
        v0 = cols[0]
        for j in range(d):
            r[slot[e * (d + 1) + j + 1]] = cols[j]
            if j > 0:
                v0 = v0 + cols[j]
        r[slot[e * (d + 1)]] = -v0
    assert not np.isnan(r).any()  # every slot written once
    batch = _kernel_batch()
    zero = np.zeros((d, c), np.float32)
    out = np.zeros_like(w)
    for p in range(n):
        acc = np.zeros((d, c), np.float32)
        begin, end = ptr[p], ptr[p + 1]
        for s in range(begin, begin + -(-(end - begin) // batch) * batch):
            acc = acc + (r[s] if s < end else zero)
        out[p] = acc
    return out


@pytest.mark.parametrize("body,c", [("2d", 1), ("2d", 9), ("3d", 1),
                                    ("3d", 9), ("flagship", 9)])
def test_h1_two_phases_equal_the_slot_recomputation(body, c):
    """The rows variant's data flow, emulated, equals the first design's
    emulation bit for bit (random Jacobians), and its linearization's own
    Jacobians too; the flagship holds particles of up to 56 slots."""
    if body == "flagship":
        obj = _config_object("demo_spot.json")
        pos = None
    else:
        obj, _, pos = _body(2 if body == "2d" else 3, "neo_hookean", False)
    e, dp1 = obj.element_indices.shape
    d = dp1 - 1
    rng = np.random.default_rng(5)
    jac = torch.as_tensor(rng.normal(size=(e, d * d, d * d)).astype(
        np.float32))
    w = torch.as_tensor(rng.normal(size=(obj.particle_cnt, d, c)).astype(
        np.float32))
    b = sk.StiffnessBinding(jac, obj.element_indices, obj.plan)
    got = _h1_two_phase_emulated(jac, w, obj.element_indices, b.slot_of_row,
                                 obj.plan.ptr)
    ref = _h1_emulated(jac, w, obj.element_indices, obj.plan.ptr,
                       obj.plan.rows)
    assert np.array_equal(got, ref)
    _close(got, sk.stiffness_apply_plain(jac, w, obj.element_indices,
                                         obj.plan.idx), 1e-6)
    if pos is None:
        return
    lin = element_linearization(_force_columns(obj, False, None),
                                torch.as_tensor(pos), obj.element_indices,
                                obj.plan)
    assert np.array_equal(
        _h1_two_phase_emulated(lin.binding.jac, w, obj.element_indices,
                               lin.binding.slot_of_row, obj.plan.ptr),
        _h1_emulated(lin.binding.jac, w, obj.element_indices, obj.plan.ptr,
                     obj.plan.rows))


def test_stiffness_plan_variants():
    """The rows variant (the default): phase B's CTAs an output entry,
    phase A's an (element, component, column); the slots variant: one
    kernel's CTAs, no phase A.  Unknown variants and element counts below
    one are refused."""
    p = sk.stiffness_plan(1007, 3, 9, torch.float32, 4068)
    assert (p.variant, p.threads, p.ctas, p.row_ctas) == (
        "rows", 128, -(-1007 * 27 // 128), -(-4068 * 27 // 128))
    q = sk.stiffness_plan(1007, 3, 9, torch.float32, 4068, "slots")
    assert (q.variant, q.ctas, q.row_ctas) == ("slots", p.ctas, 0)
    assert sk.stiffness_plan(121, 2, 1, torch.float64, 200).row_ctas == -(
        -200 * 2 // 128)
    assert sk.VARIANTS == ("rows", "slots")
    for args in ((10, 3, 1, torch.float32, 4, "tiles"),
                 (10, 3, 1, torch.float32, 0),
                 (10, 3, 1, torch.float32, -1, "slots"),
                 (10, 4, 1, torch.float32, 4, "slots"),
                 (10, 3, 0, torch.float32, 4, "rows")):
        with pytest.raises(ValueError):
            sk.stiffness_plan(*args)


def test_stiffness_binding_variants():
    """The binding holds the slot order of its plan; on the CPU the apply
    runs the plain version in either variant and refuses an unknown one."""
    obj, _, pos = _body(3, "neo_hookean", True)
    lin = element_linearization(_force_columns(obj, False, None),
                                torch.as_tensor(pos), obj.element_indices,
                                obj.plan)
    b = lin.binding
    assert torch.equal(b.slot_of_row, sk.slot_order(obj.plan.rows))
    w = torch.as_tensor(np.random.default_rng(6).normal(
        size=pos.shape + (3,)).astype(np.float32))
    ref = sk.stiffness_apply_plain(b.jac, w, b.element_indices, b.plan_idx)
    assert torch.equal(sk.stiffness_apply(b, w), ref)
    assert torch.equal(sk.stiffness_apply(b, w, variant="slots"), ref)
    with pytest.raises(ValueError, match="unknown H1 variant"):
        sk.stiffness_apply(b, w, variant="tiles")

