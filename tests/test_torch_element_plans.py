# coding=utf-8
"""The launch in tiles of the four element kernels K1, K6, K9a and K9b
(``element_kernels.element_plan``), the binding of their wrappers
(``element_binding``), and their CPU path.

The plan is pure host code, so it is checked here at the shapes the card
sees: the flagship's 4,068 tets, ``default.json``'s 200 triangles, and the
ragged sizes 1, 31, 33 and 4,069, for every K1 instance (the seven base
materials and robust Neo-Hookean), every K6 instance (the seven base
materials), K9a and K9b, 2D and 3D (each element covered by one thread
once).  The binding is checked with a fake library: no launch.  On the CPU
the wrappers return their plain versions, which are held to the JAX
package's Pallas kernels in interpret mode at the tolerance of
tests/test_torch_element_kernels.py (block-relative 1e-5, atol 1e-6)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu.ops.pallas_kernels import (
    explicit_grad_columns_pallas,
    hessian_and_force_pallas,
    hessian_blocks_pallas,
    implicit_force_columns_pallas,
)
from fem_tpu_torch.models import mesh as pmesh
from fem_tpu_torch.models.state import build_object
from fem_tpu_torch.ops import element_kernels as ek
from fem_tpu_torch.ops.element import MATERIAL_IDS, ROBUST_NEO_HOOKEAN_ID
from fem_tpu_torch.utils import cuda_build
from fem_tpu_torch.utils.config import ObjectConfig

torch.set_num_threads(1)

SIZES = (4068, 200, 1, 31, 33, 4069)
# K1's instances by material id, K9b (the Neo-Hookean rhs alone), K9a
# (the Neo-Hookean blocks alone) and K6's instances (the base materials).
INSTANCES = [("K1", m) for m in range(ROBUST_NEO_HOOKEAN_ID + 1)] + [
    ("K9b", MATERIAL_IDS["neo_hookean"]),
    ("K9a", MATERIAL_IDS["neo_hookean"])] + [
    ("K6", m) for m in sorted(MATERIAL_IDS.values())]
INSTANCE_IDS = [f"{k}-m{m}" for k, m in INSTANCES]
SM_COUNT = 132  # H100 SXM


def _check_plan(plan, e):
    """CTAs, tiles and the ragged last tile of ``plan`` over ``e``
    elements: the tiles cover every element once, thread t of CTA c element
    c · tile + t, in whole warps."""
    assert plan.tile == ek.ELEMENT_TILE and plan.tile % 32 == 0
    assert plan.ctas == -(-e // plan.tile)
    assert 1 <= plan.last <= plan.tile
    assert (plan.ctas - 1) * plan.tile + plan.last == e
    seen = np.zeros(e, dtype=int)
    for cta in range(plan.ctas):
        elem = cta * plan.tile + np.arange(plan.tile)
        np.add.at(seen, elem[elem < e], 1)
    assert (seen == 1).all()


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("instance", INSTANCES, ids=INSTANCE_IDS)
@pytest.mark.parametrize("e", SIZES)
def test_element_plan_tiles_every_size(e, instance, dim):
    kernel, mid = instance
    plan = ek.element_plan(e, dim, mid, kernel)
    _check_plan(plan, e)


@pytest.mark.parametrize("dim", [2, 3])
def test_element_plan_spreads_the_flagship_over_the_sms(dim):
    """The flagship's tets (and as many triangles) fill on the order of 128
    CTAs, one wave of the 132 SMs, where one thread an element in CTAs of
    256 filled 16."""
    for kernel, mid in INSTANCES:
        plan = ek.element_plan(4068, dim, mid, kernel)
        assert (plan.tile, plan.ctas, plan.last) == (32, 128, 4), plan
        assert 64 <= plan.ctas <= SM_COUNT, plan
    empty = ek.element_plan(0, dim, 0, "K1")
    assert (empty.ctas, empty.last) == (0, 0)


def test_element_plan_refuses_what_the_kernels_do_not_take():
    nh = MATERIAL_IDS["neo_hookean"]
    for kernel in ("K9a", "K9b"):                    # Neo-Hookean only
        for mid in (ROBUST_NEO_HOOKEAN_ID, MATERIAL_IDS["stvk"],
                    MATERIAL_IDS["corotated"]):
            with pytest.raises(ValueError):
                ek.element_plan(100, 3, mid, kernel)
    with pytest.raises(ValueError):                  # K6: no robust chain
        ek.element_plan(100, 3, ROBUST_NEO_HOOKEAN_ID, "K6")
    for kernel in ("K1", "K6"):                      # no such instance
        with pytest.raises(ValueError):
            ek.element_plan(100, 3, ROBUST_NEO_HOOKEAN_ID + 1, kernel)
    with pytest.raises(ValueError):                  # no such kernel
        ek.element_plan(100, 3, nh, "K9")
    for kernel in ("K1", "K6", "K9a", "K9b"):
        for dim in (1, 4):
            with pytest.raises(ValueError):
                ek.element_plan(100, dim, nh, kernel)
        with pytest.raises(ValueError):
            ek.element_plan(-1, 3, nh, kernel)


class _Entry:
    """A ctypes function's stand-in: argument types unset until bound."""

    argtypes = None
    restype = None


class _FakeLibrary:
    def __init__(self):
        for name in ("fem_hessian_and_force", "fem_explicit_grad_columns",
                     "fem_hessian_blocks", "fem_implicit_force",
                     "fem_element_chain_error"):
            setattr(self, name, _Entry())


def test_binding_is_built_once_and_again_on_a_change(monkeypatch):
    """One binding for repeated (material, robust, μ, λ, d); a new one when
    μ, λ, the material or d changes; the library loaded once a binding, at
    its first use, with its entries' argument types set."""
    loads = []

    def fake_load(name, material=None):
        loads.append((name, material))
        return _FakeLibrary()

    monkeypatch.setattr(cuda_build, "load", fake_load)
    monkeypatch.setattr(ek, "_BINDINGS", {})
    b = ek.element_binding("neo_hookean", False, 1e4, 4e4, 3)
    assert ek.element_binding("neo_hookean", False, 1e4, 4e4, 3) is b
    assert loads == []                               # no launch yet
    lib = b.lib
    assert b.lib is lib and loads == [("element_chain", 0)]
    assert lib.fem_hessian_and_force.argtypes is not None
    assert len(lib.fem_implicit_force.argtypes) == 9
    want = ek.material_params("neo_hookean", 1e4, 4e4, 3)
    assert bytes(b.params) == bytes(want)
    for changed in (("neo_hookean", False, 2e4, 4e4, 3),
                    ("neo_hookean", False, 1e4, 5e4, 3),
                    ("stvk", False, 1e4, 4e4, 3),
                    ("neo_hookean", True, 1e4, 4e4, 3),
                    ("neo_hookean", False, 1e4, 4e4, 2)):
        other = ek.element_binding(*changed)
        assert other is not b
        assert ek.element_binding(*changed) is other
        assert bytes(other.params) == bytes(ek.material_params(
            changed[0], *changed[2:]))
    assert ek.element_binding("stvk", False, 1e4, 4e4, 3).mid == \
        MATERIAL_IDS["stvk"]
    assert ek.element_binding("neo_hookean", True, 1e4, 4e4, 3).mid == \
        ROBUST_NEO_HOOKEAN_ID
    assert ek.element_binding("neo_hookean", False, 1e4, 4e4, 3) is b


class _RecordingEntry(_Entry):
    """A C entry's stand-in that records its arguments and returns ``rc``."""

    def __init__(self, rc=0):
        self.calls = []
        self.rc = rc

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


def _meta_inputs(e, d):
    """K6's operands on the meta device (shapes only; data pointers 0)."""
    meta = torch.device("meta")
    return (torch.empty((50, d), device=meta),
            torch.empty((e, d + 1), dtype=torch.int32, device=meta),
            torch.empty((e, d, d), device=meta),
            torch.empty((e,), device=meta))


def test_k6_binding_is_built_once_and_again_on_a_change(monkeypatch):
    """K6's wrapper launches through ``element_binding``: one binding, one
    ``MaterialParamsC`` and one library load for repeated (material, μ, λ,
    d), the same argument reference on every launch; a new binding when μ,
    λ, the material or d changes.  Its launches are counted in total and by
    instance, its plan kept; a failed launch raises and counts nothing."""
    loads, built = [], []

    def fake_load(name, material=None):
        loads.append((name, material))
        lib = _FakeLibrary()
        lib.fem_explicit_grad_columns = _RecordingEntry()
        lib.fem_element_chain_error = lambda rc: b"fake error"
        return lib

    def counting_params(*args):
        built.append(args)
        return ek.MaterialParamsC(**ek.material_constants(*args))

    monkeypatch.setattr(cuda_build, "load", fake_load)
    monkeypatch.setattr(ek, "_BINDINGS", {})
    monkeypatch.setattr(ek, "material_params", counting_params)
    # The device checks and the stream need a card: stand-ins on the meta
    # device.
    monkeypatch.setattr(ek, "_check_elements", lambda pos, idx, r, v: (
        idx.shape[0], pos.shape[1], pos.device))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                        types.SimpleNamespace(cuda_stream=0))
    fn = ek.explicit_grad_columns
    monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(fn, "instance_launches", {})
    monkeypatch.setattr(fn, "last_plan", None)

    key = ("neo_hookean", 1e4, 4e4, 3)
    args = _meta_inputs(33, 3)
    for _ in range(3):
        g = fn(*args, 1e4, 4e4)
        assert g.shape == (33, 3, 3) and g.device.type == "meta"
    b = ek.element_binding("neo_hookean", False, 1e4, 4e4, 3)
    entry = b.lib.fem_explicit_grad_columns
    assert loads == [("element_chain", 0)] and len(built) == 1
    assert len(entry.calls) == 3
    assert all(c[:2] == (3, 0) and c[6] == 33 and c[7] is b.ref
               for c in entry.calls)
    assert bytes(b.params) == bytes(ek.MaterialParamsC(
        **ek.material_constants(*key)))
    assert fn.launches == 3 and fn.instance_launches == {(3, 0): 3}
    assert fn.last_plan == ek.element_plan(33, 3, 0, "K6")

    changed = (("neo_hookean", 2e4, 4e4, 3), ("neo_hookean", 1e4, 5e4, 3),
               ("fiber:1,0,0", 1e4, 4e4, 3), ("corotated", 1e4, 4e4, 3),
               ("neo_hookean", 1e4, 4e4, 2))
    for i, (material, mu, lam, d) in enumerate(changed, start=2):
        e = 31 + i
        for _ in range(2):
            fn(*_meta_inputs(e, d), mu, lam, material)
        other = ek.element_binding(material, False, mu, lam, d)
        assert other is not b and len(loads) == i and len(built) == i
        assert len(other.lib.fem_explicit_grad_columns.calls) == 2
        assert fn.last_plan == ek.element_plan(e, d, other.mid, "K6")
        assert bytes(other.params) == bytes(ek.MaterialParamsC(
            **ek.material_constants(material, mu, lam, d)))
    assert fn.launches == 3 + 2 * len(changed)
    assert fn.instance_launches[(3, ek.MATERIAL_IDS["fiber"])] == 2
    assert fn.instance_launches[(2, 0)] == 2

    entry.rc = 1
    with pytest.raises(RuntimeError,
                       match="gradient-columns kernel launch failed: fake"):
        fn(*args, 1e4, 4e4)
    assert fn.launches == 3 + 2 * len(changed) and len(entry.calls) == 4
    assert len(loads) == len(changed) + 1


def _mesh(dim):
    """3D: the 3-subdivision grid cube (162 tets); 2D: default.json's
    square (200 triangles)."""
    if dim == 3:
        cfg = ObjectConfig(subdivisions=3, side_length=0.2,
                           center=(0.4, 0.6, 0.4), E=4e4)
        v, f, t = pmesh.construct_3d_grid_mesh(cfg)
    else:
        cfg = ObjectConfig(subdivisions=10, side_length=0.2,
                           center=(0.5, 0.8), E=4e4, nu=0.2)
        v, f, t = pmesh.construct_2d_mesh(cfg)
    return build_object(cfg, v, f, t, device="cpu")


def _cut_inputs(dim, e, seed):
    """``e`` elements cut cyclically from the mesh, its positions moved by a
    fifth of an element's size (numpy seed)."""
    obj, state = _mesh(dim)
    rng = np.random.default_rng(seed)
    h = 0.2 / (3 if dim == 3 else 10)
    pos = state.pos + torch.as_tensor(
        rng.uniform(-0.2 * h, 0.2 * h, tuple(state.pos.shape)).astype(
            np.float32))
    idx = torch.arange(e) % obj.element_cnt
    return (pos, obj.element_indices[idx].contiguous(),
            obj.ref_inv[idx].contiguous(), obj.volume[idx].contiguous(),
            obj.mu, obj.s_lambda)


def _assert_blocks_close(got, ref, rtol=1e-5, atol=1e-6):
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(axis=1)[:, None, None]
    assert (np.abs(got - ref) <= atol + rtol * scale).all()


CPU_CASES = [("K1", "neo_hookean", False), ("K1", "neo_hookean", True),
             ("K1", "corotated", False), ("K9b", "neo_hookean", False),
             ("K9a", "neo_hookean", False), ("K6", "neo_hookean", False),
             ("K6", "corotated", False)]
WRAPPERS = (ek.hessian_and_force, ek.implicit_force_columns,
            ek.hessian_blocks, ek.explicit_grad_columns)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("case", CPU_CASES,
                         ids=["K1-nh", "K1-nh-robust", "K1-corotated", "K9b",
                              "K9a", "K6-nh", "K6-corotated"])
def test_cpu_wrappers_return_plain_and_match_pallas(case, dim):
    """On CPU tensors K1, K9b, K9a and K6 return their plain versions (no
    launch, no plan) at a ragged 33 elements, and those match the Pallas
    kernels."""
    kernel, material, robust = case
    args = _cut_inputs(dim, 33, seed=dim)
    jargs = tuple(jnp.asarray(a.numpy()) for a in args[:4]) + args[4:]
    launches = [fn.launches for fn in WRAPPERS]
    plans = [fn.last_plan for fn in WRAPPERS]
    if kernel == "K1":
        got = ek.hessian_and_force(*args, robust, material)
        ref = ek.hessian_and_force_plain(*args, material, robust)
        jax_ref = hessian_and_force_pallas(*jargs, robust, material)
    elif kernel == "K9b":
        got = (ek.implicit_force_columns(*args),)
        ref = (ek.implicit_force_columns_plain(*args),)
        jax_ref = (implicit_force_columns_pallas(*jargs),)
    elif kernel == "K9a":
        got = (ek.hessian_blocks(*args),)
        ref = (ek.hessian_blocks_plain(*args),)
        jax_ref = (hessian_blocks_pallas(*jargs),)
    else:
        got = (ek.explicit_grad_columns(*args, material),)
        ref = (ek.explicit_grad_columns_plain(*args, material),)
        jax_ref = (explicit_grad_columns_pallas(*jargs, material),)
    assert [fn.launches for fn in WRAPPERS] == launches
    assert [fn.last_plan for fn in WRAPPERS] == plans
    for g, r, j in zip(got, ref, jax_ref):
        assert g.shape == (33, dim, dim)
        assert torch.equal(g, r)
        assert np.isfinite(g.numpy()).all()
        _assert_blocks_close(g.numpy(), np.asarray(j))
