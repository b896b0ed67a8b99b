# coding=utf-8
"""The probes' modules against the JAX package: ``pad_blocking``, P1's plain
version (``probes/pairblock.py``) against ``tools/probe_pairblock.py``'s
``paired_matvec`` in interpret mode, and P2's plain version
(``probes/int8.py``) against a numpy statement of the kernel body.

Tolerances: ``pad_blocking`` field by field exactly; P1 to 1e-5 of the
largest entry (the Pallas kernel's three-plane bf16 split dots are exact
to f32 rounding, and the sums run in another order); P2 exactly for
int8 × int8 and to 1e-6 of the largest entry for the bf16 variants (f32
sums of 384 exact products).  P2 is held to numpy, not to the JAX probe:
the JAX probe builds its kernel inside ``main()`` and returns no values,
only times."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from fem_tpu.models.mesh import construct_3d_grid_mesh
from fem_tpu.models.state import build_object as jax_build_object
from fem_tpu.ops import blocking as jblocking
from fem_tpu.ops.element import hessian_blocks as jax_hessian_blocks
from fem_tpu.utils import config as jconfig
from fem_tpu_torch import convert
from fem_tpu_torch.ops import blocked_kernels, blocking
from fem_tpu_torch.probes import int8 as p2
from fem_tpu_torch.probes import pairblock as p1

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_probe():
    spec = importlib.util.spec_from_file_location(
        "probe_pairblock", os.path.join(REPO, "tools", "probe_pairblock.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bodies():
    """The 5-subdivision grid cube (750 tets, 3 locality blocks) in both
    packages, deformed and moving with numpy noise."""
    ocfg = jconfig.ObjectConfig(subdivisions=5, side_length=0.2,
                                center=(0.4, 0.1, 0.4), E=4e5, rho=1000.0,
                                damping=10.0)
    v, f, t = construct_3d_grid_mesh(ocfg)
    jobj, jstate = jax_build_object(ocfg, v, f, t)
    rng = np.random.default_rng(0)
    pos = (np.asarray(jstate.pos)
           + rng.uniform(-0.004, 0.004, jstate.pos.shape)).astype(np.float32)
    vel = rng.uniform(-0.3, 0.3, pos.shape).astype(np.float32)
    arrays = {n: np.asarray(getattr(jobj, n)) for n in convert.OBJECT_ARRAYS}
    statics = {n: getattr(jobj, n) for n in convert.OBJECT_STATICS}
    obj = convert.object_from_arrays(arrays, statics, "cpu")
    assert obj.blocking.num_blocks == jobj.blocking.num_blocks == 3
    return jobj, obj, pos, vel


@pytest.mark.parametrize("multiple", [2, 4])
def test_pad_blocking_matches_jax(bodies, multiple):
    jobj, obj, _, vel = bodies
    jp = jblocking.pad_blocking(jobj.blocking, multiple)
    pp = blocking.pad_blocking(obj.blocking, multiple)
    assert pp.num_blocks == jp.num_blocks == 4
    for name in ("block_particles", "element_indices", "ref_inv", "volume",
                 "element_perm"):
        assert np.array_equal(getattr(pp, name).numpy(),
                              np.asarray(getattr(jp, name))), name
    for name in ("plus", "minus"):
        assert np.array_equal(getattr(pp, name).numpy(),
                              np.asarray(getattr(jp, name))[..., 0]), name
    # The port's own tables: the padded block is empty.
    b = obj.blocking.num_blocks
    assert not pp.block_elements[b:].any()
    assert not pp.local_ptr[b:].any() and not pp.local_rows[b:].any()
    assert torch.equal(pp.element_slot, obj.blocking.element_slot)
    # The same operator: G(K)·x over the padded blocks.
    K, _ = blocked_kernels.blocked_prep(pp, torch.as_tensor(bodies[2]),
                                        obj.mu, obj.s_lambda)
    y = blocked_kernels.blocked_graph_apply(pp, K, torch.as_tensor(vel))
    y0 = blocked_kernels.blocked_graph_apply(
        obj.blocking, K[: b * obj.blocking.eb], torch.as_tensor(vel))
    assert torch.equal(y, y0)
    assert blocking.pad_blocking(pp, multiple) is pp


@pytest.mark.parametrize("pair", [1, 2, 4])
def test_paired_matvec_plain_matches_jax(bodies, pair):
    jobj, obj, pos, vel = bodies
    probe = _jax_probe()
    jblk = jblocking.pad_blocking(jobj.blocking, pair)
    K = jax_hessian_blocks(pos, jblk.element_indices, jblk.ref_inv,
                           jblk.volume, jobj.mu, jobj.s_lambda)
    jkp = jblocking.make_kplane(jblk, K, 3)
    jxbt = jblocking.blocked_gather(vel, jblk)
    ref = np.asarray(probe.paired_matvec(jblk, jkp, jxbt, 3, pair))
    blk = blocking.pad_blocking(obj.blocking, pair)
    kp = p1.make_kplane(blk, torch.as_tensor(np.array(K)))
    assert np.array_equal(kp.numpy(), np.asarray(jkp))
    xbt = p1.blocked_gather_planar(torch.as_tensor(vel), blk)
    assert np.array_equal(xbt.numpy(), np.asarray(jxbt))
    got = p1.paired_matvec(blk, kp, xbt, 3, pair).numpy()
    assert got.shape == ref.shape == (blk.num_blocks, 3, blk.pb)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_paired_matvec_needs_whole_pairs(bodies):
    _, obj, _, vel = bodies
    blk = obj.blocking
    kp = torch.zeros((blk.num_blocks, 9, blk.eb * 3))
    xbt = p1.blocked_gather_planar(torch.as_tensor(vel), blk)
    with pytest.raises(ValueError, match="pad"):
        p1.paired_matvec(blk, kp, xbt, 3, 2)
    with pytest.raises(ValueError):
        p1.paired_matvec(blk, kp, xbt, 3, 3)


def _numpy_chain(a, w, reps):
    """The kernel body in numpy: acc = Σ_r roll(a, r, rows) @ w, float64."""
    acc = np.zeros((a.shape[0], w.shape[1]))
    for r in range(reps):
        acc += np.roll(a, r, axis=0) @ w
    return acc


@pytest.mark.parametrize("variant", p2.VARIANTS)
def test_chained_dot_plain_matches_numpy(variant):
    a, w = p2.probe_inputs(6, 128, 256, variant)
    got = p2.chained_dot(a, w, 3, variant)
    ref = _numpy_chain(a.float().numpy().astype(np.float64),
                       w.float().numpy().astype(np.float64), 3)
    assert got.shape == (6, 256)
    if variant == "int8xint8":
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), ref.astype(np.int64))
    else:
        assert got.dtype == torch.float32
        assert np.abs(got.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()


def test_chained_dot_checks_types_and_the_library_operands():
    a, w = p2.probe_inputs(6, 128, 256, "bf16xbf16")
    with pytest.raises(TypeError):
        p2.chained_dot(a, w, 3, "int8xint8")
    with pytest.raises(ValueError):
        p2.chained_dot(a, w, 3, "fp8")
    stack = p2.stacked(a, 3)
    assert stack.shape == (24, 128)
    assert torch.equal(stack[6:12], torch.roll(a, 1, dims=0))
    assert not stack[18:].any()


@pytest.mark.parametrize("main", [p1.main, p2.main], ids=["P1", "P2"])
def test_probe_mains_need_the_card(main, capsys):
    """Without a CUDA device a probe prints no result and returns 1."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert main([]) == 1
    assert capsys.readouterr().out == ""
