# coding=utf-8
"""The port's locality blocking (``fem_tpu_torch.ops.blocking``) against the
JAX package's ``build_blocking`` on the same numpy arrays: the partition
must be identical (which elements and particles go in which block, in which
order), the slot plan must hold the same (particle, slot) pairs as the JAX
package's two-tier plan, and the slot-sum assembly must agree to float32
rounding (1e-6 of the largest entry: both sum a particle's slots in
ascending slot order, the JAX package split over two tiers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu.ops import blocking as jblocking
from fem_tpu_torch import convert, entry
from fem_tpu_torch.ops import blocking
from tests.test_blocked import _cube_mesh

torch.set_num_threads(1)

FIELDS = ("block_particles", "element_indices", "ref_inv", "volume",
          "element_perm", "element_slot")


def _cube_arrays(spacing=0.4):
    """(element_indices, ref_inv, volume, rest_pos) of the Delaunay cube of
    tests/test_blocked.py, through the port's host element setup."""
    from fem_tpu_torch.models.state import init_element_data

    nodes, _, tets = _cube_mesh(spacing)
    pos = nodes.astype(np.float32) + np.float32(2.0)
    ref_inv, volume, _ = init_element_data(pos, tets, 1000.0)
    return np.asarray(tets, np.int32), ref_inv, volume, pos


@pytest.fixture(scope="module")
def flagship_arrays():
    _, obj, _, _ = entry.flagship("cpu")
    arrays, _ = convert.object_to_arrays(obj)
    return obj, (arrays["element_indices"], arrays["ref_inv"],
                 arrays["volume"], arrays["rest_pos"])


def _assert_same_partition(port, jax_blk):
    assert port.num_blocks == jax_blk.num_blocks
    assert (port.eb, port.pb) == (jax_blk.eb, jax_blk.pb)
    for name in FIELDS:
        np.testing.assert_array_equal(
            getattr(port, name).numpy(), np.asarray(getattr(jax_blk, name)),
            err_msg=name,
        )
    np.testing.assert_array_equal(port.plus.numpy(),
                                  np.asarray(jax_blk.plus)[..., 0])
    np.testing.assert_array_equal(port.minus.numpy(),
                                  np.asarray(jax_blk.minus)[..., 0])


def _slot_pairs_port(port):
    ptr = port.slot_plan.ptr.numpy()
    rows = port.slot_plan.rows.numpy()
    counts = np.diff(ptr)
    return sorted(zip(np.repeat(np.arange(counts.size), counts).tolist(),
                      rows.tolist()))


def _slot_pairs_jax(jax_blk):
    sentinel = jax_blk.num_blocks * jax_blk.pb
    pairs = []
    lo = np.asarray(jax_blk.scatter_lo)
    for p, row in enumerate(lo):
        pairs += [(p, int(s)) for s in row if s != sentinel]
    if jax_blk.scatter_hi is not None:
        hi = np.asarray(jax_blk.scatter_hi)
        for p, row in zip(np.asarray(jax_blk.scatter_out), hi):
            pairs += [(int(p), int(s)) for s in row if s != sentinel]
    return sorted(pairs)


@pytest.mark.parametrize("caps", [(8, 16), (256, 128)])
def test_cube_partition_matches_jax(caps):
    eb, pb = caps
    args = _cube_arrays()
    port = blocking.build_blocking(*args, eb=eb, pb=pb, device="cpu")
    jax_blk = jblocking.build_blocking(*args, eb=eb, pb=pb)
    if caps == (8, 16):
        assert port.num_blocks >= 3  # several blocks, halo particles
    _assert_same_partition(port, jax_blk)
    assert _slot_pairs_port(port) == _slot_pairs_jax(jax_blk)


def test_flagship_partition_matches_jax(flagship_arrays):
    obj, args = flagship_arrays
    jax_blk = jblocking.build_blocking(*args)
    assert jax_blk.num_blocks == 17 and (jax_blk.eb, jax_blk.pb) == (256, 128)
    # build_object attached the same partition the JAX package builds.
    _assert_same_partition(obj.blocking, jax_blk)
    assert _slot_pairs_port(obj.blocking) == _slot_pairs_jax(jax_blk)
    # Padded particle slots (id 0, no contribution rows) stay out of the plan.
    real_slots = int((torch.diff(obj.blocking.local_ptr, dim=1) > 0).sum())
    assert obj.blocking.slot_plan.rows.numel() == real_slots


def test_object_from_arrays_rebuilds_the_same_blocking(flagship_arrays):
    obj, _ = flagship_arrays
    again = convert.object_from_arrays(*convert.object_to_arrays(obj), "cpu")
    for name in FIELDS + ("plus", "minus", "local_ptr", "local_rows",
                          "row_slot", "block_elements"):
        assert torch.equal(getattr(again.blocking, name),
                           getattr(obj.blocking, name)), name
    assert torch.equal(again.blocking.slot_plan.idx, obj.blocking.slot_plan.idx)


def test_local_plan_covers_every_real_contribution_once():
    """Each real (element, local vertex) row lands exactly once, on the
    local slot of that vertex; padded element slots are absent."""
    blk = blocking.build_blocking(*_cube_arrays(), eb=8, pb=16, device="cpu")
    d1 = blk.dim + 1
    for b in range(blk.num_blocks):
        ptr = blk.local_ptr[b].numpy()
        rows = blk.local_rows[b].numpy()
        nel = int(blk.block_elements[b])
        assert ptr[-1] == nel * d1
        seen = np.zeros(nel * d1, np.int64)
        for p in range(blk.pb):
            for row in rows[ptr[p]:ptr[p + 1]]:
                seen[row] += 1
                e, l = divmod(int(row), d1)
                local = (blk.minus[b, e * blk.dim] if l == 0
                         else blk.plus[b, e * blk.dim + l - 1])
                assert int(local) == p
                assert int(blk.row_slot[(b * blk.eb + e) * d1 + l]) == (
                    b * blk.pb + p)
        assert np.all(seen == 1)


@pytest.mark.parametrize("caps", [(8, 16), (256, 128)])
def test_blocked_scatter_sum_matches_jax(caps):
    eb, pb = caps
    args = _cube_arrays()
    port = blocking.build_blocking(*args, eb=eb, pb=pb, device="cpu")
    jax_blk = jblocking.build_blocking(*args, eb=eb, pb=pb)
    n = args[3].shape[0]
    rng = np.random.default_rng(0)
    part = rng.uniform(-1, 1, (port.num_blocks, pb, 3)).astype(np.float32)
    got = blocking.blocked_scatter_sum(torch.as_tensor(part), port).numpy()
    ref = np.asarray(jblocking.blocked_scatter_sum(
        jnp.asarray(part.transpose(0, 2, 1)), jax_blk, n))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-6 * float(np.abs(ref).max()))


def test_blocked_gather_duplicates_halo_particles():
    blk = blocking.build_blocking(*_cube_arrays(), eb=8, pb=16, device="cpu")
    n = int(blk.slot_plan.ptr.numel()) - 1
    x = torch.arange(3 * n, dtype=torch.float32).reshape(n, 3)
    xb = blocking.blocked_gather(x, blk)
    assert xb.shape == (blk.num_blocks, blk.pb, 3)
    assert torch.equal(xb, x[blk.block_particles.long()])
    # Some particle sits in more than one block.
    assert int(torch.diff(blk.slot_plan.ptr).max()) > 1
