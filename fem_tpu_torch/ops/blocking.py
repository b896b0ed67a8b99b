# coding=utf-8
"""M7: locality blocking of the element mesh.

The port of the JAX package's ``ops/blocking.py`` partition
(``_morton_order``, ``build_blocking``, ``_element_slot``,
``blocked_gather``, ``blocked_scatter_sum``).  Elements are sorted by the
Morton code of their rest centroids and packed greedily into blocks of at
most ``eb`` elements touching at most ``pb`` distinct particles; which
elements and particles land in which block, and in which order, is identical
to the JAX package's partition.

Each block is one CUDA thread block's unit of work in the blocked kernels
(``ops/blocked_kernels.py``, ``ops/frame_kernels.py``): it gathers its
particles into shared memory, works on its elements there, and leaves one
partial per particle slot.  Two plans, built here once on the host, sum
those without float atomics and in a fixed order:

* the **local plan** (``local_ptr``/``local_rows``): per block and local
  particle slot, the block's contribution rows ``e·(d+1)+l`` (local vertex
  ``l`` of the block's ``e``-th element) that land on it;
* the **slot plan** (``slot_plan``): per mesh particle, the flat block slots
  ``b·Pb+p`` that hold it — halo particles sit in several blocks — as a
  padded plan (plain versions) and in CSR form (kernels).

What the JAX package adds for the TPU is left out: the one-hot tables
``s_dense``/``g_dense``, the VMEM gate and the padding of the block count to
a multiple of 4 (Pallas grid pairing), and the two-tier split of the slot
plan.  Padded element slots (past a block's real elements) replicate mesh
element 0 at volume 0, as in the JAX package; padded particle slots hold id
0 and stay out of the slot plan.  :func:`shard_blocking` gives one rank
its blocks whole, with the plans re-based on them (element sharding,
``parallel/sharding.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fem_tpu_torch.ops.assembly import GatherPlan, gather_assemble, plan_to_csr
from fem_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Blocking:
    """Element-block partition and block-ordered element arrays (row
    ``b·Eb+e`` is block ``b``'s ``e``-th element slot)."""

    block_particles: torch.Tensor  # (B, Pb) int32 global particle ids, 0-padded
    plus: torch.Tensor  # (B, Eb·d) int32 local slot of vertex j+1, row e·d+j
    minus: torch.Tensor  # (B, Eb·d) int32 local slot of vertex 0, row e·d+j
    element_indices: torch.Tensor  # (B·Eb, d+1) int32, padded with element 0
    ref_inv: torch.Tensor  # (B·Eb, d, d)
    volume: torch.Tensor  # (B·Eb,) 0 on padded slots
    element_perm: torch.Tensor  # (B·Eb,) int32 mesh element of each slot
    element_slot: torch.Tensor  # (E,) int32 slot of each mesh element
    block_elements: torch.Tensor  # (B,) int32 real elements of each block
    local_ptr: torch.Tensor  # (B, Pb+1) int32 offsets into local_rows[b]
    local_rows: torch.Tensor  # (B, Eb·(d+1)) int32 contribution rows by slot
    row_slot: torch.Tensor  # (B·Eb·(d+1),) int64 flat slot b·Pb+p of each row
    slot_plan: GatherPlan  # mesh particle → flat block slots
    num_blocks: int = 0
    eb: int = 0
    pb: int = 0

    @property
    def dim(self) -> int:
        return self.element_indices.shape[1] - 1


def _morton_order(centroids: np.ndarray) -> np.ndarray:
    """Sort key: interleaved 10-bit Morton code of element centroids
    (consecutive elements are spatially adjacent)."""
    lo, hi = centroids.min(0), centroids.max(0)
    q = ((centroids - lo) / np.maximum(hi - lo, 1e-30) * 1023).astype(
        np.uint64
    )

    def spread(x):
        x = (x | (x << 32)) & 0x1F00000000FFFF
        x = (x | (x << 16)) & 0x1F0000FF0000FF
        x = (x | (x << 8)) & 0x100F00F00F00F00F
        x = (x | (x << 4)) & 0x10C30C30C30C30C3
        x = (x | (x << 2)) & 0x1249249249249249
        return x

    code = spread(q[:, 0])
    for k in range(1, centroids.shape[1]):
        code = code | (spread(q[:, k]) << k)
    return np.argsort(code, kind="stable")


def _element_slot(flat: np.ndarray, vol_flat: np.ndarray) -> np.ndarray:
    """Mesh element id → block slot of its real (volume > 0) occurrence."""
    real = np.asarray(vol_flat) > 0.0
    slots = np.full(int(np.asarray(flat).max()) + 1, -1, np.int64)
    slots[np.asarray(flat)[real]] = np.nonzero(real)[0]
    if (slots < 0).any():
        raise ValueError("every mesh element needs a real block slot")
    return slots.astype(np.int32)


def _pack(idx: np.ndarray, order: np.ndarray, eb: int, pb: int):
    """Greedy packing of elements in ``order`` into (elements, sorted
    particles) blocks of at most ``eb`` elements and ``pb`` particles."""
    blocks = []
    cur: list = []
    cur_parts: set = set()
    for ei in order:
        new = cur_parts | set(idx[ei].tolist())
        if len(cur) + 1 > eb or len(new) > pb:
            blocks.append((cur, sorted(cur_parts)))
            cur, cur_parts = [ei], set(idx[ei].tolist())
        else:
            cur.append(ei)
            cur_parts = new
    if cur:
        blocks.append((cur, sorted(cur_parts)))
    return blocks


def build_blocking(
    element_indices: np.ndarray,
    ref_inv: np.ndarray,
    volume: np.ndarray,
    rest_pos: np.ndarray,
    eb: int = 256,
    pb: int = 128,
    device="cuda",
) -> Blocking:
    """Host-side partitioner (numpy, once at load) and its plans, as tensors
    on ``device``."""
    dev = resolve_device(device)
    idx = np.asarray(element_indices, np.int64)
    ref_inv = np.asarray(ref_inv, np.float32)
    volume = np.asarray(volume, np.float32)
    e_cnt, dp1 = idx.shape
    d = dp1 - 1
    n = np.asarray(rest_pos).shape[0]
    blocks = _pack(idx, _morton_order(np.asarray(rest_pos)[idx].mean(1)), eb, pb)
    b_cnt = len(blocks)
    r = eb * d
    blk_parts = np.zeros((b_cnt, pb), np.int32)
    plus = np.zeros((b_cnt, r), np.int32)
    minus = np.zeros((b_cnt, r), np.int32)
    # local_vert[b, k, l]: local slot of element k's vertex l.
    local_vert = np.zeros((b_cnt, eb, dp1), np.int64)
    blk_elems = np.zeros((b_cnt, eb), np.int64)
    vol_b = np.zeros((b_cnt, eb), np.float32)
    nparts = np.zeros((b_cnt,), np.int64)
    nelems = np.zeros((b_cnt,), np.int64)
    for b, (els, parts) in enumerate(blocks):
        lmap = {p: i for i, p in enumerate(parts)}
        blk_parts[b, : len(parts)] = parts
        nparts[b] = len(parts)
        nelems[b] = len(els)
        for k, ei in enumerate(els):
            blk_elems[b, k] = ei
            vol_b[b, k] = volume[ei]
            local_vert[b, k] = [lmap[v] for v in idx[ei].tolist()]
    plus[:] = local_vert[:, :, 1:].reshape(b_cnt, r)
    minus[:] = np.repeat(local_vert[:, :, 0], d, axis=1)

    # Local plan: contribution rows of each block sorted by local slot, in
    # ascending row order within a slot; padded element slots contribute
    # nothing and are left out.
    rows_per_block = eb * dp1
    local_ptr = np.zeros((b_cnt, pb + 1), np.int32)
    local_rows = np.zeros((b_cnt, rows_per_block), np.int32)
    for b in range(b_cnt):
        slots = local_vert[b, : nelems[b]].reshape(-1)
        order = np.argsort(slots, kind="stable")
        local_rows[b, : order.size] = order
        local_ptr[b, 1:] = np.cumsum(np.bincount(slots, minlength=pb))
    row_slot = (
        local_vert + (np.arange(b_cnt) * pb)[:, None, None]
    ).reshape(-1)

    # Slot plan over real particle slots only (padded slots hold particle 0
    # and carry nothing).
    real = (np.arange(pb)[None, :] < nparts[:, None]).reshape(-1)
    slot_rows = np.nonzero(real)[0]
    slot_parts = blk_parts.reshape(-1)[real]
    order = np.argsort(slot_parts, kind="stable")
    counts = np.bincount(slot_parts, minlength=n)
    maxdeg = max(int(counts.max()), 1)
    sentinel = b_cnt * pb
    plan = np.full((n, maxdeg), sentinel, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    ranks = np.arange(order.size) - starts[slot_parts[order]]
    plan[slot_parts[order], ranks] = slot_rows[order]
    ptr, rows = plan_to_csr(plan, sentinel)

    flat = blk_elems.reshape(-1)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return Blocking(
        block_particles=t(blk_parts),
        plus=t(plus),
        minus=t(minus),
        element_indices=t(idx[flat].astype(np.int32)),
        ref_inv=t(ref_inv[flat]),
        volume=t(vol_b.reshape(-1)),
        element_perm=t(flat.astype(np.int32)),
        element_slot=t(_element_slot(flat, vol_b.reshape(-1))),
        block_elements=t(nelems.astype(np.int32)),
        local_ptr=t(local_ptr),
        local_rows=t(local_rows),
        row_slot=t(row_slot),
        slot_plan=GatherPlan(
            idx=t(plan.astype(np.int32)), ptr=t(ptr), rows=t(rows)
        ),
        num_blocks=b_cnt,
        eb=eb,
        pb=pb,
    )


def pad_blocking(blocking: Blocking, multiple: int) -> Blocking:
    """The blocking with its block count padded to a multiple of
    ``multiple`` (the JAX package's ``pad_blocking``; the paired-block
    probe ``probes/pairblock.py`` needs it, as the flagship's 17 blocks
    pair with none).

    Padded blocks are empty: ``plus == minus == 0`` makes every S row of
    theirs zero, ``volume == 0`` zeroes their elements' contributions, their
    element slots replicate element slot 0 (finite geometry, the convention
    of :class:`Blocking` itself) and ``block_particles == 0``.  Beyond the
    JAX package's fields: a padded block has no real elements
    (``block_elements`` 0) and an empty local plan, its rows' flat slots
    are its slot 0, ``element_slot`` is unchanged (real slots do not move)
    and the slot plan's sentinel moves to the new slot count."""
    b = blocking.num_blocks
    target = ((b + multiple - 1) // multiple) * multiple
    pad = target - b
    if pad == 0:
        return blocking
    eb, pb = blocking.eb, blocking.pb

    def pad0(x, rows):
        return torch.cat([x, x.new_zeros((rows,) + tuple(x.shape[1:]))])

    def tile0(x, rows):
        return torch.cat([x, x[:1].expand((rows,) + tuple(x.shape[1:]))])

    rows_per_block = blocking.local_rows.shape[1]
    new_slots = (torch.arange(b, target, device=blocking.row_slot.device,
                              dtype=blocking.row_slot.dtype) * pb)
    plan = blocking.slot_plan
    idx = torch.where(plan.idx == b * pb, target * pb, plan.idx)
    return dataclasses.replace(
        blocking,
        block_particles=pad0(blocking.block_particles, pad),
        plus=pad0(blocking.plus, pad),
        minus=pad0(blocking.minus, pad),
        element_indices=tile0(blocking.element_indices, pad * eb),
        ref_inv=tile0(blocking.ref_inv, pad * eb),
        volume=pad0(blocking.volume, pad * eb),
        element_perm=tile0(blocking.element_perm, pad * eb),
        block_elements=pad0(blocking.block_elements, pad),
        local_ptr=pad0(blocking.local_ptr, pad),
        local_rows=pad0(blocking.local_rows, pad),
        row_slot=torch.cat([blocking.row_slot,
                            new_slots.repeat_interleave(rows_per_block)]),
        slot_plan=GatherPlan(idx=idx.to(plan.idx.dtype), ptr=plan.ptr,
                             rows=plan.rows),
        num_blocks=target,
    )


def blocked_gather(x: torch.Tensor, blocking: Blocking) -> torch.Tensor:
    """(N, d) → (B, Pb, d) block-local copies (halo particles duplicated)."""
    return x[blocking.block_particles]


def blocked_scatter_sum(partials: torch.Tensor, blocking: Blocking) -> torch.Tensor:
    """(B, Pb, d) per-slot partials → (N, d): each particle sums its slots in
    ascending slot order (halo contributions add; padded slots are never
    read).  Deterministic: a gather and a sum, no atomics."""
    return gather_assemble(partials, blocking.slot_plan.idx)


def shard_blocking(blocking: Blocking, rank: int, world: int) -> Blocking:
    """Rank ``rank``'s share of ``blocking`` over ``world`` ranks: the
    blocking padded to a multiple of ``world`` blocks (:func:`pad_blocking`)
    and its block rows ``[rank·B/world, (rank+1)·B/world)`` — each rank's
    blocks whole, as the JAX package shards them — with every block table
    and element row of those blocks.  The plans are re-based on the local
    blocks: ``row_slot`` counts from the first local block, and the slot
    plan, still over all N particles, holds each particle's local slots
    only, in ascending order; a particle that no local block holds has an
    empty range and sums to 0, so that the ranks' slot sums add up to the
    unsharded one.  ``element_slot`` is the local slot of each mesh element
    whose real occurrence is local, −1 for the others.  A rank past the
    real blocks holds only padded ones: no real element, an empty local
    plan and an empty slot plan."""
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"rank {rank} of {world}")
    padded = pad_blocking(blocking, world)
    lb = padded.num_blocks // world
    b0 = rank * lb
    eb, pb = padded.eb, padded.pb
    rows = padded.local_rows.shape[1]
    plan = padded.slot_plan
    dev = plan.ptr.device
    ptr = plan.ptr.cpu().numpy().astype(np.int64)
    slots = plan.rows.cpu().numpy().astype(np.int64)
    n = ptr.size - 1
    keep = (slots >= b0 * pb) & (slots < (b0 + lb) * pb)
    owner = np.repeat(np.arange(n), np.diff(ptr))[keep]
    local_slots = slots[keep] - b0 * pb
    counts = np.bincount(owner, minlength=n)
    local_ptr = np.concatenate([[0], np.cumsum(counts)])
    maxdeg = max(int(counts.max()) if counts.size else 0, 1)
    sentinel = lb * pb
    idx = np.full((n, maxdeg), sentinel, np.int64)
    idx[owner, np.arange(owner.size) - local_ptr[owner]] = local_slots
    slot = padded.element_slot.cpu().numpy().astype(np.int64) - b0 * eb
    slot[(slot < 0) | (slot >= lb * eb)] = -1
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return dataclasses.replace(
        padded,
        block_particles=padded.block_particles[b0:b0 + lb].clone(),
        plus=padded.plus[b0:b0 + lb].clone(),
        minus=padded.minus[b0:b0 + lb].clone(),
        element_indices=padded.element_indices[b0 * eb:(b0 + lb) * eb].clone(),
        ref_inv=padded.ref_inv[b0 * eb:(b0 + lb) * eb].clone(),
        volume=padded.volume[b0 * eb:(b0 + lb) * eb].clone(),
        element_perm=padded.element_perm[b0 * eb:(b0 + lb) * eb].clone(),
        element_slot=t(slot.astype(np.int32)),
        block_elements=padded.block_elements[b0:b0 + lb].clone(),
        local_ptr=padded.local_ptr[b0:b0 + lb].clone(),
        local_rows=padded.local_rows[b0:b0 + lb].clone(),
        row_slot=padded.row_slot[b0 * rows:(b0 + lb) * rows] - b0 * pb,
        slot_plan=GatherPlan(idx=t(idx.astype(np.int32)),
                             ptr=t(local_ptr.astype(np.int32)),
                             rows=t(local_slots.astype(np.int32))),
        num_blocks=lb,
    )
