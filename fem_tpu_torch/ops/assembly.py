# coding=utf-8
"""Nodal assembly without atomics: per-particle gather plans.

The port of the JAX package's ``ops/assembly.py``.  Each
particle sums its own incident contribution rows (row ``e·(d+1)+l`` is local
vertex ``l`` of element ``e``) in a fixed order, so assembly is deterministic
on every device.  The plan exists in two forms built once on the host:

* ``idx`` — the padded ``(N, max_degree)`` plan of the JAX package, padded
  with the sentinel row ``E·(d+1)`` (a zero row appended at apply time); the
  plain PyTorch versions gather through it;
* ``ptr``/``rows`` — the same rows in CSR form, which the CUDA kernels walk
  (no sentinel padding: the flagship's valence is skewed, median 12 and
  maximum 56).

``element_contrib_full`` encodes the reference's per-element scatter pattern:
local vertices ``1..d`` each receive one column of a d×d block, and local
vertex ``0`` receives the negative sum of those columns.

The serial Jacobi sweep's block-sparse rows (M10) have a plan of their own,
:func:`build_jacobi_plan` (the JAX package's, copied), and its inverse,
:func:`make_jacobi_gather`: for each of the N·max_nb neighbour slots its
contribution ids in ascending order, as a :class:`TieredPlan` (the slot
counts are skewed: a self slot sums every incident element, an off-diagonal
slot the few elements on one edge), so that the rows are summed by a gather
in a fixed order, as nodal assembly is.

Element sharding (``parallel/sharding.py``) sums each rank's share over the
ranks of a ``torch.distributed`` process group: :func:`segment_assemble`
(the JAX package's, with ``group`` for its ``axis_name``: a gather through
a plan built once an element table, then :func:`all_reduce_sum`) and
:func:`all_gather_rows` for the internal inverses.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    idx: torch.Tensor  # (N, max_degree) int32, sentinel-padded
    ptr: torch.Tensor  # (N + 1,) int32 CSR offsets into ``rows``
    rows: torch.Tensor  # (E·(d+1),) int32 contribution rows, per particle


def build_gather_plan(element_indices, num_particles: int) -> np.ndarray:
    """The padded per-particle incidence plan ``(N, max_degree)`` int32 of
    flattened contribution-row ids ``e·(d+1)+l`` in ascending row order,
    padded with the sentinel row ``E·(d+1)``.  Host-side numpy, once."""
    idx = np.asarray(element_indices)
    e, dp1 = idx.shape
    flat_particle = idx.reshape(-1)
    order = np.argsort(flat_particle, kind="stable")
    sorted_rows = order.astype(np.int64)
    sorted_particles = flat_particle[order]
    counts = np.bincount(sorted_particles, minlength=num_particles)
    maxdeg = int(counts.max()) if counts.size else 0
    sentinel = e * dp1
    plan = np.full((num_particles, maxdeg), sentinel, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    ranks = np.arange(sorted_rows.shape[0]) - starts[sorted_particles]
    plan[sorted_particles, ranks] = sorted_rows
    return plan.astype(np.int32)


def plan_to_csr(plan: np.ndarray, sentinel: int):
    """CSR ``(ptr (N+1,), rows)`` of a padded plan, same row order."""
    plan = np.asarray(plan)
    valid = plan != sentinel
    ptr = np.concatenate([[0], np.cumsum(valid.sum(axis=1))])
    return ptr.astype(np.int32), plan[valid].astype(np.int32)


def make_gather_plan(element_indices, num_particles: int, device) -> GatherPlan:
    idx_np = np.asarray(element_indices)
    plan = build_gather_plan(idx_np, num_particles)
    ptr, rows = plan_to_csr(plan, idx_np.size)
    return GatherPlan(
        idx=torch.as_tensor(plan, device=device),
        ptr=torch.as_tensor(ptr, device=device),
        rows=torch.as_tensor(rows, device=device),
    )


def gather_assemble(contrib: torch.Tensor, plan_idx: torch.Tensor) -> torch.Tensor:
    """Gather-based assembly ``(E, d+1, k) -> (N, k)`` through the padded
    plan (single tier, as the JAX package's ``gather_assemble``)."""
    k = contrib.shape[-1]
    flat = contrib.reshape(-1, k)
    flat = torch.cat([flat, flat.new_zeros((1, k))], dim=0)
    return flat[plan_idx].sum(dim=1)


def element_contrib_full(columns: torch.Tensor) -> torch.Tensor:
    """``(E, d, d)`` columns → ``(E, d+1, d)`` contributions: row 0 is
    ``−Σ_j columns[:, :, j]`` (local vertex 0), rows ``1..d`` the columns
    (reference: solver/explicit.py:42-49)."""
    cols = columns.transpose(-1, -2)  # [e, j] = column j
    v0 = cols[:, 0:1, :]
    for j in range(1, cols.shape[1]):
        v0 = v0 + cols[:, j : j + 1, :]
    return torch.cat([-v0, cols], dim=1)


def gather_edge_diffs(pos: torch.Tensor, element_indices: torch.Tensor) -> torch.Tensor:
    """``(E, d, d)`` edge matrices with ``X[e, :, j] = pos[v_{j+1}] − pos[v_0]``
    (reference: solver/explicit.py:12-16)."""
    p = pos[element_indices]  # (E, d+1, d)
    diffs = p[:, 1:, :] - p[:, 0:1, :]  # row j = p_{j+1} - p_0
    return diffs.transpose(-1, -2)  # columns = edges


class _GatherRows(torch.autograd.Function):
    """x[element_indices] (E, d+1, k), whose backward sums each particle's
    rows through the gather plan (:class:`_AssembleRows`) instead of the
    index backward's accumulation."""

    @staticmethod
    def forward(ctx, x, element_indices, plan_idx):
        ctx.element_indices, ctx.plan_idx = element_indices, plan_idx
        return x[element_indices.long()]

    @staticmethod
    def backward(ctx, g):
        return _AssembleRows.apply(g, ctx.plan_idx, ctx.element_indices), \
            None, None


class _AssembleRows(torch.autograd.Function):
    """:func:`gather_assemble` of (E, d+1, k) contributions, whose backward
    is the gather of each row's particle (:class:`_GatherRows`)."""

    @staticmethod
    def forward(ctx, contrib, plan_idx, element_indices):
        ctx.element_indices, ctx.plan_idx = element_indices, plan_idx
        return gather_assemble(contrib, plan_idx)

    @staticmethod
    def backward(ctx, g):
        return _GatherRows.apply(g, ctx.element_indices, ctx.plan_idx), \
            None, None


def gather_rows(x: torch.Tensor, element_indices: torch.Tensor,
                plan: GatherPlan) -> torch.Tensor:
    """``x[element_indices]`` (E, d+1, k), differentiable to any order with
    no float atomics: the transpose of this gather is the per-particle sum
    through ``plan`` (the plan of ``element_indices``) and the transpose of
    that sum is this gather, so that every gradient is summed in the plan's
    fixed order and two runs are bit-identical on every device."""
    return _GatherRows.apply(x, element_indices, plan.idx)


def assemble_rows(contrib: torch.Tensor, element_indices: torch.Tensor,
                  plan: GatherPlan) -> torch.Tensor:
    """:func:`gather_assemble` of (E, d+1, k) contributions through
    ``plan``, differentiable to any order as :func:`gather_rows` is."""
    return _AssembleRows.apply(contrib, plan.idx, element_indices)


def edge_diffs(x: torch.Tensor, element_indices: torch.Tensor,
               plan: GatherPlan) -> torch.Tensor:
    """:func:`gather_edge_diffs` through :func:`gather_rows`."""
    p = gather_rows(x, element_indices, plan)
    return (p[:, 1:, :] - p[:, 0:1, :]).transpose(-1, -2)


def build_jacobi_plan(element_indices, num_particles: int):
    """Block-sparse row structure of the implicit system for the serial
    Jacobi sweep (the JAX package's ``build_jacobi_plan``, copied).

    Element e (vertices v0, v1..vd) contributes its block K_e to 4·d (row,
    col) pairs of the assembled graph Laplacian (reference scatter,
    solver/implicit.py:151-181): (vi, vi, +), (vi, v0, −), (v0, vi, −),
    (v0, v0, +) for each local i.  Unique pairs become per-row neighbour
    slots in ascending column order.

    Returns (nb_ids (N, max_nb) int32 — the neighbour particle of each
    slot, −1 on padded slots; slot_ids (E, 4d) int32 — the flat index into
    (N·max_nb) of each contribution; coeff (E, 4d) float32 — ±1 each).
    Host-side numpy, once at load."""
    idx = np.asarray(element_indices, np.int64)
    e_cnt, dp1 = idx.shape
    d = dp1 - 1
    v0 = np.repeat(idx[:, 0:1], d, axis=1)  # (E, d)
    vi = idx[:, 1:]  # (E, d)
    rows = np.concatenate([vi, vi, v0, v0], axis=1)  # (E, 4d)
    cols = np.concatenate([vi, v0, vi, v0], axis=1)
    ones = np.ones((e_cnt, d), np.float32)
    coeff = np.concatenate([ones, -ones, -ones, ones], axis=1)
    pairs = rows * np.int64(num_particles) + cols
    uniq = np.unique(pairs)
    urows = uniq // num_particles
    counts = np.bincount(urows, minlength=num_particles)
    max_nb = int(counts.max()) if counts.size else 1
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(uniq.size) - starts[urows]
    nb_ids = np.full((num_particles, max_nb), -1, np.int64)
    nb_ids[urows, rank] = uniq % num_particles
    pos = np.searchsorted(uniq, pairs.reshape(-1))
    slot_ids = (urows[pos] * max_nb + rank[pos]).reshape(e_cnt, 4 * d)
    return nb_ids.astype(np.int32), slot_ids.astype(np.int32), coeff


def split_two_tier(plan, counts, min_saving: float = 0.25):
    """Split a padded ``(S, maxdeg)`` gather plan in two tiers when its
    degrees are skewed enough to pay for it (the JAX package's
    ``split_two_tier``, copied): ``lo`` ``(S, cap)`` at the cap that
    gathers the fewest rows, ``hi`` ``(S2, maxdeg − cap)`` the remaining
    rows of the ``out`` outliers.  ``hi`` and ``out`` are None, and ``lo``
    is ``plan``, when the split saves less than ``min_saving`` of the
    gathered rows."""
    plan = np.asarray(plan)
    counts = np.asarray(counts)
    n, maxdeg = plan.shape
    if n == 0 or maxdeg <= 1:
        return plan, None, None
    caps = np.arange(1, maxdeg + 1)
    n2_at = np.array([(counts > c).sum() for c in caps])
    cost = n * caps + n2_at * (maxdeg - caps)
    best = int(np.argmin(cost))
    cap = int(caps[best])
    if cap == maxdeg or cost[best] > (1.0 - min_saving) * n * maxdeg:
        return plan, None, None
    outliers = np.nonzero(counts > cap)[0].astype(np.int32)
    return plan[:, :cap], plan[outliers, cap:], outliers


@dataclasses.dataclass(frozen=True)
class TieredPlan:
    """A sentinel-padded gather plan in one or two tiers
    (:func:`split_two_tier`); the sentinel is the row count of the
    contributions it gathers."""

    lo: torch.Tensor  # (S, cap) int32
    hi: Optional[torch.Tensor] = None  # (S2, maxdeg − cap) int32
    out: Optional[torch.Tensor] = None  # (S2,) int64 segments of ``hi``


def make_jacobi_gather(slot_ids, num_slots: int, device) -> TieredPlan:
    """The inverse of ``slot_ids`` (E, 4d): for each of the ``num_slots``
    = N·max_nb slots, its contribution ids ``e·4d + l`` in ascending order,
    split in two tiers.  Host-side numpy, once at load."""
    slots = np.asarray(slot_ids)
    plan = build_gather_plan(slots, num_slots)
    counts = np.bincount(slots.reshape(-1), minlength=num_slots)
    lo, hi, out = split_two_tier(plan, counts)
    return TieredPlan(
        lo=torch.as_tensor(np.ascontiguousarray(lo), device=device),
        hi=None if hi is None else torch.as_tensor(hi, device=device),
        out=None if out is None else torch.as_tensor(
            out.astype(np.int64), device=device),
    )


def gather_tiered(contrib: torch.Tensor, plan: TieredPlan) -> torch.Tensor:
    """``(R, k) -> (S, k)``: each segment's sum of its contribution rows
    through ``plan``, in the plan's order (a zero row appended as the
    sentinel; the outliers' high tier added on top, each segment once, by
    a gather and a placement: no atomics)."""
    flat = torch.cat([contrib, contrib.new_zeros((1, contrib.shape[-1]))])
    out = flat[plan.lo].sum(dim=1)
    if plan.hi is not None:
        out[plan.out] = out[plan.out] + flat[plan.hi].sum(dim=1)
    return out


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (a ``ProcessGroup``;
    None: ``x`` unchanged, the single-device path): one
    ``torch.distributed.all_reduce`` in place on a contiguous ``x``, on
    ``x``'s own device, counted in ``all_reduce_sum.calls``.  Every rank
    gets the same bits, so loops that stop on a value read from a reduced
    tensor stop at the same iteration on every rank."""
    if group is None:
        return x
    import torch.distributed as dist

    x = x.contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    all_reduce_sum.calls += 1
    return x


all_reduce_sum.calls = 0


def all_gather_rows(local: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``local`` row blocks (R, ...) concatenated in rank order
    (world·R, ...) on every rank of ``group``: one all-gather into one
    tensor (the JAX package's tiled ``jax.lax.all_gather``)."""
    import torch.distributed as dist

    local = local.contiguous()
    world = dist.get_world_size(group)
    out = local.new_empty((world * local.shape[0],) + tuple(local.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, local, group=group)
    return out


# id(element_indices) → (element_indices, N, its GatherPlan); the tensor is
# held so that its id is not reused while the plan is kept.
_PLANS: dict = {}


def element_gather_plan(element_indices: torch.Tensor, num_particles: int
                        ) -> GatherPlan:
    """The :class:`GatherPlan` of ``element_indices`` over ``num_particles``
    particles, built once a table (host numpy) and kept with it."""
    hit = _PLANS.get(id(element_indices))
    if hit is None or hit[0] is not element_indices or hit[1] != num_particles:
        if len(_PLANS) >= 64:
            _PLANS.pop(next(iter(_PLANS)))
        plan = make_gather_plan(element_indices.cpu().numpy(), num_particles,
                                element_indices.device)
        hit = _PLANS[id(element_indices)] = (element_indices, num_particles,
                                             plan)
    return hit[2]


def segment_assemble(contrib: torch.Tensor, element_indices: torch.Tensor,
                     num_particles: int, group=None,
                     plan: Optional[GatherPlan] = None) -> torch.Tensor:
    """Per-element per-vertex rows ``(E, d+1, k)`` summed onto their
    particles, ``(N, k)`` (the JAX package's ``segment_assemble``): a
    gather through the plan of ``element_indices`` (``plan``, or the one
    built once for the table, :func:`element_gather_plan`), each particle's
    rows in ascending order, no atomics; then, with ``group``, the sum
    over its ranks (:func:`all_reduce_sum`), whose element rows are each a
    slice of the mesh, so that every rank holds the whole assembly."""
    if plan is None:
        plan = element_gather_plan(element_indices, num_particles)
    return all_reduce_sum(gather_assemble(contrib, plan.idx), group)
