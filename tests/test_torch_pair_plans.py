# coding=utf-8
"""P1's launch plan and binding on the CPU (``probes/pairblock.py``).

``pair_plan`` at the flagship's shapes (Eb 256, Pb 128, 3D: 2 CTAs a block
of 64 / 128 / 256 threads at pairs 1 / 2 / 4), at ``default.json``'s (2D,
one block), at block sizes that take rounds or fewer CTAs, its refusals,
and its constants against the kernel source's. The rule by which the kernel
stores a contribution row into its slot's owner — row 0 under
``minus[e·d]``, row j+1 under ``plus[e·d+j]`` — reproduces
``local_ptr``/``local_rows`` exactly on the flagship's and
``default.json``'s blockings, and a numpy emulation of the kernel (rows
stored at their row ids into their owner's receive rows, each owner summing
its slots through the plan) matches the plain version to 1e-5 of its
largest entry (float32, no fused multiply-adds) at every pair. The wrapper
is checked with a fake library on the meta device: the library loaded once,
a blocking's tables built once and again when it is replaced or changed in
place, launches counted, a failed launch raising. No kernel runs here."""

import dataclasses
import os
import re
import types

import numpy as np
import pytest
import torch

from fem_tpu_torch import entry
from fem_tpu_torch.probes import pairblock as p1
from fem_tpu_torch.utils import cuda_build

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def flagship():
    """configs/demo_spot.json's body on the CPU (17 blocks), deformed."""
    _, obj, state, _ = entry.flagship("cpu")
    assert obj.blocking.num_blocks == 17
    return obj, entry.deformed(state)


@pytest.fixture(scope="module")
def square():
    """configs/default.json's body on the CPU (2D, one block)."""
    _, obj, state, _ = entry.load_config(
        os.path.join(os.path.dirname(entry.FLAGSHIP_CONFIG), "default.json"),
        "cpu")
    assert obj.blocking.num_blocks == 1 and obj.dim == 2
    return obj, state


@pytest.mark.parametrize("pair, blocks, ctas", [(1, 17, 34), (2, 18, 18),
                                                (4, 20, 10)])
def test_pair_plan_at_the_flagship(flagship, pair, blocks, ctas):
    blk = flagship[0].blocking
    assert (blk.eb, blk.pb) == (256, 128)
    plan = p1.pair_plan(blk.eb, blk.pb, 3, pair)
    # Per group: 1,024 rows of 4 floats, x (128 × 3), 1,024 plan rows.
    assert plan == (64, 2, 64 * pair, 4 * pair * (1024 * 4 + 384 + 1024))
    assert p1.pad_blocking(blk, pair).num_blocks == blocks
    assert plan.ctas * blocks // pair == ctas


@pytest.mark.parametrize("pair", p1.PAIRS)
def test_pair_plan_at_default_json(square, pair):
    blk = square[0].blocking
    plan = p1.pair_plan(blk.eb, blk.pb, 2, pair)
    # Per group: 768 rows of 2 floats, x (128 × 2), 768 plan rows.
    assert plan == (64, 2, 64 * pair, 4 * pair * (768 * 2 + 256 + 768))
    # One cluster of 2 CTAs: the block and its padding.
    assert plan.ctas * p1.pad_blocking(blk, pair).num_blocks // pair == 2


@pytest.mark.parametrize("eb, ctas, rounds", [(1, 1, 1), (64, 1, 1),
                                              (65, 2, 1), (128, 2, 1),
                                              (256, 2, 2), (300, 2, 3),
                                              (700, 2, 6)])
def test_pair_plan_tiles_and_rounds(eb, ctas, rounds):
    plan = p1.pair_plan(eb, 40, 3, 1)
    assert (plan.tile, plan.ctas, plan.threads) == (64, ctas, 64)
    assert -(-eb // (plan.ctas * plan.tile)) == rounds
    # 16-byte multiples: each group's share starts 16-byte aligned.
    assert plan.smem % 16 == 0


@pytest.mark.parametrize("args, match", [
    ((256, 128, 4, 1), "dim"), ((256, 128, 1, 1), "dim"),
    ((256, 128, 3, 3), "pair"), ((256, 128, 3, 8), "pair"),
    ((0, 128, 3, 1), "blocks of"), ((256, 0, 3, 1), "blocks of"),
    ((1024, 128, 3, 4), "shared memory"), ((2048, 128, 2, 4), "shared memory"),
])
def test_pair_plan_refusals(args, match):
    with pytest.raises(ValueError, match=match):
        p1.pair_plan(*args)


def test_pair_plan_constants_are_the_kernels():
    with open(os.path.join(cuda_build.CSRC, "probe_pairblock.cu")) as fh:
        src = fh.read()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert constant("kTile") == p1.PAIR_TILE
    assert constant("kMaxCtas") == p1.PAIR_MAX_CTAS


def _row_slots(blk, b):
    """The local slot of each real contribution row e·(d+1)+v of block b by
    the kernel's rule: v = 0 under minus[e·d], v = j+1 under plus[e·d+j]."""
    d = blk.dim
    nel = int(blk.block_elements[b])
    plus = blk.plus[b].numpy().reshape(-1, d)[:nel]
    minus = blk.minus[b].numpy().reshape(-1, d)[:nel, :1]
    return np.concatenate([minus, plus], axis=1).reshape(-1)


@pytest.mark.parametrize("body", ["flagship", "square"])
def test_row_slot_rule_reproduces_the_local_plan(request, body):
    blk = request.getfixturevalue(body)[0].blocking
    for b in range(blk.num_blocks):
        slots = _row_slots(blk, b)
        order = np.argsort(slots, kind="stable")
        assert np.array_equal(blk.local_rows[b, : order.size].numpy(), order)
        assert np.array_equal(
            blk.local_ptr[b].numpy(),
            np.concatenate([[0], np.cumsum(np.bincount(slots,
                                                       minlength=blk.pb))]))


def _emulate(blk, kplane, xbt, dim, pair):
    """The kernel in numpy float32: every block's rows computed in its
    order of operations, stored at their row ids into the receive rows of
    their slot's owner (rank p // ⌈Pb / C⌉ of the block's C CTAs; a row
    never stored reads NaN), and each owner's slots summed through the
    local plan in its order."""
    plan = p1.pair_plan(blk.eb, blk.pb, dim, pair)
    c, eb, pb, r = plan.ctas, blk.eb, blk.pb, dim + 1
    spr = -(-pb // c)
    kp = kplane.numpy().reshape(blk.num_blocks, dim, dim, eb, dim)
    x = xbt.numpy()
    out = np.zeros((blk.num_blocks, dim, pb), np.float32)
    for b in range(blk.num_blocks):
        nel = int(blk.block_elements[b])
        slots = _row_slots(blk, b).reshape(nel, r)
        xs = x[b].T
        dv = xs[slots[:, 1:]] - xs[slots[:, :1]]  # (nel, j, c)
        k = kp[b, :, :, :nel, :]  # (i, c, e, j)
        rows = np.zeros((nel, r, dim), np.float32)
        for j in range(dim):
            for i in range(dim):
                ti = k[i, 0, :, j] * dv[:, j, 0]
                for cc in range(1, dim):
                    ti = ti + k[i, cc, :, j] * dv[:, j, cc]
                rows[:, j + 1, i] = ti
        rows[:, 0] = -rows[:, 1]
        for j in range(2, dim + 1):
            rows[:, 0] = rows[:, 0] - rows[:, j]
        recv = np.full((c, eb * r, dim), np.nan, np.float32)
        ids = np.arange(nel * r).reshape(nel, r)
        recv[slots // spr, ids] = rows
        ptr, lrows = blk.local_ptr[b].numpy(), blk.local_rows[b].numpy()
        for rank in range(c):
            for p in range(min(pb, rank * spr), min(pb, rank * spr + spr)):
                acc = np.zeros(dim, np.float32)
                for q in range(ptr[p], ptr[p + 1]):
                    acc = acc + recv[rank, lrows[q]]
                out[b, :, p] = acc
    return out


@pytest.mark.parametrize("pair", p1.PAIRS)
@pytest.mark.parametrize("body", ["flagship", "square"])
def test_emulated_kernel_matches_plain(request, body, pair):
    obj, state = request.getfixturevalue(body)
    d = obj.dim
    rng = np.random.default_rng(5 + pair)
    blk = obj.blocking
    K = torch.as_tensor(rng.normal(size=(blk.num_blocks * blk.eb, d, d))
                        .astype(np.float32))
    kp = p1.make_kplane(blk, K)
    x = state.pos + torch.as_tensor(
        rng.normal(scale=0.3, size=tuple(state.pos.shape)).astype(np.float32))
    blk_p, kp_p, xbt = p1.padded_inputs(blk, kp, x, pair)
    ref = p1.paired_matvec_plain(blk_p, kp_p, xbt, d, pair).numpy()
    got = _emulate(blk_p, kp_p, xbt, d, pair)
    assert not np.isnan(got).any()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    assert not got[blk.num_blocks:].any()


class _Entry:
    def __init__(self, rc=0):
        self.calls = []
        self.rc = rc
        self.argtypes = None

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


class _FakeLibrary:
    def __init__(self):
        self.fem_paired_matvec = _Entry()
        self.fem_paired_matvec_last_launch = _Entry()
        self.fem_paired_matvec_error = lambda rc: b"fake error"


def _meta(blk):
    """``blk`` with every tensor on the meta device (shapes only; data
    pointers 0)."""
    meta = torch.device("meta")
    fields = {f.name: getattr(blk, f.name).to(meta)
              for f in dataclasses.fields(blk)
              if isinstance(getattr(blk, f.name), torch.Tensor)}
    plan = blk.slot_plan
    fields["slot_plan"] = dataclasses.replace(plan, **{
        f.name: getattr(plan, f.name).to(meta)
        for f in dataclasses.fields(plan)})
    return dataclasses.replace(blk, **fields)


def test_wrapper_binds_the_library_and_each_blocking_once(flagship,
                                                          monkeypatch):
    """One library, loaded at the first launch with its entries' argument
    types; a blocking's C tables built at its first launch, passed by the
    same reference every launch, built again when a table the kernel reads
    changes in place or the blocking is replaced; the pair and the
    operands' pointers passed, the current stream last; launches counted
    by pair and the plan kept; a failed launch raises and counts
    nothing."""
    loads, builds = [], []

    def fake_load(name, material=None):
        loads.append((name, material))
        return _FakeLibrary()

    real_tables = p1.block_tables

    def counting_tables(blk):
        builds.append(blk)
        return real_tables(blk)

    monkeypatch.setattr(cuda_build, "load", fake_load)
    monkeypatch.setattr(p1, "_LIB", None)
    monkeypatch.setattr(p1, "_TABLES", {})
    monkeypatch.setattr(p1, "block_tables", counting_tables)
    # The device checks and the stream need a card: stand-ins on the meta
    # device, whose index (None) is the current device's.
    monkeypatch.setattr(p1, "_check_device", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                        types.SimpleNamespace(cuda_stream=7))
    fn = p1.paired_matvec
    monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(fn, "instance_launches", {})
    monkeypatch.setattr(fn, "last_plan", None)

    obj, state = flagship
    blk = _meta(p1.pad_blocking(obj.blocking, 2))
    b, eb, pb = blk.num_blocks, blk.eb, blk.pb
    kp = torch.empty((b, 9, eb * 3), device="meta")
    xbt = torch.empty((b, 3, pb), device="meta")
    for pair in (1, 2, 2):
        out = p1.paired_matvec(blk, kp, xbt, 3, pair)
        assert out.shape == (b, 3, pb) and out.device.type == "meta"
    assert loads == [("probe_pairblock", None)] and len(builds) == 1
    lib = p1._library()
    assert lib.fem_paired_matvec.argtypes is not None
    calls = lib.fem_paired_matvec.calls
    assert [c[1] for c in calls] == [1, 2, 2]
    assert all(c[0] is calls[0][0] and c[-1] == 7 for c in calls)
    assert fn.launches == 3 and fn.instance_launches == {(1,): 1, (2,): 2}
    assert fn.last_plan == p1.pair_plan(eb, pb, 3, 2)

    blk.local_rows.add_(0)  # changed in place: its tables are built again
    p1.paired_matvec(blk, kp, xbt, 3, 1)
    assert len(builds) == 2 and calls[-1][0] is not calls[0][0]
    p1.paired_matvec(blk, kp, xbt, 3, 1)
    assert len(builds) == 2 and calls[-1][0] is calls[-2][0]
    other = dataclasses.replace(blk)  # replaced: another blocking
    p1.paired_matvec(other, kp, xbt, 3, 1)
    assert len(builds) == 3 and builds[-1] is other

    with pytest.raises(ValueError, match="dim 2"):
        p1.paired_matvec(blk, kp, xbt, 2, 1)
    with pytest.raises(ValueError, match="xbt has shape"):
        p1.paired_matvec(blk, kp, xbt[:, :, :-1], 3, 1)
    lib.fem_paired_matvec.rc = 1
    with pytest.raises(RuntimeError, match="launch failed: fake error"):
        p1.paired_matvec(blk, kp, xbt, 3, 1)
    assert fn.launches == 6 and len(loads) == 1
