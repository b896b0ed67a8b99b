# coding=utf-8
"""P2's tiling (``probes/int8.chained_dot_plan``), emulated in PyTorch on the
CPU as ``csrc/probe_int8.cu`` computes it: the reps stacked along M into
tiles of 64 accumulator rows through the rotation's row map
(``tile_source_rows``), the tiles split over cluster groups, w's rows (K)
split over a cluster's ranks and over each CTA's two warpgroups, every
tile of a warpgroup summed into one accumulator, then the fixed-order
epilogue: warpgroup 0 + warpgroup 1 and accumulator rows j ≡ i (mod rows)
in ascending j, the ranks in rank order, the groups in group order.

Held to ``chained_dot_plain``: exactly for int8 × int8 (the emulation sums
in int64), and to 1e-6 of the largest entry for the bf16 variants (the
emulation sums the exact products in float64, the plain version in f32 and
in another order), at shapes whose rows do not divide 64, whose reps do not
fill a tile, and at forced slice widths and clusters.
Also the issued-MAC formula, counted wgmma by wgmma, and the plan's
choices and refusals."""

import pytest
import torch

from fem_tpu_torch.probes import int8 as p2

torch.set_num_threads(1)


def _emulate(a, w, reps, variant, plan):
    """The kernel's sums, and the MACs its wgmmas issue."""
    exact = variant == "int8xint8"
    work = torch.int64 if exact else torch.float64
    rows, n = a.shape
    cols = w.shape[1]
    af = torch.cat([a.to(work), torch.zeros((1, n), dtype=work)])  # zero row
    wf = w.to(work)
    k_step = 32 if exact else 16
    out, macs = None, 0
    for g in range(plan.groups):
        ranks = []
        for q in range(plan.cluster):
            k_rows = p2.rank_rows(plan, n, q)
            half = (len(k_rows) // k_step) // 2 * k_step
            halves = (k_rows[:half], k_rows[half:])
            acc = [torch.zeros((p2.TILE_M, cols), dtype=work) for _ in halves]
            for tile in p2.group_tiles(plan, g):
                src = torch.as_tensor(p2.tile_source_rows(
                    rows, reps, plan.per_tile, tile))
                a_t = af[torch.where(src < 0, rows, src)]
                for wg, ks in enumerate(halves):
                    ks = list(ks)
                    acc[wg] += a_t[:, ks] @ wf[ks]
                    macs += p2.TILE_M * len(ks) * cols
            part = torch.zeros((rows, cols), dtype=work)
            for i in range(rows):
                for j in range(i, plan.per_tile, rows):
                    part[i] = part[i] + (acc[0][j] + acc[1][j])
            ranks.append(part)
        total = ranks[0]
        for part in ranks[1:]:
            total = total + part
        out = total if out is None else out + total
    return (out.to(torch.int32) if exact else out), macs


SHAPES = [
    (6, 1024, 512, 200),   # the probe's rows, n and reps; 20 tiles
    (7, 128, 64, 3),       # rows not dividing 64, one partial tile
    (64, 256, 128, 5),     # a tile of one rep
    (1, 64, 192, 11),      # one row, one 64-row chunk of w
    (33, 192, 64, 4),      # H = 33, uneven K ranks
    (5, 320, 768, 9),      # n of 5 chunks over 4 ranks
    (6, 128, 64, 0),       # no reps
]


@pytest.mark.parametrize("variant", p2.VARIANTS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_tiling_matches_the_plain_version(shape, variant):
    rows, n, cols, reps = shape
    a, w = p2.probe_inputs(rows, n, cols, variant)
    plan = p2.chained_dot_plan(rows, n, cols, reps, variant)
    got, macs = _emulate(a, w, reps, variant, plan)
    ref = p2.chained_dot_plain(a, w, reps, variant)
    if variant == "int8xint8":
        assert torch.equal(got, ref)
    else:
        top = float(ref.abs().max()) if reps else 0.0
        assert float((got - ref.double()).abs().max()) <= 1e-6 * top
    assert macs == plan.macs >= reps * rows * n * cols


@pytest.mark.parametrize("width,cluster", [(64, 1), (64, 3), (256, 8),
                                           (256, 16)])
def test_forced_tilings_match_the_plain_version(width, cluster):
    a, w = p2.probe_inputs(6, 1024, 512, "int8xint8")
    plan = p2.chained_dot_plan(6, 1024, 512, 200, "int8xint8",
                               cluster=cluster, width=width)
    assert (plan.width, plan.cluster) == (width, cluster)
    got, macs = _emulate(a, w, 200, "int8xint8", plan)
    assert torch.equal(got, p2.chained_dot_plain(a, w, 200, "int8xint8"))
    assert macs == plan.macs


def test_row_map_is_the_stacked_rotations():
    """Accumulator row j of tile t reads stacked row t·H + j of the reps'
    rotations, roll(a, r) for r = 0, 1, ... stacked; rows j ≥ H and past
    the last rep are zero (−1)."""
    rows, reps = 7, 23
    a = torch.arange(rows * 4, dtype=torch.float32).reshape(rows, 4)
    stacked = torch.cat([torch.roll(a, r, dims=0) for r in range(reps)])
    plan = p2.chained_dot_plan(rows, 64, 64, reps, "bf16xbf16")
    assert plan.per_tile == 63 and plan.tiles == 3
    seen = 0
    for tile in range(plan.tiles):
        src = p2.tile_source_rows(rows, reps, plan.per_tile, tile)
        for j, s in enumerate(src.tolist()):
            g = tile * plan.per_tile + j
            if j >= plan.per_tile or g >= reps * rows:
                assert s == -1
            else:
                assert torch.equal(a[s], stacked[g])
                # Row j holds output row j mod rows in every tile.
                assert g % rows == j % rows
                seen += 1
    assert seen == reps * rows


def test_plan_choices_and_refusals():
    """The probe's defaults on the H100: 8 slices of 256 columns, clusters
    of 4 CTAs (w's 1,024 rows in 256-row quarters), 3 tile groups (30
    clusters of 4 at once); 20 tiles of 60 stacked rows, 94 % of the issued
    MACs real."""
    plan = p2.chained_dot_plan(6, 1024, 2048, 200, "bf16xbf16")
    assert plan[:6] == (60, 20, 256, 8, 4, 3)
    assert plan.macs == 20 * 64 * 1024 * 2048
    assert 200 * 6 * 1024 * 2048 / plan.macs == pytest.approx(0.9375)
    # The int8 x bf16 CTA: the int8 quarter as it arrives and widened.
    assert p2.chained_dot_plan(6, 1024, 2048, 200, "int8xbf16").smem == \
        p2.dot_smem("int8xbf16", 6, 1024, 256, 4)
    # n of 3,072: clusters of 4 take 768 rows a CTA, too many for its
    # shared memory; the plan takes larger clusters.
    assert p2.chained_dot_plan(5, 3072, 512, 13, "bf16xbf16").cluster == 8
    # cols not a multiple of 256: 64-wide slices.
    assert p2.chained_dot_plan(6, 1024, 192, 20, "int8xint8").width == 64
    assert p2.chained_dot_plan(6, 1024, 384, 20, "int8xint8").width == 64
    for args, kw in [((0, 64, 64, 1), {}), ((65, 64, 64, 1), {}),
                     ((6, 96, 64, 1), {}), ((6, 64, 96, 1), {}),
                     ((6, 64, 64, -1), {}), ((6, 128, 256, 1),
                                             dict(width=512)),
                     ((6, 128, 256, 1), dict(width=128)),
                     ((6, 128, 256, 1), dict(cluster=3)),
                     ((6, 4096, 256, 1), dict(cluster=1))]:
        with pytest.raises(ValueError):
            p2.chained_dot_plan(*args, "bf16xbf16", **kw)
    with pytest.raises(ValueError):
        p2.chained_dot_plan(6, 64, 64, 1, "fp8")
