# coding=utf-8
"""P2, the int8 table probe: ``reps`` chained dots Σ_r roll(a, r)·w of a
small value side with a ±1 table, as bf16×bf16→f32, int8×int8→int32 and
int8×bf16→f32.

``chained_dot`` launches the hand-written CUDA kernel
``fem_tpu_torch/csrc/probe_int8.cu`` (warpgroup ``wgmma`` on the reps
stacked along M, ``w`` staged by TMA, K split over a thread-block cluster;
:func:`chained_dot_plan` says how) for tensors on a CUDA device; it
replaces the Pallas kernel built in the JAX package's
``tools/probe_int8.py`` (``main``).  For tensors on the CPU it runs
``chained_dot_plain``: the same sum of products in float32 (the bf16
variants, whose products are exact in f32) or float64 (int8, whose sums are
exact there and cast to int32).  On CUDA it launches the kernel or raises.

Inputs: ``a`` (rows, n) — bf16, or int8 for ``"int8xint8"``; ``w`` (n,
cols) — bf16 for ``"bf16xbf16"``, int8 otherwise.  Output (rows, cols):
int32 for ``"int8xint8"`` (exact: |sum| ≤ 127·n·reps < 2³¹ at the
defaults), float32 otherwise.  Row i of roll(a, r) is a[(i − r) mod rows],
and every rep is one pass over all of w, so the chain does not fold.

Run on the card as ``python -m fem_tpu_torch.probes.int8 [--reps 200]
[--outer 30] [--n 1024] [--rows 6] [--cols 2048]``: the JAX probe's
arguments and lines — µs per dot of each variant (best of ``--outer``
launches of ``--reps`` chained dots, CUDA events) and the int8 speed-up
verdict — plus one PyTorch call's time for the same products.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import sys
from typing import NamedTuple

import numpy as np
import torch

from fem_tpu_torch.ops.element_kernels import count_launch
from fem_tpu_torch.utils import cuda_build

_P = ctypes.c_void_p
VARIANTS = ("bf16xbf16", "int8xint8", "int8xbf16")
# (a dtype, w dtype, output dtype) of each variant.
DTYPES = {
    "bf16xbf16": (torch.bfloat16, torch.bfloat16, torch.float32),
    "int8xint8": (torch.int8, torch.int8, torch.int32),
    "int8xbf16": (torch.bfloat16, torch.int8, torch.float32),
}


# The kernel's tiling (csrc/probe_int8.cu): a wgmma tile of 64 rows, w in
# chunks of 64 rows, slices of 256 or 64 columns of w (the wgmma's N),
# clusters of at most 16 CTAs splitting K (the plan starts at 4), and
# groups of tiles over clusters, as many as the device runs in one wave.
TILE_M = 64
CHUNK = 64
WIDTHS = (256, 64)
MAX_CLUSTER = 16
PLAN_CLUSTER = 4


def h100_clusters(width: int, cluster: int, smem: int) -> int:
    """Clusters of ``cluster`` CTAs the H100 runs at once, for planning
    without a card (one CTA an SM, 120 of its 132 SMs taken as usable by
    clusters); the wrapper asks the device."""
    return 120 // cluster
# The H100's shared memory a CTA (232,448 B) less the kernel's static 4 B,
# rounded down to 16.
H100_SMEM = 232432


class DotPlan(NamedTuple):
    """P2's launch (csrc/probe_int8.cu): ``per_tile`` stacked rows a tile
    (whole reps, H = rows·⌊64/rows⌋), ``tiles`` tiles in all, ``width``
    columns of w a slice (the wgmma's N), ``slices`` slices, ``cluster``
    CTAs a cluster (rank q takes w's 64-row chunks [q·NC/C, (q+1)·NC/C)),
    ``groups`` clusters a slice (group g takes the tiles [g·T/G,
    (g+1)·T/G)), ``smem`` bytes of dynamic shared memory a CTA and the
    ``macs`` the launch issues on the tensor cores (tiles·64·n·cols)."""

    per_tile: int
    tiles: int
    width: int
    slices: int
    cluster: int
    groups: int
    smem: int
    macs: int


def dot_smem(variant: str, rows: int, n: int, width: int, cluster: int) -> int:
    """Bytes of dynamic shared memory of a CTA (csrc/probe_int8.cu:
    layout): its chunks of w as the wgmma reads them, the int8 chunks as TMA
    brings them (int8 variants), its columns of a's rows and a zero row (32
    bytes of padding each), or the two warpgroups' staged accumulators if
    larger; the mbarrier, the partial sums and 1,024 bytes of alignment
    slack."""
    kc = -(-(n // CHUNK) // cluster) * CHUNK
    wide = 1 if variant == "int8xint8" else 2
    size_a = DTYPES[variant][0].itemsize
    mma = kc * width * wide + (0 if variant == "bf16xbf16" else kc * width) + (
        rows + 1) * (kc * size_a + 32)
    main = -(-max(mma, 2 * TILE_M * (width + 8) * 4) // 16) * 16
    return 1024 + main + 16 + rows * width * 4


def chained_dot_plan(rows: int, n: int, cols: int, reps: int, variant: str,
                     active=h100_clusters,
                     cluster: int = 0, width: int = 0,
                     smem_limit: int = H100_SMEM) -> DotPlan:
    """The kernel's tiling of Σ_{r<reps} roll(a, r)·w: stacked row
    G = r·rows + i is a[(i − r) mod rows]; a tile takes H = rows·⌊64/rows⌋
    of them, so accumulator row j always holds output row j mod rows and
    every tile of a CTA accumulates into the same registers.  Each
    ``width``-column slice of w takes ``groups`` clusters of ``cluster``
    CTAs; a cluster splits K, the groups split the tiles.  By default the
    widest slice dividing cols, the smallest cluster from 4 (or n/64) up
    whose CTA fits ``smem_limit``, and as many groups, up to the tiles, as
    keep every cluster in one wave: ``active(width, cluster, smem)`` such
    clusters at once (the device's count; at the defaults on the H100 8
    slices of 256 columns, groups of 4 CTAs).  Shapes the kernel does
    not take raise ``ValueError``: rows 1..64, n and cols multiples of 64,
    reps ≥ 0, and a forced width or cluster whose CTA does not fit."""
    if variant not in DTYPES:
        raise ValueError(f"unknown variant {variant!r}: one of {VARIANTS}")
    if not (1 <= rows <= TILE_M and n > 0 and n % CHUNK == 0 and cols > 0
            and cols % 64 == 0 and reps >= 0):
        raise ValueError(
            f"the chained-dot kernel takes rows 1..{TILE_M}, n and cols "
            f"multiples of 64 and reps >= 0, not rows {rows}, n {n}, cols "
            f"{cols}, reps {reps}")
    per_tile = rows * (TILE_M // rows)
    tiles = -(-reps * rows // per_tile)
    chunks = n // CHUNK
    most = min(MAX_CLUSTER, chunks)
    if width and (width not in WIDTHS or cols % width):
        raise ValueError(f"width {width} is not one of {WIDTHS} dividing "
                         f"cols {cols}")
    if cluster and not 1 <= cluster <= most:
        raise ValueError(f"cluster {cluster} outside 1..{most}")
    choices = [(wd, c) for wd in ([width] if width else
                                  [w for w in WIDTHS if cols % w == 0])
               for c in ([cluster] if cluster else
                         range(min(PLAN_CLUSTER, chunks), most + 1))]
    fit = [(wd, c) for wd, c in choices
           if dot_smem(variant, rows, n, wd, c) <= smem_limit]
    if not fit:
        raise ValueError(f"no CTA of the chained-dot kernel fits "
                         f"{smem_limit} B of shared memory at n {n}")
    wd, c = fit[0]
    slices = cols // wd
    smem = dot_smem(variant, rows, n, wd, c)
    groups = max(1, min(tiles, active(wd, c, smem) // slices))
    return DotPlan(per_tile, tiles, wd, slices, c, groups, smem,
                   tiles * TILE_M * n * cols)


def tile_source_rows(rows: int, reps: int, per_tile: int, tile: int):
    """Row of ``a`` that each of the 64 accumulator rows of ``tile`` reads
    (the kernel's row map), −1 for a zero row: rows j ≥ H and stacked rows
    past the last rep."""
    src = np.full(TILE_M, -1, np.int64)
    j = np.arange(min(per_tile, TILE_M))
    g = tile * per_tile + j
    real = g < reps * rows
    src[j[real]] = (j[real] % rows - g[real] // rows) % rows
    return src


def rank_rows(plan: DotPlan, n: int, rank: int) -> range:
    """The rows of w (the K range) of cluster rank ``rank``: its 64-row
    chunks [q·NC/C, (q+1)·NC/C)."""
    chunks = n // CHUNK
    return range(rank * chunks // plan.cluster * CHUNK,
                 (rank + 1) * chunks // plan.cluster * CHUNK)


def group_tiles(plan: DotPlan, group: int) -> range:
    """The tiles of tile group ``group``: [g·T/G, (g+1)·T/G)."""
    return range(group * plan.tiles // plan.groups,
                 (group + 1) * plan.tiles // plan.groups)


def probe_inputs(rows: int, n: int, cols: int, variant: str, device="cpu",
                 seed: int = 0):
    """(a, w) of the JAX probe (numpy seed 0): w uniform in {−1, 0, 1},
    a standard normal — int8 as clip(100·a) for ``"int8xint8"``."""
    rng = np.random.default_rng(seed)
    table = rng.integers(-1, 2, size=(n, cols)).astype(np.int8)
    val = rng.standard_normal((rows, n)).astype(np.float32)
    a_t, w_t, _ = DTYPES[variant]
    if a_t == torch.int8:
        a = torch.as_tensor(np.clip(val * 100, -127, 127).astype(np.int8))
    else:
        a = torch.as_tensor(val).to(a_t)
    w = torch.as_tensor(table)
    if w_t != torch.int8:
        w = w.to(w_t)
    return a.to(device), w.to(device)


def _check(a, w, variant):
    if variant not in DTYPES:
        raise ValueError(f"unknown variant {variant!r}: one of {VARIANTS}")
    a_t, w_t, _ = DTYPES[variant]
    if a.dtype != a_t or w.dtype != w_t:
        raise TypeError(f"{variant} takes a {a_t} and w {w_t}, not "
                        f"{a.dtype} and {w.dtype}")
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} and {tuple(w.shape)}")


def chained_dot_plain(a, w, reps: int, variant: str):
    """Plain PyTorch version of :func:`chained_dot`."""
    _check(a, w, variant)
    exact = variant == "int8xint8"
    work = torch.float64 if exact else torch.float32
    wf = w.to(work)
    acc = torch.zeros((a.shape[0], w.shape[1]), dtype=work, device=a.device)
    af = a.to(work)
    for r in range(reps):
        acc = acc + torch.matmul(torch.roll(af, r, dims=0), wf)
    return acc.to(torch.int32) if exact else acc


def _library():
    lib = cuda_build.load("probe_int8")
    if lib.fem_chained_dot.argtypes is None:
        lib.fem_chained_dot.argtypes = [
            ctypes.c_int, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P,
            _P,
        ]
        lib.fem_chained_dot.restype = ctypes.c_int
        lib.fem_chained_dot_smem.argtypes = [ctypes.c_int] * 5
        lib.fem_chained_dot_smem.restype = ctypes.c_int
        lib.fem_chained_dot_active_clusters.argtypes = [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.fem_chained_dot_active_clusters.restype = ctypes.c_int
        lib.fem_chained_dot_error.argtypes = [ctypes.c_int]
        lib.fem_chained_dot_error.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=64)
def _active_clusters(device_index: int, variant: str, width: int,
                     cluster: int, smem: int) -> int:
    """How many clusters of ``cluster`` CTAs of ``smem`` bytes at slice
    width ``width`` the device runs at once (once per shape)."""
    lib = _library()
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = lib.fem_chained_dot_active_clusters(
            VARIANTS.index(variant), width, cluster, smem, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError("chained-dot kernel: the occupancy query failed: "
                           f"{lib.fem_chained_dot_error(rc).decode()}")
    return out.value


@functools.lru_cache(maxsize=64)
def _check_smem(variant: str, rows: int, n: int, width: int,
                cluster: int) -> None:
    """Raise unless the plan's shared memory is the kernel's (once per
    shape)."""
    want = _library().fem_chained_dot_smem(VARIANTS.index(variant), rows, n,
                                           width, cluster)
    mine = dot_smem(variant, rows, n, width, cluster)
    if want != mine:
        raise RuntimeError(f"chained-dot kernel: the plan's {mine} B of "
                           f"shared memory differ from the kernel's {want}")




def chained_dot(a: torch.Tensor, w: torch.Tensor, reps: int,
                variant: str) -> torch.Tensor:
    """Σ_{r < reps} roll(a, r, rows) @ w.  CUDA tensors: one launch of the
    probe kernel's ``variant``, tiled as :func:`chained_dot_plan` says;
    rows must be 1..64, n and cols multiples of 64, and a CTA's staging
    (:func:`dot_smem`) fit the device's shared memory — else
    ``ValueError`` or, from the kernel, ``RuntimeError``.  The plan is left
    in ``chained_dot.last_plan``, the MACs the kernel issued in
    ``chained_dot.last_macs`` (a (1,) int64 tensor on the device).  CPU
    tensors: :func:`chained_dot_plain`."""
    if a.device.type == "cpu":
        return chained_dot_plain(a, w, reps, variant)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    _check(a, w, variant)
    rows, n = a.shape
    cols = w.shape[1]
    for name, t in (("a", a), ("w", w)):
        cuda_build.check_operand(name, t, tuple(t.shape), t.dtype, a.device)
    index = a.device.index if a.device.index is not None else (
        torch.cuda.current_device())
    plan = chained_dot_plan(
        rows, n, cols, int(reps), variant,
        functools.partial(_active_clusters, index, variant))
    _check_smem(variant, rows, n, plan.width, plan.cluster)
    out_t = DTYPES[variant][2]
    out = torch.empty((rows, cols), dtype=out_t, device=a.device)
    scratch = torch.empty(
        (plan.slices * plan.groups * rows * plan.width
         if plan.groups > 1 else 1,), dtype=out_t, device=a.device)
    # The MAC counter, then the groups' int32 tickets (zeroed by the launch).
    macs = torch.empty((1 + -(-plan.slices * plan.cluster // 2),),
                       dtype=torch.int64, device=a.device)
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.fem_chained_dot(VARIANTS.index(variant), a.data_ptr(),
                                 w.data_ptr(), rows, n, cols, int(reps),
                                 plan.width, plan.cluster, plan.groups,
                                 out.data_ptr(), scratch.data_ptr(),
                                 macs.data_ptr(), stream)
    if rc != 0:
        msg = lib.fem_chained_dot_error(rc).decode()
        raise RuntimeError(f"chained-dot kernel launch failed ({variant}, "
                           f"{rows}x{n}x{cols}, {plan.cluster} CTAs a "
                           f"slice, {plan.smem} B of shared memory): {msg}")
    count_launch(chained_dot, variant)
    chained_dot.last_plan = plan
    chained_dot.last_macs = macs[:1]
    return out


chained_dot.launches = 0
chained_dot.instance_launches = {}  # {(variant,): launches}
chained_dot.last_plan = None
chained_dot.last_macs = None


def stacked(a: torch.Tensor, reps: int) -> torch.Tensor:
    """The ``reps`` rotations of ``a`` stacked, (reps·rows, n), padded with
    zero rows to the least ``torch._int_mm`` takes (more than 16, a
    multiple of 8): the value side of one PyTorch product that computes
    every rep's dot."""
    rows = torch.cat([torch.roll(a, r, dims=0) for r in range(reps)])
    m = max(24, -(-rows.shape[0] // 8) * 8)
    pad = rows.new_zeros((m - rows.shape[0],) + tuple(rows.shape[1:]))
    return torch.cat([rows, pad]).contiguous()


def library_call(a_stack: torch.Tensor, w: torch.Tensor, variant: str):
    """One PyTorch call computing every rep's dot at once, from
    :func:`stacked`: ``torch._int_mm`` for int8 × int8, ``torch.matmul``
    in bf16 otherwise (``w`` already bf16: the int8 table widened
    beforehand)."""
    if variant == "int8xint8":
        return torch._int_mm(a_stack, w)
    return torch.matmul(a_stack, w)


def best_ms(fn, outer: int) -> float:
    """Best of ``outer`` timed calls of ``fn`` (CUDA events), in ms."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(outer):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop))
    return best


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=200,
                   help="dots chained inside ONE kernel launch")
    p.add_argument("--outer", type=int, default=30)
    p.add_argument("--n", type=int, default=1024, help="contract dim (N)")
    p.add_argument("--rows", type=int, default=6,
                   help="value-side rows (d·planes for d=3, 2-plane)")
    p.add_argument("--cols", type=int, default=2048,
                   help="table columns (B·Pb)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("int8: no CUDA device; the probe times the card",
              file=sys.stderr)
        return 1
    results = {}
    for name in VARIANTS:
        a, w = probe_inputs(args.rows, args.n, args.cols, name, "cuda")
        ms = best_ms(lambda: chained_dot(a, w, args.reps, name), args.outer)
        a_stack = stacked(a, args.reps)
        w_lib = w if name != "int8xbf16" else w.to(torch.bfloat16)
        lib = best_ms(lambda: library_call(a_stack, w_lib, name), args.outer)
        results[name] = ms / args.reps * 1e3
        print(f"{name}: {results[name]:.2f} us/dot (best-of-{args.outer}, "
              f"{args.reps} chained); one PyTorch call for all "
              f"{args.reps}: {lib / args.reps * 1e3:.2f} us/dot", flush=True)
    r = results["bf16xbf16"] / results["int8xint8"]
    print(f"int8xint8 speedup over bf16: {r:.2f}x "
          f"({'PROMISING — worth an exactness scheme' if r > 1.3 else 'NEGATIVE — weight stream not int8-bound at these shapes'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
