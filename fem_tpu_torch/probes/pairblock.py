# coding=utf-8
"""P1, the paired-block probe: the blocked operator's per-block product with
``pair`` locality blocks to a thread-block cluster.

``paired_matvec`` launches the hand-written CUDA kernel
``fem_tpu_torch/csrc/probe_pairblock.cu`` for tensors on a CUDA device; it
replaces the Pallas kernel of the JAX package's
``tools/probe_pairblock.py`` (``paired_matvec``), which runs K3's kernel
body for ``pair`` blocks per grid step.  On the card a block's elements
spread over a cluster of CTAs, one thread an element in tiles of 64, and
``pair`` blocks share each cluster, each CTA holding a tile of each
(:func:`pair_plan`).  For tensors on the CPU it runs
``paired_matvec_plain``: the block incidence matrices S_b built from the
plus/minus indices as dense ±1 tables and two batched products, the
definition the Pallas kernel computes.  On CUDA it launches the kernel or
raises; it never falls back.

Per block b: out_b = S_bᵀ·(K ∘ (S_b·x_b)) of shape (d, Pb), with no slot
sum; ``kplane`` (B, d², Eb·d) carries K_e on rows e·d..e·d+d−1
(:func:`make_kplane`), ``xbt`` (B, d, Pb) the block-local vectors
(:func:`blocked_gather_planar`); the block count must divide by ``pair``
(``ops/blocking.pad_blocking`` pads it).

Run on the card as ``python -m fem_tpu_torch.probes.pairblock [--spacing
0.04] [--iters 200] [--config PATH]``: it meshes ``assets/spot.obj`` as the
JAX probe does (68,508 tets and 270 blocks at 0.04), or with ``--config``
builds the body of a single-body config file instead (the flagship
``configs/demo_spot.json``: 17 blocks), times the kernel with 1 (the
baseline), 2 and 4 blocks a thread-block cluster — the device time a launch
from the profiler, and the wall time a call of back-to-back calls from CUDA
events, which the host's wrapper bounds at these sizes — and prints each
and the largest difference from the baseline.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import os
import subprocess
import sys
import time
from typing import NamedTuple

import torch

from fem_tpu_torch.ops.blocked_kernels import BlockTablesC, block_tables
from fem_tpu_torch.ops.blocking import Blocking, pad_blocking
from fem_tpu_torch.ops.element_kernels import count_launch
from fem_tpu_torch.utils import cuda_build

_P = ctypes.c_void_p
PAIRS = (1, 2, 4)


def make_kplane(blk: Blocking, K: torch.Tensor) -> torch.Tensor:
    """(B·Eb, d, d) K blocks → (B, d², Eb·d) planes: component pair (i, k)
    on row i·d+k, each element repeated ×d along the last axis (the JAX
    package's ``make_kplane``)."""
    b, eb, d = blk.num_blocks, blk.eb, blk.dim
    kp = K.reshape(b, eb, d, d).permute(0, 2, 3, 1).reshape(b, d * d, eb)
    return kp.repeat_interleave(d, dim=2).contiguous()


def blocked_gather_planar(x: torch.Tensor, blk: Blocking) -> torch.Tensor:
    """(N, d) → (B, d, Pb) block-local transposed copies (the JAX package's
    ``blocked_gather``)."""
    return x[blk.block_particles].transpose(1, 2).contiguous()


def _check_pair(blk: Blocking, pair: int) -> None:
    if pair not in PAIRS:
        raise ValueError(f"pair must be one of {PAIRS}, not {pair}")
    if blk.num_blocks % pair:
        raise ValueError(
            f"{blk.num_blocks} blocks do not divide by pair {pair} "
            "(ops/blocking.pad_blocking pads them)")


def paired_matvec_plain(blk: Blocking, kplane, xbt, dim: int, pair: int):
    """Plain PyTorch version of :func:`paired_matvec`."""
    _check_pair(blk, pair)
    col = torch.arange(blk.pb, device=xbt.device)
    s = ((blk.plus.long()[..., None] == col).to(xbt.dtype)
         - (blk.minus.long()[..., None] == col).to(xbt.dtype))  # (B, R, Pb)
    st = torch.matmul(xbt, s.transpose(1, 2))  # (B, d, R)
    t = torch.stack([
        sum(kplane[:, i * dim + k, :] * st[:, k, :] for k in range(dim))
        for i in range(dim)], dim=1)
    return torch.matmul(t, s)


# Elements a thread group of the kernel, one thread each (its kTile), and
# the most CTAs a block (its kMaxCtas): on the H100 the one setting of
# tiles of 32-128 and 2-8 CTAs a block that was ahead of a CTA a block at
# every pair at both 17 and 270 blocks (PERF.md, section 6).
PAIR_TILE = 64
PAIR_MAX_CTAS = 2
# The H100's most dynamic shared memory a CTA (opt-in; the kernel has no
# static shared memory).
SMEM_OPTIN = 232448


class PairPlan(NamedTuple):
    """A launch of P1: each cluster holds ``pair`` blocks."""

    tile: int  # elements a thread group, one thread each
    ctas: int  # CTAs a block: a cluster's size
    threads: int  # threads a CTA: ``pair`` groups of ``tile``
    smem: int  # bytes of dynamic shared memory a CTA


@functools.lru_cache(maxsize=64)
def pair_plan(eb: int, pb: int, dim: int, pair: int) -> PairPlan:
    """The kernel's launch for blocks of ``eb`` element and ``pb`` particle
    slots in ``dim`` dimensions, ``pair`` blocks a cluster: ⌈eb / 64⌉ CTAs
    a block, at most 2 (a larger ``eb`` takes rounds), each with a group of
    64 threads for each of the ``pair`` blocks and, per group, x (dim·pb),
    then its receive rows (eb·(dim+1) rows padded to 16 bytes, 8 in 2D)
    and plan rows (eb·(dim+1)), each part rounded to 16 bytes.  Raises
    ``ValueError`` for a launch the kernel does not take.  Pure: no device
    is asked."""
    if dim not in (2, 3):
        raise ValueError(f"the probe takes dim 2 or 3, not {dim}")
    if pair not in PAIRS:
        raise ValueError(f"pair must be one of {PAIRS}, not {pair}")
    if eb < 1 or pb < 1:
        raise ValueError(f"blocks of {eb} elements and {pb} particles")
    rows = eb * (dim + 1)
    words = (-(-dim * pb // 4) * 4
             + -(-(rows * (4 if dim == 3 else 2) + rows) // 4) * 4)
    smem = 4 * pair * words
    if smem > SMEM_OPTIN:
        raise ValueError(
            f"{smem} bytes of shared memory a CTA ({pair} blocks of {eb} "
            f"elements and {pb} particles) exceed the device's {SMEM_OPTIN}")
    return PairPlan(PAIR_TILE, min(PAIR_MAX_CTAS, -(-eb // PAIR_TILE)),
                    PAIR_TILE * pair, smem)


# The probe's library with its entries' argument types, loaded at the first
# launch.
_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("probe_pairblock")
        lib.fem_paired_matvec.argtypes = [
            ctypes.POINTER(BlockTablesC), ctypes.c_int, _P, _P, _P, _P,
        ]
        lib.fem_paired_matvec.restype = ctypes.c_int
        lib.fem_paired_matvec_last_launch.argtypes = [
            ctypes.POINTER(ctypes.c_int)]
        lib.fem_paired_matvec_last_launch.restype = None
        lib.fem_paired_matvec_error.argtypes = [ctypes.c_int]
        lib.fem_paired_matvec_error.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


class Launch(NamedTuple):
    """The kernel's last launch, as the library recorded it."""

    ctas: int  # CTAs of the grid
    threads: int  # threads a CTA
    cluster: int  # CTAs a cluster
    smem: int  # bytes of dynamic shared memory a CTA


def last_launch() -> Launch:
    """The grid of the kernel's last launch in this process, read from the
    library (zeros before the first)."""
    out = (ctypes.c_int * 4)()
    _library().fem_paired_matvec_last_launch(out)
    return Launch(*out)


def _check_device(dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")


def _versions(blk: Blocking) -> tuple:
    """The version counters of the blocking's tensors that the kernel
    reads: an in-place change to one of them rebuilds its tables."""
    return (blk.plus._version, blk.minus._version,
            blk.block_elements._version, blk.local_ptr._version,
            blk.local_rows._version)


# id(blocking) → (the blocking, its tensors' versions, its C tables, them
# by reference, device, device index): built at a blocking's first launch
# and again when it is replaced or changed in place.
_TABLES: dict = {}


def _bound_tables(blk: Blocking):
    key = id(blk)
    hit = _TABLES.get(key)
    if hit is None or hit[0] is not blk or hit[1] != _versions(blk):
        dev = blk.volume.device
        _check_device(dev)
        tables = block_tables(blk)
        index = dev.index if dev.index is not None else (
            torch.cuda.current_device())
        hit = (blk, _versions(blk), tables, ctypes.byref(tables), dev, index)
        if key not in _TABLES and len(_TABLES) >= 64:
            _TABLES.pop(next(iter(_TABLES)))
        _TABLES[key] = hit
    return hit


def paired_matvec(blk: Blocking, kplane: torch.Tensor, xbt: torch.Tensor,
                  dim: int, pair: int) -> torch.Tensor:
    """(B, d, Pb) per-block products.  CUDA tensors: one launch of the probe
    kernel on :func:`pair_plan`'s plan (left in ``paired_matvec.last_plan``),
    with the blocking's tables bound once.  CPU tensors:
    :func:`paired_matvec_plain`."""
    if xbt.device.type == "cpu":
        return paired_matvec_plain(blk, kplane, xbt, dim, pair)
    _check_device(xbt.device)
    _check_pair(blk, pair)
    _, _, tables, ref, dev, index = _bound_tables(blk)
    if tables.dim != dim:
        raise ValueError(f"dim {dim} but the blocking's is {tables.dim}")
    b, eb, pb = blk.num_blocks, blk.eb, blk.pb
    plan = pair_plan(eb, pb, dim, pair)
    f32 = torch.float32
    cuda_build.check_operand("kplane", kplane, (b, dim * dim, eb * dim), f32,
                             dev)
    cuda_build.check_operand("xbt", xbt, (b, dim, pb), f32, dev)
    out = torch.empty((b, dim, pb), dtype=f32, device=dev)
    lib = _library()
    rc = cuda_build.launch_on_stream(
        dev, index, lib.fem_paired_matvec, ref, pair, kplane.data_ptr(),
        xbt.data_ptr(), out.data_ptr())
    if rc != 0:
        msg = lib.fem_paired_matvec_error(rc).decode()
        raise RuntimeError(f"paired-block matvec kernel launch failed: {msg}")
    count_launch(paired_matvec, pair)
    paired_matvec.last_plan = plan
    return out


paired_matvec.launches = 0
paired_matvec.instance_launches = {}  # {(pair,): launches}
paired_matvec.last_plan = None


def padded_inputs(blk: Blocking, kplane, pos, pair: int):
    """(blocking, K planes, block vectors) padded to a multiple of ``pair``
    blocks: the padded blocks' planes are zero."""
    blk_p = pad_blocking(blk, pair)
    extra = blk_p.num_blocks - blk.num_blocks
    kp = torch.cat([kplane, kplane.new_zeros((extra,) + kplane.shape[1:])])
    return blk_p, kp, blocked_gather_planar(pos, blk_p)


# Windows the profiler may return without the probe kernel's launches
# before the probe fails: on the H100 it has returned windows with no
# device activity at all, up to three in a row, for calls that launched.
_WINDOWS = 10


def _time_us(fn, iters: int):
    """(device µs a launch of the probe kernel, from the profiler; wall µs
    a call, from CUDA events around ``iters`` back-to-back calls, which the
    host's wrapper bounds when it outlasts the kernel; the windows taken,
    each a warm-up call and ``iters`` calls).  A window that saw no launch
    of it is taken again, after a pause, up to _WINDOWS."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(_WINDOWS):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(iters):
                fn()
            stop.record()
            stop.synchronize()
        total, count = 0.0, 0
        for e in prof.key_averages():
            if "paired_matvec_kernel" in e.key:
                total += getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
                count += e.count
        if count:
            return (total / count, start.elapsed_time(stop) / iters * 1e3,
                    attempt + 1)
        time.sleep(0.05 * (attempt + 1))
    raise RuntimeError(f"the profiler saw no launch of the probe kernel in "
                       f"{_WINDOWS} windows")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--spacing", type=float, default=0.04)
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--config", default=None,
                   help="a single-body config file to take the body from")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("pairblock: no CUDA device; the probe times the card",
              file=sys.stderr)
        return 1

    from fem_tpu_torch.ops.element_kernels import hessian_blocks

    if args.config is not None:
        from fem_tpu_torch.entry import load_config

        _, obj, state, _ = load_config(args.config, "cuda")
    else:
        from fem_tpu_torch.models.mesh import load_object_mesh
        from fem_tpu_torch.models.state import build_object
        from fem_tpu_torch.utils.config import ObjectConfig

        here = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        spot = os.path.join(here, "assets", "spot.obj")
        if not os.path.exists(spot):
            subprocess.run([sys.executable,
                            os.path.join(here, "assets", "make_assets.py")],
                           check=True)
        ocfg = ObjectConfig(center=(2.0, 0.7, 2.0), rho=1000.0, E=4e4,
                            nu=0.4, damping=10.0, obj=spot)
        v, f, e, _ = load_object_mesh(ocfg, args.spacing)
        obj, state = build_object(ocfg, v, f, e, device="cuda")
    blk = obj.blocking
    d = obj.dim
    print(f"{obj.element_cnt} tets, {blk.num_blocks} blocks", flush=True)
    K = hessian_blocks(state.pos, blk.element_indices, blk.ref_inv,
                       blk.volume, obj.mu, obj.s_lambda)
    kp = make_kplane(blk, K)
    base = paired_matvec(blk, kp, blocked_gather_planar(state.pos, blk), d, 1)
    for pair in PAIRS:
        blk_p, kp_p, xbt_p = padded_inputs(blk, kp, state.pos, pair)
        us, wall, main.windows[pair] = _time_us(
            lambda: paired_matvec(blk_p, kp_p, xbt_p, d, pair), args.iters)
        out = paired_matvec(blk_p, kp_p, xbt_p, d, pair)
        diff = float((out[: base.shape[0]] - base).abs().max())
        label = ("baseline 1-block/step :" if pair == 1
                 else f"paired {pair}-block/step:")
        print(f"{label} {us:8.2f} us/apply on the device (maxdiff "
              f"{diff:.2e}, {blk_p.num_blocks} blocks; {wall:.1f} us a "
              f"call back to back, the host wrapper included)", flush=True)
    return 0


# {pair: profiler windows the last run took} (each window launches the
# kernel iters + 1 times).
main.windows = {}


if __name__ == "__main__":
    sys.exit(main())
