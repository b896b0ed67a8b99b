# coding=utf-8
"""P2, the int8 table probe: ``reps`` chained dots Σ_r roll(a, r)·w of a
small value side with a ±1 table, as bf16×bf16→f32, int8×int8→int32 and
int8×bf16→f32.

``chained_dot`` launches the hand-written CUDA kernel
``fem_tpu_torch/csrc/probe_int8.cu`` (warp-level ``mma.sync``) for tensors
on a CUDA device; it replaces the Pallas kernel built in the JAX package's
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
import sys

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
            ctypes.c_int, _P, _P,
        ]
        lib.fem_chained_dot.restype = ctypes.c_int
        lib.fem_chained_dot_error.argtypes = [ctypes.c_int]
        lib.fem_chained_dot_error.restype = ctypes.c_char_p
    return lib


def chained_dot(a: torch.Tensor, w: torch.Tensor, reps: int,
                variant: str) -> torch.Tensor:
    """Σ_{r < reps} roll(a, r, rows) @ w.  CUDA tensors: one launch of the
    probe kernel's ``variant``; n must divide by 256 (bf16 MMA) or 512
    (int8 MMA), cols by 8, and rows be 1..16.  CPU tensors:
    :func:`chained_dot_plain`."""
    if a.device.type == "cpu":
        return chained_dot_plain(a, w, reps, variant)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    _check(a, w, variant)
    rows, n = a.shape
    cols = w.shape[1]
    for name, t in (("a", a), ("w", w)):
        cuda_build.check_operand(name, t, tuple(t.shape), t.dtype, a.device)
    out = torch.empty((rows, cols), dtype=DTYPES[variant][2], device=a.device)
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.fem_chained_dot(VARIANTS.index(variant), a.data_ptr(),
                                 w.data_ptr(), rows, n, cols, int(reps),
                                 out.data_ptr(), stream)
    if rc != 0:
        msg = lib.fem_chained_dot_error(rc).decode()
        raise RuntimeError(f"chained-dot kernel launch failed ({variant}, "
                           f"{rows}x{n}x{cols}): {msg}")
    count_launch(chained_dot, variant)
    return out


chained_dot.launches = 0
chained_dot.instance_launches = {}  # {(variant,): launches}


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
