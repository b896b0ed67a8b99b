#!/usr/bin/env python3
# coding=utf-8
"""P1's tile and CTAs a block swept, and its parts timed, on one GPU.

    python3 tools/torch_p1_sweep.py [--parent PATH]

Builds ``fem_tpu_torch/csrc/probe_pairblock.cu`` once for each (tile, most
CTAs a block) of VARIANTS, its ``kTile`` and ``kMaxCtas`` constants
replaced in a copy under ``build/p1_sweep/``; once for each of ABLATIONS,
the committed source with one part of its work taken out (timing only:
all but the first give wrong products); and, with ``--parent``, another
checkout's source as it is (for instance the parent commit unpacked with
``git archive``) — nvcc, the port's flags, all at once.  Each library
stands in for the probe's in turn and launches through
``probes/pairblock.paired_matvec`` on ``tools/torch_kernel_ab.py``'s P1
bodies and operand sets (the flagship, and the probe's default body with
its operands rotated over 256 MB), at every pair: device ms a launch from
the profiler (50 launches a window), the launch the library recorded, and
whether the output equals the committed source's bit for bit.  Two rounds,
the variants in turns forward then backward.  Prints one JSON line a
measurement, with the card's name and power limit.
"""

import argparse
import ctypes
import itertools
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (kTile, kMaxCtas): the committed source's first.
VARIANTS = ((64, 2), (32, 8), (64, 4), (32, 4), (32, 2), (128, 2))
SWEEP_DIR = os.path.join(REPO, "build", "p1_sweep")
# The committed source less one part of its work, as text replacements:
# what each part costs is the committed source's time less its ablation's.
_LOCAL = ("    if (owner != me) dst = cl.map_shared_rank(dst, owner);\n", "")
ABLATIONS = {
    # The K planes of make_kplane repeat each value d times along a row, so
    # the j = 0 column holds every value: d² loads an element, not d³.
    "K loads of column j = 0 only": [(
        "kp[static_cast<size_t>(q) * rb + e * D + j];",
        "kp[static_cast<size_t>(q) * rb + e * D];")],
    "no slot sums (zeros)": [(
        "    slot_sum<D>(recv, prow, s0, s1, a);",
        "    for (int c = 0; c < D; ++c) a[c] = 0.0f;")],
    "rows stored locally (no DSMEM)": [_LOCAL],
    "rows stored locally, no cluster barriers": [
        _LOCAL,
        ("  if (nr > 1) fem::cluster_arrive_relaxed();\n", ""),
        ("  if (nr > 1) fem::cluster_wait();", ""),
        ("    cl.sync();", "    __syncthreads();")],
}


def sources(committed, parent):
    """{name: source path}: the committed source's copy with each
    variant's constants and each ablation, and the parent's source when
    given."""
    with open(committed) as fh:
        text = fh.read()
    found = {n: f"constexpr int {n} = {v};"
             for n, v in zip(("kTile", "kMaxCtas"), VARIANTS[0])}
    for line in found.values():
        if line not in text:
            raise SystemExit(f"{committed} does not hold `{line}`")
    out = {}
    for i, (name, edits) in enumerate(ABLATIONS.items()):
        d = os.path.join(SWEEP_DIR, f"ablation{i}")
        shutil.copytree(os.path.dirname(committed), d)
        changed = text
        for old, new in edits:
            if old not in changed:
                raise SystemExit(f"{committed} does not hold `{old}`")
            changed = changed.replace(old, new)
        out[name] = os.path.join(d, os.path.basename(committed))
        with open(out[name], "w") as fh:
            fh.write(changed)
    for tile, ctas in VARIANTS:
        name = f"tile {tile}, {ctas} CTAs"
        d = os.path.join(SWEEP_DIR, f"t{tile}c{ctas}")
        shutil.copytree(os.path.dirname(committed), d)
        path = os.path.join(d, os.path.basename(committed))
        with open(path, "w") as fh:
            fh.write(text.replace(found["kTile"],
                                  f"constexpr int kTile = {tile};")
                     .replace(found["kMaxCtas"],
                              f"constexpr int kMaxCtas = {ctas};"))
        out[name] = path
    if parent is not None:
        d = os.path.join(SWEEP_DIR, "parent")
        shutil.copytree(os.path.join(os.path.abspath(parent), "fem_tpu_torch",
                                     "csrc"), d)
        out["parent"] = os.path.join(d, os.path.basename(committed))
    return out


def build(paths, cuda_build, p1):
    """{name: the library, its entries typed}, every nvcc started at
    once."""
    nvcc = cuda_build.find_nvcc()
    jobs = {}
    for name, src in paths.items():
        so = os.path.join(os.path.dirname(src), "lib.so")
        jobs[name] = (so, subprocess.Popen(
            [nvcc, *cuda_build.NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc exit {proc.returncode}\n{log}")
        lib = ctypes.CDLL(so)
        lib.fem_paired_matvec.argtypes = [
            ctypes.POINTER(p1.BlockTablesC), ctypes.c_int] + [
            ctypes.c_void_p] * 4
        lib.fem_paired_matvec.restype = ctypes.c_int
        lib.fem_paired_matvec_error.argtypes = [ctypes.c_int]
        lib.fem_paired_matvec_error.restype = ctypes.c_char_p
        if hasattr(lib, "fem_paired_matvec_last_launch"):
            lib.fem_paired_matvec_last_launch.argtypes = [
                ctypes.POINTER(ctypes.c_int)]
            lib.fem_paired_matvec_last_launch.restype = None
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", default=None,
                   help="another checkout whose source is timed as it is")
    args = p.parse_args(argv)
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import torch

    if not torch.cuda.is_available():
        print("torch_p1_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import torch_kernel_ab as ab

    from fem_tpu_torch.ops import element_kernels as ek
    from fem_tpu_torch.probes import pairblock as p1
    from fem_tpu_torch.utils import cuda_build

    shutil.rmtree(SWEEP_DIR, ignore_errors=True)
    libs = build(sources(os.path.join(cuda_build.CSRC, "probe_pairblock.cu"),
                         args.parent), cuda_build, p1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cells = []
    for label, cobj, cpos, obj in ab.p1_bodies(torch, dev):
        cblk, d = cobj.blocking, obj.dim
        K = ek.hessian_blocks(cpos, cblk.element_indices, cblk.ref_inv,
                              cblk.volume, cobj.mu, cobj.s_lambda)
        noise = torch.randn(cpos.shape, generator=torch.Generator()
                            .manual_seed(17))
        x = (cpos + 0.3 * noise).to(dev)
        kp = p1.make_kplane(cblk, K).to(dev)
        for pair in p1.PAIRS:
            bp, kpp, xb = p1.padded_inputs(obj.blocking, kp, x, pair)
            cells.append((label, pair, d, ab.p1_sets(cs, bp, kpp, xb)))
    names = list(libs)
    committed, ref = f"tile {VARIANTS[0][0]}, {VARIANTS[0][1]} CTAs", {}
    names.remove(committed)
    names.insert(0, committed)
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            p1._LIB = libs[name]
            for label, pair, d, sets in cells:
                out = p1.paired_matvec(*sets[0], d, pair)
                torch.cuda.synchronize()
                if name == committed:
                    ref.setdefault((label, pair), out)
                turn = itertools.count()

                def call(sets=sets, turn=turn, pair=pair, d=d):
                    b, k, xs = sets[next(turn) % len(sets)]
                    return p1.paired_matvec(b, k, xs, d, pair)

                ms = cs.kernel_ms(torch, call, 50, ["paired_matvec_kernel"])
                launch = (p1.last_launch() if hasattr(
                    libs[name], "fem_paired_matvec_last_launch") else None)
                print(json.dumps(dict(
                    card=card, round=rnd, variant=name, scene=label,
                    pair=pair, sets=len(sets), ms=ms,
                    launch=None if launch is None else launch._asdict(),
                    equal_to_committed=bool(torch.equal(
                        out, ref[(label, pair)])) if (label, pair) in ref
                    else None)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
