#!/usr/bin/env python3
# coding=utf-8
"""H1's two variants (``ops/stiffness_kernels.VARIANTS``: the rows variant,
the default, and the slots variant, the first design) side by side on one
GPU, in one process, in turns.

    python3 tools/torch_h1_ab.py [--rounds N]

* The kernels: on the flagship (``configs/demo_spot.json``, pinned over its
  top 1 %, as ``chip_smoke.py``'s path BB) at 9 columns, f32 and f64, the
  device ms a launch of phase A (``stiffness_rows_kernel``), phase B
  (``stiffness_sum_kernel``) and the slots kernel
  (``stiffness_apply_kernel``) under the profiler, ``REPS`` applies of each
  variant in one window; and the host µs an apply of each variant: the time
  to enqueue ``ENQUEUE`` applies with no synchronisation between them
  (fewer launches than the launch queue holds), in turns.
* The paths: BB (``Simulation.modes(k=6)``, Chebyshev), BC
  (``demo_hanging.json``, ``method="shift_invert"``) and BE
  (``buckling(k=4, gravity=True)`` on the flagship at E 4e6 pinned over
  its lowest 5 %), set up as ``chip_smoke.py`` sets them up.  Each runs
  once in each variant to warm up, then ``--rounds`` rounds, the order of
  the variants swapped each round (rows first in even rounds): the wall s
  of each solve, host clock, synchronised.  Then one profiled run of each
  in each variant: device ms a solve and busy share.  The slots variant
  runs through ``chip_smoke.SlotsVariant``; both variants' ω² or λ must be
  equal (``torch.equal``).

Prints one JSON line for the kernels and one a path (every wall, the
medians), each with the card's name and power limit.
"""

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 200
ENQUEUE = 400
COLUMNS = 9


def smoke_helpers():
    """This checkout's ``chip_smoke.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def enqueue_us(torch, fn):
    """Host µs a call to enqueue ``ENQUEUE`` calls of ``fn``, then waits."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ENQUEUE):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / ENQUEUE


def kernels(torch, cs, obj, pos, rounds):
    from fem_tpu_torch.convert import to_dtype
    from fem_tpu_torch.ops import stiffness_kernels as sk
    from fem_tpu_torch.solvers import modal

    n, d = obj.particle_cnt, obj.dim
    row = dict(what="H1 kernels (flagship, 9 columns)", particles=n,
               elements=obj.element_cnt)
    for dtype, name in ((torch.float32, "f32"), (torch.float64, "f64")):
        kv = modal.make_stiffness_hvp(to_dtype(obj, dtype), pos.to(dtype))
        b = kv.binding
        w = torch.randn((n, d, COLUMNS), generator=torch.Generator(
            ).manual_seed(COLUMNS), dtype=dtype).to(pos.device)
        cs.require(torch.equal(sk.stiffness_apply(b, w),
                               sk.stiffness_apply(b, w, variant="slots")),
                   f"H1 {name}: the variants differ")
        phase_a, phase_b, slots = cs.kernels_ms(
            torch, lambda: (sk.stiffness_apply(b, w),
                            sk.stiffness_apply(b, w, variant="slots")),
            REPS, [["stiffness_rows_kernel"], ["stiffness_sum_kernel"],
                   ["stiffness_apply_kernel"]])
        host = {"rows": [], "slots": []}
        for r in range(rounds):
            order = ("rows", "slots") if r % 2 == 0 else ("slots", "rows")
            for v in order:
                host[v].append(enqueue_us(
                    torch, lambda: sk.stiffness_apply(b, w, variant=v)))
        row[name] = dict(
            phase_a_ms=phase_a, phase_b_ms=phase_b, rows_ms=phase_a + phase_b,
            slots_ms=slots, host_us_rows=host["rows"],
            host_us_slots=host["slots"],
            host_us_rows_median=statistics.median(host["rows"]),
            host_us_slots_median=statistics.median(host["slots"]))
    return row


def paths(torch, cs, dev):
    """{label: (the solve's callable, the result's tensor to compare)}."""
    import fem_tpu_torch
    from fem_tpu_torch.solvers.static import solve_static

    with open(os.path.join(REPO, "configs", "demo_spot.json")) as f:
        spot = json.load(f)

    def simulation(**obj_over):
        data = json.loads(json.dumps(spot))
        data["objects"][0].update(obj_over)
        return fem_tpu_torch.Simulation.from_dict(data, device=dev)

    rest = simulation().scene[0].state.pos
    lo, hi = float(rest[:, 1].min()), float(rest[:, 1].max())
    bb = simulation(pin_boxes=[[[-1e3, hi - 0.01 * (hi - lo), -1e3],
                                [1e3, 1e3, 1e3]]])
    hang = fem_tpu_torch.Simulation.from_config(
        os.path.join(REPO, "configs", "demo_hanging.json"), device=dev)
    be = simulation(pin_boxes=[[[-1e3, -1e3, -1e3],
                                [1e3, lo + cs.BUCKLE_PINS * (hi - lo), 1e3]]],
                    E=cs.BUCKLE_E)
    base = solve_static(be.scene[0].obj, be.scene[0].state.pos,
                        g_dir=tuple(be.cfg.g_dir))
    return bb, {
        "BB": (lambda: bb.modes(k=6), lambda r: r.omega_sq),
        "BC": (lambda: hang.modes(k=6, method="shift_invert"),
               lambda r: r.omega_sq),
        "BE": (lambda: be.buckling(k=4, gravity=True, base=base),
               lambda r: r.load_factors),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=6)
    args = p.parse_args(argv)
    cs = smoke_helpers()
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("torch_h1_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    bb, solves = paths(torch, cs, dev)
    row = kernels(torch, cs, bb.scene[0].obj, bb.scene[0].state.pos,
                  args.rounds)
    print(json.dumps(dict(card=card, **row)), flush=True)

    def run(go, variant):
        if variant == "rows":
            return go()
        with cs.SlotsVariant():
            return go()

    for label, (go, key) in solves.items():
        ref = {v: key(run(go, v)) for v in ("rows", "slots")}  # warm-up
        cs.require(torch.equal(ref["rows"], ref["slots"]),
                   f"path {label}: the variants' results differ")
        walls = {"rows": [], "slots": []}
        for r in range(args.rounds):
            order = ("rows", "slots") if r % 2 == 0 else ("slots", "rows")
            for v in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(go, v)
                torch.cuda.synchronize()
                walls[v].append(time.perf_counter() - t0)
        prof = {}
        for v in ("rows", "slots"):
            _, _, _, _, _, dev_ms, busy = cs.counted_then_profiled(
                torch, lambda: None, dict, lambda: run(go, v), 1)
            prof[v] = dict(device_ms=dev_ms, busy_pct=busy)
        print(json.dumps(dict(
            card=card, path=label, rounds=args.rounds, walls_s=walls,
            median_wall_s={v: statistics.median(x) for v, x in walls.items()},
            profiled=prof)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
