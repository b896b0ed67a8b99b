# coding=utf-8
"""The readings the limits of ``correct`` are set from, on the GPU:

    python3 portbench/calibrate.py --cell cube3d_implicit.render \
        --seeds 12 --control-seeds 3 --first-seed 1000

runs the cell's set-up, warm-up and a one-episode window for each seed and
prints, one JSON line each, the compared numbers of

* ``program``: the program as the benchmark runs it (the lower readings);
* ``control``: the plain reference put in the program's place with its
  element chain and operator products in bfloat16, the state in float32
  (the upper readings);
* ``unchanged``: the program's frame run, its state then put back, so the
  step returns its state unchanged;
* ``altered``: the program's frame with one particle's position moved by
  1 mm where the frame produces it.

The benchmark's own runs run none of this.  ``ControlSystem`` and the two
faults are also what ``portbench/tests`` drive on the CPU at a small size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import check, harness  # noqa: E402
from portbench.reference import fem  # noqa: E402


class ControlSystem:
    """The reference in the program's place, computing its chain and
    G(K)·x products in ``chain_dtype`` on a float32 state."""

    def __init__(self, config: dict, device: str = "cuda", overrides=None,
                 chain_dtype=None):
        import torch

        self.torch = torch
        self.config, self.device = config, device
        self.chain_dtype = torch.bfloat16 if chain_dtype is None else chain_dtype
        self.body = self.scene = self.state = self.start = None
        self.iters = None

    def check_mesh(self, rest, tets) -> None:
        self.body, self.scene = check.reference_scene(
            self.config, rest, tets, self.torch.float32, self.device)

    def set_start(self, pos, vel, vel_g) -> None:
        t = self.torch
        self.start = fem.State(*(t.as_tensor(a, device=self.device)
                                 for a in (pos, vel, vel_g)))

    def reset(self) -> None:
        self.state = fem.State(*(t.clone() for t in self.start))

    def step(self) -> None:
        self.state, its = fem.frame(self.body, self.scene, self.state,
                                    self.chain_dtype)
        self.iters = self.torch.tensor(its, dtype=self.torch.int32,
                                       device=self.device)

    def positions(self):
        return self.state.pos.cpu().numpy()

    def tensors(self):
        return tuple(self.state)

    def snapshot(self):
        return tuple(t.clone() for t in self.state)

    def iterations(self):
        return self.iters

    def launches(self):
        return {}

    def close(self) -> None:
        self.state = self.start = None


class UnchangedSystem(harness.ProgramSystem):
    """Fault: the frame runs, and its state is put back."""

    def step(self) -> None:
        before = self.sim.scene[0].state
        self.sim.step_frame()
        self.sim.scene[0].state = before


class AlteredSystem(harness.ProgramSystem):
    """Fault: one particle's position moved by 1 mm as the frame produces
    it."""

    def step(self) -> None:
        self.sim.step_frame()
        s = self.sim.scene[0].state
        pos = s.pos.clone()
        pos[0, 1] += 1e-3
        self.sim.scene[0].state = s.replace(pos=pos)


KINDS = {"program": harness.ProgramSystem, "control": ControlSystem,
         "unchanged": UnchangedSystem, "altered": AlteredSystem}


def reading(cell: dict, kind: str, seed: int, device: str = "cuda",
            sim_overrides=None, segments: int = harness.SEGMENTS) -> dict:
    """The compared numbers of a one-episode run of ``kind`` on ``seed``."""
    inf = {k: float("inf") for k in check.NUMBERS}
    t0 = time.perf_counter()
    r = harness.run_cell(cell, seed, 0.0, False, device=device,
                         make_system=KINDS[kind], sim_overrides=sim_overrides,
                         check_kernel=kind != "control" and device == "cuda",
                         segments=segments, limits=inf)
    out = {k: v["value"] for k, v in r["compared"].items()}
    out.update(kind=kind, seed=seed, cell=cell["name"],
               seconds=time.perf_counter() - t0,
               correct_at_limits=check.verdict(
                   {k: (v if v is not None else float("inf"))
                    for k, v in out.items() if k in check.NUMBERS}
                   | {"start_equal": out["start_equal"]},
                   cell["config_data"]["limits"])[0])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=1000)
    args = ap.parse_args(argv)
    os.environ.setdefault("FEM_TPU_MESH_CACHE", os.path.join(
        ROOT, "portbench", ".cache", "mesh"))
    cell = harness.load_cell(args.cell)
    s = args.first_seed
    plan = ([("program", s + i) for i in range(args.seeds)]
            + [("control", s + i) for i in range(args.control_seeds)]
            + [(k, s + i) for k in ("unchanged", "altered")
               for i in range(args.fault_seeds)])
    rows = []
    for kind, seed in plan:
        row = reading(cell, kind, seed)
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"cell": args.cell}
    for k in check.NUMBERS:
        prog = [r[k] for r in rows if r["kind"] == "program"]
        ctrl = [r[k] if r[k] is not None else float("inf")
                for r in rows if r["kind"] == "control"]
        summary[k] = {"lower": max(prog) if prog else None,
                      "upper": min(ctrl) if ctrl else None,
                      "program": prog, "control": ctrl}
        for f in ("unchanged", "altered"):
            summary[k][f] = [r[k] for r in rows if r["kind"] == f]
    print(json.dumps({"summary": summary}), flush=True)
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
