# coding=utf-8
"""The benchmark of fem_tpu_torch: one cell (a configuration under a traffic
mix) a process.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` builds the configuration's ``Simulation`` on the GPU, sets
the start state drawn from the seed, warms up one episode, then runs
episodes back to back for ``--seconds`` and prints one JSON line: the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``.  Everything a cell needs is found by name: the configuration
in ``portbench/configs/<config>.json`` (``file`` in BENCHMARK.json), the
traffic mix in ``portbench/traffic/<traffic>.json``, each per-layer metric's
reader in ``portbench/metrics/<name>.py``.

An episode is the configuration's ``episode_frames`` rendered frames from
the start state, which is restored from a device copy before each episode,
so that every episode does the same work.  The traffic mix says how often
the positions are read back (``readback_every`` frames, and at the
episode's end) and which latency metric the readbacks feed: the time from
the first dispatch of the frames read to their positions on the host.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
# Top-level module names that may not be loaded in a run, compared whole.
FORBIDDEN = ("jax", "jaxlib", "flax", "fem_tpu")
SEGMENTS = 12  # random two-frame segments compared a run
THREADS_REFERENCE = 8  # set once the window has closed


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> List[str]:
    """The forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


# -- the cell, by name ------------------------------------------------------

def load_cell(name: str, root=ROOT) -> dict:
    """The workload entry ``name`` of BENCHMARK.json with its configuration,
    traffic mix and the metrics it reports."""
    root = Path(root)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    cell = dict(cells[name])
    cfg_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cell["config_data"] = json.loads((root / cfg_entry["file"]).read_text())
    cell["traffic_data"] = json.loads(
        (root / "portbench" / "traffic" / f"{cell['traffic']}.json")
        .read_text())

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    cell["end_to_end"] = [m for m in spec["end_to_end"] if mine(m)]
    cell["per_layer"] = [m for m in spec["per_layer"] if mine(m)]
    cell["root"] = str(root)
    return cell


def load_mesh(config: dict, root: Path = ROOT) -> dict:
    with np.load(root / config["mesh"]) as z:
        return {"nodes": z["nodes"], "tets": z["tets"]}


def load_reader(name: str, root: Path = ROOT) -> Callable:
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def resolve(path: str):
    """``module:attribute`` → the object."""
    mod, _, attr = path.partition(":")
    return getattr(importlib.import_module(mod), attr)


# -- the start state -------------------------------------------------------

def start_state(config: dict, rest: np.ndarray, seed: int):
    """(pos, vel, vel_g) float32 numpy: the rest shape turned about the
    vertical axis through its centroid by a yaw drawn from the seed, moving
    at a uniform vertical velocity drawn from the seed, gravity channel
    zero."""
    rng = np.random.default_rng(seed % (1 << 64))
    st = config["start"]
    yaw = rng.uniform(*st["yaw"])
    vy = rng.uniform(*st["vertical_velocity"])
    g = np.asarray(config["sim"]["g_dir"], np.float64)
    up = int(np.argmax(np.abs(g)))
    a, b = [k for k in range(rest.shape[1]) if k != up][:2]
    x = rest.astype(np.float64)
    c = x.mean(axis=0)
    pos = x.copy()
    if rest.shape[1] == 3:
        da, db = x[:, a] - c[a], x[:, b] - c[b]
        pos[:, a] = c[a] + math.cos(yaw) * da - math.sin(yaw) * db
        pos[:, b] = c[b] + math.sin(yaw) * da + math.cos(yaw) * db
    vel = np.zeros_like(x)
    vel[:, up] = vy
    z = np.zeros_like(x)
    return pos.astype(np.float32), vel.astype(np.float32), z.astype(np.float32)


# -- the system under test ----------------------------------------------------

class ProgramSystem:
    """``fem_tpu_torch.api.Simulation`` of the configuration: the entry the
    window drives (``step_frame``, ``positions``)."""

    def __init__(self, config: dict, device: str = "cuda",
                 overrides: Optional[dict] = None):
        import torch

        from fem_tpu_torch.api import Simulation

        self.torch = torch
        sim_cfg = dict(config["sim"], **(overrides or {}))
        self.sim = Simulation.from_dict(sim_cfg, device=device)
        if len(self.sim.scene) != 1:
            raise ValueError("the benchmark's configurations have one body")
        fk = config.get("frame_kernel")
        self.wrapper = resolve(fk["wrapper"]) if fk else None
        self.start = None

    def check_mesh(self, rest: np.ndarray, tets: np.ndarray) -> None:
        obj = self.sim.scene[0].obj
        if not (np.array_equal(obj.rest_pos.cpu().numpy(), rest)
                and np.array_equal(obj.element_indices.cpu().numpy(), tets)):
            raise RuntimeError(
                "the program's mesh differs from the configuration's mesh "
                f"file ({obj.particle_cnt} particles, {obj.element_cnt} "
                f"elements against {len(rest)}, {len(tets)})")

    def set_start(self, pos, vel, vel_g) -> None:
        torch = self.torch
        s = self.sim.scene[0].state
        dev = s.pos.device
        self.start = s.replace(**{k: torch.as_tensor(v, device=dev)
                                  for k, v in (("pos", pos), ("vel", vel),
                                               ("vel_g", vel_g))})

    def reset(self) -> None:
        st = self.start
        self.sim.scene[0].state = st.replace(
            pos=st.pos.clone(), vel=st.vel.clone(), vel_g=st.vel_g.clone(),
            force=st.force.clone())

    def step(self) -> None:
        self.sim.step_frame()

    def positions(self) -> np.ndarray:
        return self.sim.positions()

    def tensors(self):
        s = self.sim.scene[0].state
        return s.pos, s.vel, s.vel_g

    def snapshot(self):
        return tuple(t.clone() for t in self.tensors())

    def iterations(self):
        return self.sim.last_aux.solver_iterations

    def launches(self) -> Dict:
        return {} if self.wrapper is None else dict(
            self.wrapper.variant_launches)

    def close(self) -> None:
        del self.sim, self.start


def _count(launches: Dict) -> int:
    return sum(launches.values())


# -- the sample compared -------------------------------------------------------

class Pending:
    def __init__(self, episode: int, start: int):
        self.episode, self.start = episode, start
        self.inp, self.out = None, []


class Sampler:
    """Which two-frame segments of the window are kept for the comparison:
    a reservoir of ``n`` drawn from the seed over ``n`` candidate segments an
    episode (distinct random starts), one over each episode's heaviest
    segment (``heavy``) and one over each episode's first segment."""

    def __init__(self, seed: int, n: int, frames: int, heavy: int):
        self.rng = np.random.default_rng([seed % (1 << 64), 0x5E9])
        self.n, self.frames, self.heavy = n, frames, heavy
        self.slots: List[Optional[Pending]] = [None] * n
        self.seen = 0
        self.fixed = {"heavy": None, "first": None}
        self.fixed_seen = 0

    def _admit(self, k: int, n: int) -> Optional[int]:
        if k < n:
            return k
        j = int(self.rng.integers(0, k + 1))
        return j if j < n else None

    def plan(self, episode: int) -> Dict[int, List[Pending]]:
        """Decide this episode's admissions; frame → segments starting
        there."""
        mine = []
        starts = self.rng.choice(self.frames - 1, size=min(
            self.n, self.frames - 1), replace=False)
        for s in starts:
            slot = self._admit(self.seen, self.n)
            self.seen += 1
            if slot is not None:
                self.slots[slot] = p = Pending(episode, int(s))
                mine.append(p)
        if self._admit(self.fixed_seen, 1) is not None:
            for key, s in (("heavy", self.heavy), ("first", 0)):
                self.fixed[key] = p = Pending(episode, s)
                mine.append(p)
        self.fixed_seen += 1
        live = set(map(id, self.segments()))
        by_frame: Dict[int, List[Pending]] = {}
        for p in mine:
            if id(p) in live:
                by_frame.setdefault(p.start, []).append(p)
        return by_frame

    def segments(self) -> List[Pending]:
        return [p for p in self.slots + list(self.fixed.values())
                if p is not None]


# -- the window -----------------------------------------------------------------

class Window:
    """What the window recorded."""

    def __init__(self):
        self.frames = 0
        self.episodes = 0
        self.seconds = 0.0
        self.latencies: List[float] = []  # s, per readback
        self.enqueue: List[float] = []  # s, per frame (host, no sync)
        self.iterations: list = []  # per frame, device tensors (trace runs)
        self.untraced_from = 0  # the first frame after the profiler stopped
        self.untraced_t0 = 0.0  # and the host clock then
        self.traced = (0, 0)  # frames [a, b) of the active traced episodes
        self.traced_launches = 0
        self.trace = None  # trace.Trace of the traced episodes
        self.launches = 0
        self.untraced_seconds = 0.0


def run_window(system, *, frames: int, readback_every: int, seconds: float,
               sampler: Optional[Sampler], trace_episodes: int = 0,
               record_iterations: bool = False) -> Window:
    """Episodes back to back until ``seconds`` have passed (at least one, and
    with ``trace_episodes`` the profiler's warm-up episode and that many
    traced ones first)."""
    import torch

    w = Window()
    prof, trace_path, span_on = None, None, False
    if trace_episodes:
        from torch.profiler import ProfilerActivity, profile, schedule

        fd, trace_path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=trace_episodes,
                              repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(trace_path))
        prof.start()
        span_on = True

    def span(name):
        if span_on:
            return torch.profiler.record_function("portbench." + name)
        return contextlib.nullcontext()

    launches0 = _count(system.launches())
    t_begin = time.perf_counter()
    deadline = t_begin + seconds
    while True:
        ep = w.episodes
        if prof is not None and ep == 1:
            traced_launches0, traced_frame0 = _count(system.launches()), w.frames
        plan = sampler.plan(ep) if sampler is not None else {}
        after: Dict[int, List[Pending]] = {}
        with span("reset"):
            system.reset()
        unit_start = None
        for f in range(frames):
            for p in plan.get(f, ()):
                with span("snapshot"):
                    p.inp = system.snapshot()
                after.setdefault(f, []).append(p)
                after.setdefault(f + 1, []).append(p)
            with span("step_frame"):
                t0 = time.perf_counter()
                system.step()
                t1 = time.perf_counter()
            if unit_start is None:
                unit_start = t0
            w.enqueue.append(t1 - t0)
            if record_iterations:
                w.iterations.append(system.iterations())
            for p in after.pop(f, ()):
                with span("snapshot"):
                    p.out.append(system.snapshot())
            if (f + 1) % readback_every == 0 or f == frames - 1:
                with span("positions"):
                    system.positions()
                w.latencies.append(time.perf_counter() - unit_start)
                unit_start = None
            w.frames += 1
        w.episodes += 1
        if prof is not None:
            if ep == trace_episodes:
                w.traced = (traced_frame0, w.frames)
                w.traced_launches = _count(system.launches()) - traced_launches0
            prof.step()
            if ep == trace_episodes:
                prof.stop()
                prof, span_on = None, False
                w.untraced_from = w.frames
                w.untraced_t0 = time.perf_counter()
        if (time.perf_counter() >= deadline and prof is None
                and w.episodes >= 1):
            break
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    w.seconds = t_end - t_begin
    if w.untraced_from:
        w.untraced_seconds = t_end - w.untraced_t0
    w.launches = _count(system.launches()) - launches0
    if trace_path is not None:
        from portbench import trace as tr

        w.trace = tr.load(trace_path)
        os.remove(trace_path)
    return w


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile of all values."""
    v = sorted(values)
    return float(v[max(0, math.ceil(q / 100.0 * len(v)) - 1)])


# -- what the readers see ---------------------------------------------------------

class Context:
    """What a per-layer reader reads: the cell, the window, the mesh's sizes
    and the work of the traced frames."""

    def __init__(self, cell: dict, window: Window, e: int, n: int, d: int):
        self.cell = cell
        self.config = cell["config_data"]
        self.traffic = cell["traffic_data"]
        self.window = window
        self.e, self.n, self.d = e, n, d
        sim = self.config["sim"]
        self.sim_count = int(sim["sim_count"])
        self.explicit = bool(sim.get("use_explicit_method")
                             or sim.get("auto_diff"))
        self.obstacles = len(sim.get("blocks", []))
        self.kernel = self.config.get("frame_kernel")
        self._iters = None
        self._records = None

    def log(self, msg: str) -> None:
        log(msg)

    def iterations(self) -> np.ndarray:
        """(frames, sim_count) CG iterations of every window frame."""
        if self._iters is None:
            import torch

            its = self.window.iterations
            self._iters = (torch.stack(its).cpu().numpy() if its
                           else np.zeros((0, self.sim_count), np.int64))
        return self._iters

    def work(self, a: int, b: int):
        """(operations, bytes) of window frames [a, b)."""
        from portbench import work

        its = self.iterations()[a:b]
        ops = sum(work.frame_ops(self.e, self.n, self.d, self.explicit, row)
                  for row in its)
        nbytes = (b - a) * work.frame_bytes(self.e, self.n, self.d,
                                            self.explicit, self.sim_count,
                                            self.obstacles)
        return ops, nbytes

    def traced_work(self):
        """(operations, bytes) of the traced frames."""
        return self.work(*self.window.traced)

    def untraced(self):
        """(first frame, frames, seconds) of the window after the profiler
        stopped: what the per-layer readers of a whole frame's share read,
        so that the profiler's own host time is not in it."""
        w = self.window
        return w.untraced_from, w.frames - w.untraced_from, w.untraced_seconds

    def device_busy_per_frame(self) -> Optional[float]:
        """Device seconds a frame in the traced episodes (the profiler's
        timeline: any kernel, copy or memset), which the profiler does not
        lengthen."""
        from portbench import trace as tr

        a, b = self.window.traced
        return tr.busy_seconds(self.window.trace) / (b - a) if b > a else None

    def roofline(self, kernel_id: str) -> Optional[float]:
        """The configuration's whole-frame kernel's share of its roofline, in
        %, where that kernel is ``kernel_id``: the least H100 time of the
        traced frames' work (``portbench/work.py``) over the device time of
        its launches (its records' mean duration times the launches made,
        where the profiler dropped records)."""
        from portbench import work

        if not self.kernel or self.kernel["id"] != kernel_id:
            return None
        recs, launched = self.kernel_records()
        if not recs or not launched:
            return None
        mean = sum(recs) / len(recs)
        self.log(f"{kernel_id} {1e3 * mean:.6f} ms a launch (device)")
        ops, nbytes = self.traced_work()
        return 100.0 * work.least_seconds(ops, nbytes) / (mean * launched)

    def kernel_records(self):
        """(durations s of the frame kernel's records, launches made) in the
        traced episodes (none without a whole-frame kernel); the count is
        printed on stderr once."""
        if self.kernel is None:
            return [], 0
        if self._records is None:
            from portbench import trace as tr

            w = self.window
            recs = tr.kernel_records(w.trace, self.kernel["profiler_names"])
            launched = w.traced_launches
            note = ("" if len(recs) == launched else
                    f"; {launched - len(recs)} records dropped by the "
                    "profiler")
            self.log(f"{self.kernel['id']} records seen {len(recs)} of "
                     f"{launched} launches{note}")
            self._records = (recs, launched)
        return self._records


# -- the run ------------------------------------------------------------------------

def run_cell(cell: dict, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", make_system: Callable = ProgramSystem,
             sim_overrides: Optional[dict] = None, check_kernel: bool = True,
             t_start: Optional[float] = None, segments: int = SEGMENTS,
             limits: Optional[dict] = None) -> dict:
    """One run; returns the result object (before the forbidden-module
    check)."""
    import torch

    from portbench import check

    t_start = time.perf_counter() if t_start is None else t_start
    config, traffic = cell["config_data"], cell["traffic_data"]
    root = Path(cell["root"])
    mesh = load_mesh(config, root)
    rest = check.rest_positions(config, mesh)
    frames = int(config["episode_frames"])
    sim_count = int(config["sim"]["sim_count"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_build = time.perf_counter()
    system = make_system(config, device, sim_overrides)
    system.check_mesh(rest, mesh["tets"])
    t_warm = time.perf_counter()
    start = start_state(config, rest, seed)
    system.set_start(*start)

    # Warm-up: one episode in the traffic's own mode, recording each
    # frame's iterations and lowest point to find the heaviest segment.
    before = system.launches()
    up = int(np.argmax(np.abs(np.asarray(config["sim"]["g_dir"]))))
    its, low = [], []
    system.reset()
    rb = int(traffic["readback_every"]) or frames
    for f in range(frames):
        system.step()
        its.append(system.iterations())
        low.append(system.tensors()[0][:, up].min())
        if (f + 1) % rb == 0 or f == frames - 1:
            system.positions()
    per_frame = torch.stack([i.reshape(-1).sum() for i in its]).cpu().numpy()
    lowest = torch.stack(low).cpu().numpy()
    if per_frame.max() > 0:
        heavy = int(np.argmax(per_frame))
    elif (lowest < 0).any():
        heavy = int(np.argmax(lowest < 0))
    else:
        heavy = frames // 2
    heavy = min(heavy, frames - 2)
    check_kernel = check_kernel and "frame_kernel" in config
    if check_kernel:
        _check_kernel(config, before, system.launches(), frames)
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    sampler = Sampler(seed, segments, frames, heavy)
    w = run_window(system, frames=frames, readback_every=rb,
                   seconds=seconds, sampler=sampler,
                   trace_episodes=int(traffic["trace_episodes"])
                   if trace else 0, record_iterations=trace)
    if check_kernel and w.launches != w.frames:
        raise RuntimeError(f"{w.launches} launches of "
                           f"{config['frame_kernel']['id']} in {w.frames} "
                           "frames: the window did not run one a frame")

    dev_info = {"platform": "gpu" if device == "cuda" else device,
                "kind": torch.cuda.get_device_name(0) if device == "cuda"
                else "cpu",
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
                if device == "cuda" else 0}
    e, n = len(mesh["tets"]), len(rest)
    d = rest.shape[1]
    ctx = Context(cell, w, e, n, d)
    if trace:
        ctx.iterations()  # read before the program's state goes
    segs = [check.Segment(p.episode, p.start,
                          tuple(t.cpu().numpy() for t in p.inp),
                          [tuple(t.cpu().numpy() for t in o) for o in p.out])
            for p in sampler.segments()]
    w.iterations = []
    system.close()
    del system
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    gaps, per_frame = check.compare(config, mesh, segs, start,
                                    THREADS_REFERENCE)
    log(f"setup {setup_s:.3f} s (to the build {t_build - t_start:.3f}, "
        f"build {t_warm - t_build:.3f}, warm-up {t_start + setup_s - t_warm:.3f}"
        f"), window {w.seconds:.3f} s ({w.frames} "
        f"frames, {w.episodes} episodes), reference "
        f"{time.perf_counter() - t_ref:.3f} s")
    limits = config["limits"] if limits is None else limits
    correct, _ = check.verdict(gaps, limits)
    failed = sum(1 for g in per_frame if check.over(g, limits))

    if trace:
        from portbench import trace as tr

        metrics = {}
        for m in cell["per_layer"]:
            value = load_reader(m["name"], root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info["busy_s"] = tr.busy_seconds(w.trace)
        dev_info["window_s"] = tr.window_seconds(w.trace)
        breakdown = {"device_ops": tr.device_ops(w.trace),
                     "idle_gaps": tr.idle_by_host(w.trace)}
    else:
        values = {
            "substeps_per_s": w.frames * sim_count / w.seconds,
            "setup_s": setup_s,
            traffic["latency_metric"]: 1e3 * percentile(
                w.latencies, float(traffic["latency_percentile"])),
        }
        metrics = {}
        for m in cell["end_to_end"]:
            if m["name"] not in values:
                raise RuntimeError(f"the harness cannot measure end-to-end "
                                   f"metric {m['name']!r} in this cell")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
        breakdown = None
    result = {"correct": bool(correct),
              "attempted": len(per_frame),
              "failed": failed,
              "metrics": metrics,
              "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["window"] = {"frames": w.frames, "episodes": w.episodes,
                        "seconds": w.seconds, "latency_samples":
                        len(w.latencies), "segments": len(segs),
                        "heavy_frame": heavy}
    result["compared"] = {
        k: {"value": gaps[k] if math.isfinite(gaps[k]) else None,
            "limit": limits[k]} for k in check.NUMBERS}
    result["compared"]["start_equal"] = {"value": gaps["start_equal"],
                                         "limit": 1.0}
    return result


def _check_kernel(config: dict, before: Dict, after: Dict, frames: int):
    """The warm-up episode ran the configuration's whole-frame kernel once a
    frame, in its variant."""
    fk = config["frame_kernel"]
    made = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    made = {k: v for k, v in made.items() if v}
    total = sum(made.values())
    variants = {k[0] if isinstance(k, tuple) else k for k in made}
    if total != frames or variants != {fk["variant"]}:
        raise RuntimeError(
            f"the frame function is not {fk['id']}'s {fk['variant']} variant "
            f"once a frame: {made} launches in {frames} frames")


def main(argv=None, t_start: Optional[float] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs on the GPU only")
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        log(f"{torch.cuda.device_count()} CUDA devices, the cell needs "
            f"{cell['chips']}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      t_start=t_start)
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return 3
    for k, v in result["compared"].items():
        log(f"compared {k} {v['value']} limit {v['limit']}")
    print(json.dumps(result), flush=True)
    return 0
