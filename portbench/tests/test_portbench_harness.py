# coding=utf-8
"""The harness on the CPU: the JAX import check, the tail and rate
arithmetic, finding a traffic mix and a metric added by file, and the
control and the faults coming out not correct.  The cells themselves run
on the GPU only (``test_portbench_cuda.py``)."""

import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import calibrate, check, harness  # noqa: E402

IMPLICIT = {"frame_backend": "blocked"}  # K5's plain version on the CPU
EXPLICIT = {"frame_backend": "blocked_explicit"}  # K8's


@pytest.fixture(autouse=True)
def _mesh_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("FEM_TPU_MESH_CACHE", str(tmp_path / "mesh"))


def short_cell(name, frames=3, root=ROOT):
    cell = harness.load_cell(name, root)
    cell["config_data"]["episode_frames"] = frames
    cell["traffic_data"]["trace_episodes"] = 1
    return cell


# -- the forbidden modules ------------------------------------------------------

def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(
        ["fem_tpu_torch", "fem_tpu_torch.api", "numpy", "jaxtyping",
         "fem_tpu_tools", "portbench.harness"]) == []
    assert harness.forbidden_modules(["fem_tpu.sim", "os"]) == ["fem_tpu"]
    assert harness.forbidden_modules(
        ["jax", "jaxlib.xla_client", "flax.linen"]) == ["flax", "jax",
                                                        "jaxlib"]


def test_forbidden_module_loaded_is_found(monkeypatch):
    monkeypatch.setitem(sys.modules, "fem_tpu", types.ModuleType("fem_tpu"))
    assert harness.forbidden_modules() == ["fem_tpu"]


def test_a_run_loads_no_jax():
    """The program and the harness, imported and driven for a frame, load
    neither JAX nor the JAX package."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import harness\n"
        "cell = harness.load_cell('cube3d_implicit.offline')\n"
        "cell['config_data']['episode_frames'] = 2\n"
        "harness.run_cell(cell, 5, 0.0, False, device='cpu',\n"
        "    sim_overrides={'frame_backend': 'blocked'}, check_kernel=False,\n"
        "    segments=1)\n"
        "print(harness.forbidden_modules())\n" % ROOT)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_cuda_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "cube3d_implicit.render", "--seed", "3", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


# -- tails and rates ------------------------------------------------------------

def test_percentile_is_nearest_rank_of_all_samples():
    values = list(range(1, 101))
    assert harness.percentile(values, 95) == 95
    assert harness.percentile(values, 50) == 50
    assert harness.percentile([7.0], 95) == 7.0


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _FakeSystem:
    """Each frame costs ``step_s`` of the fake clock (``stall_s`` at frame
    ``stall``), each read back ``read_s``."""

    def __init__(self, clock, step_s=1e-3, read_s=2e-4, stall=None,
                 stall_s=0.03):
        self.clock, self.step_s, self.read_s = clock, step_s, read_s
        self.stall, self.stall_s = stall, stall_s
        self.frames = 0

    def reset(self):
        pass

    def step(self):
        self.clock.t += (self.stall_s if self.frames == self.stall
                         else self.step_s)
        self.frames += 1

    def positions(self):
        self.clock.t += self.read_s

    def launches(self):
        return {("cluster", 16): self.frames}

    def snapshot(self):
        return ()

    def iterations(self):
        return torch.zeros(2, dtype=torch.int32)


@pytest.mark.parametrize("stall", [None, 4])
def test_frame_tail_and_rate(monkeypatch, stall):
    clock = _Clock()
    monkeypatch.setattr(harness.time, "perf_counter", clock)
    system = _FakeSystem(clock, stall=stall)
    w = harness.run_window(system, frames=10, readback_every=1,
                           seconds=0.0, sampler=None)
    assert (w.frames, w.episodes, len(w.latencies)) == (10, 1, 10)
    p95 = harness.percentile(w.latencies, 95)
    # 10 samples: the 95th percentile is the largest, so one stall moves it.
    assert p95 == pytest.approx(1.2e-3 if stall is None else 30.2e-3)
    total = 10 * 1.2e-3 + (0 if stall is None else 29e-3)
    assert w.seconds == pytest.approx(total)
    assert w.launches == 10


def test_episode_tail_counts_every_episode(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(harness.time, "perf_counter", clock)
    system = _FakeSystem(clock, stall=25)
    w = harness.run_window(system, frames=10, readback_every=10,
                           seconds=0.035, sampler=None)
    # Episodes of 10.2 ms (the third has the stall) until 35 ms have passed.
    assert w.episodes == 3 and len(w.latencies) == 3
    assert w.latencies[2] == pytest.approx(9e-3 + 30e-3 + 2e-4)
    assert harness.percentile(w.latencies, 95) == pytest.approx(39.2e-3)


def test_untraced_idle_and_mfu(monkeypatch):
    """The idle share and the whole frame's share of the peak are read over
    the untraced part of the window, with the device time a frame taken
    from the traced episodes."""
    from portbench import trace, work

    w = harness.Window()
    w.frames, w.traced = 500, (100, 300)
    w.untraced_from, w.untraced_seconds = 300, 0.5
    w.trace = object()
    cell = harness.load_cell("cube3d_implicit.render")
    ctx = harness.Context(cell, w, 6, 8, 3)
    monkeypatch.setattr(trace, "busy_seconds", lambda tr: 0.2)
    monkeypatch.setattr(trace, "window_seconds", lambda tr: 0.8)
    ctx._records = ([], 0)
    # 1 ms of device a frame, 200 untraced frames in 0.5 s.
    assert harness.load_reader("device_idle_pct")(ctx) == pytest.approx(60.0)
    ctx._iters = np.zeros((500, 10), np.int64)
    want = 200 * work.frame_ops(6, 8, 3, False, np.zeros(10, np.int64))
    assert harness.load_reader("frame_mfu")(ctx) == pytest.approx(
        100.0 * want / (0.5 * work.PEAK_F32_OPS_PER_S))


def test_sampler_keeps_n_random_and_the_fixed_segments():
    s = harness.Sampler(123, 4, 20, heavy=7)
    for ep in range(50):
        plan = s.plan(ep)
        for f, ps in plan.items():
            assert all(p.episode == ep and p.start == f for p in ps)
    segs = s.segments()
    assert len(segs) == 6
    assert sorted(p.start for p in segs if p is s.fixed["heavy"]) == [7]
    assert s.fixed["first"].start == 0
    again = harness.Sampler(123, 4, 20, heavy=7)
    for ep in range(50):
        again.plan(ep)
    assert ([(p.episode, p.start) for p in again.segments()]
            == [(p.episode, p.start) for p in segs])


# -- found by name --------------------------------------------------------------

def _copy(tmp_path):
    dst = tmp_path / "checkout"
    dst.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(ROOT, "portbench"), dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache",
                                                  "tests"))
    return dst


def test_a_traffic_mix_and_a_metric_added_by_file(tmp_path, monkeypatch):
    dst = _copy(tmp_path)
    (dst / "portbench/traffic/every2.json").write_text(json.dumps({
        "name": "every2", "readback_every": 2,
        "latency_metric": "pair_ms_p95", "latency_percentile": 95,
        "trace_episodes": 1}))
    (dst / "portbench/metrics/frames_traced.py").write_text(
        "def read(ctx):\n"
        "    a, b = ctx.window.traced\n"
        "    return float(b - a)\n")
    spec = json.loads((dst / "BENCHMARK.json").read_text())
    name = "cube3d_implicit.every2"
    spec["workloads"].append({"name": name, "config": "cube3d_implicit",
                              "traffic": "every2", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"].append({"name": "pair_ms_p95", "unit": "ms",
                               "better": "lower", "bound": 0.1,
                               "source": "host_clock", "workloads": [name]})
    spec["per_layer"].append({"name": "frames_traced", "unit": "frames",
                              "better": "higher", "source": "host_clock",
                              "layer": "a test", "moves": "pair_ms_p95",
                              "workloads": [name]})
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.chdir(dst)
    cell = short_cell(name, frames=4, root=dst)
    assert cell["traffic_data"]["readback_every"] == 2
    r = harness.run_cell(cell, 9, 0.0, False, device="cpu",
                         sim_overrides=IMPLICIT, check_kernel=False,
                         segments=1)
    assert set(r["metrics"]) == {"pair_ms_p95", "setup_s"}
    assert r["window"]["latency_samples"] == 2
    assert r["correct"]
    t = harness.run_cell(cell, 9, 0.0, True, device="cpu",
                         sim_overrides=IMPLICIT, check_kernel=False,
                         segments=1)
    assert t["metrics"]["frames_traced"]["value"] == 4.0
    assert list(t)[-1] == "compared"


# -- correct, and not -----------------------------------------------------------

@pytest.mark.parametrize("name,over", [("cube3d_implicit.render", IMPLICIT),
                                       ("cube3d_explicit.render", EXPLICIT)])
def test_program_is_correct(name, over):
    """A whole episode, the cell's own size, on K5's and K8's plain
    versions."""
    r = harness.run_cell(harness.load_cell(name), 2**31 + 11, 0.0, False,
                         device="cpu", sim_overrides=over,
                         check_kernel=False, segments=2)
    assert r["correct"], r["compared"]
    assert r["attempted"] == 8 and r["failed"] == 0
    assert list(r)[-1] == "compared"


@pytest.mark.parametrize("kind", ["control", "unchanged", "altered"])
@pytest.mark.parametrize("name,over", [("cube3d_implicit.render", IMPLICIT),
                                       ("cube3d_explicit.render", EXPLICIT)])
def test_control_and_faults_are_not_correct(kind, name, over):
    """A whole episode: in the free fall alone the cube barely deforms, and
    the control's bfloat16 chain reads little there."""
    cell = harness.load_cell(name)
    r = calibrate.reading(cell, kind, 77, device="cpu", sim_overrides=over,
                          segments=2)
    assert not r["correct_at_limits"], r
    limits = cell["config_data"]["limits"]
    assert check.over({k: r[k] if r[k] is not None else float("inf")
                       for k in check.NUMBERS}, limits)
