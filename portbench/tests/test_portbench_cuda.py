# coding=utf-8
"""The cells on the GPU (marker ``cuda``; each test skips without a CUDA
device):

    python -m pytest -p no:cacheprovider -m cuda portbench/tests
"""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in json.load(
    open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _run(cwd, cell, trace=0, seed=2**31 + 7):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", "1", "--trace", str(trace)],
        capture_output=True, text=True, cwd=cwd, timeout=1200)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(cell):
    _require_cuda()
    out = _run(ROOT, cell)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["compared"]
    assert r["device"]["platform"] == "gpu"
    want = {m["name"] for m in harness.load_cell(cell)["end_to_end"]}
    assert set(r["metrics"]) == want


def test_without_the_program_a_run_fails(tmp_path):
    _require_cuda()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = _run(tmp_path, CELLS[0])
    assert out.returncode != 0
    assert out.stdout.strip() == ""
