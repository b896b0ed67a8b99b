# coding=utf-8
"""Run one cell of the benchmark of fem_tpu_torch on this machine's GPU:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints one JSON line (the last line of
standard output); see ``portbench/harness.py``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The mesher's cache at a fixed path inside the checkout.
os.environ["FEM_TPU_MESH_CACHE"] = os.path.join(ROOT, "portbench", ".cache",
                                                "mesh")
sys.path.insert(0, ROOT)

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
