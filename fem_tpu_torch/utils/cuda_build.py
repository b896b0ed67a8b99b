# coding=utf-8
"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source ``fem_tpu_torch/csrc/<name>.cu`` exports plain C launch functions
(pointers and the stream as ``void*``) and is compiled on first use into its
own shared library::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/fem_tpu_torch/<name>-<hash>.so

The file name carries a hash of the source, of every header of ``csrc/`` it
includes (``#include "<name>.cuh"``, followed recursively) and of the flags,
so an edited kernel or header is rebuilt and a built one is reused.  nvcc writes to a temporary name that is
renamed into place once complete, so concurrent processes never load a
half-written library.  Nothing here falls back: without nvcc the build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "fem_tpu_torch")
SOURCES = (
    "element_chain", "fused_cg", "blocked", "blocked_frame", "explicit_frame",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory report of each library built by this process.
BUILD_LOGS: Dict[str, str] = {}


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of fem_tpu_torch are built from source at first use"
    )


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_files(name: str):
    """``csrc/<name>.cu`` and the ``csrc/`` headers it includes, directly or
    through another header, each once, in the order first reached."""
    files, todo = [], [f"{name}.cu"]
    while todo:
        f = todo.pop(0)
        if f in files:
            continue
        files.append(f)
        with open(os.path.join(CSRC, f), "rb") as fh:
            todo.extend(m.decode() for m in _INCLUDE.findall(fh.read()))
    return files


def library_path(name: str) -> str:
    h = hashlib.sha256()
    for f in source_files(name):
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library of ``names``, one nvcc process per
    source, all started together.  Returns name → library path."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name, out in todo.items():
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
        )
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(build([name])[name])
        _LOADED[name] = lib
    return lib


def check_operand(name: str, t, shape, dtype, device) -> None:
    """Raise unless tensor ``t`` is what a kernel's C interface takes: on
    ``device``, of ``dtype`` and ``shape``, and contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
