# coding=utf-8
"""Build the port's CUDA kernels with nvcc, load them with ctypes, and
call their launch functions on the current stream.

Each source ``fem_tpu_torch/csrc/<name>.cu`` exports plain C launch functions
(pointers and the stream as ``void*``) and is compiled on first use into
shared libraries::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v [-DFEM_MATERIAL=<m>] \\
         -o build/fem_tpu_torch/<name>[-m<m>]-<hash>.so

The material-dependent sources (``MATERIAL_SOURCES``) are built once per
material instance m (``fem::Material``, csrc/element_chain.cuh): each such
library holds that material's template instances only, so that the many
instances of the whole-frame kernels compile in parallel processes rather
than in one.  A library is keyed by (name, material).  Its file name
carries a hash of the source, of every header of ``csrc/`` it includes
(``#include "<name>.cuh"``, followed recursively) and of the flags, the
material's define included, so an edited kernel or header is rebuilt and a
built one is reused.  nvcc writes to a temporary name that is renamed into
place once complete, so concurrent processes never load a half-written
library.  Nothing here falls back: without nvcc the build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "fem_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# fem::Material ids: the seven base materials and robust Neo-Hookean
# (ops/element.py: MATERIAL_IDS, ROBUST_NEO_HOOKEAN_ID).
_MATERIALS = tuple(range(8))
_ROBUST = 7
# Sources built per material; the explicit ones have no robust instance.
MATERIAL_SOURCES = {
    "element_chain": _MATERIALS,
    "blocked": _MATERIALS,
    "blocked_frame": _MATERIALS,
    "explicit_frame": tuple(m for m in _MATERIALS if m != _ROBUST),
}
Key = Tuple[str, Optional[int]]
# Every library of the port, as (source name, material or None).
LIBRARIES: Tuple[Key, ...] = tuple(
    (name, None) for name in ("fused_cg", "advect", "edge_cg", "fused_frame",
                              "probe_pairblock", "probe_int8",
                              "jacobi_serial", "contact_pairs",
                              "contact_grid", "stiffness_apply")) + tuple(
    (name, m) for name, ms in MATERIAL_SOURCES.items() for m in ms)

_LOADED: Dict[Key, ctypes.CDLL] = {}
# ptxas register / shared-memory report, and the seconds from the build's
# start to the library's completion and nvcc's CPU seconds, of each library
# built by this process, by label ``name`` or ``name-m<m>``.
BUILD_LOGS: Dict[str, str] = {}
BUILD_SECONDS: Dict[str, Tuple[float, float]] = {}


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


def label(key: Key) -> str:
    name, material = key
    return name if material is None else f"{name}-m{material}"


def _flags(key: Key):
    _, material = key
    return NVCC_FLAGS + (() if material is None
                         else (f"-DFEM_MATERIAL={material}",))


def library_path(key: Key) -> str:
    name, _ = key
    h = hashlib.sha256()
    for f in source_files(name):
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    h.update(" ".join(_flags(key)).encode())
    return os.path.join(BUILD_DIR, f"{label(key)}-{h.hexdigest()[:16]}.so")


def _check_key(key: Key) -> None:
    name, material = key
    allowed = MATERIAL_SOURCES.get(name)
    if (allowed is None and material is not None) or (
            allowed is not None and material not in allowed):
        raise ValueError(f"no library {label(key)} "
                         f"(material-dependent sources: {MATERIAL_SOURCES})")


def build(keys: Iterable[Key] = LIBRARIES) -> Dict[Key, str]:
    """Compile every missing library of ``keys``, one nvcc process per
    library, all started together.  Returns key → library path."""
    keys = list(keys)
    for key in keys:
        _check_key(key)
    paths = {k: library_path(k) for k in keys}
    todo = {k: p for k, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for key, out in todo.items():
        tmp = f"{out}.{os.getpid()}.tmp"
        log_path = f"{tmp}.log"
        cmd = [nvcc, *_flags(key), "-o", tmp,
               os.path.join(CSRC, f"{key[0]}.cu")]
        with open(log_path, "w") as log:
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        jobs.append((key, proc, tmp, log_path))

    def reap(key, proc):
        # wait4 gives the CPU seconds of nvcc and the tools it ran.
        _, status, usage = os.wait4(proc.pid, 0)
        proc.returncode = os.waitstatus_to_exitcode(status)
        BUILD_SECONDS[label(key)] = (time.perf_counter() - t0,
                                     usage.ru_utime + usage.ru_stime)

    threads = [threading.Thread(target=reap, args=(k, p)) for k, p, _, _ in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed = []
    for key, proc, tmp, log_path in jobs:
        with open(log_path) as fh:
            log = fh.read()
        os.remove(log_path)
        BUILD_LOGS[label(key)] = log
        if proc.returncode != 0:
            failed.append(f"{label(key)} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, todo[key])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str, material: Optional[int] = None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (of one material's
    instances for a material-dependent source), built if needed."""
    key = (name, material)
    lib = _LOADED.get(key)
    if lib is None:
        lib = ctypes.CDLL(build([key])[key])
        _LOADED[key] = lib
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


def launch_on_stream(dev, index, call, *args) -> int:
    """``call(*args, stream)`` with ``dev``'s current stream as ``stream``,
    entering ``torch.cuda.device(dev)`` only when the current device is not
    ``index``; returns what ``call`` returns (a C entry's error code)."""
    if torch.cuda.current_device() == index:
        return call(*args, torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        return call(*args, torch.cuda.current_stream(dev).cuda_stream)
