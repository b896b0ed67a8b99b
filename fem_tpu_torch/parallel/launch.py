# coding=utf-8
"""A launcher of ``torch.distributed`` ranks as child processes of one
program: the CPU ranks of the tests and of ``entry.dryrun_multichip``, and
the two ranks on one card of ``chip_smoke.py``.

:func:`start_ranks` starts ``world`` processes, ``python -m
fem_tpu_torch.parallel.launch``, each of which joins one process group
(``backend``, a file-store rendezvous in a new temporary directory, never a
fixed port, and a ``timeout``), calls ``fn(rank, world, *args)`` and writes
what it returns, pickled, for the parent; :meth:`Ranks.results` waits for
them and returns their results in rank order, or raises with the failed
rank's output.  ``fn`` is a module-level function, named by its module and
name, so that a rank imports only ``fn``'s module and what it imports.
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time


class Ranks:
    """The running ranks of one :func:`start_ranks` call."""

    def __init__(self, procs, tmp: str, world: int, deadline: float):
        self.procs, self.tmp, self.world = procs, tmp, world
        self.deadline = deadline

    def _output(self, rank: int) -> str:
        with open(os.path.join(self.tmp, f"rank{rank}.log"),
                  errors="replace") as f:
            return f.read()[-8000:]

    def stop(self) -> None:
        """Kill every rank still running and remove the directory."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()
        shutil.rmtree(self.tmp, ignore_errors=True)

    def results(self) -> list:
        """Wait for every rank (until the deadline) and return what each
        returned, in rank order.  A rank that fails, or the deadline
        passing, stops them all and raises ``RuntimeError`` with the
        output of the first rank that failed."""
        try:
            while True:
                codes = [p.poll() for p in self.procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    raise RuntimeError(
                        f"rank {bad[0]} of {self.world} exited with "
                        f"{codes[bad[0]]}:\n{self._output(bad[0])}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > self.deadline:
                    raise RuntimeError(
                        f"ranks still running at the deadline: "
                        f"{[r for r, c in enumerate(codes) if c is None]}"
                        f"\n{self._output(codes.index(None))}")
                time.sleep(0.05)
            out = []
            for r in range(self.world):
                with open(os.path.join(self.tmp, f"rank{r}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            self.stop()


def _import_root(module) -> str:
    """The directory that ``module``'s top-level package sits in."""
    path = os.path.abspath(module.__file__)
    for _ in module.__name__.split("."):
        path = os.path.dirname(path)
    if os.path.basename(module.__file__) == "__init__.py":
        path = os.path.dirname(path)
    return path


def start_ranks(fn, world: int, args=(), backend: str = "gloo",
                timeout: float = 300.0, threads: int = 1,
                pg_timeout: float = 120.0) -> Ranks:
    """Start ``world`` ranks running ``fn(rank, world, *args)`` in one
    ``backend`` process group (``pg_timeout`` seconds on every collective),
    each with ``threads`` intra-op threads; :meth:`Ranks.results` collects
    them, at most ``timeout`` seconds from now."""
    if fn.__module__ == "__main__":
        raise ValueError("a rank function must live in an importable module, "
                         "not in __main__")
    module = sys.modules[fn.__module__]
    tmp = tempfile.mkdtemp(prefix="fem_tpu_torch_ranks_")
    spec = dict(module=fn.__module__, name=fn.__qualname__, world=world,
                args=args, backend=backend, threads=threads,
                pg_timeout=pg_timeout, store=os.path.join(tmp, "store"))
    with open(os.path.join(tmp, "spec.pkl"), "wb") as f:
        pickle.dump(spec, f)
    here = sys.modules[__name__]
    roots = [_import_root(module), _import_root(here)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        roots + [p for p in [env.get("PYTHONPATH")] if p])
    env["OMP_NUM_THREADS"] = str(threads)
    procs = []
    for rank in range(world):
        log = open(os.path.join(tmp, f"rank{rank}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "fem_tpu_torch.parallel.launch", tmp,
             str(rank)], env=env, stdout=log, stderr=subprocess.STDOUT))
        log.close()
    return Ranks(procs, tmp, world, time.monotonic() + timeout)


def run_ranks(fn, world: int, args=(), **kw) -> list:
    """:func:`start_ranks` and wait: the ranks' results in rank order."""
    return start_ranks(fn, world, args, **kw).results()


def _rank_main(tmp: str, rank: int) -> None:
    import torch
    import torch.distributed as dist

    with open(os.path.join(tmp, "spec.pkl"), "rb") as f:
        spec = pickle.load(f)
    torch.set_num_threads(spec["threads"])
    world = spec["world"]
    dist.init_process_group(
        spec["backend"], store=dist.FileStore(spec["store"], world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=spec["pg_timeout"]))
    try:
        fn = importlib.import_module(spec["module"])
        for part in spec["name"].split("."):
            fn = getattr(fn, part)
        result = fn(rank, world, *spec["args"])
    finally:
        dist.destroy_process_group()
    path = os.path.join(tmp, f"rank{rank}.pkl")
    with open(path + ".part", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".part", path)


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
