# coding=utf-8
"""Observability: profiler trace, throughput meter, NaN guard and metrics.

The port of the JAX package's ``utils/profiling.py``.  The reference's only
tracing is Taichi's kernel profiler with its prints commented out
(main.py:40,114-115), and its only failure detection is a determinant clamp
and the Jacobi rollback.  Here: a ``torch.profiler`` trace written as a
Chrome trace, a steps/s meter, per-frame physics metrics computed on the
state's device, and a guard that raises when the state diverges.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, NamedTuple

import torch

from fem_tpu_torch.models.state import FemObject, SimState
from fem_tpu_torch.ops import smallmat as sm
from fem_tpu_torch.ops.element import deformation_gradients, total_energy


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the block's CPU and, when a GPU is present, CUDA activity
    with ``torch.profiler``, and write it to ``log_dir/trace.json`` (a
    Chrome trace: chrome://tracing or Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepsMeter:
    """Steps/s counter for stepping loops (in place of the reference's
    commented-out profiler prints, main.py:114-115)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.steps = 0

    def add(self, n: int) -> None:
        self.steps += n

    @property
    def steps_per_s(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.steps / dt if dt > 0 else float("inf")


class FrameMetrics(NamedTuple):
    """Per-frame physics diagnostics."""

    elastic_energy: float
    kinetic_energy: float
    min_det_f: float
    max_speed: float
    any_nan: bool


def _metrics(obj: FemObject, state: SimState) -> torch.Tensor:
    """(U, KE, min det F, max speed, diverged) as one (5,) float32 tensor
    on the state's device."""
    f = deformation_gradients(state.pos, obj.element_indices, obj.ref_inv)
    det = sm.det(f)
    u = total_energy(state.pos, obj.element_indices, obj.ref_inv, obj.volume,
                     obj.mu, obj.s_lambda, obj.material)
    v = state.vel + state.vel_g
    v2 = (v * v).sum(dim=-1)
    ke = 0.5 * (obj.mass * v2).sum()
    # The divergence flag reads the whole kinematic state, not positions
    # alone: a stalling solver can blow velocities and energy up while the
    # positions stay representable for a while.
    bad = (~torch.isfinite(state.pos).all() | ~torch.isfinite(v).all()
           | ~torch.isfinite(u) | (det.abs().max() > 1e3))
    return torch.stack([u, ke, det.min(), torch.sqrt(v2.max()),
                        bad.to(u.dtype)]).float()


def frame_metrics(obj: FemObject, state: SimState) -> FrameMetrics:
    """Structured per-frame stats, computed on the state's device and read
    back as one (5,) tensor per call."""
    u, ke, min_det, speed, bad = _metrics(obj, state).tolist()
    return FrameMetrics(
        elastic_energy=u,
        kinetic_energy=ke,
        min_det_f=min_det,
        max_speed=speed,
        any_nan=bool(bad),
    )


class SimulationDiverged(RuntimeError):
    pass


def check_state(obj: FemObject, state: SimState, step: int) -> FrameMetrics:
    """The NaN guard: raise :class:`SimulationDiverged`, with diagnostics,
    when the state diverged (the reference silently NaNs)."""
    m = frame_metrics(obj, state)
    if m.any_nan:
        bad = int((~torch.isfinite(state.pos)).sum())
        raise SimulationDiverged(
            f"non-finite positions at step {step}: {bad} bad entries, "
            f"min det F = {m.min_det_f:.3e} (inverted element?), "
            f"max speed = {m.max_speed:.3e}"
        )
    return m
