# coding=utf-8
"""The work a frame needs, and the H100's peaks: the yardstick of the
roofline and MFU readers.

The counts are of the work the method needs, whatever kernel or layout
implements it: per element and per particle of the mesh, the CG iterations
the frame ran, each input read once and each output written once.  The
per-element chains are counted from their formulas (the implicit chain: F,
det, F⁻¹, the K and force products, the logs and the −V scaling; the
explicit chain: F, det, F⁻¹, the log, P, P·R⁻ᵀ and the +V scaling) and the
particle steps likewise (the implicit advection and the explicit kinematic
step with one circle).  An element's contribution rows are the vertex-0 row
(−Σ of d columns, d·(d−1) adds) and the scatter of its d+1 rows into their
particles, (d+1)·d adds.  A G(K)·x apply is the edge differences (d·d), the
d×d product K·S (d·d·(2d−1)) and the rows.
"""

from __future__ import annotations

from typing import Iterable

# NVIDIA H100 SXM data sheet: dense float32 outside the tensor cores, and
# HBM3 bandwidth, at the 700 W limit.
PEAK_F32_OPS_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12

# f32 operations per element (chain, grad) and per particle (advect,
# kinematic), by dimension.
OPS = {
    3: dict(chain=430, grad=200, advect=40, kinematic=40),
    2: dict(chain=136, grad=60, advect=27, kinematic=27),
}
F32 = 4  # bytes of a float32 or an int32


def rows(d: int) -> int:
    """Adds of an element's contribution rows: the vertex-0 row and the
    scatter of its d+1 rows."""
    return d * (d - 1) + (d + 1) * d


def apply_ops(d: int) -> int:
    """Operations of one element's part of G(K)·x."""
    return d * d + d * d * (2 * d - 1) + rows(d)


def implicit_substep_ops(e: int, n: int, d: int, iterations: int) -> int:
    """One implicit substep that ran ``iterations`` CG iterations on the
    normal equations: the chain and force rows, the rhs (4·d a particle),
    3 + 2·iterations applies of A or Aᵀ (each G(K)·x and 4·d a particle),
    the CG's vector work (10·d a particle an iteration) and the advection."""
    applies = 3 + 2 * iterations
    return ((OPS[d]["chain"] + rows(d)) * e + 4 * d * n
            + applies * (apply_ops(d) * e + 4 * d * n)
            + iterations * 10 * d * n + OPS[d]["advect"] * n)


def explicit_substep_ops(e: int, n: int, d: int) -> int:
    """One explicit substep: the gradient chain and rows of every element and
    the kinematic step of every particle."""
    return (OPS[d]["grad"] + rows(d)) * e + OPS[d]["kinematic"] * n


def frame_ops(e: int, n: int, d: int, explicit: bool,
              iterations: Iterable[int]) -> int:
    """One frame: ``iterations`` holds each substep's CG iterations (zeros,
    one a substep, on the explicit method)."""
    if explicit:
        return sum(explicit_substep_ops(e, n, d) for _ in iterations)
    return sum(implicit_substep_ops(e, n, d, int(it)) for it in iterations)


def frame_bytes(e: int, n: int, d: int, explicit: bool, sim_count: int,
                obstacles: int) -> int:
    """One frame's inputs read once and outputs written once: the state
    (positions, velocities and, implicit, the gravity channel) in and out,
    the masses, the elements' indices, R⁻¹ and volumes, the circles, and on
    the implicit method each substep's iterations and residual."""
    channels = 2 if explicit else 3
    inputs = (channels * n * d + n + e * (d + 1) + e * d * d + e
              + obstacles * (d + 1))
    outputs = channels * n * d + (0 if explicit else 2 * sim_count)
    return F32 * (inputs + outputs)


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations over
    the f32 peak and the bytes over the bandwidth."""
    return max(ops / PEAK_F32_OPS_PER_S, nbytes / PEAK_BYTES_PER_S)
