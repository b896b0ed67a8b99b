# coding=utf-8
"""The comparison that decides ``correct``.

The window keeps, for a sample of two-frame segments drawn from the seed
(``harness.Sampler``), the program's state before the segment and after each
of its two frames.  Once the window has closed, the plain reference
(``reference/fem.py``, float64 on the host) runs each segment's two frames
from the segment's input state, carrying its own state from the first frame
to the second, and the widest gaps to the program's outputs are the numbers
compared:

* ``pos_gap_m``: the largest |x_program − x_reference| of any particle and
  coordinate, in metres;
* ``vel_gap_mps``: the same of the velocity channels (v and, on the implicit
  method, the gravity channel v_g), in metres a second.

A segment that starts at the episode's first frame starts the reference from
the state the harness made from the seed, and the program's own input there
must equal it bit for bit.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from portbench.reference import fem

NUMBERS = ("pos_gap_m", "vel_gap_mps")


class Segment(NamedTuple):
    episode: int
    start: int  # the segment's first frame
    inp: tuple  # (pos, vel, vel_g) before frame ``start``, numpy
    out: List[tuple]  # after frame start and start + 1


def reference_scene(config: dict, rest: np.ndarray, tets: np.ndarray,
                    dtype=torch.float64, device="cpu"):
    """(fem.Body, fem.Scene) of a configuration, from its rest positions,
    its elements and its settings alone."""
    sim = config["sim"]
    ob = sim["objects"][0]
    body = fem.make_body(rest, tets, float(ob["rho"]), float(ob["E"]),
                         float(ob["nu"]), float(ob["damping"]), dtype, device)
    d = rest.shape[1]
    blocks = sim.get("blocks", [])
    scene = fem.Scene(
        dt=float(sim["delta_time"]),
        sim_count=int(sim["sim_count"]),
        gravity=9.8 * torch.tensor(sim["g_dir"], dtype=dtype, device=device),
        centers=torch.tensor([b["block_center"] for b in blocks],
                             dtype=dtype, device=device).reshape(-1, d),
        radii=torch.tensor([b["block_radius"] for b in blocks], dtype=dtype,
                           device=device),
        explicit=bool(sim.get("use_explicit_method") or sim.get("auto_diff")),
    )
    return body, scene


def rest_positions(config: dict, mesh: dict) -> np.ndarray:
    """The body's rest positions as float32: the mesh's nodes plus the
    object's center."""
    center = np.asarray(config["sim"]["objects"][0]["center"], np.float32)
    return np.asarray(mesh["nodes"], np.float32) + center


def _gap(a, b) -> float:
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d.max()) if np.all(np.isfinite(d)) else math.inf


def compare(config: dict, mesh: dict, segments: List[Segment],
            start: tuple, threads: Optional[int] = None):
    """(the widest gaps over the segments, each compared frame's gaps):
    ``inf`` where the program's output is not finite, and ``start_equal``
    0 when a segment's input at frame 0 differs from ``start``."""
    if threads:
        torch.set_num_threads(threads)
    body, scene = reference_scene(config, rest_positions(config, mesh),
                                  mesh["tets"])
    gaps = {k: 0.0 for k in NUMBERS}
    gaps["start_equal"] = 1.0
    frames = []
    for seg in segments:
        inp = seg.inp
        if seg.start == 0:
            if not all(np.array_equal(a, b) for a, b in zip(inp, start)):
                gaps["start_equal"] = 0.0
            inp = start
        s = fem.State(*(torch.as_tensor(np.asarray(t, np.float64))
                        for t in inp))
        for out in seg.out:
            s, _ = fem.frame(body, scene, s)
            g = {"pos_gap_m": _gap(out[0], s.pos),
                 "vel_gap_mps": max(_gap(out[1], s.vel),
                                    _gap(out[2], s.vel_g))}
            frames.append(g)
            for k in NUMBERS:
                gaps[k] = max(gaps[k], g[k])
    return gaps, frames


def over(gaps: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    """The numbers of ``gaps`` that are not finite or exceed their limit."""
    return [k for k in NUMBERS
            if not (math.isfinite(gaps[k]) and gaps[k] <= limits[k])]


def verdict(gaps: Dict[str, float], limits: Dict[str, float]):
    """(correct, failed numbers): every number finite and at or under its
    limit, and the program's start equal to the harness's."""
    failed = over(gaps, limits)
    if gaps.get("start_equal", 1.0) != 1.0:
        failed.append("start_equal")
    return not failed, failed
