# coding=utf-8
"""Output and persistence: deformed-OBJ export and checkpoint/resume.

The port of the JAX package's ``utils/io.py``.  OBJ export mirrors the
reference (object.py:322-335): the deformed particle positions copied onto
the original surface mesh through the nearest-vertex map, written as a
Wavefront OBJ.  A checkpoint is one ``.npz`` in the JAX package's format,
so that a checkpoint written by either package loads into the other:
``n_bodies``, ``step``, ``virtual_time``, ``ply_cnt`` and, per body i,
``b{i}_<field>`` for ``pos``, ``vel``, ``vel_g``, ``force`` and
``jacobi_past_x``, plus ``plastic_inv`` and ``viscous_inv`` when the body
has them.  The legacy single-body format (flat keys, no ``n_bodies``) is
read too.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch

from fem_tpu_torch.models.state import SimState
from fem_tpu_torch.utils.device import resolve_device

STATE_FIELDS = ("pos", "vel", "vel_g", "force", "jacobi_past_x")
# The inelastic internal inverses: written only when present; absent keys
# load as None.
OPTIONAL_STATE_FIELDS = ("plastic_inv", "viscous_inv")


def to_numpy(t) -> np.ndarray:
    """A host numpy array of a tensor (a device read for a CUDA one)."""
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def export_deformed_obj(
    file_name: str,
    pos,
    obj_vertices: np.ndarray,
    obj_faces: np.ndarray,
    map_index: np.ndarray,
) -> None:
    """Write the original OBJ with its vertices moved to the deformed
    positions of their mapped tet-mesh particles (object.py:322-335)."""
    verts = to_numpy(pos)[map_index]
    with open(file_name, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for face in np.asarray(obj_faces) + 1:
            f.write(f"f {face[0]} {face[1]} {face[2]}\n")


def save_checkpoint(path: str, state: SimState, step: int,
                    virtual_time: float) -> None:
    """Single-body checkpoint (the library API); the CLI writes
    :func:`save_scene_checkpoint`'s multi-body format, which this is."""
    save_scene_checkpoint(path, [state], step, virtual_time)


def load_checkpoint(path: str, device="cuda") -> Tuple[SimState, int, float]:
    states, step, virtual_time, _ = load_scene_checkpoint(path, device)
    return states[0], step, virtual_time


def save_scene_checkpoint(path: str, states: List[SimState], step: int,
                          virtual_time: float, ply_cnt: int = 0) -> None:
    """Checkpoint every body's state (bodies differ in particle count, so
    each array sits under its body's keys ``b{i}_pos`` and so on) and the
    CLI's counters a bit-identical continuation needs: the frame index,
    ``virtual_time`` and the OBJ-export counter.  A ``jacobi_past_x`` of
    None is written as the zeros it stands for."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {"n_bodies": np.int64(len(states)),
              "step": np.int64(step),
              "virtual_time": np.float64(virtual_time),
              "ply_cnt": np.int64(ply_cnt)}
    for i, state in enumerate(states):
        for field in STATE_FIELDS:
            val = getattr(state, field)
            if val is None:
                val = torch.zeros_like(state.pos)
            arrays[f"b{i}_{field}"] = to_numpy(val)
        for field in OPTIONAL_STATE_FIELDS:
            val = getattr(state, field)
            if val is not None:
                arrays[f"b{i}_{field}"] = to_numpy(val)
    np.savez(path, **arrays)


def load_scene_checkpoint(
    path: str, device="cuda",
) -> Tuple[List[SimState], int, float, int]:
    """(states, step, virtual_time, ply_cnt) of a checkpoint written by
    :func:`save_scene_checkpoint` or by the JAX package, on ``device``;
    also reads the legacy single-body flat-key format (its ``ply_cnt`` is
    0, and a missing ``jacobi_past_x`` loads as zeros)."""
    dev = resolve_device(device)
    data = np.load(path)

    def state(prefix: str) -> SimState:
        fields = {}
        for f in STATE_FIELDS + OPTIONAL_STATE_FIELDS:
            if prefix + f in data:
                fields[f] = torch.as_tensor(data[prefix + f], device=dev)
        if "jacobi_past_x" not in fields:
            fields["jacobi_past_x"] = torch.zeros_like(fields["pos"])
        return SimState(**fields)

    if "n_bodies" in data:
        states = [state(f"b{i}_") for i in range(int(data["n_bodies"]))]
        ply_cnt = int(data["ply_cnt"]) if "ply_cnt" in data else 0
    else:
        states = [state("")]
        ply_cnt = 0
    return states, int(data["step"]), float(data["virtual_time"]), ply_cnt
