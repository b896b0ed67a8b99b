# coding=utf-8
"""Conversion between plain numpy arrays and the port's state objects.

The JAX package's ``FemObject``/``SimState`` fields, handed over as a dict of
numpy arrays plus the static scalars, become the port's objects here — so both
packages can compute on exactly the same data.  The assembly plan is rebuilt
from ``element_indices`` (the same host algorithm as the JAX package's
``build_gather_plan``), and so are the locality blocks, from
``element_indices``, ``ref_inv``, ``volume`` and ``rest_pos`` (the same
partition as the JAX package's ``build_blocking``).  Only numpy crosses this
boundary.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from fem_tpu_torch.models.state import FemObject, SimState
from fem_tpu_torch.ops.assembly import make_gather_plan
from fem_tpu_torch.ops.blocking import build_blocking
from fem_tpu_torch.ops.element import check_material
from fem_tpu_torch.utils.device import resolve_device

OBJECT_ARRAYS = ("element_indices", "ref_inv", "volume", "mass", "rest_pos", "faces")
OBJECT_STATICS = (
    "dim", "particle_cnt", "element_cnt", "mesh_cnt", "mu", "s_lambda",
    "damping", "rho", "material", "plastic_yield", "viscous_mu",
    "viscous_tau",
)
# Static fields of the JAX package's FemObject that select features this
# slice does not port; each must hold its default value.
UNPORTED_STATICS = {
    "damping_beta": (0.0, "Rayleigh damping_beta", "M13"),
}
STATE_ARRAYS = ("pos", "vel", "vel_g", "force")
# The inelastic internal inverses: optional (absent or None when off).
INTERNAL_ARRAYS = ("plastic_inv", "viscous_inv")

_INT_ARRAYS = ("element_indices", "faces")


def object_from_arrays(
    arrays: Dict[str, np.ndarray], statics: Dict[str, object], device="cuda"
) -> FemObject:
    """A :class:`FemObject` from ``arrays`` (the names of ``OBJECT_ARRAYS``)
    and ``statics`` (the names of ``OBJECT_STATICS`` — the three inelastic
    ones optional, at their defaults when absent — plus optionally the keys
    of ``UNPORTED_STATICS`` at their defaults)."""
    dev = resolve_device(device)
    for key, (default, what, item) in UNPORTED_STATICS.items():
        if statics.get(key, default) != default:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP {item})"
            )
    check_material(statics["material"])
    tensors = {}
    for name in OBJECT_ARRAYS:
        a = np.asarray(arrays[name])
        a = a.astype(np.int32 if name in _INT_ARRAYS else np.float32)
        tensors[name] = torch.tensor(a, device=dev)
    idx = np.asarray(arrays["element_indices"]).astype(np.int32)
    plan = make_gather_plan(idx, int(statics["particle_cnt"]), dev)
    blocking = build_blocking(
        idx, arrays["ref_inv"], arrays["volume"],
        np.asarray(arrays["rest_pos"], np.float32), device=dev,
    )
    return FemObject(
        **tensors, plan=plan, blocking=blocking,
        **{k: statics[k] for k in OBJECT_STATICS if k in statics},
    )


def object_to_arrays(obj: FemObject):
    """(arrays, statics) of ``obj`` — the inverse of
    :func:`object_from_arrays`."""
    arrays = {n: getattr(obj, n).cpu().numpy() for n in OBJECT_ARRAYS}
    statics = {n: getattr(obj, n) for n in OBJECT_STATICS}
    return arrays, statics


def state_from_arrays(arrays: Dict[str, np.ndarray], device="cuda") -> SimState:
    """A :class:`SimState` from the arrays of ``STATE_ARRAYS`` and those of
    ``INTERNAL_ARRAYS`` that ``arrays`` holds and are not None."""
    dev = resolve_device(device)
    names = STATE_ARRAYS + tuple(
        n for n in INTERNAL_ARRAYS if arrays.get(n) is not None
    )
    return SimState(
        **{
            n: torch.tensor(np.asarray(arrays[n], np.float32), device=dev)
            for n in names
        }
    )


def state_to_arrays(state: SimState) -> Dict[str, np.ndarray]:
    """The inverse of :func:`state_from_arrays`: internal inverses that are
    None are left out."""
    out = {n: getattr(state, n).cpu().numpy() for n in STATE_ARRAYS}
    for n in INTERNAL_ARRAYS:
        if getattr(state, n) is not None:
            out[n] = getattr(state, n).cpu().numpy()
    return out


def to_dtype(x, dtype: torch.dtype):
    """A copy of a dataclass of tensors — ``FemObject``, ``SimState``,
    ``Obstacles``, ``Blocking`` — whose floating tensors, nested ones
    included, are of ``dtype`` (for example float64, to check semantics
    against a float64 reference on the plain path; the CUDA kernels take
    float32 only)."""
    changes = {}
    for field in dataclasses.fields(x):
        v = getattr(x, field.name)
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            changes[field.name] = v.to(dtype)
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            changes[field.name] = to_dtype(v, dtype)
    return dataclasses.replace(x, **changes)
