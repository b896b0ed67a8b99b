# coding=utf-8
"""Conversion between plain numpy arrays and the port's state objects.

The JAX package's ``FemObject``/``SimState`` fields, handed over as a dict of
numpy arrays plus the static scalars, become the port's objects here — so both
packages can compute on exactly the same data.  The assembly plan is rebuilt
from ``element_indices`` (the same host algorithm as the JAX package's
``build_gather_plan``), and so are the locality blocks, from
``element_indices``, ``ref_inv``, ``volume`` and ``rest_pos`` (the same
partition as the JAX package's ``build_blocking``).  The pins' and loads'
arrays (``free_mask``, ``pin_vel``, ``static_load``) and the edge matrix of
``operator_mode="mxu"`` (``edge_matrix``) are optional, None when off, and
so are the typed obstacles' arrays of :class:`Obstacles`.  The serial
Jacobi sweep's plan is rebuilt from ``element_indices`` too (the same host
algorithm as the JAX package's ``build_jacobi_plan``), and the state's
``jacobi_past_x`` crosses with the state, zero when absent.  The coarse
space of the two-level preconditioner (``agg_ids``, ``agg_basis``) crosses
when given and is built from ``rest_pos`` otherwise (the same host
algorithm as the JAX package's ``build_aggregates``); ``num_aggregates``
is its largest id + 1.  A batched
state (the JAX package's ``batch.py``: every field with a leading B axis)
crosses through the same two functions, its axis kept.  A contact plan
(``contact.ContactPlan``) crosses as the JAX package's plan fields
(``CONTACT_PLAN_FIELDS``), the self-contact masks as booleans.  A modal
basis (``solvers/modal.ModalResult``) crosses as its four arrays
(``MODAL_FIELDS``).  Only numpy crosses this boundary.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from fem_tpu_torch.contact import ContactPlan
from fem_tpu_torch.models.state import (
    FemObject,
    Obstacles,
    SimState,
    coarse_arrays,
    jacobi_arrays,
)
from fem_tpu_torch.ops.assembly import make_gather_plan
from fem_tpu_torch.ops.blocking import build_blocking
from fem_tpu_torch.ops.contact_kernels import pair_tables
from fem_tpu_torch.ops.element import check_material
from fem_tpu_torch.utils.device import resolve_device

OBJECT_ARRAYS = ("element_indices", "ref_inv", "volume", "mass", "rest_pos", "faces")
OBJECT_STATICS = (
    "dim", "particle_cnt", "element_cnt", "mesh_cnt", "mu", "s_lambda",
    "damping", "rho", "material", "plastic_yield", "viscous_mu",
    "viscous_tau", "damping_beta", "num_aggregates",
)
# The pins' and loads' arrays and the dense edge matrix of
# operator_mode="mxu", and the coarse space (built at load when absent):
# optional (absent or None when off).
OPTIONAL_OBJECT_ARRAYS = ("free_mask", "pin_vel", "static_load",
                          "edge_matrix", "agg_ids", "agg_basis")
# The arrays of OPTIONAL_OBJECT_ARRAYS that object_from_arrays builds from
# rest_pos when they are absent (coarse_arrays).
_COARSE_ARRAYS = ("agg_ids", "agg_basis")
STATE_ARRAYS = ("pos", "vel", "vel_g", "force", "jacobi_past_x")
# The inelastic internal inverses: optional (absent or None when off).
INTERNAL_ARRAYS = ("plastic_inv", "viscous_inv")
# Obstacles: the circles, the typed obstacles' arrays (optional) and their
# friction tuples.
OBSTACLE_ARRAYS = ("centers", "radii")
OPTIONAL_OBSTACLE_ARRAYS = ("half_p", "half_n", "box_lo", "box_hi",
                            "sdf_grid", "sdf_origin", "sdf_spacing", "sph_c",
                            "sph_r")
OBSTACLE_FRICTIONS = ("half_f", "box_f", "sdf_f", "sph_f")

_INT_ARRAYS = ("element_indices", "faces")


def object_from_arrays(
    arrays: Dict[str, np.ndarray], statics: Dict[str, object], device="cuda"
) -> FemObject:
    """A :class:`FemObject` from ``arrays`` (the names of ``OBJECT_ARRAYS``
    and, when on, of ``OPTIONAL_OBJECT_ARRAYS``) and ``statics`` (the names
    of ``OBJECT_STATICS``; the inelastic ones and ``damping_beta`` optional,
    at their defaults when absent; ``num_aggregates`` follows from
    ``agg_ids``)."""
    dev = resolve_device(device)
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
    for name in OPTIONAL_OBJECT_ARRAYS:
        if arrays.get(name) is not None and name not in _COARSE_ARRAYS:
            tensors[name] = torch.tensor(
                np.asarray(arrays[name], np.float32), device=dev)
    coarse = coarse_arrays(arrays["rest_pos"], dev, arrays.get("agg_ids"),
                           arrays.get("agg_basis"))
    return FemObject(
        **tensors, plan=plan, blocking=blocking,
        **jacobi_arrays(idx, int(statics["particle_cnt"]), dev), **coarse,
        **{k: statics[k] for k in OBJECT_STATICS
           if k in statics and k != "num_aggregates"},
    )


def _present(x, names):
    """{name: numpy array} of the tensors of ``x`` among ``names`` that are
    not None."""
    return {n: getattr(x, n).cpu().numpy() for n in names
            if getattr(x, n) is not None}


def object_to_arrays(obj: FemObject):
    """(arrays, statics) of ``obj`` — the inverse of
    :func:`object_from_arrays`."""
    arrays = _present(obj, OBJECT_ARRAYS + OPTIONAL_OBJECT_ARRAYS)
    statics = {n: getattr(obj, n) for n in OBJECT_STATICS}
    return arrays, statics


def obstacles_from_arrays(arrays: Dict[str, np.ndarray], frictions=None,
                          device="cuda") -> Obstacles:
    """:class:`Obstacles` from ``arrays`` (``centers``, ``radii`` and those
    of ``OPTIONAL_OBSTACLE_ARRAYS`` that are present and not None) and
    ``frictions`` (the tuples of ``OBSTACLE_FRICTIONS``; empty when
    absent)."""
    dev = resolve_device(device)
    names = OBSTACLE_ARRAYS + tuple(
        n for n in OPTIONAL_OBSTACLE_ARRAYS if arrays.get(n) is not None)
    frictions = frictions or {}
    return Obstacles(
        **{n: torch.tensor(np.asarray(arrays[n], np.float32), device=dev)
           for n in names},
        **{n: tuple(float(f) for f in frictions.get(n, ()))
           for n in OBSTACLE_FRICTIONS},
    )


def obstacles_to_arrays(obstacles: Obstacles):
    """(arrays, frictions) of ``obstacles``: the inverse of
    :func:`obstacles_from_arrays`."""
    return (_present(obstacles, OBSTACLE_ARRAYS + OPTIONAL_OBSTACLE_ARRAYS),
            {n: getattr(obstacles, n) for n in OBSTACLE_FRICTIONS})


def state_from_arrays(arrays: Dict[str, np.ndarray], device="cuda") -> SimState:
    """A :class:`SimState` from the arrays of ``STATE_ARRAYS`` and those of
    ``INTERNAL_ARRAYS`` that ``arrays`` holds and are not None; an absent
    ``jacobi_past_x`` is zero, as at the start of a run."""
    dev = resolve_device(device)
    arrays = dict(arrays)
    if arrays.get("jacobi_past_x") is None:
        arrays["jacobi_past_x"] = np.zeros_like(
            np.asarray(arrays["pos"], np.float32))
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
    return _present(state, STATE_ARRAYS + INTERNAL_ARRAYS)


# The JAX package's ContactPlan fields, by name: per-body ``surf`` and
# ``self_mask`` sequences (masks (ns_i, ns_i) 0/1 or None), the grid's
# ``body_id`` and ``rest_cat`` (None in dense mode) and the static routing
# fields.
CONTACT_PLAN_FIELDS = ("surf", "self_mask", "body_id", "rest_cat", "mode",
                       "sizes", "self_contact", "cap")


def contact_plan_from_arrays(fields: Dict[str, object],
                             device="cuda") -> ContactPlan:
    """A :class:`ContactPlan` from the fields ``CONTACT_PLAN_FIELDS`` of a
    plan (array-likes; the masks are taken as given, nonzero admits)."""
    dev = resolve_device(device)
    surf = [np.asarray(s) for s in fields["surf"]]
    sizes = tuple(int(n) for n in fields["sizes"])
    plan = dict(
        surf=tuple(torch.tensor(s, dtype=torch.int64, device=dev)
                   for s in surf),
        sizes=sizes, mode=str(fields["mode"]),
        self_contact=bool(fields["self_contact"]), cap=int(fields["cap"]))
    if plan["mode"] == "grid":
        return ContactPlan(
            **plan,
            body_id=torch.tensor(np.asarray(fields["body_id"], np.int32),
                                 device=dev),
            rest_cat=torch.tensor(np.asarray(fields["rest_cat"], np.float32),
                                  device=dev))
    masks = [None if m is None else np.asarray(m) != 0
             for m in fields["self_mask"]]
    return ContactPlan(**plan, tables=pair_tables(sizes, masks, dev))


def contact_plan_to_arrays(plan: ContactPlan) -> Dict[str, object]:
    """The fields ``CONTACT_PLAN_FIELDS`` of ``plan`` as numpy arrays and
    host values, the masks as booleans: the inverse of
    :func:`contact_plan_from_arrays`."""
    def host(t):
        return None if t is None else t.cpu().numpy()

    return dict(
        surf=[host(s) for s in plan.surf],
        self_mask=[None if m is None else host(m) != 0
                   for m in plan.self_mask],
        body_id=host(plan.body_id), rest_cat=host(plan.rest_cat),
        mode=plan.mode, sizes=tuple(plan.sizes),
        self_contact=plan.self_contact, cap=plan.cap)


MODAL_FIELDS = ("omega_sq", "frequencies", "modes", "residuals")


def modal_from_arrays(arrays: Dict[str, np.ndarray], device="cuda"):
    """A ``solvers/modal.ModalResult`` from the numpy arrays of its fields
    (``MODAL_FIELDS``; for example a JAX package's result through
    ``np.asarray``), each keeping its dtype."""
    from fem_tpu_torch.solvers.modal import ModalResult

    dev = resolve_device(device)
    return ModalResult(**{n: torch.as_tensor(np.asarray(arrays[n]),
                                             device=dev)
                          for n in MODAL_FIELDS})


def modal_to_arrays(result) -> Dict[str, np.ndarray]:
    """{field: numpy array} of a ``ModalResult`` (the inverse of
    :func:`modal_from_arrays`)."""
    return {n: getattr(result, n).cpu().numpy() for n in MODAL_FIELDS}


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
