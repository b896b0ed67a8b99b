# coding=utf-8
"""Body-body penalty contact: the port of the JAX package's ``contact.py``.

``contact="penalty"`` couples the bodies once a substep with a particle
pair penalty force between different bodies (and, with ``self_contact``,
between surface vertices of one body whose rest distance exceeds
2.5·radius):

    f(i, j) = k · max(0, r − ‖x_i − x_j‖) · (x_i − x_j) / max(‖x_i − x_j‖, 0.1 r)

with an optional viscous dashpot on the overlap ramp (``contact_friction``)
and a regularized Coulomb cone (``contact_mu``).  The pair forces enter each
body's ``sim.substep(external_force=...)``; Newton's third law holds pair
by pair, so the contact conserves linear momentum up to rounding.

What runs where:

* on the host, once at build (numpy): the auto radius and stiffness, the
  surface-vertex sets, the ``"auto"`` routing between the dense pass and
  the grid with the JAX package's byte budgets, and the self-contact rest
  masks, built with the JAX package's expression and kept on the device as
  uint8, never recomputed;
* each substep, one contact-force evaluation over every body pair and the
  self-contact: one launch of C1 (``ops/contact_kernels.pair_forces``, the
  dense pass over the concatenated vertex soup) or, on the grid, one
  stable sort, one lookup and one launch of C2
  (``broadphase.grid_contact_forces``), then each body's substep.  On the
  CPU both run their plain versions.  Nothing is read back inside a frame.

The coupled frame cannot run the whole-frame kernels K5 or K8 (the forces
change every substep), so each body steps through the op-composed substep.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from fem_tpu_torch.broadphase import grid_contact_forces, grid_shape
from fem_tpu_torch.models.state import FemObject, Obstacles
from fem_tpu_torch.ops.contact_kernels import (  # noqa: F401  (the JAX names)
    PairTables,
    _pair_coefs,
    _pair_mu_forces,
    pair_contact_forces,
    pair_forces,
    pair_tables,
    self_contact_forces,
)
from fem_tpu_torch.sim import StepAux, check_supported_config, substep, substep_kwargs
from fem_tpu_torch.utils.config import SimConfig


def auto_contact_radius(objs: Sequence[FemObject]) -> float:
    """Default contact radius: the mean rest edge length over all bodies."""
    total, count = 0.0, 0
    for o in objs:
        pos = o.rest_pos.cpu().numpy()
        idx = o.element_indices.cpu().numpy()
        for j in range(1, o.dim + 1):
            e = np.linalg.norm(pos[idx[:, j]] - pos[idx[:, 0]], axis=1)
            total += float(e.sum())
            count += e.size
    return total / max(count, 1)


def auto_contact_stiffness(objs: Sequence[FemObject], dt: float) -> float:
    """Default penalty stiffness at the explicit stability limit:
    k = 0.02·m_min/dt²."""
    return 0.02 * _min_mass(objs) / (dt * dt)


def _min_mass(objs: Sequence[FemObject]) -> float:
    return min(float(o.mass.min()) for o in objs)


@dataclasses.dataclass(frozen=True, eq=False)
class ContactPlan:
    """Static (per-scene) contact index data, built once on the host.

    ``surf``: each body's participating vertex ids (int64; the surface set
    when ``contact_surface_only``, else all).  Dense mode: ``tables``, C1's
    soup tables, whose ``masks`` are the self-contact masks (uint8, None
    when off).  Grid mode: ``body_id`` (Σns,) int32 (integers, where the
    JAX package packs them as f32) and ``rest_cat`` (Σns, d)."""

    surf: Tuple[torch.Tensor, ...]
    sizes: Tuple[int, ...]
    mode: str = "dense"
    self_contact: bool = False
    cap: int = 8
    tables: Optional[PairTables] = None
    body_id: Optional[torch.Tensor] = None
    rest_cat: Optional[torch.Tensor] = None

    @property
    def self_mask(self) -> Tuple[Optional[torch.Tensor], ...]:
        if self.tables is None:
            return tuple(None for _ in self.surf)
        return self.tables.masks


def _surface_vertices(obj: FemObject, surface_only: bool) -> np.ndarray:
    if surface_only:
        return np.unique(obj.faces.cpu().numpy().reshape(-1)).astype(np.int32)
    return np.arange(obj.particle_cnt, dtype=np.int32)


def _route(sizes: Sequence[int], cfg: SimConfig, dim: int) -> str:
    """The broad phase of ``cfg.contact_broadphase``: ``"auto"`` takes the
    grid past 8 bodies or when the largest pair matrix passes the JAX
    package's budget (2 GiB of pairs, or 1 GiB per (ns_a, ns_b, d) tensor
    with ``contact_mu``), else the dense pass."""
    mode = cfg.contact_broadphase
    if mode == "auto":
        peak = max(
            [a * b for i, a in enumerate(sizes) for b in sizes[i + 1:]]
            + ([s * s for s in sizes] if cfg.self_contact else [0]))
        pair_budget = (2**30 // (4 * dim) if cfg.contact_mu > 0.0
                       else 2 * 2**30)
        mode = "grid" if (len(sizes) > 8 or peak > pair_budget) else "dense"
    if mode not in ("dense", "grid"):
        raise ValueError(
            f"unknown contact_broadphase {cfg.contact_broadphase!r}")
    return mode


def _rest_masks(objs: Sequence[FemObject], surf: Sequence[np.ndarray],
               radius: float):
    """Each body's self-contact mask over its participating vertices: rest
    distance > 2.5·radius, by the JAX package's expression
    (its contact.py:311-321), as booleans."""
    masks = []
    for o, sv in zip(objs, surf):
        rp = o.rest_pos.cpu().numpy()[sv]
        d = np.sqrt(np.maximum(
            (rp ** 2).sum(1)[:, None] + (rp ** 2).sum(1)[None, :]
            - 2.0 * rp @ rp.T, 0.0))
        masks.append(d > 2.5 * radius)
    return masks


def build_contact_plan(objs: Sequence[FemObject], cfg: SimConfig,
                       radius: float) -> ContactPlan:
    """Host-side plan build: surface-vertex sets from each body's faces, then
    the dense pass's tables (with the rest masks under ``self_contact``) or
    the grid's soup, on the bodies' device."""
    dev = objs[0].device
    surf = [_surface_vertices(o, cfg.contact_surface_only) for o in objs]
    sizes = tuple(int(s.size) for s in surf)
    mode = _route(sizes, cfg, objs[0].dim)
    surf_t = tuple(torch.tensor(s, dtype=torch.int64, device=dev)
                   for s in surf)
    if mode == "grid":
        grid_shape(radius, objs[0].dim)  # the int32 range guard, at build
        body_id = np.concatenate(
            [np.full(n, i, np.int32) for i, n in enumerate(sizes)])
        rest_cat = np.concatenate(
            [o.rest_pos.cpu().numpy()[s] for o, s in zip(objs, surf)])
        return ContactPlan(
            surf=surf_t, sizes=sizes, mode="grid",
            self_contact=bool(cfg.self_contact),
            cap=int(cfg.contact_cell_cap),
            body_id=torch.tensor(body_id, device=dev),
            rest_cat=torch.tensor(rest_cat, dtype=torch.float32, device=dev))
    masks = (_rest_masks(objs, surf, radius) if cfg.self_contact
             else [None] * len(objs))
    return ContactPlan(surf=surf_t, sizes=sizes,
                       self_contact=bool(cfg.self_contact),
                       tables=pair_tables(sizes, masks, dev))


def _all_pairs_plan(positions: Sequence[torch.Tensor]) -> ContactPlan:
    """The plan of ``contact_forces_all`` without one: every particle of
    every body, no self-contact."""
    sizes = tuple(int(p.shape[0]) for p in positions)
    dev = positions[0].device
    return ContactPlan(
        surf=tuple(torch.arange(n, device=dev) for n in sizes), sizes=sizes,
        tables=pair_tables(sizes, [None] * len(sizes), dev))


def contact_forces_all(
    positions: Sequence[torch.Tensor],
    radius: float,
    stiffness: float,
    velocities: Optional[Sequence[torch.Tensor]] = None,
    plan: Optional[ContactPlan] = None,
    friction_c: float = 0.0,
    mu: float = 0.0,
    mu_slope: float = 0.0,
) -> list:
    """Per-body contact forces (each (N_i, d)) over every unordered body
    pair and each body's self-contact, in one pass over the concatenated
    soup of the participating vertices: C1 (dense) or C2 (grid).  Without a
    plan every particle takes part and there is no self-contact."""
    if plan is None:
        plan = _all_pairs_plan(positions)
    pos_cat = torch.cat([p.index_select(0, sv)
                         for p, sv in zip(positions, plan.surf)])
    vel_cat = (torch.cat([v.index_select(0, sv)
                          for v, sv in zip(velocities, plan.surf)])
               if velocities is not None else None)
    if plan.mode == "grid":
        f_cat = grid_contact_forces(
            pos_cat, plan.body_id, plan.rest_cat, radius, stiffness,
            vel=vel_cat, friction_c=friction_c, cap=plan.cap,
            self_contact=plan.self_contact, mu=mu, mu_slope=mu_slope)
    else:
        f_cat = pair_forces(plan.tables, pos_cat, vel_cat, radius, stiffness,
                            friction_c, mu, mu_slope)
    # Surface ids are unique within a body: the scatter back is a copy.
    return [torch.zeros_like(p).index_copy_(0, sv, f)
            for p, sv, f in zip(positions, plan.surf,
                                torch.split(f_cat, plan.sizes))]


def contact_constants(objs: Sequence[FemObject], cfg: SimConfig):
    """(radius, stiffness, friction_c, mu_slope) of a scene: the config's,
    or the auto rules; friction_c and mu_slope scale √(k·m_min), the pair
    critical damping (the JAX package's contact.py:419-424)."""
    radius = (cfg.contact_radius if cfg.contact_radius > 0.0
              else auto_contact_radius(objs))
    stiffness = (cfg.contact_stiffness if cfg.contact_stiffness > 0.0
                 else auto_contact_stiffness(objs, cfg.delta_time))
    damp = float(np.sqrt(stiffness * _min_mass(objs)))
    return radius, stiffness, cfg.contact_friction * damp, damp


def make_contact_frame_fn(objs: Sequence[FemObject], cfg: SimConfig):
    """Frame function advancing all bodies jointly for ``sim_count``
    substeps with per-substep penalty coupling:
    ``frame(states, obstacles) -> (states, auxes)``, ``states`` a tuple of
    per-body SimStates and ``auxes`` a tuple of per-body StepAux whose
    fields are stacked over the substeps, shape ``(sim_count,)``, as
    ``sim.make_frame_fn``'s.  The plan's sizes are host integers taken
    here; a frame reads nothing back."""
    check_supported_config(cfg)
    objs = tuple(objs)
    kwargs = substep_kwargs(cfg)
    radius, stiffness, friction_c, mu_slope = contact_constants(objs, cfg)
    mu = cfg.contact_mu
    plan = build_contact_plan(objs, cfg, radius)

    def frame(states, obstacles: Obstacles):
        states = tuple(states)
        iters = [[] for _ in objs]
        res = [[] for _ in objs]
        for _ in range(cfg.sim_count):
            forces = contact_forces_all(
                [s.pos for s in states], radius, stiffness,
                velocities=[s.vel for s in states], plan=plan,
                friction_c=friction_c, mu=mu, mu_slope=mu_slope)
            out = []
            for b, (o, s, f) in enumerate(zip(objs, states, forces)):
                s2, aux = substep(o, s, obstacles, external_force=f, **kwargs)
                out.append(s2)
                iters[b].append(aux.solver_iterations)
                res[b].append(aux.solver_residual)
            states = tuple(out)
        return states, tuple(StepAux(torch.stack(it), torch.stack(r))
                             for it, r in zip(iters, res))

    frame.plan = plan
    frame.constants = (radius, stiffness, friction_c, mu_slope)
    return frame


def contact_scene(cfg: SimConfig, bodies: int) -> bool:
    """Whether a scene of ``bodies`` bodies steps through the coupled frame:
    ``contact == "penalty"`` with more than one body or with
    ``self_contact`` (the JAX package's api.py:47-49 and the
    root main.py:100)."""
    return cfg.contact == "penalty" and (bodies > 1 or cfg.self_contact)

