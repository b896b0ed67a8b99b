# coding=utf-8
"""Batched simulation: an ensemble of independent simulations of one mesh,
the port of the JAX package's ``batch.py``.

A batched state is a :class:`SimState` whose fields carry a leading batch
axis B (``broadcast_state``, ``perturb_states``).  ``make_batched_frame_fn``
advances every member ``sim_count`` substeps through ``sim.substep``, one
member after another, as the JAX package's function scans ``substep`` under
``vmap``; obstacles are shared or per sample (``centers`` (B, nb, d)).  One
launch over the whole batch is later work (ROADMAP M8 part 2).
``make_sharded_batched_frame_fn`` shares the members out over the ranks of
a ``torch.distributed`` mesh.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fem_tpu_torch.models.state import FemObject, Obstacles, SimState
from fem_tpu_torch.sim import StepAux, check_supported_config, substep, substep_kwargs
from fem_tpu_torch.utils.config import SimConfig


def _map(x, fn):
    """A copy of dataclass ``x`` with ``fn`` applied to each tensor field
    (None fields stay None)."""
    return dataclasses.replace(x, **{
        f.name: fn(getattr(x, f.name)) for f in dataclasses.fields(x)
        if isinstance(getattr(x, f.name), torch.Tensor)})


def broadcast_state(state: SimState, batch: int) -> SimState:
    """Tile a single state into a (B, ...) batched state."""
    return _map(state, lambda t: t[None].expand((batch,) + t.shape).clone())


def perturb_states(state: SimState, batch: int, scale: float,
                   seed: int = 0) -> SimState:
    """Batched state with per-sample position noise: the JAX package's
    ``np.random.default_rng(seed)`` normal draws in float32, so both
    packages start from bit-equal ensembles."""
    base = broadcast_state(state, batch)
    rng = np.random.default_rng(seed)
    noise = rng.normal(scale=scale, size=tuple(base.pos.shape)).astype(
        np.float32)
    return base.replace(pos=base.pos + torch.from_numpy(noise).to(
        base.pos.device))


def make_sharded_batched_frame_fn(obj: FemObject, cfg: SimConfig, mesh):
    """Data-parallel ensembles: the batch axis shared out over the ranks of
    a 1-D ``DeviceMesh`` (``parallel/sharding.make_element_mesh``), the
    JAX package's ``make_sharded_batched_frame_fn``.  Members are
    independent, so they step with no collective: each rank advances its
    contiguous members through :func:`make_batched_frame_fn` (the batch a
    multiple of the ranks), and one all-gather a field at the end of the
    frame gives every rank the full (B, ...) states and (B, sim_count)
    metrics.  Obstacles are shared, or per sample (each rank takes its
    members' rows)."""
    import torch.distributed as dist

    from fem_tpu_torch.parallel.sharding import gather_members, member_range

    frame = make_batched_frame_fn(obj, cfg)
    group = mesh.get_group()
    rank, world = dist.get_rank(group), dist.get_world_size(group)

    def sharded_frame(states: SimState, obstacles: Obstacles):
        lo, hi = member_range(states.pos.shape[0], rank, world)
        if obstacles.centers.dim() == 3:
            obstacles = _map(obstacles, lambda t: t[lo:hi])
        out, aux = frame(_map(states, lambda t: t[lo:hi]), obstacles)
        return gather_members(out, group), gather_members(aux, group)

    return sharded_frame


def make_batched_frame_fn(obj: FemObject, cfg: SimConfig):
    """``frame(states, obstacles) -> (states, StepAux)`` over a batched
    state: every member advances ``sim_count`` substeps; the StepAux fields
    have shape (B, sim_count).  ``obstacles`` are shared, or per sample when
    ``centers`` is (B, nb, d) (every tensor field then (B, ...))."""
    check_supported_config(cfg)
    kwargs = substep_kwargs(cfg)

    def frame(states: SimState, obstacles: Obstacles):
        per_sample = obstacles.centers.dim() == 3
        members, iters, res = [], [], []
        for b in range(states.pos.shape[0]):
            s = _map(states, lambda t: t[b])
            obs = _map(obstacles, lambda t: t[b]) if per_sample else obstacles
            it, r = [], []
            for _ in range(cfg.sim_count):
                s, aux = substep(obj, s, obs, **kwargs)
                it.append(aux.solver_iterations)
                r.append(aux.solver_residual)
            members.append(s)
            iters.append(torch.stack(it))
            res.append(torch.stack(r))
        out = dataclasses.replace(states, **{
            f.name: torch.stack([getattr(m, f.name) for m in members])
            for f in dataclasses.fields(states)
            if getattr(members[0], f.name) is not None})
        return out, StepAux(torch.stack(iters), torch.stack(res))

    return frame
