# coding=utf-8
"""M20: element sharding over ``torch.distributed`` ranks.

The port of the JAX package's ``parallel/sharding.py``.  The JAX package
is single-controller: ``jax.shard_map`` runs one program over a mesh of
devices from one process.  Here every rank is a process of its own (SPMD):
each calls the same function with the same replicated state and gets the
same replicated state back.  The data parallelism is the JAX package's:

* each rank holds a contiguous slice of the element rows (indices, rest-edge
  inverses, volumes, the Jacobi slots) and, on the implicit-CG path, whole
  locality blocks (``ops/blocking.shard_blocking``), with a gather plan
  over them built once (:func:`shard_object`, the counterpart of the JAX
  package's ``_prep_body`` and ``_localize``);
* each rank computes its elements' contributions and sums them onto the
  particles, and one all-reduce over the (N, d) particle space gives every
  rank the whole assembly: one a force assembly and one an operator apply
  (K2 once a substep, K3 for each CG product, on the rank's blocks);
* the particle-space solver iterations (CG, PCG, Newton, the Jacobi
  sweeps) run on every rank alike: their stop tests read values computed
  from summed tensors, which every rank holds bit for bit, so every rank
  stops at the same iteration and the next all-reduce never waits on a
  rank that stopped.

Padding: the element count rarely divides the ranks, so the rows are
padded by repeating element 0 at volume 0 (:func:`pad_elements`), whose
force, energy and Hessian contributions are exactly zero; its Jacobi
coefficients are 0.  The blocks are padded likewise by empty blocks.

Inelastic materials: the internal inverses ride the state over the whole
padded element range on every rank (:func:`_pad_internal`); each rank
takes its rows for the material layers and updates them, and one
all-gather reassembles them (``ops/inelastic.advance_internal``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh``:
:func:`make_element_mesh` a 1-D one named ``("elem",)`` over the default
process group, :func:`make_2d_mesh` a 2-D ``("batch", "elem")`` one.  With
no process group initialised, :func:`make_element_mesh` sets up one (the
``torchrun`` environment when it is there, else a one-rank group: NCCL on
the card, gloo on the CPU).  The whole-frame kernels K5, K8 and K11b and
the whole solve K4 are single-device; the sharded frame is ``sim_count``
op-composed substeps, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
from typing import Optional, Sequence

import torch

from fem_tpu_torch.models.state import FemObject, Obstacles, SimState
from fem_tpu_torch.ops.assembly import (
    all_gather_rows,
    make_gather_plan,
    make_jacobi_gather,
)
from fem_tpu_torch.ops.blocking import shard_blocking
from fem_tpu_torch.sim import StepAux, check_supported_config, substep
from fem_tpu_torch.utils.config import CONJUGATE_GRADIENT_METHOD, SimConfig

AXIS = "elem"

# The timeout of every process group this package sets up: a rank that
# never reaches a collective fails the others within it instead of
# hanging them.
TIMEOUT = datetime.timedelta(seconds=120)


def pad_elements(obj: FemObject, multiple: int) -> FemObject:
    """``obj`` with its element rows padded to a multiple of ``multiple``:
    the padding repeats element 0 at volume 0 (zero contribution, finite
    math), its Jacobi slots are element 0's with zero coefficients, and the
    gather plan and the Jacobi slots' inverse are rebuilt over the padded
    rows; the dense edge matrix, single-device, is dropped.  Unchanged when
    no padding is needed."""
    e = obj.element_cnt
    target = ((e + multiple - 1) // multiple) * multiple
    pad = target - e
    if pad == 0:
        return obj

    def tile0(x):
        return torch.cat([x, x[:1].expand((pad,) + tuple(x.shape[1:]))])

    idx = tile0(obj.element_indices)
    jac = {}
    if obj.jacobi_slots is not None:
        slots = tile0(obj.jacobi_slots)
        jac = dict(
            jacobi_slots=slots,
            jacobi_coeff=torch.cat([
                obj.jacobi_coeff,
                obj.jacobi_coeff.new_zeros((pad,) + tuple(
                    obj.jacobi_coeff.shape[1:]))]),
            jacobi_gather=make_jacobi_gather(
                slots.cpu().numpy(), obj.jacobi_nb.numel(), obj.device),
        )
    return dataclasses.replace(
        obj, element_indices=idx, ref_inv=tile0(obj.ref_inv),
        volume=torch.cat([obj.volume, obj.volume.new_zeros((pad,))]),
        element_cnt=target,
        plan=make_gather_plan(idx.cpu().numpy(), obj.particle_cnt, obj.device),
        edge_matrix=None, **jac)


def _uses_blocked(obj: FemObject, cfg: SimConfig) -> bool:
    """Whether the sharded substep runs the blocked operator: the
    implicit-CG path on an object with locality blocks, under an
    ``operator_mode`` that prefers them (the JAX package's
    ``_uses_blocked``)."""
    return (
        not cfg.auto_diff
        and not cfg.use_explicit_method
        and cfg.implicit_method == CONJUGATE_GRADIENT_METHOD
        and cfg.operator_mode in ("auto", "blocked", "fused")
        and obj.blocking is not None
    )


def _sharded_blocking(obj: FemObject, cfg: SimConfig, rank: int, world: int):
    """The rank's blocks, or None when the config's method does not use
    the blocked operator: locality blocks are shared out whole
    (``ops/blocking.shard_blocking``)."""
    if not _uses_blocked(obj, cfg):
        return None
    return shard_blocking(obj.blocking, rank, world)


def shard_object(obj: FemObject, rank: int, world: int,
                 blocked: bool = True) -> FemObject:
    """Rank ``rank``'s share of ``obj`` over ``world`` ranks: the element
    rows ``[rank·E/world, (rank+1)·E/world)`` of :func:`pad_elements`'s
    padded rows (indices, rest-edge inverses, volumes, Jacobi slots and
    coefficients), with the gather plan and the Jacobi slots' inverse
    built over those rows for all N particles, ``element_cnt`` the local
    count and ``element_start`` the first row; the particle-space arrays
    (masses, rest positions, pins, loads, the coarse space, the Jacobi
    neighbour table) whole; with ``blocked`` (and blocks on ``obj``) the
    rank's blocks (``ops/blocking.shard_blocking``), else none; no edge
    matrix."""
    padded = pad_elements(obj, world)
    e_local = padded.element_cnt // world
    start = rank * e_local
    rows = slice(start, start + e_local)
    idx = padded.element_indices[rows].clone()
    jac = {}
    if padded.jacobi_slots is not None:
        slots = padded.jacobi_slots[rows].clone()
        jac = dict(
            jacobi_slots=slots,
            jacobi_coeff=padded.jacobi_coeff[rows].clone(),
            jacobi_gather=make_jacobi_gather(
                slots.cpu().numpy(), padded.jacobi_nb.numel(), obj.device),
        )
    return dataclasses.replace(
        padded, element_indices=idx, ref_inv=padded.ref_inv[rows].clone(),
        volume=padded.volume[rows].clone(), element_cnt=e_local,
        element_start=start,
        plan=make_gather_plan(idx.cpu().numpy(), obj.particle_cnt, obj.device),
        blocking=(shard_blocking(obj.blocking, rank, world)
                  if blocked and obj.blocking is not None else None),
        edge_matrix=None, **jac)


def _prep_body(obj: FemObject, cfg: SimConfig, rank: int,
               world: int) -> FemObject:
    """The rank's share of one body for ``cfg``: its element rows, and its
    blocks when the config runs the blocked operator."""
    local = shard_object(obj, rank, world, blocked=False)
    return dataclasses.replace(
        local, blocking=_sharded_blocking(obj, cfg, rank, world))


def _device_type(device) -> str:
    return torch.device(device).type


def init_ranks(device="cuda", timeout: datetime.timedelta = TIMEOUT) -> None:
    """Initialise the default process group unless it is: from the
    ``torchrun`` environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``
    and ``MASTER_PORT``; on the card each rank takes device
    ``LOCAL_RANK``), else a one-rank group through a file store in a new
    temporary directory; NCCL on the card, gloo on the CPU, with
    ``timeout``."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    cuda = _device_type(device) == "cuda"
    backend = "nccl" if cuda else "gloo"
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        if cuda:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
        return
    store = dist.FileStore(
        os.path.join(tempfile.mkdtemp(prefix="fem_tpu_torch_"), "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1,
                            timeout=timeout)


def make_element_mesh(n_devices: Optional[int] = None, device="cuda"):
    """1-D ``DeviceMesh`` named ``("elem",)`` over the default process
    group (set up by :func:`init_ranks` when there is none); ``n_devices``,
    when given, must be its size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    init_ranks(device)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"{n_devices} devices asked for, {world} ranks run")
    return init_device_mesh(_device_type(device), (world,),
                            mesh_dim_names=(AXIS,))


def make_2d_mesh(batch_size: int, elem_size: int, device="cuda"):
    """2-D ``DeviceMesh`` ``("batch", "elem")`` of ``batch_size`` ×
    ``elem_size`` ranks (all of the default group): ensembles × elements."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    init_ranks(device)
    if batch_size * elem_size != dist.get_world_size():
        raise ValueError(f"a {batch_size} x {elem_size} mesh over "
                         f"{dist.get_world_size()} ranks")
    return init_device_mesh(_device_type(device), (batch_size, elem_size),
                            mesh_dim_names=("batch", AXIS))


def _elem_group(mesh):
    """(process group, rank in it, its size) of the mesh's ``elem``
    dimension."""
    import torch.distributed as dist

    group = mesh.get_group(AXIS)
    return group, dist.get_rank(group), dist.get_world_size(group)


def _pad_internal(state: SimState, target_e: int) -> SimState:
    """The state's internal inverses padded to ``target_e`` elements with
    identity rows (padded elements carry volume 0: their internal state is
    finite and nothing reads it with a nonzero weight)."""
    def pad(x):
        if x is None or x.shape[-3] == target_e:
            return x
        eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
        eye = eye.expand(x.shape[:-3] + (target_e - x.shape[-3],)
                         + x.shape[-2:])
        return torch.cat([x, eye], dim=-3)

    return state.replace(plastic_inv=pad(state.plastic_inv),
                         viscous_inv=pad(state.viscous_inv))


def _slice_internal(state: SimState, orig_e: int) -> SimState:
    """Inverse of :func:`_pad_internal` on the returned state."""
    def cut(x):
        if x is None or x.shape[-3] == orig_e:
            return x
        return x[..., :orig_e, :, :]

    return state.replace(plastic_inv=cut(state.plastic_inv),
                         viscous_inv=cut(state.viscous_inv))


def _sharded_kwargs(cfg: SimConfig, group) -> dict:
    """The substep keywords of every sharded frame function: the config's, with
    ``group``, the matrix-free backend (the dense one is single-device) and
    ``"fused"`` read as ``"auto"`` (the whole solve is single-device; under
    sharding it resolves to the blocked operator, the same preference)."""
    return dict(
        dt=cfg.delta_time,
        g_dir=tuple(cfg.g_dir),
        use_explicit_method=cfg.use_explicit_method,
        auto_diff=cfg.auto_diff,
        implicit_method=cfg.implicit_method,
        preconditioned=cfg.preconditioned,
        jacobi_sweep=cfg.jacobi_sweep,
        cg_precond=cfg.cg_precond,
        robust_inversion=cfg.robust_inversion,
        element_backend=cfg.element_backend,
        hessian=cfg.hessian,
        integrator=cfg.integrator,
        newton_iters=cfg.newton_iters,
        newton_cg_iters=cfg.newton_cg_iters,
        newton_tol=cfg.newton_tol,
        newton_hessian=cfg.newton_hessian,
        newton_theta=cfg.newton_theta,
        wall_friction=cfg.wall_friction,
        group=group,
        solver_backend="matrix_free",
        operator_mode=("auto" if cfg.operator_mode == "fused"
                       else cfg.operator_mode),
    )


def _inelastic(obj: FemObject) -> bool:
    return obj.plastic_yield > 0.0 or obj.viscous_mu > 0.0


def _frame_substeps(local, kwargs, sim_count: int):
    """``frame(state, obstacles, external=None) -> (state, StepAux)`` of
    ``sim_count`` sharded substeps of ``local``, the metrics stacked."""
    def frame(state, obstacles):
        iters, res = [], []
        for _ in range(sim_count):
            state, aux = substep(local, state, obstacles, **kwargs)
            iters.append(aux.solver_iterations)
            res.append(aux.solver_residual)
        return state, StepAux(torch.stack(iters), torch.stack(res))

    return frame


def _build(obj: FemObject, cfg: SimConfig, mesh, scan_frame: bool):
    """The sharded substep (``scan_frame`` False) or frame function of
    ``obj`` on the mesh's ``elem`` ranks; an inelastic state is padded to
    the padded element range on the way in and cut back on the way out."""
    check_supported_config(cfg)
    group, rank, world = _elem_group(mesh)
    local = _prep_body(obj, cfg, rank, world)
    padded_e = local.element_cnt * world
    kwargs = _sharded_kwargs(cfg, group)
    inelastic = _inelastic(obj)
    orig_e = obj.element_cnt
    if scan_frame:
        step = _frame_substeps(local, kwargs, cfg.sim_count)
    else:
        def step(state, obstacles):
            return substep(local, state, obstacles, **kwargs)

    def run(state: SimState, obstacles: Obstacles):
        if inelastic:
            state = _pad_internal(state, padded_e)
        out, aux = step(state, obstacles)
        if inelastic:
            out = _slice_internal(out, orig_e)
        return out, aux

    run.local = local
    return run


def make_sharded_substep_fn(obj: FemObject, cfg: SimConfig, mesh):
    """One sharded substep, ``step(state, obstacles) -> (state,
    StepAux)``, to be called on every rank of the mesh's ``elem``
    dimension with the same state (tests, the multi-chip dry run)."""
    return _build(obj, cfg, mesh, scan_frame=False)


def make_sharded_frame_fn(obj: FemObject, cfg: SimConfig, mesh):
    """The frame function (``sim_count`` substeps) with the elements
    sharded over the mesh's ``elem`` ranks; a drop-in for
    ``sim.make_frame_fn`` that every rank calls with the same state and
    obstacles and that returns the same state on every rank
    (``run.local`` is the rank's share of ``obj``)."""
    return _build(obj, cfg, mesh, scan_frame=True)


def _member(states: SimState, b: int) -> SimState:
    """Member ``b`` of a batched state."""
    return dataclasses.replace(states, **{
        f.name: getattr(states, f.name)[b]
        for f in dataclasses.fields(states)
        if isinstance(getattr(states, f.name), torch.Tensor)})


def _stack_members(members) -> SimState:
    """The batched state (B, ...) of unbatched ``members``."""
    return dataclasses.replace(members[0], **{
        f.name: torch.stack([getattr(m, f.name) for m in members])
        for f in dataclasses.fields(members[0])
        if getattr(members[0], f.name) is not None})


def gather_members(states, group):
    """Every rank's members (B_local, ...) of a batched state or
    ``StepAux`` concatenated in rank order over ``group``, (B, ...) on
    every rank: one all-gather a tensor field."""
    if isinstance(states, StepAux):
        return StepAux(*(all_gather_rows(t, group) for t in states))
    return dataclasses.replace(states, **{
        f.name: all_gather_rows(getattr(states, f.name), group)
        for f in dataclasses.fields(states)
        if isinstance(getattr(states, f.name), torch.Tensor)})


def member_range(batch: int, rank: int, world: int):
    """The members ``[lo, hi)`` of ``batch`` that rank ``rank`` of
    ``world`` advances; ``batch`` must divide evenly."""
    if batch % world:
        raise ValueError(f"{batch} members do not divide over {world} ranks")
    per = batch // world
    return rank * per, (rank + 1) * per


def make_batched_sharded_frame_fn(obj: FemObject, cfg: SimConfig, mesh):
    """Composed parallelism over a 2-D ``("batch", "elem")`` mesh: the
    ensemble members shard over ``batch`` (independent: no collective
    while they step) and each member's elements over ``elem`` (one
    all-reduce an assembly and an apply).  Call on every rank with a
    batched :class:`SimState` (leading axis divisible by the ``batch``
    size) and unbatched obstacles; every rank returns the full (B, ...)
    states and (B, sim_count) metrics, gathered over ``batch`` at the end
    of the frame."""
    import torch.distributed as dist

    frame = _build(obj, cfg, mesh, scan_frame=True)
    bgroup = mesh.get_group("batch")
    brank, bworld = dist.get_rank(bgroup), dist.get_world_size(bgroup)

    def run(states: SimState, obstacles: Obstacles):
        lo, hi = member_range(states.pos.shape[0], brank, bworld)
        outs, auxes = zip(*(frame(_member(states, b), obstacles)
                            for b in range(lo, hi)))
        aux = StepAux(torch.stack([a.solver_iterations for a in auxes]),
                      torch.stack([a.solver_residual for a in auxes]))
        return (gather_members(_stack_members(outs), bgroup),
                gather_members(aux, bgroup))

    return run


def make_sharded_contact_frame_fn(objs: Sequence[FemObject], cfg: SimConfig,
                                  mesh):
    """The multi-body penalty-contact frame with each body's elements
    sharded over the mesh's ``elem`` ranks; a drop-in for
    ``contact.make_contact_frame_fn``.  The pair forces are particle-space
    math on the replicated positions: every rank computes them alike (C1
    or C2 on the card, as the single-device frame does), with no
    collective; each body's element work shards with one all-reduce an
    assembly, its substep taking the pair force as its external force."""
    from fem_tpu_torch.contact import (
        build_contact_plan,
        contact_constants,
        contact_forces_all,
    )

    check_supported_config(cfg)
    objs = tuple(objs)
    group, rank, world = _elem_group(mesh)
    kwargs = _sharded_kwargs(cfg, group)
    radius, stiffness, friction_c, mu_slope = contact_constants(objs, cfg)
    mu = cfg.contact_mu
    plan = build_contact_plan(objs, cfg, radius)
    locals_ = tuple(_prep_body(o, cfg, rank, world) for o in objs)
    padded = tuple(lo.element_cnt * world for lo in locals_)
    orig = tuple(o.element_cnt for o in objs)
    inelastic = any(_inelastic(o) for o in objs)

    def frame(states, obstacles: Obstacles):
        states = tuple(states)
        if inelastic:
            states = tuple(_pad_internal(s, e) for s, e in zip(states, padded))
        iters = [[] for _ in objs]
        res = [[] for _ in objs]
        for _ in range(cfg.sim_count):
            forces = contact_forces_all(
                [s.pos for s in states], radius, stiffness,
                velocities=[s.vel for s in states], plan=plan,
                friction_c=friction_c, mu=mu, mu_slope=mu_slope)
            out = []
            for b, (lo, s, f) in enumerate(zip(locals_, states, forces)):
                s2, aux = substep(lo, s, obstacles, external_force=f,
                                  **kwargs)
                out.append(s2)
                iters[b].append(aux.solver_iterations)
                res[b].append(aux.solver_residual)
            states = tuple(out)
        if inelastic:
            states = tuple(_slice_internal(s, e) for s, e in zip(states, orig))
        return states, tuple(StepAux(torch.stack(it), torch.stack(r))
                             for it, r in zip(iters, res))

    frame.plan = plan
    return frame
