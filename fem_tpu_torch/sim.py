# coding=utf-8
"""Simulation stepping: the substep and the frame.

The port of the JAX package's ``sim.py`` for the semi-implicit path (the
conjugate-gradient and the Jacobi solvers, matrix-free or dense), the
Newton integrator and the explicit and autodiff paths.  A substep
is, as in the reference's main loop (main.py:101-112; ``auto_diff`` wins
over everything):

* explicit or autodiff: the assembled energy gradient
  (``solvers/explicit.py``) less the external force, then the kinematic
  step (``solvers/advect.kinematic_step``);
* otherwise: the velocity solve — semi-implicit (``solvers/implicit.py``)
  or, with ``integrator="newton"``, the Newton solve
  (``solvers/newton.py``) — with the external force folded into the
  velocity it starts from (b = v + dt·M⁻¹(f_el + f_ext)), then implicit
  advection (``solvers/advect.advect_implicit_step``, θ-weighted after a
  Newton solve at ``newton_theta`` < 1).

The external force is the caller's (``external_force``: the contact
forces of ``contact.py``), the object's static load (``load_boxes``) and, on
the explicit paths, Rayleigh damping β·G(K)·v
(``implicit.rayleigh_damping_grad``); on the implicit path β sits in the
system coefficient.  Pins and wall friction go into both advection steps,
which run their plain (``"xla"``) backend, as the JAX package's frames do.

An inelastic material (``plastic_yield`` or ``viscous_mu``,
ops/inelastic.py) runs every path on its material layers, and the substep
ends with ``advance_internal``, the update of the internal inverses from
the end-of-substep positions; an inelastic autodiff config runs the
analytic layered gradient, as the JAX package's does (its sim.py:116-123).

A frame advances ``sim_count`` substeps and returns the per-substep solver
metrics as device tensors of shape ``(sim_count,)`` (zeros on the explicit
paths).  ``make_frame_fn`` picks how, as the JAX package's does:

* the whole-frame kernel K5 (``ops/frame_kernels.py``), one launch a frame
  over the locality blocks, for ``frame_backend="blocked"`` and, on a CUDA
  object, for ``"auto"`` when the config is eligible
  (:func:`supports_blocked_frame`: no pins, loads, β, typed obstacles, wall
  friction, exact Hessian or block-Jacobi, which the kernels do not
  implement);
* the explicit whole-frame kernel K8, likewise, for
  ``frame_backend="blocked_explicit"`` and, on a CUDA object, for ``"auto"``
  when an explicit or autodiff config is eligible
  (:func:`supports_explicit_blocked_frame`);
* the unblocked whole-frame kernel K11b (``experiments/fused_frame.py``),
  one launch a frame over the mesh as it is, for ``frame_backend="fused"``
  only (:func:`supports_fused_frame`), never for ``"auto"``;
* an ``adaptive_dt`` config: the guarded frame
  (:func:`make_adaptive_frame_fn`): κ once a frame through K2, one host
  read of its split level, then K5 at dt/n where eligible, else the
  op-composed frame at dt/n;
* otherwise the op-composed frame: ``sim_count`` substeps back to back, in
  which nothing waits for the device unless the blocked operator's CG loop
  reads ‖r‖² (``operator_mode="blocked"``) or the snapshot Jacobi sweep its
  error; the serial Jacobi solve is one launch of J1 that reads nothing
  back, and each substep carries ``jacobi_past_x`` to the next.

Every configuration the port does not cover raises ``NotImplementedError``
naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from fem_tpu_torch.experiments.fused_frame import (
    make_fused_frame_fn,
    supports_fused_frame,
)
from fem_tpu_torch.models.state import FemObject, Obstacles, SimState
from fem_tpu_torch.ops.frame_kernels import (
    explicit_frame_binding,
    fused_blocked_frame,
    fused_explicit_frame,
)
from fem_tpu_torch.ops.element import (
    element_energies,
    element_stresses,
    von_mises,
)
from fem_tpu_torch.ops.inelastic import (
    advance_internal,
    inelastic_element_energies,
    is_inelastic,
    material_layers,
)
from fem_tpu_torch.solvers.adaptive import (
    LEVELS,
    adaptive_substep,
    inner_substeps,
    kappa_estimate,
    read_level,
)
from fem_tpu_torch.solvers.advect import (
    advect_implicit_step,
    damping_decay,
    gravity_vector,
    kinematic_step,
)
from fem_tpu_torch.solvers.dense import implicit_velocity_solve_dense
from fem_tpu_torch.solvers.explicit import (
    analytic_energy_gradient,
    autodiff_energy_gradient,
)
from fem_tpu_torch.solvers.implicit import (
    implicit_velocity_solve,
    rayleigh_damping_grad,
)
from fem_tpu_torch.solvers.newton import newton_velocity_solve
from fem_tpu_torch.utils.config import CONJUGATE_GRADIENT_METHOD, SimConfig


class StepAux(NamedTuple):
    """Per-substep solver metrics (device tensors)."""

    solver_iterations: torch.Tensor
    solver_residual: torch.Tensor


def _explicit(cfg: SimConfig) -> bool:
    return bool(cfg.auto_diff or cfg.use_explicit_method)


def check_supported_config(cfg: SimConfig) -> None:
    """Raise for configurations the port does not cover.  The solver
    options apply to the implicit path only: an explicit or autodiff
    substep never reads them, as in the JAX package."""
    unsupported = []
    if not _explicit(cfg):
        unsupported += [
            (cfg.cg_fast_math,
             "cg_fast_math (the TPU kernels' 2-plane bf16 split-dots on the "
             "MXU; the port computes in plain f32 and has no counterpart)",
             "K5"),
        ]
    for bad, what, item in unsupported:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP {item})"
            )


def substep(
    obj: FemObject,
    state: SimState,
    obstacles: Obstacles,
    *,
    dt: float,
    g_dir: Tuple[float, ...],
    implicit_method: int,
    preconditioned: int,
    robust_inversion: bool = False,
    cg_precond: str = "reference",
    operator_mode: str = "auto",
    use_explicit_method: bool = False,
    auto_diff: bool = False,
    element_backend: str = "auto",
    hessian: str = "reference",
    wall_friction: float = 0.0,
    jacobi_sweep: str = "serial",
    solver_backend: str = "auto",
    integrator: str = "semi_implicit",
    newton_iters: int = 10,
    newton_cg_iters: int = 120,
    newton_tol: float = 1e-5,
    newton_hessian: str = "exact",
    newton_theta: float = 1.0,
    external_force: Optional[torch.Tensor] = None,
    group=None,
) -> Tuple[SimState, StepAux]:
    """One substep.  Explicit or autodiff: the energy gradient less the
    external force, then the kinematic step, with zero solver metrics.
    The external force is ``external_force`` (N, d) (the penalty contact
    forces of ``contact.make_contact_frame_fn``) plus the object's static
    load, in the JAX package's order (``external_force + static_load``).
    Otherwise implicit: the velocity solve from v + dt·M⁻¹·f_ext — with
    ``integrator="newton"`` the Newton solve (``solvers/newton.py``; the
    ``newton_*`` settings, ``cg_precond`` "reference" read as "none"), its
    θ-scheme position weighting from the physical velocity before the
    fold; else the dense backend (``solvers/dense.py``) for
    ``solver_backend="dense"`` under the JAX package's conditions (its
    sim.py:203-222: the reference Hessian and CG preconditioner, no
    material layers, no pins), else the matrix-free solve — then advection
    (θ-weighted after Newton at θ < 1).  An inelastic material then updates
    its internal inverses.

    ``group`` (a ``torch.distributed`` process group; the JAX package's
    ``axis_name``) runs the substep element-sharded
    (``parallel/sharding.py``): ``obj`` is a rank's share
    (``sharding.shard_object``), every assembly and operator apply is
    summed over the ranks and the particle-space work runs on every rank
    alike, so that every rank returns the same state.  The dense backend
    is single-device and is not taken then, as in the JAX package (its
    sim.py:203-210)."""
    inelastic = is_inelastic(obj)
    layers = material_layers(obj, state) if inelastic else None
    external = obj.static_load
    if external_force is not None:
        external = (external_force if external is None
                    else external_force + external)
    advect_kw = dict(free_mask=obj.free_mask, pin_vel=obj.pin_vel,
                     wall_friction=wall_friction)
    if auto_diff or use_explicit_method:
        if obj.damping_beta != 0.0:
            damp = rayleigh_damping_grad(obj, state.pos, state.vel, layers,
                                         group)
            external = -damp if external is None else external - damp
        if inelastic:
            grad = analytic_energy_gradient(obj, state.pos, element_backend,
                                            layers, group)
        elif auto_diff:
            grad = autodiff_energy_gradient(obj, state.pos, group)
        else:
            grad = analytic_energy_gradient(obj, state.pos, element_backend,
                                            group=group)
        if external is not None:
            grad = grad - external
        dtype = state.pos.dtype
        state = kinematic_step(
            state, grad, obj.mass, obstacles, dt,
            damping_decay(dt, obj.damping, dtype),
            gravity_vector(tuple(g_dir), obj.device, dtype), **advect_kw,
        )
        if inelastic:
            state = advance_internal(obj, state, dt, group)
        return state, StepAux(
            torch.zeros((), dtype=torch.int32, device=obj.device),
            torch.zeros((), dtype=torch.float32, device=obj.device),
        )
    # The θ-scheme's position weighting takes the physical start velocity
    # (vel + vel_g) and the Newton force position the unfolded vel, both
    # from before the external-force fold below, which is algebra, not a
    # velocity the body had (the JAX package's sim.py:139-151).
    theta_newton = integrator == "newton" and newton_theta != 1.0
    vel_pos_old = state.vel + state.vel_g if theta_newton else None
    vel_unfolded = state.vel if theta_newton else None
    if external is not None:
        # b = v + dt·M⁻¹·f_el is linear in v: solving from
        # v' = v + dt·M⁻¹·f_ext gives b = v + dt·M⁻¹·(f_el + f_ext) on every
        # branch unchanged.
        state = state.replace(
            vel=state.vel + dt * external / obj.mass[:, None])
    if integrator == "newton":
        state, aux = newton_velocity_solve(
            obj, state, dt, max_newton=newton_iters,
            cg_iters=newton_cg_iters, tol=newton_tol,
            hessian_mode=newton_hessian, element_backend=element_backend,
            # "reference" and "none" are plain CG inside Newton (it has no
            # normal-equations variant).
            cg_precond=(cg_precond if cg_precond == "block_jacobi"
                        or cg_precond.startswith("two_level") else "none"),
            robust=robust_inversion, beta=obj.damping_beta,
            theta=newton_theta, layers=layers, v_n_pos=vel_unfolded,
            group=group)
        state = advect_implicit_step(
            state, obstacles, dt,
            damping_decay(dt, obj.damping, state.pos.dtype),
            gravity_vector(tuple(g_dir), obj.device), **advect_kw,
            theta=newton_theta, vel_pos_old=vel_pos_old)
        if inelastic:
            state = advance_internal(obj, state, dt, group)
        return state, StepAux(aux.iterations, aux.residual)
    if integrator != "semi_implicit":
        raise ValueError(f"unknown integrator {integrator!r}")
    use_dense = (solver_backend == "dense" and hessian == "reference"
                 and cg_precond == "reference" and not inelastic
                 and obj.free_mask is None and group is None)
    if use_dense:
        state, aux = implicit_velocity_solve_dense(
            obj, state, dt, implicit_method, preconditioned, robust_inversion,
            jacobi_sweep)
    else:
        state, aux = implicit_velocity_solve(
            obj, state, dt, implicit_method, preconditioned, robust_inversion,
            cg_precond, operator_mode, layers, hessian, element_backend,
            jacobi_sweep, group,
        )
    # The decay follows the state's dtype; gravity stays f32, as in the JAX
    # package's advect_implicit_step.
    state = advect_implicit_step(
        state, obstacles, dt, damping_decay(dt, obj.damping, state.pos.dtype),
        gravity_vector(tuple(g_dir), obj.device), **advect_kw,
    )
    if inelastic:
        state = advance_internal(obj, state, dt, group)
    return state, StepAux(aux.iterations, aux.residual)


def substep_kwargs(cfg: SimConfig) -> dict:
    return dict(
        dt=cfg.delta_time,
        g_dir=tuple(cfg.g_dir),
        implicit_method=cfg.implicit_method,
        preconditioned=cfg.preconditioned,
        robust_inversion=cfg.robust_inversion,
        cg_precond=cfg.cg_precond,
        operator_mode=cfg.operator_mode,
        use_explicit_method=cfg.use_explicit_method,
        auto_diff=cfg.auto_diff,
        element_backend=cfg.element_backend,
        hessian=cfg.hessian,
        wall_friction=cfg.wall_friction,
        jacobi_sweep=cfg.jacobi_sweep,
        solver_backend=cfg.solver_backend,
        integrator=cfg.integrator,
        newton_iters=cfg.newton_iters,
        newton_cg_iters=cfg.newton_cg_iters,
        newton_tol=cfg.newton_tol,
        newton_hessian=cfg.newton_hessian,
        newton_theta=cfg.newton_theta,
    )


def _circles_only(cfg: SimConfig) -> bool:
    """The whole-frame kernel implements the reference advection only:
    circle obstacles (frictionless spheres fold into the circle arrays) and
    frictionless walls."""
    return cfg.wall_friction == 0.0 and all(
        o.type == "sphere" and o.friction == 0.0 for o in cfg.obstacles
    )


def _plain_object(obj: FemObject) -> bool:
    """No pins, loads or Rayleigh β: what the whole-frame kernels leave
    out, as the JAX package's do."""
    return (obj.free_mask is None and obj.static_load is None
            and obj.damping_beta == 0.0)


def supports_blocked_frame(obj: FemObject, cfg: SimConfig) -> bool:
    """Eligibility for the whole-frame kernel K5: the JAX package's config
    conditions (sim.py:275-308), with its VMEM gate replaced by what the
    port's kernel covers: 2D or 3D, every material with or without its
    plastic and Maxwell branches, ``robust_inversion`` included."""
    return (
        obj.dim in (2, 3)
        and not cfg.adaptive_dt
        and _circles_only(cfg)
        and cfg.integrator == "semi_implicit"
        and not cfg.use_explicit_method
        and not cfg.auto_diff
        and cfg.implicit_method == CONJUGATE_GRADIENT_METHOD
        and cfg.hessian == "reference"
        and cfg.operator_mode in ("auto", "fused")
        and cfg.element_backend in ("auto", "pallas")
        and cfg.solver_backend == "auto"
        and cfg.cg_precond in ("reference", "none")
        and _plain_object(obj)
        and obj.blocking is not None
    )


def _internal_kwargs(obj: FemObject, state: SimState) -> dict:
    """The whole-frame kernels' inelastic arguments (JAX sim.py:341-352)."""
    return dict(
        plastic_inv=state.plastic_inv if obj.plastic_yield > 0.0 else None,
        plastic_yield=obj.plastic_yield,
        viscous_inv=state.viscous_inv if obj.viscous_mu > 0.0 else None,
        viscous_mu=obj.viscous_mu, viscous_tau=obj.viscous_tau,
    )


def _with_internal(obj: FemObject, state: SimState, extra) -> SimState:
    """``state`` with the internal inverses a frame returned after its
    other outputs (plastic first, then viscous)."""
    extra = list(extra)
    if obj.plastic_yield > 0.0:
        state = state.replace(plastic_inv=extra.pop(0))
    if obj.viscous_mu > 0.0:
        state = state.replace(viscous_inv=extra.pop(0))
    return state


def make_blocked_frame_fn(obj: FemObject, cfg: SimConfig):
    """Frame function backed by the whole-frame kernel: one launch per
    rendered frame (``ops/frame_kernels.py``; its plain version on the
    CPU)."""
    kwargs = dict(
        dt=cfg.delta_time, damping=obj.damping, g_dir=tuple(cfg.g_dir),
        mu=obj.mu, s_lambda=obj.s_lambda,
        preconditioned=cfg.preconditioned == 1 and cfg.cg_precond == "reference",
        sim_count=cfg.sim_count, robust=cfg.robust_inversion,
        material=obj.material,
    )

    def frame(state: SimState, obstacles: Obstacles):
        pos, vel, vel_g, iters, res, *extra = fused_blocked_frame(
            obj.blocking, state.pos, state.vel, state.vel_g, obj.mass,
            obstacles.centers, obstacles.radii, **kwargs,
            **_internal_kwargs(obj, state),
        )
        state = state.replace(pos=pos, vel=vel, vel_g=vel_g)
        return _with_internal(obj, state, extra), StepAux(iters, res)

    return frame


def supports_explicit_blocked_frame(obj: FemObject, cfg: SimConfig) -> bool:
    """Eligibility for the explicit whole-frame kernel K8: the JAX package's
    config conditions (sim.py:311-332), with its VMEM gate replaced by what
    the port's kernel covers: 2D or 3D, every material with or without its
    plastic and Maxwell branches."""
    return (
        obj.dim in (2, 3)
        and not cfg.adaptive_dt
        and _circles_only(cfg)
        and _explicit(cfg)
        and cfg.element_backend in ("auto", "pallas")
        and _plain_object(obj)
        and obj.blocking is not None
    )


def make_explicit_blocked_frame_fn(obj: FemObject, cfg: SimConfig):
    """Explicit or autodiff frame backed by the explicit whole-frame kernel:
    one launch per rendered frame (its plain version on the CPU).  It runs
    the analytic gradient chain for autodiff configs too, as the JAX
    package's does: the same formula up to the order of its sums.

    What is fixed per (object, config) is bound once, here: the frame's
    keyword arguments, and on a CUDA object K8's plan, its checked operands
    and its prebuilt launch (``frame_kernels.explicit_frame_binding``,
    which the frame's call finds again by the blocking's and the mass's
    identity and version counters, so a replaced or changed mass or
    blocking binds anew).  Each frame then passes only its state and
    obstacles; its outputs are fresh tensors.  The zero solver metrics and
    the zero ``force`` are made once and returned every frame."""
    kwargs = dict(
        dt=cfg.delta_time, damping=obj.damping, g_dir=tuple(cfg.g_dir),
        mu=obj.mu, s_lambda=obj.s_lambda, sim_count=cfg.sim_count,
        material=obj.material, plastic_yield=obj.plastic_yield,
        viscous_mu=obj.viscous_mu, viscous_tau=obj.viscous_tau,
    )
    plastic, viscous = obj.plastic_yield > 0.0, obj.viscous_mu > 0.0
    if obj.device.type == "cuda":
        explicit_frame_binding(obj.blocking, obj.mass, **kwargs)
    aux = StepAux(
        torch.zeros((cfg.sim_count,), dtype=torch.int32, device=obj.device),
        torch.zeros((cfg.sim_count,), dtype=torch.float32, device=obj.device),
    )
    force = torch.zeros_like(obj.rest_pos)

    def frame(state: SimState, obstacles: Obstacles):
        pos, vel, *extra = fused_explicit_frame(
            obj.blocking, state.pos, state.vel, obj.mass, obstacles.centers,
            obstacles.radii, **kwargs,
            plastic_inv=state.plastic_inv if plastic else None,
            viscous_inv=state.viscous_inv if viscous else None,
        )
        state = state.replace(pos=pos, vel=vel, force=force)
        return _with_internal(obj, state, extra), aux

    return frame


def make_adaptive_frame_fn(obj: FemObject, cfg: SimConfig):
    """Guarded frame of an ``adaptive_dt`` config (the JAX package's
    frame-level guard, its sim.py:489-577): κ is measured once a frame
    (``solvers/adaptive.kappa_estimate``), its split level read on the host
    (one read a frame), and all ``sim_count`` substeps run at that level's
    dt/n, n ∈ (1, 2, 4, 8).

    When the config without the guard is eligible for K5 and
    ``frame_backend`` is ``"blocked"``, or ``"auto"`` on a CUDA object,
    each level is a K5 frame function at dt/n over sim_count·n substeps
    built here, so a guarded frame is K2 (for κ) and one K5 launch; its
    metrics are folded back to (sim_count,): iterations summed over each
    outer substep's n inner steps, the residual of the last.  Otherwise
    the op-composed frame runs n substeps at dt/n per outer substep."""
    kwargs = substep_kwargs(cfg)
    dt = kwargs.pop("dt")
    unguarded = dataclasses.replace(cfg, adaptive_dt=False)
    frames = {}
    if supports_blocked_frame(obj, unguarded) and (
        cfg.frame_backend == "blocked"
        or (cfg.frame_backend == "auto" and obj.device.type == "cuda")
    ):
        frames = {
            n: make_blocked_frame_fn(obj, dataclasses.replace(
                unguarded, delta_time=cfg.delta_time / n,
                sim_count=cfg.sim_count * n))
            for n in LEVELS
        }

    def frame(state: SimState, obstacles: Obstacles):
        kappa = kappa_estimate(obj, state.pos, dt, cfg.robust_inversion)
        n = LEVELS[read_level(kappa, cfg.adaptive_dt_threshold)]
        if frames:
            state, aux = frames[n](state, obstacles)
            return state, StepAux(
                aux.solver_iterations.reshape(cfg.sim_count, n).sum(dim=1)
                .to(torch.int32),
                aux.solver_residual.reshape(cfg.sim_count, n)[:, -1],
            )
        def sub_at(dt_eff, st):
            return substep(obj, st, obstacles, dt=dt_eff, **kwargs)

        iters, res = [], []
        for _ in range(cfg.sim_count):
            state, it, r = inner_substeps(sub_at, state, dt, n)
            iters.append(it)
            res.append(r)
        return state, StepAux(torch.stack(iters), torch.stack(res))

    return frame


def make_frame_fn(obj: FemObject, cfg: SimConfig):
    """Function advancing one rendered frame (``sim_count`` substeps):
    ``frame(state, obstacles) -> (state, StepAux)`` with StepAux fields of
    shape ``(sim_count,)`` left on the device.

    ``frame_backend``: ``"fused"`` runs the unblocked whole-frame kernel
    K11b (``experiments/fused_frame.py``), decided first, as in the JAX
    package; ``"blocked"`` runs the whole-frame kernel K5 and
    ``"blocked_explicit"`` the explicit whole-frame kernel K8 (each its
    plain version on the CPU), and each of the three raises ``ValueError``
    when the config is not eligible; ``"auto"`` runs the eligible one of K5
    and K8 on a CUDA object, and the op-composed frame otherwise.  An
    ``adaptive_dt`` config runs the guarded frame
    (:func:`make_adaptive_frame_fn`), never the plain K5 route; there
    ``"blocked"`` asks for K5 under the guard and raises ``ValueError``
    when the config without the guard is not eligible for it."""
    if cfg.frame_backend == "fused":
        if not supports_fused_frame(obj, cfg):
            raise ValueError(
                "frame_backend='fused' requested but this config/mesh is not "
                "eligible (see experiments/fused_frame.supports_fused_frame)"
            )
        return make_fused_frame_fn(obj, cfg)
    if cfg.frame_backend == "blocked" and not supports_blocked_frame(
            obj, dataclasses.replace(cfg, adaptive_dt=False)):
        raise ValueError(
            "frame_backend='blocked' requested but this config/mesh is not "
            "eligible (see sim.supports_blocked_frame)"
        )
    if (cfg.frame_backend == "blocked_explicit"
            and not supports_explicit_blocked_frame(obj, cfg)):
        raise ValueError(
            "frame_backend='blocked_explicit' requested but this config/mesh "
            "is not eligible (see sim.supports_explicit_blocked_frame)"
        )
    check_supported_config(cfg)
    if cfg.adaptive_dt:
        return make_adaptive_frame_fn(obj, cfg)
    auto_cuda = cfg.frame_backend == "auto" and obj.device.type == "cuda"
    if cfg.frame_backend == "blocked" or (
        auto_cuda and supports_blocked_frame(obj, cfg)
    ):
        return make_blocked_frame_fn(obj, cfg)
    if cfg.frame_backend == "blocked_explicit" or (
        auto_cuda and supports_explicit_blocked_frame(obj, cfg)
    ):
        return make_explicit_blocked_frame_fn(obj, cfg)
    kwargs = substep_kwargs(cfg)

    def frame(state: SimState, obstacles: Obstacles):
        iters, res = [], []
        for _ in range(cfg.sim_count):
            state, aux = substep(obj, state, obstacles, **kwargs)
            iters.append(aux.solver_iterations)
            res.append(aux.solver_residual)
        return state, StepAux(torch.stack(iters), torch.stack(res))

    return frame


def make_substep_fn(obj: FemObject, cfg: SimConfig):
    """``step(state, obstacles) -> (state, StepAux)``: one substep (tests
    and fine-grained stepping).  An ``adaptive_dt`` config runs the guard
    per substep (``solvers/adaptive.adaptive_substep``: κ and one host read
    of its split level each substep, iterations summed over the inner
    steps, the last inner step's residual)."""
    check_supported_config(cfg)
    kwargs = substep_kwargs(cfg)
    if not cfg.adaptive_dt:
        def step(state: SimState, obstacles: Obstacles):
            return substep(obj, state, obstacles, **kwargs)

        return step
    dt = kwargs.pop("dt")

    def adaptive_step(state: SimState, obstacles: Obstacles):
        def sub_at(dt_eff, st):
            return substep(obj, st, obstacles, dt=dt_eff, **kwargs)

        state, iters, res = adaptive_substep(
            sub_at, obj, state, dt=dt, threshold=cfg.adaptive_dt_threshold,
            robust=cfg.robust_inversion)
        return state, StepAux(iters, res)

    return adaptive_step


def element_phi(obj: FemObject, state: SimState) -> torch.Tensor:
    """Per-element energy V·φ, (E,), for render colouring (the reference's
    ``obj.phi``, sized by elements); an inelastic material's through its
    material layers."""
    if is_inelastic(obj):
        return inelastic_element_energies(obj, state, state.pos)
    return element_energies(state.pos, obj.element_indices, obj.ref_inv,
                            obj.volume, obj.mu, obj.s_lambda, obj.material)


def element_von_mises(obj: FemObject, state: SimState) -> torch.Tensor:
    """Per-element von Mises equivalent stress, (E,), of the base
    material's Cauchy stress (``ops/element.cauchy_stress``)."""
    return von_mises(element_stresses(
        state.pos, obj.element_indices, obj.ref_inv, obj.mu, obj.s_lambda,
        obj.material))
