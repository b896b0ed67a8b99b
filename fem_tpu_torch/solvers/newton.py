# coding=utf-8
"""Fully implicit (true Newton) backward-Euler velocity solve.

The port of the JAX package's ``solvers/newton.py``
(``SimConfig.integrator = "newton"``).  The reference's implicit method
makes one linearized solve per substep, which goes NaN once
κ = dt²·‖K‖/m nears 1; this solver closes the nonlinear residual

    r(v) = (v − vₙ) − dt·M⁻¹·f_el(xₙ + dt·v)  =  0

by damped Newton: each step solves J·δ = −r by an inexact inner CG
(a 1e-4 relative drop in rᵀr, never below the outer tolerance's scale)
and backtracks on ‖r‖∞ (a NaN residual reads as +inf and is rejected).
Gravity, damping and collisions stay in the advection step
(``sim.substep``).  Two Jacobians (``newton_hessian``):

* ``"exact"``: J = I + dt²·M⁻¹·K(x), K·w the exact Hessian-vector product
  of the plain assembled force (the JAX package's ``jax.jvp``, which XLA
  compiles), through each element's Jacobian formed once a Newton step by
  ``torch.func.jvp`` (``implicit.element_linearization``), so that an
  inner iteration's product is one launch of the stiffness kernel H1 on a
  CUDA object (its plain gather, product and assembly on the CPU);
* ``"decoupled"``: modified Newton on the reference's one-block-per-element
  linearization.  One element prep gives both the residual force and the
  operator's K: on an object with locality blocks and element backend
  ``"pallas"`` (``"auto"`` on a CUDA object) the blocked prep K2 per
  material layer, each launch ending in its layer's assembled force, and
  every operator apply the blocked operator K3 — the JAX package's TPU
  route; with ``"xla"`` (``"auto"`` on the CPU) the plain element blocks
  and force columns on the block-ordered copies, their assembly K7a and
  the applies K3 — its XLA route; without locality blocks K1 (``"pallas"``)
  or the plain element chain, and the plain graph operator.  On a CPU
  object every kernel is its plain version.

The inner solve is plain CG, the block-Jacobi PCG (``cg_precond=
"block_jacobi"``) or the two-level PCG (``"two_level"``,
``"two_level_cheb<k>"``, ``solvers/multilevel.py``), the last two in
decoupled mode only; the two-level preconditioner is built once a substep
at the initial iterate (its blocks, coarse matrix, factor and power-
iterated ω/λmax) and frozen.  β (Rayleigh damping) adds β·G(K)·v to the
force, and the θ-scheme (``theta`` < 1) evaluates the force at
x_θ = xₙ + θ·dt·((1 − θ)·vₙ + θ·v); every Jacobian coefficient becomes
dt·(dt + β_eff), β_eff = β − (1 − θ²)·dt.

The JAX package's ``lax.while_loop`` and ``lax.cond`` become Python loops
and branches: the outer test reads ‖r‖∞ on the host once a Newton step,
the line search once a trial, and the inner loops rᵀr once an iteration.
The Newton steps and line-search trials of the last call are left in
``newton_velocity_solve.last_steps`` / ``last_trials`` and summed, with
the solves and inner iterations, in ``newton_velocity_solve.totals``
(what ``chip_smoke.py`` holds the kernels' launch counts to).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from fem_tpu_torch.models.state import FemObject, SimState
from fem_tpu_torch.ops import element
from fem_tpu_torch.ops import element_kernels as ek
from fem_tpu_torch.ops.assembly import (
    all_reduce_sum,
    element_contrib_full,
    element_gather_plan,
    segment_assemble,
)
from fem_tpu_torch.ops.blocked_kernels import (
    blocked_assemble,
    blocked_graph_apply,
    blocked_prep_force,
    blocked_system_applies,
)
from fem_tpu_torch.ops.cg_kernels import (
    conjugate_gradient,
    diagonal_blocks_from,
    preconditioned_conjugate_gradient,
)
from fem_tpu_torch.ops.inelastic import (
    layer_ref_inv_blocked,
    layer_ref_inv_local,
    normalize_layers,
    sum_layers,
)
from fem_tpu_torch.solvers.implicit import (
    ImplicitAux,
    _assembled_force,
    _force_columns,
    _one_layer_force_columns,
    element_linearization,
    graph_block_apply,
    make_system_apply,
)
from fem_tpu_torch.solvers.multilevel import (
    coarse_matrix,
    make_coarse_space,
    parse_two_level_precond,
    two_level_pcg,
    two_level_setup,
)


def _resolve_backend(element_backend: str, device: torch.device) -> str:
    """``"auto"`` is ``"pallas"`` (the kernels) on a CUDA object and
    ``"xla"`` (the plain element chain) on the CPU, as the JAX package
    resolves it on its TPU and its CPU."""
    if element_backend == "auto":
        return "pallas" if device.type == "cuda" else "xla"
    if element_backend not in ("pallas", "xla"):
        raise ValueError(f"unknown element_backend {element_backend!r}")
    return element_backend


def _decoupled_prep(obj: FemObject, pos: torch.Tensor, element_backend: str,
                    robust: bool = False, layers=None, group=None):
    """(assembled elastic force f (N, d), K) at ``pos``, summed over the
    material ``layers`` (the JAX package's ``_decoupled_prep``).  K is in
    block order (B·Eb, d, d) on an object with locality blocks, else in
    mesh order: what :func:`_decoupled_apply` takes.  With ``group`` f is
    summed over its ranks (K stays the rank's)."""
    blk = obj.blocking
    lys = normalize_layers(obj, layers)
    if blk is not None and element_backend == "pallas":
        K, f = sum_layers(
            blocked_prep_force(
                blk, pos, mu, lam,
                None if fi is None else layer_ref_inv_blocked(blk, fi),
                material, robust)
            for fi, mu, lam, material in lys)
        return all_reduce_sum(f, group), K
    if blk is not None:
        K, cols = sum_layers(
            _plain_k_and_cols(pos, blk.element_indices,
                              layer_ref_inv_blocked(blk, fi), blk.volume,
                              mu, lam, material, robust)
            for fi, mu, lam, material in lys)
        return all_reduce_sum(blocked_assemble(blk, cols), group), K
    if element_backend == "pallas":
        K, cols = sum_layers(
            ek.hessian_and_force(
                pos, obj.element_indices,
                layer_ref_inv_local(obj.ref_inv, fi, obj.element_start), obj.volume, mu, lam,
                robust, material)
            for fi, mu, lam, material in lys)
    else:
        K, cols = sum_layers(
            _plain_k_and_cols(pos, obj.element_indices,
                              layer_ref_inv_local(obj.ref_inv, fi, obj.element_start),
                              obj.volume, mu, lam, material, robust)
            for fi, mu, lam, material in lys)
    return segment_assemble(element_contrib_full(cols), obj.element_indices,
                            obj.particle_cnt, group, obj.plan), K


def _plain_k_and_cols(pos, element_indices, ref_inv, volume, mu, lam,
                      material, robust):
    """(K, rhs force columns) of one layer in plain PyTorch (the JAX
    package's XLA ``_k_and_force_cols``)."""
    return (element.hessian_blocks(pos, element_indices, ref_inv, volume, mu,
                                   lam, robust, material),
            _one_layer_force_columns(pos, element_indices, ref_inv, volume,
                                     mu, lam, material, robust))


def _decoupled_apply(obj: FemObject, K: torch.Tensor, dt: float,
                     beta: float = 0.0, group=None):
    """w ↦ w − dt·(dt + β)·M⁻¹·G(K)·w from a stored K (the JAX package's
    ``_decoupled_apply``): the blocked operator (K3) on an object with
    locality blocks, else the graph operator; each product summed over the
    ranks of ``group``."""
    if obj.blocking is not None:
        return blocked_system_applies(obj.blocking, K, obj.mass, dt, beta,
                                      group=group)[0]
    return make_system_apply(obj, K, dt, beta, group)


def _decoupled_minv_gk(obj: FemObject, K: torch.Tensor, group=None):
    """w ↦ M⁻¹·G(K)·w from a stored K (the JAX package's
    ``_decoupled_minv_gk``): the damping force's product."""
    blk = obj.blocking

    def apply_gk(w: torch.Tensor) -> torch.Tensor:
        if blk is not None:
            gw = all_reduce_sum(blocked_graph_apply(blk, K, w), group)
        else:
            gw = graph_block_apply(obj, K, w, group)
        return gw / obj.mass[:, None]

    return apply_gk


def _res_norm(r: torch.Tensor) -> Tuple[torch.Tensor, float]:
    """(max |r| as a 0-d tensor, the same on the host), NaN read as +inf."""
    m = torch.max(torch.abs(r))
    m = torch.where(torch.isnan(m), torch.full_like(m, float("inf")), m)
    return m, float(m)


def newton_velocity_solve(
    obj: FemObject,
    state: SimState,
    dt: float,
    max_newton: int = 10,
    cg_iters: int = 120,
    tol: float = 1e-5,
    n_backtrack: int = 10,
    hessian_mode: str = "exact",
    element_backend: str = "auto",
    cg_precond: str = "none",
    robust: bool = False,
    beta: float = 0.0,
    theta: float = 1.0,
    layers=None,
    v_n_pos: Optional[torch.Tensor] = None,
    group=None,
) -> Tuple[SimState, ImplicitAux]:
    """Solve r(v) = 0 for the end-of-substep velocity; vel ← v (the JAX
    package's ``newton_velocity_solve``, argument for argument, its
    ``axis_name`` the ``group`` of element sharding: every assembly, K3
    product and exact-Hessian product (H1 on the rank's elements) summed
    over the ranks, one all-reduce each, and the Newton, line-search and
    inner CG loops run on every rank alike, their stop tests on summed
    values).

    Converged when max |P·r| ≤ ``tol``, or after ``max_newton`` steps or 3
    line-search failures in a row.  Pins: the iterate starts at vₙ on free
    vertices and ``pin_vel`` (or 0) on pinned ones, and every residual,
    step and operator is projected.  ``v_n_pos`` is the physical
    (unfolded) start velocity for the θ-weighted position; the residual's
    vₙ is ``state.vel``, which carries a folded external force.  Returns
    the state with the new velocity and ``ImplicitAux(total inner
    iterations, final ‖P·r‖∞²)``, both on the object's device."""
    if hessian_mode not in ("exact", "decoupled"):
        raise ValueError(
            f"newton_hessian must be 'exact' or 'decoupled', "
            f"got {hessian_mode!r}"
        )
    use_pcg = cg_precond == "block_jacobi"
    use_two_level, tl_smoother, tl_degree = parse_two_level_precond(
        cg_precond)
    if (use_pcg or use_two_level) and hessian_mode != "decoupled":
        raise ValueError(
            f"integrator='newton' with cg_precond={cg_precond!r} requires "
            "newton_hessian='decoupled' (the exact-HVP mode assembles no "
            "K blocks; use cg_precond='none' there)"
        )
    if use_two_level and obj.agg_ids is None:
        raise ValueError(
            "cg_precond='two_level' needs the coarse space attached at "
            "build time (models/state.build_object)"
        )
    backend = _resolve_backend(element_backend, obj.device)
    beta_eff = beta - (1.0 - theta * theta) * dt
    inv_m = 1.0 / obj.mass[:, None]
    free = obj.free_mask
    held = None if free is None else 1.0 - free
    v_n = state.vel
    v_n_pos = v_n if v_n_pos is None else v_n_pos
    x_n = state.pos
    decoupled = hessian_mode == "decoupled"
    force_cols = _force_columns(obj, robust, layers)
    force_local = None if decoupled else _assembled_force(obj, robust, layers)
    totals = newton_velocity_solve.totals
    trials = 0

    def project(r):
        return r if free is None else free * r

    def position(v):
        if theta == 1.0:  # the backward-Euler form, bit for bit
            return x_n + dt * v
        return x_n + (theta * dt) * ((1.0 - theta) * v_n_pos + theta * v)

    def eval_at(v):
        """(projected residual, K) at iterate ``v``; in decoupled mode one
        element prep gives both."""
        pos = position(v)
        if decoupled:
            f, K = _decoupled_prep(obj, pos, backend, robust, layers, group)
            r = (v - v_n) - dt * inv_m * f
            if beta != 0.0:
                r = r - dt * beta * _decoupled_minv_gk(obj, K, group)(v)
        else:
            f, K = all_reduce_sum(force_local(pos), group), None
            if beta != 0.0:
                _, df_v = torch.func.jvp(force_local, (pos,), (v,))
                f = f + beta * all_reduce_sum(df_v, group)
            r = (v - v_n) - dt * inv_m * f
        return project(r), K

    def projected(base):
        if free is None:
            return base
        return lambda w: free * base(free * w) + held * w

    def diag_of(K):
        """The decoupled Jacobian's diagonal blocks, pinned rows the
        identity."""
        if obj.blocking is not None and group is not None:
            # A rank's blocks: assembled in block order, then summed.
            idx = obj.blocking.element_indices
            diag = diagonal_blocks_from(
                idx, K, obj.mass, dt,
                element_gather_plan(idx, obj.particle_cnt).idx, beta_eff,
                group)
        else:
            if obj.blocking is not None:  # block order → mesh order
                K = K[obj.blocking.element_slot.long()]
            diag = diagonal_blocks_from(obj.element_indices, K, obj.mass,
                                        dt, obj.plan.idx, beta_eff)
        if free is None:
            return diag
        eye = torch.eye(obj.dim, dtype=diag.dtype, device=diag.device)[None]
        f3 = free[..., None]
        return f3 * diag + (1.0 - f3) * eye

    if free is None:
        v = v_n
    elif obj.pin_vel is not None:
        v = free * v_n + held * obj.pin_vel
    else:
        v = free * v_n
    r, K = eval_at(v)
    trials += 1
    tl_setup = None
    if use_two_level:
        # Built once a substep at the initial iterate and frozen: the
        # blocks, the coarse matrix and its factor, and ω/λmax by power
        # iteration on the same operator.
        coarse = make_coarse_space(obj)
        idx = (obj.blocking.element_indices if obj.blocking is not None
               else obj.element_indices)
        c_mat = coarse_matrix(coarse, obj, K, dt, beta_eff, free, idx,
                              group=group)
        tl_setup = two_level_setup(
            diag_of(K), obj.mass, coarse, c_mat, free,
            operator=projected(_decoupled_apply(obj, K, dt, beta_eff,
                                                group)))
    gn, gn_f = _res_norm(r)
    tol_f32 = float(torch.tensor(tol, dtype=torch.float32))
    steps = fails = 0
    cg_total = torch.zeros((), dtype=torch.int32, device=v.device)
    while steps < max_newton and gn_f > tol_f32 and fails < 3:
        if decoupled:
            base_op = _decoupled_apply(obj, K, dt, beta_eff, group)
        else:
            hvp = element_linearization(force_cols, position(v),
                                        obj.element_indices, obj.plan)
            coeff = dt * (theta * theta * dt + beta)

            def base_op(w, hvp=hvp, coeff=coeff):
                return w - coeff * inv_m * all_reduce_sum(hvp(w), group)

        op = projected(base_op)
        rr = torch.sum(r * r)
        # Inexact Newton: a 1e-4 relative drop in rᵀr, floored at the outer
        # tolerance's scale.
        inner_tol = torch.clamp(1e-4 * rr, min=tol * tol)
        zeros = torch.zeros_like(r)
        if use_two_level:
            sol = two_level_pcg(
                op, None, obj.mass, None, None, -r, zeros,
                max_iter=cg_iters, tol=inner_tol, free_mask=free,
                setup=tl_setup, smoother=tl_smoother, cheb_degree=tl_degree)
        elif use_pcg:
            sol = preconditioned_conjugate_gradient(
                op, diag_of(K), obj.mass, -r, zeros, cg_iters, inner_tol)
        else:
            sol = conjugate_gradient(op, -r, zeros, cg_iters, inner_tol)
        delta = project(sol.x)
        # Backtracking on ‖r‖∞ from the full step, halving up to
        # n_backtrack − 1 times.
        t = 1.0
        r_new, k_new = eval_at(v + delta)
        rn, rn_f = _res_norm(r_new)
        k = 1
        while rn_f >= gn_f and k < n_backtrack:
            t = 0.5 * t
            r_new, k_new = eval_at(v + t * delta)
            rn, rn_f = _res_norm(r_new)
            k += 1
        trials += k
        if rn_f < gn_f:
            v, r, K, gn, gn_f = v + t * delta, r_new, k_new, rn, rn_f
            fails = 0
        else:
            fails += 1
        steps += 1
        cg_total = cg_total + sol.iterations
    newton_velocity_solve.last_steps = steps
    newton_velocity_solve.last_trials = trials
    totals["solves"] += 1
    totals["steps"] += steps
    totals["trials"] += trials
    totals["cg"] += int(cg_total)
    return state.replace(vel=v), ImplicitAux(cg_total, gn * gn)


newton_velocity_solve.last_steps = 0
newton_velocity_solve.last_trials = 0
# Summed over calls until reset: solves, Newton steps, residual
# evaluations (the initial one and every line-search trial) and inner
# iterations.
newton_velocity_solve.totals = dict(solves=0, steps=0, trials=0, cg=0)
