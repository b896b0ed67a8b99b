# coding=utf-8
"""Quasi-static equilibrium solve.

The port of the JAX package's ``solvers/static.py``: the static problem

    min_x  Π(x) = U(x) − f_extᵀ·x     with the pinned vertices held,

by damped Newton on the Dirichlet-projected exact Hessian (its products
through each element's Jacobian of the plain energy-gradient columns,
formed once an iteration by ``torch.func.jvp``:
``implicit.element_linearization``, each product one launch of the
stiffness kernel H1 on a CUDA object; the JAX package takes ``jax.jvp`` of
the assembled gradient), a Levenberg shift λ adapted ×8
up and ×4 down, and a backtracking line search on the residual with the
potential as a divergence guard.  Everything else is plain PyTorch on
either device, as the JAX package computes it in XLA; the JAX package's
``lax.while_loop`` becomes a Python loop that reads the residual norm and
the line search's acceptance on the host once an iteration, and its
``jax.vmap`` over the trial steps a loop over them with the same
acceptance rule.

``cg_precond="two_level…"`` runs the inner solves as the two-level PCG
(``solvers/multilevel.py``) with the preconditioner built once at ``pos0``
from the decoupled blocks (``static_diag_blocks``, ``coarse_matrix`` with
coeff 1 and no mass) and frozen, ω/λmax power-iterated on the exact
operator at ``pos0``.

Needs ``obj.free_mask`` (``pin_boxes``): an unconstrained body has a
rigid-motion null space and no unique equilibrium.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from fem_tpu_torch.ops.assembly import element_contrib_full, gather_assemble
from fem_tpu_torch.ops.cg_kernels import conjugate_gradient
from fem_tpu_torch.ops.element import (
    explicit_grad_columns,
    hessian_blocks,
    total_energy,
)
from fem_tpu_torch.solvers.implicit import element_linearization
from fem_tpu_torch.solvers.multilevel import (
    coarse_matrix,
    make_coarse_space,
    parse_two_level_precond,
    static_diag_blocks,
    two_level_pcg,
    two_level_setup,
)


class StaticResult(NamedTuple):
    pos: torch.Tensor  # (N, d) equilibrium positions
    iterations: torch.Tensor  # Newton iterations taken (int32)
    grad_norm: torch.Tensor  # final max |projected residual force|
    energy: torch.Tensor  # final total potential Π
    converged: torch.Tensor  # bool: grad_norm ≤ the effective tolerance
    stalled: torch.Tensor  # bool: stopped at the f32 progress floor instead
    cg_iterations: torch.Tensor  # total inner CG iterations (int32)


def gravity_force(obj, g_dir: Tuple[float, ...]) -> torch.Tensor:
    """Per-vertex gravity load f = m·9.8·ĝ (N, d), the static counterpart
    of the dynamic paths' 9.8·g_dir acceleration."""
    g = 9.8 * torch.tensor(g_dir, dtype=torch.float32, device=obj.device)
    return obj.mass[:, None] * g[None, :]


def solve_static(
    obj,
    pos0: torch.Tensor,
    f_ext: Optional[torch.Tensor] = None,
    g_dir: Optional[Tuple[float, ...]] = None,
    tol: float = 1e-5,
    max_newton: int = 60,
    cg_iters: int = 400,
    n_backtrack: int = 12,
    cg_precond: str = "none",
) -> StaticResult:
    """Static equilibrium from the initial guess ``pos0`` (the JAX
    package's ``solve_static``).  Pinned vertices stay at their ``pos0``
    positions; the load is ``f_ext``, gravity along ``g_dir`` and the
    object's static load (``load_boxes``).

    Each iteration solves (P·H·P + (I − P) + λ·P)·δ = −P·g by CG (or the
    two-level PCG) to 1e-8 of gᵀg, then takes the largest step of
    t = 1, ½, …, 2^{1−n_backtrack} whose residual norm drops and whose
    potential rises by at most 1e-4·(|Π| + 1) (NaN read as +inf).
    Converged when max |P·g| ≤ max(``tol``, 16 × the f32 residual floor
    ε₃₂·Vₘₐₓ·(|μ| + |λ|)·‖R⁻¹‖ₘₐₓ); ``stalled`` after 3 line-search
    failures in a row above it."""
    if obj.free_mask is None:
        raise ValueError(
            "solve_static requires Dirichlet constraints (ObjectConfig."
            "pin_boxes / obj.free_mask): an unconstrained body has a "
            "rigid-motion null space and no unique equilibrium"
        )
    use_two_level, tl_smoother, tl_degree = parse_two_level_precond(
        cg_precond)
    if cg_precond != "none" and not use_two_level:
        raise ValueError(
            f"solve_static cg_precond must be 'none' or 'two_level[...]', "
            f"got {cg_precond!r}"
        )
    if use_two_level and obj.agg_ids is None:
        raise ValueError(
            "cg_precond='two_level' needs the coarse space attached at "
            "build time (models/state.build_object)"
        )
    free = obj.free_mask
    held = 1.0 - free
    dtype, dev = pos0.dtype, pos0.device
    load = torch.zeros_like(pos0)
    if f_ext is not None:
        load = load + f_ext
    if g_dir is not None:
        load = load + gravity_force(obj, g_dir)
    if obj.static_load is not None:
        load = load + obj.static_load

    def grad_cols(p, element_indices):
        return explicit_grad_columns(p, element_indices, obj.ref_inv,
                                     obj.volume, obj.mu, obj.s_lambda,
                                     obj.material)

    def energy_grad(p):
        return gather_assemble(
            element_contrib_full(grad_cols(p, obj.element_indices)),
            obj.plan.idx)

    def hessian_at(p):
        return element_linearization(grad_cols, p, obj.element_indices,
                                     obj.plan)

    def potential(p):
        u = total_energy(p, obj.element_indices, obj.ref_inv, obj.volume,
                         obj.mu, obj.s_lambda, obj.material)
        return u - torch.sum(load * p)

    def residual(p):
        return free * (energy_grad(p) - load)

    def res_norm(g):
        m = torch.max(torch.abs(g))
        return torch.where(torch.isnan(m), torch.full_like(m, float("inf")),
                           m)

    tl_setup = None
    if use_two_level:
        # Built once at pos0 and frozen across the Newton iterates.
        k_dec0 = hessian_blocks(pos0, obj.element_indices, obj.ref_inv,
                                obj.volume, obj.mu, obj.s_lambda, True,
                                obj.material)
        diag0 = static_diag_blocks(obj, k_dec0, 0.0)
        eye0 = torch.eye(obj.dim, dtype=diag0.dtype, device=dev)[None]
        f30 = free[..., None]
        diag0 = f30 * diag0 + (1.0 - f30) * eye0
        coarse0 = make_coarse_space(obj)
        c_mat0 = coarse_matrix(coarse0, obj, k_dec0, 0.0, free_mask=free,
                               coeff=1.0,
                               mass_vec=torch.zeros_like(obj.mass))

        hvp0 = hessian_at(pos0)

        def op0(v):
            return free * hvp0(free * v) + (1.0 - free) * v

        tl_setup = two_level_setup(diag0, torch.ones_like(obj.mass), coarse0,
                                   c_mat0, free, operator=op0)

    ts = [2.0 ** -k for k in range(n_backtrack)]  # 1, ½, …
    rinv_norm = torch.sqrt(torch.max(torch.sum(obj.ref_inv * obj.ref_inv,
                                               dim=(-2, -1))))
    f32_floor = (1.2e-7 * torch.max(obj.volume)
                 * (abs(obj.mu) + abs(obj.s_lambda)) * rinv_norm)
    tol_eff = torch.clamp(16.0 * f32_floor, min=tol)
    tol_eff_f = float(tol_eff)
    lam_scale = float(torch.tensor(abs(obj.mu) + abs(obj.s_lambda),
                                   dtype=torch.float32))
    lam = torch.zeros((), dtype=dtype, device=dev)
    x = pos0
    gnorm = res_norm(residual(pos0))
    energy = potential(pos0)
    it = fails = 0
    cg_total = torch.zeros((), dtype=torch.int32, device=dev)
    while it < max_newton and float(gnorm) > tol_eff_f and fails < 3:
        g = residual(x)

        hvp = hessian_at(x)

        def op(v, hvp=hvp, lam=lam):
            return free * (hvp(free * v) + lam * v) + held * v

        inner_tol = 1e-8 * torch.sum(g * g)
        zeros = torch.zeros_like(g)
        if use_two_level:
            sol = two_level_pcg(
                op, None, torch.ones_like(obj.mass), None, None, -g, zeros,
                max_iter=cg_iters, tol=inner_tol, free_mask=free,
                setup=tl_setup, smoother=tl_smoother, cheb_degree=tl_degree)
        else:
            sol = conjugate_gradient(op, -g, zeros, cg_iters, inner_tol)
        delta = sol.x
        e0 = potential(x)
        g0n = torch.max(torch.abs(g))
        slack = 1e-4 * (torch.abs(e0) + 1.0)
        cands = [x + t * delta for t in ts]
        e_t = torch.stack([potential(c) for c in cands])
        e_t = torch.where(torch.isnan(e_t), torch.full_like(e_t, float("inf")),
                          e_t)
        g_t = torch.stack([res_norm(residual(c)) for c in cands])
        improved = ((g_t < g0n) & (e_t <= e0 + slack)).tolist()
        if any(improved):  # the largest accepted step (ts descends)
            x = cands[improved.index(True)]
            lam = torch.clamp(lam / 4.0, min=0.0)
            fails = 0
        else:
            lam = torch.clamp(lam * 8.0, min=1e-6 * lam_scale)
            fails += 1
        gnorm = res_norm(residual(x))
        energy = potential(x)
        it += 1
        cg_total = cg_total + sol.iterations
    gnorm_f = float(gnorm)
    return StaticResult(
        pos=x,
        iterations=torch.tensor(it, dtype=torch.int32, device=dev),
        grad_norm=gnorm, energy=energy,
        converged=torch.tensor(gnorm_f <= tol_eff_f, device=dev),
        stalled=torch.tensor(fails >= 3 and gnorm_f > tol_eff_f, device=dev),
        cg_iterations=cg_total)


def make_static_solve_fn(obj, **kwargs):
    """``solve(pos0, f_ext=None) -> StaticResult`` over ``obj`` with the
    settings ``kwargs`` (the JAX package's ``make_static_solve_fn``, which
    jits the same closure)."""
    def solve(pos0, f_ext=None):
        if f_ext is None:
            f_ext = torch.zeros_like(pos0)
        return solve_static(obj, pos0, f_ext=f_ext, **kwargs)

    return solve


def solve_static_chunked(
    obj,
    pos0: torch.Tensor,
    f_ext: Optional[torch.Tensor] = None,
    chunk_newton: int = 2,
    max_newton: int = 60,
    plateau_rtol: float = 1e-3,
    **kwargs,
) -> StaticResult:
    """The static solve as repeated warm-started solves of
    ``chunk_newton`` iterations (the JAX package's
    ``solve_static_chunked``): each restart resets the stall counter and
    λ, so the f32 plateau is detected here instead — a chunk that improves
    ``grad_norm`` by less than ``plateau_rtol`` (relative) ends with
    ``stalled=True`` — and the iteration and inner counts sum over the
    chunks."""
    solve = make_static_solve_fn(obj, max_newton=chunk_newton, **kwargs)
    pos = pos0
    tot_newton = tot_cg = 0
    prev_grad = float("inf")
    res = None
    stalled = False
    while tot_newton < max_newton:
        res = solve(pos, f_ext)
        g = float(res.grad_norm)
        pos = res.pos
        tot_newton += int(res.iterations)
        tot_cg += int(res.cg_iterations)
        if bool(res.converged) or bool(res.stalled):
            stalled = bool(res.stalled)
            break
        if not g == g or g == float("inf") or g >= prev_grad * (
                1.0 - plateau_rtol):
            stalled = True
            break
        prev_grad = g
    dev = pos0.device
    return StaticResult(
        pos=res.pos,
        iterations=torch.tensor(tot_newton, dtype=torch.int32, device=dev),
        grad_norm=res.grad_norm, energy=res.energy,
        converged=res.converged,
        stalled=torch.tensor(stalled and not bool(res.converged), device=dev),
        cg_iterations=torch.tensor(tot_cg, dtype=torch.int32, device=dev))
