# coding=utf-8
"""Implicit (backward-Euler-style) velocity solve, matrix-free.

The port of the JAX package's ``solvers/implicit.py`` reference-CG subset.
Each element contributes a single block K_e in a graph-Laplacian pattern (the
reference's decoupled Hessian, solver/implicit.py:141-144), so the operator

    (K·x)|_e :  s_j = x_{v_{j+1}} − x_{v_0};  t_j = K_e s_j
                v_{j+1} += t_j,   v_0 −= Σ_j t_j
    A·x = x − dt² · (K·x) / m

is applied in O(E).  The CG keeps the reference's semantics: x₀ = b
(implicit.py:314), absolute tolerance ‖r‖² > 1e-5 (implicit.py:341), at most
500 iterations, and normal equations AᵀAx = Aᵀb when ``preconditioned == 1``
(implicit.py:289-299).

By default one substep runs two kernels: the element chain
(``ops/element_kernels``, K_e and the rhs force columns) and the whole solve
(``ops/cg_kernels``, rhs assembly and the CG loop).  With
``operator_mode="blocked"`` it runs over the locality blocks instead
(``ops/blocked_kernels``): the blocked prep once, the per-slot force
partials summed per particle, and the reference CG loop on the host over
the blocked operator, which reads ‖r‖² on the host once an iteration.  On
CUDA tensors the kernels are the hand-written CUDA ones; on CPU tensors
their plain PyTorch versions.

Every material of ``ops/element.py`` runs, and ``robust`` (the
``robust_inversion`` extension) on both branches.  An inelastic material
passes its material layers (ops/inelastic.py): the element chain (or the
blocked prep) runs once per layer on that layer's effective rest-edge
inverses and material, and the solve runs once over the summed K blocks and
force columns (partials).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from fem_tpu_torch.models.state import FemObject, SimState
from fem_tpu_torch.ops.blocked_kernels import (
    blocked_prep,
    blocked_velocity_solve,
)
from fem_tpu_torch.ops.cg_kernels import (
    conjugate_gradient,
    fused_cg_solve,
    graph_apply,
    system_applies,
)
from fem_tpu_torch.ops.assembly import element_contrib_full, gather_assemble
from fem_tpu_torch.ops.element import implicit_force_columns
from fem_tpu_torch.ops.element_kernels import (
    explicit_grad_columns,
    explicit_grad_columns_plain,
    hessian_and_force,
)
from fem_tpu_torch.ops.inelastic import (
    layer_ref_inv_blocked,
    layer_ref_inv_local,
    normalize_layers,
    sum_layers,
)
from fem_tpu_torch.utils.config import CONJUGATE_GRADIENT_METHOD, JACOBI_METHOD

__all__ = [
    "ImplicitAux",
    "conjugate_gradient",
    "graph_block_apply",
    "implicit_rhs",
    "implicit_velocity_solve",
    "make_system_apply",
    "make_system_apply_t",
    "system_coeff",
]


def graph_block_apply(
    obj: FemObject, K: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """K·x with the element-Laplacian scatter pattern; O(E)."""
    return graph_apply(K, x, obj.element_indices, obj.plan.idx)


def system_coeff(dt: float) -> float:
    """Coefficient on M⁻¹·G(K) in the implicit system: dt² (reference
    implicit.py:183-194; Rayleigh β is not ported, ROADMAP M13)."""
    return dt * dt


def make_system_apply(
    obj: FemObject, K: torch.Tensor, dt: float
) -> Callable[[torch.Tensor], torch.Tensor]:
    """A·x = x − dt²·M⁻¹·(K·x)."""
    return system_applies(
        K, obj.element_indices, obj.plan.idx, 1.0 / obj.mass, dt
    )[0]


def make_system_apply_t(
    obj: FemObject, K: torch.Tensor, dt: float
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Aᵀ·y = y − dt²·G(K)ᵀ·M⁻¹·y: the same scatter pattern with each block
    transposed (replaces the reference's explicit Aᵀ, implicit.py:289-292)."""
    return system_applies(
        K, obj.element_indices, obj.plan.idx, 1.0 / obj.mass, dt
    )[1]


def _one_layer_force_columns(pos, element_indices, ref_inv, volume, mu, lam,
                             material, robust):
    """Implicit rhs force columns of one material layer in plain PyTorch:
    the Neo-Hookean rhs chain (λ/2·log det F² form) for ``neo_hookean``,
    −V·P(F)·R⁻ᵀ for every other material (the JAX package's
    ``_one_layer_force_columns``)."""
    if material == "neo_hookean":
        return implicit_force_columns(pos, element_indices, ref_inv, volume,
                                      mu, lam, robust)
    return -explicit_grad_columns_plain(pos, element_indices, ref_inv, volume,
                                        mu, lam, material)


def implicit_rhs(obj: FemObject, state: SimState, dt: float,
                 robust: bool = False, element_backend: str = "auto",
                 layers=None) -> torch.Tensor:
    """b = v + dt·M⁻¹·f_elastic (N, d), f summed over material ``layers``
    (the JAX package's ``implicit_rhs``, its solvers/implicit.py:444-485).
    ``element_backend`` "pallas" ("auto" on a CUDA object) sends a non-NH
    layer's columns to the gradient-columns kernel K6, negated, and a
    non-robust Neo-Hookean layer's to K1's rhs half (the JAX package runs
    K9b there, the rhs half of K1 as a kernel of its own, which the port
    keeps queued as a K1 entry); everything else runs the plain columns."""
    if element_backend == "auto":
        element_backend = "pallas" if state.pos.device.type == "cuda" else "xla"
    cols = []
    for fi, mu, lam, material in normalize_layers(obj, layers):
        r_eff = layer_ref_inv_local(obj.ref_inv, fi)
        args = (state.pos, obj.element_indices, r_eff, obj.volume, mu, lam)
        if element_backend == "pallas" and material != "neo_hookean":
            cols.append(-explicit_grad_columns(*args, material))
        elif element_backend == "pallas" and not robust:
            cols.append(hessian_and_force(*args)[1])
        else:
            cols.append(_one_layer_force_columns(*args, material, robust))
    f = gather_assemble(element_contrib_full(sum_layers(cols)), obj.plan.idx)
    return state.vel + dt * f / obj.mass[:, None]


class ImplicitAux(NamedTuple):
    iterations: torch.Tensor
    residual: torch.Tensor


def implicit_velocity_solve(
    obj: FemObject,
    state: SimState,
    dt: float,
    method: int,
    preconditioned: int,
    robust: bool = False,
    cg_precond: str = "reference",
    operator_mode: str = "auto",
    layers=None,
) -> Tuple[SimState, ImplicitAux]:
    """Assemble (matrix-free) and solve for the new velocity; returns the
    updated state (vel ← x, implicit.py:222-223) and the solver metrics, all
    left on the object's device.  ``operator_mode="blocked"`` takes the
    blocked operator (the JAX package's blocked branch with
    ``element_backend="pallas"``); every other mode the whole-solve kernel.
    ``layers``: the material layers (None: the one elastic layer)."""
    if method == JACOBI_METHOD:
        raise NotImplementedError(
            "the Jacobi solver (implicit_method=0) is not ported yet "
            "(ROADMAP M10)"
        )
    if method != CONJUGATE_GRADIENT_METHOD:
        raise ValueError(f"unknown implicit method {method}")
    if cg_precond not in ("reference", "none"):
        raise NotImplementedError(
            f"cg_precond={cg_precond!r} is not ported yet (ROADMAP M13)"
        )
    normal = preconditioned == 1 and cg_precond == "reference"
    lys = normalize_layers(obj, layers)
    if operator_mode == "blocked":
        return _blocked_solve(obj, state, dt, normal, robust, lys)
    K, cols = sum_layers(
        hessian_and_force(
            state.pos, obj.element_indices,
            layer_ref_inv_local(obj.ref_inv, fi), obj.volume, mu, lam, robust,
            material,
        )
        for fi, mu, lam, material in lys
    )
    vel, iters, residual = fused_cg_solve(
        K, cols, obj.element_indices, obj.plan, state.vel, obj.mass, dt,
        normal,
    )
    return state.replace(vel=vel), ImplicitAux(iters, residual)


def _blocked_solve(
    obj: FemObject, state: SimState, dt: float, normal: bool, robust: bool,
    layers,
) -> Tuple[SimState, ImplicitAux]:
    """The blocked branch (JAX implicit.py:1080-1101): K2 per material
    layer, the slot-sum assembly of the summed partials, b = v + dt·f/m,
    then the reference CG over A and Aᵀ built from K3 on the summed K."""
    if obj.blocking is None:
        raise ValueError("operator_mode='blocked' requires obj.blocking")
    blk = obj.blocking
    prepped = sum_layers(
        blocked_prep(
            blk, state.pos, mu, lam,
            None if fi is None else layer_ref_inv_blocked(blk, fi), material,
            robust)
        for fi, mu, lam, material in layers
    )
    res = blocked_velocity_solve(blk, prepped, state.vel, obj.mass, dt, normal)
    return state.replace(vel=res.x), ImplicitAux(res.iterations, res.residual)

