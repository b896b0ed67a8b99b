# coding=utf-8
"""The adaptive-dt κ-guard (``adaptive_dt: true``).

The port of the JAX package's ``solvers/adaptive.py``.  The reference
integrates at a fixed dt with no stability monitor, and at scale that
silently NaNs: the decoupled-Hessian integrator blows up as
κ = dt²·‖K‖/m approaches 1, when elements shrink or a deep squash stiffens
them.  The guard measures that indicator and, past ``threshold``, splits a
substep into 2, 4 or 8 inner steps at dt/n (κ ∝ dt², so halving dt quarters
κ).  Guarded trajectories leave fixed-dt parity the moment a split triggers.

κ is built from the elastic layer only: the Maxwell branch's stiffness and
the plastic rest-state growth of an inelastic material are left out, as in
the JAX package (ROADMAP F3, kept for parity).

Where the JAX package picks the split level on the device (``lax.switch``),
the port reads it on the host: one device → host read of a 0-d tensor per
guarded frame (per substep in ``sim.make_substep_fn``), counted in
``read_level.reads`` (ROADMAP M8 part 2 lists it as a sync to remove).
"""

from __future__ import annotations

import torch

from fem_tpu_torch.ops.blocked_kernels import blocked_prep_force
from fem_tpu_torch.ops.cg_kernels import diagonal_blocks_from
from fem_tpu_torch.ops.element import hessian_blocks

# The split ladder: dt, dt/2, dt/4, dt/8.
LEVELS = (1, 2, 4, 8)


def kappa_estimate(obj, pos: torch.Tensor, dt: float,
                   robust: bool = False, group=None) -> torch.Tensor:
    """κ = max_i dt²·‖(diag K)_i‖_F / m_i as a 0-d tensor on ``pos``'s
    device: the Frobenius size of the largest assembled diagonal block of
    dt²·M⁻¹K, i.e. max_i ‖A_ii − I‖_F of the implicit system.

    With a blocking, K comes from the blocked prep K2
    (``blocked_prep_force``: one launch on a CUDA object, its plain version
    on the CPU), moved to mesh element order; without one, from
    ``ops/element.hessian_blocks``.  Then the diagonal blocks
    (``cg_kernels.diagonal_blocks_from``) and their largest Frobenius
    norm.  With ``group`` (element sharding) K comes from the element path
    on the rank's rows, as in the JAX package, and the assembled diagonal
    is summed over the ranks."""
    blk = obj.blocking
    if blk is not None and group is None:
        k_slots, _ = blocked_prep_force(blk, pos, obj.mu, obj.s_lambda,
                                        material=obj.material, robust=robust)
        k = k_slots[blk.element_slot.long()]
    else:
        k = hessian_blocks(pos, obj.element_indices, obj.ref_inv, obj.volume,
                           obj.mu, obj.s_lambda, robust, obj.material)
    diag = diagonal_blocks_from(obj.element_indices, k, obj.mass, dt,
                                obj.plan.idx, group=group)
    dev = diag - torch.eye(obj.dim, dtype=diag.dtype, device=diag.device)
    return torch.sqrt((dev * dev).sum(dim=(1, 2)).max())


def split_level(kappa: torch.Tensor, threshold: float) -> torch.Tensor:
    """Index into :data:`LEVELS` such that κ/n² ≤ ``threshold`` (κ scales
    with dt²): 0 when κ ≤ θ, else ⌈log₄(κ/θ)⌉ clamped to the ladder; a 0-d
    int32 tensor on κ's device."""
    ratio = torch.clamp(kappa / threshold, min=1e-30)
    lvl = torch.ceil(0.5 * torch.log2(ratio))
    return torch.clamp(lvl.to(torch.int32), 0, len(LEVELS) - 1)


def read_level(kappa: torch.Tensor, threshold: float) -> int:
    """:func:`split_level` read on the host: the guard's one device → host
    read, counted in ``read_level.reads``."""
    level = int(split_level(kappa, threshold))
    read_level.reads += 1
    return level


read_level.reads = 0


def inner_substeps(substep_at_dt, state, dt: float, n: int):
    """One outer substep as ``n`` inner substeps at dt/n:
    ``substep_at_dt(dt_eff, state) -> (state, StepAux)`` is closed over
    everything else (method, obstacles).  Returns (state, iterations summed
    over the inner steps, the last inner step's residual)."""
    iters = None
    for _ in range(n):
        state, aux = substep_at_dt(dt / n, state)
        iters = (aux.solver_iterations if iters is None
                 else iters + aux.solver_iterations)
    return state, iters, aux.solver_residual


def adaptive_substep(substep_at_dt, obj, state, *, dt: float,
                     threshold: float, robust: bool = False):
    """One guarded outer substep: κ at the current positions, the split
    level read on the host, then :func:`inner_substeps` at its n."""
    n = LEVELS[read_level(kappa_estimate(obj, state.pos, dt, robust),
                          threshold)]
    return inner_substeps(substep_at_dt, state, dt, n)
