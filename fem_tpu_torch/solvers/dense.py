# coding=utf-8
"""The dense backend of the implicit solve (``solver_backend="dense"``).

The port of the JAX package's ``solvers/dense.py``: A = I − c·M⁻¹·G(K) is
materialised once a substep as an (N·d, N·d) matrix, c =
``system_coeff(dt, β)``, and the solve runs on it — the reference CG
(plain, or the normal equations as two products an iteration) with every
product one ``torch.matmul`` (TF32 off; the JAX package leaves these
products to XLA), or the Jacobi solver: the serial sweep J1 over its dense
rows (``ops/jacobi_kernels.jacobi_serial``, on the level schedule of the
Jacobi table that holds A's nonzero blocks) or the snapshot sweep.  K and
the rhs force columns come from K1, as on the graph branch.

The matrix is assembled from the block-sparse rows of the serial Jacobi
sweep (``implicit.sparse_system_rows``): each row's blocks are placed at
their unique (row, column) positions, so the assembly is a gather and a
placement, with no float atomics.  ``sim.substep`` takes this backend
under the JAX package's conditions (its sim.py:203-222): the reference
Hessian and CG preconditioner, no material layers, no pins.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from fem_tpu_torch.models.state import FemObject, SimState, jacobi_arrays
from fem_tpu_torch.ops import element_kernels as ek
from fem_tpu_torch.ops.assembly import element_contrib_full, gather_assemble
from fem_tpu_torch.solvers.implicit import (
    ImplicitAux,
    conjugate_gradient,
    jacobi_anchor,
    jacobi_solve,
    jacobi_solve_serial,
    sparse_system_rows,
)
from fem_tpu_torch.utils.config import CONJUGATE_GRADIENT_METHOD, JACOBI_METHOD


def _with_jacobi_plan(obj: FemObject) -> FemObject:
    """``obj``, with the Jacobi plan built from its elements on the host
    when it was built without one."""
    if obj.jacobi_nb is not None:
        return obj
    idx = obj.element_indices.cpu().numpy()
    return dataclasses.replace(
        obj, **jacobi_arrays(idx, obj.particle_cnt, obj.device))


def assemble_dense_system(obj: FemObject, K: torch.Tensor, dt: float,
                          beta: float = 0.0) -> torch.Tensor:
    """A (N·d, N·d) from the per-element blocks K (the JAX package's
    ``assemble_dense_system``): each sparse row's blocks placed at (i,
    jacobi_nb[i, k]), and the identity block of a particle in no element."""
    obj = _with_jacobi_plan(obj)
    n, d = obj.particle_cnt, obj.dim
    rows = sparse_system_rows(obj, K, dt, beta)
    nb = obj.jacobi_nb.long()
    ids = torch.arange(n, device=nb.device)
    real = nb >= 0
    a = rows.new_zeros((n, n, d, d))
    a[ids[:, None].expand_as(nb)[real], nb[real]] = rows[real]
    alone = ids[~(nb == ids[:, None]).any(dim=1)]
    a[alone, alone] = torch.eye(d, dtype=rows.dtype, device=rows.device)
    return a.permute(0, 2, 1, 3).reshape(n * d, n * d)


def implicit_velocity_solve_dense(
    obj: FemObject,
    state: SimState,
    dt: float,
    method: int,
    preconditioned: int,
    robust: bool = False,
    jacobi_sweep: str = "serial",
) -> Tuple[SimState, ImplicitAux]:
    """Dense-backend counterpart of ``implicit.implicit_velocity_solve``
    (the JAX package's ``implicit_velocity_solve_dense``): the same solver
    semantics; the Jacobi solver's every ``jacobi_sweep`` but "serial" is
    the snapshot sweep, as there."""
    obj = _with_jacobi_plan(obj)
    n, d = obj.particle_cnt, obj.dim
    K, cols = ek.hessian_and_force(
        state.pos, obj.element_indices, obj.ref_inv, obj.volume, obj.mu,
        obj.s_lambda, robust, obj.material)
    a = assemble_dense_system(obj, K, dt, obj.damping_beta)
    f = gather_assemble(element_contrib_full(cols), obj.plan.idx)
    b = state.vel + dt * f / obj.mass[:, None]
    if method == JACOBI_METHOD:
        past = jacobi_anchor(state)
        if jacobi_sweep == "serial":
            # A's nonzero blocks lie in the Jacobi table (the assembly
            # above places exactly its rows), so J1 sweeps its levels.
            res = jacobi_solve_serial(a, b, past, pattern=obj.jacobi_nb)
        else:
            res = jacobi_solve(
                lambda v: torch.matmul(a, v.reshape(-1)).reshape(n, d),
                torch.diag_embed(torch.diagonal(a).reshape(n, d)), b, past)
        return (state.replace(vel=res.x, jacobi_past_x=res.past_x),
                ImplicitAux(res.iterations, res.error))
    if method == CONJUGATE_GRADIENT_METHOD:
        bf = b.reshape(-1)
        if preconditioned == 1:
            a_t = a.T
            res = conjugate_gradient(
                lambda v: torch.matmul(a_t, torch.matmul(a, v)),
                torch.matmul(a_t, bf), bf)
        else:
            res = conjugate_gradient(lambda v: torch.matmul(a, v), bf, bf)
        return (state.replace(vel=res.x.reshape(n, d)),
                ImplicitAux(res.iterations, res.residual))
    raise ValueError(f"unknown implicit method {method}")
