# coding=utf-8
"""Solver-system diagnostics: symmetry and diagonal-dominance checks.

The port of the JAX package's ``solvers/diagnostics.py``, the functional
equivalents of the reference's commented-out property checks
(``check_symmetry`` and ``check_diagonally_dominant``, solver/implicit.py):
a matrix-free symmetry probe with random vectors at any size, and the
exact checks on a materialized system when it is small enough.  The system
A = I − dt²M⁻¹G(K) is built from the plain per-element blocks
(``ops/element.hessian_blocks``, as the JAX package uses its XLA ones) on
the object's device; the dense checks run in numpy on the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from fem_tpu_torch.models.state import FemObject, SimState
from fem_tpu_torch.ops.element import hessian_blocks
from fem_tpu_torch.solvers.dense import assemble_dense_system
from fem_tpu_torch.solvers.implicit import make_system_apply


class SystemDiagnostics(NamedTuple):
    symmetry_error: float  # max asymmetry measure
    diagonally_dominant: bool  # Jacobi convergence precondition
    diag_dominance_margin: float  # min over rows of |a_ii| − Σ|a_ij|


def symmetry_probe(
    apply_a: Callable[[torch.Tensor], torch.Tensor],
    shape,
    num_probes: int = 8,
    seed: int = 0,
    device="cpu",
) -> float:
    """Matrix-free symmetry test: max |⟨x, A y⟩ − ⟨A x, y⟩| over random
    probe pairs (numpy's generator seeded with ``seed``, float32, on
    ``device``), normalized by |⟨x, A y⟩| (0 for a symmetric operator)."""
    rng = np.random.default_rng(seed)
    worst = 0.0
    for _ in range(num_probes):
        x = torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                            device=device)
        y = torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                            device=device)
        xay = float(torch.sum(x * apply_a(y)))
        axy = float(torch.sum(apply_a(x) * y))
        denom = max(abs(xay), abs(axy), 1e-12)
        worst = max(worst, abs(xay - axy) / denom)
    return worst


def dense_diagnostics(a: np.ndarray) -> SystemDiagnostics:
    """Exact checks on a materialized system matrix (reference semantics:
    symmetry, per-scalar-row dominance)."""
    sym = float(np.abs(a - a.T).max() / max(np.abs(a).max(), 1e-12))
    diag = np.abs(np.diag(a))
    off = np.abs(a).sum(axis=1) - diag
    margin = float((diag - off).min())
    return SystemDiagnostics(
        symmetry_error=sym,
        diagonally_dominant=bool(margin >= 0.0),
        diag_dominance_margin=margin,
    )


def leading_principal_minors(a: np.ndarray, max_k: int = 64) -> np.ndarray:
    """Leading principal minors det(A[:k,:k]) — the reference's commented-out
    positive-definiteness probe; all positive ⇒ positive definite
    (Sylvester's criterion); capped at ``max_k`` for cost."""
    k_max = min(a.shape[0], max_k)
    return np.array(
        [np.linalg.det(a[:k, :k]) for k in range(1, k_max + 1)])


def system_diagnostics(
    obj: FemObject, state: SimState, dt: float, dense_max_dof: int = 8192
) -> SystemDiagnostics:
    """Diagnose the current implicit system A = I − dt²M⁻¹G(K): exactly
    from the dense A up to ``dense_max_dof`` DOFs, else by the symmetry
    probe (dominance unknown, its margin NaN)."""
    K = hessian_blocks(state.pos, obj.element_indices, obj.ref_inv,
                       obj.volume, obj.mu, obj.s_lambda)
    if obj.particle_cnt * obj.dim <= dense_max_dof:
        a = assemble_dense_system(obj, K, dt).cpu().numpy()
        return dense_diagnostics(a)
    apply_a = make_system_apply(obj, K, dt)
    sym = symmetry_probe(apply_a, (obj.particle_cnt, obj.dim),
                         device=state.pos.device)
    return SystemDiagnostics(
        symmetry_error=sym,
        diagonally_dominant=False,
        diag_dominance_margin=float("nan"),
    )
