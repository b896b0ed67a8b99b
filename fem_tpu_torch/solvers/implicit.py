# coding=utf-8
"""Implicit (backward-Euler-style) velocity solve, matrix-free.

The port of the JAX package's ``solvers/implicit.py`` CG paths.  Each
element contributes a single block K_e in a graph-Laplacian pattern (the
reference's decoupled Hessian, solver/implicit.py:141-144), so the operator

    (K·x)|_e :  s_j = x_{v_{j+1}} − x_{v_0};  t_j = K_e s_j
                v_{j+1} += t_j,   v_0 −= Σ_j t_j
    A·x = x − c · (K·x) / m,     c = dt·(dt + β)

is applied in O(E) (β, the Rayleigh ``damping_beta``, is 0 in the
reference, and c = dt²).  The CG keeps the reference's semantics: x₀ = b
(implicit.py:314), absolute tolerance ‖r‖² > 1e-5 (implicit.py:341), at most
500 iterations, and normal equations AᵀAx = Aᵀb when ``preconditioned == 1``
(implicit.py:289-299).

Which kernels one substep runs, in the JAX package's order (its
implicit.py:995-1155):

* ``hessian="exact_jvp"``: the true Newton operator, A·x from the forward
  derivative (``torch.func.jvp``) of the plain assembled elastic force and
  Aᵀ·y from its reverse derivative (``torch.func.vjp``), plain PyTorch as
  XLA is in the JAX package; the rhs through ``implicit_rhs`` (K9b for a
  Neo-Hookean layer on a CUDA object); plain or normal-equations CG only;
* pins (``free_mask``), Rayleigh β, ``cg_precond="block_jacobi"`` or the
  two-level PCG (``"two_level"``, ``"two_level_cheb<k>"``,
  ``solvers/multilevel.py``, its coarse matrix from the same K): no
  whole-solve kernel; on an object with locality blocks (``operator_mode``
  "auto", "fused" or "blocked") the blocked branch — the blocked prep K2
  per material layer, each launch ending in the assembled force, and the
  CG dispatch over the blocked operator K3 — and otherwise the graph branch — K1 per layer and
  the dispatch over the plain graph operator;
* ``operator_mode="mxu"`` on an object that carries the dense edge matrix
  S (``build_object(..., operator_mode="mxu")``; under ``"auto"`` only
  when the object has no locality blocks, which win first): K1 per layer,
  then the dispatch over the edge-matrix operator G(K)·x = Sᵀ(K∘(S·x)),
  whose two products with S are ``torch.matmul`` (TF32 off), as the JAX
  package leaves them to XLA;
* otherwise ``operator_mode="blocked"`` takes the blocked branch and every
  other mode the element chain K1 and the whole solve K4.

The CG dispatch (``ops/cg_kernels.cg_solve_dispatch``) runs the reference
CG, the block-Jacobi PCG or the two-level PCG, with the pin projection
P·A·P + (I − P) around each; every loop reads ‖r‖² on the host once an
iteration.  On CUDA
tensors the kernels are the hand-written CUDA ones; on CPU tensors their
plain PyTorch versions.

The Jacobi solver (``implicit_method=0``, the JAX package's
implicit.py:1197-1245) takes the graph branch's K1 (one layer: inelastic
materials, pins and ``hessian="exact_jvp"`` raise, as there), then

* ``jacobi_sweep="serial"`` (the reference's execution): the block-sparse
  rows (:func:`sparse_system_rows`, a deterministic gather) and the whole
  serial solve J1 (``ops/jacobi_kernels.jacobi_serial``, one launch a
  solve on a CUDA object); an object without the Jacobi plan runs J1 over
  the dense system (``solvers/dense.assemble_dense_system``);
* ``"snapshot"``: the weighted Jacobi of :func:`jacobi_solve`, op-composed
  with a host read of the error a sweep, over the blocked operator K3 (its
  K from K1 on the block-ordered element copies) when the object has
  locality blocks and ``operator_mode`` is "auto" or "blocked", else over
  the edge-matrix or the graph operator.

Every material of ``ops/element.py`` runs, and ``robust`` (the
``robust_inversion`` extension) on every branch.  An inelastic material
passes its material layers (ops/inelastic.py): the element chain (or the
blocked prep) runs once per layer on that layer's effective rest-edge
inverses and material, and the solve runs once over the summed K blocks and
force columns (partials).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fem_tpu_torch.models.state import FemObject, SimState
from fem_tpu_torch.ops import element
from fem_tpu_torch.ops import element_kernels as ek
from fem_tpu_torch.ops import stiffness_kernels
from fem_tpu_torch.ops.assembly import (
    all_reduce_sum,
    element_contrib_full,
    element_gather_plan,
    gather_assemble,
    gather_tiered,
    segment_assemble,
)
from fem_tpu_torch.ops.blocked_kernels import (
    blocked_graph_apply,
    blocked_prep_force,
    blocked_velocity_solve,
)
from fem_tpu_torch.ops.cg_kernels import (
    CGResult,
    cg_solve_dispatch,
    conjugate_gradient,
    diagonal_blocks_from,
    fused_cg_solve,
    graph_apply,
    preconditioned_conjugate_gradient,
    system_applies,
    system_coeff,
)
from fem_tpu_torch.ops.inelastic import (
    layer_ref_inv_blocked,
    layer_ref_inv_local,
    normalize_layers,
    sum_layers,
)
from fem_tpu_torch.ops.jacobi_kernels import (
    MAX_ITER,
    OMEGA,
    TOL,
    JacobiResult,
    jacobi_outer_loop,
    jacobi_serial,
)
from fem_tpu_torch.solvers.multilevel import (
    coarse_matrix,
    make_coarse_space,
    parse_two_level_precond,
)
from fem_tpu_torch.utils.config import CONJUGATE_GRADIENT_METHOD, JACOBI_METHOD

__all__ = [
    "CGResult",
    "ImplicitAux",
    "build_edge_matrix",
    "cg_solve_dispatch",
    "conjugate_gradient",
    "diagonal_blocks",
    "diagonal_blocks_from",
    "graph_block_apply",
    "implicit_rhs",
    "implicit_velocity_solve",
    "jacobi_solve",
    "jacobi_solve_serial",
    "jacobi_solve_serial_sparse",
    "JacobiResult",
    "element_linearization",
    "make_exact_hvp_apply",
    "make_mxu_system_apply",
    "make_system_apply",
    "make_system_apply_t",
    "preconditioned_conjugate_gradient",
    "rayleigh_damping_grad",
    "sparse_system_rows",
    "system_coeff",
]


def graph_block_apply(
    obj: FemObject, K: torch.Tensor, x: torch.Tensor, group=None
) -> torch.Tensor:
    """K·x with the element-Laplacian scatter pattern; O(E).  With
    ``group`` (element sharding: ``obj`` a rank's elements) summed over its
    ranks, one all-reduce."""
    return graph_apply(K, x, obj.element_indices, obj.plan.idx, group)


def make_system_apply(
    obj: FemObject, K: torch.Tensor, dt: float, beta: float = 0.0,
    group=None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """A·x = x − dt·(dt+β)·M⁻¹·(K·x)."""
    return system_applies(
        K, obj.element_indices, obj.plan.idx, 1.0 / obj.mass, dt, beta, group
    )[0]


def make_system_apply_t(
    obj: FemObject, K: torch.Tensor, dt: float, beta: float = 0.0,
    group=None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Aᵀ·y = y − dt·(dt+β)·G(K)ᵀ·M⁻¹·y: the same scatter pattern with each
    block transposed (replaces the reference's explicit Aᵀ,
    implicit.py:289-292)."""
    return system_applies(
        K, obj.element_indices, obj.plan.idx, 1.0 / obj.mass, dt, beta, group
    )[1]


def build_edge_matrix(element_indices, num_particles: int) -> np.ndarray:
    """Dense ±1 edge-difference operator S of shape (E·d, N), float32
    numpy: ``(S x)[e·d+j] = x[v_{j+1}] − x[v_0]``, so the element-Laplacian
    product is two matrix products, ``G(K)·x = Sᵀ·(K ∘ (S x))`` (the JAX
    package's ``build_edge_matrix``).  O(E·d·N) memory: ``build_object``
    builds it only when ``operator_mode="mxu"`` is forced and E·d·N ≤
    16,000,000.  Host-side, once at load."""
    idx = np.asarray(element_indices)
    e, dp1 = idx.shape
    d = dp1 - 1
    s = np.zeros((e * d, num_particles), np.float32)
    rows = np.arange(e * d)
    s[rows, idx[:, 1:].reshape(-1)] += 1.0
    s[rows, np.repeat(idx[:, 0], d)] -= 1.0
    return s


def make_mxu_system_apply(
    obj: FemObject, K: torch.Tensor, s_mat: torch.Tensor, dt: float,
    beta: float = 0.0,
):
    """(apply_a, apply_at) of A = I − c·M⁻¹·G(K) through the edge matrix
    ``s_mat`` (:func:`build_edge_matrix`): G(K)·x = Sᵀ·(K ∘ (S x)), the two
    products ``torch.matmul`` in full f32 and the d×d blocks one einsum (the
    JAX package's ``make_mxu_system_apply``); c = :func:`system_coeff`."""
    e, d = K.shape[0], obj.dim
    c = system_coeff(dt, beta)
    s_t = s_mat.T
    m = obj.mass[:, None]

    def g_apply(k_blocks, x):
        s = torch.matmul(s_mat, x)  # row (e, j) = edge difference j
        t = torch.einsum("eik,ejk->eji", k_blocks,
                         s.reshape(e, d, d)).reshape(e * d, d)
        return torch.matmul(s_t, t)

    k_t = K.transpose(-1, -2)

    def apply_a(x):
        return x - c * g_apply(K, x) / m

    def apply_at(y):
        return y - c * g_apply(k_t, y / m)

    return apply_a, apply_at


def diagonal_blocks(
    obj: FemObject, K: torch.Tensor, dt: float, beta: float = 0.0,
    group=None,
) -> torch.Tensor:
    """Per-particle diagonal d×d blocks (N, d, d) of A from the mesh-order
    K blocks (block-Jacobi PCG; the JAX package's ``diagonal_blocks``)."""
    return diagonal_blocks_from(obj.element_indices, K, obj.mass, dt,
                                obj.plan.idx, beta, group)


def _assemble(obj: FemObject, contrib: torch.Tensor, group=None):
    """Element rows (E, d+1, k) of ``obj`` summed onto its particles
    through its gather plan, then over the ranks of ``group``."""
    return segment_assemble(contrib, obj.element_indices, obj.particle_cnt,
                            group, obj.plan)


def _one_layer_force_columns(pos, element_indices, ref_inv, volume, mu, lam,
                             material, robust):
    """Implicit rhs force columns of one material layer in plain PyTorch:
    the Neo-Hookean rhs chain (λ/2·log det F² form) for ``neo_hookean``,
    −V·P(F)·R⁻ᵀ for every other material (the JAX package's
    ``_one_layer_force_columns``)."""
    if material == "neo_hookean":
        return element.implicit_force_columns(
            pos, element_indices, ref_inv, volume, mu, lam, robust)
    return -ek.explicit_grad_columns_plain(pos, element_indices, ref_inv,
                                           volume, mu, lam, material)


def _force_columns(obj: FemObject, robust: bool, layers):
    """(p, element_indices) ↦ the elastic force columns (E, d, d) at
    positions p on that element table (the object's rest-edge inverses and
    volumes, element for element), summed over material ``layers``, in
    plain PyTorch with no in-place operation (so that ``torch.func``
    differentiates it)."""
    lys = normalize_layers(obj, layers)

    def cols(p, element_indices):
        return sum_layers(
            _one_layer_force_columns(
                p, element_indices, layer_ref_inv_local(obj.ref_inv, fi, obj.element_start),
                obj.volume, mu, lam, material, robust)
            for fi, mu, lam, material in lys)

    return cols


def _assembled_force(obj: FemObject, robust: bool, layers):
    """p ↦ the assembled elastic force (N, d) at positions p, summed over
    material ``layers``, in plain PyTorch with no in-place operation (so
    that ``torch.func`` differentiates it)."""
    cols = _force_columns(obj, robust, layers)

    def force(p):
        return gather_assemble(
            element_contrib_full(cols(p, obj.element_indices)), obj.plan.idx)

    return force


def element_linearization(cols_fn, pos: torch.Tensor,
                          element_indices: torch.Tensor, plan,
                          negate: bool = False):
    """w ↦ the derivative at ``pos`` along w of the assembled element
    columns ``cols_fn(p, element_indices)`` (the force's exact
    Hessian-vector product; with ``negate`` its negative, the stiffness
    K·w = −(∂f/∂x)·w), through each element's Jacobian J_e (d², d²) of its
    columns in its d edge vectors D_j = x_{j+1} − x_0, formed once here:
    one ``torch.func.jvp`` over the d² unit tangents of vertices 1..d at
    once (``torch.func.vmap``), on a table of element-local positions.
    The columns depend on the positions only through the edge vectors (F =
    D·R⁻¹), so an apply is J_e times the edge differences of w, as the JAX
    package's ``jax.jvp`` of the assembled force differentiates through
    them: the same derivative, summed in another order.  (Applied to the
    (d+1)·d vertex values instead, a smooth w — a buckling or vibration
    mode — would cancel its common translation inside each element's sum
    and lose its small edge differences to f32 rounding.)

    The apply takes w of shape (N, d) or a block of columns (N, d, c) and
    returns the same shape: ``ops/stiffness_kernels.stiffness_apply`` over
    the Jacobians and ``plan`` (the object's ``GatherPlan``) — one launch
    of H1 on a CUDA ``pos``, the plain gather, product and assembly on the
    CPU."""
    e, dp1 = element_indices.shape
    d = dp1 - 1
    k = d * d
    dev, dtype = pos.device, pos.dtype
    table = pos[element_indices.long()].reshape(e * dp1, d)
    local = torch.arange(e * dp1, dtype=torch.int32,
                         device=dev).reshape(e, dp1)
    # Unit tangents on vertex j + 1, component a: tangent j·d + a.
    tangents = torch.eye(dp1 * d, dtype=dtype, device=dev)[d:].reshape(
        k, 1, dp1, d).expand(k, e, dp1, d).reshape(k, e * dp1, d)

    def columns(x):
        return cols_fn(x, local)

    jac = torch.func.vmap(
        lambda t: torch.func.jvp(columns, (table,), (t,))[1])(tangents)
    jac = jac.reshape(k, e, d * d).permute(1, 2, 0)  # (E, d², d²)
    if negate:
        jac = -jac
    binding = stiffness_kernels.StiffnessBinding(jac, element_indices, plan)

    def apply(w):
        return stiffness_kernels.stiffness_apply(binding, w.contiguous())

    apply.binding = binding
    return apply


def make_exact_hvp_apply(
    obj: FemObject, pos: torch.Tensor, dt: float, robust: bool = False,
    beta: float = 0.0, layers=None, group=None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The true Newton operator A·x = x − dt·(dt+β)·M⁻¹·(∂f/∂x)·x at
    ``pos``, the Hessian-vector product taken by ``torch.func.jvp`` of the
    plain assembled force (the JAX package's ``make_exact_hvp_apply``,
    ``jax.jvp``): every vertex pair of an element couples, where the
    reference's block Hessian drops the cross terms.  O(E) an apply.  With
    ``group`` the derivative of each rank's share of the force is summed
    over the ranks (the sum is linear, so its derivative is the sum of
    theirs), one all-reduce an apply."""
    c = system_coeff(dt, beta)
    force = _assembled_force(obj, robust, layers)
    m = obj.mass[:, None]

    def apply_a(x):
        _, df_x = torch.func.jvp(force, (pos,), (x,))
        return x - c * all_reduce_sum(df_x, group) / m

    return apply_a


def _exact_apply_t(obj: FemObject, pos: torch.Tensor, dt: float,
                   robust: bool, beta: float, layers, group=None):
    """Aᵀ·y = y − c·Jᵀ·M⁻¹·y of the exact operator, Jᵀ from
    ``torch.func.vjp`` of the same force (the JAX package's implicit.py:
    1012-1018), summed over the ranks of ``group``."""
    c = system_coeff(dt, beta)
    _, vjp_fn = torch.func.vjp(_assembled_force(obj, robust, layers), pos)
    m = obj.mass[:, None]

    def apply_at(y):
        (jt,) = vjp_fn(y / m)
        return y - c * all_reduce_sum(jt, group)

    return apply_at


def rayleigh_damping_grad(obj: FemObject, pos: torch.Tensor,
                          vel: torch.Tensor, layers=None,
                          group=None) -> torch.Tensor:
    """The explicit paths' Rayleigh term in the gradient's sign: −β·G(K)·v
    with K the decoupled blocks summed over material ``layers`` (the JAX
    package's ``rayleigh_damping_grad``; β = ``obj.damping_beta``).  A
    Neo-Hookean layer's blocks come from K9a
    (``element_kernels.hessian_blocks``: the kernel on a CUDA object),
    every other material's from the plain ``hessian_blocks``."""
    K = sum_layers(
        ek.hessian_blocks(pos, obj.element_indices,
                          layer_ref_inv_local(obj.ref_inv, fi, obj.element_start), obj.volume,
                          mu, lam)
        if material == "neo_hookean" else
        element.hessian_blocks(pos, obj.element_indices,
                               layer_ref_inv_local(obj.ref_inv, fi, obj.element_start),
                               obj.volume, mu, lam, False, material)
        for fi, mu, lam, material in normalize_layers(obj, layers))
    return -obj.damping_beta * graph_block_apply(obj, K, vel, group)


def implicit_rhs(obj: FemObject, state: SimState, dt: float,
                 robust: bool = False, element_backend: str = "auto",
                 layers=None, group=None) -> torch.Tensor:
    """b = v + dt·M⁻¹·f_elastic (N, d), f summed over material ``layers``
    (the JAX package's ``implicit_rhs``, its solvers/implicit.py:444-485).
    ``element_backend`` "pallas" ("auto" on a CUDA object) sends a
    non-robust Neo-Hookean layer's columns to K9b
    (``element_kernels.implicit_force_columns``) and a non-NH layer's to
    the gradient-columns kernel K6, negated; everything else runs the plain
    columns."""
    if element_backend == "auto":
        element_backend = "pallas" if state.pos.device.type == "cuda" else "xla"
    cols = []
    for fi, mu, lam, material in normalize_layers(obj, layers):
        r_eff = layer_ref_inv_local(obj.ref_inv, fi, obj.element_start)
        args = (state.pos, obj.element_indices, r_eff, obj.volume, mu, lam)
        if element_backend == "pallas" and material != "neo_hookean":
            cols.append(-ek.explicit_grad_columns(*args, material))
        elif element_backend == "pallas" and not robust:
            cols.append(ek.implicit_force_columns(*args))
        else:
            cols.append(_one_layer_force_columns(*args, material, robust))
    f = _assemble(obj, element_contrib_full(sum_layers(cols)), group)
    return state.vel + dt * f / obj.mass[:, None]


def jacobi_solve(
    operator: Callable[[torch.Tensor], torch.Tensor],
    diag: torch.Tensor,
    b: torch.Tensor,
    past_x: torch.Tensor,
    omega: float = OMEGA,
    tol: float = TOL,
    max_iter: int = MAX_ITER,
) -> JacobiResult:
    """Snapshot weighted-Jacobi sweeps over any ``operator`` (the JAX
    package's ``jacobi_solve``, the ``jacobi_sweep="snapshot"`` extension):
    every row reads the previous iterate, ``diag`` (N, d, d) gives the
    scalar diagonal A_ii[k,k].  Op-composed, the error read on the host
    once a sweep (:func:`jacobi_outer_loop`)."""
    diag_kk = torch.diagonal(diag, dim1=-2, dim2=-1)
    safe = diag_kk.abs() >= 1e-6
    safe_diag = torch.where(safe, diag_kk, 1.0)

    def once(x, past):
        num = (b - operator(x)) + diag_kk * x
        upd = omega * num / safe_diag + (1.0 - omega) * past
        return torch.where(safe, upd, 0.0)

    def error(x):
        r = b - operator(x)
        return torch.sqrt(torch.sum(r * r))

    return jacobi_outer_loop(once, error, b, past_x, tol, max_iter)


def jacobi_solve_serial(a_dense: torch.Tensor, b: torch.Tensor,
                        past_x: torch.Tensor, omega: float = OMEGA,
                        tol: float = TOL, max_iter: int = MAX_ITER,
                        pattern: Optional[torch.Tensor] = None
                        ) -> JacobiResult:
    """The serial sweep over the dense system ``a_dense`` (N·d, N·d) (the
    JAX package's ``jacobi_solve_serial``): J1 over its dense rows on a
    CUDA tensor — on the level schedule of ``pattern``, a neighbour table
    (N, k) int32 that holds every nonzero block of A, where given — the
    plain row loop on a CPU one."""
    return jacobi_serial(a_dense, b, past_x, None, omega, tol, max_iter,
                         pattern=pattern)


def jacobi_solve_serial_sparse(nb_ids: torch.Tensor, blocks: torch.Tensor,
                               b: torch.Tensor, past_x: torch.Tensor,
                               omega: float = OMEGA, tol: float = TOL,
                               max_iter: int = MAX_ITER) -> JacobiResult:
    """The serial sweep over the block-sparse rows ``blocks`` (N, max_nb,
    d, d) of the neighbours ``nb_ids`` (the JAX package's
    ``jacobi_solve_serial_sparse``): J1 on CUDA tensors, the plain row loop
    on CPU ones."""
    return jacobi_serial(blocks, b, past_x, nb_ids, omega, tol, max_iter)


def sparse_system_rows(obj: FemObject, K: torch.Tensor, dt: float,
                       beta: float = 0.0, group=None) -> torch.Tensor:
    """Block-sparse rows (N, max_nb, d, d) of A = I − c·M⁻¹·G(K) over the
    object's neighbour slots (the JAX package's ``sparse_system_rows``):
    slot k of row i holds A[i, jacobi_nb[i, k]], zero on padded slots.
    Each slot sums its ±K contributions through ``obj.jacobi_gather`` in
    ascending order (a gather, no atomics); c = :func:`system_coeff`.
    With ``group`` (element sharding: each rank's K, Jacobi slots and
    coefficients a slice of the mesh's) the slot sums are summed over its
    ranks, one all-reduce."""
    d, n = obj.dim, obj.particle_cnt
    max_nb = obj.jacobi_nb.shape[1]
    vals = K[:, None, :, :] * obj.jacobi_coeff[..., None, None]
    acc = all_reduce_sum(
        gather_tiered(vals.reshape(-1, d * d), obj.jacobi_gather), group)
    a = -system_coeff(dt, beta) * acc.reshape(n, max_nb, d, d) \
        / obj.mass[:, None, None, None]
    ids = torch.arange(n, dtype=obj.jacobi_nb.dtype, device=K.device)
    self_slot = (obj.jacobi_nb == ids[:, None])[..., None, None]
    eye = torch.eye(d, dtype=a.dtype, device=a.device)
    return a + self_slot * eye


def jacobi_anchor(state: SimState) -> torch.Tensor:
    """The state's relaxation anchor ``jacobi_past_x`` (zero when None)."""
    if state.jacobi_past_x is None:
        return torch.zeros_like(state.vel)
    return state.jacobi_past_x


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
    hessian: str = "reference",
    element_backend: str = "auto",
    jacobi_sweep: str = "serial",
    group=None,
) -> Tuple[SimState, ImplicitAux]:
    """Assemble (matrix-free) and solve for the new velocity; returns the
    updated state (vel ← x, implicit.py:222-223; the Jacobi solver also
    ``jacobi_past_x``) and the solver metrics (the Jacobi solver's
    iterations and final error ‖b − A·x‖), all left on the object's device.
    The branches as the module says; ``layers``: the material layers (None:
    the one elastic layer); ``element_backend`` applies to the
    exact-Hessian rhs.

    With ``group`` (element sharding, ``parallel/sharding.py``) ``obj``
    holds a rank's elements and blocks: every assembly and operator apply
    is summed over the ranks (one all-reduce each) and the solver's
    iterations run on every rank alike.  The whole solve K4 and the
    edge-matrix operator are single-device: CG takes the blocked branch on
    the rank's blocks when it has them and ``operator_mode`` allows it,
    else the graph branch, as the JAX package's sharded solve does."""
    if method == JACOBI_METHOD:
        return _jacobi_velocity_solve(obj, state, dt, robust, operator_mode,
                                      layers, hessian, jacobi_sweep, group)
    if method != CONJUGATE_GRADIENT_METHOD:
        raise ValueError(f"unknown implicit method {method}")
    two_level = parse_two_level_precond(cg_precond)[0]
    if cg_precond not in ("reference", "none", "block_jacobi") \
            and not two_level:
        raise ValueError(f"unknown cg_precond {cg_precond!r}")
    if hessian == "exact_jvp":
        return _exact_solve(obj, state, dt, preconditioned, cg_precond,
                            robust, element_backend, layers, group)
    if hessian != "reference":
        raise ValueError(f"unknown hessian {hessian!r}")
    lys = normalize_layers(obj, layers)
    extended = (obj.free_mask is not None or obj.damping_beta != 0.0
                or cg_precond == "block_jacobi" or two_level
                or group is not None)
    if operator_mode == "blocked" or (
            extended and obj.blocking is not None
            and operator_mode in ("auto", "fused")):
        return _blocked_solve(obj, state, dt, preconditioned, cg_precond,
                              robust, lys, group)
    K, cols = sum_layers(
        ek.hessian_and_force(
            state.pos, obj.element_indices,
            layer_ref_inv_local(obj.ref_inv, fi, obj.element_start),
            obj.volume, mu, lam, robust, material,
        )
        for fi, mu, lam, material in lys
    )
    if group is None and obj.edge_matrix is not None and (
            operator_mode == "mxu"
            or (operator_mode == "auto" and obj.blocking is None)):
        return _graph_solve(obj, state, dt, preconditioned, cg_precond, K,
                            cols, mxu=True)
    if extended:
        return _graph_solve(obj, state, dt, preconditioned, cg_precond, K,
                            cols, group=group)
    normal = preconditioned == 1 and cg_precond == "reference"
    vel, iters, residual = fused_cg_solve(
        K, cols, obj.element_indices, obj.plan, state.vel, obj.mass, dt,
        normal,
    )
    return state.replace(vel=vel), ImplicitAux(iters, residual)


def _solved(state: SimState, res: CGResult) -> Tuple[SimState, ImplicitAux]:
    return state.replace(vel=res.x), ImplicitAux(res.iterations, res.residual)


def _graph_solve(obj, state, dt, preconditioned, cg_precond, K, cols,
                 mxu=False, group=None):
    """The graph branch (JAX implicit.py:1103-1155 with its CG dispatch at
    :1141-1155): b from K1's force columns, then the dispatch over the
    plain graph operator — or with ``mxu`` the edge-matrix operator
    (:func:`make_mxu_system_apply`, JAX :1186-1196) — with β, the pin
    projection and the block-Jacobi blocks of K; ``group`` sums every
    assembly and apply over its ranks."""
    beta = obj.damping_beta
    f = _assemble(obj, element_contrib_full(cols), group)
    b = state.vel + dt * f / obj.mass[:, None]
    if mxu:
        apply_a, apply_at = make_mxu_system_apply(obj, K, obj.edge_matrix, dt,
                                                  beta)
    else:
        apply_a, apply_at = system_applies(K, obj.element_indices,
                                           obj.plan.idx, 1.0 / obj.mass, dt,
                                           beta, group)
    return _solved(state, cg_solve_dispatch(
        apply_a, lambda: apply_at, b, preconditioned, cg_precond,
        lambda: diagonal_blocks(obj, K, dt, beta, group), obj.mass,
        obj.free_mask, obj.pin_vel,
        two_level_fn=_two_level_fn(obj, K, dt, beta, group=group)))


def _two_level_fn(obj, K, dt, beta, element_indices=None, group=None):
    """The thunk of the two-level PCG's (coarse space, coarse matrix) for K
    on ``element_indices`` (the mesh's when None; the JAX package's
    implicit.py:1125-1151 and :1252-1275), the coarse matrix's element sum
    over the ranks of ``group``."""
    def two_level_fn():
        if obj.agg_ids is None:
            raise ValueError(
                "cg_precond='two_level' needs the coarse space attached at "
                "build time (models/state.build_object)"
            )
        coarse = make_coarse_space(obj)
        return coarse, coarse_matrix(coarse, obj, K, dt, beta, obj.free_mask,
                                     element_indices, group=group)

    return two_level_fn


def blocked_diagonal_blocks(obj: FemObject, K: torch.Tensor, dt: float,
                            beta: float = 0.0, group=None) -> torch.Tensor:
    """The diagonal blocks (N, d, d) of A from the block-ordered K of
    ``obj.blocking`` (B·Eb, d, d).  Single-device: K to mesh order through
    ``Blocking.element_slot``, assembled there (:func:`diagonal_blocks`).
    With ``group`` the rank's blocks hold a slice of the mesh, so K is
    assembled in block order through the plan of the blocking's element
    rows (padded slots carry K = 0) and summed over the ranks."""
    blk = obj.blocking
    if group is None:
        return diagonal_blocks(obj, K[blk.element_slot.long()], dt, beta)
    return diagonal_blocks_from(
        blk.element_indices, K, obj.mass, dt,
        element_gather_plan(blk.element_indices, obj.particle_cnt).idx, beta,
        group)


def _blocked_solve(obj, state, dt, preconditioned, cg_precond, robust,
                   layers, group=None) -> Tuple[SimState, ImplicitAux]:
    """The blocked branch (JAX implicit.py:1080-1101 and :1128-1139): K2
    per material layer, each launch ending in its layer's assembled force
    (``blocked_prep_force``; the layers' K and f summed in layer order,
    where the JAX package sums the layers' partials and then assembles: the
    same terms, another f32 association), b = v + dt·f/m, then the CG dispatch over A and Aᵀ built from K3 on the
    summed K, with β, the pin projection and the block-Jacobi blocks.  The
    port's K2 emits K in the flat block order (B·Eb, d, d) that the JAX
    package gets from ``kplane_to_kflat``; the diagonal blocks take it to
    mesh order through ``Blocking.element_slot`` and assemble it there
    (:func:`blocked_diagonal_blocks`).  With ``group`` the force and every
    K3 product are summed over the ranks, one all-reduce each."""
    if obj.blocking is None:
        raise ValueError("operator_mode='blocked' requires obj.blocking")
    blk = obj.blocking
    beta = obj.damping_beta
    K, f = sum_layers(
        blocked_prep_force(
            blk, state.pos, mu, lam,
            None if fi is None else layer_ref_inv_blocked(blk, fi), material,
            robust)
        for fi, mu, lam, material in layers
    )
    f = all_reduce_sum(f, group)
    normal = preconditioned == 1 and cg_precond == "reference"
    return _solved(state, blocked_velocity_solve(
        blk, (K, f), state.vel, obj.mass, dt, normal, beta=beta,
        cg_precond=cg_precond,
        diag_fn=lambda: blocked_diagonal_blocks(obj, K, dt, beta, group),
        free=obj.free_mask, pin_vel=obj.pin_vel,
        two_level_fn=_two_level_fn(obj, K, dt, beta, blk.element_indices,
                                   group),
        group=group))


def _exact_solve(obj, state, dt, preconditioned, cg_precond, robust,
                 element_backend, layers, group=None
                 ) -> Tuple[SimState, ImplicitAux]:
    """``hessian="exact_jvp"`` (JAX implicit.py:995-1023): the exact
    operator, the rhs through ``implicit_rhs`` and the CG dispatch without
    diagonal blocks (block-Jacobi raises there)."""
    beta = obj.damping_beta
    apply_a = make_exact_hvp_apply(obj, state.pos, dt, robust, beta, layers,
                                   group)
    b = implicit_rhs(obj, state, dt, robust, element_backend, layers, group)
    return _solved(state, cg_solve_dispatch(
        apply_a,
        lambda: _exact_apply_t(obj, state.pos, dt, robust, beta, layers,
                               group),
        b, preconditioned, cg_precond, None, obj.mass, obj.free_mask,
        obj.pin_vel))


def _jacobi_velocity_solve(obj, state, dt, robust, operator_mode, layers,
                           hessian, jacobi_sweep, group=None
                           ) -> Tuple[SimState, ImplicitAux]:
    """The Jacobi solver (JAX implicit.py:979-1001 for its refusals,
    :1157-1245 for the solve), as the module says; ``group`` sums the
    force, the rows and the snapshot operator over its ranks, and J1 runs
    on every rank alike."""
    if layers is not None:
        raise ValueError(
            "inelastic materials support only the CG solver "
            "(implicit_method=1); the Jacobi sweeps keep pure "
            "reference semantics"
        )
    if hessian == "exact_jvp":
        raise ValueError(
            "hessian='exact_jvp' supports only the CG solver (Jacobi "
            "needs explicit diagonal blocks)"
        )
    if hessian != "reference":
        raise ValueError(f"unknown hessian {hessian!r}")
    if operator_mode == "blocked" and obj.blocking is None:
        raise ValueError("operator_mode='blocked' requires obj.blocking")
    beta = obj.damping_beta
    K, cols = ek.hessian_and_force(
        state.pos, obj.element_indices, obj.ref_inv, obj.volume, obj.mu,
        obj.s_lambda, robust, obj.material)
    f = _assemble(obj, element_contrib_full(cols), group)
    b = state.vel + dt * f / obj.mass[:, None]
    if obj.free_mask is not None:
        raise ValueError(
            "pin_boxes (Dirichlet constraints) support only the CG "
            "solver; the Jacobi sweeps keep pure reference semantics"
        )
    past = jacobi_anchor(state)
    if jacobi_sweep == "serial":
        if obj.jacobi_nb is not None:
            res = jacobi_solve_serial_sparse(
                obj.jacobi_nb, sparse_system_rows(obj, K, dt, beta, group),
                b, past)
        else:
            from fem_tpu_torch.solvers.dense import assemble_dense_system

            res = jacobi_solve_serial(
                assemble_dense_system(obj, K, dt, beta), b, past)
    elif jacobi_sweep == "snapshot":
        res = jacobi_solve(
            _snapshot_operator(obj, state, dt, robust, operator_mode, K,
                               group),
            diagonal_blocks(obj, K, dt, beta, group), b, past)
    else:
        raise ValueError(f"unknown jacobi_sweep {jacobi_sweep!r}")
    return (state.replace(vel=res.x, jacobi_past_x=res.past_x),
            ImplicitAux(res.iterations, res.error))


def _snapshot_operator(obj, state, dt, robust, operator_mode, K, group=None):
    """A·x of the snapshot sweep (JAX implicit.py:1186-1196, 1219-1241):
    on locality blocks under "auto" or "blocked", K3 over K from K1 on the
    block-ordered element copies (the blocking keeps no element
    permutation of the mesh-order K); else the edge-matrix operator when
    the object carries S under "mxu" or "auto" (single-device); else the
    graph operator.  ``group`` sums each product over its ranks."""
    beta = obj.damping_beta
    if obj.blocking is not None and operator_mode in ("auto", "blocked"):
        blk = obj.blocking
        k_blk, _ = ek.hessian_and_force(
            state.pos, blk.element_indices, blk.ref_inv, blk.volume, obj.mu,
            obj.s_lambda, robust, obj.material)
        c = system_coeff(dt, beta)
        m = obj.mass[:, None]
        return lambda x: x - c * all_reduce_sum(
            blocked_graph_apply(blk, k_blk, x), group) / m
    if group is None and obj.edge_matrix is not None and \
            operator_mode in ("mxu", "auto"):
        return make_mxu_system_apply(obj, K, obj.edge_matrix, dt, beta)[0]
    return make_system_apply(obj, K, dt, beta, group)
