# coding=utf-8
"""Differentiable simulation: end-to-end gradients through trajectories.

The port of the JAX package's ``diff.py``.  A rollout is a function of
tensors that ``torch.autograd`` differentiates:

* material parameters (μ, λ — or E, ν through :func:`lame_from_young`),
  damping, the plastic yield strain and the initial state are ordinary
  tensors of the rollout (:class:`DiffParams`, 0-d tensors);
* the explicit and autodiff substeps differentiate by plain reverse mode
  through the element chain (``ops/element.py``) and the advection
  (``solvers/advect.py``, with the decay ``exp(−dt·damping)`` a tensor);
* the implicit substep solves the normal equations AᵀA·x = Aᵀb with a
  fixed-iteration CG under :class:`_NormalSolve`, a
  ``torch.autograd.Function`` in place of the JAX package's
  ``lax.custom_linear_solve(..., symmetric=True)``: its backward is ONE
  adjoint CG solve by the implicit function theorem, λ = (AᵀA)⁻¹·x̄, and
  the closed-form cotangent of the system blocks K — never a graph of the
  forward iterations;
* each substep runs under ``torch.utils.checkpoint`` (``remat=True``) so
  that a long rollout recomputes its element chain in the backward instead
  of storing it.

Every product G(K)·x goes through :class:`_GraphApply` or, inside a CG,
straight to the operator: on a CUDA object with locality blocks that is K3
(``ops/blocked_kernels.blocked_graph_apply``) on K placed in block order,
in both transposes, forward and adjoint; on the CPU K3's plain version, and
on an object without blocks the mesh-order ``graph_apply``.  The element
chain and the advection stay plain PyTorch under autograd, as XLA runs
them in the JAX package (its diff path reaches no Pallas kernel).  Every
gather's backward sums through the object's gather plans
(``ops/assembly.gather_rows``) and K's placement in block order transposes
to a gather, so that gradients add no floats by atomics and two runs are
bit-identical.

Forward parity: the explicit and autodiff substeps compute the op-composed
path's arithmetic; the implicit substep solves the same system as the
non-diff path, always in normal equations, with ``n_cg_iters`` iterations
from x₀ = b instead of the reference's tolerance loop.  Refused as in the
JAX package: the Jacobi method and ``integrator="newton"``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from fem_tpu_torch.models.state import FemObject, Obstacles, SimState
from fem_tpu_torch.ops import blocked_kernels
from fem_tpu_torch.ops import smallmat as sm
from fem_tpu_torch.ops.assembly import (
    assemble_rows,
    edge_diffs,
    element_contrib_full,
    gather_edge_diffs,
)
from fem_tpu_torch.ops.cg_kernels import graph_apply, system_coeff
from fem_tpu_torch.ops.element import (
    energy_density,
    first_piola_dp,
    grad_cols_chain,
    k_and_h_chain,
    mooney_params,
    material_base,
)
from fem_tpu_torch.ops.inelastic import (
    BRANCH_MATERIAL,
    is_inelastic,
    layer_ref_inv_local,
    plastic_return_map,
    viscous_relax,
)
from fem_tpu_torch.solvers.advect import (
    advect_implicit_step,
    damping_decay,
    gravity_vector,
    kinematic_step,
)
from fem_tpu_torch.utils.config import CONJUGATE_GRADIENT_METHOD, SimConfig

class DiffParams(NamedTuple):
    """Physical parameters of a differentiable rollout, each a 0-d tensor
    (``requires_grad`` on those to differentiate)."""

    mu: torch.Tensor
    s_lambda: torch.Tensor
    damping: torch.Tensor
    # Von-Mises yield strain of the inelastic extension, None for elastic
    # objects: inverse problems identify the yield surface from permanent
    # deformation (the return map is piecewise smooth in it).
    plastic_yield: Optional[torch.Tensor] = None


def params_from_object(obj: FemObject) -> DiffParams:
    """The object's material scalars as float32 0-d tensors on its device."""

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=obj.device)

    return DiffParams(
        mu=scalar(obj.mu),
        s_lambda=scalar(obj.s_lambda),
        damping=scalar(obj.damping),
        plastic_yield=(scalar(obj.plastic_yield)
                       if obj.plastic_yield > 0.0 else None),
    )


def lame_from_young(E, nu) -> Tuple[torch.Tensor, torch.Tensor]:
    """(μ, λ) from Young's modulus and Poisson's ratio — the closed form the
    config applies (reference object.py:48), differentiable."""
    mu = E / 2.0 / (1.0 + nu)
    lam = E * nu / (1.0 + nu) / (1.0 - 2.0 * nu)
    return mu, lam


def _cg_fixed(matvec, b: torch.Tensor, n_iters: int) -> torch.Tensor:
    """Fixed-iteration CG from x₀ = b (the reference's initialization,
    implicit.py:314).  Iterations where the search direction has died
    (dᵀq = 0, converged) are no-ops through ``torch.where``; nothing is read
    back to the host."""
    x = b
    r = b - matvec(x)
    d = r
    delta = torch.sum(r * r)
    for _ in range(n_iters):
        q = matvec(d)
        dq = torch.sum(d * q)
        live = dq > 0.0
        alpha = torch.where(live, delta / torch.where(live, dq, 1.0), 0.0)
        x = x + alpha * d
        r = r - alpha * q
        delta_new = torch.sum(r * r)
        held = delta > 0.0
        beta = torch.where(held, delta_new / torch.where(held, delta, 1.0),
                           0.0)
        d = r + beta * d
        delta = delta_new
    return x


class _Graph:
    """G(K)·x over one object's elements, K in block order (B·Eb, d, d) on
    an object with locality blocks, else in mesh order (E, d, d).  With
    blocks every call of :meth:`__call__` goes to
    ``blocked_kernels.blocked_graph_apply``: one launch of K3 on the card,
    its plain version on the CPU."""

    def __init__(self, obj: FemObject):
        self.obj = obj
        self.blk = blk = obj.blocking
        if blk is None:
            self.element_indices = obj.element_indices
            return
        self.element_indices = blk.element_indices
        self.slot = blk.element_slot.long()
        self.k_shape = (blk.num_blocks * blk.eb, blk.dim, blk.dim)
        self.real = blocked_kernels._real_slots(blk)

    def place(self, K: torch.Tensor) -> torch.Tensor:
        """Mesh-order K (E, d, d) in the order the products take: into its
        block slots (padded slots 0) on an object with blocks.  The
        placement's backward is a gather by slot."""
        if self.blk is None:
            return K
        return K.new_zeros(self.k_shape).index_copy(0, self.slot, K)

    def __call__(self, K, x, transpose: bool = False) -> torch.Tensor:
        if self.blk is None:
            return graph_apply(sm.mT(K) if transpose else K, x,
                               self.element_indices, self.obj.plan.idx)
        return blocked_kernels.blocked_graph_apply(self.blk, K,
                                                   x.contiguous(), transpose)

    def k_cotangent(self, u: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """∂⟨u, G(K)·x⟩/∂K: U_e·X_eᵀ per element, with U_e and X_e the edge
        matrices of u and x (padded block slots 0)."""
        out = sm.matmul(gather_edge_diffs(u, self.element_indices),
                        sm.mT(gather_edge_diffs(x, self.element_indices)))
        if self.blk is None:
            return out
        return torch.where(self.real, out, 0.0)


class _GraphApply(torch.autograd.Function):
    """G(K)·x, or G(Kᵀ)·x with ``transpose``, carrying gradients to K and
    x: x̄ = G(Kᵀ)·ȳ (resp. G(K)·ȳ) through the same operator, K̄ = Ȳ_e·X_eᵀ
    (resp. X_e·Ȳ_eᵀ) in closed form."""

    @staticmethod
    def forward(ctx, K, x, graph, transpose):
        ctx.graph, ctx.transpose = graph, transpose
        ctx.save_for_backward(K, x)
        return graph(K, x, transpose)

    @staticmethod
    @once_differentiable
    def backward(ctx, y_bar):
        K, x = ctx.saved_tensors
        graph, transpose = ctx.graph, ctx.transpose
        k_bar = x_bar = None
        if ctx.needs_input_grad[1]:
            x_bar = graph(K, y_bar, not transpose)
        if ctx.needs_input_grad[0]:
            k_bar = (graph.k_cotangent(x, y_bar) if transpose
                     else graph.k_cotangent(y_bar, x))
        return k_bar, x_bar, None, None


class _System:
    """A = P·(I − c·M⁻¹·G(K))·P + (I − P) and its transpose, P the pin
    projection (identity without pins), c = dt·(dt + β): the implicit
    substep's operator (the JAX package's ``apply_a``/``apply_at``).  With
    ``grad`` the products go through :class:`_GraphApply`."""

    def __init__(self, graph: _Graph, mass, free, c: float):
        self.graph, self.c = graph, c
        self.minv = (1.0 / mass)[:, None]
        self.free = free

    def _g(self, K, x, transpose, grad):
        if grad:
            return _GraphApply.apply(K, x, self.graph, transpose)
        return self.graph(K, x, transpose)

    def base_a(self, K, x, grad=True):
        """I − c·M⁻¹·G(K), no projection (differentiable by default: the
        moving pins' particular solution)."""
        return x - self.c * self._g(K, x, False, grad) * self.minv

    def a(self, K, x, grad=False):
        if self.free is None:
            return self.base_a(K, x, grad)
        return (self.free * self.base_a(K, self.free * x, grad)
                + (1.0 - self.free) * x)

    def at(self, K, y, grad=False):
        z = y if self.free is None else self.free * y
        z = z - self.c * self._g(K, z * self.minv, True, grad)
        return z if self.free is None else self.free * z + (1.0 - self.free) * y

    def normal(self, K):
        return lambda v: self.at(K, self.a(K, v))

    def k_cotangent(self, K, x, lam):
        """∂⟨−λ, AᵀA·x⟩/∂K = c·(U(P·M⁻¹·A·x)·X(P·λ)ᵀ + U(P·M⁻¹·A·λ)·X(P·x)ᵀ)
        per element: the chain of the closed form through A's projection,
        M⁻¹ and c.  Two products."""
        f = 1.0 if self.free is None else self.free
        ax, al = self.a(K, x), self.a(K, lam)
        return self.c * (self.graph.k_cotangent(f * ax * self.minv, f * lam)
                         + self.graph.k_cotangent(f * al * self.minv, f * x))


class _NormalSolve(torch.autograd.Function):
    """x = (AᵀA)⁻¹·rhs by :func:`_cg_fixed`.  Backward: one adjoint solve
    λ = (AᵀA)⁻¹·x̄ from x₀ = x̄ by the same CG (AᵀA is symmetric), then
    rhs̄ = λ and K̄ = ∂⟨−λ, AᵀA·x⟩/∂K at the solved x — the implicit
    function theorem, the gradient of the converged solve."""

    @staticmethod
    def forward(ctx, K, rhs, system, n_iters):
        ctx.system, ctx.n_iters = system, n_iters
        x = _cg_fixed(system.normal(K), rhs, n_iters)
        ctx.save_for_backward(K, x)
        return x

    @staticmethod
    @once_differentiable
    def backward(ctx, x_bar):
        K, x = ctx.saved_tensors
        system = ctx.system
        lam = _cg_fixed(system.normal(K), x_bar.contiguous(), ctx.n_iters)
        k_bar = (system.k_cotangent(K, x, lam) if ctx.needs_input_grad[0]
                 else None)
        return k_bar, lam, None, None


def implicit_graph_products(obj: FemObject, n_substeps: int,
                            n_cg_iters: int = 32, remat: bool = True,
                            backward: bool = True) -> int:
    """G(K)·x products of an implicit diff rollout of ``n_substeps`` (each
    one launch of K3 on a CUDA object with locality blocks), with its
    backward when ``backward`` (the parameters differentiated).  A substep's
    forward: Aᵀb 1, the moving pins' particular solution 1, the CG's start
    2 and 2 an iteration; its backward: the adjoint CG 2 + 2 an iteration,
    A·x and A·λ for K̄ 2, and x̄ of Aᵀb 1.  ``remat`` runs each forward
    again in the backward."""
    moving = obj.free_mask is not None and obj.pin_vel is not None
    forward = 3 + 2 * n_cg_iters + int(moving)
    if not backward:
        return n_substeps * forward
    return n_substeps * (forward * (2 if remat else 1) + 5 + 2 * n_cg_iters)


def make_diff_substep_fn(obj: FemObject, cfg: SimConfig, n_cg_iters: int = 32):
    """Build ``substep(params, state, obstacles) -> state``: one substep with
    :class:`DiffParams` as tensors, differentiable in all of them and in the
    state.  The method dispatch is the JAX package's (reference
    main.py:101-112): ``auto_diff`` wins, then explicit against implicit;
    implicit requires the CG method (``implicit_method=1``) and the
    semi-implicit integrator."""
    dt = cfg.delta_time
    robust = cfg.robust_inversion
    material = obj.material
    beta = obj.damping_beta
    inelastic = is_inelastic(obj)
    visc_mu, visc_tau = obj.viscous_mu, obj.viscous_tau
    plan, idx = obj.plan, obj.element_indices
    graph = _Graph(obj)
    if material_base(material) == "mooney_rivlin":
        # The calibration check, once on the floats (it skips tensors).
        mooney_params(obj.mu, obj.s_lambda, obj.dim, material)

    def gravity(state):
        return gravity_vector(tuple(cfg.g_dir), state.pos.device,
                              state.pos.dtype)

    def edges(pos):
        return edge_diffs(pos, idx, plan)

    def assemble(cols):
        return assemble_rows(element_contrib_full(cols), idx, plan)

    def base_ref(state):
        return (layer_ref_inv_local(obj.ref_inv, state.plastic_inv)
                if inelastic else obj.ref_inv)

    def layer_cols(params, state, x):
        """Explicit gradient columns summed over the material layers."""
        r = base_ref(state)
        cols = obj.volume[:, None, None] * grad_cols_chain(
            sm.matmul(x, r), r, params.mu, params.s_lambda, material)
        if state.viscous_inv is not None:
            r = layer_ref_inv_local(obj.ref_inv, state.viscous_inv)
            cols = cols + obj.volume[:, None, None] * grad_cols_chain(
                sm.matmul(x, r), r, visc_mu, 0.0, BRANCH_MATERIAL)
        return cols

    def hessian(x, r, mu, lam, mat, rob):
        dp = first_piola_dp(sm.matmul(x, r), r, mu, lam, mat, rob)
        return -obj.volume[:, None, None] * sm.matmul(dp, sm.mT(r))

    def energy_cols(params, x):
        """∂U/∂X of U = Σ_e V_e·φ(X_e·R_e) by autograd (with its graph when
        gradients are on, for the rollout's backward)."""
        keep = torch.is_grad_enabled()
        with torch.enable_grad():
            if not x.requires_grad:
                x = x.detach().requires_grad_(True)
            u = torch.sum(obj.volume * energy_density(
                sm.matmul(x, obj.ref_inv), params.mu, params.s_lambda,
                material))
            (g,) = torch.autograd.grad(u, x, create_graph=keep)
        return g

    def rayleigh(params, state, x):
        """−β·G(K)·v, K on the traced parameters (not robust)."""
        K = graph.place(hessian(x, obj.ref_inv, params.mu, params.s_lambda,
                                material, False))
        return -beta * _GraphApply.apply(K, state.vel, graph, False)

    def advance(params, state):
        """The post-advect internal-variable update with the traced yield
        strain (the row form of ``ops/inelastic.advance_internal``)."""
        if not inelastic:
            return state
        F = sm.matmul(edges(state.pos), obj.ref_inv)
        ok = (sm.det(F) > 1e-9)[..., None, None]
        eye = torch.eye(obj.dim, dtype=F.dtype, device=F.device).expand_as(F)
        f_inv = sm.inv(torch.where(ok, F, eye))
        new = {}
        if state.plastic_inv is not None:
            y = (params.plastic_yield if params.plastic_yield is not None
                 else obj.plastic_yield)
            fe_new, yielded = plastic_return_map(
                sm.matmul(F, state.plastic_inv), y)
            new["plastic_inv"] = torch.where(
                ok & yielded[..., None, None], sm.matmul(f_inv, fe_new),
                state.plastic_inv)
        if state.viscous_inv is not None:
            fv = sm.matmul(f_inv, viscous_relax(
                sm.matmul(F, state.viscous_inv), dt, visc_tau))
            new["viscous_inv"] = torch.where(ok, fv, state.viscous_inv)
        return state.replace(**new)

    def kinematic(params, state, x, grad, obstacles):
        if beta != 0.0:
            grad = grad + rayleigh(params, state, x)
        if obj.static_load is not None:
            grad = grad - obj.static_load
        state = kinematic_step(
            state, grad, obj.mass, obstacles, dt,
            damping_decay(dt, params.damping), gravity(state),
            free_mask=obj.free_mask, pin_vel=obj.pin_vel,
            wall_friction=cfg.wall_friction)
        return advance(params, state)

    if cfg.auto_diff:

        def substep(params: DiffParams, state: SimState,
                    obstacles: Obstacles) -> SimState:
            x = edges(state.pos)
            if inelastic:
                # The analytic layered chain: autodiff's value at frozen
                # internal variables (ops/inelastic).
                grad = assemble(layer_cols(params, state, x))
            else:
                grad = assemble(energy_cols(params, x))
            return kinematic(params, state, x, grad, obstacles)

        return substep

    if cfg.use_explicit_method:

        def substep(params: DiffParams, state: SimState,
                    obstacles: Obstacles) -> SimState:
            x = edges(state.pos)
            grad = assemble(layer_cols(params, state, x))
            return kinematic(params, state, x, grad, obstacles)

        return substep

    if cfg.implicit_method != CONJUGATE_GRADIENT_METHOD:
        raise ValueError(
            "differentiable implicit stepping supports only the CG method "
            "(implicit_method=1); the Jacobi rollback loop is not "
            "reverse-differentiable"
        )
    if cfg.integrator != "semi_implicit":
        raise ValueError(
            "differentiable implicit stepping supports only "
            "integrator='semi_implicit' (the Newton loop's data-dependent "
            "line search is not reverse-differentiable); use the "
            "semi-implicit path for gradient rollouts"
        )

    system = _System(graph, obj.mass, obj.free_mask,
                     system_coeff(dt, beta))

    def substep(params: DiffParams, state: SimState,
                obstacles: Obstacles) -> SimState:
        x = edges(state.pos)
        r = base_ref(state)
        K = hessian(x, r, params.mu, params.s_lambda, material, robust)
        f_mat = sm.matmul(x, r)
        if material == "neo_hookean":
            h = k_and_h_chain(f_mat, r, params.mu, params.s_lambda,
                              robust=robust)[1]
            cols = -obj.volume[:, None, None] * h
        else:
            # The implicit rhs force is −∂U/∂x through the material's
            # analytic Piola columns (the non-diff path's routing).
            cols = -obj.volume[:, None, None] * grad_cols_chain(
                f_mat, r, params.mu, params.s_lambda, material)
        if state.viscous_inv is not None:
            r_br = layer_ref_inv_local(obj.ref_inv, state.viscous_inv)
            K = K + hessian(x, r_br, visc_mu, 0.0, BRANCH_MATERIAL, robust)
            cols = cols - obj.volume[:, None, None] * grad_cols_chain(
                sm.matmul(x, r_br), r_br, visc_mu, 0.0, BRANCH_MATERIAL)
        K = graph.place(K)
        f = assemble(cols)
        if obj.static_load is not None:
            f = f + obj.static_load
        b = state.vel + dt * f * system.minv
        free = obj.free_mask
        if free is not None:
            # The Dirichlet projection, b̂ = P·b; moving pins take the
            # inhomogeneous form with particular solution x_h.
            if obj.pin_vel is not None:
                x_h = (1.0 - free) * obj.pin_vel
                b = free * (b - system.base_a(K, x_h)) + x_h
            else:
                b = free * b
        v = _NormalSolve.apply(K, system.at(K, b, grad=True), system,
                               n_cg_iters)
        state = advect_implicit_step(
            state.replace(vel=v), obstacles, dt,
            damping_decay(dt, params.damping), gravity(state),
            free_mask=obj.free_mask, pin_vel=obj.pin_vel,
            wall_friction=cfg.wall_friction)
        return advance(params, state)

    return substep


def make_diff_rollout_fn(
    obj: FemObject,
    cfg: SimConfig,
    n_substeps: int,
    n_cg_iters: int = 32,
    remat: bool = True,
):
    """Build ``rollout(params, state, obstacles) -> (final_state, traj_pos)``:
    ``n_substeps`` differentiable substeps, the positions after each stacked
    as ``(n_substeps, N, d)`` for trajectory losses.  ``remat=True`` runs
    each substep under ``torch.utils.checkpoint`` (non-reentrant), so that
    the backward recomputes its element chain and solve instead of storing
    them."""
    sub = make_diff_substep_fn(obj, cfg, n_cg_iters)

    def step(params, state, obstacles):
        if remat and torch.is_grad_enabled():
            return checkpoint(sub, params, state, obstacles,
                              use_reentrant=False, preserve_rng_state=False)
        return sub(params, state, obstacles)

    def rollout(params: DiffParams, state: SimState, obstacles: Obstacles):
        traj = []
        for _ in range(n_substeps):
            state = step(params, state, obstacles)
            traj.append(state.pos)
        return state, torch.stack(traj)

    return rollout


def trajectory_loss_fn(
    obj: FemObject,
    cfg: SimConfig,
    target_traj: torch.Tensor,
    n_cg_iters: int = 32,
):
    """Mean-squared trajectory mismatch ``loss(params, state, obstacles)``
    against a target ``(n_substeps, N, d)`` position history, the standard
    inverse-problem objective."""
    n_substeps = int(target_traj.shape[0])
    rollout = make_diff_rollout_fn(obj, cfg, n_substeps, n_cg_iters)

    def loss(params: DiffParams, state: SimState, obstacles: Obstacles):
        _, traj = rollout(params, state, obstacles)
        return torch.mean((traj - target_traj) ** 2)

    return loss


__all__ = [
    "DiffParams",
    "lame_from_young",
    "make_diff_rollout_fn",
    "make_diff_substep_fn",
    "params_from_object",
    "trajectory_loss_fn",
    "implicit_graph_products",
]
