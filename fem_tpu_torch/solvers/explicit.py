# coding=utf-8
"""Explicit integration: the analytic energy gradient, or autograd of the
energy.

The port of the JAX package's ``solvers/explicit.py`` (reference
solver/explicit.py:8-49 and solver/explicit_auto_diff.py with the tape at
main.py:107).  Both return the assembled +∂U/∂x,
(N, d), which the kinematic step subtracts, for every material of
``ops/element.py``.  The analytic gradient sums over material layers
(ops/inelastic.py): each layer runs the kernel below on its own effective
rest-edge inverses and material.

Which kernels run, as in the JAX package's dispatch
(its ``solvers/explicit.py:22-143``):

* analytic, with locality blocks and ``element_backend`` "pallas" ("auto"
  on a CUDA object): the blocked prep in its explicit mode (K7b), one
  launch that ends in the per-particle slot sum, per layer;
* analytic, with blocks and "xla" ("auto" on the CPU): plain columns on the
  block-ordered elements, then the blocked assembly (K7a);
* analytic, without blocks: the gradient-columns kernel (K6; plain columns
  for "xla"), then the gather assembly;
* autodiff with blocks: ``torch.autograd.grad`` of Σ V·φ(X·R⁻¹) with respect
  to the block-ordered edge matrices X — ∂U/∂X are columns in the same
  scatter pattern — then the blocked assembly (K7a);
* autodiff without blocks: ``torch.autograd.grad`` of the total energy with
  respect to the positions.

Under element sharding (``group``, ``parallel/sharding.py``) the object
holds a rank's element rows and no blocks, as in the JAX package (its
explicit.py:43): K6 (or the plain columns) on those rows and the gather
assembly, or the autograd gradient of the rank's share of the energy, then
one all-reduce over the ranks.

On CPU tensors every kernel runs its plain PyTorch version.
"""

from __future__ import annotations

import torch

from fem_tpu_torch.models.state import FemObject
from fem_tpu_torch.ops import smallmat as sm
from fem_tpu_torch.ops.assembly import (
    all_reduce_sum,
    element_contrib_full,
    gather_edge_diffs,
    segment_assemble,
)
from fem_tpu_torch.ops.blocked_kernels import (
    blocked_assemble,
    blocked_grad_force,
)
from fem_tpu_torch.ops.element import energy_density, total_energy
from fem_tpu_torch.ops.element_kernels import (
    explicit_grad_columns,
    explicit_grad_columns_plain,
)
from fem_tpu_torch.ops.inelastic import (
    layer_ref_inv_blocked,
    layer_ref_inv_local,
    normalize_layers,
    sum_layers,
)


def _resolve_backend(element_backend: str, device: torch.device) -> str:
    """"auto" is "pallas" (the kernels) on a CUDA object and "xla" (plain
    columns) on the CPU, as the JAX package resolves it on its TPU."""
    if element_backend == "auto":
        return "pallas" if device.type == "cuda" else "xla"
    if element_backend not in ("pallas", "xla"):
        raise ValueError(f"unknown element_backend {element_backend!r}")
    return element_backend


def analytic_energy_gradient(
    obj: FemObject, pos: torch.Tensor, element_backend: str = "auto",
    layers=None, group=None,
) -> torch.Tensor:
    """Assembled ∂U/∂x (N, d) from the reference's analytic per-element
    formula (solver/explicit.py:23-49), summed over material ``layers``
    (``ops/inelastic.material_layers``; None: the one elastic layer), and
    with ``group`` over its ranks (the element path)."""
    backend = _resolve_backend(element_backend, pos.device)
    lys = normalize_layers(obj, layers)
    blk = obj.blocking
    if blk is not None and group is None:
        if backend == "pallas":
            # K7b per layer, each launch ending in its layer's assembled
            # gradient, summed in layer order.
            return sum_layers(
                blocked_grad_force(
                    blk, pos, mu, lam,
                    None if fi is None else layer_ref_inv_blocked(blk, fi),
                    material)
                for fi, mu, lam, material in lys)
        cols = sum_layers(
            explicit_grad_columns_plain(
                pos, blk.element_indices, layer_ref_inv_blocked(blk, fi),
                blk.volume, mu, lam, material)
            for fi, mu, lam, material in lys)
        return blocked_assemble(blk, cols)
    columns = (
        explicit_grad_columns if backend == "pallas"
        else explicit_grad_columns_plain
    )
    cols = sum_layers(
        columns(pos, obj.element_indices, layer_ref_inv_local(obj.ref_inv, fi, obj.element_start),
                obj.volume, mu, lam, material)
        for fi, mu, lam, material in lys)
    return segment_assemble(element_contrib_full(cols), obj.element_indices,
                            obj.particle_cnt, group, obj.plan)


def autodiff_energy_gradient(obj: FemObject, pos: torch.Tensor,
                             group=None) -> torch.Tensor:
    """∂U/∂x (N, d) by reverse-mode autograd — the contract of the
    reference's ``particles.pos.grad`` after its tape (main.py:107-110).
    Padded element slots hold mesh element 0 at volume 0, so their
    gradient is 0·φ'(F), finite, and the assembly drops them.  The
    material is the object's: for ``corotated`` autograd runs through the
    12 Higham iterations of ``polar_rotation``, as ``jax.grad`` does.  With
    ``group`` the gradient of the rank's share of the energy is summed over
    its ranks (the JAX package's psum of the energy, explicit.py:139-140)."""
    blk = obj.blocking
    with torch.enable_grad():
        if blk is not None and group is None:
            x = gather_edge_diffs(pos.detach(), blk.element_indices)
            x.requires_grad_(True)
            f = sm.matmul(x, blk.ref_inv)
            u = torch.sum(blk.volume * energy_density(
                f, obj.mu, obj.s_lambda, obj.material))
            (g_cols,) = torch.autograd.grad(u, x)
            return blocked_assemble(blk, g_cols)
        p = pos.detach().requires_grad_(True)
        u = total_energy(p, obj.element_indices, obj.ref_inv, obj.volume,
                         obj.mu, obj.s_lambda, obj.material)
        (grad,) = torch.autograd.grad(u, p)
        return all_reduce_sum(grad, group)
