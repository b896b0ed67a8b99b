# coding=utf-8
"""Inelastic materials: multiplicative plasticity and a Maxwell branch
(plain PyTorch).

The port of the JAX package's ``ops/inelastic.py`` (not its
``inelastic_energy_gradient``, which nothing reaches).  Both models carry
per-element internal inverses on the state (``SimState.plastic_inv`` =
F_p⁻¹, ``viscous_inv`` = F_v⁻¹, (E, d, d) in mesh element order) and update
them once a substep from the end-of-substep positions; within a substep the
solve sees them frozen.

* Von-Mises plasticity (``plastic_yield``): the base material runs on the
  effective rest-edge inverse R⁻¹·F_p⁻¹ (F_e = X·R⁻¹·F_p⁻¹).  The return map
  acts on principal Hencky strains of F_e (a Jacobi eigensolve of F_eᵀF_e):
  a deviator past the yield strain is scaled back onto it.
* Maxwell branch (``viscous_mu``/``viscous_tau``): a second layer,
  stable Neo-Hookean with λ = 0 and μ_v, on R⁻¹·F_v⁻¹; each substep its
  principal log strains decay by exp(−dt/τ).

Execution paths consume the stress as *material layers*
(:func:`material_layers`): (internal inverse, μ, λ, material) tuples whose
contributions sum, each composed with the rest-edge inverses the path holds
(:func:`layer_ref_inv_local` in mesh order, :func:`layer_ref_inv_blocked`
in block order).  The whole-frame kernels K5 and K8 run the same layers and
the same update in-kernel (``ops/frame_kernels.py``, ``csrc/inelastic.cuh``).

The clamps stay as the JAX package has them: √max(w, 1e-12),
log max(s, 1e-6), det F > 1e-9 (an element at or past inversion freezes its
state), yield/max(‖dev ε‖, 1e-30); the update masks are ``ok & yielded``
for the plastic state and ``ok`` for the viscous one.
"""

from __future__ import annotations

from typing import Tuple

import torch

from fem_tpu_torch.ops import smallmat as sm
from fem_tpu_torch.ops.element import (
    deformation_gradients,
    energy_density,
    explicit_grad_columns,
)

# The Maxwell branch's material (JAX inelastic.py:70).
BRANCH_MATERIAL = "stable_neo_hookean"


def is_inelastic(obj) -> bool:
    return obj.plastic_yield > 0.0 or obj.viscous_mu > 0.0


def relax_decay(dt: float, tau: float) -> float:
    """exp(−dt/τ) − 1 in float32, rounded where the JAX package rounds it
    (its ``_p_viscous_relax``: an f32 exp of −dt/τ, minus 1 in f32)."""
    return float(torch.exp(torch.tensor(-dt / tau, dtype=torch.float32)) - 1.0)


def material_layers(obj, state) -> tuple:
    """``(fi_inv, mu, lam, material)`` layers whose contributions sum to
    the stress: the base material on R⁻¹·F_p⁻¹ (``fi_inv`` None: the static
    R⁻¹), plus the Maxwell branch on R⁻¹·F_v⁻¹ when it is on."""
    layers = [(state.plastic_inv, obj.mu, obj.s_lambda, obj.material)]
    if state.viscous_inv is not None:
        layers.append((state.viscous_inv, obj.viscous_mu, 0.0,
                       BRANCH_MATERIAL))
    return tuple(layers)


def normalize_layers(obj, layers) -> tuple:
    """``layers``, or the one elastic layer of ``obj`` when None."""
    if layers is None:
        return ((None, obj.mu, obj.s_lambda, obj.material),)
    return tuple(layers)


def sum_layers(parts):
    """The sum of per-layer ``parts`` in layer order: tensors, or tuples of
    tensors summed entry by entry."""
    total = None
    for p in parts:
        if total is None:
            total = p
        elif isinstance(p, tuple):
            total = tuple(a + b for a, b in zip(total, p))
        else:
            total = total + p
    return total


def layer_ref_inv_local(ref_inv: torch.Tensor, fi_inv,
                        start: int = 0) -> torch.Tensor:
    """A layer's effective rest-edge inverse R⁻¹·F_i⁻¹ in mesh element order
    (``ref_inv`` when ``fi_inv`` is None).  Under element sharding the
    internal inverses span the whole padded element range while
    ``ref_inv`` holds a rank's rows from ``start`` on
    (``FemObject.element_start``): the rank takes its rows of ``fi_inv``."""
    if fi_inv is None:
        return ref_inv
    if fi_inv.shape[0] != ref_inv.shape[0]:
        fi_inv = fi_inv[start:start + ref_inv.shape[0]]
    return sm.matmul(ref_inv, fi_inv)


def layer_ref_inv_blocked(blk, fi_inv) -> torch.Tensor:
    """A layer's effective rest-edge inverse in block order (B·Eb, d, d):
    the internal inverses gather through ``Blocking.element_perm`` (padded
    slots take element 0's, which nothing reads)."""
    if fi_inv is None:
        return blk.ref_inv
    return sm.matmul(blk.ref_inv, fi_inv[blk.element_perm.long()])


# ---------------------------------------------------------------------------
# Row form: (…, d, d) tensors.
# ---------------------------------------------------------------------------

def _log_strain(f: torch.Tensor):
    """(ε (…, d), V (…, d, d)): principal log strains of ``f`` from the
    Jacobi eigensolve of FᵀF, singular values clamped away from zero."""
    w, v = sm.sym_eigh(sm.gram(f))
    s = torch.sqrt(torch.clamp(w, min=1e-12))
    return torch.log(torch.clamp(s, min=1e-6)), v


def _principal_rescale(f: torch.Tensor, delta_eps: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """F·(V·diag(exp Δε)·Vᵀ): the principal stretches scaled by exp Δε."""
    m = sm.matmul(v * torch.exp(delta_eps)[..., None, :], sm.mT(v))
    return sm.matmul(f, m)


def plastic_return_map(fe_trial: torch.Tensor,
                       yield_eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Radial return in principal Hencky space (perfect plasticity,
    isochoric flow): (F_e on the yield surface, yielded mask (…,))."""
    eps, v = _log_strain(fe_trial)
    mean = torch.mean(eps, dim=-1, keepdim=True)
    dev = eps - mean
    nrm = torch.sqrt(torch.sum(dev * dev, dim=-1, keepdim=True))
    yielded = nrm[..., 0] > yield_eps
    scale = torch.where(nrm > yield_eps,
                        yield_eps / torch.clamp(nrm, min=1e-30),
                        torch.ones_like(nrm))
    return _principal_rescale(fe_trial, dev * (scale - 1.0), v), yielded


def viscous_relax(fbe_trial: torch.Tensor, dt: float,
                  tau: float) -> torch.Tensor:
    """The branch strain after one substep of Maxwell relaxation."""
    eps, v = _log_strain(fbe_trial)
    return _principal_rescale(fbe_trial, eps * relax_decay(dt, tau), v)


# ---------------------------------------------------------------------------
# Plane form: lists of d² (or d) component tensors, c = i·d + j — the JAX
# package's ``_p_*`` functions (its inelastic.py:201-289), the order the
# CUDA update (csrc/inelastic.cuh) follows.
# ---------------------------------------------------------------------------

def _p_matmul(a, b, d):
    out = []
    for i in range(d):
        for j in range(d):
            s = a[i * d] * b[j]
            for k in range(1, d):
                s = s + a[i * d + k] * b[k * d + j]
            out.append(s)
    return out


def _p_det(a, d):
    if d == 2:
        return a[0] * a[3] - a[1] * a[2]
    return (
        a[0] * (a[4] * a[8] - a[5] * a[7])
        - a[1] * (a[3] * a[8] - a[5] * a[6])
        + a[2] * (a[3] * a[7] - a[4] * a[6])
    )


def _p_adjugate(a, d):
    if d == 2:
        return [a[3], -a[1], -a[2], a[0]]
    return [
        a[4] * a[8] - a[5] * a[7],
        a[2] * a[7] - a[1] * a[8],
        a[1] * a[5] - a[2] * a[4],
        a[5] * a[6] - a[3] * a[8],
        a[0] * a[8] - a[2] * a[6],
        a[2] * a[3] - a[0] * a[5],
        a[3] * a[7] - a[4] * a[6],
        a[1] * a[6] - a[0] * a[7],
        a[0] * a[4] - a[1] * a[3],
    ]


def _p_log_strain(f, d):
    c = {}
    for i in range(d):
        for j in range(i, d):
            s = f[i] * f[j]
            for k in range(1, d):
                s = s + f[k * d + i] * f[k * d + j]
            c[(i, j)] = s
    a, v = sm.sym_eigh_core(c, d)
    eps = []
    for k in range(d):
        s = torch.sqrt(torch.clamp(a[(k, k)], min=1e-12))
        eps.append(torch.log(torch.clamp(s, min=1e-6)))
    return eps, v


def _p_principal_rescale(f, delta, v, d):
    e = [torch.exp(dk) for dk in delta]
    m = []
    for i in range(d):
        for j in range(d):
            s = v[(i, 0)] * e[0] * v[(j, 0)]
            for k in range(1, d):
                s = s + v[(i, k)] * e[k] * v[(j, k)]
            m.append(s)
    return _p_matmul(f, m, d)


def _p_plastic_return(f_e, yield_eps, d):
    eps, v = _p_log_strain(f_e, d)
    mean = eps[0]
    for k in range(1, d):
        mean = mean + eps[k]
    mean = mean / d
    dev = [ek - mean for ek in eps]
    nrm2 = dev[0] * dev[0]
    for k in range(1, d):
        nrm2 = nrm2 + dev[k] * dev[k]
    nrm = torch.sqrt(nrm2)
    yielded = nrm > yield_eps
    scale = torch.where(yielded, yield_eps / torch.clamp(nrm, min=1e-30),
                        torch.ones_like(nrm))
    delta = [dk * (scale - 1.0) for dk in dev]
    return _p_principal_rescale(f_e, delta, v, d), yielded


def _p_viscous_relax(f_be, decay, d):
    eps, v = _p_log_strain(f_be, d)
    return _p_principal_rescale(f_be, [ek * decay for ek in eps], v, d)


def update_planes(x, r, plastic, viscous, d, plastic_yield, decay):
    """The per-element update in plane form — the plain twin of the CUDA
    update (csrc/inelastic.cuh): F = X·R⁻¹ against the ORIGINAL rest state,
    the guarded inverse (elements with det F ≤ 1e-9 keep their state), then
    the radial return of F·F_p⁻¹ and the relaxation of F·F_v⁻¹, each new
    inverse F⁻¹·F_new.  ``x``, ``r``, ``plastic`` and ``viscous`` are lists
    of d² component tensors (the last two None when off); returns the new
    (plastic, viscous) lists."""
    d2 = d * d
    f = _p_matmul(x, r, d)
    ok = _p_det(f, d) > 1e-9
    eye = [1.0 if (c // d) == (c % d) else 0.0 for c in range(d2)]
    f_safe = [torch.where(ok, f[c], torch.full_like(f[c], eye[c]))
              for c in range(d2)]
    adj = _p_adjugate(f_safe, d)
    det_safe = _p_det(f_safe, d)
    f_inv = [adj[c] / det_safe for c in range(d2)]
    new_p = new_v = None
    if plastic is not None:
        fe_new, yielded = _p_plastic_return(_p_matmul(f, plastic, d),
                                            plastic_yield, d)
        fp_new = _p_matmul(f_inv, fe_new, d)
        upd = ok & yielded
        new_p = [torch.where(upd, fp_new[c], plastic[c]) for c in range(d2)]
    if viscous is not None:
        fbe_new = _p_viscous_relax(_p_matmul(f, viscous, d), decay, d)
        fv_new = _p_matmul(f_inv, fbe_new, d)
        new_v = [torch.where(ok, fv_new[c], viscous[c]) for c in range(d2)]
    return new_p, new_v


def _planes(m: torch.Tensor):
    return list(m.reshape(m.shape[0], -1).unbind(1))


def _stack(planes, d):
    return torch.stack(planes, dim=1).reshape(-1, d, d)


def advance_blocked(blk, pos, plastic_inv, viscous_inv, plastic_yield: float,
                    decay: float, edges=None):
    """The blocked update (the JAX package's ``_advance_planes``): the edge
    matrices of every block slot (``edges(blk, pos)``; default the edges
    mode of the blocked prep, K7b edges, which on the CPU is its plain
    version), the plane update in block order, and the real slots written
    back in mesh order through ``element_slot``.  ``plastic_inv`` and
    ``viscous_inv`` are (E, d, d) in mesh order or None; ``decay`` is
    :func:`relax_decay`.  Returns the new (plastic_inv, viscous_inv)."""
    if edges is None:
        from fem_tpu_torch.ops.blocked_kernels import blocked_edges as edges
    d = blk.dim
    perm = blk.element_perm.long()
    slot = blk.element_slot.long()
    new_p, new_v = update_planes(
        _planes(edges(blk, pos)), _planes(blk.ref_inv),
        None if plastic_inv is None else _planes(plastic_inv[perm]),
        None if viscous_inv is None else _planes(viscous_inv[perm]),
        d, plastic_yield, decay)
    return (None if new_p is None else _stack(new_p, d)[slot],
            None if new_v is None else _stack(new_v, d)[slot])


def advance_internal(obj, state, dt: float, group=None):
    """Update the internal inverses from the end-of-substep positions of
    ``state`` (the JAX package's ``advance_internal``): the blocked form
    when ``obj`` has locality blocks, the row form otherwise.

    With ``group`` (element sharding) the internal inverses span the whole
    padded element range on every rank while ``obj`` holds the rank's rows
    from ``obj.element_start`` on: each rank updates its rows in the row
    form (per-element math, no collective in the chain) and one all-gather
    gives every rank the whole updated arrays."""
    if not is_inelastic(obj):
        return state
    if obj.blocking is not None and group is None:
        plastic, viscous = advance_blocked(
            obj.blocking, state.pos, state.plastic_inv, state.viscous_inv,
            obj.plastic_yield, relax_decay(dt, obj.viscous_tau))
        return state.replace(plastic_inv=plastic, viscous_inv=viscous)
    e_local, start = obj.element_indices.shape[0], obj.element_start

    def local_rows(full):
        if group is None or full.shape[0] == e_local:
            return full
        return full[start:start + e_local]

    def regather(local, full):
        if group is None or full.shape[0] == e_local:
            return local
        from fem_tpu_torch.ops.assembly import all_gather_rows

        return all_gather_rows(local, group)

    f = deformation_gradients(state.pos, obj.element_indices, obj.ref_inv)
    ok = (sm.det(f) > 1e-9)[..., None, None]
    eye = torch.eye(obj.dim, dtype=f.dtype, device=f.device).expand_as(f)
    f_inv = sm.inv(torch.where(ok, f, eye))
    new = {}
    if state.plastic_inv is not None:
        fp = local_rows(state.plastic_inv)
        fe_new, yielded = plastic_return_map(sm.matmul(f, fp),
                                             obj.plastic_yield)
        upd = ok & yielded[..., None, None]
        new["plastic_inv"] = regather(
            torch.where(upd, sm.matmul(f_inv, fe_new), fp),
            state.plastic_inv)
    if state.viscous_inv is not None:
        fv = local_rows(state.viscous_inv)
        fbe_new = viscous_relax(sm.matmul(f, fv), dt, obj.viscous_tau)
        new["viscous_inv"] = regather(
            torch.where(ok, sm.matmul(f_inv, fbe_new), fv),
            state.viscous_inv)
    return state.replace(**new)


def inelastic_grad_columns(obj, state, pos: torch.Tensor) -> torch.Tensor:
    """Energy-gradient columns (E, d, d) of the whole inelastic stress: the
    base material on R⁻¹·F_p⁻¹ plus the Maxwell branch on R⁻¹·F_v⁻¹."""
    return sum_layers(
        explicit_grad_columns(
            pos, obj.element_indices, layer_ref_inv_local(obj.ref_inv, fi_inv, obj.element_start),
            obj.volume, mu, lam, material)
        for fi_inv, mu, lam, material in material_layers(obj, state))


def inelastic_element_energies(obj, state, pos: torch.Tensor) -> torch.Tensor:
    """Per-element V·φ including the branch energy."""
    return obj.volume * sum_layers(
        energy_density(
            deformation_gradients(pos, obj.element_indices,
                                  layer_ref_inv_local(obj.ref_inv, fi_inv, obj.element_start)),
            mu, lam, material)
        for fi_inv, mu, lam, material in material_layers(obj, state))
