# coding=utf-8
"""Arc-length (Riks/Crisfield) continuation: equilibrium paths through
limit points.

The port of the JAX package's ``solvers/riks.py``: the equilibrium path
(x(s), λ(s)) of g(x) − λ·f = 0 (g = ∂U/∂x, f the load pattern) traced
through folds with Crisfield's spherical constraint
‖Δx‖² + ψ²·s_f²·Δλ² = Δl², s_f = ‖K₀⁻¹f‖.  The tangent solves are direct,
as in the JAX package: exact per-element Hessians of the elastic energy
(``torch.func.hessian`` of one element's energy under ``torch.func.vmap``,
on the object's device) assembled into a host scipy CSR with the Dirichlet
projection and factorized by sparse f64 LU (``splu``).  δλ per corrector
comes from the constraint's quadratic with the linearized (Riks) fallback;
the host loop halves Δl on a failed step and grows it 1.3× on fast
convergence.

The whole analysis runs in float64.  The JAX package runs it on the host
CPU because a TPU has no f64; here the element Hessians and the residuals
are computed on the object's device in float64 (the H100 has native f64)
and copied to the host, where only the LU and the continuation's scalars
live, as there.

Dirichlet pins are required; ``f`` is projected to the free subspace.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from fem_tpu_torch.convert import to_dtype
from fem_tpu_torch.models.state import FemObject
from fem_tpu_torch.ops.assembly import element_contrib_full, gather_assemble
from fem_tpu_torch.ops.element import energy_density, explicit_grad_columns


class ArcLengthResult(NamedTuple):
    """Recorded equilibrium path.

    ``lam``: (n_pts,) load multipliers λ along the path (row 0 = 0).
    ``control``: (n_pts,) control displacement — position component of
    ``control_dof`` minus its initial value.
    ``residuals``: (n_pts,) max |g − λf| at each recorded point.
    ``pos``: (N, d) final configuration.
    ``path_pos``: (n_pts, N, d) full configurations, or None when
    ``record_path=False``.
    ``steps_taken``: accepted steps; ``retries``: total Δl halvings;
    ``tol_used``: the effective absolute residual tolerance.
    """

    lam: torch.Tensor
    control: torch.Tensor
    residuals: torch.Tensor
    pos: torch.Tensor
    path_pos: Optional[torch.Tensor]
    steps_taken: int
    retries: int
    tol_used: float = 0.0


def make_element_hessian_fn(obj: FemObject):
    """``pos -> (E, m, m)`` exact per-element elastic Hessians, m = (d+1)·d
    local DOFs: ``torch.func.hessian`` of the local element energy
    V_e·φ(D·R⁻¹) (``ops/element.energy_density``) under
    ``torch.func.vmap``, on the object's device and in its dtype."""
    d = int(obj.ref_inv.shape[-1])
    m = (d + 1) * d
    mu, lam, material = obj.mu, obj.s_lambda, obj.material

    def local_energy(x_flat, rinv, vol):
        x = x_flat.reshape(d + 1, d)
        dm = torch.matmul((x[1:] - x[0][None, :]).T, rinv)
        return vol * energy_density(dm, mu, lam, material)

    hess = torch.func.vmap(torch.func.hessian(local_energy))

    def run(pos):
        x_loc = pos[obj.element_indices.long()].reshape(-1, m)
        return hess(x_loc, obj.ref_inv, obj.volume)

    return run


class _SparseTangent:
    """Host-side exact tangent stiffness: element Hessians on the object's
    device, assembly and the f64 sparse LU on the host."""

    def __init__(self, obj: FemObject):
        import scipy.sparse as sp

        self._sp = sp
        self.obj = obj
        elem = obj.element_indices.cpu().numpy().astype(np.int64)
        e_cnt, dp1 = elem.shape
        d = dp1 - 1
        self.nd = int(obj.particle_cnt) * d
        m = dp1 * d
        gdof = (elem[:, :, None] * d + np.arange(d)[None, None, :]).reshape(
            e_cnt, m)
        self.rows = np.repeat(gdof, m, axis=1).ravel()
        self.cols = np.tile(gdof, (1, m)).ravel()
        free = np.repeat(obj.free_mask.cpu().numpy()[:, 0].astype(bool), d)
        self.free = free
        self.mask_elem = free[gdof].astype(np.float64)  # (E, m)
        self.hess_fn = make_element_hessian_fn(obj)

    def factor(self, pos: torch.Tensor):
        """Assemble K(pos) with the Dirichlet projection (P·K·P + (I−P))
        and return a solve(rhs (N, d)) -> (N, d) closure over the f64 LU."""
        import scipy.sparse.linalg as spla

        h = self.hess_fn(pos).cpu().numpy().astype(np.float64)
        h = h * (self.mask_elem[:, :, None] * self.mask_elem[:, None, :])
        k = self._sp.coo_matrix(
            (h.ravel(), (self.rows, self.cols)), shape=(self.nd, self.nd)
        ).tocsc()
        held = ~self.free
        if held.any():
            idx = np.where(held)[0]
            k = k + self._sp.coo_matrix(
                (np.ones(idx.size), (idx, idx)), shape=k.shape).tocsc()
        lu = spla.splu(k)
        n = self.nd // pos.shape[1]

        def solve(rhs: np.ndarray) -> np.ndarray:
            out = lu.solve(np.asarray(rhs, np.float64).reshape(self.nd))
            out = np.where(self.free, out, 0.0)
            return out.reshape(n, -1)

        return solve


def arc_length_path(
    obj: FemObject,
    pos0: torch.Tensor,
    f_pattern: torch.Tensor,
    n_steps: int = 40,
    dlam0: float = 0.05,
    lam_max: Optional[float] = None,
    psi: float = 1.0,
    max_corr: int = 12,
    tol: float = 1e-6,
    max_retries: int = 4,
    record_path: bool = True,
    control_dof: Optional[Tuple[int, int]] = None,
) -> ArcLengthResult:
    """Trace the equilibrium path of ``obj`` under load λ·``f_pattern``.

    ``dlam0`` sets the first step's intended Δλ (the arc radius derives
    from it through the tangent); later steps adapt.  Stops after
    ``n_steps`` accepted steps or once λ ≥ ``lam_max`` (if given).  ``tol``
    is relative to the load scale max|f|; the analysis runs in float64
    (module docstring).  ``control_dof`` = (vertex, axis) to record;
    defaults to the largest-|f| DOF.  Returns float64 tensors on the
    object's device."""
    if obj.free_mask is None:
        raise ValueError(
            "arc_length_path requires Dirichlet constraints "
            "(ObjectConfig.pin_boxes / obj.free_mask)")
    obj64 = to_dtype(obj, torch.float64)
    pos64 = pos0.to(torch.float64)
    f64 = torch.as_tensor(f_pattern).to(device=pos0.device,
                                        dtype=torch.float64)
    return _arc_length_impl(obj64, pos64, f64, n_steps, dlam0, lam_max, psi,
                            max_corr, tol, max_retries, record_path,
                            control_dof)


def _arc_length_impl(
    obj, pos0, f_pattern, n_steps, dlam0, lam_max, psi, max_corr, tol,
    max_retries, record_path, control_dof,
) -> ArcLengthResult:
    n, d = pos0.shape
    dev = pos0.device
    free = obj.free_mask  # (N, 1) f64
    f_dev = f_pattern * free
    f = f_dev.cpu().numpy()
    f_scale = float(np.max(np.abs(f)))
    tol_eff = tol * f_scale
    if control_dof is None:
        flat = int(np.argmax(np.abs(f)))
        control_dof = (flat // d, flat % d)
    ci, cj = control_dof

    def residual(p: np.ndarray, lam: float) -> np.ndarray:
        pt = torch.as_tensor(p, dtype=torch.float64, device=dev)
        cols = explicit_grad_columns(pt, obj.element_indices, obj.ref_inv,
                                     obj.volume, obj.mu, obj.s_lambda,
                                     obj.material)
        g = gather_assemble(element_contrib_full(cols), obj.plan.idx)
        return (free * (g - lam * f_dev)).cpu().numpy()

    tangent = _SparseTangent(obj)

    def factor(x):
        return tangent.factor(torch.as_tensor(x, dtype=torch.float64,
                                              device=dev))

    def trial_step(x, lam, prev_dx, prev_dlam, dl, s_f):
        """Predictor + full-Newton Crisfield correctors (host f64)."""
        psi2 = psi * psi * s_f * s_f
        solve = factor(x)
        dxt = solve(f)
        denom = np.sqrt(np.sum(dxt * dxt) + psi2)
        sgn = 1.0 if (np.sum(dxt * prev_dx) + psi2 * prev_dlam) >= 0 else -1.0
        dlam = sgn * dl / denom
        dx = dlam * dxt
        n_corr = 0
        for _ in range(max_corr):
            xt = x + dx
            r = residual(xt, lam + dlam)
            rmax = float(np.max(np.abs(r)))
            if not np.isfinite(rmax):
                return dx, dlam, False, rmax, n_corr
            if rmax <= tol_eff:
                return dx, dlam, True, rmax, n_corr
            solve = factor(xt)
            dx_r = solve(-r)
            dx_f = solve(f)
            a = np.sum(dx_f * dx_f) + psi2
            b = 2.0 * (np.sum((dx + dx_r) * dx_f) + psi2 * dlam)
            c = (np.sum((dx + dx_r) * (dx + dx_r)) + psi2 * dlam * dlam
                 - dl * dl)
            disc = b * b - 4.0 * a * c
            if disc >= 0.0:
                sq = np.sqrt(disc)
                r1 = (-b + sq) / (2.0 * a)
                r2 = (-b - sq) / (2.0 * a)

                def align(z):
                    return np.sum((dx + dx_r + z * dx_f) * dx)

                dlam_c = r1 if align(r1) >= align(r2) else r2
            else:
                den = np.sum(dx * dx_f) + psi2 * dlam
                dlam_c = -np.sum(dx * dx_r) / (
                    den if abs(den) > 1e-300 else 1e-300)
            dx = dx + dx_r + dlam_c * dx_f
            dlam = dlam + dlam_c
            n_corr += 1
        r = residual(x + dx, lam + dlam)
        rmax = float(np.max(np.abs(r)))
        return (dx, dlam, bool(np.isfinite(rmax) and rmax <= tol_eff), rmax,
                n_corr)

    x = pos0.cpu().numpy().astype(np.float64)
    dxt0 = factor(x)(f)
    s_f = max(float(np.linalg.norm(dxt0)), 1e-30)
    dl = float(dlam0) * np.sqrt(s_f * s_f + psi * psi * s_f * s_f)
    dl_max = 8.0 * dl

    lam = 0.0
    prev_dx = np.zeros_like(x)
    prev_dlam = 1.0
    c0 = float(x[ci, cj])

    lams = [0.0]
    controls = [0.0]
    resids = [float(np.max(np.abs(residual(x, 0.0))))]
    path = [x.copy()] if record_path else None
    accepted = 0
    retries = 0
    fails_in_row = 0
    while accepted < n_steps:
        dx, dlam, ok, rmax, n_corr = trial_step(
            x, lam, prev_dx, prev_dlam, dl, s_f)
        if not ok:
            retries += 1
            fails_in_row += 1
            if fails_in_row > max_retries:
                break
            dl *= 0.5
            continue
        fails_in_row = 0
        x = x + dx
        lam = lam + dlam
        prev_dx, prev_dlam = dx, dlam
        accepted += 1
        lams.append(float(lam))
        controls.append(float(x[ci, cj]) - c0)
        resids.append(rmax)
        if record_path:
            path.append(x.copy())
        if n_corr <= 4:
            dl = min(dl * 1.3, dl_max)
        if lam_max is not None and lam >= lam_max:
            break

    def out(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)

    return ArcLengthResult(
        lam=out(lams), control=out(controls), residuals=out(resids),
        pos=out(x),
        path_pos=out(np.stack(path)) if record_path else None,
        steps_taken=accepted, retries=retries, tol_used=float(tol_eff))
