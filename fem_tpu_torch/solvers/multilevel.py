# coding=utf-8
"""Two-level (coarse-space) preconditioner for the implicit operator.

The port of the JAX package's ``solvers/multilevel.py``
(``cg_precond="two_level"`` and ``"two_level_cheb<k>"``).  The implicit
system A = I − c·M⁻¹·G(K), c = dt·(dt + β), has a condition number that
grows like dt²; the two-level PCG splits its spectrum:

* the top (element-scale stiff modes) is local, and a smoother damps it:
  one damped block-Jacobi sweep, or a degree-k Chebyshev sweep over the
  band [λmax/α, λmax] of D⁻¹Ã;
* the bottom (smooth, low-energy deformations) is global, and a coarse
  space of per-aggregate rigid-body modes captures it.

Both cycles run on the mass-symmetrized operator Ã = M^{1/2}·A·M^{-1/2}:
the multiplicative V-cycle (3 fine applies a PCG iteration with the Jacobi
smoother, 2k + 1 with Chebyshev) and the additive Schwarz form
M⁻¹ = ω·D⁻¹ + R̃·C⁻¹·R̃ᵀ (no fine apply).  D is the Gershgorin-shifted
symmetrized diagonal blocks, R̃ = M^{1/2}·R the aggregate rigid-body basis
and C = R̃ᵀ·Ã·R̃, assembled exactly from the per-element decoupled blocks
in O(E) (:func:`coarse_matrix`) and factored once a setup
(:func:`two_level_setup`), which callers may build once and reuse across
solves (Newton freezes it per substep, the static solve per solve).

Where the JAX package computes in XLA, this module computes in plain
PyTorch on either device; no hand-written kernel is involved, and the
operator callbacks it is given carry the kernels (K3 on a CUDA object with
locality blocks).  What differs from the JAX package:

* every segment sum — the 4·E·d aggregate-pair blocks of C into G² pairs,
  the mass term and the coarse restriction into G aggregates — is a
  gather through a plan built once on the host for each element table
  and aggregate ids (:func:`pair_plan`, :func:`aggregate_plan`), so that
  two runs on the card are bit-identical (``index_add_`` on CUDA sums with float atomics);
* ``jnp.linalg.cholesky`` returns NaN for a matrix that is not positive
  definite, which the SPD guard ladder tests; ``torch.linalg.cholesky_ex``
  reports it in ``info`` instead, and the ladder tests ``info == 0`` and
  finiteness with one host read a rung;
* the PCG loop is a Python loop that reads rᵀr on the host once an
  iteration, as ``ops/cg_kernels.conjugate_gradient`` does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fem_tpu_torch.ops import smallmat as sm
from fem_tpu_torch.ops.assembly import (
    TieredPlan,
    all_reduce_sum,
    gather_assemble,
    gather_tiered,
    make_jacobi_gather,
)
from fem_tpu_torch.ops.cg_kernels import CGResult


def n_rigid_modes(dim: int) -> int:
    """Rigid-body modes per aggregate: translations + rotations."""
    return 3 if dim == 2 else 6


def parse_two_level_precond(name: str) -> Tuple[bool, str, int]:
    """``(is_two_level, smoother, degree)`` of a ``cg_precond`` string:
    ``"two_level"`` the damped block-Jacobi smoother, ``"two_level_cheb<k>"``
    (k in 2..6; ``"two_level_cheb"`` is 3) the degree-k Chebyshev smoother;
    any other name ``(False, "", 0)``."""
    if name == "two_level":
        return True, "jacobi", 0
    if name.startswith("two_level_cheb"):
        tail = name[len("two_level_cheb"):]
        deg = int(tail) if tail else 3
        if not 2 <= deg <= 6:
            raise ValueError(
                f"two_level_cheb degree must be in 2..6, got {deg}"
            )
        return True, "chebyshev", deg
    return False, "", 0


def _spread(v: np.ndarray, d: int) -> np.ndarray:
    """Bit interleave of 10-bit coordinates for a Morton code in ``d``
    dimensions."""
    v = v.astype(np.uint64)
    if d == 2:
        v = (v | (v << 16)) & np.uint64(0x0000FFFF0000FFFF)
        v = (v | (v << 8)) & np.uint64(0x00FF00FF00FF00FF)
        v = (v | (v << 4)) & np.uint64(0x0F0F0F0F0F0F0F0F)
        v = (v | (v << 2)) & np.uint64(0x3333333333333333)
        v = (v | (v << 1)) & np.uint64(0x5555555555555555)
        return v
    v = (v | (v << 32)) & np.uint64(0x1F00000000FFFF)
    v = (v | (v << 16)) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v << 8)) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v << 4)) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v << 2)) & np.uint64(0x1249249249249249)
    return v


def build_aggregates(
    rest_pos: np.ndarray, target_size: int = 96
) -> Tuple[np.ndarray, np.ndarray]:
    """Particle aggregation by Morton order over the rest positions, on
    the host (the JAX package's ``build_aggregates``): ``round(N /
    target_size)`` aggregates of consecutive particles in Morton order.

    Returns ``(agg_ids (N,) int32, basis (N, d, n_rb) float32)``: the
    per-particle rows of the rigid-body prolongator R (translations, then
    the rotations e_k × (x − c) about the aggregate's centroid c),
    column-normalized per aggregate in float64.  Each aggregate's
    particles are read from the sort rather than searched for (the JAX
    package's ``np.where`` over all N a aggregate): the same ids and the
    same basis, in O(N log N)."""
    rest_pos = np.asarray(rest_pos)
    n, d = rest_pos.shape
    lo, hi = rest_pos.min(0), rest_pos.max(0)
    span = np.maximum(hi - lo, 1e-12)
    q = ((rest_pos - lo) / span * 1023).astype(np.uint64)
    code = _spread(q[:, 0], d)
    for ax in range(1, d):
        code |= _spread(q[:, ax], d) << np.uint64(ax)
    order = np.argsort(code, kind="stable")
    n_agg = max(1, int(round(n / target_size)))
    bounds = np.linspace(0, n, n_agg + 1).astype(int)
    agg = np.zeros(n, np.int32)
    agg[order] = np.repeat(np.arange(n_agg, dtype=np.int32),
                           np.diff(bounds))

    nrb = n_rigid_modes(d)
    basis = np.zeros((n, d, nrb), np.float32)
    for g in range(n_agg):
        # The aggregate's particles in ascending order, as np.where gives
        # them: the same centroid sum, so the same basis bit for bit.
        sel = np.sort(order[bounds[g]:bounds[g + 1]])
        c = rest_pos[sel].mean(0)
        rel = rest_pos[sel] - c
        b = np.zeros((sel.size, d, nrb), np.float64)
        for ax in range(d):  # translations
            b[:, ax, ax] = 1.0
        if d == 2:  # one in-plane rotation
            b[:, 0, 2] = -rel[:, 1]
            b[:, 1, 2] = rel[:, 0]
        else:  # three rotations r_k = e_k × (x − c)
            b[:, 1, 3] = -rel[:, 2]
            b[:, 2, 3] = rel[:, 1]
            b[:, 0, 4] = rel[:, 2]
            b[:, 2, 4] = -rel[:, 0]
            b[:, 0, 5] = -rel[:, 1]
            b[:, 1, 5] = rel[:, 0]
        # Column normalization (degenerate rotation columns of tiny
        # aggregates stay ~0; the ridge in the factor handles them).
        nrm = np.sqrt((b * b).sum(axis=(0, 1)))
        b /= np.maximum(nrm, 1e-12)[None, None, :]
        basis[sel] = b.astype(np.float32)
    return agg, basis


def default_aggregate_size(dim: int) -> int:
    """Aggregate granularity: ~3 elements across (10 particles in 2D, 40
    in 3D; the JAX package's measured choice)."""
    return 10 if dim == 2 else 40


class CoarseSpace(NamedTuple):
    """The aggregate data (carried by ``FemObject`` from the build:
    ``agg_ids`` / ``agg_basis`` / ``num_aggregates``)."""

    agg_ids: torch.Tensor  # (N,) int32
    basis: torch.Tensor  # (N, d, n_rb) float32
    num_aggregates: int


def make_coarse_space(obj, target_size: Optional[int] = None) -> CoarseSpace:
    """The object's coarse space, or one built here from its rest
    positions at ``target_size`` (or when the object carries none)."""
    if obj.agg_ids is not None and target_size is None:
        return CoarseSpace(obj.agg_ids, obj.agg_basis, obj.num_aggregates)
    if target_size is None:
        target_size = default_aggregate_size(obj.dim)
    agg, basis = build_aggregates(obj.rest_pos.cpu().numpy(), target_size)
    dev = obj.mass.device
    return CoarseSpace(torch.as_tensor(agg, device=dev),
                       torch.as_tensor(basis, device=dev),
                       int(agg.max()) + 1)


def _pair_ids(agg: np.ndarray, idx: np.ndarray, g_count: int) -> np.ndarray:
    """The aggregate pair of each pair-block row of :func:`coarse_matrix`,
    in its row order: (j, j), (j, 0), (0, j), (0, 0), each E·d rows in
    element-major order."""
    d = idx.shape[1] - 1
    g = agg[idx]
    g0e = np.repeat(g[:, 0], d)
    gje = g[:, 1:].reshape(-1)
    return np.concatenate([gje * g_count + gje, gje * g_count + g0e,
                           g0e * g_count + gje, g0e * g_count + g0e])


# (ids of the tables, G) → (the tables, their version counters, the plan).
_PLANS: dict = {}


def _cached_plan(tables, g_count: int, build) -> TieredPlan:
    """The plan ``build(host tables)`` of ``tables``, built on the host at
    its first use (one read of each) and kept, by the tensors' identity and
    version counters, for every later call."""
    key = tuple(id(t) for t in tables) + (g_count,)
    versions = tuple(t._version for t in tables)
    hit = _PLANS.get(key)
    if (hit is not None and all(a is b for a, b in zip(hit[0], tables))
            and hit[1] == versions):
        return hit[2]
    plan = build(*(t.cpu().numpy().astype(np.int64) for t in tables))
    if key not in _PLANS and len(_PLANS) >= 32:
        _PLANS.pop(next(iter(_PLANS)))
    _PLANS[key] = (tuple(tables), versions, plan)
    return plan


def aggregate_plan(coarse: CoarseSpace) -> TieredPlan:
    """The gather plan that sums N particle rows into the G aggregates,
    each aggregate its particles in ascending order (the mass term of
    :func:`coarse_matrix` and the coarse restriction of the cycle)."""
    g_count = coarse.num_aggregates
    return _cached_plan(
        (coarse.agg_ids,), g_count,
        lambda agg: make_jacobi_gather(agg[:, None], g_count,
                                       coarse.agg_ids.device))


def pair_plan(coarse: CoarseSpace, element_indices: torch.Tensor
              ) -> TieredPlan:
    """The gather plan that sums the 4·E·d pair-block rows of
    :func:`coarse_matrix` over ``element_indices`` (mesh or block order)
    into the G² aggregate pairs, each pair its rows in ascending order."""
    g_count = coarse.num_aggregates
    return _cached_plan(
        (element_indices, coarse.agg_ids), g_count * g_count,
        lambda idx, agg: make_jacobi_gather(
            _pair_ids(agg, idx, g_count)[:, None], g_count * g_count,
            coarse.agg_ids.device))


def coarse_matrix(
    coarse: CoarseSpace,
    obj,
    K: torch.Tensor,  # (E, d, d) decoupled blocks on ``element_indices``
    dt: float,
    beta: float = 0.0,
    free_mask: Optional[torch.Tensor] = None,
    element_indices: Optional[torch.Tensor] = None,
    coeff=None,
    mass_vec: Optional[torch.Tensor] = None,
    group=None,
) -> torch.Tensor:
    """C = R̃ᵀ·Ã·R̃ (G·n_rb, G·n_rb), assembled exactly in O(E) (the JAX
    package's ``coarse_matrix``).  With ``group`` (element sharding: K and
    ``element_indices`` a rank's slice) the aggregate-pair sum is summed
    over its ranks, one all-reduce.

    The general form is C = Rᵀ·diag(``mass_vec``)·R − ``coeff``·Rᵀ·G(K)·R:
    the dynamic system takes the defaults (``obj.mass``, dt·(dt + β)); the
    static solve passes coeff = 1 and mass_vec = 0.  For x = R·y the
    graph-Laplacian form xᵀG(K)x = Σ_e Σ_j s_jᵀ·K_e·s_j, s_j = x_{v_{j+1}} −
    x_{v_0}, so each element's edge j adds four aggregate-pair blocks
    (+T_jᵀKT_j, −T_jᵀKT_0, −T_0ᵀKT_j, +T_0ᵀKT_0), T_i = basis[v_i]; the
    mass term is aggregate-block-diagonal.  ``free_mask`` zeroes pinned
    particles' basis rows (the Dirichlet-projected coarse operator).  K
    may live on another element order than the object's
    (``element_indices``: the blocked operator's block order, whose padded
    slots carry K = 0).  The result is symmetrized and given a ridge of
    1e-6 of its mean diagonal."""
    d, n = obj.dim, obj.particle_cnt
    nrb = n_rigid_modes(d)
    g_count = coarse.num_aggregates
    basis = coarse.basis
    if free_mask is not None:
        basis = basis * free_mask[..., None]
    idx = obj.element_indices if element_indices is None else element_indices
    e = idx.shape[0]
    t = basis[idx.long()]  # (E, d+1, d, nrb)
    t0, tj = t[:, 0], t[:, 1:]
    kt0 = torch.einsum("eab,ebr->ear", K, t0)  # K·T_0
    ktj = torch.einsum("eab,ejbr->ejar", K, tj)  # K·T_j
    p_jj = torch.einsum("ejas,ejar->ejsr", tj, ktj)
    p_j0 = -torch.einsum("ejas,ear->ejsr", tj, kt0)
    p_0j = -torch.einsum("eas,ejar->ejsr", t0, ktj)
    p_00 = torch.einsum("eas,ear->esr", t0, kt0)
    pair_blocks = torch.cat([
        p_jj.reshape(e * d, nrb * nrb),
        p_j0.reshape(e * d, nrb * nrb),
        p_0j.reshape(e * d, nrb * nrb),
        p_00.reshape(e, 1, nrb * nrb).expand(e, d, nrb * nrb)
        .reshape(e * d, nrb * nrb),
    ])
    gkr = all_reduce_sum(gather_tiered(pair_blocks, pair_plan(coarse, idx)),
                         group).reshape(g_count, g_count, nrb, nrb)
    if coeff is None:
        coeff = dt * (dt + beta)
    if mass_vec is None:
        mass_vec = obj.mass
    mb = torch.einsum("nas,nar->nsr", basis,
                      basis * mass_vec[:, None, None])
    mass_diag = gather_tiered(mb.reshape(n, nrb * nrb),
                              aggregate_plan(coarse)).reshape(
        g_count, nrb, nrb)
    c = -coeff * gkr
    ar = torch.arange(g_count, device=c.device)
    c[ar, ar] = c[ar, ar] + mass_diag
    c_dense = c.permute(0, 2, 1, 3).reshape(g_count * nrb, g_count * nrb)
    # Symmetrized: the decoupled blocks are individually nonsymmetric, as
    # the fine operator is (its PCG runs on the symmetrized form).
    c_dense = 0.5 * (c_dense + c_dense.T)
    ridge = 1e-6 * torch.trace(c_dense) / c_dense.shape[0]
    return c_dense + ridge * torch.eye(c_dense.shape[0], dtype=c_dense.dtype,
                                       device=c_dense.device)


def static_diag_blocks(obj, K: torch.Tensor, lam) -> torch.Tensor:
    """Per-particle diagonal blocks (N, d, d) of the static operator
    H + λ·I, H = −G(K): vertex 0 of an element receives d·K, vertices 1..d
    K (the JAX package's ``static_diag_blocks``), assembled through the
    object's gather plan."""
    d = obj.dim
    e = K.shape[0]
    w = torch.ones((1, d + 1, 1), dtype=K.dtype, device=K.device)
    w[0, 0, 0] = float(d)
    diag_k = gather_assemble(w * K.reshape(e, 1, d * d),
                             obj.plan.idx).reshape(-1, d, d)
    eye = torch.eye(d, dtype=K.dtype, device=K.device)[None]
    return lam * eye - diag_k


class TwoLevelSetup(NamedTuple):
    """The prebuilt preconditioner (symmetrized space): the
    Gershgorin-shifted smoother inverse, R̃'s rows, the equilibrated
    Cholesky factor of C and its guard flag, √m, and — when the setup was
    given the operator — ω and λmax(D⁻¹Ã).  ``plan`` is the coarse space's
    :func:`aggregate_plan`."""

    minv: torch.Tensor  # (N, d, d)
    basis_t: torch.Tensor  # (N, d, n_rb)
    agg_ids: torch.Tensor  # (N,)
    num_aggregates: int
    dscale: torch.Tensor  # (G·n_rb,)
    chol_l: torch.Tensor  # (G·n_rb, G·n_rb) lower factor
    chol_ok: torch.Tensor  # scalar bool
    sq: torch.Tensor  # (N, 1) √m
    plan: TieredPlan
    omega: Optional[torch.Tensor] = None
    lam_max: Optional[torch.Tensor] = None


def _vdot(a, b):
    return torch.sum(a * b)


def _block_apply(minv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Σ_j minv[n, i, j]·r[n, j], an elementwise sum (no matmul)."""
    return torch.sum(minv * r[:, None, :], dim=-1)


def estimate_lam_max(
    smooth_apply: Callable[[torch.Tensor], torch.Tensor],
    op: Callable[[torch.Tensor], torch.Tensor],
    shape_like: torch.Tensor,
    iters: int = 16,
) -> torch.Tensor:
    """λmax(D⁻¹Ã) by ``iters`` power iterations from the rough start vector
    sin((1 + i)·2.399963) (f32; λmax's eigenvector is element-scale
    oscillatory, which a smooth start would meet only through rounding).
    A 0-d tensor on the device; nothing is read back."""
    n = shape_like.numel()
    rough = torch.sin(
        (1.0 + torch.arange(n, dtype=torch.float32,
                            device=shape_like.device)) * 2.399963
    ).reshape(shape_like.shape).to(shape_like.dtype)
    v = smooth_apply(rough)
    lam = torch.ones((), dtype=shape_like.dtype, device=shape_like.device)
    for _ in range(iters):
        w = smooth_apply(op(v))
        lam = torch.sqrt(_vdot(w, w)) / torch.clamp(
            torch.sqrt(_vdot(v, v)), min=1e-30)
        v = w / torch.clamp(torch.sqrt(_vdot(w, w)), min=1e-30)
    return torch.clamp(lam, min=1e-6)


def estimate_omega(
    smooth_apply: Callable[[torch.Tensor], torch.Tensor],
    op: Callable[[torch.Tensor], torch.Tensor],
    shape_like: torch.Tensor,
    iters: int = 16,
    safety: float = 0.9,
) -> torch.Tensor:
    """ω = ``safety`` / λmax(D⁻¹Ã): the damped-Jacobi V-cycle is SPD only
    for ω·λmax < 2, so the margin absorbs an under-estimate."""
    return safety / estimate_lam_max(smooth_apply, op, shape_like, iters)


def _cholesky_ok(c: torch.Tensor):
    """(factor, ok): ``torch.linalg.cholesky_ex`` and whether it succeeded
    (``info`` 0 and every entry finite) — one host read."""
    chol, info = torch.linalg.cholesky_ex(c)
    ok = (info == 0) & torch.isfinite(chol).all()
    return chol, ok, bool(ok)


def two_level_setup(
    diag: torch.Tensor,  # (N, d, d) diagonal blocks of A
    mass: torch.Tensor,  # (N,)
    coarse: CoarseSpace,
    c_matrix: torch.Tensor,
    free_mask: Optional[torch.Tensor] = None,
    operator: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> TwoLevelSetup:
    """The reusable preconditioner pieces (the JAX package's
    ``two_level_setup``): the smoother's per-block Gershgorin SPD shift,
    C Jacobi-equilibrated and factored through the SPD guard ladder — the
    plain factor; else the factor of C shifted by its largest Gershgorin
    deficit + 1e-6; else no coarse correction (``chol_ok`` false) — and,
    given ``operator`` (A in the original space), λmax(D⁻¹Ã) and
    ω = 0.9/λmax by power iteration."""
    d = diag.shape[-1]
    sq = torch.sqrt(mass)[:, None]
    basis = coarse.basis
    if free_mask is not None:
        basis = basis * free_mask[..., None]
    basis_t = basis * sq[..., None]

    dsym = 0.5 * (diag + sm.mT(diag))
    main = torch.diagonal(dsym, dim1=-2, dim2=-1)
    absdiag = torch.abs(main)
    offdiag = torch.sum(torch.abs(dsym), dim=-1) - absdiag
    gersh_min = torch.min(main - offdiag, dim=-1).values
    scale = torch.mean(absdiag, dim=-1) + 1e-30
    shift_b = torch.clamp(0.01 * scale - gersh_min, min=0.0)
    eye = torch.eye(d, dtype=diag.dtype, device=diag.device)[None]
    minv = sm.inv(dsym + shift_b[:, None, None] * eye)

    dscale = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(c_matrix),
                                          min=1e-20))
    c_eq = c_matrix * dscale[:, None] * dscale[None, :]
    eye_c = torch.eye(c_eq.shape[0], dtype=c_eq.dtype, device=c_eq.device)
    chol_l, chol_ok, ok = _cholesky_ok(c_eq)
    if not ok:
        diag_c = torch.diagonal(c_eq)
        row_abs = torch.sum(torch.abs(c_eq), dim=1) - torch.abs(diag_c)
        shift = torch.clamp(torch.max(row_abs - diag_c), min=0.0) + 1e-6
        chol_l, chol_ok, ok = _cholesky_ok(c_eq + shift * eye_c)
        if not ok:
            chol_l = eye_c
    omega = lam_max = None
    if operator is not None:
        def _op_sym(y):
            return sq * operator(y / sq)

        lam_max = estimate_lam_max(lambda r: _block_apply(minv, r), _op_sym,
                                   basis[..., 0])
        omega = 0.9 / lam_max
    return TwoLevelSetup(
        minv=minv, basis_t=basis_t, agg_ids=coarse.agg_ids,
        num_aggregates=coarse.num_aggregates, dscale=dscale, chol_l=chol_l,
        chol_ok=chol_ok, sq=sq, plan=aggregate_plan(coarse), omega=omega,
        lam_max=lam_max)


def two_level_pcg(
    operator: Callable[[torch.Tensor], torch.Tensor],  # A (original space)
    diag: Optional[torch.Tensor],
    mass: torch.Tensor,
    coarse: Optional[CoarseSpace],
    c_matrix: Optional[torch.Tensor],
    rhs: torch.Tensor,
    x0: torch.Tensor,
    max_iter: int = 500,
    tol=1e-5,
    omega: Optional[float] = None,
    free_mask: Optional[torch.Tensor] = None,
    precond_operator: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    setup: Optional[TwoLevelSetup] = None,
    cycle: str = "multiplicative",
    smoother: str = "jacobi",
    cheb_degree: int = 3,
    cheb_alpha: float = 8.0,
) -> CGResult:
    """PCG on the mass-symmetrized operator with the two-level
    preconditioner (the JAX package's ``two_level_pcg``): the symmetric
    V-cycle (``cycle="multiplicative"``, with ``smoother`` ``"jacobi"`` or
    ``"chebyshev"`` of degree ``cheb_degree`` over [λmax/``cheb_alpha``,
    1.1·λmax]) or additive Schwarz (``"additive"``).  Termination is the
    reference's absolute rᵀr > ``tol`` on the original residual
    (``tol`` a float or a 0-d tensor); x₀ = ``x0``.  ``setup`` reuses a
    frozen preconditioner; otherwise it is built here from ``diag``,
    ``coarse`` and ``c_matrix``.
    ``precond_operator`` runs the cycle's own residual updates on another
    approximation of A.  The Jacobi smoother's ω is ``omega``, else the
    setup's, else power-iterated here once a solve, as is λmax for
    Chebyshev when the setup has none."""
    if cycle not in ("additive", "multiplicative"):
        raise ValueError(f"unknown two-level cycle {cycle!r}")
    if smoother not in ("jacobi", "chebyshev"):
        raise ValueError(f"unknown two-level smoother {smoother!r}")
    if smoother == "chebyshev" and cycle != "multiplicative":
        raise ValueError(
            "smoother='chebyshev' requires the multiplicative cycle"
        )
    if setup is None:
        setup = two_level_setup(diag, mass, coarse, c_matrix, free_mask)
    minv, basis_t, sq = setup.minv, setup.basis_t, setup.sq
    nrb = basis_t.shape[-1]
    g_count = setup.num_aggregates
    agg_long = setup.agg_ids.long()

    def op(y):  # Ã in the symmetrized space
        return sq * operator(y / sq)

    if precond_operator is None:
        op_m = op
    else:
        def op_m(y):
            return sq * precond_operator(y / sq)

    def smooth_apply(r):
        return _block_apply(minv, r)

    def coarse_apply(r):
        ry = gather_tiered(torch.einsum("nar,na->nr", basis_t, r),
                           setup.plan).reshape(-1, 1)
        y = setup.dscale[:, None] * torch.cholesky_solve(
            setup.dscale[:, None] * ry, setup.chol_l)
        y = torch.where(setup.chol_ok, y, 0.0).reshape(g_count, nrb)
        return torch.einsum("nar,nr->na", basis_t, y[agg_long])

    if cycle == "additive":
        omega_t = 1.0 if omega is None else float(omega)

        def apply_m(r):
            return omega_t * smooth_apply(r) + coarse_apply(r)

    elif smoother == "chebyshev":
        lam = (setup.lam_max if setup.lam_max is not None
               else estimate_lam_max(smooth_apply, op_m, rhs))
        ub = 1.1 * lam  # an over-estimate weakens the sweep, never breaks SPD
        lb = ub / float(cheb_alpha)
        theta = 0.5 * (ub + lb)
        delta = 0.5 * (ub - lb)
        sigma = theta / delta

        def cheb_sweep(x0_, r0, need_r):
            """k Chebyshev steps on Ã·x = b from (x0_, r0 = b − Ã·x0_);
            (x, r), r exact for x when ``need_r``."""
            rho = 1.0 / sigma
            dvec = smooth_apply(r0) / theta
            x, r = x0_, r0
            for _ in range(cheb_degree - 1):
                x = x + dvec
                r = r - op_m(dvec)
                rho_next = 1.0 / (2.0 * sigma - rho)
                dvec = (rho_next * rho) * dvec + (
                    2.0 * rho_next / delta) * smooth_apply(r)
                rho = rho_next
            return x + dvec, (r - op_m(dvec)) if need_r else r

        def apply_m(r):
            x1, r1 = cheb_sweep(torch.zeros_like(r), r, True)
            e = coarse_apply(r1)
            x2 = x1 + e
            r2 = r1 - op_m(e)
            x3, _ = cheb_sweep(x2, r2, False)
            return x3

    else:
        if omega is not None:
            omega_t = float(omega)
        elif setup.omega is not None:
            omega_t = setup.omega
        else:
            omega_t = estimate_omega(smooth_apply, op_m, rhs)

        def apply_m(r):
            x1 = omega_t * smooth_apply(r)
            r1 = r - op_m(x1)
            x2 = x1 + coarse_apply(r1)
            r2 = r - op_m(x2)
            return x2 + omega_t * smooth_apply(r2)

    def rr_orig(r):
        q = r / sq
        return _vdot(q, q)

    y = sq * x0
    r = sq * rhs - op(y)
    p = apply_m(r)
    delta_k = _vdot(r, p)
    rr = rr_orig(r)
    it = 0
    while it < max_iter and bool(rr > tol):
        q = op(p)
        alpha = delta_k / _vdot(p, q)
        y = y + alpha * p
        r = r - alpha * q
        z = apply_m(r)
        delta_next = _vdot(r, z)
        p = z + (delta_next / delta_k) * p
        delta_k = delta_next
        rr = rr_orig(r)
        it += 1
    return CGResult(
        y / sq, torch.tensor(it, dtype=torch.int32, device=y.device), rr)
