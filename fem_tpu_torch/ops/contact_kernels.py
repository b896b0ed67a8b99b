# coding=utf-8
"""C1 and C2: the penalty contact's pair forces, one launch a substep.

``pair_forces`` (C1) is the dense pass: every pair of the participating
vertices of different bodies, and the pairs of one body that its
self-contact mask admits, over the concatenated vertex soup.
``grid_pair_forces`` (C2) is the uniform grid's narrow phase, after the
sort and the lookup of ``broadphase.grid_contact_forces``.  For tensors on
a CUDA device each launches its hand-written kernel
(``fem_tpu_torch/csrc/contact_pairs.cu``, ``csrc/contact_grid.cu``); for
tensors on the CPU each runs its plain PyTorch version (``*_plain``),
which is the JAX package's computation written in PyTorch.  On CUDA each
launches its kernel or raises; it never falls back.  Each wrapper counts
its launches (``launches``).

Neither replaces a TPU kernel: the JAX package computes both in XLA
(its ``contact.py:92-218`` and ``:370-402``, and its
``broadphase.py:82-232``).  The plain functions of this module are
that computation and keep its names (``contact.py`` re-exports them):

* ``_pair_coefs``, ``pair_contact_forces``, ``self_contact_forces``: the
  distance as ‖a‖² + ‖b‖² − 2a·bᵀ (TF32 off) and the force as
  x·Σcoef − coef·x, a viscous dashpot on the overlap ramp;
* ``_pair_mu_forces``: direct differences and the regularized Coulomb cone
  (``contact_mu`` > 0).

The kernels compute each pair's force term for term as the plain versions
do and sum each vertex's row in a fixed order, with no float atomics, so
two runs are bit-identical; against the plain versions they differ by the
order of the sums (and C1 by the order of the three-term distance's sums):
agreement to f32 rounding, stated in the tests relative to max |f|.

C1 has two variants (:func:`contact_plan`): the cluster variant, on every
path, spreads each row tile's partners over a thread-block cluster of P
CTAs whose partials the leader adds in rank order, reads the self-contact
masks as bits (:func:`pack_mask_bits`) and rejects a pair on its squared
distance (:func:`d2_threshold`) before the root only where the exact test
rejects it too; the rows variant, the first design, is kept for the checks
that hold the cluster variant to it (the same accepted pairs, and with
P = 1 the same bits).

C2 has two variants (:func:`grid_plan`): the warp variant, on every path,
gathers the soup into rank order and gives each sorted vertex a warp that
hands its candidates (listed from the run table :func:`grid_runs`, no
binary search) to the lanes 32 at a time, rejects a pair on d² as C1 does
and adds the hits in candidate order; the thread variant, the first design,
a thread a sorted vertex, is kept for the checks.  The two are
bit-identical: every pair's terms are the same bits, summed in the same
order.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from fem_tpu_torch.utils import cuda_build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


# -- the plain pair forces (the JAX package's contact.py:92-218) --------------

def _pair_coefs(pos_a, pos_b, radius, stiffness):
    """Pairwise distances → (penalty coefficient, overlap ramp) matrices."""
    sq_a = torch.sum(pos_a * pos_a, dim=1)
    sq_b = torch.sum(pos_b * pos_b, dim=1)
    cross = pos_a @ pos_b.T
    d2 = torch.clamp(sq_a[:, None] + sq_b[None, :] - 2.0 * cross, min=1e-18)
    dist = torch.sqrt(d2)
    pen = torch.clamp(radius - dist, min=0.0)
    # The normalization distance is floored at 0.1·radius: near-coincident
    # particles get a large but bounded push.
    coef = stiffness * pen / torch.clamp(dist, min=0.1 * radius)
    return coef, pen / radius


def _pair_mu_forces(pos_a, pos_b, vel_a, vel_b, radius, stiffness,
                    friction_c, mu, mu_slope, mask=None):
    """Dense pair forces with explicit (ns_a, ns_b, d) pair tensors, for the
    Coulomb cone: direct differences, the penalty k·pen/max(dist, 0.1r),
    the optional isotropic dashpot and min(mu_slope·|v_t|, μ·k·pen)·v̂_t.
    ``mask`` (0/1, zero diagonal) admits same-body pairs.  Returns
    (f_a, f_b); antisymmetric per pair."""
    diff = pos_a[:, None, :] - pos_b[None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    dist = torch.sqrt(torch.clamp(d2, min=1e-18))
    pen = torch.clamp(radius - dist, min=0.0)
    if mask is not None:
        pen = pen * mask  # also zeroes the dist ≈ 0 diagonal
    coef = stiffness * pen / torch.clamp(dist, min=0.1 * radius)
    f_pair = coef[..., None] * diff
    dv = vel_a[:, None, :] - vel_b[None, :, :]
    if friction_c > 0.0:
        f_pair = f_pair - friction_c * (pen / radius)[..., None] * dv
    active = pen > 0.0
    n_hat = diff / dist[..., None]
    v_t = dv - torch.sum(dv * n_hat, dim=-1, keepdim=True) * n_hat
    t_speed = torch.sqrt(torch.clamp(torch.sum(v_t * v_t, dim=-1),
                                     min=1e-24))
    f_t_mag = torch.minimum(mu_slope * t_speed, mu * stiffness * pen)
    f_t_mag = torch.where(active, f_t_mag, 0.0)
    f_pair = f_pair - (f_t_mag / t_speed)[..., None] * v_t
    return torch.sum(f_pair, dim=1), -torch.sum(f_pair, dim=0)


def pair_contact_forces(pos_a, pos_b, radius, stiffness, vel_a=None,
                        vel_b=None, friction_c=0.0, mu=0.0, mu_slope=0.0):
    """Penalty forces (f_a, f_b) between two particle sets; f_b is the exact
    opposite scatter of the same pair forces.  With ``friction_c`` > 0 and
    velocities, the viscous pair dashpot f_i −= c·Σ_j w_ij (v_i − v_j);
    ``mu`` > 0 with velocities takes :func:`_pair_mu_forces`."""
    if mu > 0.0 and vel_a is not None:
        return _pair_mu_forces(pos_a, pos_b, vel_a, vel_b, radius, stiffness,
                               friction_c, mu, mu_slope)
    coef, w = _pair_coefs(pos_a, pos_b, radius, stiffness)
    row = torch.sum(coef, dim=1)
    col = torch.sum(coef, dim=0)
    f_a = pos_a * row[:, None] - coef @ pos_b
    f_b = pos_b * col[:, None] - coef.T @ pos_a
    if friction_c > 0.0 and vel_a is not None:
        cw = friction_c * w
        rw = torch.sum(cw, dim=1)
        cwc = torch.sum(cw, dim=0)
        f_a = f_a - (vel_a * rw[:, None] - cw @ vel_b)
        f_b = f_b - (vel_b * cwc[:, None] - cw.T @ vel_a)
    return f_a, f_b


def self_contact_forces(pos, mask, radius, stiffness, vel=None,
                        friction_c=0.0, mu=0.0, mu_slope=0.0):
    """Same-body penalty forces over the pairs the static ``mask`` admits
    (0/1, symmetric, zero diagonal: the rest-distance exclusion of
    ``contact.build_contact_plan``); ``mu`` > 0 with a velocity takes the
    Coulomb variant, whose row sums give every particle its force."""
    if mu > 0.0 and vel is not None:
        f_a, _ = _pair_mu_forces(pos, pos, vel, vel, radius, stiffness,
                                 friction_c, mu, mu_slope, mask=mask)
        return f_a
    coef, w = _pair_coefs(pos, pos, radius, stiffness)
    coef = coef * mask
    f = pos * torch.sum(coef, dim=1)[:, None] - coef @ pos
    if friction_c > 0.0 and vel is not None:
        cw = friction_c * (w * mask)
        f = f - (vel * torch.sum(cw, dim=1)[:, None] - cw @ vel)
    return f


# -- C1: the dense pass over the vertex soup ----------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class PairTables:
    """C1's static tables over a soup of bodies' participating vertices
    (body after body): the bodies' sizes on the host, each vertex's body
    (int32), each body's self-contact mask (uint8, (ns_i, ns_i), None
    when off: views of one flat ``mask_cat``), and ``body_table`` (B, 3)
    int64 on the device: each body's first soup row, its size and its
    mask's offset in ``mask_cat`` (−1 when off).  The cluster variant reads
    the same masks packed a bit a pair: ``mask_bits`` (int32 words, each
    row of a mask ⌈ns_i / 32⌉ words, partner j of the body at bit j % 32 of
    word j // 32) and ``bit_offsets`` (B,) int64, each mask's first word
    (−1 when off)."""

    sizes: Tuple[int, ...]
    body_id: torch.Tensor
    masks: Tuple[Optional[torch.Tensor], ...]
    mask_cat: Optional[torch.Tensor]
    body_table: torch.Tensor
    mask_bits: Optional[torch.Tensor]
    bit_offsets: torch.Tensor


def pack_mask_bits(mask: np.ndarray) -> np.ndarray:
    """A 0/1 (n, n) mask as (n, ⌈n / 32⌉) uint32 words, column j at bit
    j % 32 of word j // 32."""
    n = mask.shape[0]
    words = (n + 31) // 32
    padded = np.zeros((n, 32 * words), dtype=np.uint64)
    padded[:, :n] = mask != 0
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    return (padded.reshape(n, words, 32) * weights).sum(
        axis=2).astype(np.uint32)


def pair_tables(sizes: Sequence[int], masks: Sequence[Optional[np.ndarray]],
                device) -> PairTables:
    """:class:`PairTables` of bodies of ``sizes`` participating vertices and
    self-contact ``masks`` (boolean or 0/1 (ns_i, ns_i) host arrays, or
    None), on ``device``.  The masks are copied as they are, never
    recomputed, and packed into bits once here."""
    sizes = tuple(int(s) for s in sizes)
    body_id = torch.repeat_interleave(
        torch.arange(len(sizes), dtype=torch.int32),
        torch.tensor(sizes, dtype=torch.int64)).to(device)
    flat, offsets, off = [], [], 0
    packed, bit_offsets, word = [], [], 0
    for n, m in zip(sizes, masks):
        if m is None:
            offsets.append(-1)
            bit_offsets.append(-1)
            continue
        m = np.asarray(m)
        if m.shape != (n, n):
            raise ValueError(f"a self-contact mask of shape {m.shape} for a "
                             f"body of {n} vertices")
        flat.append((m != 0).astype(np.uint8).reshape(-1))
        offsets.append(off)
        off += n * n
        packed.append(pack_mask_bits(m).reshape(-1))
        bit_offsets.append(word)
        word += packed[-1].size
    mask_cat = (torch.tensor(np.concatenate(flat), device=device)
                if flat else None)
    mask_bits = (torch.tensor(np.concatenate(packed).view(np.int32),
                              device=device) if packed else None)
    views = tuple(None if o < 0 else mask_cat[o:o + n * n].view(n, n)
                  for n, o in zip(sizes, offsets))
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    table = torch.tensor(np.stack([starts, np.asarray(sizes, np.int64),
                                   np.asarray(offsets, np.int64)], axis=1),
                         device=device)
    return PairTables(sizes, body_id, views, mask_cat, table, mask_bits,
                      torch.tensor(bit_offsets, dtype=torch.int64,
                                   device=device))


def pair_forces_plain(tables: PairTables, pos, vel, radius, stiffness,
                      friction_c=0.0, mu=0.0, mu_slope=0.0):
    """Plain PyTorch version of :func:`pair_forces`: the JAX package's loop
    over every unordered body pair, then each body's self-contact
    (its contact.py:385-402), on the soup's slices."""
    n = len(tables.sizes)
    sub_pos = list(torch.split(pos, tables.sizes))
    sub_vel = (list(torch.split(vel, tables.sizes)) if vel is not None
               else [None] * n)
    sub_f = [torch.zeros_like(p) for p in sub_pos]
    for i in range(n):
        for j in range(i + 1, n):
            f_i, f_j = pair_contact_forces(
                sub_pos[i], sub_pos[j], radius, stiffness, sub_vel[i],
                sub_vel[j], friction_c, mu, mu_slope)
            sub_f[i] = sub_f[i] + f_i
            sub_f[j] = sub_f[j] + f_j
    for i in range(n):
        if tables.masks[i] is not None:
            sub_f[i] = sub_f[i] + self_contact_forces(
                sub_pos[i], tables.masks[i], radius, stiffness, sub_vel[i],
                friction_c, mu, mu_slope)
    return torch.cat(sub_f)


# Threads a CTA of C1 and C2, C1's threads a vertex row and rows a CTA
# (csrc/contact_pairs.cu: kThreads, kSplit, kRows; csrc/contact_grid.cu:
# kThreads), and the cluster sizes of C1's cluster variant.
PAIR_THREADS = 128
PAIR_SPLIT = 4
PAIR_ROWS = PAIR_THREADS // PAIR_SPLIT
PAIR_CLUSTERS = (1, 2, 4, 8)
PAIR_VARIANTS = ("cluster", "rows")
H100_SMS = 132
GRID_THREADS = 128


class PairPlan(NamedTuple):
    """A launch of C1: ``tiles`` row tiles of ``PAIR_ROWS`` rows, each over
    a cluster of ``cluster`` CTAs (0: the rows variant, one CTA a tile)."""

    variant: str
    tiles: int
    cluster: int
    ctas: int


@functools.lru_cache(maxsize=64)
def contact_plan(n: int, variant: str = "cluster", cluster: int = 0,
                 sms: int = H100_SMS) -> PairPlan:
    """C1's launch over a soup of ``n`` vertices.  The cluster variant
    splits each row tile's partners over P CTAs, the smallest P of
    ``PAIR_CLUSTERS`` whose tiles × P reach 1.5 × ``sms`` (the SMs filled
    about twice), 8 where none does: two flagship surfaces' 41 tiles take
    8, the blob's 87 take 4, the shells' 768 take 1, AO's 7 take 8.
    ``cluster`` forces P; ``variant="rows"`` is the first design, a CTA a
    tile.  Raises ``ValueError`` for no vertex, an unknown variant or a P
    outside ``PAIR_CLUSTERS``.  Pure: no device is asked."""
    if n < 1:
        raise ValueError(f"C1 needs a vertex, got {n}")
    if variant not in PAIR_VARIANTS:
        raise ValueError(f"unknown C1 variant {variant!r}; one of "
                         f"{PAIR_VARIANTS}")
    tiles = -(-n // PAIR_ROWS)
    if variant == "rows":
        if cluster:
            raise ValueError("C1's rows variant takes no cluster")
        return PairPlan("rows", tiles, 0, tiles)
    if cluster:
        if cluster not in PAIR_CLUSTERS:
            raise ValueError(f"C1 takes clusters of {PAIR_CLUSTERS}, not "
                             f"{cluster}")
        p = cluster
    else:
        p = next((c for c in PAIR_CLUSTERS if 2 * tiles * c >= 3 * sms),
                 PAIR_CLUSTERS[-1])
    return PairPlan("cluster", tiles, p, tiles * p)


@functools.lru_cache(maxsize=64)
def d2_threshold(radius: float) -> float:
    """The cluster variant's pre-test bound on the squared distance: the
    float32 at or above (r·(1 + 2⁻²⁰))², r the float32 radius the kernel
    reads.  A pair with d2 ≥ it has √d2 ≥ r·(1 + 2⁻²⁰) > r, so its rounded
    distance is ≥ r and its exact test pen = max(r − dist, 0) > 0 fails:
    the pre-test rejects no pair that the exact test accepts."""
    r = float(np.float32(radius))
    bound = (r * (1.0 + 2.0 ** -20)) ** 2
    thr = np.float32(bound)
    if float(thr) < bound:
        thr = np.nextafter(thr, np.float32(np.inf))
    return float(thr)


_LIBS = {}


def _library(name: str):
    lib = _LIBS.get(name)
    if lib is None:
        lib = cuda_build.load(name)
        if name == "contact_pairs":
            lib.fem_contact_pairs.argtypes = [
                _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _F, _F, _F, _F,
                _F, _F, _F, _I, _I, _P, _P, _P]
            lib.fem_contact_pairs.restype = _I
            lib.fem_contact_pairs_error.argtypes = [_I]
            lib.fem_contact_pairs_error.restype = ctypes.c_char_p
        else:
            lib.fem_contact_grid.argtypes = [
                _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _F, _F, _F, _F,
                _F, _F, _F, _I, _I, _I, _P, _P]
            lib.fem_contact_grid.restype = _I
            lib.fem_contact_grid_warp.argtypes = [
                _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _F, _F, _F, _F, _F,
                _F, _F, _F, _I, _I, _I, _P, _P]
            lib.fem_contact_grid_warp.restype = _I
            lib.fem_contact_grid_error.argtypes = [_I]
            lib.fem_contact_grid_error.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def _check_soup(pos, vel, d_ok=(2, 3)):
    """(N, d, device) of a soup after checking what the kernels take."""
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if pos.dim() != 2 or pos.shape[1] not in d_ok:
        raise ValueError(f"positions of shape {tuple(pos.shape)}: the "
                         "contact kernels take (N, 2) or (N, 3)")
    n, d = pos.shape
    cuda_build.check_operand("pos", pos, (n, d), torch.float32, dev)
    if vel is not None:
        cuda_build.check_operand("vel", vel, (n, d), torch.float32, dev)
    return n, d, dev


def _pointer(t):
    return None if t is None else t.data_ptr()


def pair_forces(tables: PairTables, pos: torch.Tensor,
                vel: Optional[torch.Tensor], radius: float, stiffness: float,
                friction_c: float = 0.0, mu: float = 0.0,
                mu_slope: float = 0.0, variant: str = "cluster",
                cluster: int = 0,
                accepted: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Penalty forces (N, d) on the soup ``pos`` (velocities ``vel`` or
    None): every pair of vertices of different bodies, and the pairs of one
    body that its mask admits, each pair's force as
    :func:`pair_contact_forces` / :func:`self_contact_forces` compute it.

    CUDA tensors: one launch of C1 on :func:`contact_plan`'s plan, left in
    ``pair_forces.last_plan``: the cluster variant (each row tile's
    partners over a cluster of P CTAs, masks read as bits, a pre-test
    before the root; ``cluster`` forces P) or, with ``variant="rows"``,
    the first design (a row of ``PAIR_SPLIT`` threads a vertex over every
    partner); ``pair_forces.variant_launches`` counts the launches by
    (variant, CTAs).  ``accepted``, an (N,) int32 tensor, receives each row's
    accepted partners as the kernel counted them.  CPU tensors:
    :func:`pair_forces_plain`."""
    if pos.device.type == "cpu":
        contact_plan(pos.shape[0], variant, cluster)  # refuses as on CUDA
        return pair_forces_plain(tables, pos, vel, radius, stiffness,
                                 friction_c, mu, mu_slope)
    n, d, dev = _check_soup(pos, vel)
    nb = len(tables.sizes)
    if sum(tables.sizes) != n:
        raise ValueError(f"a soup of {n} vertices for bodies of "
                         f"{tables.sizes}")
    plan = contact_plan(n, variant, cluster)
    cuda_build.check_operand("body_id", tables.body_id, (n,), torch.int32,
                             dev)
    cuda_build.check_operand("body_table", tables.body_table, (nb, 3),
                             torch.int64, dev)
    cuda_build.check_operand("bit_offsets", tables.bit_offsets, (nb,),
                             torch.int64, dev)
    for name, t, dtype in (("mask_cat", tables.mask_cat, torch.uint8),
                           ("mask_bits", tables.mask_bits, torch.int32)):
        if t is not None:
            cuda_build.check_operand(name, t, tuple(t.shape), dtype, dev)
    if accepted is not None:
        cuda_build.check_operand("accepted", accepted, (n,), torch.int32,
                                 dev)
    out = torch.empty_like(pos)
    with_vel = vel is not None
    lib = _library("contact_pairs")
    rc = cuda_build.launch_on_stream(
        dev, dev.index, lib.fem_contact_pairs, d, n, nb, plan.cluster,
        pos.data_ptr(), _pointer(vel), tables.body_id.data_ptr(),
        tables.body_table.data_ptr(), _pointer(tables.mask_cat),
        _pointer(tables.mask_bits), tables.bit_offsets.data_ptr(), radius,
        stiffness, 0.1 * radius, d2_threshold(radius), friction_c,
        mu * stiffness, mu_slope, int(with_vel and friction_c > 0.0),
        int(with_vel and mu > 0.0), _pointer(accepted), out.data_ptr())
    if rc != 0:
        raise RuntimeError("C1 kernel launch failed: "
                           f"{lib.fem_contact_pairs_error(rc).decode()}")
    pair_forces.launches += 1
    key = (plan.variant, plan.ctas)
    pair_forces.variant_launches[key] = (
        pair_forces.variant_launches.get(key, 0) + 1)
    pair_forces.last_plan = plan
    return out


pair_forces.launches = 0
pair_forces.variant_launches = {}  # launches by (variant, CTAs)
pair_forces.last_plan = None


# -- C2: the grid narrow phase -------------------------------------------------

@functools.lru_cache(maxsize=16)
def forward_offsets_host(m: int, d: int) -> Tuple[int, ...]:
    """The (3^d − 1)/2 neighbour offsets whose linearized id delta is
    positive, in the JAX package's order (its broadphase.py:163-169):
    (dx, …) over {−1, 0, 1}^d, the last axis fastest."""
    all_offs = np.array(
        np.meshgrid(*([[-1, 0, 1]] * d), indexing="ij")
    ).reshape(d, -1).T @ np.array([int(m ** k) for k in range(d - 1, -1, -1)])
    return tuple(int(o) for o in all_offs[all_offs > 0])


def grid_pair_forces_plain(pos, vel, rest, body, cell_s, order, start, offs,
                           radius, stiffness, cap, friction_c=0.0, mu=0.0,
                           mu_slope=0.0, self_contact=False, excl=None):
    """Plain PyTorch version of :func:`grid_pair_forces`: the JAX package's
    candidate gather (its broadphase.py:171-232), +f summed on the
    finder and −f scattered (``index_add``) onto each candidate."""
    ns, d = pos.shape
    excl = 2.5 * radius if excl is None else excl
    pos_s = pos[order]
    vel_s = vel[order] if vel is not None else None
    body_s = body[order]
    slot = torch.arange(cap, dtype=torch.int64, device=pos.device)
    i_row = torch.arange(ns, dtype=torch.int64, device=pos.device)[:, None]
    idx_own = i_row + 1 + slot[None, :]
    idx_fwd = start.to(torch.int64)[:, :, None] + slot[None, None, :]
    idx = torch.cat([idx_own[:, None, :], idx_fwd], dim=1)
    tgt = torch.cat([cell_s[:, None], cell_s[:, None] + offs[None, :]], dim=1)
    idx_c = torch.clamp(idx, max=ns - 1)
    valid = (idx < ns) & (cell_s[idx_c] == tgt[:, :, None])
    j = idx_c.reshape(ns, -1)
    valid = valid.reshape(ns, -1)
    same_body = body_s[j] == body_s[:, None]
    if self_contact:
        rest_s = rest[order]
        rd = rest_s[j] - rest_s[:, None, :]
        rest_ok = torch.sum(rd * rd, dim=-1) > excl * excl
        admit = torch.where(same_body, rest_ok, True)
    else:
        admit = ~same_body
    valid = valid & admit
    diff = pos_s[:, None, :] - pos_s[j]
    d2 = torch.sum(diff * diff, dim=-1)
    dist = torch.sqrt(torch.clamp(d2, min=1e-18))
    pen = torch.clamp(radius - dist, min=0.0)
    coef = stiffness * pen / torch.clamp(dist, min=0.1 * radius)
    coef = torch.where(valid, coef, 0.0)
    f_pair = coef[..., None] * diff
    if vel is not None and (friction_c > 0.0 or mu > 0.0):
        dv = vel_s[:, None, :] - vel_s[j]
    if friction_c > 0.0 and vel is not None:
        w = torch.where(valid, pen / radius, 0.0)
        f_pair = f_pair - friction_c * w[..., None] * dv
    if mu > 0.0 and vel is not None:
        active = valid & (pen > 0.0)
        n_hat = diff / dist[..., None]
        v_t = dv - torch.sum(dv * n_hat, dim=-1, keepdim=True) * n_hat
        t_speed = torch.sqrt(torch.clamp(torch.sum(v_t * v_t, dim=-1),
                                         min=1e-24))
        f_n = stiffness * pen
        f_t_mag = torch.minimum(mu_slope * t_speed, mu * f_n)
        f_t_mag = torch.where(active, f_t_mag, 0.0)
        f_pair = f_pair - (f_t_mag / t_speed)[..., None] * v_t
    f_s = torch.sum(f_pair, dim=1)
    f_s = f_s.index_add(0, j.reshape(-1), -f_pair.reshape(-1, d))
    out = torch.zeros_like(pos)
    out[order] = f_s
    return out


# csrc/contact_grid.cu's CTAs: the thread variant's kThreads, the warp
# variant's kWarpThreads (a warp a sorted vertex).
GRID_THREADS = 128
GRID_WARP_THREADS = 64
GRID_VARIANTS = ("warp", "thread")


class GridPlan(NamedTuple):
    """A launch of C2: ``ctas`` CTAs of ``threads`` (the warp variant's
    after its soup gather)."""

    variant: str
    threads: int
    ctas: int


@functools.lru_cache(maxsize=64)
def grid_plan(n: int, d: int, cap: int,
              variant: Optional[str] = None) -> GridPlan:
    """C2's launch for a soup of ``n`` vertices in ``d`` dimensions at cell
    cap ``cap``: the warp variant (a warp a sorted vertex, CTAs of
    ``GRID_WARP_THREADS``) unless ``variant="thread"`` asks for the first
    design (a thread a sorted vertex, CTAs of ``GRID_THREADS``).  Raises
    ``ValueError`` for no vertex, d ∉ {2, 3}, a cap below 1 or an unknown
    variant.  Pure: no device is asked."""
    if variant not in (None,) + GRID_VARIANTS:
        raise ValueError(f"unknown C2 variant {variant!r}; one of "
                         f"{GRID_VARIANTS}")
    if n < 1:
        raise ValueError(f"C2 needs a vertex, got {n}")
    if d not in (2, 3):
        raise ValueError(f"C2 takes dim 2 or 3, not {d}")
    if cap < 1:
        raise ValueError(f"C2 needs a cell cap of at least 1, not {cap}")
    if variant == "thread":
        return GridPlan("thread", GRID_THREADS, -(-n // GRID_THREADS))
    per_cta = GRID_WARP_THREADS // 32
    return GridPlan("warp", GRID_WARP_THREADS, -(-n // per_cta))


@functools.lru_cache(maxsize=16)
def run_deltas_host(m: int, d: int) -> Tuple[int, ...]:
    """The run table's queries, as cell id deltas: for each row of the
    3^d neighbourhood (the cells that differ in the last axis only, the
    rows in the order of {−1, 0, 1}^(d−1), the last fastest) the deltas
    of its three cells and of the cell past them, base − 1, base, base + 1
    and base + 2.  So neighbourhood cell c (its index in {−1, 0, 1}^d)
    starts at column ``c + c // 3`` and ends at the next."""
    rows = np.array(np.meshgrid(*([[-1, 0, 1]] * (d - 1)), indexing="ij")
                    ).reshape(d - 1, -1).T
    bases = rows @ np.array([int(m ** k) for k in range(d - 1, 0, -1)])
    return tuple(int(b) + k - 1 for b in bases for k in range(4))


def run_column(cell: int) -> int:
    """The run table's column of the first rank of neighbourhood cell
    ``cell`` (csrc/contact_grid.cu's run_col); its end is the next."""
    return cell + cell // 3


def forward_columns(d: int) -> Tuple[int, ...]:
    """The run table's columns of the forward cells' first ranks, in
    :func:`forward_offsets_host`'s order (the neighbourhood's indices past
    its centre)."""
    centre = (3 ** d - 1) // 2
    return tuple(run_column(centre + 1 + o) for o in range(centre))


def grid_runs(cell_s: torch.Tensor, m: int, d: int) -> torch.Tensor:
    """The run table (ns, 4·3^(d−1)) int32 of the sorted cell ids
    ``cell_s``: each rank's first rank of every cell of its 3^d
    neighbourhood and the rank past each row of three
    (:func:`run_deltas_host`), by one ``torch.searchsorted`` (side left,
    as the forward starts).  Its forward cells' columns are those starts
    (:func:`forward_columns`)."""
    deltas = torch.tensor(run_deltas_host(m, d), dtype=cell_s.dtype,
                          device=cell_s.device)
    return torch.searchsorted(cell_s, cell_s[:, None] + deltas[None, :],
                              out_int32=True)


def grid_pair_forces(pos: torch.Tensor, vel: Optional[torch.Tensor],
                     rest: Optional[torch.Tensor], body: torch.Tensor,
                     cell_s: torch.Tensor, order: torch.Tensor,
                     runs: torch.Tensor, m: int, radius: float,
                     stiffness: float, cap: int, friction_c: float = 0.0,
                     mu: float = 0.0, mu_slope: float = 0.0,
                     self_contact: bool = False,
                     excl: Optional[float] = None,
                     variant: Optional[str] = None) -> torch.Tensor:
    """The grid narrow phase: penalty forces (ns, d) in the input order of
    ``pos``, given the sorted cell ids ``cell_s`` (int32), the stable sort
    ``order`` (int64) and each sorted vertex's run table ``runs``
    (:func:`grid_runs`, int32) over a grid of ``m`` cells an axis.  Every
    pair the JAX package's forward stencil finds, truncation at ``cap``
    included, gets its force, +f on the finder and −f on the candidate.

    CUDA tensors: one call of C2 on :func:`grid_plan`'s plan, left in
    ``grid_pair_forces.last_plan``: the warp variant (the soup gathered in
    rank order, a warp a sorted vertex over its candidates from ``runs``)
    or, with ``variant="thread"``, the first design (a thread a sorted
    vertex, its forward starts read from ``runs``, its backward runs found
    by binary search over ``cell_s``); both sum each vertex's +f over the
    candidates it finds and, for the −f half, over the vertices whose
    stencil finds it, in the same fixed order, so their outputs are
    bit-identical.  ``grid_pair_forces.variant_launches`` counts the calls
    by variant.  CPU tensors: :func:`grid_pair_forces_plain` over the
    forward starts, the table's :func:`forward_columns`."""
    d = pos.shape[1]
    excl = 2.5 * radius if excl is None else excl
    if pos.device.type == "cpu":
        grid_plan(pos.shape[0], d, cap, variant)  # refuses as on CUDA
        offs = torch.tensor(forward_offsets_host(m, d), dtype=cell_s.dtype)
        return grid_pair_forces_plain(
            pos, vel, rest, body, cell_s, order,
            runs[:, list(forward_columns(d))], offs, radius, stiffness, cap,
            friction_c, mu, mu_slope, self_contact, excl)
    n, d, dev = _check_soup(pos, vel)
    plan = grid_plan(n, d, cap, variant)
    cuda_build.check_operand("body", body, (n,), torch.int32, dev)
    cuda_build.check_operand("order", order, (n,), torch.int64, dev)
    cuda_build.check_operand("runs", runs, (n, 4 * 3 ** (d - 1)),
                             torch.int32, dev)
    if self_contact:
        cuda_build.check_operand("rest", rest, (n, d), torch.float32, dev)
    out = torch.empty_like(pos)
    with_vel = vel is not None
    friction = int(with_vel and friction_c > 0.0)
    coulomb = int(with_vel and mu > 0.0)
    lib = _library("contact_grid")
    if plan.variant == "warp":
        # The soup's row blocks: positions, then velocities and rest
        # positions where a term reads them (csrc/contact_grid.cu).
        blocks = 1 + int(friction or coulomb) + int(self_contact)
        soup = torch.empty((blocks * n, 4), dtype=torch.float32, device=dev)
        rc = cuda_build.launch_on_stream(
            dev, dev.index, lib.fem_contact_grid_warp, d, n, cap,
            pos.data_ptr(), _pointer(vel),
            _pointer(rest) if self_contact else None, body.data_ptr(),
            order.data_ptr(), runs.data_ptr(), soup.data_ptr(), radius,
            stiffness, 0.1 * radius, friction_c, mu, mu_slope, excl * excl,
            d2_threshold(radius), friction, coulomb, int(self_contact),
            out.data_ptr())
    else:
        cuda_build.check_operand("cell_s", cell_s, (n,), torch.int32, dev)
        rc = cuda_build.launch_on_stream(
            dev, dev.index, lib.fem_contact_grid, d, n, m, cap,
            pos.data_ptr(), _pointer(vel),
            _pointer(rest) if self_contact else None, body.data_ptr(),
            cell_s.data_ptr(), order.data_ptr(), runs.data_ptr(), radius,
            stiffness, 0.1 * radius, friction_c, mu, mu_slope, excl * excl,
            friction, coulomb, int(self_contact), out.data_ptr())
    if rc != 0:
        raise RuntimeError("C2 kernel launch failed: "
                           f"{lib.fem_contact_grid_error(rc).decode()}")
    grid_pair_forces.launches += 1
    grid_pair_forces.variant_launches[plan.variant] = (
        grid_pair_forces.variant_launches.get(plan.variant, 0) + 1)
    grid_pair_forces.last_plan = plan
    return out


grid_pair_forces.launches = 0
grid_pair_forces.variant_launches = {}  # calls by variant
grid_pair_forces.last_plan = None
