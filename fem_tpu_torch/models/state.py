# coding=utf-8
"""State containers: dataclasses of tensors plus static scalars.

The port of the JAX package's ``models/state.py``: the reference fields, the
materials, the inelastic extension, pins and loads, Rayleigh damping and
the typed obstacles.  :class:`SimState` is the dynamic state (per particle,
plus the per-element internal inverses of an inelastic material),
:class:`FemObject` the static mesh and material data, and
:class:`Obstacles` the circles plus the typed SDF obstacles
(``obstacles.py``).  Every tensor of one object lives on one device, chosen
by ``build_object``'s ``device`` argument.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from fem_tpu_torch.ops.assembly import (
    GatherPlan,
    TieredPlan,
    build_jacobi_plan,
    make_gather_plan,
    make_jacobi_gather,
)
from fem_tpu_torch.ops.blocking import Blocking, build_blocking
from fem_tpu_torch.ops.element import check_material
from fem_tpu_torch.utils.config import BlockConfig, ObjectConfig
from fem_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class SimState:
    """Per-particle dynamic state (reference ``Particle`` fields)."""

    pos: torch.Tensor  # (N, d)
    vel: torch.Tensor  # (N, d)
    vel_g: torch.Tensor  # (N, d) implicit-path gravity velocity (implicit.py:409)
    force: torch.Tensor  # (N, d) energy gradient accumulator (explicit.py:46)
    # Internal inverses of the inelastic extension (ops/inelastic.py), (E, d,
    # d) in mesh element order, identity at rest; None when off:
    # plastic_inv = F_p⁻¹ (plastic_yield > 0), viscous_inv = F_v⁻¹ (the
    # Maxwell branch, viscous_mu > 0).
    plastic_inv: Optional[torch.Tensor] = None
    viscous_inv: Optional[torch.Tensor] = None
    # (N, d) weighted-Jacobi relaxation anchor, the reference's never-reset
    # ``past_vec_x`` (object.py:85): zero at start (None reads as zero),
    # carried across substeps and frames; only the Jacobi solve changes it.
    jacobi_past_x: Optional[torch.Tensor] = None

    def replace(self, **changes) -> "SimState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class FemObject:
    """Static per-object data: mesh topology, rest configuration, material."""

    element_indices: torch.Tensor  # (E, d+1) int32
    ref_inv: torch.Tensor  # (E, d, d) inverse rest-edge matrices (object.py:362)
    volume: torch.Tensor  # (E,) rest volumes (object.py:356)
    mass: torch.Tensor  # (N,) lumped masses (object.py:358-360)
    rest_pos: torch.Tensor  # (N, d)
    faces: torch.Tensor  # (M, 3) int32 render/surface faces
    plan: GatherPlan  # per-particle assembly plan (ops/assembly.py)
    blocking: Blocking = None  # locality blocks (ops/blocking.py)
    # Dense ±1 edge matrix S (E·d, N) of operator_mode="mxu"
    # (solvers/implicit.build_edge_matrix); None unless that mode was
    # forced at build time and E·d·N ≤ 16,000,000.
    edge_matrix: Optional[torch.Tensor] = None
    dim: int = 3
    particle_cnt: int = 0
    element_cnt: int = 0
    mesh_cnt: int = 0
    mu: float = 0.0
    s_lambda: float = 0.0
    damping: float = 0.0
    rho: float = 0.0
    material: str = "neo_hookean"
    plastic_yield: float = 0.0  # von-Mises yield strain; 0 = off
    viscous_mu: float = 0.0  # Maxwell branch shear modulus; 0 = off
    viscous_tau: float = 0.1  # Maxwell branch relaxation time
    # Pins (ObjectConfig.pin_boxes): (N, 1) 1.0 on free vertices, 0.0 on
    # pinned ones; None without pins.  The implicit solve projects pinned
    # vertices out (P·A·P + I − P) and both advection steps hold them.
    free_mask: Optional[torch.Tensor] = None
    # (N, d) prescribed velocity of moving pins (3-entry pin_boxes), zero
    # elsewhere; None when no pin moves.
    pin_vel: Optional[torch.Tensor] = None
    # (N, d) static load (ObjectConfig.load_boxes), the mass-weighted share
    # of each box's total force; None without loads.
    static_load: Optional[torch.Tensor] = None
    # Stiffness-proportional Rayleigh damping β (ObjectConfig.damping_beta):
    # the damping force β·G(K)·v; 0 = off.
    damping_beta: float = 0.0
    # Block-sparse rows of the serial Jacobi sweep
    # (ops/assembly.build_jacobi_plan): the neighbour of each row slot (−1
    # padded), each contribution's flat slot and sign, and their inverse,
    # each slot's contributions (ops/assembly.make_jacobi_gather).  None on
    # an object built without them: the serial sweep then assembles the
    # dense system.
    jacobi_nb: Optional[torch.Tensor] = None  # (N, max_nb) int32
    jacobi_slots: Optional[torch.Tensor] = None  # (E, 4d) int32
    jacobi_coeff: Optional[torch.Tensor] = None  # (E, 4d) float32 ±1
    jacobi_gather: Optional[TieredPlan] = None
    # Coarse space of the two-level preconditioner (solvers/multilevel.py):
    # Morton particle aggregates and each particle's rows of the rigid-body
    # basis, built on the host at load (:func:`coarse_arrays`).
    agg_ids: Optional[torch.Tensor] = None  # (N,) int32
    agg_basis: Optional[torch.Tensor] = None  # (N, d, n_rb) float32
    num_aggregates: int = 0
    # Under element sharding (parallel/sharding.shard_object): this rank's
    # first row in the padded mesh element order, whose rows
    # [element_start, element_start + element_cnt) it holds; 0 unsharded.
    element_start: int = 0

    @property
    def device(self) -> torch.device:
        return self.mass.device


@dataclasses.dataclass
class Obstacles:
    """Circular obstacle set (reference: circle_blocks.py:6-25).  Zero-radius
    blocks are skipped by the collision predicate (kinematic.py:34-35).

    The typed SDF obstacles (SimConfig.obstacles, ``obstacles.py``; all None
    without them): half-spaces, solid boxes, frictional spheres and mesh
    SDF grids, with a Coulomb coefficient each.  A frictionless ``sphere``
    folds into ``centers``/``radii``."""

    centers: torch.Tensor  # (B, d)
    radii: torch.Tensor  # (B,)
    half_p: Optional[torch.Tensor] = None  # (H, d) half-space anchor points
    half_n: Optional[torch.Tensor] = None  # (H, d) outward unit normals
    box_lo: Optional[torch.Tensor] = None  # (Bx, d) solid-box corners
    box_hi: Optional[torch.Tensor] = None  # (Bx, d)
    sdf_grid: Optional[torch.Tensor] = None  # (M, nx, ny, nz) mesh SDF grids
    sdf_origin: Optional[torch.Tensor] = None  # (M, 3)
    sdf_spacing: Optional[torch.Tensor] = None  # (M,)
    sph_c: Optional[torch.Tensor] = None  # (S, d) frictional spheres
    sph_r: Optional[torch.Tensor] = None  # (S,)
    # Coulomb coefficients μ per obstacle of each class (config constants).
    half_f: Tuple[float, ...] = ()
    box_f: Tuple[float, ...] = ()
    sdf_f: Tuple[float, ...] = ()
    sph_f: Tuple[float, ...] = ()

    @staticmethod
    def from_configs(
        blocks: Tuple[BlockConfig, ...], dim: int, obstacle_cfgs=(),
        device="cuda",
    ) -> "Obstacles":
        dev = resolve_device(device)
        centers = [b.block_center for b in blocks]
        radii = [b.block_radius for b in blocks]
        fields = {}
        if obstacle_cfgs:
            from fem_tpu_torch.obstacles import build_extension_arrays

            fields, spheres = build_extension_arrays(obstacle_cfgs, dim, dev)
            for c, r in spheres:
                centers.append(c)
                radii.append(r)
        if not centers:
            centers, radii = [np.zeros((dim,), np.float32)], [0.0]
        return Obstacles(
            centers=torch.as_tensor(np.array(centers, np.float32), device=dev),
            radii=torch.as_tensor(np.array(radii, np.float32), device=dev),
            **fields,
        )


def check_supported_object(cfg: ObjectConfig) -> None:
    """Raise for object features the port does not cover (every material,
    pins, loads and β run; an unknown material raises ``ValueError``)."""
    check_material(cfg.material)


def _box_selection(pos: np.ndarray, lo, hi) -> np.ndarray:
    """(N,) bool: the vertices inside the closed box [lo, hi]."""
    lo_a = np.asarray(lo, np.float32)
    hi_a = np.asarray(hi, np.float32)
    return np.all((pos >= lo_a) & (pos <= hi_a), axis=1)


def pin_arrays(cfg: ObjectConfig, pos: np.ndarray):
    """(free_mask (N, 1), pin_vel (N, d) or None) of ``cfg.pin_boxes``, or
    (None, None) without pins (the JAX package's build_object): a vertex in
    any box is pinned; a 3-entry box also prescribes its velocity."""
    if not cfg.pin_boxes:
        return None, None
    n, d = pos.shape
    pinned = np.zeros((n,), bool)
    pin_vel = np.zeros((n, d), np.float32)
    moving = False
    for box in cfg.pin_boxes:
        sel = _box_selection(pos, box[0], box[1])
        pinned |= sel
        if len(box) > 2:
            pin_vel[sel] = np.asarray(box[2], np.float32)
            moving = True
    free = (~pinned).astype(np.float32)[:, None]
    return free, (pin_vel if moving else None)


def load_array(cfg: ObjectConfig, pos: np.ndarray, mass: np.ndarray):
    """(N, d) static load of ``cfg.load_boxes``, or None without loads:
    each box's total force spread over its vertices by mass (the JAX
    package's build_object); a box that selects no vertex raises."""
    if not cfg.load_boxes:
        return None
    load = np.zeros(pos.shape, np.float32)
    for lo, hi, f_total in cfg.load_boxes:
        sel = _box_selection(pos, lo, hi)
        if not sel.any():
            raise ValueError(
                f"load_boxes: box ({lo}, {hi}) selects no vertices"
            )
        w = mass * sel
        w = w / w.sum()
        load += w[:, None] * np.asarray(f_total, np.float32)[None, :]
    return load


def init_element_data(
    vertices: np.ndarray, element_indices: np.ndarray, rho: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side element initialization (reference ``elements_init``,
    object.py:346-362): volumes (2D: |cross|/2, 3D: |det|/6), lumped vertex
    masses ``V·ρ/(d+1)`` and ``ref = r⁻¹`` of the rest edge matrices.

    Returns (ref_inv (E,d,d), volume (E,), mass (N,)) as float32 numpy.
    """
    v = vertices.astype(np.float64)
    idx = element_indices.astype(np.int64)
    d = v.shape[1]
    p = v[idx]  # (E, d+1, d)
    r = np.swapaxes(p[:, 1:, :] - p[:, 0:1, :], -1, -2)  # columns = edges
    if d == 2:
        vol = 0.5 * np.abs(r[:, 0, 0] * r[:, 1, 1] - r[:, 1, 0] * r[:, 0, 1])
    else:
        vol = np.abs(np.linalg.det(r)) / 6.0
    mass = np.zeros(v.shape[0])
    np.add.at(mass, idx.reshape(-1), np.repeat(vol / (d + 1) * rho, d + 1))
    ref_inv = np.linalg.inv(r)
    return (
        ref_inv.astype(np.float32),
        vol.astype(np.float32),
        mass.astype(np.float32),
    )


def build_object(
    cfg: ObjectConfig,
    vertices: np.ndarray,
    faces: np.ndarray,
    element_indices: np.ndarray,
    device="cuda",
    operator_mode: str = "auto",
) -> Tuple[FemObject, SimState]:
    """:class:`FemObject` + initial :class:`SimState` from mesh arrays
    (reference Object.__init__ + particles_init, object.py:44-93, 337-343:
    ``pos = vertices + center``), on ``device``.

    ``operator_mode`` mirrors ``SimConfig.operator_mode``, as in the JAX
    package: the dense edge matrix S (O(E·d·N) memory) is built only when
    ``"mxu"`` is forced and E·d·N ≤ 16,000,000; ``"auto"`` prefers the
    blocked operator and leaves it out."""
    from fem_tpu_torch.solvers.implicit import build_edge_matrix

    check_supported_object(cfg)
    dev = resolve_device(device)
    d = vertices.shape[1]
    pos = vertices.astype(np.float32) + np.asarray(cfg.center, np.float32)
    ref_inv, volume, mass = init_element_data(pos, element_indices, cfg.rho)
    n = pos.shape[0]
    idx = np.asarray(element_indices).astype(np.int32)
    free_mask, pin_vel = pin_arrays(cfg, pos)
    static_load = load_array(cfg, pos, mass)

    def tensor(a):
        return None if a is None else torch.as_tensor(a, device=dev)

    want_mxu = operator_mode == "mxu" and idx.shape[0] * d * n <= 16_000_000

    obj = FemObject(
        element_indices=torch.as_tensor(idx, device=dev),
        ref_inv=torch.as_tensor(ref_inv, device=dev),
        volume=torch.as_tensor(volume, device=dev),
        mass=torch.as_tensor(mass, device=dev),
        rest_pos=torch.as_tensor(pos, device=dev),
        faces=torch.as_tensor(np.asarray(faces).astype(np.int32), device=dev),
        plan=make_gather_plan(idx, n, dev),
        blocking=build_blocking(idx, ref_inv, volume, pos, device=dev),
        edge_matrix=tensor(build_edge_matrix(idx, n) if want_mxu else None),
        dim=d,
        particle_cnt=n,
        element_cnt=int(idx.shape[0]),
        mesh_cnt=int(faces.shape[0]),
        mu=cfg.mu,
        s_lambda=cfg.s_lambda,
        damping=cfg.damping,
        rho=cfg.rho,
        material=cfg.material,
        plastic_yield=cfg.plastic_yield,
        viscous_mu=cfg.viscous_mu,
        viscous_tau=cfg.viscous_tau,
        free_mask=tensor(free_mask),
        pin_vel=tensor(pin_vel),
        static_load=tensor(static_load),
        damping_beta=cfg.damping_beta,
        **jacobi_arrays(idx, n, dev),
        **coarse_arrays(pos, dev),
    )
    return obj, initial_state(pos, dev, obj)


def jacobi_arrays(element_indices: np.ndarray, n: int, device) -> dict:
    """The Jacobi fields of :class:`FemObject` on ``device``, from
    ``element_indices`` (JAX state.py:277-279, 316-318)."""
    nb, slots, coeff = build_jacobi_plan(element_indices, n)
    return dict(
        jacobi_nb=torch.as_tensor(nb, device=device),
        jacobi_slots=torch.as_tensor(slots, device=device),
        jacobi_coeff=torch.as_tensor(coeff, device=device),
        jacobi_gather=make_jacobi_gather(slots, nb.size, device),
    )


def coarse_arrays(rest_pos: np.ndarray, device, agg_ids=None,
                  agg_basis=None) -> dict:
    """The coarse-space fields of :class:`FemObject` on ``device`` (JAX
    state.py:288-295, 322-324): ``agg_ids`` and ``agg_basis`` as given, or
    built from ``rest_pos`` at the default aggregate size
    (``solvers/multilevel.build_aggregates``: 10 particles in 2D, 40 in
    3D); ``num_aggregates`` = the largest id + 1."""
    from fem_tpu_torch.solvers.multilevel import (
        build_aggregates,
        default_aggregate_size,
    )

    rest_pos = np.asarray(rest_pos, np.float32)
    if agg_ids is None:
        agg_ids, agg_basis = build_aggregates(
            rest_pos, default_aggregate_size(rest_pos.shape[1]))
    agg_ids = np.array(agg_ids, np.int32)
    return dict(
        agg_ids=torch.as_tensor(agg_ids, device=device),
        agg_basis=torch.as_tensor(np.array(agg_basis, np.float32),
                                  device=device),
        num_aggregates=int(agg_ids.max()) + 1,
    )


def initial_state(pos: np.ndarray, device, obj: FemObject = None) -> SimState:
    """Rest state: positions given, every velocity channel and the Jacobi
    anchor zero, and the internal inverses ``obj`` enables at the identity
    (JAX state.py:347-348)."""
    p = torch.tensor(np.asarray(pos, np.float32), device=device)
    state = SimState(
        pos=p,
        vel=torch.zeros_like(p),
        vel_g=torch.zeros_like(p),
        force=torch.zeros_like(p),
        jacobi_past_x=torch.zeros_like(p),
    )
    if obj is None:
        return state
    eye = torch.eye(obj.dim, device=device).expand(obj.element_cnt, -1, -1)
    return state.replace(
        plastic_inv=eye.clone() if obj.plastic_yield > 0.0 else None,
        viscous_inv=eye.clone() if obj.viscous_mu > 0.0 else None,
    )
