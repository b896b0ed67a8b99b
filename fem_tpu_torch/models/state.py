# coding=utf-8
"""State containers: dataclasses of tensors plus static scalars.

The port of the JAX package's ``models/state.py`` restricted to the reference
fields, the materials and the inelastic extension.  :class:`SimState` is the dynamic state
(per particle, plus the per-element internal inverses of an inelastic
material), :class:`FemObject` the static mesh and material data, and
:class:`Obstacles` the circle obstacle set.  Every tensor of one object lives
on one device, chosen by ``build_object``'s ``device`` argument.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from fem_tpu_torch.ops.assembly import GatherPlan, make_gather_plan
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

    @property
    def device(self) -> torch.device:
        return self.mass.device


@dataclasses.dataclass
class Obstacles:
    """Circular obstacle set (reference: circle_blocks.py:6-25).  Zero-radius
    blocks are skipped by the collision predicate (kinematic.py:34-35)."""

    centers: torch.Tensor  # (B, d)
    radii: torch.Tensor  # (B,)

    @staticmethod
    def from_configs(
        blocks: Tuple[BlockConfig, ...], dim: int, obstacle_cfgs=(),
        device="cuda",
    ) -> "Obstacles":
        if obstacle_cfgs:
            raise NotImplementedError(
                "typed obstacles (SimConfig.obstacles: halfspaces, boxes, "
                "spheres, mesh SDFs) are not ported yet (ROADMAP M13)"
            )
        dev = resolve_device(device)
        centers = [b.block_center for b in blocks]
        radii = [b.block_radius for b in blocks]
        if not centers:
            centers, radii = [np.zeros((dim,), np.float32)], [0.0]
        return Obstacles(
            centers=torch.as_tensor(np.array(centers, np.float32), device=dev),
            radii=torch.as_tensor(np.array(radii, np.float32), device=dev),
        )


def check_supported_object(cfg: ObjectConfig) -> None:
    """Raise for object features this slice of the port does not cover
    (every material runs; an unknown one raises ``ValueError``)."""
    check_material(cfg.material)
    if cfg.pin_boxes or cfg.load_boxes:
        raise NotImplementedError(
            "pins and loads (pin_boxes / load_boxes) are not ported yet "
            "(ROADMAP M13)"
        )
    if cfg.damping_beta != 0.0:
        raise NotImplementedError(
            "Rayleigh damping_beta is not ported yet (ROADMAP M13)"
        )


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
) -> Tuple[FemObject, SimState]:
    """:class:`FemObject` + initial :class:`SimState` from mesh arrays
    (reference Object.__init__ + particles_init, object.py:44-93, 337-343:
    ``pos = vertices + center``), on ``device``."""
    check_supported_object(cfg)
    dev = resolve_device(device)
    d = vertices.shape[1]
    pos = vertices.astype(np.float32) + np.asarray(cfg.center, np.float32)
    ref_inv, volume, mass = init_element_data(pos, element_indices, cfg.rho)
    n = pos.shape[0]
    idx = np.asarray(element_indices).astype(np.int32)
    obj = FemObject(
        element_indices=torch.as_tensor(idx, device=dev),
        ref_inv=torch.as_tensor(ref_inv, device=dev),
        volume=torch.as_tensor(volume, device=dev),
        mass=torch.as_tensor(mass, device=dev),
        rest_pos=torch.as_tensor(pos, device=dev),
        faces=torch.as_tensor(np.asarray(faces).astype(np.int32), device=dev),
        plan=make_gather_plan(idx, n, dev),
        blocking=build_blocking(idx, ref_inv, volume, pos, device=dev),
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
    )
    return obj, initial_state(pos, dev, obj)


def initial_state(pos: np.ndarray, device, obj: FemObject = None) -> SimState:
    """Rest state: positions given, every velocity channel zero, and the
    internal inverses ``obj`` enables at the identity (JAX state.py:347-348)."""
    p = torch.tensor(np.asarray(pos, np.float32), device=device)
    state = SimState(
        pos=p,
        vel=torch.zeros_like(p),
        vel_g=torch.zeros_like(p),
        force=torch.zeros_like(p),
    )
    if obj is None:
        return state
    eye = torch.eye(obj.dim, device=device).expand(obj.element_cnt, -1, -1)
    return state.replace(
        plastic_inv=eye.clone() if obj.plastic_yield > 0.0 else None,
        viscous_inv=eye.clone() if obj.viscous_mu > 0.0 else None,
    )
