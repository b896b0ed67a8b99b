# coding=utf-8
"""Scene assembly: config → soft bodies + obstacles, on one device.

The port of the JAX package's ``scene.py`` (``SceneObject``,
``load_scene``; the reference builds this in main.py:51-61).  Each body is
built on its own.  It steps with its own frame function
(``sim.make_frame_fn(body.obj, cfg)``, one per body, as the reference's
main loop does), unless ``contact="penalty"`` couples the bodies: then all
step together through ``contact.make_contact_frame_fn`` (with more than
one body, or with ``self_contact``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from fem_tpu_torch.models.mesh import load_object_mesh
from fem_tpu_torch.models.state import FemObject, Obstacles, SimState, build_object
from fem_tpu_torch.sim import check_supported_config
from fem_tpu_torch.utils.config import SimConfig
from fem_tpu_torch.utils.device import resolve_device


class SceneObject:
    """One soft body plus its export auxiliaries."""

    def __init__(self, obj: FemObject, state: SimState, aux: dict):
        self.obj = obj
        self.state = state
        self.aux = aux  # obj_vertices / obj_faces / map_index for 3D export


def load_scene(
    cfg: SimConfig, interior_spacing: Optional[float] = None, device="cuda"
) -> Tuple[List[SceneObject], Obstacles]:
    """Build all soft bodies and the obstacle set of a parsed config on
    ``device`` (reference: main.py:57-61), printing each body's counts as
    the reference does (object.py:75-77).  A mesh path is read as given.
    Raises ``NotImplementedError`` for what the port does not cover."""
    dev = resolve_device(device)
    check_supported_config(cfg)
    scene = []
    for ocfg in cfg.objects:
        vertices, faces, elements, aux = load_object_mesh(
            ocfg, interior_spacing
        )
        obj, state = build_object(ocfg, vertices, faces, elements, device=dev,
                                  operator_mode=cfg.operator_mode)
        print(f"Vertex count: {obj.particle_cnt}")
        print(f"Mesh count: {obj.mesh_cnt}")
        print(f"Element count: {obj.element_cnt}")
        scene.append(SceneObject(obj, state, aux))
    obstacles = Obstacles.from_configs(cfg.blocks, cfg.dim, cfg.obstacles,
                                       device=dev)
    return scene, obstacles


def method_banner(cfg: SimConfig) -> str:
    """The reference's startup banner (its main.py:74-80)."""
    if cfg.use_explicit_method:
        return (
            "Simulation method: explicit method. "
            f"Auto-diff {bool(cfg.auto_diff)}"
        )
    if cfg.implicit_method == 0:
        return "Simulation method: implicit method. System Solver: jacobian iteration."
    return (
        "Simulation method: implicit method. System Solver: conjugate "
        f"gradient. Preconditioned: {bool(cfg.preconditioned)}"
    )
