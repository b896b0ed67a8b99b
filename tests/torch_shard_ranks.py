# coding=utf-8
"""The rank side of tests/test_torch_sharding.py: the sharded cases as data
(config dicts both packages parse, seeds of the start states) and the
functions that gloo ranks run on them.  It imports the port only: a rank
never imports JAX; the test module builds the JAX package's references
from the same table."""

import numpy as np
import torch

from fem_tpu_torch.models.mesh import construct_2d_mesh, construct_3d_grid_mesh
from fem_tpu_torch.models.state import Obstacles, build_object
from fem_tpu_torch.utils.config import parse_config

WORLD = 4
# The composed mesh's shape: batch × elem ranks of a world of their own.
BATCH_MESH = (2, 4)
MEMBERS = 4

CIRCLES = [{"id": 0, "block_center": [0.8, 0.5], "block_radius": 0.21},
           {"id": 1, "block_center": [0.2, 0.5], "block_radius": 0.21}]
# default.json's square (tests/utils.py default_sim_config).
BASE_2D = dict(dim=2, delta_time=5e-4, sim_count=2, auto_diff=True,
               use_explicit_method=True, implicit_method=0, preconditioned=1,
               g_dir=[0.0, -1.0], blocks=CIRCLES,
               objects=[dict(center=[0.5, 0.8], side_length=0.2,
                             subdivisions=4)])
# A 3D tet grid (tests/utils.py default_sim_config_3d, subdivisions 3).
BASE_3D = dict(dim=3, delta_time=5e-4, sim_count=2, auto_diff=False,
               use_explicit_method=False, implicit_method=1,
               preconditioned=1, g_dir=[0.0, -1.0, 0.0], blocks=[],
               objects=[dict(center=[0.4, 0.6, 0.4], side_length=0.2,
                             subdivisions=3)])

METHODS = {
    "explicit": dict(auto_diff=False, use_explicit_method=True),
    "autodiff": dict(auto_diff=True, use_explicit_method=True),
    "cg-precond": dict(auto_diff=False, use_explicit_method=False,
                       implicit_method=1, preconditioned=1),
    "cg-plain": dict(auto_diff=False, use_explicit_method=False,
                     implicit_method=1, preconditioned=0),
    "jacobi": dict(auto_diff=False, use_explicit_method=False,
                   implicit_method=0),
}


def _with(base, obj=None, **over):
    data = dict(base, **over)
    if obj:
        data["objects"] = [dict(o, **obj) for o in base["objects"]]
    return data


# name → (kind, config dict, velocity-noise seed and scale or None).
# "substep" runs one sharded substep, "frame" one sharded frame.
CASES = {}
for _m, _over in METHODS.items():
    CASES[f"2d-{_m}"] = ("substep", _with(BASE_2D, **_over), (1, 0.2))
    CASES[f"3d-{_m}"] = ("substep", _with(BASE_3D, **_over), (3, 0.2))
CASES.update({
    "3d-frame": ("frame", _with(BASE_3D, sim_count=3), (7, 0.2)),
    "pallas-prep": ("substep", _with(BASE_3D, element_backend="pallas"),
                    (5, 0.2)),
    "block-jacobi": ("substep", _with(BASE_3D, cg_precond="block_jacobi"),
                     (7, 0.2)),
    "precond-none": ("substep", _with(BASE_3D, cg_precond="none"), (7, 0.2)),
    "corotated": ("substep", _with(BASE_3D, {"material": "corotated"},
                                   preconditioned=0), (9, 0.2)),
    "newton-exact": ("substep", _with(BASE_3D, preconditioned=0,
                                      integrator="newton"), (11, 0.3)),
    "newton-decoupled": ("substep", _with(
        BASE_3D, preconditioned=0, integrator="newton",
        newton_hessian="decoupled"), (13, 0.3)),
    "plastic": ("frame", _with(BASE_3D, {"plastic_yield": 0.02},
                               preconditioned=0, delta_time=1e-3),
                (17, 0.3)),
    "sdf-obstacle": ("frame", _with(
        BASE_3D, preconditioned=0, obstacles=[
            dict(type="halfspace", point=[0.0, 0.55, 0.0],
                 normal=[0.0, 1.0, 0.0], friction=0.3),
            dict(type="box", lo=[0.0, 0.0, 0.0], hi=[0.35, 0.6, 0.35])]),
        (19, 0.3)),
})

_BODIES = [(0.5, 0.35, 800.0, 8e4), (0.5, 0.62, 500.0, 4e4)]
# tests/test_sharding.py's two squares coupled by penalty contact.
CONTACT = {
    name: dict(dim=2, delta_time=5e-4, sim_count=5, auto_diff=False,
               g_dir=[0.0, -1.0], contact="penalty", blocks=[],
               objects=[dict(id=i, center=[cx, cy], side_length=0.18,
                             subdivisions=5, rho=rho, E=e, nu=0.25,
                             damping=10.0)
                        for i, (cx, cy, rho, e) in enumerate(_BODIES)],
               **over)
    for name, over in (
        ("explicit", dict(use_explicit_method=True)),
        ("implicit-cg", dict(use_explicit_method=False, implicit_method=1,
                             preconditioned=0)))}
CONTACT_FRAMES = 4
# tests/test_sharding.py's Simulation(sharded=True) contact scene.
API_SPEC = {
    "dim": 2, "delta_time": 5e-4, "sim_count": 5,
    "use_explicit_method": True, "g_dir": [0.0, -1.0], "contact": "penalty",
    "objects": [
        {"id": 0, "center": [0.5, 0.3], "side_length": 0.15,
         "subdivisions": 4},
        {"id": 1, "center": [0.5, 0.55], "side_length": 0.15,
         "subdivisions": 4},
    ],
    "blocks": [],
}
API_FRAMES = 3
BATCH_CASE = _with(BASE_2D, **METHODS["cg-precond"])


def mesh_of(ocfg, dim):
    """(vertices, faces, elements) of a body: the square or the tet grid."""
    if dim == 2:
        return construct_2d_mesh(ocfg)
    return construct_3d_grid_mesh(ocfg)


def velocity_noise(shape, noise):
    """The start velocities of a case, float32 numpy (None: none)."""
    if noise is None:
        return None
    seed, scale = noise
    return np.random.default_rng(seed).normal(scale=scale, size=shape).astype(
        np.float32)


def batch_noise(shape):
    """The members' position noise of the batched case, float32."""
    return np.random.default_rng(0).normal(scale=1e-4, size=shape).astype(
        np.float32)


def _scene(data):
    cfg = parse_config(data)
    built = [build_object(o, *mesh_of(o, cfg.dim), device="cpu")
             for o in cfg.objects]
    obstacles = Obstacles.from_configs(cfg.blocks, cfg.dim, cfg.obstacles,
                                       device="cpu")
    return cfg, built, obstacles


def _arrays(state, aux=None):
    out = {"pos": state.pos.numpy().copy(), "vel": state.vel.numpy().copy()}
    if state.plastic_inv is not None:
        out["plastic_inv"] = state.plastic_inv.numpy().copy()
    if aux is not None:
        out["iterations"] = aux.solver_iterations.numpy().copy()
    return out


def run_case(name, mesh, single: bool):
    """(sharded arrays, single-device arrays or None) of one case of
    :data:`CASES` on ``mesh``."""
    from fem_tpu_torch.parallel import sharding
    from fem_tpu_torch.sim import make_frame_fn, make_substep_fn

    kind, data, noise = CASES[name]
    cfg, [(obj, state)], obstacles = _scene(data)
    vel = velocity_noise(tuple(state.pos.shape), noise)
    if vel is not None:
        state = state.replace(vel=torch.from_numpy(vel))
    if kind == "frame":
        sharded = sharding.make_sharded_frame_fn(obj, cfg, mesh)
        plain = make_frame_fn(obj, cfg) if single else None
    else:
        sharded = sharding.make_sharded_substep_fn(obj, cfg, mesh)
        plain = make_substep_fn(obj, cfg) if single else None
    got = _arrays(*sharded(state, obstacles))
    return got, (_arrays(*plain(state, obstacles)) if single else None)


def run_contact(name, mesh, single: bool):
    from fem_tpu_torch.contact import make_contact_frame_fn
    from fem_tpu_torch.parallel import sharding

    cfg, built, obstacles = _scene(CONTACT[name])
    objs = [o for o, _ in built]

    def run(frame):
        states = tuple(s for _, s in built)
        for _ in range(CONTACT_FRAMES):
            states, _aux = frame(states, obstacles)
        return [_arrays(s) for s in states]

    got = run(sharding.make_sharded_contact_frame_fn(objs, cfg, mesh))
    return got, (run(make_contact_frame_fn(objs, cfg)) if single else None)


def run_api(single: bool):
    from fem_tpu_torch.api import Simulation

    def run(**kw):
        sim = Simulation.from_dict(API_SPEC, device="cpu", **kw)
        sim.run(frames=API_FRAMES)
        return [sim.positions(i) for i in range(len(sim.scene))]

    return run(sharded=True), (run() if single else None)


def element_world(rank, world):
    """Every world-4 case on this rank: {case: (sharded arrays, rank 0's
    single-device arrays or None)}, with the contact frames and the
    sharded ``Simulation`` under their own keys."""
    from fem_tpu_torch.parallel.sharding import make_element_mesh

    mesh = make_element_mesh(world, device="cpu")
    single = rank == 0
    out = {name: run_case(name, mesh, single) for name in CASES}
    for name in CONTACT:
        out[f"contact-{name}"] = run_contact(name, mesh, single)
    out["api-contact"] = run_api(single)
    return out


def batch_world(rank, world):
    """The (batch × elem) case on this rank: (sharded arrays, rank 0's
    ``make_batched_frame_fn`` arrays or None)."""
    from fem_tpu_torch.batch import broadcast_state, make_batched_frame_fn
    from fem_tpu_torch.parallel.sharding import (
        make_2d_mesh,
        make_batched_sharded_frame_fn,
    )

    mesh = make_2d_mesh(*BATCH_MESH, device="cpu")
    cfg, [(obj, state)], obstacles = _scene(BATCH_CASE)
    states = broadcast_state(state, MEMBERS)
    states = states.replace(pos=states.pos + torch.from_numpy(
        batch_noise(tuple(states.pos.shape))))
    got = _arrays(*make_batched_sharded_frame_fn(obj, cfg, mesh)(
        states, obstacles))
    plain = None
    if rank == 0:
        plain = _arrays(*make_batched_frame_fn(obj, cfg)(states, obstacles))
    return got, plain
