# coding=utf-8
"""The flagship models and their example states.

The counterpart of the repository's ``__graft_entry__._flagship`` and
``entry``: ``configs/demo_spot.json`` — one 3D Neo-Hookean tet body (1,007
particles, 4,068 tets) under the reference implicit CG in normal-equations
mode, ``sim_count = 10`` — built on ``device`` (CUDA by default).  The
explicit flagship is the same body under the explicit method at
``delta_time = 1e-4``, the mesh's explicit stability limit (the JAX
package's ``bench.py`` explicit row).  ``load_config`` builds any shipped
single-body config the same way.  All three take keyword overrides of the
body's object config, for example the inelastic materials the JAX package's
flagship A/B runs (``plastic_yield=0.01``; with ``viscous_mu=2e4,
viscous_tau=0.01`` on the explicit flagship, as its
tests/test_blocked_frame.py does).  ``inverted_cube`` is the example state
of ``robust_inversion``: a small cube with one inverted, nearly flat tet.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch

from fem_tpu_torch.models.mesh import delaunay_tetrahedralize, load_object_mesh
from fem_tpu_torch.models.state import Obstacles, SimState, build_object
from fem_tpu_torch.scene import load_scene
from fem_tpu_torch.sim import check_supported_config, substep, substep_kwargs
from fem_tpu_torch.utils.config import (
    BlockConfig,
    ObjectConfig,
    SimConfig,
    read_config,
)
from fem_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_CONFIG = os.path.join(REPO, "configs", "demo_spot.json")


def load_config(path: str, device="cuda", sim_overrides=None,
                **object_overrides):
    """(cfg, obj, state, obstacles) of a single-body config file on
    ``device``, with ``sim_overrides`` (a dict) of its simulation config and
    ``object_overrides`` of every body's config; a mesh path in it is read
    relative to the repository.  The body is built for the config's
    ``operator_mode`` (``"mxu"`` attaches the edge matrix).  A config of
    several bodies is built by ``scene.load_scene`` and gives (cfg, [obj],
    [state], obstacles), one entry a body."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(read_config(path), **(sim_overrides or {}))
    check_supported_config(cfg)
    objects = []
    for ocfg in cfg.objects:
        ocfg = dataclasses.replace(ocfg, **object_overrides)
        if ocfg.obj is not None:
            obj_path = os.path.join(REPO, ocfg.obj)
            if not os.path.exists(obj_path):
                subprocess.run(
                    [sys.executable,
                     os.path.join(REPO, "assets", "make_assets.py")],
                    check=True,
                )
            ocfg = dataclasses.replace(ocfg, obj=obj_path)
        objects.append(ocfg)
    cfg = dataclasses.replace(cfg, objects=tuple(objects))
    if len(objects) != 1:
        bodies, obstacles = load_scene(cfg, device=dev)
        return (cfg, [b.obj for b in bodies], [b.state for b in bodies],
                obstacles)
    vertices, faces, elements, _aux = load_object_mesh(objects[0])
    obj, state = build_object(objects[0], vertices, faces, elements,
                              device=dev, operator_mode=cfg.operator_mode)
    obstacles = Obstacles.from_configs(cfg.blocks, cfg.dim, cfg.obstacles,
                                       device=dev)
    return cfg, obj, state, obstacles


def flagship(device="cuda", sim_overrides=None, **object_overrides):
    """(cfg, obj, state, obstacles) of the flagship config on ``device``."""
    return load_config(FLAGSHIP_CONFIG, device, sim_overrides,
                       **object_overrides)


def explicit_flagship(device="cuda", **object_overrides):
    """(cfg, obj, state, obstacles) of the explicit flagship on ``device``:
    the flagship body under ``use_explicit_method`` at ``delta_time = 1e-4``,
    lowered until its lowest particle sits 0.01 above the floor and falling
    at v_y = −1, so that it reaches the floor within the first frames."""
    cfg, obj, state, obstacles = flagship(device, **object_overrides)
    cfg = dataclasses.replace(cfg, use_explicit_method=True, delta_time=1e-4)
    pos = state.pos.clone()
    pos[:, 1] += 0.01 - pos[:, 1].min()
    vel = torch.zeros_like(state.vel)
    vel[:, 1] = -1.0
    return cfg, obj, state.replace(pos=pos, vel=vel), obstacles


def deformed(state: SimState) -> SimState:
    """Squash toward the centroid and add a downward velocity: the fresh
    free-fall state converges in 0 CG iterations (x₀ = b is exact), so the
    example state deforms the body to make the solver iterate."""
    c = state.pos.mean(dim=0, keepdim=True)
    squash = torch.tensor([[1.15, 0.7, 1.15]], device=state.pos.device)
    return state.replace(
        pos=c + (state.pos - c) * squash,
        vel=torch.full_like(state.vel, -0.05),
    )


def inverted_cube(device="cuda", flatten=3e-6):
    """(cfg, obj, state, obstacles) of the JAX package's robust-frame scene
    (its tests/test_blocked_frame.py: the unit cube meshed at spacing 0.45,
    scaled by 0.35, one sphere obstacle, the implicit CG in normal-equations
    mode, ``sim_count = 4``, ``robust_inversion``) with one tet whose base
    lies in a plane y = const and whose apex is pushed ``flatten`` past that
    plane: inverted and nearly flat (det F ≈ −1.7e-5 at 3e-6), so that
    det F² < 1e-8 and the robust clamp of the rhs log acts."""
    dev = resolve_device(device)
    corners = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float64)
    faces = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5],
                      [0, 5, 4], [2, 3, 7], [2, 7, 6], [0, 4, 7], [0, 7, 3],
                      [1, 2, 6], [1, 6, 5]], np.int32)
    nodes, tets = delaunay_tetrahedralize(corners, faces, 0.45)
    ocfg = ObjectConfig(center=(0.3, 0.45, 0.3), rho=1000.0, E=4e4, nu=0.3,
                        damping=10.0)
    obj, state = build_object(ocfg, (nodes * 0.35).astype(np.float32), faces,
                              tets.astype(np.int32), device=dev)
    pos = state.pos.cpu().numpy()
    idx = obj.element_indices.cpu().numpy()
    e, k = next((e, k) for e in range(idx.shape[0]) for k in range(4)
                if len({float(pos[v, 1]) for j, v in enumerate(idx[e])
                        if j != k}) == 1
                and pos[idx[e][k], 1] != pos[idx[e][(k + 1) % 4], 1])
    y = pos[idx[e][(k + 1) % 4], 1]
    pos[idx[e][k], 1] = y - np.sign(pos[idx[e][k], 1] - y) * flatten
    cfg = SimConfig(dim=3, delta_time=5e-4, sim_count=4,
                    use_explicit_method=False, auto_diff=False,
                    implicit_method=1, preconditioned=1,
                    g_dir=(0.0, -1.0, 0.0), robust_inversion=True,
                    objects=(ocfg,), blocks=(BlockConfig(
                        block_center=(0.45, 0.25, 0.45), block_radius=0.18),))
    obstacles = Obstacles.from_configs(cfg.blocks, 3, device=dev)
    return cfg, obj, state.replace(pos=torch.as_tensor(pos, device=dev)), \
        obstacles


def entry(device="cuda"):
    """``(fn, (obj, state, obstacles))``: ``fn`` is one implicit-CG substep
    of the flagship, and the state is the deformed example state."""
    cfg, obj, state, obstacles = flagship(device)
    kwargs = substep_kwargs(cfg)

    def fn(obj, state, obstacles):
        return substep(obj, state, obstacles, **kwargs)

    return fn, (obj, deformed(state), obstacles)


def _dryrun_rank(rank: int, world: int) -> str:
    """One rank of :func:`dryrun_multichip` (on the CPU, in a process group
    of ``world`` ranks): what the JAX package's ``dryrun_multichip`` runs
    over its devices, each check on the port's sharded functions.  Returns
    the summary line's body (the same on every rank)."""
    from fem_tpu_torch.models.mesh import construct_3d_grid_mesh
    from fem_tpu_torch.parallel.sharding import (
        make_2d_mesh,
        make_batched_sharded_frame_fn,
        make_element_mesh,
        make_sharded_contact_frame_fn,
        make_sharded_frame_fn,
    )
    from fem_tpu_torch.utils.config import ObstacleConfig

    dev = torch.device("cpu")
    rng = np.random.default_rng(0)

    def noisy(state):
        return state.replace(vel=torch.as_tensor(rng.normal(
            scale=0.3, size=tuple(state.pos.shape)).astype(np.float32)))

    # Flagship-scale tet grid (6·9³ = 4,374 tets, 1,000 particles), stiff
    # with strong velocity noise, so that CG runs tens of iterations a
    # substep over the sharded blocked operator.
    ocfg = ObjectConfig(subdivisions=9, side_length=0.3,
                        center=(0.35, 0.6, 0.35), E=4e5)
    cfg = SimConfig(dim=3, delta_time=1e-3, sim_count=2, auto_diff=False,
                    use_explicit_method=False, implicit_method=1,
                    preconditioned=1, g_dir=(0.0, -1.0, 0.0),
                    objects=(ocfg,), blocks=())
    obj, state = build_object(ocfg, *construct_3d_grid_mesh(ocfg), device=dev)
    assert obj.blocking is not None and obj.blocking.num_blocks >= world
    state = noisy(state)
    obstacles = Obstacles.from_configs(cfg.blocks, cfg.dim, device=dev)

    # Shape 1: the 1-D element mesh over every rank.
    mesh = make_element_mesh(world, device=dev)
    out, aux = make_sharded_frame_fn(obj, cfg, mesh)(state, obstacles)
    assert torch.isfinite(out.pos).all()
    iters1 = aux.solver_iterations.tolist()
    assert min(iters1) >= 8, f"CG barely iterated: {iters1}"

    # Shape 2: the composed (batch × elem) mesh, distinct members.
    n_batch = 2 if world % 2 == 0 else 1
    n_elem = world // n_batch
    mesh2d = make_2d_mesh(n_batch, n_elem, device=dev)
    members = 2 * n_batch
    vels = np.stack([rng.normal(scale=0.3, size=tuple(state.pos.shape))
                     .astype(np.float32) for _ in range(members)])
    batched = dataclasses.replace(state, **{
        f.name: getattr(state, f.name)[None].expand(
            (members,) + tuple(getattr(state, f.name).shape)).clone()
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)})
    batched = batched.replace(vel=torch.as_tensor(vels))
    out2, aux2 = make_batched_sharded_frame_fn(obj, cfg, mesh2d)(batched,
                                                                 obstacles)
    assert torch.isfinite(out2.pos).all()
    iters2 = aux2.solver_iterations
    assert int(iters2.min()) >= 8, f"batched CG barely iterated: {iters2}"

    # Shape 3: the feature matrix on a smaller grid over the 1-D mesh.
    vcfg = ObjectConfig(subdivisions=5, side_length=0.3,
                        center=(0.35, 0.6, 0.35), E=4e5)
    v_mesh = construct_3d_grid_mesh(vcfg)
    variants = {
        "newton": (dict(integrator="newton", newton_hessian="decoupled"), {}),
        "corotated": ({}, dict(material="corotated")),
        "sdf_obstacles": (dict(obstacles=(
            ObstacleConfig(type="halfspace", point=(0.0, 0.25, 0.0),
                           normal=(0.0, 1.0, 0.0), friction=0.3),
            ObstacleConfig(type="box", lo=(0.0, 0.0, 0.0),
                           hi=(0.2, 0.2, 0.2)))), {}),
        "plastic": ({}, dict(plastic_yield=0.02)),
    }
    summary = []
    for name, (sim_over, mat_over) in variants.items():
        v_ocfg = dataclasses.replace(vcfg, **mat_over)
        v_obj, v_state = build_object(v_ocfg, *v_mesh, device=dev)
        v_cfg = SimConfig(dim=3, delta_time=1e-3, sim_count=2,
                          auto_diff=False, use_explicit_method=False,
                          implicit_method=1, preconditioned=0,
                          g_dir=(0.0, -1.0, 0.0), objects=(v_ocfg,),
                          blocks=(), **sim_over)
        v_state = noisy(v_state)
        v_obs = Obstacles.from_configs(v_cfg.blocks, v_cfg.dim,
                                       v_cfg.obstacles, device=dev)
        v_out, v_aux = make_sharded_frame_fn(v_obj, v_cfg, mesh)(v_state,
                                                                 v_obs)
        assert torch.isfinite(v_out.pos).all(), name
        if name == "plastic":
            assert v_out.plastic_inv is not None
            assert torch.isfinite(v_out.plastic_inv).all()
        summary.append(f"{name}: iters {v_aux.solver_iterations.tolist()}")

    # Two bodies coupled by penalty contact.
    c_ocfgs = tuple(ObjectConfig(id=i, subdivisions=4, side_length=0.2,
                                 center=(0.4, 0.45 + 0.22 * i, 0.4), E=1e5)
                    for i in range(2))
    c_cfg = SimConfig(dim=3, delta_time=1e-3, sim_count=2, auto_diff=False,
                      use_explicit_method=False, implicit_method=1,
                      preconditioned=0, g_dir=(0.0, -1.0, 0.0),
                      objects=c_ocfgs, blocks=(), contact="penalty")
    c_built = [build_object(oc, *construct_3d_grid_mesh(oc), device=dev)
               for oc in c_ocfgs]
    c_out, _ = make_sharded_contact_frame_fn(
        [o for o, _ in c_built], c_cfg, mesh)(
        tuple(s for _, s in c_built), Obstacles.from_configs((), 3, device=dev))
    for s in c_out:
        assert torch.isfinite(s.pos).all()
    summary.append("contact: 2 bodies coupled OK")
    return (f"{world} ranks | 3D tet mesh ({obj.element_cnt} tets / "
            f"{obj.particle_cnt} particles, {obj.blocking.num_blocks} "
            f"locality blocks, blocked operator sharded) | 1-D elem mesh: CG "
            f"iters/substep {iters1} | 2-D ({n_batch} batch x {n_elem} elem) "
            f"mesh: {members} members, CG iters/substep "
            f"min={int(iters2.min())} max={int(iters2.max())} | feature "
            "matrix: " + "; ".join(summary))


def dryrun_multichip(n_devices: int) -> None:
    """One element-sharded frame of the 4,374-tet grid on ``n_devices``
    gloo ranks on the CPU (``parallel/launch.run_ranks``), over both mesh
    shapes and the feature matrix of the JAX package's
    ``__graft_entry__.dryrun_multichip``; prints ``dryrun_multichip OK``
    and the summary when every rank agrees."""
    from fem_tpu_torch.parallel.launch import run_ranks

    lines = run_ranks(_dryrun_rank, n_devices, timeout=600)
    assert len(set(lines)) == 1, lines
    print(f"dryrun_multichip OK: {lines[0]}")


def sharded_flagship_rank(rank: int, world: int, frames: int = 3) -> dict:
    """One rank of the flagship stepped element-sharded on the card: the
    deformed example state, ``frames`` frames of
    ``parallel/sharding.make_sharded_frame_fn`` in the process group this
    rank was started in (``parallel/launch.start_ranks``; gloo runs several
    ranks on one card, where NCCL refuses to).  First one all-reduce of a
    CUDA tensor checks that the group's backend takes CUDA tensors.
    Returns numpy: that all-reduce's result, the end positions, the CG
    iterations a substep and the K2 and K3 launches."""
    import torch.distributed as dist

    from fem_tpu_torch.ops import blocked_kernels
    from fem_tpu_torch.parallel.sharding import (
        make_element_mesh,
        make_sharded_frame_fn,
    )

    dev = torch.device("cuda")
    probe = torch.full((4,), float(rank + 1), device=dev)
    dist.all_reduce(probe)
    cfg, obj, state, obstacles = flagship(dev)
    state = deformed(state)
    frame = make_sharded_frame_fn(obj, cfg, make_element_mesh(world, dev))
    blocked_kernels.blocked_prep.launches = 0
    blocked_kernels.blocked_graph_apply.launches = 0
    iters = []
    for _ in range(frames):
        state, aux = frame(state, obstacles)
        iters.append(aux.solver_iterations)
    return dict(probe=probe.cpu().numpy(), pos=state.pos.cpu().numpy(),
                iterations=torch.cat(iters).cpu().numpy(),
                k2=blocked_kernels.blocked_prep.launches,
                k3=blocked_kernels.blocked_graph_apply.launches,
                backend=dist.get_backend())
