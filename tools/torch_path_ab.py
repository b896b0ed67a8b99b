#!/usr/bin/env python3
# coding=utf-8
"""Times two of the port's paths through one checkout's ``fem_tpu_torch`` on
one GPU, so that two checkouts can be compared on the same card: path AK
(``configs/default.json`` with ``solver_backend="dense"`` and
``implicit_method: 0``, the dense Jacobi solve) and the grid cubes of
``chip_smoke.py``'s path AR (two 3D cubes, 5 subdivisions, side 0.2, the
upper one half a contact radius into the lower, through
``make_contact_frame_fn`` with ``contact_broadphase: "grid"``).

    python3 tools/torch_path_ab.py [--repo PATH] [--label NAME]

``--repo`` imports ``fem_tpu_torch`` from another checkout, for instance the
parent commit unpacked with ``git archive``; by default this one.  The
profiler helpers and the scenes' set-up (``squeezed_2d``, ``OVERRIDES_2D``,
``soup_of``) come from this checkout's ``chip_smoke.py``.  Each checkout
runs the paths as its own code routes them; nothing is patched.

* AK: ``FRAMES`` frames of 10 substeps from ``default.json``'s body
  squeezed into its circle (``squeezed_2d``, seed 7) under the profiler:
  device ms a frame, busy share, J1's device ms a launch and its launches
  by kernel name (``jacobi_levels_kernel``, ``jacobi_serial_kernel``).
* The grid cubes, after ``FRAMES`` coupled frames: device ms a substep of
  one coupled frame (the soup, the grid pass, the scatter and each body's
  substep) and of the bodies' substeps alone, one profiled window each;
  then, at the frame's vertex soup, the whole grid pass
  (``broadphase.grid_contact_forces``: cell ids, sort, lookup, C2) and
  C2's kernels alone (every kernel of ``csrc/contact_grid.cu``), device ms
  a call over ``REPS`` calls.

Prints one JSON line per path, each with the label, the checkout and the
card's name and power limit.  Run two checkouts in turns (A, B, B, A) in
one call to compare them.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 10
REPS = 20
J1_NAMES = ("jacobi_levels_kernel", "jacobi_serial_kernel")
C2_NAMES = ("contact_grid_kernel", "grid_soup_kernel", "grid_warp_kernel")


def smoke_helpers():
    """This checkout's ``chip_smoke.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def by_name(per_kernel, names):
    """{name: (device ms in total, launches)} of the kernels whose profiler
    name holds one of ``names``."""
    out = {}
    for name in names:
        hits = [v for k, v in per_kernel.items() if name in k]
        if hits:
            out[name] = (sum(t for t, _ in hits), sum(c for _, c in hits))
    return out


def path_ak(torch, cs, dev):
    from fem_tpu_torch import entry, sim

    cfg, obj, state, obs = entry.load_config(
        os.path.join(REPO, "configs", "default.json"), dev,
        sim_overrides=dict(cs.OVERRIDES_2D["implicit_jacobi"],
                           solver_backend="dense"))
    start = cs.squeezed_2d(torch, state, torch.Generator().manual_seed(7))
    frame = sim.make_frame_fn(obj, cfg)
    go = cs.frames_go(frame, start, obs, FRAMES)
    per_kernel, wall_ms = cs.profile_kernels(torch, go, 1)
    dev_ms = sum(t for t, _ in per_kernel.values())
    j1 = by_name(per_kernel, J1_NAMES)
    j1_ms = sum(t for t, _ in j1.values())
    j1_n = sum(c for _, c in j1.values())
    return dict(path="AK (default.json, dense Jacobi)", frames=FRAMES,
                device_ms_per_frame=dev_ms / FRAMES,
                busy_percent=100 * dev_ms / wall_ms,
                j1_ms_per_launch=j1_ms / j1_n if j1_n else None,
                j1_launches={k: c for k, (_, c) in j1.items()})


def grid_cubes(torch, cs, dev):
    import fem_tpu_torch
    from fem_tpu_torch import broadphase as bp
    from fem_tpu_torch import contact, sim
    from fem_tpu_torch.models import mesh as pmesh
    from fem_tpu_torch.models.state import Obstacles, build_object
    from fem_tpu_torch.utils.config import ObjectConfig, parse_config

    cfg = parse_config(dict(
        dim=3, delta_time=5e-4, sim_count=10, auto_diff=False,
        use_explicit_method=True, g_dir=[0.0, -1.0, 0.0],
        contact="penalty", contact_broadphase="grid", blocks=[]))
    cubes = []
    for center in ([0.4, 0.1, 0.4], [0.42, 0.3, 0.4]):
        ocfg = ObjectConfig(center=tuple(center), side_length=0.2,
                            subdivisions=5)
        cubes.append(build_object(
            ocfg, *pmesh.construct_3d_grid_mesh(ocfg), device=dev))
    upper = cubes[1][1]
    states = (cubes[0][1], upper.replace(pos=upper.pos - torch.tensor(
        [0.0, 0.5 * contact.auto_contact_radius([o for o, _ in cubes]), 0.0],
        device=dev)))
    frame = fem_tpu_torch.make_contact_frame_fn([o for o, _ in cubes], cfg)
    obs = Obstacles.from_configs((), 3, device=dev)
    for _ in range(FRAMES):
        states, _ = frame(states, obs)
    torch.cuda.synchronize()
    kw = sim.substep_kwargs(cfg)

    def with_contact():
        frame(states, obs)

    def without():
        ss = states
        for _ in range(cfg.sim_count):
            ss = tuple(sim.substep(o, st, obs, **kw)[0]
                       for (o, _), st in zip(cubes, ss))

    with_ms, with_busy = cs.window_ms(torch, with_contact, cfg.sim_count)
    without_ms, without_busy = cs.window_ms(torch, without, cfg.sim_count)
    plan = frame.plan
    pos, _ = cs.soup_of(torch, plan, states)
    radius, stiffness = frame.constants[:2]

    def grid_pass():
        return bp.grid_contact_forces(pos, plan.body_id, None, radius,
                                      stiffness, cap=plan.cap)

    per_kernel, _ = cs.profile_kernels(torch, grid_pass, REPS)
    pass_ms = sum(t for t, _ in per_kernel.values()) / REPS
    c2 = by_name(per_kernel, C2_NAMES)
    return dict(path="AR grid cubes", frames=FRAMES, vertices=pos.shape[0],
                substep_device_ms_with_contact=with_ms,
                substep_device_ms_without=without_ms,
                contact_device_ms_per_substep=with_ms - without_ms,
                busy_percent_with=with_busy,
                busy_percent_without=without_busy,
                grid_pass_ms=pass_ms,
                c2_ms=sum(t for t, _ in c2.values()) / REPS,
                c2_kernels={k: t / REPS for k, (t, _) in c2.items()})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--repo", default=REPO)
    p.add_argument("--label", default="this checkout")
    args = p.parse_args(argv)
    repo = os.path.abspath(args.repo)
    cs = smoke_helpers()
    sys.path.insert(0, repo)
    import torch

    if not torch.cuda.is_available():
        print("torch_path_ab: no CUDA device", file=sys.stderr)
        return 1
    import fem_tpu_torch

    if os.path.dirname(os.path.dirname(os.path.abspath(
            fem_tpu_torch.__file__))) != repo:
        print(f"torch_path_ab: fem_tpu_torch came from "
              f"{fem_tpu_torch.__file__}, not {repo}", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    for run in (path_ak, grid_cubes):
        row = run(torch, cs, dev)
        print(json.dumps(dict(label=args.label, repo=repo, card=card, **row)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
