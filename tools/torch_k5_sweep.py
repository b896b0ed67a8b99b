#!/usr/bin/env python3
# coding=utf-8
"""Where the whole-frame CUDA kernel (K5) spends its time, on one GPU.

    python3 tools/torch_k5_sweep.py [--repo PATH]

On the flagship (``configs/demo_spot.json``, deformed example state,
normal-equations CG as on path A) and on ``configs/default.json``'s
``implicit_cg`` variant (one block, squeezed state as on path I), times one
frame of ``fused_blocked_frame`` with ``tol = 0`` and ``max_iter`` = 0, 1,
2, 4, 8, so that each of the frame's substeps runs exactly ``max_iter`` CG
iterations, in each variant: the cluster variant (the automatic plan) and
the cooperative grid variant (one CTA per block).  A least-squares line
through (iterations, ms) splits the frame into a fixed part per substep
(prep, rhs, the first residual, advection, their barriers) and a part per
CG iteration; the barriers the kernel counted in each frame split the
same way, where the checkout's K5 counts them.  Then, on the flagship at
the default tolerance, the frame
at forced cluster sizes (CLUSTERS; 17 blocks over fewer CTAs take two or
more blocks each).  Times are CUDA events around 30 launches after a
warm-up.  Prints one JSON line per scene and variant and per cluster size,
and the card's name and power limit.

``--repo`` imports ``fem_tpu_torch`` from another checkout (for instance
the parent commit unpacked with ``git archive``); a checkout whose K5 has
no ``cluster`` option is timed in its only variant, the grid.
"""

import argparse
import dataclasses
import inspect
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = (0, 1, 2, 4, 8)
CLUSTERS = (6, 9, 12, 16)
REPS = 30


def frame_ms(torch, frame, fargs, kw):
    """Mean ms a frame over REPS launches after a warm-up (CUDA events)."""
    out = frame(*fargs, **kw)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        frame(*fargs, **kw)
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop) / REPS


def scenes(torch, dev):
    """(label, blocking, frame args, frame kwargs) of the two scenes."""
    from fem_tpu_torch import entry, scene
    from fem_tpu_torch.utils.config import read_config

    cfg, obj, state, obs = entry.flagship(dev)
    state = entry.deformed(state)
    kw = dict(dt=cfg.delta_time, damping=obj.damping, g_dir=tuple(cfg.g_dir),
              mu=obj.mu, s_lambda=obj.s_lambda, sim_count=cfg.sim_count,
              preconditioned=True)
    yield ("flagship (3D, 17 blocks)", obj.blocking,
           (obj.blocking, state.pos, state.vel, state.vel_g, obj.mass,
            obs.centers, obs.radii), kw)
    cfg = read_config(os.path.join(REPO, "configs", "default.json"))
    cfg = dataclasses.replace(cfg, auto_diff=False, use_explicit_method=False,
                              implicit_method=1, preconditioned=1)
    (body,), obs = scene.load_scene(cfg, device=dev)
    obj, st = body.obj, body.state
    c = st.pos.mean(dim=0, keepdim=True)
    pos = (c + (st.pos - c) * torch.tensor([[0.9, 1.1]], device=dev)
           - torch.tensor([[0.0, 0.2]], device=dev))
    vel = 0.3 * torch.randn(st.vel.shape,
                            generator=torch.Generator().manual_seed(1)).to(dev)
    kw = dict(dt=cfg.delta_time, damping=obj.damping, g_dir=tuple(cfg.g_dir),
              mu=obj.mu, s_lambda=obj.s_lambda, sim_count=cfg.sim_count,
              preconditioned=True)
    yield ("default.json implicit_cg (2D, 1 block)", obj.blocking,
           (obj.blocking, pos, vel, st.vel_g, obj.mass, obs.centers,
            obs.radii), kw)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", default=REPO,
                        help="checkout whose fem_tpu_torch is timed")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_k5_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.repo))
    from fem_tpu_torch.ops import frame_kernels as fk

    frame = fk.fused_blocked_frame
    has_cluster = "cluster" in inspect.signature(frame).parameters
    dev = torch.device("cuda")
    flagship = None
    for label, blk, fargs, kw in scenes(torch, dev):
        flagship = flagship or (label, fargs, kw)
        variants = ([("cluster", {}), ("grid", dict(grid=blk.num_blocks))]
                    if has_cluster else [("grid", {})])
        for variant, launch in variants:
            rows, barriers = [], []
            for n in ITERS:
                out, ms = frame_ms(torch, frame, fargs,
                                   dict(kw, max_iter=n, tol=0.0, **launch))
                its = out[3].tolist()
                if its != [n] * kw["sim_count"]:
                    raise RuntimeError(f"{label}: iterations {its}, not {n}")
                rows.append((n, ms))
                met = getattr(frame, "last_barriers", None)
                if met is not None:
                    barriers.append((n, int(met.item())))
            m = len(rows)
            mx = sum(i for i, _ in rows) / m
            my = sum(t for _, t in rows) / m
            slope = (sum((i - mx) * (t - my) for i, t in rows)
                     / sum((i - mx) ** 2 for i, _ in rows))
            plan = getattr(frame, "last_plan", None)
            s = kw["sim_count"]
            print(json.dumps({
                "scene": label, "variant": variant,
                "ctas": None if plan is None else plan.size,
                "checkout": os.path.abspath(args.repo),
                "points_iterations_ms": rows,
                "fixed_ms_per_substep": (my - slope * mx) / s,
                "per_iteration_ms": slope / s,
                "points_iterations_barriers": barriers or None,
            }), flush=True)
    label, fargs, kw = flagship
    for cluster in CLUSTERS if has_cluster else ():
        out, ms = frame_ms(torch, frame, fargs, dict(kw, cluster=cluster))
        plan = frame.last_plan
        print(json.dumps({
            "scene": label, "variant": "cluster", "ctas": plan.size,
            "threads": plan.threads, "iterations": sum(out[3].tolist()),
            "ms_per_frame": ms}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
