#!/usr/bin/env python3
# coding=utf-8
"""Times P2, K11b, K5's frame, K4 and K11a of one checkout on one GPU, and
hashes K4's and K11a's outputs, so that two checkouts can be compared on
the same card.

    python3 tools/torch_kernel_ab.py [--repo PATH] [--label NAME]

``--repo`` imports ``fem_tpu_torch`` (and its ``chip_smoke.py``'s profiler
helpers) from another checkout, for instance the parent commit unpacked
with ``git archive``; by default this one.  On the flagship
(``configs/demo_spot.json``, deformed state) and ``configs/default.json``'s
``implicit_cg`` variant (squeezed state), both with normal equations:
K11b's frame (``fused_frame``, the checkout's own plan) and K5's frame
(``fused_blocked_frame``), K4's solve (``fused_cg_solve``) and K11a's
(``cg_solve_edge``) at the scene's K and b, and P2's three variants at the
probe's defaults (rows 6, n 1,024, cols 2,048, 200 reps).  Device ms a
launch from the profiler (``chip_smoke.kernel_ms``, 20 launches a
window); K4's and K11a's outputs (velocity and iterations) as a sha256 of
their bytes.  Prints one JSON line per measurement, each with the label,
and the card's name and power limit.  Run two checkouts in turns (A, B, B,
A) in one call to compare them.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--repo", default=REPO)
    p.add_argument("--label", default="this checkout")
    args = p.parse_args(argv)
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from fem_tpu_torch import entry
    from fem_tpu_torch.experiments import edge_cg, fused_frame as ff
    from fem_tpu_torch.ops import cg_kernels, element_kernels as ek
    from fem_tpu_torch.ops import frame_kernels as fk
    from fem_tpu_torch.probes import int8 as p2
    from fem_tpu_torch.solvers.implicit import build_edge_matrix

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")

    def emit(**row):
        print(json.dumps(dict(label=args.label, repo=repo, card=card, **row)),
              flush=True)

    def digest(*tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
        return h.hexdigest()[:16]

    cfg, obj, s0, obs = entry.flagship(dev)
    dcfg, dobj, ds0, dobs = entry.load_config(
        os.path.join(REPO, "configs", "default.json"), dev,
        sim_overrides=cs.OVERRIDES_2D["implicit_cg"])
    scenes = (("flagship", cfg, obj, entry.deformed(s0), obs),
              ("default.json", dcfg, dobj,
               cs.squeezed_2d(torch, ds0, torch.Generator().manual_seed(7)),
               dobs))
    for label, c, o, s, ob in scenes:
        kw = dict(dt=c.delta_time, damping=o.damping, g_dir=tuple(c.g_dir),
                  mu=o.mu, s_lambda=o.s_lambda, preconditioned=True,
                  sim_count=c.sim_count)
        fargs = (s.pos, s.vel, s.vel_g, o.ref_inv, o.volume,
                 o.element_indices, o.plan, o.mass, ob.centers, ob.radii)
        out = ff.fused_frame(*fargs, **kw)
        ms = cs.kernel_ms(torch, lambda: ff.fused_frame(*fargs, **kw), 20,
                          ["fused_frame_kernel"])
        emit(kernel="K11b", scene=label, ms=ms,
             iterations=int(out[3].sum()),
             plan=str(getattr(ff.fused_frame, "last_plan", None)))
        blk = o.blocking
        bargs = (blk, s.pos, s.vel, s.vel_g, o.mass, ob.centers, ob.radii)
        fk.fused_blocked_frame(*bargs, **kw)
        ms = cs.kernel_ms(torch, lambda: fk.fused_blocked_frame(*bargs, **kw),
                          20, [cs.k5_kernel_name()])
        emit(kernel="K5", scene=label, ms=ms)
        K, H = ek.hessian_and_force(s.pos, o.element_indices, o.ref_inv,
                                    o.volume, o.mu, o.s_lambda)
        solve = (K, H, o.element_indices, o.plan, s.vel, o.mass,
                 c.delta_time, True)
        v, it, _ = cg_kernels.fused_cg_solve(*solve)
        ms = cs.kernel_ms(torch, lambda: cg_kernels.fused_cg_solve(*solve),
                          20, ["fused_cg_kernel"])
        emit(kernel="K4", scene=label, ms=ms, iterations=int(it),
             sha256=digest(v, it))
        s_mat = torch.as_tensor(build_edge_matrix(
            o.element_indices.cpu().numpy(), o.particle_cnt), device=dev)
        b = cs.rhs_of(torch, o, s, H, c.delta_time)
        ekw = dict(dim=o.dim, dt2=c.delta_time ** 2, preconditioned=True)
        x, it = edge_cg.cg_solve_edge(s_mat, K, b, o.mass, **ekw)
        ms = cs.kernel_ms(torch, lambda: edge_cg.cg_solve_edge(
            s_mat, K, b, o.mass, **ekw), 20, ["edge_cg_kernel"])
        emit(kernel="K11a", scene=label, ms=ms, iterations=int(it),
             sha256=digest(x, it))
    for name in p2.VARIANTS:
        a, w = p2.probe_inputs(6, 1024, 2048, name, dev)
        ms = cs.kernel_ms(torch, lambda: p2.chained_dot(a, w, 200, name), 20,
                          ["chained_dot_kernel"])
        emit(kernel="P2", variant=name, ms=ms,
             plan=str(getattr(p2.chained_dot, "last_plan", None)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
