# coding=utf-8
"""The port's command-line entry point.

    python -m fem_tpu_torch.main --config configs/demo_spot.json --frames 30 --no-render
    python -m fem_tpu_torch.main --device cpu --config configs/default.json --seconds 0.25

The counterpart of the repository's root ``main.py`` (the JAX package's
CLI), flag for flag, plus ``--device`` (``cuda`` by default; ``cpu`` runs
every kernel's plain version).  It advances the scene, captures frames at
the config's fps, exports per-frame OBJs (3D) and VTU snapshots at the same
cadence, writes and resumes checkpoints, and builds the gif and mp4 at the
end.  Its exit code is 3 when the config does not parse and when a
checkpoint's body count differs from the config's, as the reference's.

Nothing is read back from the device in a frame that neither renders,
exports, checkpoints, guards (``--debug``) nor prints: the solver metrics
are read at the print cadence only, so a whole-frame path stays one
launch a frame.  Rendering imports matplotlib when it draws (``--no-render``
needs none).  ``contact="penalty"`` with more than one body, or with
``self_contact``, steps every body jointly through
``contact.make_contact_frame_fn``.

``--sharded`` shards every body's elements over the ranks of
``torch.distributed`` (``parallel/sharding.py``), as the root ``main.py``
does over its devices: one rank when started alone, one rank a GPU under
``torchrun --nproc-per-node <GPUs> -m fem_tpu_torch.main --sharded ...``.
Every rank steps the same state and only rank 0 writes (frames, exports,
checkpoints, prints).  With a contact scene it exits with code 3, as the
root ``main.py`` does.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def run(argv=None) -> int:
    parser = argparse.ArgumentParser(description="FEM on a GPU (PyTorch/CUDA)")
    parser.add_argument(
        "--config", type=str, default="configs/default.json",
        help="Please input a config json file.",
    )
    parser.add_argument("--seconds", type=float, default=3.0,
                        help="virtual seconds to simulate")
    parser.add_argument("--frames", type=int, default=None,
                        help="explicit frame count (overrides --seconds)")
    parser.add_argument("--output", type=str, default="./output")
    parser.add_argument("--no-render", action="store_true")
    parser.add_argument("--checkpoint-every", type=int, default=0,
                        help="save a checkpoint every N frames (0 = off)")
    parser.add_argument("--resume", type=str, default=None,
                        help="checkpoint .npz to resume from")
    parser.add_argument("--interior-spacing", type=float, default=None,
                        help="Steiner-point spacing for the native tet mesher")
    parser.add_argument("--print-every", type=int, default=60)
    parser.add_argument("--debug", action="store_true",
                        help="NaN-guarded stepping + physics metrics per print")
    parser.add_argument("--trace", type=str, default=None,
                        help="write a torch.profiler Chrome trace into this "
                             "directory")
    parser.add_argument("--wireframe", action="store_true",
                        help="3D: edges only instead of the lit surface")
    parser.add_argument("--camera", type=str, default=None,
                        help="3D camera as 'elev,azim' degrees")
    parser.add_argument("--color", choices=("energy", "stress"),
                        default="energy",
                        help="2D triangle tint: 'energy' (V*phi, the "
                             "reference's) or 'stress' (von Mises over the "
                             "scene max)")
    parser.add_argument("--export-vtu", action="store_true",
                        help="also write VTK .vtu snapshots (+ a .pvd index) "
                             "at the OBJ export cadence (any dim)")
    parser.add_argument("--sharded", action="store_true",
                        help="shard every body's elements over the ranks of "
                             "torch.distributed (torchrun: one a GPU)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    from fem_tpu_torch.contact import contact_scene, make_contact_frame_fn
    from fem_tpu_torch.scene import load_scene, method_banner
    from fem_tpu_torch.sim import element_phi, element_von_mises, make_frame_fn
    from fem_tpu_torch.utils import io as fio
    from fem_tpu_torch.utils.config import read_config
    from fem_tpu_torch.utils.device import resolve_device
    from fem_tpu_torch.utils.io import to_numpy

    try:
        cfg = read_config(args.config)
    except Exception as e:  # the reference exits with code 3 (utils.py:29-32)
        print(e)
        print("Parsing config file error")
        return 3
    device = resolve_device(args.device)
    writer = True
    if args.sharded:  # before any tensor: under torchrun a rank's GPU
        import torch.distributed as dist

        from fem_tpu_torch.parallel import sharding

        sharding.init_ranks(device)
        writer = dist.get_rank() == 0
        if not writer:
            args.no_render, args.export_vtu = True, False
            args.checkpoint_every = args.print_every = 0
            args.trace = None

    scene, obstacles = load_scene(cfg, args.interior_spacing, device=device)
    if writer:
        print(method_banner(cfg))
    contact_frame, frame_fns = None, []
    if contact_scene(cfg, len(scene)):
        if args.sharded:
            print("contact='penalty' is not supported with --sharded")
            return 3
        contact_frame = make_contact_frame_fn([s.obj for s in scene], cfg)
    elif args.sharded:
        mesh = sharding.make_element_mesh(device=device)
        if writer:
            print(f"sharded over {mesh.size()} ranks")
        frame_fns = [sharding.make_sharded_frame_fn(s.obj, cfg, mesh)
                     for s in scene]
    else:
        frame_fns = [make_frame_fn(s.obj, cfg) for s in scene]

    frame_time = cfg.frame_time
    n_frames = args.frames
    if n_frames is None:
        n_frames = int(args.seconds / (cfg.sim_count * cfg.delta_time))

    virtual_time = 0.0
    start_frame = 0
    ply_cnt = 0
    vtu_entries = {}
    if args.resume:
        states, start_frame, virtual_time, ply_cnt = fio.load_scene_checkpoint(
            args.resume, device)
        if len(states) != len(scene):
            print(
                f"Checkpoint has {len(states)} bodies but config has "
                f"{len(scene)}"
            )
            return 3
        for s, state in zip(scene, states):
            s.state = state
        print(f"Resumed from {args.resume} at frame {start_frame}")

    renderer = None
    if not args.no_render:
        from fem_tpu_torch.render.raster import HeadlessRenderer

        camera = None
        if args.camera:
            elev, azim = (float(x) for x in args.camera.split(","))
            camera = (elev, azim)
        renderer = HeadlessRenderer(
            cfg.dim, args.output, cfg.output_fps, cfg.is_output_gif,
            camera=camera,
            style="wireframe" if args.wireframe else "shaded",
        )
        centers = to_numpy(obstacles.centers)
        radii = to_numpy(obstacles.radii)
    if writer:
        os.makedirs(args.output, exist_ok=True)

    t0 = time.perf_counter()
    trace_ctx = None
    if args.trace:
        from fem_tpu_torch.utils.profiling import trace as profiler_trace

        trace_ctx = profiler_trace(args.trace)
        trace_ctx.__enter__()

    for frame in range(start_frame, n_frames):
        per_body_aux = []
        if contact_frame is not None:
            states, auxes = contact_frame(tuple(s.state for s in scene),
                                          obstacles)
            for s, state, aux in zip(scene, states, auxes):
                s.state = state
                per_body_aux.append(aux)
            # The coupled frame keeps the reference's N×-per-body pacing
            # (PARITY.md), as the JAX package's CLI does (main.py:179-181).
            virtual_time += len(scene) * cfg.sim_count * cfg.delta_time
        else:
            for s, frame_fn in zip(scene, frame_fns):
                s.state, aux = frame_fn(s.state, obstacles)
                per_body_aux.append(aux)
                # The reference's quirk, kept: virtual_time advances inside
                # the per-object loop (its main.py:113), so an N-body scene
                # paces capture and export N× faster (PARITY.md).
                virtual_time += cfg.sim_count * cfg.delta_time

        if writer and (
            (cfg.is_output_obj or args.export_vtu)
            and (virtual_time / frame_time) > ply_cnt
            and (cfg.dim == 3 or args.export_vtu)
        ):  # the reference's main.py:117-122
            if cfg.is_output_obj and cfg.dim == 3:
                for s in scene:
                    if "map_index" in s.aux:
                        fio.export_deformed_obj(
                            os.path.join(args.output, f"obj_{ply_cnt:06}.obj"),
                            s.state.pos, s.aux["obj_vertices"],
                            s.aux["obj_faces"], s.aux["map_index"],
                        )
            if args.export_vtu:
                from fem_tpu_torch.utils.vtu import write_vtu

                for i, s in enumerate(scene):
                    vtu_path = os.path.join(
                        args.output, f"sim_b{i}_{ply_cnt:06}.vtu")
                    write_vtu(
                        vtu_path,
                        to_numpy(s.state.pos),
                        to_numpy(s.obj.element_indices),
                        point_data={"velocity": to_numpy(s.state.vel)},
                        cell_data={"von_mises": to_numpy(
                            element_von_mises(s.obj, s.state))},
                    )
                    vtu_entries.setdefault(i, []).append(
                        (virtual_time, vtu_path))
            ply_cnt += 1

        if renderer is not None:
            msgs = []
            if not cfg.is_output_gif:  # overlay, the reference's main.py:124-127
                msgs = [f"frame_cnt: {frame + 1}", f"time: {virtual_time:.4f}"]
            all_pos = [to_numpy(s.state.pos) for s in scene]
            all_faces = [to_numpy(s.obj.faces) for s in scene]
            all_phi = None
            if cfg.dim == 2:
                if args.color == "stress":
                    vm = [to_numpy(element_von_mises(s.obj, s.state))
                          for s in scene]
                    peak = max(float(v.max()) for v in vm) or 1.0
                    all_phi = [v / peak for v in vm]
                else:
                    all_phi = [to_numpy(element_phi(s.obj, s.state))
                               for s in scene]
            renderer.maybe_capture(
                virtual_time, all_pos, all_faces, all_phi, centers, radii,
                msgs,
            )

        if args.checkpoint_every and (frame + 1) % args.checkpoint_every == 0:
            fio.save_scene_checkpoint(
                os.path.join(args.output, f"ckpt_{frame + 1:06}.npz"),
                [s.state for s in scene], frame + 1, virtual_time, ply_cnt,
            )

        if args.debug:
            from fem_tpu_torch.utils.profiling import check_state

            check_state(scene[0].obj, scene[0].state,
                        (frame + 1) * cfg.sim_count)

        if args.print_every and (frame + 1) % args.print_every == 0:
            body_iters = [int(a.solver_iterations.sum())
                          for a in per_body_aux]
            elapsed = time.perf_counter() - t0
            steps = (frame + 1 - start_frame) * cfg.sim_count
            msg = (
                f"frame {frame + 1}/{n_frames}  t={virtual_time:.3f}s  "
                f"{steps / elapsed:.1f} steps/s"
            )
            if any(body_iters):
                if len(body_iters) == 1:
                    msg += (
                        "  solver iters/substep: "
                        f"{body_iters[0] / cfg.sim_count:.1f}"
                    )
                else:
                    per = ", ".join(
                        f"obj{i}={it / cfg.sim_count:.1f}"
                        for i, it in enumerate(body_iters)
                    )
                    msg += f"  solver iters/substep: {per}"
            if args.debug:
                from fem_tpu_torch.utils.profiling import frame_metrics

                m = frame_metrics(scene[0].obj, scene[0].state)
                msg += (
                    f"  U={m.elastic_energy:.4g} KE={m.kinetic_energy:.4g}"
                    f" min|F|={m.min_det_f:.3f}"
                )
            print(msg)

    if args.export_vtu and vtu_entries:
        from fem_tpu_torch.utils.vtu import write_pvd

        for i, entries in vtu_entries.items():
            write_pvd(os.path.join(args.output, f"sim_b{i}.pvd"), entries)
        print(f"VTU series written ({sum(map(len, vtu_entries.values()))} "
              "snapshots).")

    if trace_ctx is not None:
        trace_ctx.__exit__(None, None, None)
        print(f"Profiler trace written to {args.trace}")

    if renderer is not None and cfg.is_output_gif:
        written = renderer.make_video(gif=True, mp4=True)
        if written:
            print("Make video success.")  # the reference's main.py:133
            for w in written:
                print(" ", w)
    return 0


if __name__ == "__main__":
    sys.exit(run())
