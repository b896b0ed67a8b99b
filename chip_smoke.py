#!/usr/bin/env python3
# coding=utf-8
"""Chip smoke run of the PyTorch/CUDA port (fem_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port on the flagship ``configs/demo_spot.json`` (1,007
particles, 4,068 tets, 17 locality blocks, ``sim_count = 10``) through its
paths — the implicit CG in normal-equations mode (A-C) and the explicit
and autodiff method at ``delta_time = 1e-4`` (D-G) — and holds every CUDA
kernel of those paths against its plain PyTorch version:

1. environment: torch, CUDA, nvcc, the card's name and power limit;
2. build: every kernel from ``fem_tpu_torch/csrc/`` with nvcc for sm_90a,
   all sources compiled in parallel;
3. K1, the element chain, against ``hessian_and_force_plain`` on the
   flagship's deformed state (block-relative error ≤ 1e-5);
4. K4, the whole CG solve, against ``fused_cg_solve_plain`` with
   ``preconditioned`` 0 and 1 (velocity rtol 5e-4 / atol 1e-6, iterations
   within 1), and twice on the same inputs, bit-identical;
5. K2, the blocked prep, and K3, the blocked operator (both transposes),
   against their plain versions (K block-relative ≤ 1e-5, partials and
   G(K)·x within 1e-5 of their largest entry), each twice bit-identical;
6. K5, the whole frame, against ``fused_blocked_frame_plain`` on the card,
   ``preconditioned`` 0 and 1, with and without velocity noise: positions
   within 1e-5, iterations within 1 per substep, two runs bit-identical;
7. K6, the gradient columns (block-relative ≤ 1e-5), K7b, the blocked
   prep's explicit mode, and K7a, the blocked assembly (each within 1e-5
   of its largest entry), against their plain versions on the deformed
   state, each twice bit-identical;
8. K8, the explicit whole frame, against ``fused_explicit_frame_plain`` on
   the card from the deformed state and from path D's start state, with
   and without velocity noise: positions within 1e-5, two runs
   bit-identical;
9. path A, the flagship frame (``sim.make_frame_fn``): 30 frames from the
   deformed state; K5 launches once a frame and no other kernel; positions
   finite; the first frame equals the CPU plain frame to 1e-5 with equal
   iterations; steps/s;
10. path B, the blocked operator (``operator_mode="blocked"``): a few
    frames; K2 launches frames × 10 times and K3 Σ(3 + 2·iterations)
    times; the first frame equals the CPU frame to 1e-5; steps/s;
11. path C, the substep entry (``fem_tpu_torch.entry.entry``): 10
    substeps; K1 and K4 launch once a substep; the first substep equals the
    CPU plain substep to 1e-5; steps/s (one substep a call);
12. path D, the explicit flagship frame (``sim.make_frame_fn`` on
    ``entry.explicit_flagship``: the body 0.01 above the floor, falling at
    1 m/s): 30 frames; K8 launches once a frame and no other kernel;
    positions finite and at the floor; the first frame equals the CPU
    plain frame to 1e-5; steps/s; then one ``auto_diff`` frame, K8 once;
13. paths E, F and G, the explicit substep (``sim.substep``) from the
    deformed state: K7b once a substep (E, ``element_backend="auto"``),
    K7a once a substep (F, ``auto_diff`` and ``"xla"``), K6 once a call of
    ``analytic_energy_gradient`` on the unblocked body (G); each first
    substep or gradient equals the CPU's to 1e-5;
14. the shipped explicit configs ``demo_3d.json`` and
    ``demo_cube_autodiff.json``: a few frames each through
    ``make_frame_fn`` (K8 once a frame), equal to the CPU frames to 1e-5;
15. 2D, on the reference's headline ``configs/default.json`` (121
    particles, 200 triangles, one locality block, ``auto_diff``,
    ``sim_count = 10``): K1-K8's triangle instances against their plain
    versions on a state moved into the right circle and squashed, with
    random velocities (the tolerances of 3-8), each twice bit-identical;
    K5 and K8 also over the 16 blocks of the same scene at 40 subdivisions;
16. path H, ``default.json`` as shipped through ``sim.make_frame_fn``
    (``scene.load_scene``): K8 once a frame over 30 frames, the first frame
    equal to the CPU plain frame to 1e-5; the same with ``auto_diff`` off;
    then 200 frames of the golden scene of tests/test_golden.py (6
    subdivisions) per explicit method through K8, held to its golden values;
17. path I, ``default.json`` with the ``implicit_cg`` overrides: K5 once a
    frame over 30 frames, the first frame equal to the CPU's; the golden
    arc of ``implicit_cg`` through K5;
18. path J, the op-composed 2D substeps (``sim.substep``) from the squashed
    state with paths C's, B's, E's, F's and G's settings: K1 + K4, K2 + K3,
    K7b, K7a (``auto_diff`` and ``"xla"``) and K6, each first substep equal
    to the CPU's to 1e-5;
19. path K, ``configs/demo_two_bodies.json`` through ``scene.load_scene``
    and one ``make_frame_fn`` per body: K8 twice a frame over 30 frames,
    each body's first frame equal to the CPU's;
20. path L, ``default.json``'s scene at 40 subdivisions (1,681 particles,
    3,200 triangles, 16 blocks): 10 frames explicit at dt 1e-4 (K8) and 10
    implicit at dt 5e-4 (K5) from the start state, first frames equal to
    the CPU's;
21. where each frame's device time goes and the device's busy share, from
    one profiled window per path (A, the op-composed K1 + K4 frame, D, H,
    I, K and both of L); each kernel's device time per launch in 3D and in
    2D (profiler; the run fails if it sees no launch of it), its plain
    version's time (CUDA events), the least time the card could take
    (bound) and, for K3 and K7a, one PyTorch sparse product (library
    yardstick), printed as one ``kernels`` JSON line with a row per kernel
    and dimension.

The last line of standard output is ``{"ok": true, "device": {...}}``.  Any
failure ends the run with a non-zero exit and no result line; without a
CUDA device, or without the repository beside it, it exits non-zero at once.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FRAMES = 30  # path A, and each profiled window
FRAMES_B = 3  # path B: its CG loop reads |r|^2 on the host every iteration
SUBSTEPS_C = 10  # path C, and path G's gradients
SHIPPED_FRAMES = 3  # each shipped explicit config
GOLDEN_FRAMES = 200  # each 2D golden arc: one virtual second
FRAMES_L = 10  # path L, each mode

# NVIDIA H100 SXM data sheet (dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# f32 operations, by dimension, counted from the formulas in
# element_chain.cuh and blocked_common.cuh: per element, the implicit chain
# (F, det, F⁻¹, the K and rhs products, logs, scaling), one G(K)·x apply
# (edge differences, the d×d products, the vertex-0 sum, the gathered
# rows), the explicit gradient chain (edge differences, F, det, F⁻¹, the
# log, P, P·R⁻ᵀ, the +V scaling) and its contribution rows and local slot
# sums; per particle, the explicit kinematic step and the implicit
# advection (one circle).
OPS = {
    3: dict(chain=430, apply=72, grad=200, rows=24, kinematic=40, advect=40),
    2: dict(chain=136, apply=24, grad=60, rows=8, kinematic=27, advect=27),
}

# tests/test_golden.py:19-57: the 2D golden trajectories (recorded by the
# JAX package on the CPU; mean and std within 5e-3, particles 0, 24 and 48
# within 1e-2 after 200 frames) and each method's overrides of
# configs/default.json.  Copied: that file imports the JAX package.
GOLDEN_2D = {
    "explicit_analytic": dict(
        mean=0.52577740, std=0.07123064, p0=(0.5946439, 0.4561227),
        p24=(0.4982445, 0.5551394), p48=(0.3927549, 0.6483386)),
    "autodiff": dict(
        mean=0.52570546, std=0.07118951, p0=(0.5946961, 0.4559107),
        p24=(0.4983058, 0.5549618), p48=(0.3928466, 0.6482556)),
    "implicit_cg": dict(
        mean=0.55748934, std=0.09069931, p0=(0.4851717, 0.4765905),
        p24=(0.4952799, 0.6177244), p48=(0.5053155, 0.7599441)),
}
OVERRIDES_2D = {
    "explicit_analytic": dict(auto_diff=False, use_explicit_method=True),
    "autodiff": dict(auto_diff=True, use_explicit_method=True),
    "implicit_cg": dict(auto_diff=False, use_explicit_method=False,
                        implicit_method=1, preconditioned=1),
}

# (counter name, CUDA source, TPU kernel it replaces), in the order of the
# kernels line.
KERNELS = (
    ("element_chain", "fem_tpu_torch/csrc/element_chain.cu",
     "fem_tpu/ops/pallas_kernels.py:555"),
    ("fused_cg", "fem_tpu_torch/csrc/fused_cg.cu",
     "fem_tpu/ops/pallas_blocked_cg.py:348"),
    ("blocked_prep", "fem_tpu_torch/csrc/blocked.cu",
     "fem_tpu/ops/blocking.py:513"),
    ("blocked_matvec", "fem_tpu_torch/csrc/blocked.cu",
     "fem_tpu/ops/blocking.py:429"),
    ("blocked_frame", "fem_tpu_torch/csrc/blocked_frame.cu",
     "fem_tpu/ops/pallas_blocked_frame.py:547"),
    ("grad_columns", "fem_tpu_torch/csrc/element_chain.cu",
     "fem_tpu/ops/pallas_kernels.py:677"),
    ("blocked_assemble", "fem_tpu_torch/csrc/blocked.cu",
     "fem_tpu/ops/blocking.py:450"),
    ("blocked_grad_prep", "fem_tpu_torch/csrc/blocked.cu",
     "fem_tpu/ops/blocking.py:513"),
    ("explicit_frame", "fem_tpu_torch/csrc/explicit_frame.cu",
     "fem_tpu/ops/pallas_blocked_frame.py:936"),
)


def require(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def log(msg=""):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def block_rel_err(got, ref):
    """max |got − ref| / max|ref_e|, over the d×d blocks e (padded blocks,
    zero in both, count 0)."""
    scale = ref.abs().reshape(ref.shape[0], -1).amax(dim=1).clamp(min=1e-30)
    return float(((got - ref).abs() / scale[:, None, None]).max())


def cuda_ms(torch, fn, reps):
    """Mean milliseconds per call over ``reps`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def profile_kernels(torch, fn, reps):
    """({kernel name: (device ms in total, launches)}, wall ms) over ``reps``
    calls of ``fn`` under torch.profiler (CUPTI, device activity only, so
    that host-side tracing slows the enqueue as little as it can), after one
    warm-up call; the wall time is that of the same profiled window."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = {}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        total = getattr(e, "self_device_time_total", None)
        if total is None:
            total = e.self_cuda_time_total
        if total > 0:
            out[e.key] = (total / 1e3, e.count)
    return out, wall_ms


def kernel_ms(torch, fn, reps, names):
    """Device milliseconds per call of ``fn``, each of which launches every
    kernel of ``names`` once: the sum over ``names`` of the kernel's mean
    time per launch, from the profiler over ``reps`` calls.  Raises if the
    profiler saw no launch of one of them.  (CUPTI may miss a launch at the
    window's edge, so each mean is over those seen.)"""
    per_kernel, _ = profile_kernels(torch, fn, reps)
    total = 0.0
    for name in names:
        hits = [v for k, v in per_kernel.items() if name in k]
        launches = sum(c for _, c in hits)
        require(0 < launches <= reps,
                f"the profiler saw {launches} launches of {name} in {reps} "
                "calls")
        total += sum(t for t, _ in hits) / launches
    return total


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def cg_ops(e, n, iterations, normal, d):
    """f32 operations of one whole-solve call with ``iterations`` CG
    iterations: OPS[d]["apply"] per element per G apply plus the
    per-unknown vector work."""
    g_apply = OPS[d]["apply"] * e
    apply_a = g_apply + 3 * d * n
    apply_at = g_apply + 4 * d * n
    op = apply_a + apply_at if normal else apply_a
    setup = (d + 1) * d * e + 3 * d * n + (apply_at if normal else 0) + op \
        + 3 * d * n
    return setup + iterations * (op + 10 * d * n)


def frame_ops(e, n, slot_rows, iterations, normal, d):
    """f32 operations of one whole frame whose substeps took
    ``iterations``: per substep the chain and force rows, the rhs, the
    applies of its CG (each a G(K)·x, its slot sums and its vector work), the
    CG's vector work and the advection."""
    ops = OPS[d]
    apply = ops["apply"] * e + d * slot_rows + 4 * d * n
    total = 0
    for it in iterations:
        applies = 3 + 2 * it if normal else 1 + it
        total += ((ops["chain"] + (d + 1) * d) * e + d * slot_rows
                  + 4 * d * n + applies * apply + it * 10 * d * n
                  + ops["advect"] * n)
    return total


def explicit_frame_ops(e, n, slot_rows, sim_count, d):
    """f32 operations of one explicit frame: per substep the gradient chain
    and rows of every element, the slot sums and the kinematic step."""
    ops = OPS[d]
    return sim_count * ((ops["grad"] + ops["rows"]) * e + d * slot_rows
                        + ops["kinematic"] * n)


def incidence_matrix(torch, blk, n):
    """The (N × d·B·Eb) ±1 incidence matrix of the blocked assembly as CSR:
    column d·s + j (column j of element slot s) carries +1 to the slot's
    vertex j+1 and −1 to its vertex 0; padded slots have no entries."""
    import warnings

    warnings.filterwarnings("ignore", "Sparse CSR tensor support is in beta")
    d = blk.dim
    real = blk.volume > 0
    slots = torch.nonzero(real).reshape(-1)
    idx = blk.element_indices[slots].long()
    cols = (d * slots[:, None] + torch.arange(d, device=slots.device)).reshape(-1)
    rows = torch.cat([idx[:, 1:].reshape(-1), idx[:, :1].expand(-1, d).reshape(-1)])
    vals = torch.cat([torch.ones(cols.numel(), device=slots.device),
                      -torch.ones(cols.numel(), device=slots.device)])
    coo = torch.sparse_coo_tensor(
        torch.stack([rows, torch.cat([cols, cols])]), vals,
        (n, d * blk.volume.numel()),
    ).coalesce()
    return coo.to_sparse_csr()


def bound(nbytes_, ops):
    """(bound ms, what bounds it) from bytes moved and f32 operations."""
    t_bytes = nbytes_ / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def graph_matrix(torch, element_indices, K, n):
    """G(K) as a (dN × dN) CSR matrix: per element, +K_e on (v_j, v_j) and
    −K_e on (v_j, v_0) and (v_0, v_j) for j = 1..d, +d·K_e on (v_0, v_0)
    (the element-Laplacian pattern of the port's operator)."""
    import warnings

    warnings.filterwarnings("ignore", "Sparse CSR tensor support is in beta")
    torch.sparse.check_sparse_tensor_invariants.disable()
    d = K.shape[-1]
    idx = element_indices.long()
    v0 = idx[:, 0]
    rows, cols, vals = [], [], []
    others = range(1, d + 1)
    blocks = [(idx[:, j], idx[:, j], K) for j in others]
    blocks += [(idx[:, j], v0, -K) for j in others]
    blocks += [(v0, idx[:, j], -K) for j in others]
    blocks.append((v0, v0, float(d) * K))
    ar = torch.arange(d, device=K.device)
    for a, b, k in blocks:
        rows.append((d * a[:, None, None] + ar[None, :, None]).expand(-1, d, d))
        cols.append((d * b[:, None, None] + ar[None, None, :]).expand(-1, d, d))
        vals.append(k)
    coo = torch.sparse_coo_tensor(
        torch.stack([torch.cat(rows).reshape(-1), torch.cat(cols).reshape(-1)]),
        torch.cat(vals).reshape(-1), (d * n, d * n),
    ).coalesce()
    return coo.to_sparse_csr()


def profile_window(torch, label, go, frames):
    """Device ms a frame of ``go`` (``frames`` frames) under the profiler,
    logged with the wall time and busy share of the same window and the
    kernels that take the most time."""
    per_window, prof_wall = profile_kernels(torch, go, 1)
    dev_ms = sum(t for t, _ in per_window.values()) / frames
    log(f"[profile] {label}: {frames} frames under the profiler: device "
        f"time {dev_ms:.4f} ms/frame of {prof_wall / frames:.4f} ms/frame "
        f"wall in the same window: device busy "
        f"{100 * dev_ms * frames / prof_wall:.1f}%")
    top = sorted(per_window.items(), key=lambda kv: -kv[1][0])[:6]
    for key, (total, count) in top:
        log(f"[profile]   {total / frames:9.4f} ms/frame  "
            f"{count / frames:6.1f} launches/frame  {key[:80]}")
    return dev_ms


def time_kernels(torch, d, obj, state, x, obstacles, frame_kw, ekw):
    """Each kernel's device ms a launch at these inputs (profiler), its
    plain version's ms (CUDA events), the least time the card could take
    for the same work (bound) and, for K3 and K7a, one PyTorch sparse
    product's ms (library yardstick, first checked against the kernel):
    {counter name: dict of the kernels line's time keys}.  ``x`` is K3's
    vector, ``frame_kw`` K5's frame arguments, ``ekw`` K8's."""
    from fem_tpu_torch.ops import (
        blocked_kernels as bk,
        cg_kernels as cg,
        element_kernels as ek,
        frame_kernels as fk,
    )

    ops = OPS[d]
    blk = obj.blocking
    n, e = obj.particle_cnt, obj.element_cnt
    tables = (blk.block_particles, blk.plus, blk.minus, blk.block_elements,
              blk.local_ptr, blk.local_rows)
    plan = (blk.slot_plan.ptr, blk.slot_plan.rows)
    slot_rows = blk.slot_plan.rows.numel()
    out = {}

    def put(name, kernel, plain, plain_reps, reps, names, moved, work,
            library=None, **extra):
        bnd, by = bound(moved, work)
        out[name] = dict(
            ms=kernel_ms(torch, kernel, reps, names),
            plain_ms=cuda_ms(torch, plain, plain_reps), bound_ms=bnd,
            bound_by=by, library_ms=library, **extra)

    def library_ms(what, lib_fn, got):
        err = float((lib_fn() - got).abs().max())
        top = float(got.abs().max())
        log(f"[{what}] torch.sparse.mm vs the kernel ({d}D): max abs "
            f"difference {err:.3e} of max {top:.3e}")
        require(err <= 1e-4 * top, f"library {what} differs ({d}D)")
        return cuda_ms(torch, lib_fn, 200)

    k1_args = (state.pos, obj.element_indices, obj.ref_inv, obj.volume,
               obj.mu, obj.s_lambda)
    K, H = ek.hessian_and_force(*k1_args)
    put("element_chain", lambda: ek.hessian_and_force(*k1_args),
        lambda: ek.hessian_and_force_plain(*k1_args), 20, 200,
        ["hessian_and_force_kernel"], nbytes(*k1_args[:4], K, H),
        ops["chain"] * e)

    solve = (K, H, obj.element_indices, obj.plan, state.vel, obj.mass,
             frame_kw["dt"], True)
    it = int(cg.fused_cg_solve(*solve)[1])
    put("fused_cg", lambda: cg.fused_cg_solve(*solve),
        lambda: cg.fused_cg_solve_plain(*solve), 5, 100, ["fused_cg_kernel"],
        nbytes(K, H, obj.element_indices, obj.plan.ptr, obj.plan.rows,
               state.vel, obj.mass, state.vel) + 8,
        cg_ops(e, n, it, True, d), iterations=it)

    k2_args = (blk, state.pos, obj.mu, obj.s_lambda)
    Kb, part = bk.blocked_prep(*k2_args)
    put("blocked_prep", lambda: bk.blocked_prep(*k2_args),
        lambda: bk.blocked_prep_plain(*k2_args), 20, 200,
        ["blocked_prep_kernel"],
        nbytes(state.pos, blk.ref_inv, blk.volume, *tables, Kb, part),
        ops["chain"] * e)

    k3_args = (blk, Kb, x, False)
    y = bk.blocked_graph_apply(*k3_args)
    gmat = graph_matrix(torch, obj.element_indices, K, n)
    xcol = x.reshape(-1, 1)
    # The same function: G(K) in element order equals G(K) in block order.
    lib = library_ms("K3", lambda: torch.sparse.mm(gmat, xcol).reshape(n, d),
                     y)
    put("blocked_matvec", lambda: bk.blocked_graph_apply(*k3_args),
        lambda: bk.blocked_graph_apply_plain(*k3_args), 20, 200,
        ["blocked_matvec_kernel", "slot_sum_kernel"],
        nbytes(Kb, x, *tables, *plan, part, y),
        ops["apply"] * e + d * slot_rows, library=lib)

    k5_args = (blk, state.pos, state.vel, state.vel_g, obj.mass,
               obstacles.centers, obstacles.radii)
    k5_out = fk.fused_blocked_frame(*k5_args, preconditioned=True, **frame_kw)
    k5_iters = k5_out[3].tolist()
    put("blocked_frame",
        lambda: fk.fused_blocked_frame(*k5_args, preconditioned=True,
                                       **frame_kw),
        lambda: fk.fused_blocked_frame_plain(*k5_args, preconditioned=True,
                                             **frame_kw),
        3, FRAMES, ["blocked_frame_kernel"],
        nbytes(blk.ref_inv, blk.volume, *tables, *plan, obj.mass,
               obstacles.centers, obstacles.radii, state.pos, state.vel,
               state.vel_g, *k5_out),
        frame_ops(e, n, slot_rows, k5_iters, True, d), iterations=k5_iters)

    G = ek.explicit_grad_columns(*k1_args)
    put("grad_columns", lambda: ek.explicit_grad_columns(*k1_args),
        lambda: ek.explicit_grad_columns_plain(*k1_args), 20, 200,
        ["explicit_grad_columns_kernel"], nbytes(*k1_args[:4], G),
        ops["grad"] * e)

    # Block-ordered columns: the explicit gradient's, on the blocked slots.
    bcols = ek.explicit_grad_columns_plain(
        state.pos, blk.element_indices, blk.ref_inv, blk.volume, obj.mu,
        obj.s_lambda)
    ysum = bk.blocked_assemble(blk, bcols)
    smat = incidence_matrix(torch, blk, n)
    ccol = bcols.transpose(1, 2).reshape(-1, d).contiguous()
    lib = library_ms("K7a", lambda: torch.sparse.mm(smat, ccol), ysum)
    put("blocked_assemble", lambda: bk.blocked_assemble(blk, bcols),
        lambda: bk.blocked_assemble_plain(blk, bcols), 20, 200,
        ["blocked_assemble_kernel", "slot_sum_kernel"],
        nbytes(bcols, blk.block_elements, blk.local_ptr, blk.local_rows,
               *plan, ysum),
        ops["rows"] * e + d * slot_rows, library=lib)

    gpart = bk.blocked_grad_prep(*k2_args)
    put("blocked_grad_prep", lambda: bk.blocked_grad_prep(*k2_args),
        lambda: bk.blocked_grad_prep_plain(*k2_args), 20, 200,
        ["blocked_grad_prep_kernel"],
        nbytes(state.pos, blk.ref_inv, blk.volume, *tables, gpart),
        (ops["grad"] + ops["rows"]) * e)

    k8_args = (blk, state.pos, state.vel, obj.mass, obstacles.centers,
               obstacles.radii)
    k8_out = fk.fused_explicit_frame(*k8_args, **ekw)
    put("explicit_frame", lambda: fk.fused_explicit_frame(*k8_args, **ekw),
        lambda: fk.fused_explicit_frame_plain(*k8_args, **ekw), 5, FRAMES,
        ["explicit_frame_kernel"],
        nbytes(blk.ref_inv, blk.volume, *tables, *plan, obj.mass,
               obstacles.centers, obstacles.radii, state.pos, state.vel,
               *k8_out),
        explicit_frame_ops(e, n, slot_rows, ekw["sim_count"], d))
    return out


def kernel_rows(d, times, launches, errors, card):
    """The kernels line's rows of dimension ``d``, each logged."""
    rows = []
    for name, source, replaces in KERNELS:
        t = times[name]
        extra = {k: v for k, v in t.items()
                 if k not in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")}
        lib = t["library_ms"]
        log(f"[time] {d}D {name} {t['ms']:.5f} ms a launch on the device "
            f"(profiler){'' if lib is None else f'; torch.sparse.mm {lib:.5f} ms'}"
            f"; plain {t['plain_ms']:.4f} ms; bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']}); {extra}; card {card}")
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, dim=d,
            launches=launches[name], max_abs_err=errors[name], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=lib, **extra))
    return rows


def squeezed_2d(torch, state, gen):
    """default.json's body (at rest in the air above its two circles) moved
    0.2 down into the right circle, squashed 10 % across and stretched 10 %
    up about its centroid, with random velocities: the CG iterates and the
    circle is hit."""
    dev = state.pos.device
    c = state.pos.mean(dim=0, keepdim=True)
    pos = (c + (state.pos - c) * torch.tensor([[0.9, 1.1]], device=dev)
           - torch.tensor([[0.0, 0.2]], device=dev))
    vel = 0.3 * torch.randn(state.vel.shape, generator=gen).to(dev)
    return state.replace(pos=pos, vel=vel)


def golden_check(torch, name, pos):
    """Hold 200-frame positions to tests/test_golden.py's values for
    ``name``, with its tolerances."""
    p = pos.cpu()
    g = GOLDEN_2D[name]
    mean, std = float(p.mean()), float(p.std(correction=0))
    worst = max(float((p[i] - torch.tensor(g[k])).abs().max())
                for k, i in (("p0", 0), ("p24", 24), ("p48", 48)))
    log(f"[golden {name}] mean {mean:.7f} (golden {g['mean']}), std "
        f"{std:.7f} (golden {g['std']}), particles 0/24/48 within "
        f"{worst:.3e}")
    require(bool(torch.isfinite(p).all()), f"golden {name} non-finite")
    require(abs(mean - g["mean"]) < 5e-3 and abs(std - g["std"]) < 5e-3,
            f"golden {name} mean/std")
    require(worst <= 1e-2, f"golden {name} particles off by {worst}")


def check_kernels_2d(torch, obj, state, obstacles, frame_kw, lscene):
    """Section 15: K1-K8's 2D instances against their plain versions on
    the card, each twice bit-identical; K5 and K8 also on path L's 16-block
    body (``lscene``: object, state, obstacles, frame arguments by mode).  Returns {counter name: max abs error}."""
    from fem_tpu_torch.ops import (
        blocked_kernels as bk,
        cg_kernels as cg,
        element_kernels as ek,
        frame_kernels as fk,
    )

    def twice(fn, args, kwargs=None):
        kwargs = kwargs or {}
        a, b = fn(*args, **kwargs), fn(*args, **kwargs)
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        require(all(torch.equal(x, y) for x, y in zip(a, b)),
                f"2D {fn.__name__} runs differ")
        return a

    errs = {}
    blk = obj.blocking
    k1_args = (state.pos, obj.element_indices, obj.ref_inv, obj.volume,
               obj.mu, obj.s_lambda)
    K, H = twice(ek.hessian_and_force, k1_args)
    Kp, Hp = ek.hessian_and_force_plain(*k1_args)
    rel = max(block_rel_err(K, Kp), block_rel_err(H, Hp))
    errs["element_chain"] = float(max((K - Kp).abs().max(),
                                      (H - Hp).abs().max()))
    log(f"[2D K1] block-relative error {rel:.3e}, max abs error "
        f"{errs['element_chain']:.3e}")
    require(rel <= 1e-5, f"2D K1 block-relative error {rel}")

    errs["fused_cg"] = 0.0
    for pre in (False, True):
        solve = (K, H, obj.element_indices, obj.plan, state.vel, obj.mass,
                 frame_kw["dt"], pre)
        v, it, _ = twice(cg.fused_cg_solve, solve)
        vp, itp, _ = cg.fused_cg_solve_plain(*solve)
        err = float((v - vp).abs().max())
        errs["fused_cg"] = max(errs["fused_cg"], err)
        log(f"[2D K4] preconditioned={int(pre)}: iterations {int(it)} "
            f"(plain {int(itp)}), max abs error {err:.3e}")
        require(1 < int(itp) <= 20, f"2D K4 plain iterations {int(itp)}")
        require(abs(int(it) - int(itp)) <= 1, "2D K4 iterations differ")
        torch.testing.assert_close(v, vp, rtol=5e-4, atol=1e-6)

    k2_args = (blk, state.pos, obj.mu, obj.s_lambda)
    Kb, part = twice(bk.blocked_prep, k2_args)
    Kbp, partp = bk.blocked_prep_plain(*k2_args)
    rel = block_rel_err(Kb, Kbp)
    perr = float((part - partp).abs().max())
    errs["blocked_prep"] = max(float((Kb - Kbp).abs().max()), perr)
    log(f"[2D K2] K block-relative error {rel:.3e}; force partials max abs "
        f"error {perr:.3e} of max {float(partp.abs().max()):.3e}")
    require(rel <= 1e-5, f"2D K2 block-relative error {rel}")
    require(perr <= 1e-5 * float(partp.abs().max()), "2D K2 partials")

    errs["blocked_matvec"] = 0.0
    for tr in (False, True):
        (y,) = twice(bk.blocked_graph_apply, (blk, Kb, state.vel, tr))
        yp = bk.blocked_graph_apply_plain(blk, Kb, state.vel, tr)
        err, top = float((y - yp).abs().max()), float(yp.abs().max())
        errs["blocked_matvec"] = max(errs["blocked_matvec"], err)
        log(f"[2D K3] transpose_k={int(tr)}: max abs error {err:.3e} of max "
            f"{top:.3e}")
        require(top > 0 and err <= 1e-5 * top, f"2D K3 error {err} of {top}")

    (G,) = twice(ek.explicit_grad_columns, k1_args)
    Gp = ek.explicit_grad_columns_plain(*k1_args)
    rel = block_rel_err(G, Gp)
    errs["grad_columns"] = float((G - Gp).abs().max())
    log(f"[2D K6] block-relative error {rel:.3e}, max abs error "
        f"{errs['grad_columns']:.3e}")
    require(bool(torch.isfinite(G).all()) and rel <= 1e-5,
            f"2D K6 block-relative error {rel}")

    (gpart,) = twice(bk.blocked_grad_prep, k2_args)
    gpartp = bk.blocked_grad_prep_plain(*k2_args)
    err, top = float((gpart - gpartp).abs().max()), float(gpartp.abs().max())
    errs["blocked_grad_prep"] = err
    log(f"[2D K7b] gradient partials max abs error {err:.3e} of max "
        f"{top:.3e}")
    require(top > 0 and err <= 1e-5 * top, f"2D K7b error {err} of {top}")

    bcols = ek.explicit_grad_columns_plain(
        state.pos, blk.element_indices, blk.ref_inv, blk.volume, obj.mu,
        obj.s_lambda)
    (ysum,) = twice(bk.blocked_assemble, (blk, bcols))
    ysump = bk.blocked_assemble_plain(blk, bcols)
    err, top = float((ysum - ysump).abs().max()), float(ysump.abs().max())
    errs["blocked_assemble"] = err
    log(f"[2D K7a] assembled gradient max abs error {err:.3e} of max "
        f"{top:.3e}")
    require(top > 0 and err <= 1e-5 * top, f"2D K7a error {err} of {top}")

    lobj, lstate, lobs, lkw = lscene
    errs["blocked_frame"] = errs["explicit_frame"] = 0.0
    for label, o, s, obs, kw in (
        ("default.json squeezed", obj, state, obstacles, frame_kw),
        ("40 subdivisions", lobj, lstate, lobs, lkw["implicit"]),
    ):
        for pre in (False, True):
            args = (o.blocking, s.pos, s.vel, s.vel_g, o.mass, obs.centers,
                    obs.radii)
            out = twice(fk.fused_blocked_frame, args,
                        dict(preconditioned=pre, **kw))
            ref = fk.fused_blocked_frame_plain(*args, preconditioned=pre,
                                               **kw)
            err = float((out[0] - ref[0]).abs().max())
            errs["blocked_frame"] = max(errs["blocked_frame"], err)
            it, itp = out[3].tolist(), ref[3].tolist()
            log(f"[2D K5] {label} ({o.blocking.num_blocks} blocks) "
                f"preconditioned={int(pre)}: iterations {it} (plain {itp}); "
                f"max |dpos| {err:.3e}")
            require(err <= 1e-5, f"2D K5 positions off by {err}")
            if max(itp) <= 20:
                require(all(abs(a - b) <= 1 for a, b in zip(it, itp)),
                        "2D K5 iterations differ")
    for label, o, s, obs, kw in (
        ("default.json squeezed", obj, state, obstacles, frame_kw),
        ("40 subdivisions", lobj, lstate, lobs, lkw["explicit"]),
    ):
        args = (o.blocking, s.pos, s.vel, o.mass, obs.centers, obs.radii)
        out = twice(fk.fused_explicit_frame, args, kw)
        ref = fk.fused_explicit_frame_plain(*args, **kw)
        err = float((out[0] - ref[0]).abs().max())
        errs["explicit_frame"] = max(errs["explicit_frame"], err)
        log(f"[2D K8] {label} ({o.blocking.num_blocks} blocks): max |dpos| "
            f"{err:.3e}, moved {float((out[0] - s.pos).abs().max()):.3e}")
        require(bool(torch.isfinite(out[0]).all()), "2D K8 non-finite")
        require(err <= 1e-5, f"2D K8 positions off by {err}")
    log("[2D] K1-K8 two runs bit-identical in every case")
    return errs


def run_2d(torch, dev, zero_counts, counts, only):
    """Sections 15-20: the 2D kernels and paths H-L.  Returns the launch
    counts and errors of the kernels line's 2D rows, the inputs their
    timing reuses and the profiled windows of section 21."""
    from fem_tpu_torch import convert, scene, sim
    from fem_tpu_torch.solvers import explicit
    from fem_tpu_torch.utils.config import read_config

    def cpu_state(s):
        return convert.state_from_arrays(convert.state_to_arrays(s), "cpu")

    def max_dpos(a, b):
        return float((a.pos.cpu() - b.pos).abs().max())

    def with_subdivisions(c, sub, **over):
        ocfg = dataclasses.replace(c.objects[0], subdivisions=sub)
        return dataclasses.replace(c, objects=(ocfg,), **over)

    cfg = read_config(os.path.join(REPO, "configs", "default.json"))
    icfg = dataclasses.replace(cfg, **OVERRIDES_2D["implicit_cg"])
    (body,), obstacles = scene.load_scene(cfg, device=dev)
    (cbody,), cobs = scene.load_scene(cfg, device="cpu")
    obj = body.obj
    require((obj.dim, obj.particle_cnt, obj.element_cnt,
             obj.blocking.num_blocks) == (2, 121, 200, 1),
            f"default.json: {obj.particle_cnt} particles, {obj.element_cnt} "
            f"triangles, {obj.blocking.num_blocks} blocks")
    frame_kw = dict(dt=cfg.delta_time, damping=obj.damping,
                    g_dir=tuple(cfg.g_dir), mu=obj.mu, s_lambda=obj.s_lambda,
                    sim_count=cfg.sim_count)
    state = squeezed_2d(torch, body.state, torch.Generator().manual_seed(1))
    lcfg = with_subdivisions(cfg, 40)
    (lbody,), lobs = scene.load_scene(lcfg, device=dev)
    lobj = lbody.obj
    require((lobj.particle_cnt, lobj.element_cnt,
             lobj.blocking.num_blocks) == (1681, 3200, 16),
            f"40 subdivisions: {lobj.particle_cnt} particles, "
            f"{lobj.blocking.num_blocks} blocks")
    lkw = {"explicit": dict(frame_kw, dt=1e-4), "implicit": frame_kw}

    # -- 15. K1-K8 in 2D against their plain versions ------------------------
    lstate = squeezed_2d(torch, lbody.state, torch.Generator().manual_seed(2))
    errors = check_kernels_2d(torch, obj, state, obstacles, frame_kw,
                              (lobj, lstate, lobs, lkw))
    launches = {}

    # -- 16. path H: default.json as shipped (K8), and its golden arcs -------
    def frame_path(label, c, key, backend, start, cstart, frames=FRAMES):
        """``frames`` frames of ``c`` through make_frame_fn from ``start``,
        launching ``key`` once a frame and nothing else; the first frame
        equal to the CPU's ``backend`` frame from ``cstart``."""
        frame = sim.make_frame_fn(start[0], c)
        warm, warm_aux = frame(start[1], start[2])  # warm-up, not counted
        ref, ref_aux = sim.make_frame_fn(
            cstart[0], dataclasses.replace(c, frame_backend=backend))(
                cstart[1], cstart[2])
        err = max_dpos(warm, ref)
        it, itp = warm_aux.solver_iterations.tolist(), \
            ref_aux.solver_iterations.tolist()
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        s, iters = start[1], []
        for _ in range(frames):
            s, aux = frame(s, start[2])
            iters.append(aux.solver_iterations)
        iters = torch.stack(iters).cpu()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
        log(f"[path {label}] {frames} frames x {c.sim_count} substeps (dt "
            f"{c.delta_time}) in {wall:.4f} s: "
            f"{frames * c.sim_count / wall:.1f} steps/s; launches {got}; "
            f"first frame vs the CPU: max |dpos| {err:.3e}, iterations {it} "
            f"(CPU {itp}); CG iterations by frame {iters.tolist()}")
        require(got == only(**{key: frames}), f"path {label} launches {got}")
        require(bool(torch.isfinite(s.pos).all()), f"path {label} non-finite")
        require(err <= 1e-5, f"path {label} off the CPU frame by {err}")
        require(all(abs(a - b) <= 1 for a, b in zip(it, itp)),
                f"path {label} iterations differ")
        return got[key], frame

    start = (obj, body.state, obstacles)
    cstart = (cbody.obj, cbody.state, cobs)
    launches["explicit_frame"], frame_h = frame_path(
        "H (default.json, autodiff)", cfg, "explicit_frame",
        "blocked_explicit", start, cstart)
    frame_path("H (auto_diff off)",
               dataclasses.replace(cfg, **OVERRIDES_2D["explicit_analytic"]),
               "explicit_frame", "blocked_explicit", start, cstart)
    launches["blocked_frame"], frame_i = frame_path(
        "I (default.json, implicit_cg)", icfg, "blocked_frame", "blocked",
        start, cstart)

    def golden_arc(name, key):
        gcfg = with_subdivisions(cfg, 6, **OVERRIDES_2D[name])
        (gbody,), gobs = scene.load_scene(gcfg, device=dev)
        frame = sim.make_frame_fn(gbody.obj, gcfg)
        zero_counts()
        s = gbody.state
        for _ in range(GOLDEN_FRAMES):
            s, _ = frame(s, gobs)
        torch.cuda.synchronize()
        got = counts()
        require(got == only(**{key: GOLDEN_FRAMES}),
                f"golden {name} launches {got}")
        golden_check(torch, name, s.pos)

    # -- 17. path I's golden arc is K5's; 16.'s are K8's ---------------------
    golden_arc("explicit_analytic", "explicit_frame")
    golden_arc("autodiff", "explicit_frame")
    golden_arc("implicit_cg", "blocked_frame")

    # -- 18. path J: the op-composed 2D substeps -----------------------------
    cstate = cpu_state(state)
    ecfg = dataclasses.replace(cfg, **OVERRIDES_2D["explicit_analytic"])
    n_sub = cfg.sim_count
    for label, c, key in (
        ("J (K1 + K4)", icfg, "element_chain"),
        ("J (K2 + K3: operator_mode=blocked)",
         dataclasses.replace(icfg, operator_mode="blocked"), "blocked_prep"),
        ("J (K7b: element_backend=auto)", ecfg, "blocked_grad_prep"),
        ("J (K7a: auto_diff)", cfg, "blocked_assemble"),
        ("J (K7a: element_backend=xla)",
         dataclasses.replace(ecfg, element_backend="xla"), None),
    ):
        kw = sim.substep_kwargs(c)
        zero_counts()
        s, first, iters = state, None, []
        for i in range(n_sub):
            s, aux = sim.substep(obj, s, obstacles, **kw)
            iters.append(aux.solver_iterations)
            if i == 0:
                first = s
        iters = [int(v) for v in torch.stack(iters).cpu()]
        torch.cuda.synchronize()
        got = counts()
        if key == "element_chain":
            want = only(element_chain=n_sub, fused_cg=n_sub)
        elif key == "blocked_prep":
            want = only(blocked_prep=n_sub,
                        blocked_matvec=sum(3 + 2 * it for it in iters))
        else:
            want = only(**{key or "blocked_assemble": n_sub})
        ref, _ = sim.substep(cbody.obj, cstate, cobs, **kw)
        err = max_dpos(first, ref)
        log(f"[path {label}] {n_sub} substeps; launches {got}; CG "
            f"iterations {iters}; first substep vs the CPU: max |dpos| "
            f"{err:.3e}")
        require(got == want, f"path {label} launches {got}")
        require(bool(torch.isfinite(s.pos).all()), f"path {label} non-finite")
        require(err <= 1e-5, f"path {label} off the CPU substep by {err}")
        if key == "element_chain":
            launches["element_chain"] = got["element_chain"]
            launches["fused_cg"] = got["fused_cg"]
        elif key == "blocked_prep":
            launches["blocked_prep"] = got["blocked_prep"]
            launches["blocked_matvec"] = got["blocked_matvec"]
        elif key:
            launches[key] = got[key]
    unblocked = dataclasses.replace(obj, blocking=None)
    zero_counts()
    grads = [explicit.analytic_energy_gradient(unblocked, state.pos)
             for _ in range(SUBSTEPS_C)]
    torch.cuda.synchronize()
    got = counts()
    ref_g = explicit.analytic_energy_gradient(
        dataclasses.replace(cbody.obj, blocking=None), cstate.pos)
    g_err = float((grads[0].cpu() - ref_g).abs().max())
    g_top = float(ref_g.abs().max())
    log(f"[path J (K6)] {SUBSTEPS_C} unblocked gradients; launches {got}; "
        f"vs the CPU: max abs error {g_err:.3e} of max {g_top:.3e}")
    require(got == only(grad_columns=SUBSTEPS_C), f"path J K6 launches {got}")
    require(g_err <= 1e-5 * g_top, f"path J K6 off the CPU by {g_err}")
    launches["grad_columns"] = got["grad_columns"]

    # -- 19. path K: demo_two_bodies.json, one frame function per body ------
    tcfg = read_config(os.path.join(REPO, "configs", "demo_two_bodies.json"))
    bodies, tobs = scene.load_scene(tcfg, device=dev)
    cbodies, ctobs = scene.load_scene(tcfg, device="cpu")
    require(len(bodies) == 2, f"{len(bodies)} bodies")
    frames_k = [sim.make_frame_fn(b.obj, tcfg) for b in bodies]
    worst = 0.0
    for f, b, cb in zip(frames_k, bodies, cbodies):
        warm, _ = f(b.state, tobs)
        ref, _ = sim.make_frame_fn(cb.obj, dataclasses.replace(
            tcfg, frame_backend="blocked_explicit"))(cb.state, ctobs)
        worst = max(worst, max_dpos(warm, ref))
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    states = [b.state for b in bodies]
    for _ in range(FRAMES):
        states = [f(s, tobs)[0] for f, s in zip(frames_k, states)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    log(f"[path K] demo_two_bodies.json, bodies of "
        f"{[b.obj.particle_cnt for b in bodies]} particles: {FRAMES} frames "
        f"in {wall:.4f} s: {FRAMES * tcfg.sim_count / wall:.1f} steps/s "
        f"(a step advances both bodies); launches {got}; first frames vs "
        f"the CPU: max |dpos| {worst:.3e}")
    require(got == only(explicit_frame=2 * FRAMES), f"path K launches {got}")
    require(all(bool(torch.isfinite(s.pos).all()) for s in states),
            "path K non-finite")
    require(worst <= 1e-5, f"path K off the CPU frames by {worst}")

    # -- 20. path L: 40 subdivisions, 16 blocks ------------------------------
    (clbody,), clobs = scene.load_scene(lcfg, device="cpu")
    lstart = (lobj, lbody.state, lobs)
    clstart = (clbody.obj, clbody.state, clobs)
    l_explicit = dataclasses.replace(lcfg, delta_time=1e-4)
    l_implicit = dataclasses.replace(lcfg, **OVERRIDES_2D["implicit_cg"])
    _, frame_le = frame_path("L (explicit, dt 1e-4)", l_explicit,
                             "explicit_frame", "blocked_explicit", lstart,
                             clstart, FRAMES_L)
    _, frame_li = frame_path("L (implicit_cg, dt 5e-4)", l_implicit,
                             "blocked_frame", "blocked", lstart, clstart,
                             FRAMES_L)

    windows = [
        ("path H (K8 2D)", [frame_h], [body.state], obstacles, FRAMES),
        ("path I (K5 2D)", [frame_i], [body.state], obstacles, FRAMES),
        ("path K (K8 2D, two bodies)", frames_k, [b.state for b in bodies],
         tobs, FRAMES),
        ("path L explicit (K8 2D, 16 blocks)", [frame_le], [lbody.state],
         lobs, FRAMES_L),
        ("path L implicit (K5 2D, 16 blocks)", [frame_li], [lbody.state],
         lobs, FRAMES_L),
    ]
    return dict(obj=obj, state=state, obstacles=obstacles, frame_kw=frame_kw,
                launches=launches, errors=errors, windows=windows,
                l=(lobj, lbody.state, lobs), l_kw=lkw)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "fem_tpu_torch")):
        print("chip_smoke: fem_tpu_torch/ not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import fem_tpu_torch  # noqa: F401  (precision pins)
    from fem_tpu_torch import convert, entry, sim
    from fem_tpu_torch.ops import (
        blocked_kernels,
        cg_kernels,
        element_kernels,
        frame_kernels,
    )
    from fem_tpu_torch.solvers import explicit
    from fem_tpu_torch.utils import cuda_build

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    counters = {
        "element_chain": element_kernels.hessian_and_force,
        "fused_cg": cg_kernels.fused_cg_solve,
        "blocked_prep": blocked_kernels.blocked_prep,
        "blocked_matvec": blocked_kernels.blocked_graph_apply,
        "blocked_frame": frame_kernels.fused_blocked_frame,
        "grad_columns": element_kernels.explicit_grad_columns,
        "blocked_assemble": blocked_kernels.blocked_assemble,
        "blocked_grad_prep": blocked_kernels.blocked_grad_prep,
        "explicit_frame": frame_kernels.fused_explicit_frame,
    }

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in counters.items()}

    def only(**launched):
        """The launch counts of a run that launched ``launched`` and no
        other kernel."""
        return {k: launched.get(k, 0) for k in counters}

    # -- 1. environment -------------------------------------------------------
    nvcc = subprocess.run(
        [cuda_build.find_nvcc(), "--version"], capture_output=True, text=True,
        check=True,
    ).stdout.strip().splitlines()[-1]
    log(f"[env] python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  nvcc: {nvcc}")
    log(f"[env] card: {card}  ({torch.cuda.device_count()} visible)")

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    paths = cuda_build.build()
    log(f"[build] {len(paths)} libraries in {time.perf_counter() - t0:.2f} s")
    for name, text in cuda_build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name}: {line.strip()}")

    # -- 3. K1 against its plain version ------------------------------------
    cfg, obj, state0, obstacles = entry.flagship(dev)
    require((obj.particle_cnt, obj.element_cnt) == (1007, 4068),
            f"flagship size {obj.particle_cnt} particles, "
            f"{obj.element_cnt} tets")
    blk = obj.blocking
    require((blk.num_blocks, blk.eb, blk.pb) == (17, 256, 128),
            f"flagship blocking {blk.num_blocks} x ({blk.eb}, {blk.pb})")
    n, e = obj.particle_cnt, obj.element_cnt
    state = entry.deformed(state0)
    k1_args = (state.pos, obj.element_indices, obj.ref_inv, obj.volume,
               obj.mu, obj.s_lambda)
    K, H = element_kernels.hessian_and_force(*k1_args)
    Kp, Hp = element_kernels.hessian_and_force_plain(*k1_args)
    torch.cuda.synchronize()
    k1_rel = max(block_rel_err(K, Kp), block_rel_err(H, Hp))
    k1_abs = float(max((K - Kp).abs().max(), (H - Hp).abs().max()))
    log(f"[K1] block-relative error {k1_rel:.3e}, max abs error {k1_abs:.3e}")
    require(k1_rel <= 1e-5, f"K1 block-relative error {k1_rel}")

    # -- 4. K4 against its plain version, and determinism -------------------
    gen = torch.Generator().manual_seed(0)
    noisy = state.vel + 0.3 * torch.randn(
        state.vel.shape, generator=gen).to(dev)
    k4_abs = 0.0
    for label, vel in (("deformed", state.vel), ("deformed+noise", noisy)):
        for pre in (False, True):
            solve = (K, H, obj.element_indices, obj.plan, vel, obj.mass,
                     cfg.delta_time, pre)
            v, it, res = cg_kernels.fused_cg_solve(*solve)
            vp, itp, resp = cg_kernels.fused_cg_solve_plain(*solve)
            torch.cuda.synchronize()
            err = float((v - vp).abs().max())
            k4_abs = max(k4_abs, err)
            log(f"[K4] {label} preconditioned={int(pre)}: iterations "
                f"{int(it)} (plain {int(itp)}), |r|^2 {float(res):.3e} "
                f"(plain {float(resp):.3e}), max abs error {err:.3e}")
            torch.testing.assert_close(v, vp, rtol=5e-4, atol=1e-6)
            require(abs(int(it) - int(itp)) <= 1, "K4 iterations differ")
            v2, it2, res2 = cg_kernels.fused_cg_solve(*solve)
            require(torch.equal(v, v2) and int(it) == int(it2)
                    and torch.equal(res, res2), "K4 runs differ")
    log("[K4] two runs bit-identical in every case")

    # -- 5. K2 and K3 against their plain versions --------------------------
    k2_args = (blk, state.pos, obj.mu, obj.s_lambda)
    Kb, part = blocked_kernels.blocked_prep(*k2_args)
    Kbp, partp = blocked_kernels.blocked_prep_plain(*k2_args)
    Kb2, part2 = blocked_kernels.blocked_prep(*k2_args)
    torch.cuda.synchronize()
    k2_rel = block_rel_err(Kb, Kbp)
    k2_part = float((part - partp).abs().max())
    k2_abs = float(max((Kb - Kbp).abs().max(), k2_part))
    log(f"[K2] K block-relative error {k2_rel:.3e}; force partials max abs "
        f"error {k2_part:.3e} of max {float(partp.abs().max()):.3e}")
    require(k2_rel <= 1e-5, f"K2 block-relative error {k2_rel}")
    require(k2_part <= 1e-5 * float(partp.abs().max()), "K2 partials")
    require(torch.equal(Kb, Kb2) and torch.equal(part, part2), "K2 runs differ")
    k3_abs = 0.0
    for tr in (False, True):
        y = blocked_kernels.blocked_graph_apply(blk, Kb, noisy, tr)
        yp = blocked_kernels.blocked_graph_apply_plain(blk, Kb, noisy, tr)
        y2 = blocked_kernels.blocked_graph_apply(blk, Kb, noisy, tr)
        torch.cuda.synchronize()
        err = float((y - yp).abs().max())
        k3_abs = max(k3_abs, err)
        top = float(yp.abs().max())
        log(f"[K3] transpose_k={int(tr)}: max abs error {err:.3e} of max "
            f"{top:.3e}")
        require(top > 0 and err <= 1e-5 * top, f"K3 error {err} of {top}")
        require(torch.equal(y, y2), "K3 runs differ")
    log("[K2/K3] two runs bit-identical")

    # -- 6. K5 against its plain version on the card ------------------------
    frame_kw = dict(dt=cfg.delta_time, damping=obj.damping,
                    g_dir=tuple(cfg.g_dir), mu=obj.mu, s_lambda=obj.s_lambda,
                    sim_count=cfg.sim_count)
    k5_abs = 0.0
    for label, vel in (("deformed", state.vel), ("deformed+noise", noisy)):
        for pre in (False, True):
            args = (blk, state.pos, vel, state.vel_g, obj.mass,
                    obstacles.centers, obstacles.radii)
            out = frame_kernels.fused_blocked_frame(
                *args, preconditioned=pre, **frame_kw)
            ref = frame_kernels.fused_blocked_frame_plain(
                *args, preconditioned=pre, **frame_kw)
            again = frame_kernels.fused_blocked_frame(
                *args, preconditioned=pre, **frame_kw)
            torch.cuda.synchronize()
            err = float((out[0] - ref[0]).abs().max())
            k5_abs = max(k5_abs, err)
            it, itp = out[3].tolist(), ref[3].tolist()
            log(f"[K5] {label} preconditioned={int(pre)}: iterations {it} "
                f"(plain {itp}); max |dpos| {err:.3e}, max |dvel| "
                f"{float((out[1] - ref[1]).abs().max()):.3e}")
            require(err <= 1e-5, f"K5 positions off by {err}")
            require(all(abs(a - b) <= 1 for a, b in zip(it, itp)),
                    "K5 iterations differ")
            require(all(torch.equal(a, b) for a, b in zip(out, again)),
                    "K5 runs differ")
    log("[K5] two runs bit-identical in every case")

    # -- 7. K6, K7b and K7a against their plain versions --------------------
    k6_args = (state.pos, obj.element_indices, obj.ref_inv, obj.volume,
               obj.mu, obj.s_lambda)
    G = element_kernels.explicit_grad_columns(*k6_args)
    Gp = element_kernels.explicit_grad_columns_plain(*k6_args)
    G2 = element_kernels.explicit_grad_columns(*k6_args)
    torch.cuda.synchronize()
    k6_rel = block_rel_err(G, Gp)
    k6_abs = float((G - Gp).abs().max())
    log(f"[K6] block-relative error {k6_rel:.3e}, max abs error {k6_abs:.3e}")
    require(bool(torch.isfinite(G).all()), "K6 non-finite columns")
    require(k6_rel <= 1e-5, f"K6 block-relative error {k6_rel}")
    require(torch.equal(G, G2), "K6 runs differ")
    k7b_args = (blk, state.pos, obj.mu, obj.s_lambda)
    gpart = blocked_kernels.blocked_grad_prep(*k7b_args)
    gpartp = blocked_kernels.blocked_grad_prep_plain(*k7b_args)
    gpart2 = blocked_kernels.blocked_grad_prep(*k7b_args)
    torch.cuda.synchronize()
    k7b_abs = float((gpart - gpartp).abs().max())
    top = float(gpartp.abs().max())
    log(f"[K7b] gradient partials max abs error {k7b_abs:.3e} of max {top:.3e}")
    require(top > 0 and k7b_abs <= 1e-5 * top, f"K7b error {k7b_abs} of {top}")
    require(torch.equal(gpart, gpart2), "K7b runs differ")
    # Block-ordered columns: the explicit gradient's, on the blocked slots.
    bcols = element_kernels.explicit_grad_columns_plain(
        state.pos, blk.element_indices, blk.ref_inv, blk.volume, obj.mu,
        obj.s_lambda)
    ysum = blocked_kernels.blocked_assemble(blk, bcols)
    ysump = blocked_kernels.blocked_assemble_plain(blk, bcols)
    ysum2 = blocked_kernels.blocked_assemble(blk, bcols)
    torch.cuda.synchronize()
    k7a_abs = float((ysum - ysump).abs().max())
    top = float(ysump.abs().max())
    log(f"[K7a] assembled gradient max abs error {k7a_abs:.3e} of max "
        f"{top:.3e}")
    require(top > 0 and k7a_abs <= 1e-5 * top, f"K7a error {k7a_abs} of {top}")
    require(torch.equal(ysum, ysum2), "K7a runs differ")
    log("[K6/K7b/K7a] two runs bit-identical")

    # -- 8. K8 against its plain version on the card ------------------------
    ecfg, _, estate0, _ = entry.explicit_flagship(dev)
    ekw = dict(dt=ecfg.delta_time, damping=obj.damping,
               g_dir=tuple(ecfg.g_dir), mu=obj.mu, s_lambda=obj.s_lambda,
               sim_count=ecfg.sim_count)
    enoise = 0.3 * torch.randn(state.vel.shape, generator=gen).to(dev)
    k8_abs = 0.0
    for label, st in (("deformed", state), ("path D start", estate0)):
        for noise in (False, True):
            vel = st.vel + enoise if noise else st.vel
            args = (blk, st.pos, vel, obj.mass, obstacles.centers,
                    obstacles.radii)
            out = frame_kernels.fused_explicit_frame(*args, **ekw)
            ref = frame_kernels.fused_explicit_frame_plain(*args, **ekw)
            again = frame_kernels.fused_explicit_frame(*args, **ekw)
            torch.cuda.synchronize()
            err = float((out[0] - ref[0]).abs().max())
            k8_abs = max(k8_abs, err)
            log(f"[K8] {label}{' + noise' if noise else ''}: max |dpos| "
                f"{err:.3e}, max |dvel| {float((out[1] - ref[1]).abs().max()):.3e}"
                f", moved {float((out[0] - st.pos).abs().max()):.3e}")
            require(bool(torch.isfinite(out[0]).all()), "K8 non-finite")
            require(err <= 1e-5, f"K8 positions off by {err}")
            require(all(torch.equal(a, b) for a, b in zip(out, again)),
                    "K8 runs differ")
    log("[K8] two runs bit-identical in every case")

    cpu_obj = convert.object_from_arrays(*convert.object_to_arrays(obj), "cpu")
    cpu_state = convert.state_from_arrays(convert.state_to_arrays(state), "cpu")
    cpu_obs = type(obstacles)(obstacles.centers.cpu(), obstacles.radii.cpu())

    # -- 9. path A: the flagship frame --------------------------------------
    frame = sim.make_frame_fn(obj, cfg)
    warm, warm_aux = frame(state, obstacles)  # warm-up frame, not counted
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    s, auxes = state, []
    for _ in range(FRAMES):
        s, aux = frame(s, obstacles)
        auxes.append(aux)
    iters_a = torch.stack([a.solver_iterations for a in auxes]).cpu()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_a = counts()
    substeps = FRAMES * cfg.sim_count
    log(f"[path A] {FRAMES} frames x {cfg.sim_count} substeps in "
        f"{wall:.4f} s: {substeps / wall:.1f} steps/s; launches {launches_a}")
    log(f"[path A] CG iterations per substep, by frame: {iters_a.tolist()}")
    require(launches_a == only(blocked_frame=FRAMES),
            f"path A launches {launches_a}")
    require(bool(torch.isfinite(s.pos).all()), "non-finite positions")
    ref, ref_aux = sim.make_frame_fn(
        cpu_obj, dataclasses.replace(cfg, frame_backend="blocked"))(
            cpu_state, cpu_obs)
    pos_err = float((warm.pos.cpu() - ref.pos).abs().max())
    log(f"[path A] first frame vs the CPU plain frame: max |dpos| "
        f"{pos_err:.3e}; iterations {warm_aux.solver_iterations.tolist()}, "
        f"CPU {ref_aux.solver_iterations.tolist()}")
    require(pos_err <= 1e-5, f"first frame off the CPU frame by {pos_err}")
    require(torch.equal(warm_aux.solver_iterations.cpu(),
                        ref_aux.solver_iterations), "path A iterations differ")

    # -- 10. path B: the blocked operator -----------------------------------
    cfg_b = dataclasses.replace(cfg, operator_mode="blocked")
    frame_b = sim.make_frame_fn(obj, cfg_b)
    zero_counts()
    t0 = time.perf_counter()
    s, iters_b = state, []
    for i in range(FRAMES_B):
        s, aux = frame_b(s, obstacles)
        iters_b.append(aux.solver_iterations.cpu())
        if i == 0:
            first_b = s
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    launches_b = counts()
    iters_b = torch.stack(iters_b)
    k3_expected = int((3 + 2 * iters_b).sum())
    log(f"[path B] {FRAMES_B} frames in {wall_b:.4f} s: "
        f"{FRAMES_B * cfg.sim_count / wall_b:.1f} steps/s; launches "
        f"{launches_b}; CG iterations {iters_b.tolist()}")
    require(launches_b == only(blocked_prep=FRAMES_B * cfg.sim_count,
                               blocked_matvec=k3_expected),
            f"path B launches {launches_b}, K3 expected {k3_expected}")
    ref_b, _ = sim.make_frame_fn(cpu_obj, cfg_b)(cpu_state, cpu_obs)
    pos_err_b = float((first_b.pos.cpu() - ref_b.pos).abs().max())
    log(f"[path B] first frame vs the CPU frame: max |dpos| {pos_err_b:.3e}")
    require(pos_err_b <= 1e-5, f"path B off the CPU frame by {pos_err_b}")
    require(bool(torch.isfinite(s.pos).all()), "path B non-finite positions")

    # -- 11. path C: the substep entry --------------------------------------
    fn, (obj_c, state_c, obs_c) = entry.entry(dev)
    zero_counts()
    t0 = time.perf_counter()
    s, iters_c = state_c, []
    for i in range(SUBSTEPS_C):
        s, aux = fn(obj_c, s, obs_c)
        iters_c.append(aux.solver_iterations)
        if i == 0:
            first_c = s
    iters_c = torch.stack(iters_c).cpu()
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    launches_c = counts()
    log(f"[path C] {SUBSTEPS_C} substeps in {wall_c:.4f} s: "
        f"{SUBSTEPS_C / wall_c:.1f} steps/s; launches {launches_c}; CG "
        f"iterations {iters_c.tolist()}")
    require(launches_c == only(element_chain=SUBSTEPS_C, fused_cg=SUBSTEPS_C),
            f"path C launches {launches_c}")
    require(bool(torch.isfinite(s.pos).all()), "path C non-finite positions")
    cpu_fn, (cpu_obj_c, cpu_state_c, cpu_obs_c) = entry.entry("cpu")
    ref_c, _ = cpu_fn(cpu_obj_c, cpu_state_c, cpu_obs_c)
    pos_err_c = float((first_c.pos.cpu() - ref_c.pos).abs().max())
    log(f"[path C] first substep vs the CPU substep: max |dpos| "
        f"{pos_err_c:.3e}")
    require(pos_err_c <= 1e-5, f"path C off the CPU substep by {pos_err_c}")

    # -- 12. path D: the explicit flagship frame ----------------------------
    ecfg, eobj, estate, eobs = entry.explicit_flagship(dev)
    require(sim.supports_explicit_blocked_frame(eobj, ecfg),
            "the explicit flagship is not eligible for K8")
    frame_d = sim.make_frame_fn(eobj, ecfg)
    warm_d, _ = frame_d(estate, eobs)  # warm-up frame, not counted
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    s, lowest = estate, []
    for _ in range(FRAMES):
        s, aux = frame_d(s, eobs)
        lowest.append(s.pos[:, 1].min())
    lowest = torch.stack(lowest).cpu()
    torch.cuda.synchronize()
    wall_d = time.perf_counter() - t0
    launches_d = counts()
    log(f"[path D] {FRAMES} frames x {ecfg.sim_count} substeps (dt "
        f"{ecfg.delta_time}) in {wall_d:.4f} s: "
        f"{FRAMES * ecfg.sim_count / wall_d:.1f} steps/s; launches "
        f"{launches_d}")
    log(f"[path D] lowest particle y by frame: "
        f"{[round(float(v), 6) for v in lowest]}")
    require(launches_d == only(explicit_frame=FRAMES),
            f"path D launches {launches_d}")
    require(bool(torch.isfinite(s.pos).all()), "path D non-finite positions")
    require(float(lowest.min()) <= 0.0, "path D never reached the floor")
    require(not aux.solver_iterations.any(), "path D solver metrics not zero")
    ecpu = convert.state_from_arrays(convert.state_to_arrays(estate), "cpu")
    ref_d, _ = sim.make_frame_fn(
        cpu_obj, dataclasses.replace(ecfg, frame_backend="blocked_explicit"))(
            ecpu, cpu_obs)
    pos_err_d = float((warm_d.pos.cpu() - ref_d.pos).abs().max())
    log(f"[path D] first frame vs the CPU plain frame: max |dpos| "
        f"{pos_err_d:.3e}")
    require(pos_err_d <= 1e-5, f"path D off the CPU frame by {pos_err_d}")
    ad_cfg = dataclasses.replace(ecfg, auto_diff=True)
    frame_ad = sim.make_frame_fn(eobj, ad_cfg)
    zero_counts()
    s_ad, _ = frame_ad(s, eobs)
    torch.cuda.synchronize()
    launches_ad = counts()
    log(f"[path D] one auto_diff frame: launches {launches_ad}")
    require(launches_ad == only(explicit_frame=1),
            f"auto_diff frame launches {launches_ad}")
    require(bool(torch.isfinite(s_ad.pos).all()), "auto_diff frame non-finite")

    # -- 13. paths E, F and G: the explicit substep -------------------------
    cpu_unblocked = dataclasses.replace(cpu_obj, blocking=None)
    unblocked = dataclasses.replace(eobj, blocking=None)
    for label, over, key in (
        ("E (element_backend=auto)", dict(), "blocked_grad_prep"),
        ("F (auto_diff)", dict(auto_diff=True), "blocked_assemble"),
        ("F (element_backend=xla)", dict(element_backend="xla"),
         "blocked_assemble"),
    ):
        kw = sim.substep_kwargs(dataclasses.replace(ecfg, **over))
        zero_counts()
        s, first = state, None
        for i in range(ecfg.sim_count):
            s, _ = sim.substep(eobj, s, eobs, **kw)
            if i == 0:
                first = s
        torch.cuda.synchronize()
        launches = counts()
        log(f"[path {label}] {ecfg.sim_count} substeps; launches {launches}")
        require(launches == only(**{key: ecfg.sim_count}),
                f"path {label} launches {launches}")
        if label.startswith("E"):
            launches_e = launches
        elif "auto_diff" in label:
            launches_f = launches
        require(bool(torch.isfinite(s.pos).all()), f"path {label} non-finite")
        ref, _ = sim.substep(cpu_obj, cpu_state, cpu_obs, **kw)
        err = float((first.pos.cpu() - ref.pos).abs().max())
        log(f"[path {label}] first substep vs the CPU: max |dpos| {err:.3e}")
        require(err <= 1e-5, f"path {label} off the CPU substep by {err}")
    zero_counts()
    grads = [explicit.analytic_energy_gradient(unblocked, state.pos)
             for _ in range(SUBSTEPS_C)]
    torch.cuda.synchronize()
    launches_g = counts()
    ref_g = explicit.analytic_energy_gradient(cpu_unblocked, cpu_state.pos)
    g_err = float((grads[0].cpu() - ref_g).abs().max())
    g_top = float(ref_g.abs().max())
    log(f"[path G] {SUBSTEPS_C} unblocked gradients; launches {launches_g}; "
        f"vs the CPU: max abs error {g_err:.3e} of max {g_top:.3e}")
    require(launches_g == only(grad_columns=SUBSTEPS_C),
            f"path G launches {launches_g}")
    require(g_err <= 1e-5 * g_top, f"path G off the CPU by {g_err}")

    # -- 14. the shipped explicit configs ------------------------------------
    for name in ("demo_3d.json", "demo_cube_autodiff.json"):
        path = os.path.join(REPO, "configs", name)
        scfg, sobj, sstate, sobs = entry.load_config(path, dev)
        ccfg, cobj, cstate, cobs = entry.load_config(path, "cpu")
        frame_s = sim.make_frame_fn(sobj, scfg)
        frame_cpu = sim.make_frame_fn(cobj, ccfg)
        zero_counts()
        worst = 0.0
        for _ in range(SHIPPED_FRAMES):
            sstate, _ = frame_s(sstate, sobs)
            cstate, _ = frame_cpu(cstate, cobs)
            worst = max(worst, float((sstate.pos.cpu() - cstate.pos)
                                     .abs().max()))
        launches = counts()
        log(f"[{name}] {sobj.particle_cnt} particles, {sobj.element_cnt} "
            f"tets: {SHIPPED_FRAMES} frames, launches {launches}; max |dpos| "
            f"vs the CPU frames {worst:.3e}")
        require(launches == only(explicit_frame=SHIPPED_FRAMES),
                f"{name} launches {launches}")
        require(worst <= 1e-5, f"{name} off the CPU frames by {worst}")

    launches3 = dict(
        element_chain=launches_c["element_chain"],
        fused_cg=launches_c["fused_cg"],
        blocked_prep=launches_b["blocked_prep"],
        blocked_matvec=launches_b["blocked_matvec"],
        blocked_frame=launches_a["blocked_frame"],
        grad_columns=launches_g["grad_columns"],
        blocked_assemble=launches_f["blocked_assemble"],
        blocked_grad_prep=launches_e["blocked_grad_prep"],
        explicit_frame=launches_d["explicit_frame"])
    errors3 = dict(
        element_chain=k1_abs, fused_cg=k4_abs, blocked_prep=k2_abs,
        blocked_matvec=k3_abs, blocked_frame=k5_abs, grad_columns=k6_abs,
        blocked_assemble=k7a_abs, blocked_grad_prep=k7b_abs,
        explicit_frame=k8_abs)

    # -- 15.-20. 2D: the kernels and paths H-L ------------------------------
    two = run_2d(torch, dev, zero_counts, counts, only)

    # -- 21. times and bounds -----------------------------------------------
    def run_frames(frame_fn, start, obs, frames=FRAMES):
        def go():
            s = start
            for _ in range(frames):
                s, _ = frame_fn(s, obs)
        return go

    # The op-composed K1 + K4 frame ("graph" is not eligible for K5).
    frame_k14 = sim.make_frame_fn(
        obj, dataclasses.replace(cfg, operator_mode="graph"))
    for label, go in (("path A (K5)", run_frames(frame, state, obstacles)),
                      ("op-composed K1 + K4",
                       run_frames(frame_k14, state, obstacles)),
                      ("path D (K8)", run_frames(frame_d, estate, obstacles))):
        profile_window(torch, label, go, FRAMES)
    for label, frame_fns, start, obs, frames in two["windows"]:
        def go(frame_fns=frame_fns, start=start, obs=obs, frames=frames):
            states = list(start)
            for _ in range(frames):
                states = [f(s, obs)[0] for f, s in zip(frame_fns, states)]
        profile_window(torch, label, go, frames)

    times3 = time_kernels(torch, 3, obj, state, noisy, obstacles, frame_kw,
                          ekw)
    times2 = time_kernels(torch, 2, two["obj"], two["state"],
                          two["state"].vel, two["obstacles"], two["frame_kw"],
                          two["frame_kw"])
    # Path L's 16-block K5 and K8 a frame, from its start state.
    lobj, lstate, lobs = two["l"]
    lblk = lobj.blocking
    largs = (lblk, lstate.pos, lstate.vel)
    lcirc = (lobj.mass, lobs.centers, lobs.radii)
    for name, kernel, key in (
        ("blocked_frame", lambda: frame_kernels.fused_blocked_frame(
            *largs, lstate.vel_g, *lcirc, preconditioned=True,
            **two["l_kw"]["implicit"]), "blocked_frame_kernel"),
        ("explicit_frame", lambda: frame_kernels.fused_explicit_frame(
            *largs, *lcirc, **two["l_kw"]["explicit"]),
         "explicit_frame_kernel"),
    ):
        ms = kernel_ms(torch, kernel, FRAMES_L, [key])
        times2[name]["ms_40_subdivisions"] = ms
        log(f"[time] 2D {name} at 40 subdivisions ({lblk.num_blocks} "
            f"blocks): {ms:.5f} ms a frame on the device (profiler); card "
            f"{card}")

    kernels = (kernel_rows(3, times3, launches3, errors3, card)
               + kernel_rows(2, times2, two["launches"], two["errors"], card))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
