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
15. where a path-A and a path-D frame's device time goes and the device's
    busy share, from one window of 30 frames under torch.profiler each,
    beside the same for the op-composed K1 + K4 frame; each kernel's device
    time per launch (profiler; the run fails if it sees no launch of it),
    its plain version's time (CUDA events), the least time the card could
    take (bound) and, for K3 and K7a, one PyTorch sparse product (library
    yardstick), printed as one ``kernels`` JSON line.

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

# NVIDIA H100 SXM data sheet (dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# f32 operations per tet of the element chain (F, det, F⁻¹, the K and rhs
# products, logs, scaling), counted from the formulas in element_chain.cuh.
K1_OPS_PER_TET = 430
# f32 operations per tet of one G(K)·x apply: edge differences, three 3×3
# products, the vertex-0 sum.
APPLY_OPS_PER_TET = 72
# f32 operations per tet of the explicit gradient chain (edge differences,
# F, det, F⁻¹, the log, P, P·R⁻ᵀ, the +V scaling), counted from
# nh_grad_cols in element_chain.cuh.
GRAD_OPS_PER_TET = 200
# f32 operations per tet of its contribution rows and local slot sums, and
# per particle of the explicit kinematic step (one circle).
ROWS_OPS_PER_TET = 24
KINEMATIC_OPS = 40


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
    """max |got − ref| / max|ref_e|, over the 3×3 blocks e (padded blocks,
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


def cg_ops(e, n, iterations, normal):
    """f32 operations of one whole-solve call with ``iterations`` CG
    iterations: 72 per tet per G apply (edge differences, three 3×3
    products, the vertex-0 sum, the 12 gathered rows) plus the per-unknown
    vector work."""
    g_apply = APPLY_OPS_PER_TET * e
    apply_a = g_apply + 9 * n
    apply_at = g_apply + 12 * n
    op = apply_a + apply_at if normal else apply_a
    setup = 12 * e + 9 * n + (apply_at if normal else 0) + op + 9 * n
    return setup + iterations * (op + 30 * n)


def frame_ops(e, n, slot_rows, iterations, normal):
    """f32 operations of one whole frame whose substeps took
    ``iterations``: per substep the chain and force rows, the rhs, the
    applies of its CG (each a G(K)·x, its slot sums and its vector work), the
    CG's vector work and the advection."""
    apply = APPLY_OPS_PER_TET * e + 3 * slot_rows + 12 * n
    total = 0
    for it in iterations:
        applies = 3 + 2 * it if normal else 1 + it
        total += ((K1_OPS_PER_TET + 12) * e + 3 * slot_rows + 12 * n
                  + applies * apply + it * 30 * n + 40 * n)
    return total


def explicit_frame_ops(e, n, slot_rows, sim_count):
    """f32 operations of one explicit frame: per substep the gradient chain
    and rows of every tet, the slot sums and the kinematic step."""
    return sim_count * ((GRAD_OPS_PER_TET + ROWS_OPS_PER_TET) * e
                        + 3 * slot_rows + KINEMATIC_OPS * n)


def incidence_matrix(torch, blk, n):
    """The (N × 3·B·Eb) ±1 incidence matrix of the blocked assembly as CSR:
    column 3·s + j (column j of element slot s) carries +1 to the slot's
    vertex j+1 and −1 to its vertex 0; padded slots have no entries."""
    import warnings

    warnings.filterwarnings("ignore", "Sparse CSR tensor support is in beta")
    real = blk.volume > 0
    slots = torch.nonzero(real).reshape(-1)
    idx = blk.element_indices[slots].long()
    cols = (3 * slots[:, None] + torch.arange(3, device=slots.device)).reshape(-1)
    rows = torch.cat([idx[:, 1:].reshape(-1), idx[:, :1].expand(-1, 3).reshape(-1)])
    vals = torch.cat([torch.ones(cols.numel(), device=slots.device),
                      -torch.ones(cols.numel(), device=slots.device)])
    coo = torch.sparse_coo_tensor(
        torch.stack([rows, torch.cat([cols, cols])]), vals,
        (n, 3 * blk.volume.numel()),
    ).coalesce()
    return coo.to_sparse_csr()


def bound(nbytes_, ops):
    """(bound ms, what bounds it) from bytes moved and f32 operations."""
    t_bytes = nbytes_ / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def graph_matrix(torch, element_indices, K, n):
    """G(K) as a (3N × 3N) CSR matrix: per tet, +K_e on (v_j, v_j) and
    −K_e on (v_j, v_0) and (v_0, v_j) for j = 1..3, +3·K_e on (v_0, v_0)
    (the element-Laplacian pattern of the port's operator)."""
    import warnings

    warnings.filterwarnings("ignore", "Sparse CSR tensor support is in beta")
    torch.sparse.check_sparse_tensor_invariants.disable()
    idx = element_indices.long()
    v0 = idx[:, 0]
    rows, cols, vals = [], [], []
    blocks = [(idx[:, j], idx[:, j], K) for j in (1, 2, 3)]
    blocks += [(idx[:, j], v0, -K) for j in (1, 2, 3)]
    blocks += [(v0, idx[:, j], -K) for j in (1, 2, 3)]
    blocks.append((v0, v0, 3.0 * K))
    ar = torch.arange(3, device=K.device)
    for a, b, k in blocks:
        rows.append((3 * a[:, None, None] + ar[None, :, None]).expand(-1, 3, 3))
        cols.append((3 * b[:, None, None] + ar[None, None, :]).expand(-1, 3, 3))
        vals.append(k)
    coo = torch.sparse_coo_tensor(
        torch.stack([torch.cat(rows).reshape(-1), torch.cat(cols).reshape(-1)]),
        torch.cat(vals).reshape(-1), (3 * n, 3 * n),
    ).coalesce()
    return coo.to_sparse_csr()


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

    # -- 15. times and bounds -----------------------------------------------
    def run_frames(frame_fn, start=state):
        def go():
            s = start
            for _ in range(FRAMES):
                s, _ = frame_fn(s, obstacles)
        return go

    # The op-composed K1 + K4 frame ("graph" is not eligible for K5).
    frame_k14 = sim.make_frame_fn(
        obj, dataclasses.replace(cfg, operator_mode="graph"))
    frame_device_ms = {}
    for label, go in (("path A (K5)", run_frames(frame)),
                      ("op-composed K1 + K4", run_frames(frame_k14)),
                      ("path D (K8)", run_frames(frame_d, estate))):
        per_window, prof_wall = profile_kernels(torch, go, 1)
        dev_ms = sum(t for t, _ in per_window.values()) / FRAMES
        frame_device_ms[label] = dev_ms
        log(f"[profile] {label}: {FRAMES} frames under the profiler: device "
            f"time {dev_ms:.4f} ms/frame of {prof_wall / FRAMES:.4f} ms/frame "
            f"wall in the same window: device busy "
            f"{100 * dev_ms * FRAMES / prof_wall:.1f}%")
        top = sorted(per_window.items(), key=lambda kv: -kv[1][0])[:6]
        for key, (total, count) in top:
            log(f"[profile]   {total / FRAMES:9.4f} ms/frame  "
                f"{count / FRAMES:6.1f} launches/frame  {key[:80]}")

    # K1
    def k1():
        return element_kernels.hessian_and_force(*k1_args)

    k1_ms = kernel_ms(torch, k1, 200, ["hessian_and_force_kernel"])
    k1_plain_ms = cuda_ms(
        torch, lambda: element_kernels.hessian_and_force_plain(*k1_args), 20)
    k1_bound, k1_by = bound(
        nbytes(state.pos, obj.element_indices, obj.ref_inv, obj.volume, K, H),
        K1_OPS_PER_TET * e)

    # K4
    solve = (K, H, obj.element_indices, obj.plan, state.vel, obj.mass,
             cfg.delta_time, True)
    k4_iters = int(cg_kernels.fused_cg_solve(*solve)[1])
    k4_ms = kernel_ms(torch, lambda: cg_kernels.fused_cg_solve(*solve), 100,
                      ["fused_cg_kernel"])
    k4_plain_ms = cuda_ms(
        torch, lambda: cg_kernels.fused_cg_solve_plain(*solve), 5)
    k4_bound, k4_by = bound(
        nbytes(K, H, obj.element_indices, obj.plan.ptr, obj.plan.rows,
               state.vel, obj.mass, state.vel) + 8,
        cg_ops(e, n, k4_iters, True))

    # K2
    tables = (blk.block_particles, blk.plus, blk.minus, blk.block_elements,
              blk.local_ptr, blk.local_rows)
    k2_ms = kernel_ms(torch, lambda: blocked_kernels.blocked_prep(*k2_args),
                      200, ["blocked_prep_kernel"])
    k2_plain_ms = cuda_ms(
        torch, lambda: blocked_kernels.blocked_prep_plain(*k2_args), 20)
    k2_bound, k2_by = bound(
        nbytes(state.pos, blk.ref_inv, blk.volume, *tables, Kb, part),
        K1_OPS_PER_TET * e)

    # K3
    k3_args = (blk, Kb, noisy, False)
    y = blocked_kernels.blocked_graph_apply(*k3_args)
    k3_ms = kernel_ms(
        torch, lambda: blocked_kernels.blocked_graph_apply(*k3_args), 200,
        ["blocked_matvec_kernel", "slot_sum_kernel"])
    k3_plain_ms = cuda_ms(
        torch, lambda: blocked_kernels.blocked_graph_apply_plain(*k3_args), 20)
    slot_rows = blk.slot_plan.rows.numel()
    k3_bound, k3_by = bound(
        nbytes(Kb, noisy, *tables, blk.slot_plan.ptr, blk.slot_plan.rows,
               part, y),
        APPLY_OPS_PER_TET * e + 3 * slot_rows)
    gmat = graph_matrix(torch, obj.element_indices, K, n)
    xcol = noisy.reshape(-1, 1)
    lib_y = torch.sparse.mm(gmat, xcol).reshape(n, 3)
    # The same function: G(K) in element order equals G(K) in block order.
    lib_err = float((lib_y - y).abs().max())
    log(f"[K3] torch.sparse.mm of the assembled G(K) vs K3: max abs "
        f"difference {lib_err:.3e} of max {float(y.abs().max()):.3e}")
    require(lib_err <= 1e-4 * float(y.abs().max()), "library G(K)·x differs")
    k3_lib_ms = cuda_ms(torch, lambda: torch.sparse.mm(gmat, xcol), 200)

    # K5
    k5_args = (blk, state.pos, state.vel, state.vel_g, obj.mass,
               obstacles.centers, obstacles.radii)
    k5_out = frame_kernels.fused_blocked_frame(
        *k5_args, preconditioned=True, **frame_kw)
    k5_iters = k5_out[3].tolist()
    k5_ms = kernel_ms(
        torch, lambda: frame_kernels.fused_blocked_frame(
            *k5_args, preconditioned=True, **frame_kw),
        FRAMES, ["blocked_frame_kernel"])
    k5_plain_ms = cuda_ms(
        torch, lambda: frame_kernels.fused_blocked_frame_plain(
            *k5_args, preconditioned=True, **frame_kw), 3)
    k5_bound, k5_by = bound(
        nbytes(blk.ref_inv, blk.volume, *tables, blk.slot_plan.ptr,
               blk.slot_plan.rows, obj.mass, obstacles.centers,
               obstacles.radii, state.pos, state.vel, state.vel_g, *k5_out),
        frame_ops(e, n, slot_rows, k5_iters, True))

    # K6
    k6_ms = kernel_ms(torch, lambda: element_kernels.explicit_grad_columns(
        *k6_args), 200, ["explicit_grad_columns_kernel"])
    k6_plain_ms = cuda_ms(
        torch, lambda: element_kernels.explicit_grad_columns_plain(*k6_args),
        20)
    k6_bound, k6_by = bound(
        nbytes(state.pos, obj.element_indices, obj.ref_inv, obj.volume, G),
        GRAD_OPS_PER_TET * e)

    # K7b
    k7b_ms = kernel_ms(torch, lambda: blocked_kernels.blocked_grad_prep(
        *k7b_args), 200, ["blocked_grad_prep_kernel"])
    k7b_plain_ms = cuda_ms(
        torch, lambda: blocked_kernels.blocked_grad_prep_plain(*k7b_args), 20)
    k7b_bound, k7b_by = bound(
        nbytes(state.pos, blk.ref_inv, blk.volume, *tables, gpart),
        (GRAD_OPS_PER_TET + ROWS_OPS_PER_TET) * e)

    # K7a, and one sparse product of the assembled ±1 incidence matrix with
    # the same columns as its yardstick (assembled outside the timing).
    k7a_ms = kernel_ms(torch, lambda: blocked_kernels.blocked_assemble(
        blk, bcols), 200, ["blocked_assemble_kernel", "slot_sum_kernel"])
    k7a_plain_ms = cuda_ms(
        torch, lambda: blocked_kernels.blocked_assemble_plain(blk, bcols), 20)
    k7a_bound, k7a_by = bound(
        nbytes(bcols, blk.block_elements, blk.local_ptr, blk.local_rows,
               blk.slot_plan.ptr, blk.slot_plan.rows, ysum),
        ROWS_OPS_PER_TET * e + 3 * slot_rows)
    smat = incidence_matrix(torch, blk, n)
    ccol = bcols.transpose(1, 2).reshape(-1, 3).contiguous()
    lib_sum = torch.sparse.mm(smat, ccol)
    lib_err7 = float((lib_sum - ysum).abs().max())
    log(f"[K7a] torch.sparse.mm of the incidence matrix vs K7a: max abs "
        f"difference {lib_err7:.3e} of max {float(ysum.abs().max()):.3e}")
    require(lib_err7 <= 1e-4 * float(ysum.abs().max()),
            "library assembly differs")
    k7a_lib_ms = cuda_ms(torch, lambda: torch.sparse.mm(smat, ccol), 200)

    # K8, a flagship frame from the deformed state
    k8_args = (blk, state.pos, state.vel, obj.mass, obstacles.centers,
               obstacles.radii)
    k8_out = frame_kernels.fused_explicit_frame(*k8_args, **ekw)
    k8_ms = kernel_ms(
        torch, lambda: frame_kernels.fused_explicit_frame(*k8_args, **ekw),
        FRAMES, ["explicit_frame_kernel"])
    k8_plain_ms = cuda_ms(
        torch, lambda: frame_kernels.fused_explicit_frame_plain(
            *k8_args, **ekw), 5)
    k8_bound, k8_by = bound(
        nbytes(blk.ref_inv, blk.volume, *tables, blk.slot_plan.ptr,
               blk.slot_plan.rows, obj.mass, obstacles.centers,
               obstacles.radii, state.pos, state.vel, *k8_out),
        explicit_frame_ops(e, n, slot_rows, ecfg.sim_count))

    for name, ms, plain, bnd, by, extra in (
        ("K1", k1_ms, k1_plain_ms, k1_bound, k1_by, ""),
        ("K4", k4_ms, k4_plain_ms, k4_bound, k4_by, f" at {k4_iters} it."),
        ("K2", k2_ms, k2_plain_ms, k2_bound, k2_by, ""),
        ("K3", k3_ms, k3_plain_ms, k3_bound, k3_by,
         f"; torch.sparse.mm {k3_lib_ms:.5f} ms"),
        ("K5", k5_ms, k5_plain_ms, k5_bound, k5_by,
         f" a frame at iterations {k5_iters}"),
        ("K6", k6_ms, k6_plain_ms, k6_bound, k6_by, ""),
        ("K7a", k7a_ms, k7a_plain_ms, k7a_bound, k7a_by,
         f"; torch.sparse.mm {k7a_lib_ms:.5f} ms"),
        ("K7b", k7b_ms, k7b_plain_ms, k7b_bound, k7b_by, ""),
        ("K8", k8_ms, k8_plain_ms, k8_bound, k8_by, " a frame"),
    ):
        log(f"[time] {name} {ms:.5f} ms a launch on the device (profiler)"
            f"{extra}; plain {plain:.4f} ms; bound {bnd:.6f} ms ({by}); "
            f"card {card}")

    def row(name, source, replaces, launches, err, ms, plain, bnd, by, lib,
            **extra):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches, max_abs_err=err, ms=ms, plain_ms=plain,
                    bound_ms=bnd, bound_by=by, library_ms=lib, **extra)

    kernels = [
        row("element_chain", "fem_tpu_torch/csrc/element_chain.cu",
            "fem_tpu/ops/pallas_kernels.py:555", launches_c["element_chain"],
            k1_abs, k1_ms, k1_plain_ms, k1_bound, k1_by, None),
        row("fused_cg", "fem_tpu_torch/csrc/fused_cg.cu",
            "fem_tpu/ops/pallas_blocked_cg.py:348", launches_c["fused_cg"],
            k4_abs, k4_ms, k4_plain_ms, k4_bound, k4_by, None,
            iterations=k4_iters),
        row("blocked_prep", "fem_tpu_torch/csrc/blocked.cu",
            "fem_tpu/ops/blocking.py:513", launches_b["blocked_prep"],
            k2_abs, k2_ms, k2_plain_ms, k2_bound, k2_by, None),
        row("blocked_matvec", "fem_tpu_torch/csrc/blocked.cu",
            "fem_tpu/ops/blocking.py:429", launches_b["blocked_matvec"],
            k3_abs, k3_ms, k3_plain_ms, k3_bound, k3_by, k3_lib_ms),
        row("blocked_frame", "fem_tpu_torch/csrc/blocked_frame.cu",
            "fem_tpu/ops/pallas_blocked_frame.py:547",
            launches_a["blocked_frame"], k5_abs, k5_ms, k5_plain_ms,
            k5_bound, k5_by, None, iterations=k5_iters),
        row("grad_columns", "fem_tpu_torch/csrc/element_chain.cu",
            "fem_tpu/ops/pallas_kernels.py:677", launches_g["grad_columns"],
            k6_abs, k6_ms, k6_plain_ms, k6_bound, k6_by, None),
        row("blocked_assemble", "fem_tpu_torch/csrc/blocked.cu",
            "fem_tpu/ops/blocking.py:450", launches_f["blocked_assemble"],
            k7a_abs, k7a_ms, k7a_plain_ms, k7a_bound, k7a_by, k7a_lib_ms),
        row("blocked_grad_prep", "fem_tpu_torch/csrc/blocked.cu",
            "fem_tpu/ops/blocking.py:513", launches_e["blocked_grad_prep"],
            k7b_abs, k7b_ms, k7b_plain_ms, k7b_bound, k7b_by, None),
        row("explicit_frame", "fem_tpu_torch/csrc/explicit_frame.cu",
            "fem_tpu/ops/pallas_blocked_frame.py:936",
            launches_d["explicit_frame"], k8_abs, k8_ms, k8_plain_ms,
            k8_bound, k8_by, None),
    ]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
