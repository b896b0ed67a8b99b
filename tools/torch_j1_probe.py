# coding=utf-8
"""Where J1's level variant spends a solve, on the card.

Runs J1 (``fem_tpu_torch/ops/jacobi_kernels.jacobi_serial``, the level
variant) on two systems that ``chip_smoke.py`` section 53 checks — the
flagship deformed (``configs/demo_spot.json``, 1,007 rows, 70 levels) and
``configs/demo_passage_jacobi.json`` squashed and moving (121 rows, 20
levels) — with the kernel's SM clocks on (``clocks=``): its set-up, its
error passes, its sweeps, and warp 0's clocks at its rows and at the level
barriers (warp 0 takes a row in every level).  The clocks are turned into
microseconds by the solve's own device time (CUDA events over repeated
solves, the clocks off), and each solve's total is checked against it.
Also times the serial variant of the same solve.  Prints one JSON line and
the card's name and power limit.

    python3 tools/torch_j1_probe.py
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 20


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError) as e:
        return f"nvidia-smi failed: {e}"


def event_ms(torch, fn, reps=REPS):
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


def systems(torch, np):
    """{label: (sparse args of J1)}: one substep's system at each state."""
    from fem_tpu_torch import entry
    from fem_tpu_torch.ops import element_kernels
    from fem_tpu_torch.ops.assembly import element_contrib_full, gather_assemble
    from fem_tpu_torch.solvers import implicit

    def system(obj, state, dt, seed):
        K, H = element_kernels.hessian_and_force(
            state.pos, obj.element_indices, obj.ref_inv, obj.volume, obj.mu,
            obj.s_lambda)
        f = gather_assemble(element_contrib_full(H), obj.plan.idx)
        b = (state.vel + dt * f / obj.mass[:, None]).contiguous()
        rows = implicit.sparse_system_rows(obj, K, dt).contiguous()
        rng = np.random.default_rng(seed)
        past = torch.as_tensor(rng.normal(scale=0.01, size=tuple(b.shape))
                               .astype(np.float32), device="cuda")
        return rows, b, past, obj.jacobi_nb

    cfg_f, obj_f, state_f, _ = entry.flagship(
        "cuda", sim_overrides=dict(implicit_method=0))
    cfg_p, obj_p, state_p, _ = entry.load_config(
        os.path.join(REPO, "configs", "demo_passage_jacobi.json"), "cuda")
    rng = np.random.default_rng(3)
    c = state_p.pos.mean(dim=0, keepdim=True)
    pos = c + (state_p.pos - c) * torch.tensor([[1.1, 0.8]], device="cuda")
    vel = torch.as_tensor(rng.uniform(-0.3, 0.3, tuple(pos.shape))
                          .astype(np.float32), device="cuda")
    squashed = state_p.replace(pos=pos.contiguous(), vel=vel)
    return {
        "flagship": system(obj_f, entry.deformed(state_f),
                           cfg_f.delta_time, 6),
        "passage": system(obj_p, squashed, cfg_p.delta_time, 5),
    }


def probe(torch, jk, args):
    clocks = torch.zeros(5, dtype=torch.int64, device="cuda")
    res = jk.jacobi_serial(*args, clocks=clocks)
    plan = jk.jacobi_serial.last_plan
    plain = jk.jacobi_serial(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(res, plain)):
        raise SystemExit("J1 with its clocks on differs from J1 without")
    it = int(res.iterations)
    init, err, sweep, work, wait = (int(v) for v in clocks.tolist())
    ms = event_ms(torch, lambda: jk.jacobi_serial(*args))
    serial_ms = event_ms(torch,
                         lambda: jk.jacobi_serial(*args, variant="serial"))
    total = init + err + sweep
    per_us = total / (1e3 * ms)  # clocks a microsecond, from this solve
    levels = plan.levels
    n = args[1].shape[0]
    us = lambda c: c / per_us  # noqa: E731
    return dict(
        rows=n, levels=levels, sweeps=it, staged=plan.staged,
        solve_ms=ms, serial_solve_ms=serial_ms,
        clocks_per_us=per_us,
        setup_us=us(init), error_us_per_pass=us(err) / (it + 1),
        sweep_us=us(sweep) / it, level_us=us(sweep) / (it * levels),
        warp0_row_us_per_level=us(work) / (it * levels),
        warp0_barrier_wait_us_per_level=us(wait) / (it * levels),
        serial_us_per_row=1e3 * serial_ms / (it * n),
        clocks=dict(setup=init, error=err, sweeps=sweep, warp0_rows=work,
                    warp0_barriers=wait))


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_j1_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import fem_tpu_torch  # noqa: F401  (precision pins)
    from fem_tpu_torch.ops import jacobi_kernels as jk

    out = {name: probe(torch, jk, args)
           for name, args in systems(torch, np).items()}
    for name, r in out.items():
        print(f"[J1 probe] {name}: {r['sweeps']} sweeps of {r['levels']} "
              f"levels; solve {r['solve_ms']:.5f} ms (serial variant "
              f"{r['serial_solve_ms']:.5f}); set-up {r['setup_us']:.2f} us, "
              f"an error pass {r['error_us_per_pass']:.2f} us, a sweep "
              f"{r['sweep_us']:.2f} us = {r['level_us']:.4f} us a level, of "
              f"which warp 0's row {r['warp0_row_us_per_level']:.4f} us and "
              f"its wait at the barrier "
              f"{r['warp0_barrier_wait_us_per_level']:.4f} us; the serial "
              f"variant {r['serial_us_per_row']:.4f} us a row")
    print(json.dumps({"j1_probe": out}))
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
