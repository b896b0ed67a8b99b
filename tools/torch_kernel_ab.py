#!/usr/bin/env python3
# coding=utf-8
"""Times P1, P2, K11b, K5's frame, K4, K11a, K3, K2, K7b, K7a, K7b edges, K8,
K1, K9b, K9a, K6, K10a and K10b of one checkout on one GPU, hashes their
outputs, and measures the host time of K3's, K2's, K7b's, K7a's, K1's,
K9b's, K9a's, K6's, K10a's and K10b's and of the explicit frames'
wrappers, so that two checkouts can be compared on the same card.

    python3 tools/torch_kernel_ab.py [--repo PATH] [--label NAME]
                                     [--advect-only | --p1-only]

``--repo`` imports ``fem_tpu_torch`` (and its ``chip_smoke.py``'s profiler
helpers) from another checkout, for instance the parent commit unpacked
with ``git archive``; by default this one.  On the flagship
(``configs/demo_spot.json``, deformed state) and ``configs/default.json``'s
``implicit_cg`` variant (squeezed state), both with normal equations:
K11b's frame (``fused_frame``, the checkout's own plan; its outputs'
sha256) and K5's frame (``fused_blocked_frame``), K4's solve
(``fused_cg_solve``, the checkout's own plan, and its single variant where
the checkout has one) and K11a's (``cg_solve_edge``, the checkout's own
plan, and its single variant where the checkout has one) at the scene's K
and b, with their outputs' sha256; K3's apply (``blocked_graph_apply``,
both transposes, the checkout's own plan and its two-kernel variant, where
the checkout has one) at K2's K and the scene's velocities, with its
output's sha256 and the host's enqueue µs an apply (1,000 applies before a
sync); K2 and K7b as the substep takes them — a checkout with
``blocked_prep_force`` its one launch (its plan and the grid variant),
every checkout also the partials form followed by PyTorch's slot sum
("parent form") — K7a's assembly of the gradient's block-ordered columns
(each variant) and K7b edges, each with the device ms of a call (every kernel it launches, profiler),
the enqueue µs a call (1,000 calls before a sync) and its outputs'
sha256; K1 and K6 (Neo-Hookean; in 3D also each material instance, and
K1's robust Neo-Hookean), K9b and K9a at the scene's state, each with its
device ms a launch, its outputs' sha256 and its plan, the Neo-Hookean
ones with the enqueue µs a call (1,000 calls before a sync), and K1, K9b,
K9a and K6 at 200-4,068 elements cut from the flagship and from the
40-subdivision grid, each on the checkout's own CTAs;
K5's frame with its outputs' sha256; K8's frame (``fused_explicit_frame``, the
checkout's own plan) on the explicit flagship, ``default.json``, its
40-subdivision grid and ``demo_plastic.json``'s plastic body, and on the
flagship with both inelastic branches; and P2's three variants at the
probe's defaults (rows 6, n 1,024, cols 2,048, 200 reps).  K10a and
K10b (``kinematic``, ``advect_implicit``) on both scenes, on
``chip_smoke.py``'s section-34 operands (three circles, one of radius 0):
device ms a launch, the byte bound, the plan, the outputs' sha256 and the
enqueue µs a call (1,000 calls before a sync, five batches); and at
121-1,048,576 particles (``ADVECT_SIZES``), 2D and 3D, in the checkout's
own plan, with operand sets rotated over 256 MB at the large sizes so that no launch
finds them in L2: device ms a launch, the byte bound and the outputs'
sha256.  ``--advect-only`` runs K11b, K10a and K10b alone.  ``--p1-only``
runs P1 alone (``paired_matvec``, pairs 1, 2 and 4) on the flagship
deformed and on the probe's default body (``assets/spot.obj`` meshed at
spacing 0.04: 68,508 tets, 270 blocks, at rest), K from the plain
``hessian_blocks`` on the CPU and x the positions plus seeded noise:
device ms a launch (operand sets — K planes, block vectors and the
tables the kernel reads — rotated over 256 MB at 270 blocks), the byte
bound, the plan and the launch as the checkout reports them, the enqueue
µs a call (1,000 calls before a sync, five batches) and the output's
sha256; per body the plain version's ms (CUDA events) and
``torch.sparse.mm``'s device ms (``library_ms``).  Device ms a
launch from the profiler (``chip_smoke.kernel_ms``, 20 launches a
window; 50 for the element and advection kernels).  Then the explicit paths D (the explicit flagship), H
(``default.json`` as shipped) and M (``demo_plastic.json``, both bodies)
through ``sim.make_frame_fn``: wall ms a frame over 200 frames ending in a
sync, the host's enqueue µs a frame (the same frames' calls, before that
sync) and device ms a frame (one profiled window of the same frames), and
host µs a frame as wall minus device.  Then path C (``entry.entry``: K1
and K4 a substep), timed as ``chip_smoke.py`` times it — steps/s over 10
substeps ending in a sync and a fetch of the CG iterations, after a
warm-up substep — five times, and over 100 substeps twice.  Then the
op-composed substeps that
run K2, K7b and K7a — B (``operator_mode="blocked"``), E (explicit,
``element_backend="auto"``), F (``auto_diff`` and ``"xla"``) — on the
flagship deformed and ``default.json`` squeezed, 10 substeps: device ms
and kernel launches a substep (one profiled window, every kernel) and
wall ms a substep ending in a sync.  Prints one JSON line per
measurement, each with the label, and the card's name and power limit.
Run two checkouts in turns (A, B, B, A) in one call to compare them.
"""


import argparse
import dataclasses
import hashlib
import itertools
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def time_explicit(torch, cs, dev, emit, digest):
    """K8's frames and the explicit paths' host time (module docstring)."""
    from fem_tpu_torch import entry, scene, sim
    from fem_tpu_torch.ops import frame_kernels as fk
    from fem_tpu_torch.utils.config import read_config

    ecfg, eobj, estate, eobs = entry.explicit_flagship(dev)

    def kw_of(cfg, o):
        return dict(dt=cfg.delta_time, damping=o.damping,
                    g_dir=tuple(cfg.g_dir), mu=o.mu, s_lambda=o.s_lambda,
                    sim_count=cfg.sim_count, material=o.material)

    dcfg = read_config(os.path.join(REPO, "configs", "default.json"))
    (dbody,), dobs = scene.load_scene(dcfg, device=dev)
    lcfg = dataclasses.replace(dcfg, objects=(dataclasses.replace(
        dcfg.objects[0], subdivisions=40),))
    (lbody,), lobs = scene.load_scene(lcfg, device=dev)
    pcfg = read_config(os.path.join(REPO, "configs", "demo_plastic.json"))
    pbodies, pobs = scene.load_scene(pcfg, device=dev)
    eye = torch.eye(3, device=dev).repeat(eobj.element_cnt, 1, 1)
    p0 = pbodies[0]
    cases = (
        ("flagship", eobj, estate, eobs, kw_of(ecfg, eobj)),
        ("default.json", dbody.obj, dbody.state, dobs,
         kw_of(dcfg, dbody.obj)),
        ("40 subdivisions", lbody.obj, lbody.state, lobs,
         dict(kw_of(dcfg, lbody.obj), dt=1e-4)),
        ("demo_plastic.json body 0", p0.obj, p0.state, pobs,
         dict(kw_of(pcfg, p0.obj), plastic_inv=p0.state.plastic_inv,
              plastic_yield=p0.obj.plastic_yield)),
        ("flagship, both branches", eobj, estate, eobs,
         dict(kw_of(ecfg, eobj), plastic_inv=eye, plastic_yield=0.01,
              viscous_inv=eye, viscous_mu=200.0)),
    )
    for label, o, st, ob, kw in cases:
        args = (o.blocking, st.pos, st.vel, o.mass, ob.centers, ob.radii)
        out = fk.fused_explicit_frame(*args, **kw)
        ms = cs.kernel_ms(torch, lambda: fk.fused_explicit_frame(*args, **kw),
                          20, ["explicit_frame_kernel"])
        barriers = getattr(fk.fused_explicit_frame, "last_barriers", None)
        emit(kernel="K8", scene=label, ms=ms,
             plan=str(getattr(fk.fused_explicit_frame, "last_plan", None)),
             barriers=None if barriers is None else int(barriers.item()),
             sha256=digest(*out))
    frames = 200
    paths = (("D", ecfg, [(sim.make_frame_fn(eobj, ecfg), estate)], eobs),
             ("H", dcfg, [(sim.make_frame_fn(dbody.obj, dcfg), dbody.state)],
              dobs),
             ("M", pcfg, [(sim.make_frame_fn(b.obj, pcfg), b.state)
                          for b in pbodies], pobs))
    for label, cfg, bodies, ob in paths:
        def go():
            states = [s for _, s in bodies]
            for _ in range(frames):
                states = [f(s, ob)[0] for (f, _), s in zip(bodies, states)]
            return states

        go()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        go()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        per_kernel, _ = cs.profile_kernels(torch, go, 1)
        device_ms = sum(t for t, _ in per_kernel.values()) / frames
        wall_ms = (t2 - t0) * 1e3 / frames
        # A step advances every body of the scene.
        emit(path=label, frames=frames, bodies=len(bodies), wall_ms=wall_ms,
             enqueue_us=(t1 - t0) * 1e6 / frames, device_ms=device_ms,
             host_us=(wall_ms - device_ms) * 1e3, busy=device_ms / wall_ms,
             steps_per_s=frames * cfg.sim_count / (t2 - t0))


# The profiler's names of the element kernels, matched as substrings so
# that a checkout whose kernels carry no ``tiled_`` prefix (K6 and K9a
# before they ran in tiles) is timed too.
ELEMENT_KERNELS = dict(K1="hessian_and_force_kernel",
                       K9b="implicit_force_kernel",
                       K9a="hessian_blocks_kernel",
                       K6="explicit_grad_columns_kernel")


def time_elements(torch, cs, label, o, s, emit, digest):
    """K1, K9b, K9a and K6 on one scene (module docstring): device ms a
    launch, outputs' sha256, the plan, and the Neo-Hookean ones' enqueue
    µs a call; in 3D each of K1's and K6's material instances."""
    from fem_tpu_torch.ops import element_kernels as ek

    d = s.pos.shape[1]
    args = (s.pos, o.element_indices, o.ref_inv, o.volume, o.mu, o.s_lambda)
    k1, k6 = ek.hessian_and_force, ek.explicit_grad_columns
    cases = [("K1", "neo_hookean", {}, k1),
             ("K9b", "neo_hookean", {}, ek.implicit_force_columns),
             ("K9a", "neo_hookean", {}, ek.hessian_blocks),
             ("K6", "neo_hookean", {}, k6)]
    if d == 3:
        cases += [(k, m, dict(material=m), fn) for m in cs.MATERIALS[3]
                  for k, fn in (("K1", k1), ("K6", k6))]
        cases.append(("K1", "neo_hookean robust", dict(robust=True), k1))
    for kernel, material, opts, fn in cases:
        def call(fn=fn, opts=opts):
            return fn(*args, **opts)

        out = call()
        out = out if isinstance(out, tuple) else (out,)
        plan = getattr(fn, "last_plan", None)
        ms = cs.kernel_ms(torch, call, 50, [ELEMENT_KERNELS[kernel]])
        row = dict(kernel=kernel, scene=label, material=material, ms=ms,
                   plan=str(plan), sha256=digest(*out))
        if not opts:
            reps = 1000
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                call()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            row["enqueue_us"] = (t1 - t0) * 1e6 / reps
        emit(**row)


def time_element_sizes(torch, cs, dev, emit):
    """K1 (Neo-Hookean), K9b, K9a and K6 (Neo-Hookean) at element counts
    cut from the flagship (3D) and from ``default.json``'s square at 40
    subdivisions (2D, 3,200 triangles), on the checkout's own CTAs: device
    ms a launch."""
    from fem_tpu_torch import entry, scene
    from fem_tpu_torch.ops import element_kernels as ek
    from fem_tpu_torch.utils.config import read_config

    _, obj3, s3, _ = entry.flagship(dev)
    dcfg = read_config(os.path.join(REPO, "configs", "default.json"))
    lcfg = dataclasses.replace(dcfg, objects=(dataclasses.replace(
        dcfg.objects[0], subdivisions=40),))
    (lbody,), _ = scene.load_scene(lcfg, device=dev)
    for d, o, s, sizes in ((3, obj3, entry.deformed(s3),
                            (200, 512, 1024, 2048, 4068)),
                           (2, lbody.obj, lbody.state,
                            (200, 512, 1024, 2048, 3200))):
        for n in sizes:
            idx = torch.arange(n, device=dev) % o.element_cnt
            args = (s.pos, o.element_indices[idx].contiguous(),
                    o.ref_inv[idx].contiguous(), o.volume[idx].contiguous(),
                    o.mu, o.s_lambda)
            for kernel, fn in (("K1", ek.hessian_and_force),
                               ("K9b", ek.implicit_force_columns),
                               ("K9a", ek.hessian_blocks),
                               ("K6", ek.explicit_grad_columns)):
                def call(fn=fn):
                    return fn(*args)

                call()
                emit(kernel=kernel, sizes=True, dim=d, elements=n,
                     plan=str(getattr(fn, "last_plan", None)),
                     ms=cs.kernel_ms(torch, call, 50,
                                     [ELEMENT_KERNELS[kernel]]))


# The profiler's names of K10a and K10b, matched as substrings so that a
# checkout whose kernels carry no ``tiled_`` prefix is timed too.
ADVECT_KERNELS = dict(K10a="kinematic_kernel", K10b="advect_implicit_kernel")


def advect_calls(pos, vel, vel_g, grad, minv, circles, kw):
    """{kernel: (wrapper, its positional operands, the launch's bytes)} of
    K10a and K10b on one set of operands; the bytes each input read once
    and each output written once."""
    from fem_tpu_torch.ops import advect_kernels as ak

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    centers, radii = circles
    table = nbytes(centers, radii, kw["gravity"])
    return {
        "K10a": (ak.kinematic, (pos, vel, grad, minv, centers, radii),
                 nbytes(pos, vel, grad, minv) + table + 2 * nbytes(pos)),
        "K10b": (ak.advect_implicit, (pos, vel, vel_g, centers, radii),
                 nbytes(pos, vel, vel_g) + table + 3 * nbytes(pos))}


# Batches of 1,000 calls of the K10 enqueue timing (the host's spread).
ADVECT_ENQUEUE_BATCHES = 5


def time_advect(torch, cs, label, o, s, c, emit, digest):
    """K10a and K10b on one scene, on chip_smoke.py's section-34 operands
    (three circles over the body, one of radius 0): device ms a launch,
    outputs' sha256, the plan, and the enqueue µs a call (1,000 calls
    before a sync; the median of ADVECT_ENQUEUE_BATCHES batches, each
    batch's too)."""
    from fem_tpu_torch.solvers import advect, explicit

    d = s.pos.shape[1]
    gen = torch.Generator().manual_seed(11 + d)
    dev = s.pos.device
    vel = s.vel + 0.3 * torch.randn(s.vel.shape, generator=gen).to(dev)
    vel_g = 0.3 * torch.randn(s.vel.shape, generator=gen).to(dev)
    grad = explicit.analytic_energy_gradient(o, s.pos)
    kw = dict(dt=c.delta_time, decay=advect.damping_decay(c.delta_time,
                                                          o.damping),
              gravity=advect.gravity_vector(tuple(c.g_dir), dev))
    calls = advect_calls(s.pos, vel, vel_g, grad, 1.0 / o.mass,
                         cs.three_circles(torch, s.pos), kw)
    for kernel, (fn, args, nbytes) in calls.items():
        def call(fn=fn, args=args):
            return fn(*args, **kw)

        out = call()
        ms = cs.kernel_ms(torch, call, 50, [ADVECT_KERNELS[kernel]])
        reps, enqueue = 1000, []
        for _ in range(ADVECT_ENQUEUE_BATCHES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                call()
            enqueue.append((time.perf_counter() - t0) * 1e6 / reps)
        torch.cuda.synchronize()
        emit(kernel=kernel, scene=label, particles=s.pos.shape[0], ms=ms,
             bound_ms=nbytes / cs.PEAK_BYTES_PER_S * 1e3,
             plan=str(getattr(fn, "last_plan", None)),
             enqueue_us=sorted(enqueue)[len(enqueue) // 2],
             enqueue_batches_us=enqueue, sha256=digest(*out))


# Particle counts of the K10 sweep, and the bytes of one operand set from
# which the sweep rotates sets, over ADVECT_ROTATED bytes, so that no
# launch finds its inputs in the 50 MB L2.
ADVECT_SIZES = (121, 1007, 16384, 262144, 1048576)
ADVECT_ROTATE_FROM = 8 << 20
ADVECT_ROTATED = 256 << 20


def time_advect_sizes(torch, cs, dev, emit, digest):
    """K10a and K10b at ADVECT_SIZES particles, 2D and 3D, each in the
    checkout's own plan: device ms a launch,
    the byte bound, the outputs' sha256 (of operand set 0).  Operands from
    a seeded generator on the card: positions in and past the unit box, a
    third of them inside two of three circles (one of radius 0);
    velocities, gravity channel and gradient normal, m⁻¹ uniform.  Operand
    sets (pos, vel, vel_g, grad, m⁻¹) of ADVECT_ROTATE_FROM bytes or more
    are rotated over ADVECT_ROTATED bytes."""
    from fem_tpu_torch.solvers import advect

    for d in (3, 2):
        kw = dict(dt=5e-4, decay=advect.damping_decay(5e-4, 10.0),
                  gravity=advect.gravity_vector((0.0, -1.0, 0.0)[:d], dev))
        for n in ADVECT_SIZES:
            gen = torch.Generator(device=dev).manual_seed(n + d)

            def draw(*shape, scale=1.0, low=None, gen=gen):
                if low is None:
                    return scale * torch.randn(shape, generator=gen,
                                               device=dev)
                return low + (scale - low) * torch.rand(
                    shape, generator=gen, device=dev)

            centers = draw(3, d, scale=0.7, low=0.3)
            radii = torch.tensor([0.2, 0.15, 0.0], device=dev)

            def operands():
                pos = draw(n, d, scale=1.1, low=-0.1)
                inside = torch.arange(n, device=dev) % 3 == 0
                near = centers[torch.arange(n, device=dev) % 2] + draw(
                    n, d, scale=0.12, low=-0.12)
                pos = torch.where(inside[:, None], near, pos).contiguous()
                return advect_calls(
                    pos, draw(n, d, scale=0.5),
                    draw(n, d, scale=0.5), draw(n, d, scale=10.0),
                    draw(n, scale=2.0, low=0.5), (centers, radii), kw)

            set_bytes = 4 * n * (4 * d + 1)
            sets = [operands() for _ in range(
                1 if set_bytes < ADVECT_ROTATE_FROM
                else -(-ADVECT_ROTATED // set_bytes))]
            for kernel, (fn, args, nbytes) in sets[0].items():
                turn = itertools.count()

                def call(kernel=kernel, turn=turn):
                    f, a, _ = sets[next(turn) % len(sets)][kernel]
                    return f(*a, **kw)

                out = fn(*args, **kw)
                emit(kernel=kernel, sizes=True, dim=d, particles=n,
                     plan=str(getattr(fn, "last_plan", None)),
                     sets=len(sets),
                     ms=cs.kernel_ms(torch, call, 50,
                                     [ADVECT_KERNELS[kernel]]),
                     bound_ms=nbytes / cs.PEAK_BYTES_PER_S * 1e3,
                     sha256=digest(*out))
            del sets


def time_path_c(torch, cs, dev, emit):
    """Path C's steps/s (module docstring), each run on its own line."""
    from fem_tpu_torch import entry

    fn, (obj, state, obs) = entry.entry(dev)
    fn(obj, state, obs)
    torch.cuda.synchronize()
    for substeps, runs in ((cs.SUBSTEPS_C, 5), (100, 2)):
        for run in range(runs):
            t0 = time.perf_counter()
            s, iters = state, []
            for _ in range(substeps):
                s, aux = fn(obj, s, obs)
                iters.append(aux.solver_iterations)
            iters = torch.stack(iters).cpu()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            emit(path="C", substeps=substeps, run=run,
                 steps_per_s=substeps / wall,
                 iterations=int(iters.sum()))


def time_prep(torch, cs, label, o, s, emit, digest):
    """K2, K7b, K7a and K7b edges on one scene (module docstring)."""
    from fem_tpu_torch.ops import blocked_kernels as bk
    from fem_tpu_torch.ops import element_kernels as ek
    from fem_tpu_torch.ops.blocking import blocked_scatter_sum

    blk = o.blocking
    args = (blk, s.pos, o.mu, o.s_lambda)
    cols = ek.explicit_grad_columns_plain(
        s.pos, blk.element_indices, blk.ref_inv, blk.volume, o.mu,
        o.s_lambda)

    def prep_parent_form():
        k, part = bk.blocked_prep(*args)
        return k, blocked_scatter_sum(part, blk)

    def grad_parent_form():
        return blocked_scatter_sum(bk.blocked_grad_prep(*args), blk)

    counters = {"K2": bk.blocked_prep, "K7b": bk.blocked_grad_prep,
                "K7a": bk.blocked_assemble, "K7b edges": bk.blocked_edges}
    cases = [("K2", "parent form", prep_parent_form),
             ("K7b", "parent form", grad_parent_form),
             ("K7a", "plan", lambda: bk.blocked_assemble(blk, cols)),
             ("K7b edges", "plan", lambda: bk.blocked_edges(blk, s.pos))]
    if hasattr(bk, "blocked_prep_force"):
        for name, opts in (("plan", {}), ("grid", dict(grid=True))):
            cases += [
                ("K2", name, lambda opts=opts: bk.blocked_prep_force(
                    *args, **opts)),
                ("K7b", name, lambda opts=opts: bk.blocked_grad_force(
                    *args, **opts))]
            if name != "plan":
                cases.append(("K7a", name, lambda opts=opts: (
                    bk.blocked_assemble(blk, cols, **opts))))
    for kernel, name, fn in cases:
        out = fn()
        out = out if isinstance(out, tuple) else (out,)
        plan = getattr(counters[kernel], "last_plan", None)
        ms = cs.library_device_ms(torch, fn, 50)
        reps = 1000
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        emit(kernel=kernel, scene=label, launch=name, ms=ms,
             plan=str(plan), enqueue_us=(t1 - t0) * 1e6 / reps,
             sha256=digest(*out))


def time_op_paths(torch, cs, dev, emit):
    """The op-composed substeps that run K2, K7b or K7a (module docstring):
    device ms, kernel launches and wall ms a substep."""
    from fem_tpu_torch import entry, sim

    cfg, obj, s0, obs = entry.flagship(dev)
    dcfg, dobj, ds0, dobs = entry.load_config(
        os.path.join(REPO, "configs", "default.json"), dev,
        sim_overrides=cs.OVERRIDES_2D["implicit_cg"])
    ds = cs.squeezed_2d(torch, ds0, torch.Generator().manual_seed(7))
    settings = (("B (K2 + K3)", dict(operator_mode="blocked")),
                ("E (K7b)", dict(use_explicit_method=True, delta_time=1e-4,
                                 element_backend="auto")),
                ("F (auto_diff, K7a)", dict(use_explicit_method=True,
                                            delta_time=1e-4, auto_diff=True)),
                ("F (xla, K7a)", dict(use_explicit_method=True,
                                      delta_time=1e-4,
                                      element_backend="xla")))
    substeps = 10
    for dim, c, o, st, ob in ((3, cfg, obj, entry.deformed(s0), obs),
                              (2, dcfg, dobj, ds, dobs)):
        for label, over in settings:
            kw = sim.substep_kwargs(dataclasses.replace(c, **over))

            def go():
                s = st
                for _ in range(substeps):
                    s, _ = sim.substep(o, s, ob, **kw)
                return s

            go()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            go()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / substeps
            per_kernel, _ = cs.profile_kernels(torch, go, 1)
            emit(path=label, dim=dim, substeps=substeps,
                 device_ms=sum(t for t, _ in per_kernel.values()) / substeps,
                 launches=sum(n for _, n in per_kernel.values()) / substeps,
                 wall_ms=wall, steps_per_s=1e3 / wall)


# P1's probe body: assets/spot.obj at the probe's default spacing, with
# the object settings of probes/pairblock.py's main; its mesh is kept under
# build/ for the other runs of a call.  Operand sets of P1_ROTATE_FROM bytes
# or more are rotated over P1_ROTATED bytes.
P1_SPACING = 0.04
P1_OBJECT = dict(center=(2.0, 0.7, 2.0), rho=1000.0, E=4e4, nu=0.4,
                 damping=10.0)
P1_MESH = os.path.join(REPO, "build", f"p1_spot_{P1_SPACING}.npz")
P1_ROTATE_FROM = 4 << 20
P1_ROTATED = 256 << 20
# The blocking's tensors the kernel reads, cloned into each rotated set.
P1_TABLES = ("plus", "minus", "block_elements", "local_ptr", "local_rows")


def p1_bodies(torch, dev):
    """P1's bodies, each (label, object on the CPU, positions on the CPU,
    object on ``dev``): the flagship deformed and the probe's default body
    at rest."""
    import numpy as np

    from fem_tpu_torch import entry
    from fem_tpu_torch.models.mesh import load_object_mesh
    from fem_tpu_torch.models.state import build_object
    from fem_tpu_torch.utils.config import ObjectConfig

    _, fobj, fstate, _ = entry.flagship("cpu")
    _, fobj_dev, _, _ = entry.flagship(dev)
    ocfg = ObjectConfig(obj=os.path.join(REPO, "assets", "spot.obj"),
                        **P1_OBJECT)
    if os.path.exists(P1_MESH):
        with np.load(P1_MESH) as z:
            v, f, e = z["v"], z["f"], z["e"]
    else:
        v, f, e, _ = load_object_mesh(ocfg, P1_SPACING)
        os.makedirs(os.path.dirname(P1_MESH), exist_ok=True)
        np.savez(P1_MESH, v=v, f=f, e=e)
    sobj, sstate = build_object(ocfg, v, f, e, device="cpu")
    sobj_dev, _ = build_object(ocfg, v, f, e, device=dev)
    return (("flagship", fobj, entry.deformed(fstate).pos, fobj_dev),
            (f"spot {P1_SPACING}", sobj, sstate.pos, sobj_dev))


def p1_sets(cs, blk, kp, xbt):
    """[(blocking, K planes, block vectors)]: the operands, and clones of
    them over P1_ROTATED bytes when one set holds P1_ROTATE_FROM bytes or
    more."""
    one = cs.nbytes(kp, xbt, *(getattr(blk, n) for n in P1_TABLES))
    sets = [(blk, kp, xbt)]
    for _ in range(1, 1 if one < P1_ROTATE_FROM else -(-P1_ROTATED // one)):
        sets.append((dataclasses.replace(blk, **{
            n: getattr(blk, n).clone() for n in P1_TABLES}),
            kp.clone(), xbt.clone()))
    return sets


def time_p1(torch, cs, dev, emit, digest):
    """P1 on p1_bodies at every pair (module docstring)."""
    from fem_tpu_torch.ops import element_kernels as ek
    from fem_tpu_torch.probes import pairblock as p1

    for label, cobj, cpos, obj in p1_bodies(torch, dev):
        cblk, blk, d = cobj.blocking, obj.blocking, obj.dim
        K = ek.hessian_blocks(cpos, cblk.element_indices, cblk.ref_inv,
                              cblk.volume, cobj.mu, cobj.s_lambda)
        noise = torch.randn(cpos.shape, generator=torch.Generator()
                            .manual_seed(17))
        x = (cpos + 0.3 * noise).to(dev)
        kp = p1.make_kplane(cblk, K).to(dev)
        gmat = cs.graph_matrix(torch, obj.element_indices,
                               K.to(dev)[blk.element_slot.long()],
                               obj.particle_cnt)
        xcol = x.reshape(-1, 1)
        emit(kernel="P1 library", scene=label, blocks=blk.num_blocks,
             ms=cs.library_device_ms(
                 torch, lambda: torch.sparse.mm(gmat, xcol), 50))
        for pair in p1.PAIRS:
            bp, kpp, xb = p1.padded_inputs(blk, kp, x, pair)
            sets = p1_sets(cs, bp, kpp, xb)
            turn = itertools.count()

            def call(sets=sets, turn=turn, pair=pair):
                b, k, xs = sets[next(turn) % len(sets)]
                return p1.paired_matvec(b, k, xs, d, pair)

            out = p1.paired_matvec(bp, kpp, xb, d, pair)
            ms = cs.kernel_ms(torch, call, 50, ["paired_matvec_kernel"])
            reps, enqueue = 1000, []
            for _ in range(ADVECT_ENQUEUE_BATCHES):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    p1.paired_matvec(bp, kpp, xb, d, pair)
                enqueue.append((time.perf_counter() - t0) * 1e6 / reps)
            torch.cuda.synchronize()
            launch = getattr(p1, "last_launch", None)
            emit(kernel="P1", scene=label, pair=pair, blocks=bp.num_blocks,
                 sets=len(sets), ms=ms,
                 bound_ms=cs.nbytes(kpp, xb, *(getattr(bp, n) for n in
                                                P1_TABLES), out)
                 / cs.PEAK_BYTES_PER_S * 1e3,
                 plain_ms=cs.cuda_ms(torch, lambda: p1.paired_matvec_plain(
                     bp, kpp, xb, d, pair), 5),
                 plan=str(getattr(p1.paired_matvec, "last_plan", None)),
                 launch=None if launch is None else str(launch()),
                 enqueue_us=sorted(enqueue)[len(enqueue) // 2],
                 enqueue_batches_us=enqueue, sha256=digest(out))
            del sets


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--repo", default=REPO)
    p.add_argument("--label", default="this checkout")
    only = p.add_mutually_exclusive_group()
    only.add_argument("--advect-only", action="store_true",
                      help="K11b, K10a and K10b only (the scenes and the "
                      "K10 sweep)")
    only.add_argument("--p1-only", action="store_true",
                      help="P1 only (the flagship and the probe's 270 "
                      "blocks)")
    args = p.parse_args(argv)
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import inspect

    from fem_tpu_torch.utils import cuda_build

    # Every library the run loads, built at once (one nvcc each, together).
    if args.p1_only:
        cuda_build.build([("probe_pairblock", None)])
    elif args.advect_only:
        cuda_build.build([("fused_frame", None), ("advect", None)])
    else:
        cuda_build.build([(name, None) for name in (
            "fused_cg", "fused_frame", "edge_cg", "probe_int8", "advect")]
            + [(name, 0) for name in ("blocked", "blocked_frame",
                                      "explicit_frame")]
            + [("element_chain", m) for m in range(8)])
    from fem_tpu_torch import entry
    from fem_tpu_torch.experiments import edge_cg, fused_frame as ff
    from fem_tpu_torch.ops import blocked_kernels as bk
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

    if args.p1_only:
        time_p1(torch, cs, dev, emit, digest)
        return 0
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
             plan=str(getattr(ff.fused_frame, "last_plan", None)),
             barriers=int(ff.fused_frame.last_barriers.item()),
             sha256=digest(*out))
        time_advect(torch, cs, label, o, s, c, emit, digest)
        if args.advect_only:
            continue
        blk = o.blocking
        bargs = (blk, s.pos, s.vel, s.vel_g, o.mass, ob.centers, ob.radii)
        out5 = fk.fused_blocked_frame(*bargs, **kw)
        ms = cs.kernel_ms(torch, lambda: fk.fused_blocked_frame(*bargs, **kw),
                          20, [cs.k5_kernel_name()])
        emit(kernel="K5", scene=label, ms=ms, sha256=digest(*out5))
        K, H = ek.hessian_and_force(s.pos, o.element_indices, o.ref_inv,
                                    o.volume, o.mu, o.s_lambda)
        solve = (K, H, o.element_indices, o.plan, s.vel, o.mass,
                 c.delta_time, True)
        k4_variants = [("plan", {})]
        if "single" in inspect.signature(cg_kernels.fused_cg_solve).parameters:
            k4_variants.append(("single", dict(single=True)))
        for name, opts in k4_variants:
            v, it, _ = cg_kernels.fused_cg_solve(*solve, **opts)
            plan = getattr(cg_kernels.fused_cg_solve, "last_plan", None)
            ms = cs.kernel_ms(torch, lambda: cg_kernels.fused_cg_solve(
                *solve, **opts), 20, ["fused_cg_kernel"])
            emit(kernel="K4", scene=label, launch=name, ms=ms,
                 iterations=int(it), plan=str(plan), sha256=digest(v, it))
        s_mat = torch.as_tensor(build_edge_matrix(
            o.element_indices.cpu().numpy(), o.particle_cnt), device=dev)
        b = cs.rhs_of(torch, o, s, H, c.delta_time)
        ekw = dict(dim=o.dim, dt2=c.delta_time ** 2, preconditioned=True)
        k11a_variants = [("plan", {})]
        if "single" in inspect.signature(edge_cg.cg_solve_edge).parameters:
            k11a_variants.append(("single", dict(single=True)))
        for name, opts in k11a_variants:
            x, it = edge_cg.cg_solve_edge(s_mat, K, b, o.mass, **ekw, **opts)
            plan = getattr(edge_cg.cg_solve_edge, "last_plan", None)
            # "edge_cg_kernel" names both variants' kernels.
            ms = cs.kernel_ms(torch, lambda: edge_cg.cg_solve_edge(
                s_mat, K, b, o.mass, **ekw, **opts), 20, ["edge_cg_kernel"])
            emit(kernel="K11a", scene=label, launch=name, ms=ms,
                 iterations=int(it), plan=str(plan), sha256=digest(x, it))
        kb, _ = bk.blocked_prep(blk, s.pos, o.mu, o.s_lambda)
        k3_variants = [("plan", {})]
        params = inspect.signature(bk.blocked_graph_apply).parameters
        if "grid" in params:
            k3_variants.append(("grid", dict(grid=True)))
        for name, opts in k3_variants:
            for tr in (False, True):
                def apply(tr=tr, opts=opts):
                    return bk.blocked_graph_apply(blk, kb, s.vel, tr, **opts)

                y = apply()
                plan = getattr(bk.blocked_graph_apply, "last_plan", None)
                names = (["cluster_blocked_matvec_kernel"]
                         if plan is not None and plan.variant == "cluster"
                         else ["blocked_matvec_kernel", "slot_sum_kernel"])
                ms = cs.kernel_ms(torch, apply, 50, names)
                reps = 1000
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    apply()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                emit(kernel="K3", scene=label, launch=name, transpose_k=tr,
                     ms=ms, plan=str(plan),
                     enqueue_us=(t1 - t0) * 1e6 / reps, sha256=digest(y))
        time_prep(torch, cs, label, o, s, emit, digest)
        time_elements(torch, cs, label, o, s, emit, digest)
    time_advect_sizes(torch, cs, dev, emit, digest)
    if args.advect_only:
        return 0
    for name in p2.VARIANTS:
        a, w = p2.probe_inputs(6, 1024, 2048, name, dev)
        ms = cs.kernel_ms(torch, lambda: p2.chained_dot(a, w, 200, name), 20,
                          ["chained_dot_kernel"])
        emit(kernel="P2", variant=name, ms=ms,
             plan=str(getattr(p2.chained_dot, "last_plan", None)))
    time_element_sizes(torch, cs, dev, emit)
    time_explicit(torch, cs, dev, emit, digest)
    time_path_c(torch, cs, dev, emit)
    time_op_paths(torch, cs, dev, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
