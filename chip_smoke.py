#!/usr/bin/env python3
# coding=utf-8
"""Chip smoke run of the PyTorch/CUDA port (fem_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port on the flagship ``configs/demo_spot.json`` (1,007
particles, 4,068 tets, 17 locality blocks, ``sim_count = 10``) through its
paths — the implicit CG in normal-equations mode (A-C) and the explicit
and autodiff method at ``delta_time = 1e-4`` (D-G) — on the 2D scenes
(H-L), the inelastic materials (M-Q), every base material and
``robust_inversion`` (R-V), the implicit extensions — pins, loads,
Rayleigh β, SDF obstacles, block-Jacobi and the exact Hessian (W-Z′) and
the fused advection (AD) — the unblocked whole frame, the ``"mxu"``
operator, the edge-matrix CG and the two probes (AE-AG, P1, P2), the
Jacobi solver (AH-AK), the CLI, ``Simulation`` and the adaptive-dt guard
(AL-AN), body-body contact and the batched frame (AO-AS), and the Newton
integrator, the two-level preconditioner and the static solve (AT-AX),
and differentiable rollouts and their gradients (AY-BA), and holds
every CUDA kernel of those paths against its plain PyTorch version.  K5
runs as its cluster variant on every path (each mesh there fits one
thread-block cluster; ``counts()`` fails the run otherwise), as do K8, K4,
K3, K2, K7b, K7a and K11a, and sections 42 and 48-52 hold every variant of
the eight:

1. environment: torch, CUDA, nvcc, the card's name and power limit;
2. build: every kernel from ``fem_tpu_torch/csrc/`` with nvcc for sm_90a,
   one library per source and material instance, all compiled in
   parallel;
3. K1, the element chain, against ``hessian_and_force_plain`` on the
   flagship's deformed state (block-relative error ≤ 1e-5), twice
   bit-identical, with its plan (``element_kernels.element_plan``: tets a
   CTA, CTAs); then K1, K9b, K9a and every K6 instance at 1, 33 and
   4,069 elements cut from the flagship (ragged last tiles), each against
   its plain version and twice bit-identical;
4. K4, the whole CG solve, against ``fused_cg_solve_plain`` with
   ``preconditioned`` 0 and 1 (velocity rtol 5e-4 / atol 1e-6, iterations
   within 1), and twice on the same inputs, bit-identical;
5. K2, the blocked prep (its partials form), and K3, the blocked operator
   (both transposes; its automatic plan, one cluster of 16 CTAs, and its
   two-kernel variant), against their plain versions (K block-relative ≤
   1e-5, partials and G(K)·x within 1e-5 of their largest entry), each
   twice bit-identical, K3's two variants bit-identical to each other;
6. K5, the whole frame (its automatic plan: one cluster of 16 CTAs on the
   flagship), against ``fused_blocked_frame_plain`` on the card,
   ``preconditioned`` 0 and 1, with and without velocity noise: positions
   within 1e-5, iterations within 1 per substep, two runs bit-identical;
7. K6, the gradient columns (block-relative ≤ 1e-5), K7b, the blocked
   prep's explicit mode (its partials form), and K7a, the blocked assembly
   (each within 1e-5 of its largest entry), against their plain versions
   on the deformed state, each twice bit-identical; then K2, K7b and K7a
   as one launch each that ends in the per-particle sum (their automatic
   plans, one cluster of 16 CTAs): twice bit-identical and bit-identical to
   their grid variants, K2's K equal to the partials form's, its force and
   K7b's gradient within 1e-5 of the largest entry of the parent form (the
   partials through ``blocked_scatter_sum``); the same in 2D in section 15;
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
    substeps after a warm-up substep; K1 and K4 launch once a substep; the
    first substep equals the CPU plain substep to 1e-5; steps/s (one
    substep a call);
12. path D, the explicit flagship frame (``sim.make_frame_fn`` on
    ``entry.explicit_flagship``: the body 0.01 above the floor, falling at
    1 m/s): 30 frames; K8 launches once a frame and no other kernel;
    positions finite and at the floor; the first frame equals the CPU
    plain frame to 1e-5; steps/s; then one ``auto_diff`` frame, K8 once;
13. paths E, F and G, the explicit substep (``sim.substep``) from the
    deformed state: K7b once a substep (E, ``element_backend="auto"``; its
    one launch ends in the gradient), K7a once a substep (F, ``auto_diff``
    and ``"xla"``; one launch), K6 once a call of
    ``analytic_energy_gradient`` on the unblocked body (G); each first
    substep or gradient equals the CPU's to 1e-5;
14. the shipped explicit configs ``demo_3d.json`` and
    ``demo_cube_autodiff.json``: a few frames each through
    ``make_frame_fn`` (K8 once a frame), equal to the CPU frames to 1e-5;
15. 2D, on the reference's headline ``configs/default.json`` (121
    particles, 200 triangles, one locality block, ``auto_diff``,
    ``sim_count = 10``): K1-K8's triangle instances against their plain
    versions on a state moved into the right circle and squashed, with
    random velocities (the tolerances of 3-8), each twice bit-identical,
    and K1, K9b, K9a and every K6 instance at 1, 33 and 4,069 triangles
    cut from the scene as in section 3; K5 and K8 also over the 16 blocks
    of the same scene at 40 subdivisions;
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
21. inelastic materials, on ``configs/demo_plastic.json`` (two 2D bodies
    of 121 particles: body 0 plastic, body 1 with a Maxwell branch) and on
    the flagship with inelastic overrides: K7b edges, the layered chains
    of K1, K6, K2 and K7b (dynamic R⁻¹·F_i⁻¹, the stable Neo-Hookean
    branch) and the inelastic instances of K5 and K8 against their plain
    versions (positions and both internal inverses within 1e-5), each
    twice bit-identical, K5 and K8 also over 3 CTAs walking the 16 blocks
    of the 40-subdivision grid;
22. path M, ``demo_plastic.json`` as shipped through ``scene.load_scene``
    and one ``make_frame_fn`` per body: 200 frames (one virtual second),
    K8 twice a frame and no other kernel, the first frames equal to the
    CPU's, body 0 yielded (max |F_p⁻¹ − I| > 1e-3) and body 1's F_v⁻¹
    moved, the arc held to the goldens of tests/test_torch_inelastic.py;
23. path N, its implicit variant (normal-equations CG) from a state
    squashed into the floor: 10 frames, K5 twice a frame;
24. path O, the flagship with ``plastic_yield = 0.01`` from the deformed
    example state: 30 frames, K5 once a frame (17 blocks);
25. path P, the explicit flagship with ``plastic_yield = 0.01,
    viscous_mu = 2e4, viscous_tau = 0.01``: 30 frames, K8 once a frame;
26. path Q, the op-composed layered substeps (``sim.substep``) with paths
    C's, B's, E's, F's and G's settings on both bodies of path M (squashed)
    and on path P's body (deformed): K1 + K4, K2 + K3, K7b, K7a, K6 per
    layer, K7b edges once a substep (the blocked update), each first
    substep equal to the CPU's to 1e-5;
27. materials: every material instance of K1, K2, K5, K6, K7b and K8
    (stvk, linear, corotated, stable Neo-Hookean, Mooney-Rivlin, fiber) and
    the robust Neo-Hookean instance of K1, K2 and K5, in 2D (the default
    scene squeezed) and 3D (the flagship deformed), K5 and K8 also with
    the inelastic branches, against their plain versions (1e-5, iterations
    within 1 in short solves), each twice bit-identical (K1's plan
    printed with each instance);
28. path R, ``configs/demo_passage_corotated.json`` as shipped through
    ``scene.load_scene`` and ``make_frame_fn``: 200 frames, K8's 2D
    corotated instance once a frame and nothing else, the first frame equal
    to the CPU's, the end state held to the JAX package's 200-frame values
    (tests/test_torch_golden_corotated.py);
29. path S, ``default.json`` with each material as shipped (K8) and with
    the ``implicit_cg`` overrides (K5), 30 frames each, and
    ``demo_plastic.json``'s body 0 with each material from its squashed
    state (K8 and K5 inelastic; corotated 10 frames, the others 1);
30. path T, the flagship with each material from the deformed state:
    3 frames through K5 and through K8 (corotated 30 each, timed); with
    ``plastic_yield = 0.01`` each material through K5 (stvk 30 frames) and
    K8, 1 frame;
31. path U, ``robust_inversion``: the flagship (K5 3D robust, 30 frames)
    and ``default.json``'s ``implicit_cg`` variant (K5 2D robust), a state
    with one tet inverted and nearly flat (the robust K5 finite, equal to
    its plain frame on the card and to the CPU's), and the op-composed
    robust substeps with C's and B's settings (K1 + K4, K2 + K3);
32. path V, the op-composed material substeps with C's, B's, E's, F's and
    G's settings on ``default.json`` with corotated and the flagship with
    ``fiber:1,0,0``, 10 substeps each, and a 2-substep sweep of every other
    material with C's, B's, E's and G's settings (every instance of K1, K2,
    K7b and K6 runs on a path); each first substep equal to the CPU's;
    every instance of the line's material rows launched on paths R-V;
33. the 3D canary of tests/test_golden.py (``assets/cube.stl`` meshed by
    the port, spacing 0.5): 100 frames through K5, held to its goldens;
34. K9a and K9b (the halves of K1's Neo-Hookean chain) against their
    plain versions on the flagship deformed and on ``default.json``
    squeezed (block-relative ≤ 1e-5), K10a and K10b (the fused advection)
    on the same bodies with three circles and random velocities (1e-6
    absolute), each twice bit-identical (K9a's and K9b's plans printed);
    K10a and K10b also at 262,144 particles in 3D (1e-6 absolute, the
    entries not bit-equal to the plain version counted; K10's plans
    printed, ``advect_plan``, and the kernels line's K10 rows carry
    ``tile`` and ``ctas``);
35. path W, ``configs/demo_hanging.json`` as shipped (2D, a pin box, plain
    CG): 200 frames through ``make_frame_fn``, the op-composed frame, K2
    ten times a frame and K3 Σ(1 + iterations) (plain CG: one apply for the
    first residual and one an iteration), the pinned vertices at their
    start exactly, the first frame equal to the CPU's to 1e-5 with equal
    iterations, the arc on the JAX package's 200-frame values; its
    ``exact_jvp`` variant, K9b 2D once a substep;
36. path X, ``configs/demo_ramp.json`` as shipped (β 2e-3 in K3's
    coefficient, a half-space and a box through the SDF pass): 31 frames,
    the same checks against the JAX package's values after them, and the
    CG iterations of the three frames after them (frames 31-33 counted
    from 0) printed (ROADMAP F7); its explicit variant,
    K9a 2D and K7b once a substep;
37. path Y, the flagship under ``hessian="exact_jvp"``: the first substep
    equal to the CPU's to 1e-5 with equal iterations, then 3 frames with
    K9b once a substep and no other kernel;
38. path Z, the flagship under ``cg_precond="block_jacobi"`` with a pin box
    over its top 1 %: 3 frames, K2 + K3, pinned vertices exact, the first
    frame equal to the CPU's to 1e-5;
39. path Z′, the explicit flagship with ``damping_beta`` 2e-3 and a load
    box: 3 frames, K7b and K9a once a substep, the first frame equal to the
    CPU's to 1e-5;
40. path AD, the advection steps with ``backend="pallas"`` (which the
    frames never take, as in the JAX package): 10 implicit substeps (K1 +
    K4, then K10b) and 10 explicit ones (K7b, then K10a) on the flagship
    and on ``default.json``, each first substep equal to the CPU's plain
    substep to 1e-5 (the K10 launch's plan printed);
41. where each frame's device time goes and the device's busy share, from
    one profiled window per path (A, the op-composed K1 + K4 frame, D, H,
    I, K, both of L, M, N, O and P, path Q's explicit layered substep in
    2D and 3D, R, T's corotated K5 and K8, U's K5, W, X, Y, Z, Z′); each kernel's device
    time per launch in 3D and in 2D (profiler; the run fails if it sees no
    launch of it), its plain version's time (CUDA events), the least time
    the card could take (bound) and, for K3, K7a and K7b edges, one PyTorch
    sparse product (library yardstick, its device time from the profiler
    as the kernels' is); K2's and K7b's rows time the one launch that ends
    in the sum, with the grid variant's time and the parent form's (the
    partials launch and PyTorch's slot sum, every kernel of it), K7a's
    likewise, K7b edges' at two CTAs a block; printed as one ``kernels`` JSON
    line with a row per kernel and dimension, the inelastic instances of K5
    and K8 rows of their own, and a row per material and robust instance
    (with ``material`` and ``robust`` keys); K5's rows name the variant,
    its CTAs, threads a CTA and the barriers the kernel counted in a frame
    (the run fails unless they are those ``frame_barriers`` places there),
    and K8's, K4's, K3's, K2's, K7b's, K7a's and K11a's rows likewise
    (``explicit_frame_barriers``, ``fused_cg_barriers``, ``blocked_barriers``
    and ``edge_cg_barriers``; K4's and K11a's a solve, K3's an apply, K2's,
    K7b's and K7a's a launch).  Every path's K5, K8, K4, K3, K2, K7b, K7a
    and K11a ran their cluster variants (``counts()`` fails the run
    otherwise).
    The build's lines give each library's seconds and the registers and
    spills of every instance.
42. K11a, the edge-matrix CG (``experiments/edge_cg.py``), against its
    plain version (the dense S products) on the flagship deformed (S of
    12,204 × 1,007, 49 MB) and ``default.json`` squeezed, ``preconditioned``
    0 and 1: equal iterations, velocity rtol 5e-4 / atol 1e-6, twice
    bit-identical; its variants — the plan's (one cluster: 16 CTAs on the
    flagship, 1 on ``default.json``), the single CTA and clusters of 1, 3
    and 16 CTAs — each with equal iterations, x within 1e-5 of its largest
    entry, twice bit-identical, the barriers its kernel counted equal to
    ``edge_cg_barriers``, a cluster too large for a CTA's shared memory
    refused before the launch (one ``k11a_variants`` JSON line); path AG,
    10 implicit substeps with K11a as the solve (K1 + K11a once a substep,
    its cluster variant), the first equal to the K1 + K4 substep to 1e-5,
    in 3D and 2D;
43. K11b, the unblocked whole frame (``experiments/fused_frame.py``),
    against its plain version on the card (positions 1e-5, iterations
    within 1, twice bit-identical); its variants — the plan's, the single
    CTA and clusters of 1, 3 and 16 CTAs — on the flagship and
    ``default.json`` against the plain frame, each twice bit-identical
    with the barriers its kernel counted equal to ``frame_barriers``, a
    cluster too large for a CTA's shared memory refused before the launch
    (one ``k11b_variants`` JSON line); path AE, ``demo_spot.json`` with
    ``frame_backend="fused"``: 30 frames from the deformed state, K11b
    once a frame and nothing else, all of the cluster variant (16 CTAs)
    with the formula's barriers, the first frame equal to the CPU plain
    fused frame to 1e-5 with equal iterations and within 1e-5 of K5's
    (iterations within 1), steps/s, device ms a frame and busy share
    beside K5's; the same for ``default.json``'s ``implicit_cg`` variant
    from its squeezed state (a cluster of one CTA);
44. path AF, ``operator_mode="mxu"`` on the flagship: 3 frames, K1 once a
    substep and nothing else (the S products are ``torch.matmul``), the
    first frame equal to the CPU's to 1e-5;
45. P1, the paired-block probe, on the flagship blocking (17 blocks, padded
    to 18 and 20): pair 1, 2 and 4 against the plain version and K3's
    per-block partials (1e-5 of the largest entry), twice bit-identical,
    the padded blocks zero, each pair's launch (CTAs, threads, cluster
    size, shared memory, as the library recorded it) logged and equal to
    ``pair_plan``'s; the probe's entry point with ``--config
    configs/demo_spot.json``;
46. P2, the int8 table probe, at its defaults: the three variants against
    the plain version (int8 × int8 exactly, bf16 within 1e-4 of the
    largest entry), twice bit-identical, the MACs the kernel issued on the
    tensor cores (its own count) equal to its plan's and at least
    reps × rows × n × cols, so that no rep was folded; the probe's entry
    point;
47. their times: each kernel's device ms (profiler), plain ms (CUDA
    events), bound and ``library_ms`` (P1: ``torch.sparse.mm``, as K3; P2:
    one ``torch.matmul`` in bf16 or ``torch._int_mm`` over the stacked
    rotations; none for K11a and K11b; the library call's device time from
    the profiler), rows of the kernels line;
48. K5's variants: the automatic plan, the grid variant (one CTA a block)
    and clusters of 1, 3 and 16 CTAs, on the flagship, ``default.json``
    squeezed and the 40-subdivision grid squeezed, each against
    ``fused_blocked_frame_plain`` (positions within 1e-5, iterations within
    1 in short solves, velocities within √tol, where a CG stopped at
    ‖r‖² ≤ tol leaves them, ``vel_g`` within 1e-5, twice bit-identical; a cluster whose state exceeds a CTA's shared
    memory raises), with its device ms and the barriers the kernel counted
    in a frame (equal to ``frame_barriers``'), printed as one
    ``k5_variants`` JSON line;
49. K8's variants: the automatic plan (the cluster variant), the grid
    variant (one CTA a block) and clusters of 1, 3 and 16 CTAs, on the
    explicit flagship, ``default.json`` squeezed, the 40-subdivision grid
    squeezed and both ``demo_plastic.json`` bodies (each with its internal
    state), each against ``fused_explicit_frame_plain`` (positions and
    internal inverses within 1e-5), twice bit-identical and bit-identical
    to the grid variant, a cluster the plan refuses (more CTAs than blocks,
    or a CTA beyond the shared memory) raising before the launch, with its
    device ms and the barriers the kernel counted in a frame (equal to
    ``explicit_frame_barriers``'), printed as one ``k8_variants`` JSON
    line;
50. K4's variants: the automatic plan (the cluster variant), the single
    CTA and clusters of 1, 3 and 16 CTAs, on the flagship deformed and
    ``default.json`` squeezed, ``preconditioned`` 0 and 1, each against
    ``fused_cg_solve_plain`` (velocities rtol 5e-4 / atol 1e-6, equal
    iterations), twice bit-identical, with its device ms and the barriers
    the kernel counted in a solve (equal to ``fused_cg_barriers``'),
    a cluster whose CTA exceeds the shared memory refused before the
    launch, printed as one ``k4_variants`` JSON line;
51. K3's variants: the automatic plan (the cluster variant), the
    two-kernel variant and clusters of 1, 3 and 16 CTAs, on the flagship
    (17 blocks), ``default.json`` (1) and the 40-subdivision grid (16),
    both transposes, each within 1e-5 of the plain version's largest
    entry, twice bit-identical and bit-identical to the two-kernel
    variant, a cluster of more CTAs than blocks refused before the launch,
    with its device ms an apply and the barriers the cluster kernel
    counted (equal to ``blocked_barriers``'), printed as one
    ``k3_variants`` JSON line;
52. K2's, K7b's and K7a's variants, each one launch that ends in the
    per-particle sum: the automatic plan (the cluster variant), the grid
    variant (one CTA a block, then the slot sums) and clusters of 1, 3 and
    16 CTAs, on the flagship, ``default.json`` and the
    40-subdivision grid, each within 1e-5 of the plain version's largest
    entry (K2's K 1e-5 block-relative), twice bit-identical and
    bit-identical to the grid variant, a cluster of more CTAs than blocks
    refused before the launch, with its device ms a launch and the barriers
    the cluster kernel counted (equal to ``blocked_barriers``'); K7b edges,
    twice bit-identical; printed as one ``prep_variants`` JSON line;
53. J1, the serial Jacobi solve (``ops/jacobi_kernels.py``), against its
    plain version on the card: the sparse rows of
    ``demo_passage_jacobi.json`` squashed and moving, and of the flagship
    deformed (one implicit substep's system), and the 2D dense rows;
    iterations equal (read from the kernel's output), x and the carried
    anchor within 1e-5 of the largest entry, twice bit-identical;
54. path AH, ``configs/demo_passage_jacobi.json`` as shipped through
    ``make_frame_fn``: 200 frames, K1 and J1 once a substep and no other
    kernel; the first frame and frame 101, restarted on the CPU from the
    card's state, within 1e-5 of the CPU frame, iterations within 1 a
    substep; steps/s; J1's device ms a solve and a sweep (profiler) and
    the frame's device ms and busy share over 10 frames in contact;
55. path AI, the flagship with ``implicit_method=0`` from the deformed
    state: 3 frames, K1 and J1 once a substep; the first frame within 1e-5
    of the CPU frame, iterations within 1; J1's device ms a solve and a
    sweep on the flagship;
56. path AJ, the flagship's snapshot sweep (``jacobi_sweep="snapshot"``,
    the blocked operator): 3 frames, K1 twice a substep (the mesh and the
    block order) and K3 1 + 2·iterations times a substep; the first frame
    within 1e-5 of the CPU frame;
57. path AK, ``default.json`` with ``solver_backend="dense"`` from the
    squashed state: its CG (normal equations; K1 once a substep) and its
    Jacobi solver (K1 and J1 over the dense rows once a substep), each 10
    frames, the first frame within 1e-5 of the CPU frame;
58. the ``implicit_jacobi`` golden of tests/test_golden.py through J1: 200
    frames, K1 and J1 once a substep, held to its values;
59. path AL, the entry points users call: the CLI (``fem_tpu_torch.main.run``) on
    ``configs/demo_spot.json``, 30 frames, ``--no-render
    --checkpoint-every 10``: K5 once a frame and no other kernel, the
    resume from frame 10 bit-equal to the straight run, the OBJ files at
    the reference's cadence (the last one equal), the first frame within
    1e-5 of the CPU's plain K5 frame, and the same 30 frames with no OBJ
    export or checkpoint (steps/s); ``configs/default.json`` likewise
    through K8; ``Simulation`` on the flagship with ``nan_guard=True``, 30
    frames, K5 once a frame; steps/s, device ms a frame and busy share;
60. path AM, the guarded flagship (``adaptive_dt``) from the deformed
    state: κ through K2 within 1e-5 relative of the CPU's plain κ, then
    levels 0-3 forced through ``adaptive_dt_threshold``, 5 frames each:
    K2 and K5 once a frame, one host read of the level a frame, K5's own
    barrier count giving 10·n substeps a launch, the first frame within
    1e-5 of the CPU guarded frame (iterations within n an outer substep);
    device ms a frame against path A's;
61. path AN, the stiff 2D reproducer of tests/test_torch_adaptive.py (7
    subdivisions, E 4e5, dt 2e-3, velocity noise 1e-4): 8 frames unguarded
    through K5 (non-finite within them) and guarded (K2 and K5 once a
    frame, finite, split), the first guarded frame within 1e-5 of the
    CPU's.  One ``entry_paths`` JSON line holds their numbers;
62. path AO, ``configs/demo_two_bodies_contact.json`` as shipped, 100
    frames through the CLI and through ``Simulation``: C1 once a substep
    and K7a once a body a substep, the CLI's N×-per-body pacing, the end
    states within 1e-5 of each other, the first frame within 1e-5 of the
    CPU's, the bodies never nearer than half the radius; then C1 against
    its plain version at the path's shapes with body 0 laid on body 1
    (active pairs printed and above 0; the matmul form held, as its plain
    version, to the float64 plain version: within twice the plain
    version's error there plus 1e-5 of the largest force; the Coulomb
    form within 1e-5; twice bit-identical; the forces' total within 1e-5
    of Σ|f|), and the same bodies with ``contact_broadphase="grid"`` (C2
    once a substep, 5 frames; C2 against its plain version within 1e-5 of
    the largest force, with self-contact and Coulomb too);
63. path AP, two flagship bodies stacked (``demo_spot.json``'s implicit
    CG with ``contact: "penalty"``, the upper lifted until its surface is
    half a radius from the lower's), 30 frames through ``Simulation``: C1
    over 642 + 642 surface vertices once a substep, K1 + K4 once a body a
    substep; the first frame within 1e-5 of the CPU's, iterations equal;
64. path AQ, tools/self_contact_scale.py's blob built through the port
    (12,037 particles, 2,780 surface vertices), slammed down and warmed
    through the slam (1,400 substeps, C1 once a substep; the active
    self-pairs sampled every 5 frames and printed), then C1 against its
    plain version over the masked self-pairs with and without
    ``contact_mu`` on the warmed state squashed to 15 % of its height (the
    active pairs printed and above 0), ``grid_overflow_count`` of the
    warmed state printed (ROADMAP F8) and device ms a substep with contact
    and without;
65. path AR, tools/probe_broadphase.py's two interpenetrating shells (ns
    8,192 and 24,576) under C1 and C2, each against its plain version and
    timed (``torch.cdist`` timed beside C1 as a yardstick the port never
    calls), C1 and C2 agreeing where no cell overflows; two 3D grid cubes
    stacked with ``contact_broadphase="grid"`` (C2 once a substep);
66. path AS, ``batch.make_batched_frame_fn`` on ``default.json`` at B = 8,
    perturbed: K7a once a member a substep, every member bit-equal to its
    single run.  One ``contact_paths`` JSON line holds their numbers;
67. path AT, the flagship (deformed) with ``integrator: "newton"``,
    ``newton_hessian: "decoupled"`` at its dt: 3 frames, K2 once a residual
    evaluation and K3 once a Newton step and once an inner CG iteration,
    as ``solvers/newton.newton_velocity_solve.totals`` counts them; no
    plain version called; the first frame within 1e-5 of the CPU's run of
    the same route (K2's and K3's plain versions), its CG a substep within
    3 (the Newton loop stops at the f32 floor of its 1e-5 tolerance); two
    runs bit-identical; device ms a frame, busy share, steps/s;
68. path AU, the same at dt 4e-3 with ``cg_precond: "two_level_cheb3"``:
    2 frames, K3 16 a substep (λmax) + 7 a PCG step and iteration, two
    runs bit-identical; plain-CG Newton's inner totals beside it and
    whether the semi-implicit frame stays finite (printed only);
69. path AV, the semi-implicit flagship with ``cg_precond: "two_level"``:
    3 frames, K2 a substep, K3 19 + 3 a PCG iteration; the first frame
    within 1e-5 of the CPU's, equal iterations; two runs bit-identical;
70. path AW, examples/newton_large_dt.py's block (copied: κ ≈ 60) through
    ``Simulation``, velocities noised by 1e-4, exact Newton at θ 1 and
    0.5: 2 frames each, H1 (the exact stiffness apply) once a Newton step
    and once an inner CG iteration and no other kernel, finite, the first
    frame within 1e-3 of the CPU's;
71. path AX, ``Simulation.solve_static(cg_precond="two_level_cheb3")`` on
    ``assets/cube.stl`` at interior spacing 0.2, pinned on top: H1 once a
    product of the exact Hessian (as many launches as the products the
    solve asked for) and no other kernel; within 1e-5 of the CPU's solve,
    ``converged``/``stalled`` equal, at rest.
    One ``newton_paths`` JSON line holds their numbers;
72. path AY, a gradient through a full flagship frame
    (``diff.make_diff_rollout_fn``: 10 implicit substeps from the
    deformed state, normal-equations CG of 32 iterations, ``remat``): the
    trajectory loss against a target made on the card at 1.5× μ, its
    gradient in μ, λ, the damping and the initial velocity.  K3 launches
    (``variant_launches``) as many times as
    ``diff.implicit_graph_products`` predicts and no other kernel runs; no
    plain version called; two runs bit-identical; the gradient within
    1e-3 of the CPU's and of the plain products' on the card, equal with
    ``remat`` off; device ms a gradient, busy share, peak device memory
    with and without ``remat``, the top device ops;
73. path AZ, 5 steps of ``torch.optim.Adam`` on log E from a 2× wrong
    guess against a target at the flagship's E (one frame each, as
    examples/inverse_material.py): K3 as predicted every step, the loss
    after step 5 below step 1's;
74. paths BA, the explicit and autodiff rollouts of ``default.json`` (12
    substeps, squashed), the explicit flagship at dt 1e-4 from the
    deformed state (10) and
    ``demo_plastic.json``'s plastic body with the yield strain traced (10,
    squashed past yield): no kernel launched (the element chain and the
    advection are plain PyTorch under autograd, as XLA in the JAX
    package), finite, two runs bit-identical, the gradients within 1e-3
    of the CPU's.  One ``diff_paths`` JSON line holds their numbers;
75. H1 (``csrc/stiffness_apply.cu``, the exact stiffness K·W through each
    element's Jacobian in its edge vectors) against its plain version on
    the flagship and ``demo_hanging.json``'s body, 1, 8 and 9 columns,
    f32 and f64, twice bit-identical, its rows variant (the default: the
    element rows once into slot order, then the per-particle sums) equal
    bit for bit to its slots variant (the first design; the sha256 of
    each instance logged), both timed beside ``torch.sparse.mm`` of the
    assembled CSR; path BB, ``Simulation.modes(k=6)`` (Chebyshev) on
    the flagship pinned over its top 1 % (path Z's box): H1 41 + 152·R
    launches (R the rounds run), no plain version, two runs
    bit-identical, and once more on the slots variant with the same
    launches and ω² and modes bit-identical; ω² within 1e-4 of ω²₆ of
    ``method="sparse_f64"``
    (ARPACK on f64 element Hessians made on the card), M-orthonormal
    within 1e-3; the direct f64 residuals of the elastic modes and every
    residual of ``refine_f64=True`` (on the card in f64, H1's double
    instance) below 1e-3; 2 rounds on the card and on the CPU from the
    same start within 1e-3 of ω²₆; the free flagship at k = 8: six rigid
    modes below 1e-4·ω²₈, the seventh above 1e-2·ω²₈;
76. path BC, ``method="shift_invert"`` on ``demo_hanging.json``'s body:
    H1 32 + 400·(1 + 2·steps) launches, two runs bit-identical, within
    1e-4 of ω²₆ of the sparse oracle;
77. path BD, ``harmonic`` (200 frequencies) and ``response_spectrum`` (a
    numpy-seeded record of 2,000 samples) on BB's modes: no kernel, two
    runs bit-identical, within 1e-5 of the CPU from the same
    ``ModalResult``, abssum ≥ SRSS;
78. path BE, ``buckling(k=4, gravity=True)`` on the flagship's mesh at E
    4e6 pinned over its lowest 5 %: H1 405 launches a round, two runs
    bit-identical, λ_cr within 1e-3 of a dense f64 pencil oracle
    (``scipy.linalg.eigh`` on the free DOFs), 2 rounds on the card and
    on the CPU from the same start within 1e-3;
79. path BF, ``arc_length`` on tests/test_riks.py's arch (its element
    Hessians on the card) and ``system_diagnostics`` on the flagship: no
    kernel, two runs bit-identical, within 1e-6 (λ) and 1e-5 of the CPU.
    One ``analysis_paths`` JSON line holds their numbers, with AX's
    (section 71) device ms and wall beside them.

The last line of standard output is ``{"ok": true, "device": {...}}``.  Any
failure ends the run with a non-zero exit and no result line; without a
CUDA device, or without the repository beside it, it exits non-zero at once.
"""

import dataclasses
import hashlib
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
FRAMES_N = 10  # path N, from the squashed state
SUBSTEPS_Q = 10  # path Q, each setting
EDGE_CTAS = 2  # CTAs a block of K7b edges (csrc/blocked.cu: kEdgeParts)

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
#
# The inelastic extension, per element: a layer's R⁻¹·F_i⁻¹ (reff), the
# stable Neo-Hookean gradient chain (snh_grad: F, cof, det, P, P·R⁻ᵀ) and
# implicit chain (snh_chain: also cof:D, Dcof, DP, DP·R⁻ᵀ), the update's
# shared part (update_guard: F, det, the guarded adjugate inverse) and its
# part per internal state (update_state: F·F_i⁻¹, FᵀF, the Jacobi
# eigensolve — 6 sweeps of 3 rotations in 3D, ~52 operations each; one
# rotation in 2D — the logs, the return or relaxation, the exps, the
# rescale and F⁻¹·F_new); K7b edges' edge differences (edges) and a
# padded slot's rest edge matrix (rest_inv).
OPS = {
    3: dict(chain=430, apply=72, grad=200, rows=24, kinematic=40, advect=40,
            reff=45, snh_grad=206, snh_chain=377, update_guard=109,
            update_state=1220, edges=9, rest_inv=40),
    2: dict(chain=136, apply=24, grad=60, rows=8, kinematic=27, advect=27,
            reff=12, snh_grad=44, snh_chain=86, update_guard=24,
            update_state=133, edges=4, rest_inv=8),
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
    "implicit_jacobi": dict(
        mean=0.55737782, std=0.09082112, p0=(0.4845500, 0.4766834),
        p24=(0.4949913, 0.6178035), p48=(0.5053604, 0.7599947)),
}
# tests/test_torch_inelastic.py: demo_plastic.json's 200-frame goldens, per
# body (recorded by the JAX package on the CPU; mean and std within 5e-3,
# particles 0, 60 and 120 within 1e-2, max |F_i⁻¹ − I| within 10 %).
# Copied: that file imports the JAX package.
GOLDEN_PLASTIC = {
    0: dict(mean=0.26474188, std=0.19676138, p0=(0.30657175, 0.00289933),
            p60=(0.44921011, 0.07068006), p120=(0.54656106, 0.17222811),
            max_fi=0.57151222),
    1: dict(mean=0.42356669, std=0.33236686, p0=(0.64952904, -0.00009840),
            p60=(0.75001907, 0.09686103), p120=(0.84958166, 0.19520803),
            max_fi=0.02481234),
}
OVERRIDES_2D = {
    "explicit_analytic": dict(auto_diff=False, use_explicit_method=True),
    "autodiff": dict(auto_diff=True, use_explicit_method=True),
    "implicit_cg": dict(auto_diff=False, use_explicit_method=False,
                        implicit_method=1, preconditioned=1),
    "implicit_jacobi": dict(auto_diff=False, use_explicit_method=False,
                            implicit_method=0),
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
    ("blocked_edges", "fem_tpu_torch/csrc/blocked.cu",
     "fem_tpu/ops/blocking.py:513"),
    ("blocked_frame_inelastic", "fem_tpu_torch/csrc/blocked_frame.cu",
     "fem_tpu/ops/pallas_blocked_frame.py:547"),
    ("explicit_frame_inelastic", "fem_tpu_torch/csrc/explicit_frame.cu",
     "fem_tpu/ops/pallas_blocked_frame.py:936"),
    ("hessian_blocks", "fem_tpu_torch/csrc/element_chain.cu",
     "fem_tpu/ops/pallas_kernels.py:387"),
    ("implicit_force", "fem_tpu_torch/csrc/element_chain.cu",
     "fem_tpu/ops/pallas_kernels.py:445"),
    ("kinematic", "fem_tpu_torch/csrc/advect.cu",
     "fem_tpu/ops/pallas_advect.py:125"),
    ("advect_implicit", "fem_tpu_torch/csrc/advect.cu",
     "fem_tpu/ops/pallas_advect.py:151"),
    # No pallas_call: the JAX package's solve is one XLA while_loop
    # (_jacobi_outer_loop) around the row scan of
    # jacobi_solve_serial_sparse (:888).
    ("jacobi_serial", "fem_tpu_torch/csrc/jacobi_serial.cu",
     "fem_tpu/solvers/implicit.py:737"),
    # No pallas_call: the JAX package takes jax.jvp of the assembled force
    # (make_stiffness_hvp), which XLA compiles.
    ("stiffness_apply", "fem_tpu_torch/csrc/stiffness_apply.cu",
     "fem_tpu/solvers/modal.py:68"),
)


# The profiler's names of K1's, K6's, K9a's and K9b's tiled kernels
# (csrc/element_chain.cu).
K1_KERNEL = "tiled_hessian_and_force_kernel"
K6_KERNEL = "tiled_explicit_grad_columns_kernel"
K9A_KERNEL = "tiled_hessian_blocks_kernel"
K9B_KERNEL = "tiled_implicit_force_kernel"
# Element counts of the element kernels' ragged-tile checks (sections 3
# and 15): one element, one past a tile of 32, one past the flagship.
RAGGED = (1, 33, 4069)


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


def element_plan_keys(fn):
    """The kernels line's plan keys of K1's, K6's, K9a's or K9b's last launch
    (``fn.last_plan``, element_kernels.element_plan)."""
    p = fn.last_plan
    return dict(tile=p.tile, ctas=p.ctas)


def advect_plan_keys(fn):
    """The kernels line's plan keys of K10a's or K10b's last launch
    (``fn.last_plan``, advect_kernels.advect_plan)."""
    p = fn.last_plan
    return dict(tile=p.tile, ctas=p.ctas)


def advect_plan_text(fn):
    p = fn.last_plan
    return (f"{p.tile} particles a CTA, one thread each, {p.ctas} CTAs, "
            f"{p.last} in the last")


def plan_text(fn):
    p = fn.last_plan
    return (f"{p.tile} elements a CTA, one thread each, {p.ctas} CTAs, "
            f"{p.last} in the last")


def check_ragged(torch, label, obj, state):
    """K1 (Neo-Hookean), K9b, K9a and every K6 instance (Neo-Hookean and
    MATERIALS[d]) at RAGGED element counts cut from ``obj``'s (cyclically
    past its count) against their plain versions on the card:
    block-relative ≤ 1e-5, twice bit-identical.  Returns the max abs error
    of each: by counter name for the Neo-Hookean rows, by (counter, d,
    material id) for K6's material rows."""
    from fem_tpu_torch.ops import element_kernels as ek
    from fem_tpu_torch.ops.element import kernel_material_id

    d = state.pos.shape[1]
    cases = [("element_chain", ek.hessian_and_force,
              ek.hessian_and_force_plain, ()),
             ("implicit_force", ek.implicit_force_columns,
              ek.implicit_force_columns_plain, ()),
             ("hessian_blocks", ek.hessian_blocks, ek.hessian_blocks_plain,
              ())]
    cases += [("grad_columns", ek.explicit_grad_columns,
               ek.explicit_grad_columns_plain, (m,))
              for m in ("neo_hookean",) + MATERIALS[d]]
    errs = {}
    for n in RAGGED:
        idx = torch.arange(n, device=state.pos.device) % obj.element_cnt
        args = (state.pos, obj.element_indices[idx].contiguous(),
                obj.ref_inv[idx].contiguous(), obj.volume[idx].contiguous(),
                obj.mu, obj.s_lambda)
        for name, fn, plain, extra in cases:
            got, again = fn(*args, *extra), fn(*args, *extra)
            got = got if isinstance(got, tuple) else (got,)
            again = again if isinstance(again, tuple) else (again,)
            ref = plain(*args, *extra)
            ref = ref if isinstance(ref, tuple) else (ref,)
            torch.cuda.synchronize()
            rel = max(block_rel_err(g, r) for g, r in zip(got, ref))
            mid = kernel_material_id(*extra) if extra else 0
            key = (name, d, mid) if mid else name
            errs[key] = max(errs.get(key, 0.0), max(
                float((g - r).abs().max()) for g, r in zip(got, ref)))
            what = f"{name}{f' {extra[0]}' if extra else ''}"
            log(f"[{label} {what}] {n} elements: block-relative error "
                f"{rel:.3e}; plan {plan_text(fn)}")
            require(all(bool(torch.isfinite(g).all()) for g in got),
                    f"{label} {what} at {n} elements: non-finite")
            require(rel <= 1e-5, f"{label} {what} at {n} elements: "
                    f"block-relative error {rel}")
            require(all(torch.equal(g, a) for g, a in zip(got, again)),
                    f"{label} {what} at {n} elements: runs differ")
    return errs


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


# Windows in a row that the profiler may return with no device activity at
# all before the run fails.  On the H100 it has returned such windows, up
# to three in a row, for calls that did launch (their wrappers' counts say
# so); each is logged and taken again after a pause.
EMPTY_WINDOWS = 10


def profile_kernels(torch, fn, reps):
    """({kernel name: (device ms in total, launches)}, wall ms) over ``reps``
    calls of ``fn`` under torch.profiler (CUPTI, device activity only, so
    that host-side tracing slows the enqueue as little as it can), after one
    warm-up call; the wall time is that of the same profiled window.  A
    window with no device activity is taken again (EMPTY_WINDOWS)."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(EMPTY_WINDOWS):
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
        if out:
            return out, wall_ms
        log(f"[profiler] a window of {reps} calls recorded no device "
            f"activity (window {attempt + 1}); taken again")
        time.sleep(0.05 * (attempt + 1))
    require(False, f"the profiler recorded no device activity in "
            f"{EMPTY_WINDOWS} windows in a row")


def kernel_ms(torch, fn, reps, names, windows=3):
    """Device milliseconds per call of ``fn``, each of which launches every
    kernel of ``names`` once: the sum over ``names`` of the kernel's mean
    time per launch, from the profiler over ``reps`` calls.  Raises if the
    profiler saw no launch of one of them in ``windows`` windows.  (CUPTI
    may miss a launch at the window's edge, so each mean is over those
    seen; it has also returned a window with none of a kernel's launches,
    once in ~130 windows, so a window that saw none is taken again.)"""
    return kernels_ms(torch, fn, reps, [names], windows)[0]


def kernels_ms(torch, fn, reps, groups, windows=3):
    """``kernel_ms`` of each group of kernel names in ``groups``, from one
    profiled window of ``fn``, which launches every kernel of every group
    once a call."""
    names = [name for group in groups for name in group]
    for _ in range(windows):
        per_kernel, _ = profile_kernels(torch, fn, reps)
        hits = {name: [v for k, v in per_kernel.items() if name in k]
                for name in names}
        if not all(hits.values()):
            log(f"[profiler] a window of {reps} calls saw none of "
                f"{[n for n in names if not hits[n]]}; it saw "
                f"{sorted(k[:80] for k in per_kernel)}")
        if all(hits.values()):
            break
    mean = {}
    for name in names:
        launches = sum(c for _, c in hits[name])
        require(0 < launches <= reps,
                f"the profiler saw {launches} launches of {name} in {reps} "
                f"calls, in each of {windows} windows")
        mean[name] = sum(t for t, _ in hits[name]) / launches
    return [sum(mean[name] for name in group) for group in groups]


def library_device_ms(torch, fn, reps):
    """Device milliseconds per call of ``fn``, one PyTorch library call
    (the kernels line's ``library_ms``), which may launch several kernels of
    its own: the device time of every kernel the profiler saw over ``reps``
    calls, divided by ``reps`` — timed by the profiler as the port's kernels
    are (kernel_ms), so that a kernel and its yardstick are both device
    time and no launch overhead enters either."""
    per_kernel, _ = profile_kernels(torch, fn, reps)
    return sum(t for t, _ in per_kernel.values()) / reps


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


def frame_ops(e, n, slot_rows, iterations, normal, d, chain=None):
    """f32 operations of one whole frame whose substeps took
    ``iterations``: per substep the chain (``chain`` a element; default the
    Neo-Hookean one) and force rows, the rhs, the applies of its CG (each a
    G(K)·x, its slot sums and its vector work), the CG's vector work and the
    advection."""
    ops = OPS[d]
    chain = ops["chain"] if chain is None else chain
    apply = ops["apply"] * e + d * slot_rows + 4 * d * n
    total = 0
    for it in iterations:
        applies = 3 + 2 * it if normal else 1 + it
        total += ((chain + (d + 1) * d) * e + d * slot_rows
                  + 4 * d * n + applies * apply + it * 10 * d * n
                  + ops["advect"] * n)
    return total


def explicit_frame_ops(e, n, slot_rows, sim_count, d, grad=None):
    """f32 operations of one explicit frame: per substep the gradient chain
    (``grad`` a element; default the Neo-Hookean one) and rows of every
    element, the slot sums and the kinematic step."""
    ops = OPS[d]
    grad = ops["grad"] if grad is None else grad
    return sim_count * ((grad + ops["rows"]) * e + d * slot_rows
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


def k5_kernel_name():
    """The profiler's name of K5's last launch: the cluster or the grid
    variant's kernel."""
    from fem_tpu_torch.ops import frame_kernels as fk

    plan = fk.fused_blocked_frame.last_plan
    return ("cluster_frame_kernel" if plan.variant == "cluster"
            else "blocked_frame_kernel")


def k5_plan_keys(iterations, normal=True):
    """The kernels line's keys of K5's last launch, whose substeps took
    ``iterations``: its variant, CTAs, threads a CTA and the barriers the
    kernel counted in that frame, which must be those that
    ``frame_kernels.frame_barriers`` places there."""
    from fem_tpu_torch.ops import frame_kernels as fk

    plan = fk.fused_blocked_frame.last_plan
    met = int(fk.fused_blocked_frame.last_barriers.item())
    want = fk.frame_barriers(plan.variant, normal, iterations)
    require(met == want, f"K5 ({plan.variant}, {plan.size} CTAs) met {met} "
            f"barriers in a frame of iterations {list(iterations)}, where "
            f"frame_barriers places {want}")
    return dict(variant=plan.variant, ctas=plan.size, threads=plan.threads,
                barriers_per_frame=met)


def k8_kernel_name():
    """The profiler's name of K8's last launch: the cluster or the grid
    variant's kernel."""
    from fem_tpu_torch.ops import frame_kernels as fk

    plan = fk.fused_explicit_frame.last_plan
    return ("cluster_explicit_frame_kernel" if plan.variant == "cluster"
            else "explicit_frame_kernel")


def k8_plan_keys(inelastic, sim_count):
    """The kernels line's keys of K8's last launch: its variant, CTAs,
    threads a CTA and the barriers the kernel counted in that frame, which
    must be those that ``frame_kernels.explicit_frame_barriers`` places."""
    from fem_tpu_torch.ops import frame_kernels as fk

    plan = fk.fused_explicit_frame.last_plan
    met = int(fk.fused_explicit_frame.last_barriers.item())
    want = fk.explicit_frame_barriers(plan.variant, inelastic, sim_count)
    require(met == want, f"K8 ({plan.variant}, {plan.size} CTAs) met {met} "
            f"barriers in a frame of {sim_count} substeps, where "
            f"explicit_frame_barriers places {want}")
    return dict(variant=plan.variant, ctas=plan.size, threads=plan.threads,
                barriers_per_frame=met)


def k4_kernel_name():
    """The profiler's name of K4's last launch."""
    from fem_tpu_torch.ops import cg_kernels as cg

    return ("cluster_fused_cg_kernel"
            if cg.fused_cg_solve.last_plan.variant == "cluster"
            else "fused_cg_kernel")


def k4_plan_keys(normal, iterations):
    """The kernels line's keys of K4's last launch: its variant, CTAs and
    the barriers the kernel counted in that solve, which must be those that
    ``cg_kernels.fused_cg_barriers`` places."""
    from fem_tpu_torch.ops import cg_kernels as cg

    plan = cg.fused_cg_solve.last_plan
    met = int(cg.fused_cg_solve.last_barriers.item())
    want = cg.fused_cg_barriers(plan.variant, normal, iterations)
    require(met == want, f"K4 ({plan.variant}, {plan.size} CTAs) met {met} "
            f"barriers in a solve of {iterations} iterations, where "
            f"fused_cg_barriers places {want}")
    return dict(variant=plan.variant, ctas=plan.size,
                threads=256 if plan.variant == "cluster" else 1024,
                barriers_per_solve=met)


def k3_kernel_names():
    """The profiler's names of K3's last launch: the cluster variant's one
    kernel, or the two-kernel variant's pair."""
    from fem_tpu_torch.ops import blocked_kernels as bk

    if bk.blocked_graph_apply.last_plan.variant == "cluster":
        return ["cluster_blocked_matvec_kernel"]
    return ["blocked_matvec_kernel", "slot_sum_kernel"]


def k3_plan_keys():
    """The kernels line's keys of K3's last launch: its variant, CTAs,
    threads a CTA and, for the cluster variant, the barriers its kernel
    counted in that apply, which must be those that
    ``blocked_kernels.blocked_barriers`` places (the two-kernel variant has
    no barrier inside a kernel to count: None)."""
    from fem_tpu_torch.ops import blocked_kernels as bk

    plan = bk.blocked_graph_apply.last_plan
    met = None
    if plan.variant == "cluster":
        met = int(bk.blocked_graph_apply.last_barriers.item())
        want = bk.blocked_barriers(plan.variant, plan.size)
        require(met == want, f"K3 ({plan.variant}, {plan.size} CTAs) met "
                f"{met} barriers in an apply, where blocked_barriers places "
                f"{want}")
    return dict(variant=plan.variant, ctas=plan.size, threads=plan.threads,
                barriers_per_apply=met)


# The profiler's names of K2's, K7b's and K7a's kernels, by counter and
# variant: the cluster variant's one kernel, the grid variant's pair.
SOURCE_KERNELS = {
    "blocked_prep": ("cluster_blocked_prep_kernel", "blocked_prep_kernel"),
    "blocked_grad_prep": ("cluster_blocked_grad_kernel",
                          "blocked_grad_prep_kernel"),
    "blocked_assemble": ("cluster_blocked_assemble_kernel",
                         "blocked_assemble_kernel"),
}


def source_kernel_names(counter):
    """The profiler's names of the last launch of the counter's source (K2
    "blocked_prep", K7b "blocked_grad_prep", K7a "blocked_assemble")."""
    from fem_tpu_torch.ops import blocked_kernels as bk

    cluster, grid = SOURCE_KERNELS[counter]
    if getattr(bk, counter).last_plan.variant == "cluster":
        return [cluster]
    return [grid, "slot_sum_kernel"]


def source_plan_keys(counter):
    """The kernels line's keys of the last launch of K2, K7b or K7a: its
    variant, CTAs, threads a CTA and, for the cluster variant, the barriers
    its kernel counted, which must be those that
    ``blocked_kernels.blocked_barriers`` places (None for the grid
    variant)."""
    from fem_tpu_torch.ops import blocked_kernels as bk

    fn = getattr(bk, counter)
    plan = fn.last_plan
    met = None
    if plan.variant == "cluster":
        met = int(fn.last_barriers.item())
        want = bk.blocked_barriers(plan.variant, plan.size)
        require(met == want, f"{counter} ({plan.variant}, {plan.size} CTAs) "
                f"met {met} barriers in a launch, where blocked_barriers "
                f"places {want}")
    return dict(variant=plan.variant, ctas=plan.size, threads=plan.threads,
                barriers_per_launch=met)


def check_force_forms(torch, label, blk, pos, mu, lam, Kb, part, gpart,
                      bcols):
    """K2, K7b and K7a as one launch each that ends in the per-particle sum
    (their automatic plans, the cluster variant) on ``blk``: twice
    bit-identical and bit-identical to the grid variant; K2's K equal to
    the partials form's ``Kb``, its f and K7b's g within 1e-5 of the largest
    entry of the parent form (the partials ``part``/``gpart`` through
    ``blocked_scatter_sum``); K7a's assembly of ``bcols``.  Returns
    {counter: max abs difference from the parent form}."""
    from fem_tpu_torch.ops import blocked_kernels as bk
    from fem_tpu_torch.ops.blocking import blocked_scatter_sum

    args = (blk, pos, mu, lam)
    errs = {}
    for counter, call, ref in (
            ("blocked_prep", lambda **o: bk.blocked_prep_force(*args, **o),
             blocked_scatter_sum(part, blk)),
            ("blocked_grad_prep",
             lambda **o: bk.blocked_grad_force(*args, **o),
             blocked_scatter_sum(gpart, blk)),
            ("blocked_assemble", lambda **o: bk.blocked_assemble(
                blk, bcols, **o), bk.blocked_assemble_plain(blk, bcols))):
        out = call()
        out = out if isinstance(out, tuple) else (out,)
        keys = source_plan_keys(counter)
        require(keys["variant"] == "cluster",
                f"{label} {counter}: the plan chose {keys}")
        again = call()
        grid = call(grid=True)
        again = again if isinstance(again, tuple) else (again,)
        grid = grid if isinstance(grid, tuple) else (grid,)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(out, again)),
                f"{label} {counter}: two runs differ")
        require(all(torch.equal(a, b) for a, b in zip(out, grid)),
                f"{label} {counter}: the cluster variant differs from the "
                f"grid variant")
        if counter == "blocked_prep":
            require(torch.equal(out[0], Kb),
                    f"{label} K2: K differs from the partials form's")
        err = float((out[-1] - ref).abs().max())
        top = float(ref.abs().max())
        log(f"[{label} {counter}] one launch {keys}: the sums' max abs "
            f"difference from the parent form {err:.3e} of max {top:.3e}; "
            f"twice bit-identical and equal to the grid variant")
        require(top > 0 and err <= 1e-5 * top,
                f"{label} {counter}: {err} from the parent form of {top}")
        errs[counter] = err
    return errs


def k11a_kernel_name():
    """The profiler's name of K11a's last launch."""
    from fem_tpu_torch.experiments import edge_cg

    return ("cluster_edge_cg_kernel"
            if edge_cg.cg_solve_edge.last_plan.variant == "cluster"
            else "edge_cg_kernel")


def k11a_plan_keys(normal, iterations):
    """The kernels line's keys of K11a's last launch: its variant, CTAs and
    the barriers the kernel counted in that solve, which must be those that
    ``edge_cg.edge_cg_barriers`` places."""
    from fem_tpu_torch.experiments import edge_cg

    plan = edge_cg.cg_solve_edge.last_plan
    met = int(edge_cg.cg_solve_edge.last_barriers.item())
    want = edge_cg.edge_cg_barriers(plan.variant, normal, iterations)
    require(met == want, f"K11a ({plan.variant}, {plan.size} CTAs) met {met} "
            f"barriers in a solve of {iterations} iterations, where "
            f"edge_cg_barriers places {want}")
    return dict(variant=plan.variant, ctas=plan.size,
                threads=256 if plan.variant == "cluster" else 1024,
                barriers_per_solve=met)


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
    from fem_tpu_torch.ops.blocking import blocked_scatter_sum

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
        return library_device_ms(torch, lib_fn, 200)

    k1_args = (state.pos, obj.element_indices, obj.ref_inv, obj.volume,
               obj.mu, obj.s_lambda)
    K, H = ek.hessian_and_force(*k1_args)
    put("element_chain", lambda: ek.hessian_and_force(*k1_args),
        lambda: ek.hessian_and_force_plain(*k1_args), 20, 200,
        [K1_KERNEL], nbytes(*k1_args[:4], K, H),
        ops["chain"] * e, **element_plan_keys(ek.hessian_and_force))

    solve = (K, H, obj.element_indices, obj.plan, state.vel, obj.mass,
             frame_kw["dt"], True)
    it = int(cg.fused_cg_solve(*solve)[1])
    k4_keys = k4_plan_keys(True, it)
    put("fused_cg", lambda: cg.fused_cg_solve(*solve),
        lambda: cg.fused_cg_solve_plain(*solve), 5, 100, [k4_kernel_name()],
        nbytes(K, H, obj.element_indices, obj.plan.ptr, obj.plan.rows,
               state.vel, obj.mass, state.vel) + 8,
        cg_ops(e, n, it, True, d), iterations=it, **k4_keys)

    k2_args = (blk, state.pos, obj.mu, obj.s_lambda)
    Kb, part = bk.blocked_prep(*k2_args)
    Kb, f2 = bk.blocked_prep_force(*k2_args)
    put("blocked_prep", lambda: bk.blocked_prep_force(*k2_args),
        lambda: bk.blocked_prep_force_plain(*k2_args), 20, 200,
        source_kernel_names("blocked_prep"),
        nbytes(state.pos, blk.ref_inv, blk.volume, *tables, *plan, Kb, f2),
        ops["chain"] * e + d * slot_rows,
        **source_times(torch, "blocked_prep",
                       lambda **o: bk.blocked_prep_force(*k2_args, **o),
                       lambda: blocked_scatter_sum(
                           bk.blocked_prep(*k2_args)[1], blk)))

    k3_args = (blk, Kb, x, False)
    y = bk.blocked_graph_apply(*k3_args)
    k3_keys, k3_names = k3_plan_keys(), k3_kernel_names()
    gmat = graph_matrix(torch, obj.element_indices, K, n)
    xcol = x.reshape(-1, 1)
    # The same function: G(K) in element order equals G(K) in block order.
    lib = library_ms("K3", lambda: torch.sparse.mm(gmat, xcol).reshape(n, d),
                     y)
    put("blocked_matvec", lambda: bk.blocked_graph_apply(*k3_args),
        lambda: bk.blocked_graph_apply_plain(*k3_args), 20, 200, k3_names,
        nbytes(Kb, x, *tables, *plan, y),
        ops["apply"] * e + d * slot_rows, library=lib, **k3_keys)

    k5_args = (blk, state.pos, state.vel, state.vel_g, obj.mass,
               obstacles.centers, obstacles.radii)
    k5_out = fk.fused_blocked_frame(*k5_args, preconditioned=True, **frame_kw)
    k5_iters = k5_out[3].tolist()
    k5_keys = k5_plan_keys(k5_iters)
    put("blocked_frame",
        lambda: fk.fused_blocked_frame(*k5_args, preconditioned=True,
                                       **frame_kw),
        lambda: fk.fused_blocked_frame_plain(*k5_args, preconditioned=True,
                                             **frame_kw),
        3, FRAMES, [k5_kernel_name()],
        nbytes(blk.ref_inv, blk.volume, *tables, *plan, obj.mass,
               obstacles.centers, obstacles.radii, state.pos, state.vel,
               state.vel_g, *k5_out),
        frame_ops(e, n, slot_rows, k5_iters, True, d), iterations=k5_iters,
        **k5_keys)

    G = ek.explicit_grad_columns(*k1_args)
    put("grad_columns", lambda: ek.explicit_grad_columns(*k1_args),
        lambda: ek.explicit_grad_columns_plain(*k1_args), 20, 200,
        [K6_KERNEL], nbytes(*k1_args[:4], G),
        ops["grad"] * e, **element_plan_keys(ek.explicit_grad_columns))

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
        source_kernel_names("blocked_assemble"),
        nbytes(bcols, blk.block_elements, blk.local_ptr, blk.local_rows,
               *plan, ysum),
        ops["rows"] * e + d * slot_rows, library=lib,
        **source_times(torch, "blocked_assemble",
                       lambda **o: bk.blocked_assemble(blk, bcols, **o)))

    g = bk.blocked_grad_force(*k2_args)
    put("blocked_grad_prep", lambda: bk.blocked_grad_force(*k2_args),
        lambda: bk.blocked_grad_force_plain(*k2_args), 20, 200,
        source_kernel_names("blocked_grad_prep"),
        nbytes(state.pos, blk.ref_inv, blk.volume, *tables, *plan, g),
        (ops["grad"] + ops["rows"]) * e + d * slot_rows,
        **source_times(torch, "blocked_grad_prep",
                       lambda **o: bk.blocked_grad_force(*k2_args, **o),
                       lambda: blocked_scatter_sum(
                           bk.blocked_grad_prep(*k2_args), blk)))

    k8_args = (blk, state.pos, state.vel, obj.mass, obstacles.centers,
               obstacles.radii)
    k8_out = fk.fused_explicit_frame(*k8_args, **ekw)
    k8_keys = k8_plan_keys(False, ekw["sim_count"])
    put("explicit_frame", lambda: fk.fused_explicit_frame(*k8_args, **ekw),
        lambda: fk.fused_explicit_frame_plain(*k8_args, **ekw), 5, FRAMES,
        [k8_kernel_name()],
        nbytes(blk.ref_inv, blk.volume, *tables, *plan, obj.mass,
               obstacles.centers, obstacles.radii, state.pos, state.vel,
               *k8_out),
        explicit_frame_ops(e, n, slot_rows, ekw["sim_count"], d), **k8_keys)
    return out


def source_times(torch, counter, call, parent_form=None):
    """The kernels line's extra times of K2, K7b or K7a (counter), each
    device ms a call (profiler): its plan's launch with its keys
    (``source_plan_keys``), the grid variant (``grid_ms``) and, for K2
    and K7b, the parent's form — the partials form and PyTorch's slot sum,
    every kernel of it (``parent_form_ms``)."""
    call()
    out = source_plan_keys(counter)
    call(grid=True)
    out["grid_ms"] = kernel_ms(torch, lambda: call(grid=True), 200,
                               source_kernel_names(counter))
    if parent_form is not None:
        out["parent_form_ms"] = library_device_ms(torch, parent_form, 200)
    call()
    return out


def kernel_rows(d, times, launches, errors, card):
    """The kernels line's rows of dimension ``d``, each logged."""
    rows = []
    for name, source, replaces in KERNELS:
        if name in ("jacobi_serial", "stiffness_apply"):
            continue  # their rows come from sections 53-58 and 75-79
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
        f"{errs['element_chain']:.3e}; plan {plan_text(ek.hessian_and_force)}")
    require(rel <= 1e-5, f"2D K1 block-relative error {rel}")
    errs["ragged"] = check_ragged(torch, "2D", obj, state)

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
        f"{errs['grad_columns']:.3e}; plan "
        f"{plan_text(ek.explicit_grad_columns)}")
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
    for name, err in check_force_forms(torch, "2D", blk, state.pos, obj.mu,
                                       obj.s_lambda, Kb, part, gpart,
                                       bcols).items():
        errs[name] = max(errs[name], err)

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


def incidence_t(torch, blk, n):
    """The transpose of :func:`incidence_matrix` ((d·B·Eb) × N, CSR): row
    d·s + j of real slot s takes +1 at its vertex j+1 and −1 at its vertex
    0, so its product with the positions is the slot's edge column j."""
    import warnings

    warnings.filterwarnings("ignore", "Sparse CSR tensor support is in beta")
    d = blk.dim
    slots = torch.nonzero(blk.volume > 0).reshape(-1)
    idx = blk.element_indices[slots].long()
    rows = (d * slots[:, None] + torch.arange(d, device=slots.device)).reshape(-1)
    cols = torch.cat([idx[:, 1:].reshape(-1),
                      idx[:, :1].expand(-1, d).reshape(-1)])
    vals = torch.cat([torch.ones(rows.numel(), device=slots.device),
                      -torch.ones(rows.numel(), device=slots.device)])
    coo = torch.sparse_coo_tensor(
        torch.stack([torch.cat([rows, rows]), cols]), vals,
        (d * blk.volume.numel(), n)).coalesce()
    return coo.to_sparse_csr()


def state_err(a, b):
    """Max |a − b| over positions and the internal inverses (a on the card,
    b on the CPU)."""
    err = 0.0
    for name in ("pos", "plastic_inv", "viscous_inv"):
        x, y = getattr(a, name), getattr(b, name)
        require((x is None) == (y is None), f"{name} present on one side")
        if x is not None:
            e = float((x.cpu() - y).abs().max())
            err = max(err, e if e == e else float("inf"))  # NaN counts as inf
    return err


def fi_moved(state):
    """max |F_i⁻¹ − I| of each internal inverse of ``state``."""
    import torch

    out = {}
    for name in ("plastic_inv", "viscous_inv"):
        fi = getattr(state, name)
        if fi is not None:
            eye = torch.eye(fi.shape[-1], device=fi.device)
            out[name] = float((fi - eye).abs().max())
    return out


def squashed_plastic(torch, state, seed):
    """A body of demo_plastic.json pressed into the floor: 0.7 down,
    squashed 30 % in y and stretched 20 % in x about its centroid, with
    seeded velocities — its first frames yield."""
    dev = state.pos.device
    c = state.pos.mean(dim=0, keepdim=True)
    pos = (c + (state.pos - c) * torch.tensor([[1.2, 0.7]], device=dev)
           - torch.tensor([[0.0, 0.7]], device=dev))
    gen = torch.Generator().manual_seed(seed)
    vel = (0.6 * torch.rand(state.vel.shape, generator=gen) - 0.3).to(dev)
    return state.replace(pos=pos, vel=vel)


def inelastic_kwargs(obj, state):
    return dict(plastic_inv=state.plastic_inv, plastic_yield=obj.plastic_yield,
                viscous_inv=state.viscous_inv, viscous_mu=obj.viscous_mu,
                viscous_tau=obj.viscous_tau)


def golden_plastic_check(torch, body, state):
    """Hold a 200-frame arc of demo_plastic.json's ``body`` to its goldens
    (tests/test_torch_inelastic.py's tolerances)."""
    p = state.pos.cpu().double()
    fi = (state.plastic_inv if body == 0 else state.viscous_inv).cpu().double()
    g = GOLDEN_PLASTIC[body]
    mean, std = float(p.mean()), float(p.std(correction=0))
    worst = max(float((p[i] - torch.tensor(g[k], dtype=torch.float64))
                      .abs().max())
                for k, i in (("p0", 0), ("p60", 60), ("p120", 120)))
    max_fi = float((fi - torch.eye(2, dtype=torch.float64)).abs().max())
    log(f"[golden demo_plastic body {body}] mean {mean:.7f} (golden "
        f"{g['mean']}), std {std:.7f} (golden {g['std']}), particles "
        f"0/60/120 within {worst:.3e}, max |F_i^-1 - I| {max_fi:.5f} "
        f"(golden {g['max_fi']})")
    require(bool(torch.isfinite(p).all()), f"golden body {body} non-finite")
    require(abs(mean - g["mean"]) < 5e-3 and abs(std - g["std"]) < 5e-3,
            f"golden body {body} mean/std")
    require(worst <= 1e-2, f"golden body {body} particles off by {worst}")
    require(abs(max_fi - g["max_fi"]) <= 0.1 * g["max_fi"],
            f"golden body {body} max |F_i^-1 - I| {max_fi}")


def run_inelastic(torch, dev, zero_counts, counts, only):
    """Sections 21-26: the inelastic kernels and paths M-Q.  Returns the
    launch counts and errors of the kernels line's new rows by dimension,
    the profiled windows and the inputs their timing reuses."""
    from fem_tpu_torch import convert, entry, scene, sim
    from fem_tpu_torch.ops import (
        blocked_kernels as bk,
        element_kernels as ek,
        frame_kernels as fk,
        inelastic,
    )
    from fem_tpu_torch.solvers import explicit
    from fem_tpu_torch.utils.config import read_config

    def cpu_state(s):
        return convert.state_from_arrays(convert.state_to_arrays(s), "cpu")

    def cpu_obj(o):
        return convert.object_from_arrays(*convert.object_to_arrays(o), "cpu")

    def twice(fn, args, kwargs):
        a, b = fn(*args, **kwargs), fn(*args, **kwargs)
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        require(all(torch.equal(x, y) for x, y in zip(a, b)),
                f"{fn.__name__} runs differ")
        return a

    pcfg = read_config(os.path.join(REPO, "configs", "demo_plastic.json"))
    bodies, pobs = scene.load_scene(pcfg, device=dev)
    cbodies, cpobs = scene.load_scene(pcfg, device="cpu")
    require(len(bodies) == 2 and all(
        (b.obj.particle_cnt, b.obj.element_cnt, b.obj.blocking.num_blocks)
        == (121, 200, 1) for b in bodies), "demo_plastic.json's bodies")
    require(bodies[0].obj.plastic_yield == 0.04 and
            bodies[1].obj.viscous_mu == 3e4, "demo_plastic.json's materials")
    ncfg = dataclasses.replace(pcfg, **OVERRIDES_2D["implicit_cg"])
    squashed = [squashed_plastic(torch, b.state, i)
                for i, b in enumerate(bodies)]
    ocfg, oobj, ostate0, oobs = entry.flagship(dev, plastic_yield=0.01)
    ostate = entry.deformed(ostate0)
    ecfg, eobj, estate, eobs = entry.explicit_flagship(
        dev, plastic_yield=0.01, viscous_mu=2e4, viscous_tau=0.01)
    edeformed = entry.deformed(estate)
    require(oobj.blocking.num_blocks == eobj.blocking.num_blocks == 17,
            "the inelastic flagship's blocks")
    errors = {2: {}, 3: {}}
    launches = {2: {}, 3: {}}

    # -- 21. the inelastic kernels against their plain versions ------------
    def frame_kw(obj, cfg, implicit):
        kw = dict(dt=cfg.delta_time, damping=obj.damping,
                  g_dir=tuple(cfg.g_dir), mu=obj.mu, s_lambda=obj.s_lambda,
                  sim_count=cfg.sim_count)
        if implicit:
            kw["preconditioned"] = True
        return kw

    def check_frame(label, implicit, obj, state, obs, kw, grid=0):
        d = obj.dim
        if implicit:
            args = (obj.blocking, state.pos, state.vel, state.vel_g, obj.mass,
                    obs.centers, obs.radii)
            fn, plain = fk.fused_blocked_frame, fk.fused_blocked_frame_plain
        else:
            args = (obj.blocking, state.pos, state.vel, obj.mass, obs.centers,
                    obs.radii)
            fn, plain = fk.fused_explicit_frame, fk.fused_explicit_frame_plain
        ikw = inelastic_kwargs(obj, state)
        out = twice(fn, args, dict(kw, grid=grid, **ikw))
        ref = plain(*args, **kw, **ikw)
        err = float((out[0] - ref[0]).abs().max())
        serr = max(float((a - b).abs().max())
                   for a, b in zip(out[-len(ikw_states(ikw)):],
                                   ref[-len(ikw_states(ikw)):]))
        moved = max(float((a - b).abs().max()) for a, b in
                    zip(out[-len(ikw_states(ikw)):], ikw_states(ikw)))
        name = "blocked_frame_inelastic" if implicit else \
            "explicit_frame_inelastic"
        errors[d][name] = max(errors[d].get(name, 0.0), err, serr)
        extra = ""
        if implicit:
            it, itp = out[3].tolist(), ref[3].tolist()
            extra = f"; iterations {it} (plain {itp})"
            if max(itp) <= 20:
                require(all(abs(a - b) <= 1 for a, b in zip(it, itp)),
                        f"{label} iterations differ")
        log(f"[{d}D {'K5' if implicit else 'K8'} inelastic] {label} "
            f"({obj.blocking.num_blocks} blocks, grid {grid or 'auto'}): max "
            f"|dpos| {err:.3e}, max |dF_i^-1| {serr:.3e}, state moved "
            f"{moved:.3e}{extra}")
        require(bool(torch.isfinite(out[0]).all()), f"{label} non-finite")
        require(err <= 1e-5 and serr <= 1e-5, f"{label} off the plain frame")
        require(moved > 1e-5, f"{label}: the internal state never moved")

    def ikw_states(ikw):
        return [v for k, v in ikw.items() if k.endswith("_inv") and v is not None]

    # The 40-subdivision grid (16 blocks; side 0.8, so that an element's
    # edge, 0.02, is long beside the positions' rounding that its F⁻¹
    # divides by) with both branches, stretched 10 % and with perturbed
    # internal inverses: a wrong element order or a missing barrier shows.
    gcfg = dataclasses.replace(pcfg, objects=(dataclasses.replace(
        pcfg.objects[0], subdivisions=40, side_length=0.8,
        center=(0.5, 0.45), viscous_mu=1e4, viscous_tau=0.03,
        plastic_yield=0.02),))
    (gbody,), gobs = scene.load_scene(gcfg, device=dev)
    lin_obj = gbody.obj
    require(lin_obj.blocking.num_blocks == 16, "the 40-subdivision grid")
    gen = torch.Generator().manual_seed(3)
    c = gbody.state.pos.mean(dim=0, keepdim=True)
    lin_state = gbody.state.replace(
        pos=c + (gbody.state.pos - c) * torch.tensor([[1.1, 0.9]], device=dev),
        vel=(0.6 * torch.rand(gbody.state.vel.shape, generator=gen)
             - 0.3).to(dev),
        plastic_inv=(torch.eye(2) + 0.03 * torch.randn(
            (lin_obj.element_cnt, 2, 2), generator=gen)).to(dev),
        viscous_inv=(torch.eye(2) + 0.03 * torch.randn(
            (lin_obj.element_cnt, 2, 2), generator=gen)).to(dev))
    lobs = gobs
    for implicit in (False, True):
        for i, b in enumerate(bodies):
            check_frame(f"demo_plastic body {i} squashed", implicit, b.obj,
                        squashed[i], pobs, frame_kw(b.obj, pcfg, implicit))
        lkw = frame_kw(lin_obj, pcfg, implicit)
        lkw["dt"] = 2e-4
        for grid in (0, 3):
            check_frame("40 subdivisions, both branches", implicit, lin_obj,
                        lin_state, lobs, lkw, grid)
    check_frame("path O deformed", True, oobj, ostate, oobs,
                frame_kw(oobj, ocfg, True))
    check_frame("path P deformed", False, eobj, edeformed, eobs,
                frame_kw(eobj, ecfg, False))

    for d, obj, state in ((2, bodies[0].obj, squashed[0]),
                          (3, oobj, ostate), (2, lin_obj, lin_state)):
        (x,) = twice(bk.blocked_edges, (obj.blocking, state.pos), {})
        xp = bk.blocked_edges_plain(obj.blocking, state.pos)
        err, top = float((x - xp).abs().max()), float(xp.abs().max())
        errors[d]["blocked_edges"] = max(errors[d].get("blocked_edges", 0.0),
                                         err)
        log(f"[{d}D K7b edges] {obj.blocking.num_blocks} blocks: max abs "
            f"error {err:.3e} of max {top:.3e}")
        require(err <= 1e-5 * top, f"{d}D K7b edges error {err} of {top}")

    # The layered chains: each layer's dynamic R and material.
    for d, obj, state in ((2, bodies[1].obj, squashed[1]),
                          (3, eobj, edeformed)):
        worst = 0.0
        for fi, mu, lam, material in inelastic.material_layers(obj, state):
            r = inelastic.layer_ref_inv_local(obj.ref_inv, fi)
            rb = inelastic.layer_ref_inv_blocked(obj.blocking, fi)
            args = (state.pos, obj.element_indices, r, obj.volume, mu, lam)
            K, H = twice(ek.hessian_and_force, args, dict(material=material))
            Kp, Hp = ek.hessian_and_force_plain(*args, material)
            G = twice(ek.explicit_grad_columns, args + (material,), {})[0]
            Gp = ek.explicit_grad_columns_plain(*args, material)
            bargs = (obj.blocking, state.pos, mu, lam, rb, material)
            Kb, part = twice(bk.blocked_prep, bargs, {})
            Kbp, partp = bk.blocked_prep_plain(*bargs)
            gpart = twice(bk.blocked_grad_prep, bargs, {})[0]
            gpartp = bk.blocked_grad_prep_plain(*bargs)
            rel = max(block_rel_err(K, Kp), block_rel_err(H, Hp),
                      block_rel_err(G, Gp), block_rel_err(Kb, Kbp))
            perr = max(
                float((part - partp).abs().max()) / float(partp.abs().max()),
                float((gpart - gpartp).abs().max())
                / float(gpartp.abs().max()))
            worst = max(worst, rel, perr)
            log(f"[{d}D layer {material}, dynamic R] K1/K6/K2 block-relative "
                f"error {rel:.3e}; K2/K7b partials relative error {perr:.3e}")
            require(rel <= 1e-5 and perr <= 1e-5,
                    f"{d}D layer {material} off its plain versions")
    log("[inelastic kernels] two runs bit-identical in every case")

    # -- 22. path M: demo_plastic.json as shipped ---------------------------
    frames_m = [sim.make_frame_fn(b.obj, pcfg) for b in bodies]
    worst = 0.0
    for f, b, cb in zip(frames_m, bodies, cbodies):
        warm, _ = f(b.state, pobs)
        ref, _ = sim.make_frame_fn(cb.obj, dataclasses.replace(
            pcfg, frame_backend="blocked_explicit"))(cb.state, cpobs)
        worst = max(worst, state_err(warm, ref))
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    states = [b.state for b in bodies]
    lowest = []
    for _ in range(GOLDEN_FRAMES):
        states = [f(s, pobs)[0] for f, s in zip(frames_m, states)]
        lowest.append(torch.stack([s.pos[:, 1].min() for s in states]))
    lowest = torch.stack(lowest).cpu()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    moved = [fi_moved(s) for s in states]
    log(f"[path M] demo_plastic.json: {GOLDEN_FRAMES} frames x "
        f"{pcfg.sim_count} substeps of both bodies in {wall:.4f} s: "
        f"{GOLDEN_FRAMES * pcfg.sim_count / wall:.1f} steps/s (a step "
        f"advances both bodies); launches {got}; first frames vs the CPU: "
        f"max |dstate| {worst:.3e}; lowest y of each body at frames "
        f"0/130/180/199 {[lowest[i].tolist() for i in (0, 130, 180, 199) if i < len(lowest)]}; max "
        f"|F_i^-1 - I| {moved}")
    require(got == only(explicit_frame=2 * GOLDEN_FRAMES),
            f"path M launches {got}")
    require(worst <= 1e-5, f"path M off the CPU frames by {worst}")
    require(moved[0]["plastic_inv"] > 1e-3, "path M: body 0 never yielded")
    require(moved[1]["viscous_inv"] > 1e-4, "path M: body 1's F_v never moved")
    for i, s in enumerate(states):
        golden_plastic_check(torch, i, s)
    launches[2]["explicit_frame_inelastic"] = got["explicit_frame"]

    def frame_path(label, cfg, key, backend, pairs, frames):
        """``frames`` frames of each (object, state, obstacles, CPU object,
        CPU state, CPU obstacles) of ``pairs`` through make_frame_fn,
        launching ``key`` once a frame per body and nothing else; the first
        frames equal to the CPU's ``backend`` frames."""
        fns = [sim.make_frame_fn(p[0], cfg) for p in pairs]
        worst, its = 0.0, []
        for f, (o, s, obs, co, cs, cobs) in zip(fns, pairs):
            warm, waux = f(s, obs)
            ref, raux = sim.make_frame_fn(co, dataclasses.replace(
                cfg, frame_backend=backend))(cs, cobs)
            worst = max(worst, state_err(warm, ref))
            it, itp = waux.solver_iterations.tolist(), \
                raux.solver_iterations.tolist()
            its.append((it, itp))
            if max(itp) <= 20:
                require(all(abs(a - b) <= 1 for a, b in zip(it, itp)),
                        f"path {label} iterations differ")
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        states = [p[1] for p in pairs]
        for _ in range(frames):
            states = [f(s, p[2])[0] for f, s, p in zip(fns, states, pairs)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
        log(f"[path {label}] {frames} frames x {cfg.sim_count} substeps (dt "
            f"{cfg.delta_time}) of {len(pairs)} bodies in {wall:.4f} s: "
            f"{frames * cfg.sim_count / wall:.1f} steps/s; launches {got}; "
            f"first frames vs the CPU: max |dstate| {worst:.3e}, iterations "
            f"(card, CPU) {its}; max |F_i^-1 - I| "
            f"{[fi_moved(s) for s in states]}")
        require(got == only(**{key: frames * len(pairs)}),
                f"path {label} launches {got}")
        require(all(bool(torch.isfinite(s.pos).all()) for s in states),
                f"path {label} non-finite")
        require(worst <= 1e-5, f"path {label} off the CPU frames by {worst}")
        return got[key], fns, states

    # -- 23. path N: the implicit variant, squashed into the floor ----------
    pairs_n = [(b.obj, squashed[i], pobs, cb.obj, cpu_state(squashed[i]),
                cpobs) for i, (b, cb) in enumerate(zip(bodies, cbodies))]
    launches[2]["blocked_frame_inelastic"], frames_n, _ = frame_path(
        "N (demo_plastic.json, implicit_cg, squashed)", ncfg, "blocked_frame",
        "blocked", pairs_n, FRAMES_N)

    # -- 24./25. paths O and P: the inelastic flagship ------------------------
    co = cpu_obj(oobj)
    ceo = cpu_obj(eobj)
    cobs = type(oobs)(oobs.centers.cpu(), oobs.radii.cpu())
    launches[3]["blocked_frame_inelastic"], frames_o, _ = frame_path(
        "O (flagship, plastic_yield 0.01, K5)", ocfg, "blocked_frame",
        "blocked", [(oobj, ostate, oobs, co, cpu_state(ostate), cobs)], FRAMES)
    launches[3]["explicit_frame_inelastic"], frames_p, _ = frame_path(
        "P (explicit flagship, plastic + Maxwell, K8)", ecfg,
        "explicit_frame", "blocked_explicit",
        [(eobj, estate, eobs, ceo, cpu_state(estate), cobs)], FRAMES)

    # -- 26. path Q: the op-composed layered substeps ------------------------
    icfg3 = dataclasses.replace(ecfg, use_explicit_method=False,
                                delta_time=ocfg.delta_time)
    scenes_q = [
        (2, f"demo_plastic body {i}", b.obj, squashed[i], pobs, cb.obj,
         cpobs, ncfg, pcfg)
        for i, (b, cb) in enumerate(zip(bodies, cbodies))
    ] + [(3, "path P body deformed", eobj, edeformed, eobs, ceo, cobs, icfg3,
          ecfg)]
    for d, label, obj, state, obs, cobj, cobs_, icfg, xcfg in scenes_q:
        n_layers = len(inelastic.material_layers(obj, state))
        edges_total = 0
        cst = cpu_state(state)
        for setting, c, unblocked in (
            ("C (K1 + K4)", icfg, False),
            ("B (K2 + K3: operator_mode=blocked)",
             dataclasses.replace(icfg, operator_mode="blocked"), False),
            ("E (K7b: element_backend=auto)", xcfg, False),
            ("F (auto_diff)", dataclasses.replace(xcfg, auto_diff=True), False),
            ("F (element_backend=xla)",
             dataclasses.replace(xcfg, element_backend="xla"), False),
            ("G (K6: no blocks)", xcfg, True),
        ):
            o = dataclasses.replace(obj, blocking=None) if unblocked else obj
            co_ = dataclasses.replace(cobj, blocking=None) if unblocked \
                else cobj
            kw = sim.substep_kwargs(c)
            zero_counts()
            s, first, iters = state, None, []
            for i in range(SUBSTEPS_Q):
                s, aux = sim.substep(o, s, obs, **kw)
                iters.append(aux.solver_iterations)
                if i == 0:
                    first = s
            iters = [int(v) for v in torch.stack(iters).cpu()]
            torch.cuda.synchronize()
            got = counts()
            n = SUBSTEPS_Q
            edges = 0 if unblocked else n
            if setting.startswith("C"):
                want = only(element_chain=n_layers * n, fused_cg=n,
                            blocked_edges=edges)
            elif setting.startswith("B"):
                want = only(blocked_prep=n_layers * n, blocked_edges=edges,
                            blocked_matvec=sum(3 + 2 * it for it in iters))
            elif "xla" in setting:
                want = only(blocked_assemble=n, blocked_edges=edges)
            elif unblocked:
                want = only(grad_columns=n_layers * n)
            else:
                want = only(blocked_grad_prep=n_layers * n,
                            blocked_edges=edges)
            ref, _ = sim.substep(co_, cst, cobs_, **kw)
            err = state_err(first, ref)
            log(f"[path Q {d}D {label}: {setting}] {n} substeps, {n_layers} "
                f"layers; launches {got}; CG iterations {iters}; first "
                f"substep vs the CPU: max |dstate| {err:.3e}; max "
                f"|F_i^-1 - I| {fi_moved(s)}")
            require(got == want, f"path Q {label} {setting} launches {got}")
            require(bool(torch.isfinite(s.pos).all()),
                    f"path Q {label} {setting} non-finite")
            require(err <= 1e-5, f"path Q {label} {setting} off the CPU by "
                    f"{err}")
            edges_total += got["blocked_edges"]
        launches[d]["blocked_edges"] = launches[d].get("blocked_edges", 0) \
            + edges_total

    windows = [
        ("path M (K8 2D inelastic, two bodies)", frames_m,
         [b.state for b in bodies], pobs, FRAMES),
        ("path N (K5 2D inelastic, two bodies)", frames_n, squashed, pobs,
         FRAMES_N),
        ("path O (K5 3D plastic)", frames_o, [ostate], oobs, FRAMES),
        ("path P (K8 3D plastic + Maxwell)", frames_p, [estate], eobs, FRAMES),
    ]
    # Path Q's explicit layered substep (setting E), one substep a "frame":
    # K7b per layer, the kinematic step, K7b edges and the plain update.
    for label, obj, start, obs, cfg in (
            ("2D demo_plastic body 1", bodies[1].obj, squashed[1], pobs, pcfg),
            ("3D path P body", eobj, edeformed, eobs, ecfg)):
        kw = sim.substep_kwargs(cfg)
        windows.append((
            f"path Q {label} (one explicit layered substep a frame)",
            [lambda s, o, obj=obj, kw=kw: sim.substep(obj, s, o, **kw)],
            [start], obs, SUBSTEPS_Q))
    timing = {
        2: dict(edges=(bodies[0].obj, squashed[0]),
                k5=(bodies[0].obj, squashed[0], pobs, frame_kw(
                    bodies[0].obj, ncfg, True)),
                k8=(bodies[0].obj, bodies[0].state, pobs, frame_kw(
                    bodies[0].obj, pcfg, False))),
        3: dict(edges=(oobj, ostate),
                k5=(oobj, ostate, oobs, frame_kw(oobj, ocfg, True)),
                k8=(eobj, estate, eobs, frame_kw(eobj, ecfg, False))),
    }
    return dict(errors=errors, launches=launches, windows=windows,
                timing=timing)


def time_inelastic_kernels(torch, d, timing):
    """K7b edges' and the inelastic K5's and K8's device ms a launch
    (profiler), their plain versions' ms, their bounds and, for K7b edges,
    one PyTorch sparse product's ms: {row name: dict of the kernels line's
    time keys}."""
    from fem_tpu_torch.ops import blocked_kernels as bk, frame_kernels as fk

    ops = OPS[d]
    out = {}

    def put(name, kernel, plain, plain_reps, reps, key, moved, work,
            library=None, **extra):
        bnd, by = bound(moved, work)
        out[name] = dict(ms=kernel_ms(torch, kernel, reps, [key]),
                         plain_ms=cuda_ms(torch, plain, plain_reps),
                         bound_ms=bnd, bound_by=by, library_ms=library,
                         **extra)

    obj, state = timing["edges"]
    blk = obj.blocking
    n = obj.particle_cnt
    x = bk.blocked_edges(blk, state.pos)
    smat = incidence_t(torch, blk, n)
    real = (blk.volume > 0).reshape(-1)
    lib_x = torch.sparse.mm(smat, state.pos).reshape(-1, d, d).transpose(1, 2)
    err = float((lib_x[real] - x[real]).abs().max())
    log(f"[K7b edges] torch.sparse.mm vs the kernel ({d}D): max abs "
        f"difference {err:.3e} on the real slots")
    require(err <= 1e-6, f"library K7b edges differs ({d}D)")
    lib = library_device_ms(torch, lambda: torch.sparse.mm(smat, state.pos),
                            200)
    e_real = int(real.sum())
    e_pad = blk.volume.numel() - e_real
    put("blocked_edges", lambda: bk.blocked_edges(blk, state.pos),
        lambda: bk.blocked_edges_plain(blk, state.pos), 20, 200,
        "blocked_edges_kernel",
        nbytes(state.pos, blk.block_particles, blk.plus, blk.minus,
               blk.block_elements, x) + 4 * d * d * e_pad,
        ops["edges"] * e_real + ops["rest_inv"] * e_pad, library=lib,
        variant=f"{EDGE_CTAS} CTAs a block", ctas=blk.num_blocks * EDGE_CTAS,
        threads=(-(-blk.eb // EDGE_CTAS) + 31) // 32 * 32,
        barriers_per_launch=0)

    def inelastic_extra(obj, state, sim_count, implicit):
        n_states = sum(fi is not None for fi in (state.plastic_inv,
                                                  state.viscous_inv))
        per = (ops["reff"] * n_states + ops["update_guard"]
               + ops["update_state"] * n_states)
        if state.viscous_inv is not None:
            per += ops["snh_chain" if implicit else "snh_grad"]
        state_bytes = 2 * n_states * 4 * d * d * obj.element_cnt \
            + obj.blocking.element_perm.numel() * 4
        return sim_count * per * obj.element_cnt, state_bytes

    obj, state, obs, kw = timing["k5"]
    blk = obj.blocking
    ikw = inelastic_kwargs(obj, state)
    args = (blk, state.pos, state.vel, state.vel_g, obj.mass, obs.centers,
            obs.radii)
    k5_out = fk.fused_blocked_frame(*args, **kw, **ikw)
    iters = k5_out[3].tolist()
    k5_keys = k5_plan_keys(iters)
    k5_name = k5_kernel_name()
    more_ops, more_bytes = inelastic_extra(obj, state, kw["sim_count"], True)
    tables = (blk.block_particles, blk.plus, blk.minus, blk.block_elements,
              blk.local_ptr, blk.local_rows)
    plan = (blk.slot_plan.ptr, blk.slot_plan.rows)
    slot_rows = blk.slot_plan.rows.numel()
    put("blocked_frame_inelastic", lambda: fk.fused_blocked_frame(
            *args, **kw, **ikw),
        lambda: fk.fused_blocked_frame_plain(*args, **kw, **ikw), 2, FRAMES_N,
        k5_name,
        nbytes(blk.ref_inv, blk.volume, *tables, *plan, obj.mass,
               obs.centers, obs.radii, state.pos, state.vel, state.vel_g,
               *k5_out[:5]) + more_bytes,
        frame_ops(obj.element_cnt, obj.particle_cnt, slot_rows, iters, True,
                  d) + more_ops, iterations=iters, **k5_keys)

    obj, state, obs, kw = timing["k8"]
    blk = obj.blocking
    ikw = inelastic_kwargs(obj, state)
    args = (blk, state.pos, state.vel, obj.mass, obs.centers, obs.radii)
    k8_out = fk.fused_explicit_frame(*args, **kw, **ikw)
    k8_keys = k8_plan_keys(True, kw["sim_count"])
    k8_name = k8_kernel_name()
    more_ops, more_bytes = inelastic_extra(obj, state, kw["sim_count"], False)
    tables = (blk.block_particles, blk.plus, blk.minus, blk.block_elements,
              blk.local_ptr, blk.local_rows)
    plan = (blk.slot_plan.ptr, blk.slot_plan.rows)
    slot_rows = blk.slot_plan.rows.numel()
    put("explicit_frame_inelastic", lambda: fk.fused_explicit_frame(
            *args, **kw, **ikw),
        lambda: fk.fused_explicit_frame_plain(*args, **kw, **ikw), 2, FRAMES,
        k8_name,
        nbytes(blk.ref_inv, blk.volume, *tables, *plan, obj.mass,
               obs.centers, obs.radii, state.pos, state.vel, *k8_out[:2])
        + more_bytes,
        explicit_frame_ops(obj.element_cnt, obj.particle_cnt, slot_rows,
                           kw["sim_count"], d) + more_ops,
        states=[k for k in ("plastic_inv", "viscous_inv")
                if getattr(state, k) is not None], **k8_keys)
    return out


# -- Materials (sections 27-33) ----------------------------------------------

FRAMES_T = 3  # path T, each material through K5 and through K8
SUBSTEPS_SWEEP = 2  # path V's sweep of every material, each setting

# Every base material but Neo-Hookean, as the JAX package spells them (the
# 2D body's E 4e4, ν 0.2 allow Mooney-Rivlin at β 0.3, the flagship's ν 0.4
# its default β 0.5).
MATERIALS = {
    2: ("stvk", "linear", "corotated", "stable_neo_hookean",
        "mooney_rivlin:0.3", "fiber:1,0"),
    3: ("stvk", "linear", "corotated", "stable_neo_hookean", "mooney_rivlin",
        "fiber:1,0,0"),
}
# f32 operations of each material's P and DP a element (material_p_dp in
# element_chain.cuh), counted from the formulas: corotated's 12 Higham
# iterations are ~60 operations each in 3D, ~16 in 2D.  The implicit chain
# adds the edges, F, DP·Rᵀ, P·Rᵀ and the scaling (3D 162, 2D 48), the
# gradient chain the edges, F, P·Rᵀ and the scaling (108, 32); robust
# Neo-Hookean adds ~6 to OPS[d]["chain"].
MATERIAL_OPS = {
    3: {"stvk": (117, 168), "linear": (36, 24), "corotated": (805, 75),
        "stable_neo_hookean": (125, 144), "mooney_rivlin": (200, 410),
        "fiber": (174, 209)},
    2: {"stvk": (38, 52), "linear": (18, 12), "corotated": (223, 30),
        "stable_neo_hookean": (20, 33), "mooney_rivlin": (64, 134),
        "fiber": (43, 66)},
}
# tests/test_torch_golden_corotated.py: configs/demo_passage_corotated.json's
# 200-frame values (recorded by the JAX package on the CPU; mean and std
# within 5e-3, particles 0, 60 and 120 within 1e-2).  Copied: that file
# imports the JAX package.
GOLDEN_COROTATED = dict(mean=0.52271651, std=0.06694287,
                        p0=(0.59543681, 0.45029497),
                        p60=(0.49884495, 0.54849130),
                        p120=(0.39236563, 0.64084446))
# tests/test_golden.py:93-104: the 3D canary (assets/cube.stl, spacing 0.5,
# 100 frames; mean and std within 5e-3, particles 0 and 5 within 1e-2).
GOLDEN_3D = dict(mean=0.27050927, std=0.16186684,
                 p0=(0.2029982, -0.0001941, 0.1924001),
                 p5=(0.4930525, -0.0001596, 0.5102745))
# The kernels with material instances: counter name → whether it has a
# robust one, whether its instances are also inelastic ones (the frames).
MATERIAL_KERNELS = {
    "element_chain": (True, False), "blocked_prep": (True, False),
    "blocked_frame": (True, True), "grad_columns": (False, False),
    "blocked_grad_prep": (False, False), "explicit_frame": (False, True),
}


def material_frame_call(kernel, obj, state, obs, dt, g, material, robust,
                        inelastic):
    """(kernel wrapper, plain version, args, kwargs) of one frame of K5 or K8
    of ``material`` (``robust``: K5's robust instance; ``inelastic``: with
    ``state``'s internal inverses) from ``state``."""
    from fem_tpu_torch.ops import frame_kernels as fk

    kw = dict(dt=dt, damping=obj.damping, g_dir=g, mu=obj.mu,
              s_lambda=obj.s_lambda, sim_count=10, material=material)
    if inelastic:
        kw.update(inelastic_kwargs(obj, state))
    if kernel == "K5":
        kw.update(preconditioned=True, robust=robust)
        args = (obj.blocking, state.pos, state.vel, state.vel_g, obj.mass,
                obs.centers, obs.radii)
        return fk.fused_blocked_frame, fk.fused_blocked_frame_plain, args, kw
    args = (obj.blocking, state.pos, state.vel, obj.mass, obs.centers,
            obs.radii)
    return fk.fused_explicit_frame, fk.fused_explicit_frame_plain, args, kw


def chain_ops(d, material, robust=False):
    """(implicit chain, explicit gradient chain) f32 operations a element
    of ``material``."""
    base = material.partition(":")[0]
    if base == "neo_hookean":
        return OPS[d]["chain"] + (6 if robust else 0), OPS[d]["grad"]
    p, dp = MATERIAL_OPS[d][base]
    if d == 3:
        return 162 + p + dp, 108 + p
    return 48 + p + dp, 32 + p


def instance_name(material, robust):
    return "neo_hookean (robust)" if robust else material


def run_materials(torch, dev, zero_counts, counts, only, instances):
    """Sections 27-33: every material and robust instance against its plain
    version, and paths R-V and the 3D canary.  Returns the launch counts and
    errors of the kernels line's instance rows, the profiled windows and
    the inputs their timing reuses."""
    from fem_tpu_torch import convert, entry, scene, sim
    from fem_tpu_torch.models import mesh as pmesh
    from fem_tpu_torch.models.state import Obstacles, build_object
    from fem_tpu_torch.ops import blocked_kernels as bk, element_kernels as ek
    from fem_tpu_torch.ops.element import (
        deformation_gradients,
        kernel_material_id,
    )
    from fem_tpu_torch.utils.config import ObjectConfig, SimConfig, read_config

    def cpu_state(s):
        return convert.state_from_arrays(convert.state_to_arrays(s), "cpu")

    def cpu_obj(o):
        return convert.object_from_arrays(*convert.object_to_arrays(o), "cpu")

    def cpu_obs(o):
        return type(o)(o.centers.cpu(), o.radii.cpu())

    def twice(fn, args, kwargs):
        a, b = fn(*args, **kwargs), fn(*args, **kwargs)
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        require(all(torch.equal(x, y) for x, y in zip(a, b)),
                f"{fn.__name__} runs differ")
        return a

    errors = {}  # (counter, d, material id[, inelastic]) -> max abs error
    launches = {}  # the same keys -> launches on paths R-V
    labels = {}  # the same keys -> (material, robust)

    def note(key, err, material, robust):
        errors[key] = max(errors.get(key, 0.0), err)
        labels[key] = (material, robust)

    def tally():
        """Adds the instance launches since the last zero_counts() to
        ``launches``."""
        for key, n in instances().items():
            launches[key] = launches.get(key, 0) + n

    def cases(d):
        return [(m, False) for m in MATERIALS[d]] + [("neo_hookean", True)]

    default_path = os.path.join(REPO, "configs", "default.json")
    cfg2 = read_config(default_path)
    icfg2 = dataclasses.replace(cfg2, **OVERRIDES_2D["implicit_cg"])
    (body2,), obs2 = scene.load_scene(cfg2, device=dev)
    state2 = squeezed_2d(torch, body2.state, torch.Generator().manual_seed(5))
    pcfg = read_config(os.path.join(REPO, "configs", "demo_plastic.json"))
    ncfg = dataclasses.replace(pcfg, **OVERRIDES_2D["implicit_cg"])
    pbodies, pobs = scene.load_scene(pcfg, device=dev)
    pstate = squashed_plastic(torch, pbodies[0].state, 0)
    cfg3, obj3, state3_0, obs3 = entry.flagship(dev)
    state3 = entry.deformed(state3_0)
    ecfg3, eobj3, estate3, _ = entry.explicit_flagship(dev)
    _, oobj3, ostate3_0, _ = entry.flagship(dev, plastic_yield=0.01)
    ostate3 = entry.deformed(ostate3_0)
    # The inputs of the instances' checks and times: 2D the default scene
    # squeezed (inelastic: demo_plastic.json's body 0 squashed), 3D the
    # flagship deformed (inelastic: with plastic_yield 0.01); K8 at the
    # explicit time steps (2D 5e-4, 3D 1e-4).
    scenes = {
        2: dict(obj=body2.obj, state=state2, obs=obs2, dt=cfg2.delta_time,
                xdt=cfg2.delta_time, g=tuple(cfg2.g_dir), iobj=pbodies[0].obj,
                istate=pstate, iobs=pobs),
        3: dict(obj=obj3, state=state3, obs=obs3, dt=cfg3.delta_time,
                xdt=ecfg3.delta_time, g=tuple(cfg3.g_dir), iobj=oobj3,
                istate=ostate3, iobs=obs3),
    }

    # -- 27. every material and robust instance against its plain version --
    t0 = time.perf_counter()
    for d in (2, 3):
        sc = scenes[d]
        obj, state, blk = sc["obj"], sc["state"], sc["obj"].blocking
        for material, robust in cases(d):
            mid = kernel_material_id(material, robust)
            args = (state.pos, obj.element_indices, obj.ref_inv, obj.volume,
                    obj.mu, obj.s_lambda)
            K, H = twice(ek.hessian_and_force, args,
                         dict(robust=robust, material=material))
            k1_plan = plan_text(ek.hessian_and_force)
            Kp, Hp = ek.hessian_and_force_plain(*args, material, robust)
            rel = max(block_rel_err(K, Kp), block_rel_err(H, Hp))
            note(("element_chain", d, mid), float(max(
                (K - Kp).abs().max(), (H - Hp).abs().max())), material, robust)
            bargs = (blk, state.pos, obj.mu, obj.s_lambda, None, material,
                     robust)
            Kb, part = twice(bk.blocked_prep, bargs, {})
            Kbp, partp = bk.blocked_prep_plain(*bargs)
            rel = max(rel, block_rel_err(Kb, Kbp))
            perr = float((part - partp).abs().max()) / float(
                partp.abs().max())
            note(("blocked_prep", d, mid), float(max(
                (Kb - Kbp).abs().max(), (part - partp).abs().max())),
                material, robust)
            if not robust:
                (G,) = twice(ek.explicit_grad_columns, args + (material,), {})
                Gp = ek.explicit_grad_columns_plain(*args, material)
                rel = max(rel, block_rel_err(G, Gp))
                note(("grad_columns", d, mid), float((G - Gp).abs().max()),
                     material, robust)
                (gpart,) = twice(bk.blocked_grad_prep, bargs[:-1], {})
                gpartp = bk.blocked_grad_prep_plain(*bargs[:-1])
                perr = max(perr, float((gpart - gpartp).abs().max())
                           / float(gpartp.abs().max()))
                note(("blocked_grad_prep", d, mid),
                     float((gpart - gpartp).abs().max()), material, robust)
            log(f"[{d}D {instance_name(material, robust)}] K1/K2"
                f"{'' if robust else '/K6'} block-relative error {rel:.3e}; "
                f"K2{'' if robust else '/K7b'} partials relative error "
                f"{perr:.3e}; K1 plan {k1_plan}")
            require(rel <= 1e-5 and perr <= 1e-5,
                    f"{d}D {material} chains off their plain versions")
            for kernel in ("K5", "K8"):
                for inelastic in (False, True):
                    if (kernel == "K8" and robust) or (inelastic and robust):
                        continue
                    o, s, obs = ((sc["iobj"], sc["istate"], sc["iobs"])
                                 if inelastic else (obj, state, sc["obs"]))
                    fn, plain, fargs, kw = material_frame_call(
                        kernel, o, s, obs, sc["dt" if kernel == "K5"
                                              else "xdt"], sc["g"], material,
                        robust, inelastic)
                    out = twice(fn, fargs, kw)
                    ref = plain(*fargs, **kw)
                    err = float((out[0] - ref[0]).abs().max())
                    if inelastic:
                        n_st = len([k for k in ("plastic_inv", "viscous_inv")
                                    if getattr(s, k) is not None])
                        err = max([err] + [float((a - b).abs().max())
                                           for a, b in zip(out[-n_st:],
                                                           ref[-n_st:])])
                    name = ("blocked_frame" if kernel == "K5"
                            else "explicit_frame")
                    note((name, d, mid, inelastic), err, material, robust)
                    extra = ""
                    if kernel == "K5":
                        it, itp = out[3].tolist(), ref[3].tolist()
                        extra = f"; iterations {it} (plain {itp})"
                        if max(itp) <= 20:
                            require(all(abs(a - b) <= 1
                                        for a, b in zip(it, itp)),
                                    f"{d}D {kernel} {material} iterations")
                    log(f"[{d}D {kernel} {instance_name(material, robust)}"
                        f"{' inelastic' if inelastic else ''}] max |d state| "
                        f"{err:.3e}{extra}")
                    require(bool(torch.isfinite(out[0]).all()),
                            f"{d}D {kernel} {material} non-finite")
                    require(err <= 1e-5, f"{d}D {kernel} {material} off its "
                            f"plain frame by {err}")
    log(f"[materials] every instance two runs bit-identical; section 27 in "
        f"{time.perf_counter() - t0:.1f} s")

    def frames_path(label, pairs, cfg, frames, want, backend):
        """``frames`` frames of each (object, state, obstacles, CPU object,
        CPU state, CPU obstacles) of ``pairs`` through make_frame_fn; the
        launch counts ``want`` (counter -> count) and nothing else; each
        first frame within 1e-5 of the CPU's ``backend`` frame.  Returns
        (frame functions, end states, wall seconds)."""
        fns = [sim.make_frame_fn(p[0], cfg) for p in pairs]
        worst, its = 0.0, []
        for f, (o, s, obs, co, cs, cobs) in zip(fns, pairs):
            warm, waux = f(s, obs)
            ref, raux = sim.make_frame_fn(co, dataclasses.replace(
                cfg, frame_backend=backend))(cs, cobs)
            worst = max(worst, state_err(warm, ref))
            it, itp = waux.solver_iterations.tolist(), \
                raux.solver_iterations.tolist()
            its.append((it, itp))
            if max(itp) <= 20:
                require(all(abs(a - b) <= 1 for a, b in zip(it, itp)),
                        f"path {label} iterations differ")
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        states = [p[1] for p in pairs]
        for _ in range(frames):
            states = [f(s, p[2])[0] for f, s, p in zip(fns, states, pairs)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
        tally()
        log(f"[path {label}] {frames} frames x {cfg.sim_count} substeps (dt "
            f"{cfg.delta_time}) in {wall:.4f} s: "
            f"{frames * cfg.sim_count / wall:.1f} steps/s; launches {got}; "
            f"first frames vs the CPU: max |dstate| {worst:.3e}, iterations "
            f"(card, CPU) {its}")
        require(got == only(**want), f"path {label} launches {got}")
        require(all(bool(torch.isfinite(s.pos).all()) for s in states),
                f"path {label} non-finite")
        require(worst <= 1e-5, f"path {label} off the CPU frames by {worst}")
        return fns, states, wall

    windows = []

    # -- 28. path R: demo_passage_corotated.json as shipped ------------------
    rcfg = read_config(os.path.join(REPO, "configs",
                                    "demo_passage_corotated.json"))
    (rbody,), robs = scene.load_scene(rcfg, device=dev)
    (crbody,), crobs = scene.load_scene(rcfg, device="cpu")
    require(rbody.obj.material == "corotated" and rcfg.auto_diff
            and (rbody.obj.particle_cnt, rbody.obj.element_cnt) == (121, 200),
            "demo_passage_corotated.json")
    require(sim.supports_explicit_blocked_frame(rbody.obj, rcfg),
            "demo_passage_corotated.json is not eligible for K8")
    fns_r, states_r, _ = frames_path(
        "R (demo_passage_corotated.json)",
        [(rbody.obj, rbody.state, robs, crbody.obj, crbody.state, crobs)],
        rcfg, GOLDEN_FRAMES, dict(explicit_frame=GOLDEN_FRAMES),
        "blocked_explicit")
    rkey = ("explicit_frame", 2, kernel_material_id("corotated"), False)
    require(instances() == {rkey: GOLDEN_FRAMES},
            f"path R instances {instances()}")
    p = states_r[0].pos.cpu().double()
    g = GOLDEN_COROTATED
    mean, std = float(p.mean()), float(p.std(correction=0))
    worst = max(float((p[i] - torch.tensor(g[k], dtype=torch.float64))
                      .abs().max())
                for k, i in (("p0", 0), ("p60", 60), ("p120", 120)))
    log(f"[golden demo_passage_corotated] mean {mean:.7f} (golden "
        f"{g['mean']}), std {std:.7f} (golden {g['std']}), particles "
        f"0/60/120 within {worst:.3e}, lowest y "
        f"{float(p[:, 1].min()):.5f}")
    require(abs(mean - g["mean"]) < 5e-3 and abs(std - g["std"]) < 5e-3,
            "path R golden mean/std")
    require(worst <= 1e-2, f"path R golden particles off by {worst}")
    windows.append(("path R (K8 2D corotated)", fns_r, [rbody.state], robs,
                    FRAMES))

    # -- 29. path S: default.json with each material, K8 and K5 --------------
    for material in MATERIALS[2]:
        _, o, s, obs = entry.load_config(default_path, dev, material=material)
        _, co, cs, cobs = entry.load_config(default_path, "cpu",
                                            material=material)
        for label, c, name, backend in (
                ("K8, as shipped", cfg2, "explicit_frame", "blocked_explicit"),
                ("K5, implicit_cg", icfg2, "blocked_frame", "blocked")):
            frames_path(f"S (default.json, {material}, {label})",
                        [(o, s, obs, co, cs, cobs)], c, FRAMES,
                        {name: FRAMES}, backend)
            mid = kernel_material_id(material)
            require(instances() == {(name, 2, mid, False): FRAMES},
                    f"path S {material} instances {instances()}")
    # demo_plastic.json's body 0 (plastic) from its squashed state with each
    # material, K8 and K5 (10 frames for corotated, 1 for the others).
    cpbodies, cpobs = scene.load_scene(pcfg, device="cpu")
    cpb = cpbodies[0]
    for material in MATERIALS[2]:
        o = dataclasses.replace(pbodies[0].obj, material=material)
        co = dataclasses.replace(cpb.obj, material=material)
        frames = FRAMES_N if material == "corotated" else 1
        for label, c, name, backend in (
                ("K8", pcfg, "explicit_frame", "blocked_explicit"),
                ("K5, implicit_cg", ncfg, "blocked_frame", "blocked")):
            frames_path(f"S (demo_plastic.json body 0, {material}, {label})",
                        [(o, pstate, pobs, co, cpu_state(pstate), cpobs)], c,
                        frames, {name: frames}, backend)

    # -- 30. path T: the flagship with each material, K5 and K8 --------------
    cobs3 = cpu_obs(obs3)
    t_fns = {}
    for material in MATERIALS[3]:
        frames = FRAMES if material == "corotated" else FRAMES_T
        c, o, s0, obs = entry.flagship(dev, material=material)
        s = entry.deformed(s0)
        co = cpu_obj(o)
        fns, _, _ = frames_path(
            f"T (flagship, {material}, K5)",
            [(o, s, obs, co, cpu_state(s), cobs3)], c, frames,
            dict(blocked_frame=frames), "blocked")
        ec, eo, es0, _ = entry.explicit_flagship(dev, material=material)
        es = entry.deformed(es0)
        efns, _, _ = frames_path(
            f"T (explicit flagship, {material}, K8)",
            [(eo, es, obs, co, cpu_state(es), cobs3)], ec, frames,
            dict(explicit_frame=frames), "blocked_explicit")
        if material == "corotated":
            t_fns = dict(k5=(fns, [s], obs), k8=(efns, [es], obs))
    for material in MATERIALS[3]:
        frames = FRAMES if material == "stvk" else 1
        c, o, s0, obs = entry.flagship(dev, plastic_yield=0.01,
                                       material=material)
        s = entry.deformed(s0)
        frames_path(f"T (flagship, plastic_yield 0.01, {material}, K5)",
                    [(o, s, obs, cpu_obj(o), cpu_state(s), cobs3)], c, frames,
                    dict(blocked_frame=frames), "blocked")
        ec, eo, es0, _ = entry.explicit_flagship(dev, plastic_yield=0.01,
                                                 material=material)
        es = entry.deformed(es0)
        frames_path(f"T (explicit flagship, plastic_yield 0.01, {material}, "
                    "K8)", [(eo, es, obs, cpu_obj(eo), cpu_state(es), cobs3)],
                    ec, 1, dict(explicit_frame=1), "blocked_explicit")
    windows += [("path T (K5 3D corotated)", *t_fns["k5"], FRAMES),
                ("path T (K8 3D corotated)", *t_fns["k8"], FRAMES)]

    # -- 31. path U: robust_inversion ---------------------------------------
    ucfg = dataclasses.replace(cfg3, robust_inversion=True)
    cobj3 = cpu_obj(obj3)
    fns_u, _, _ = frames_path(
        "U (flagship, robust_inversion, K5)",
        [(obj3, state3, obs3, cobj3, cpu_state(state3), cobs3)], ucfg, FRAMES,
        dict(blocked_frame=FRAMES), "blocked")
    windows.append(("path U (K5 3D robust)", fns_u, [state3], obs3, FRAMES))
    ucfg2 = dataclasses.replace(icfg2, robust_inversion=True)
    frames_path("U (default.json, implicit_cg, robust_inversion, K5)",
                [(body2.obj, body2.state, obs2, cpu_obj(body2.obj),
                  cpu_state(body2.state), cpu_obs(obs2))], ucfg2, FRAMES,
                dict(blocked_frame=FRAMES), "blocked")
    # The inverted-tet state (entry.inverted_cube: one tet inverted and
    # nearly flat, det F ≈ −1.7e-5, where the robust clamp of the rhs log
    # acts): the robust K5 stays finite and equals its plain frame on the
    # card and the CPU's frame, and the non-robust K5 differs.
    icfg3, iobj3, inv_state, iobs3 = entry.inverted_cube(dev)
    _, ciobj3, ciinv_state, ciobs3 = entry.inverted_cube("cpu")
    det_min = float(torch.linalg.det(deformation_gradients(
        inv_state.pos, iobj3.element_indices, iobj3.ref_inv)).min())
    frames_path(
        f"U (inverted cube, det F {det_min:.3e}, robust K5)",
        [(iobj3, inv_state, iobs3, ciobj3, ciinv_state, ciobs3)], icfg3,
        1, dict(blocked_frame=1), "blocked")
    fn, plain, fargs, kw = material_frame_call(
        "K5", iobj3, inv_state, iobs3, icfg3.delta_time, tuple(icfg3.g_dir),
        "neo_hookean", True, False)
    kw["sim_count"] = icfg3.sim_count
    out, ref = fn(*fargs, **kw), plain(*fargs, **kw)
    err = float((out[0] - ref[0]).abs().max())
    nonrobust = fn(*fargs, **dict(kw, robust=False))
    log(f"[path U inverted cube] robust K5 vs its plain frame on the card: "
        f"max |dpos| {err:.3e}, finite {bool(torch.isfinite(out[0]).all())}; "
        f"the non-robust K5 differs by "
        f"{float((nonrobust[0] - out[0]).abs().max()):.3e}")
    require(bool(torch.isfinite(out[0]).all()) and err <= 1e-5,
            "path U inverted cube: robust K5 off its plain frame")
    require(not torch.equal(nonrobust[0], out[0]),
            "path U inverted cube: the robust clamp did not act")
    note(("blocked_frame", 3, kernel_material_id("neo_hookean", True), False),
         err, "neo_hookean", True)

    def substeps(label, obj, state, obs, cobj, cstate, cobs, c, n, want):
        """``n`` op-composed substeps with ``c``'s settings; the launch
        counts ``want(iterations)`` and nothing else, the first substep
        within 1e-5 of the CPU's."""
        kw = sim.substep_kwargs(c)
        zero_counts()
        s, first, iters = state, None, []
        for i in range(n):
            s, aux = sim.substep(obj, s, obs, **kw)
            iters.append(aux.solver_iterations)
            if i == 0:
                first = s
        iters = [int(x) for x in torch.stack(iters).cpu()]
        torch.cuda.synchronize()
        got = counts()
        tally()
        ref, _ = sim.substep(cobj, cstate, cobs, **kw)
        err = state_err(first, ref)
        log(f"[path {label}] {n} substeps; launches {got}; CG iterations "
            f"{iters}; first substep vs the CPU: max |dstate| {err:.3e}")
        require(got == only(**want(iters)), f"path {label} launches {got}")
        require(bool(torch.isfinite(s.pos).all()), f"path {label} non-finite")
        require(err <= 1e-5, f"path {label} off the CPU substep by {err}")

    def settings(icfg, xcfg, full):
        """(label, config, unblocked, launches(n, iterations)) of paths C,
        B, E, F and G's settings (``full``), or of C, B, E and G."""
        out = [
            ("C (K1 + K4)", icfg, False,
             lambda n, it: dict(element_chain=n, fused_cg=n)),
            ("B (K2 + K3)", dataclasses.replace(icfg, operator_mode="blocked"),
             False, lambda n, it: dict(blocked_prep=n, blocked_matvec=sum(
                 3 + 2 * i for i in it))),
            ("E (K7b)", xcfg, False, lambda n, it: dict(blocked_grad_prep=n)),
        ]
        if full:
            out += [
                ("F (K7a: auto_diff)", dataclasses.replace(xcfg, auto_diff=True),
                 False, lambda n, it: dict(blocked_assemble=n)),
                ("F (K7a: element_backend=xla)",
                 dataclasses.replace(xcfg, element_backend="xla"), False,
                 lambda n, it: dict(blocked_assemble=n)),
            ]
        out.append(("G (K6: no blocks)", xcfg, True,
                    lambda n, it: dict(grad_columns=n)))
        return out

    xcfg2 = dataclasses.replace(cfg2, **OVERRIDES_2D["explicit_analytic"])
    # Path U's op-composed robust substeps (C's and B's settings).
    for d, obj, state, obs, icfg in (
            (2, body2.obj, state2, obs2, ucfg2), (3, obj3, state3, obs3, ucfg)):
        co, cs, cob = cpu_obj(obj), cpu_state(state), cpu_obs(obs)
        for label, c, _, want in settings(icfg, xcfg2, False)[:2]:
            substeps(f"U {d}D robust {label}", obj, state, obs, co, cs, cob, c,
                     SUBSTEPS_C, lambda it, want=want: want(SUBSTEPS_C, it))

    # -- 32. path V: the op-composed material substeps -----------------------
    full_v = {2: "corotated", 3: "fiber:1,0,0"}  # all five settings
    for d, material, obj, state, obs, icfg, xcfg, full, n in [
            (2, full_v[2], body2.obj, state2, obs2, icfg2, xcfg2, True,
             SUBSTEPS_C),
            (3, full_v[3], obj3, state3, obs3, cfg3, ecfg3, True,
             SUBSTEPS_C)] + [
            (d, m, sc_obj, sc_state, sc_obs, ic, xc, False, SUBSTEPS_SWEEP)
            for d, sc_obj, sc_state, sc_obs, ic, xc in (
                (2, body2.obj, state2, obs2, icfg2, xcfg2),
                (3, obj3, state3, obs3, cfg3, ecfg3))
            for m in MATERIALS[d] if m != full_v[d]]:
        o = dataclasses.replace(obj, material=material)
        co, cs, cob = cpu_obj(o), cpu_state(state), cpu_obs(obs)
        for label, c, unblocked, want in settings(icfg, xcfg, full):
            oo = dataclasses.replace(o, blocking=None) if unblocked else o
            cco = dataclasses.replace(co, blocking=None) if unblocked else co
            substeps(f"V {d}D {material} {label}", oo, state, obs, cco, cs,
                     cob, c, n, lambda it, want=want, n=n: want(n, it))

    # -- 33. the 3D canary of tests/test_golden.py through K5 ---------------
    v, f = pmesh.load_surface_mesh(os.path.join(REPO, "assets", "cube.stl"))
    nodes, tets = pmesh.delaunay_tetrahedralize(v, f, 0.5)
    surface, _ = pmesh.extract_surface(nodes, tets)
    ocfg = ObjectConfig(center=(0.2, 0.05, 0.2), rho=1000.0, E=4e4, nu=0.3,
                        damping=10.0)
    kcfg = SimConfig(dim=3, delta_time=5e-4, sim_count=10, auto_diff=False,
                     use_explicit_method=False, implicit_method=1,
                     preconditioned=1, g_dir=(0.0, -1.0, 0.0),
                     objects=(ocfg,), blocks=())
    kobj, kstate = build_object(ocfg, (0.3 * nodes).astype("float32"),
                                surface.astype("int32"), tets.astype("int32"),
                                device=dev)
    kobs = Obstacles.from_configs((), 3, device=dev)
    frame = sim.make_frame_fn(kobj, kcfg)
    zero_counts()
    t0 = time.perf_counter()
    for _ in range(100):
        kstate, _ = frame(kstate, kobs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    p = kstate.pos.cpu().double()
    g = GOLDEN_3D
    mean, std = float(p.mean()), float(p.std(correction=0))
    worst = max(float((p[i] - torch.tensor(g[k], dtype=torch.float64))
                      .abs().max()) for k, i in (("p0", 0), ("p5", 5)))
    log(f"[3D canary] assets/cube.stl, {kobj.particle_cnt} particles, "
        f"{kobj.element_cnt} tets, {kobj.blocking.num_blocks} blocks: 100 "
        f"frames in {wall:.3f} s, launches {got}; mean {mean:.7f} (golden "
        f"{g['mean']}), std {std:.7f} (golden {g['std']}), particles 0/5 "
        f"within {worst:.3e}")
    require(got == only(blocked_frame=100), f"3D canary launches {got}")
    require(abs(mean - g["mean"]) < 5e-3 and abs(std - g["std"]) < 5e-3,
            "3D canary mean/std")
    require(worst <= 1e-2, f"3D canary particles off by {worst}")

    return dict(errors=errors, launches=launches, labels=labels,
                windows=windows, timing=scenes)


def time_material_kernels(torch, d, timing, keys):
    """Device ms a launch (profiler), plain ms (CUDA events) and the bound of
    each material instance ``keys`` of dimension ``d``: {key: dict of the
    kernels line's time keys}."""
    from fem_tpu_torch.ops import blocked_kernels as bk, element_kernels as ek
    from fem_tpu_torch.ops.element import MATERIAL_IDS, ROBUST_NEO_HOOKEAN_ID

    by_id = {v: k for k, v in MATERIAL_IDS.items()}
    by_id[ROBUST_NEO_HOOKEAN_ID] = "neo_hookean"
    spelled = {m.partition(":")[0]: m for m in MATERIALS[d]}
    spelled["neo_hookean"] = "neo_hookean"
    sc = timing[d]
    obj, state, blk = sc["obj"], sc["state"], sc["obj"].blocking
    n, e = obj.particle_cnt, obj.element_cnt
    tables = (blk.block_particles, blk.plus, blk.minus, blk.block_elements,
              blk.local_ptr, blk.local_rows)
    plan = (blk.slot_plan.ptr, blk.slot_plan.rows)
    slot_rows = blk.slot_plan.rows.numel()
    out = {}
    for key in keys:
        counter, kd, mid = key[:3]
        if kd != d:
            continue
        robust = mid == ROBUST_NEO_HOOKEAN_ID
        material = spelled[by_id[mid]]
        chain, grad = chain_ops(d, material, robust)
        args = (state.pos, obj.element_indices, obj.ref_inv, obj.volume,
                obj.mu, obj.s_lambda)
        bargs = (blk, state.pos, obj.mu, obj.s_lambda, None, material)
        if counter == "element_chain":
            K, H = ek.hessian_and_force(*args, robust, material)
            call = (lambda: ek.hessian_and_force(*args, robust, material),
                    lambda: ek.hessian_and_force_plain(*args, material,
                                                       robust),
                    20, 100, K1_KERNEL,
                    nbytes(*args[:4], K, H), chain * e)
            plan_keys = element_plan_keys(ek.hessian_and_force)
        elif counter == "grad_columns":
            G = ek.explicit_grad_columns(*args, material)
            call = (lambda: ek.explicit_grad_columns(*args, material),
                    lambda: ek.explicit_grad_columns_plain(*args, material),
                    20, 100, K6_KERNEL, nbytes(*args[:4], G), grad * e)
            plan_keys = element_plan_keys(ek.explicit_grad_columns)
        elif counter == "blocked_prep":
            Kb, part = bk.blocked_prep(*bargs, robust)
            call = (lambda: bk.blocked_prep(*bargs, robust),
                    lambda: bk.blocked_prep_plain(*bargs, robust), 10, 100,
                    "blocked_prep_kernel",
                    nbytes(state.pos, blk.ref_inv, blk.volume, *tables, Kb,
                           part), chain * e)
        elif counter == "blocked_grad_prep":
            gp = bk.blocked_grad_prep(*bargs)
            call = (lambda: bk.blocked_grad_prep(*bargs),
                    lambda: bk.blocked_grad_prep_plain(*bargs), 10, 100,
                    "blocked_grad_prep_kernel",
                    nbytes(state.pos, blk.ref_inv, blk.volume, *tables, gp),
                    (grad + OPS[d]["rows"]) * e)
        else:
            inelastic = key[3]
            kernel = "K5" if counter == "blocked_frame" else "K8"
            o, s, obs = ((sc["iobj"], sc["istate"], sc["iobs"]) if inelastic
                         else (obj, state, sc["obs"]))
            fn, plain, fargs, kw = material_frame_call(
                kernel, o, s, obs, sc["dt" if kernel == "K5" else "xdt"],
                sc["g"], material, robust, inelastic)
            res = fn(*fargs, **kw)
            ob = o.blocking
            ot = (ob.block_particles, ob.plus, ob.minus, ob.block_elements,
                  ob.local_ptr, ob.local_rows)
            op = (ob.slot_plan.ptr, ob.slot_plan.rows)
            moved = nbytes(ob.ref_inv, ob.volume, *ot, *op, o.mass,
                           obs.centers, obs.radii, *fargs[1:4 if kernel == "K8"
                                                         else 4], *res[:2])
            if inelastic:
                n_st = sum(x is not None for x in (s.plastic_inv,
                                                   s.viscous_inv))
                moved += 2 * n_st * 4 * d * d * o.element_cnt \
                    + ob.element_perm.numel() * 4
            plan_keys = {}
            if kernel == "K5":
                iters = res[3].tolist()
                plan_keys = k5_plan_keys(iters)
                ops = frame_ops(o.element_cnt, o.particle_cnt,
                                ob.slot_plan.rows.numel(), iters, True, d,
                                chain=chain)
            else:
                plan_keys = k8_plan_keys(inelastic, kw["sim_count"])
                ops = explicit_frame_ops(o.element_cnt, o.particle_cnt,
                                         ob.slot_plan.rows.numel(),
                                         kw["sim_count"], d, grad=grad)
            if inelastic:
                n_st = sum(x is not None for x in (s.plastic_inv,
                                                   s.viscous_inv))
                ops += kw["sim_count"] * o.element_cnt * (
                    OPS[d]["reff"] * n_st + OPS[d]["update_guard"]
                    + OPS[d]["update_state"] * n_st)
            call = (lambda fn=fn, fargs=fargs, kw=kw: fn(*fargs, **kw),
                    lambda plain=plain, fargs=fargs, kw=kw: plain(*fargs,
                                                                  **kw),
                    1, 10, k5_kernel_name() if kernel == "K5"
                    else k8_kernel_name(), moved, ops)
        plan_keys = (plan_keys if counter in ("blocked_frame",
                                              "explicit_frame",
                                              "element_chain",
                                              "grad_columns") else {})
        kernel, plain_fn, plain_reps, reps, kname, moved, ops = call
        bnd, by = bound(moved, ops)
        out[key] = dict(ms=kernel_ms(torch, kernel, reps, [kname]),
                        plain_ms=cuda_ms(torch, plain_fn, plain_reps),
                        bound_ms=bnd, bound_by=by, library_ms=None,
                        **plan_keys)
    return out


# -- Implicit extensions (sections 34-41) -------------------------------------

FRAMES_W = 200  # path W: demo_hanging.json's golden arc
FRAMES_X = 31  # path X: demo_ramp.json, up to the onset of ROADMAP F7
FRAMES_EXT = 3  # paths Y, Z and Z', and the 2D variants of W and X
SUBSTEPS_AD = 10  # path AD, each advection kernel
BETA_Z = 2e-3  # path Z': the JAX package's explicit flagship is finite at it
# Recorded from the JAX package on the CPU (fem_tpu.sim.make_frame_fn):
# demo_hanging.json after 200 frames and demo_ramp.json after 31
# (tests/test_torch_pins.py and tests/test_torch_obstacles.py hold them to
# live runs).  Copied: those files import the JAX package.
GOLDEN_HANGING = dict(mean=0.54870546, std=0.07990864,
                      p0=(0.40102217, 0.49494788),
                      p60=(0.50076079, 0.59617370),
                      p120=(0.60000002, 0.69999999))
GOLDEN_RAMP_31 = dict(mean=0.58076754, std=0.23927735,
                      p0=(0.24999997, 0.71153498),
                      p60=(0.34999999, 0.81153518),
                      p120=(0.45000017, 0.91153520))
# f32 operations a K9a/K9b element (counted from nh_prelude, nh_k and nh_h
# in element_chain.cuh: F, det, the adjugate inverse, then the K half's two
# products, F⁻¹R, the block and K·Rᵀ, or the rhs half's P and P·Rᵀ; the −V
# scaling) and a K10 particle (kinematic: the step and walls; a circle of
# K10a: disp, |disp|², the tests, the projection; of K10b: three
# projections).
EXT_OPS = {
    3: dict(k9a=335, k9b=181, circle_a=25, circle_b=46),
    2: dict(k9a=93, k9b=50, circle_a=16, circle_b=28),
}


def golden_arc_check(torch, name, pos, golden, tol_mean=5e-3, tol_p=1e-2):
    """Hold positions to a recorded JAX run's mean, std and particles 0,
    60 and 120 (tests/test_golden.py's tolerances)."""
    p = pos.cpu().double()
    mean, std = float(p.mean()), float(p.std(correction=0))
    worst = max(float((p[i] - torch.tensor(golden[k]).double()).abs().max())
                for k, i in (("p0", 0), ("p60", 60), ("p120", 120)))
    log(f"[{name}] mean {mean:.7f} (JAX {golden['mean']}), std {std:.7f} "
        f"(JAX {golden['std']}), particles 0/60/120 within {worst:.3e}")
    require(bool(torch.isfinite(p).all()), f"{name} non-finite")
    require(abs(mean - golden["mean"]) < tol_mean
            and abs(std - golden["std"]) < tol_mean, f"{name} mean/std")
    require(worst <= tol_p, f"{name} particles off by {worst}")


def three_circles(torch, pos):
    """Three circles over a body (two overlapping its centre, one of
    radius 0): (centers (3, d), radii (3,))."""
    c = pos.mean(dim=0)
    ext = float((pos.max(dim=0).values - pos.min(dim=0).values).max())
    d = pos.shape[1]
    off = torch.tensor([[0.1, 0.05, 0.0], [-0.15, 0.0, 0.1],
                        [0.0, -0.2, 0.05]], device=pos.device)[:, :d]
    centers = (c[None, :] + ext * off).contiguous()
    radii = torch.tensor([0.35 * ext, 0.25 * ext, 0.0], device=pos.device)
    return centers, radii


K10_LARGE = 262144  # particles of section 34's large K10 check


def advect_inputs(torch, dev, name, n, d):
    """K10a's (``name`` "kinematic") or K10b's operands over ``n``
    particles and their keywords, from a seeded generator on the card:
    positions in and past the unit box, a third inside two of three circles
    (one of radius 0); velocities, gravity channel and gradient normal, m⁻¹
    uniform."""
    from fem_tpu_torch.solvers import advect

    gen = torch.Generator(device=dev).manual_seed(n + d)

    def draw(*shape, low=None, high=1.0):
        if low is None:
            return high * torch.randn(shape, generator=gen, device=dev)
        return low + (high - low) * torch.rand(shape, generator=gen,
                                               device=dev)

    centers = draw(3, d, low=0.3, high=0.7)
    radii = torch.tensor([0.2, 0.15, 0.0], device=dev)
    idx = torch.arange(n, device=dev)
    near = centers[idx % 2] + draw(n, d, low=-0.12, high=0.12)
    pos = torch.where((idx % 3 == 0)[:, None], near,
                      draw(n, d, low=-0.1, high=1.1)).contiguous()
    vel, aux = draw(n, d, high=0.5), draw(n, d, high=0.5)
    kw = dict(dt=5e-4, decay=advect.damping_decay(5e-4, 10.0),
              gravity=advect.gravity_vector((0.0, -1.0, 0.0)[:d], dev))
    if name == "kinematic":
        return (pos, vel, draw(n, d, high=10.0),
                draw(n, low=0.5, high=2.0), centers, radii), kw
    return (pos, vel, aux, centers, radii), kw


def run_extensions(torch, dev, zero_counts, counts, only):
    """Sections 34-40: K9a, K9b, K10a and K10b against their plain versions
    and paths W-Z', AD.  Returns the launch counts and errors of the
    kernels line's rows of the four kernels by dimension, the inputs their
    timing reuses and the profiled windows of section 41."""
    from fem_tpu_torch import convert, entry, sim
    from fem_tpu_torch.ops import advect_kernels as ak
    from fem_tpu_torch.ops import element_kernels as ek
    from fem_tpu_torch.solvers import advect, explicit, implicit

    launches = {2: {}, 3: {}}
    errors = {2: {}, 3: {}}
    timing = {2: {}, 3: {}}
    windows = []

    def cpu_state(s):
        return convert.state_from_arrays(convert.state_to_arrays(s), "cpu")

    def max_dpos(a, b):
        return float((a.pos.cpu() - b.pos).abs().max())

    def check_not_whole_frame(label, o, c):
        require(not sim.supports_blocked_frame(o, c)
                and not sim.supports_explicit_blocked_frame(o, c),
                f"path {label} routed to a whole-frame kernel")

    def run_frames(label, frame, start, obs, frames):
        """``frames`` frames from ``start``, counted from zero: (first
        frame's state and aux, end state, iterations (frames, sim_count),
        launches, wall s)."""
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        s, its = start, []
        for i in range(frames):
            s, aux = frame(s, obs)
            its.append(aux.solver_iterations)
            if i == 0:
                first = (s, aux)
        its = torch.stack(its).cpu()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
        log(f"[path {label}] {frames} frames in {wall:.4f} s: "
            f"{its.numel() / wall:.1f} steps/s; launches {got}")
        return first, s, its, got, wall

    # -- 34. K9a, K9b, K10a and K10b against their plain versions ----------
    cfg, obj, state0, obs = entry.flagship(dev)
    state = entry.deformed(state0)
    dpath = os.path.join(REPO, "configs", "default.json")
    dcfg, dobj, dstate0, dobs = entry.load_config(dpath, dev)
    dstate = squeezed_2d(torch, dstate0, torch.Generator().manual_seed(7))
    for d, (o, s, c) in ((3, (obj, state, cfg)), (2, (dobj, dstate, dcfg))):
        args = (s.pos, o.element_indices, o.ref_inv, o.volume, o.mu,
                o.s_lambda)
        for name, fn, plain in (
            ("hessian_blocks", ek.hessian_blocks, ek.hessian_blocks_plain),
            ("implicit_force", ek.implicit_force_columns,
             ek.implicit_force_columns_plain),
        ):
            got, again = fn(*args), fn(*args)
            ref = plain(*args)
            torch.cuda.synchronize()
            rel = block_rel_err(got, ref)
            errors[d][name] = float((got - ref).abs().max())
            log(f"[{name} {d}D] block-relative error {rel:.3e}, max abs "
                f"error {errors[d][name]:.3e}")
            require(rel <= 1e-5, f"{name} {d}D block-relative error {rel}")
            require(torch.equal(got, again), f"{name} {d}D runs differ")
            log(f"[{name} {d}D] plan {plan_text(fn)}")
            timing[d][name] = args
        gen = torch.Generator().manual_seed(11 + d)
        vel = s.vel + 0.3 * torch.randn(s.vel.shape, generator=gen).to(dev)
        vel_g = 0.3 * torch.randn(s.vel.shape, generator=gen).to(dev)
        grad = explicit.analytic_energy_gradient(o, s.pos)
        centers, radii = three_circles(torch, s.pos)
        kw = dict(dt=c.delta_time,
                  decay=advect.damping_decay(c.delta_time, o.damping),
                  gravity=advect.gravity_vector(tuple(c.g_dir), o.device))
        for name, fn, plain, a in (
            ("kinematic", ak.kinematic, ak.kinematic_plain,
             (s.pos, vel, grad, 1.0 / o.mass, centers, radii)),
            ("advect_implicit", ak.advect_implicit, ak.advect_implicit_plain,
             (s.pos, vel, vel_g, centers, radii)),
        ):
            got, again = fn(*a, **kw), fn(*a, **kw)
            ref = plain(*a, **kw)
            torch.cuda.synchronize()
            errors[d][name] = max(float((x - y).abs().max())
                                  for x, y in zip(got, ref))
            moved = float((got[1] - a[1]).abs().max())
            log(f"[{name} {d}D] N {o.particle_cnt}, 3 circles: max abs "
                f"error {errors[d][name]:.3e} (velocities moved up to "
                f"{moved:.3e})")
            require(errors[d][name] <= 1e-6, f"{name} {d}D error")
            require(all(torch.equal(x, y) for x, y in zip(got, again)),
                    f"{name} {d}D runs differ")
            log(f"[{name} {d}D] plan {advect_plan_text(fn)}")
            timing[d][name] = (a, kw)
    # K10a and K10b at a large mesh's size (3D, 3 circles).
    for name, fn, plain in (
            ("kinematic", ak.kinematic, ak.kinematic_plain),
            ("advect_implicit", ak.advect_implicit, ak.advect_implicit_plain)):
        a, kw = advect_inputs(torch, dev, name, K10_LARGE, 3)
        got, again = fn(*a, **kw), fn(*a, **kw)
        ref = plain(*a, **kw)
        torch.cuda.synchronize()
        err = max(float((x - y).abs().max()) for x, y in zip(got, ref))
        differ = sum(int((x != y).sum()) for x, y in zip(got, ref))
        log(f"[{name} 3D] N {K10_LARGE}, 3 circles: max abs error "
            f"{err:.3e} against the plain version ({differ} entries not "
            f"bit-equal); plan {advect_plan_text(fn)}")
        require(err <= 1e-6, f"{name} 3D at {K10_LARGE} particles: {err}")
        require(all(torch.equal(x, y) for x, y in zip(got, again)),
                f"{name} 3D at {K10_LARGE} particles: runs differ")
        errors[3][name] = max(errors[3][name], err)
    log("[K9a/K9b/K10a/K10b] two runs bit-identical in every case")

    # -- 35. path W: demo_hanging.json as shipped ---------------------------
    wpath = os.path.join(REPO, "configs", "demo_hanging.json")
    wcfg, wobj, wstate, wobs = entry.load_config(wpath, dev)
    ccfg, cobj, cstate, cobs = entry.load_config(wpath, "cpu")
    require(wobj.free_mask is not None and wcfg.cg_precond == "none",
            "demo_hanging.json: no pins or not plain CG")
    check_not_whole_frame("W", wobj, wcfg)
    held = wobj.free_mask[:, 0] == 0
    frame_w = sim.make_frame_fn(wobj, wcfg)
    (first, first_aux), s, its, got, _ = run_frames("W", frame_w, wstate,
                                                     wobs, FRAMES_W)
    k3 = int((1 + its).sum())
    log(f"[path W] K2 {FRAMES_W} x {wcfg.sim_count}; K3 Σ(1 + iterations) "
        f"= {k3} (plain CG: one apply for r0, one an iteration; the "
        f"projection adds none); CG iterations a substep in "
        f"{sorted(set(its.reshape(-1).tolist()))}")
    require(got == only(blocked_prep=FRAMES_W * wcfg.sim_count,
                        blocked_matvec=k3), f"path W launches {got}")
    require(torch.equal(s.pos[held], wstate.pos[held]),
            "path W pinned vertices moved")
    ref, ref_aux = sim.make_frame_fn(cobj, ccfg)(cstate, cobs)
    err = max_dpos(first, ref)
    log(f"[path W] {int(held.sum())} pinned vertices held exactly; first "
        f"frame vs the CPU: max |dpos| {err:.3e}, iterations "
        f"{first_aux.solver_iterations.tolist()} (CPU "
        f"{ref_aux.solver_iterations.tolist()})")
    require(err <= 1e-5, f"path W off the CPU frame by {err}")
    require(torch.equal(first_aux.solver_iterations.cpu(),
                        ref_aux.solver_iterations), "path W iterations")
    golden_arc_check(torch, f"path W, {FRAMES_W} frames", s.pos,
                     GOLDEN_HANGING)
    windows.append(("path W (K2 + K3 2D, pins)", [frame_w], [wstate], wobs,
                    FRAMES))
    # Its exact-Hessian variant: K9b 2D once a substep and nothing else.
    wycfg = dataclasses.replace(wcfg, hessian="exact_jvp")
    check_not_whole_frame("W (exact_jvp)", wobj, wycfg)
    (first, first_aux), s, its, got, _ = run_frames(
        "W (exact_jvp)", sim.make_frame_fn(wobj, wycfg), wstate, wobs,
        FRAMES_EXT)
    require(got == only(implicit_force=FRAMES_EXT * wcfg.sim_count),
            f"path W (exact_jvp) launches {got}")
    launches[2]["implicit_force"] = got["implicit_force"]
    ref, ref_aux = sim.make_frame_fn(cobj, wycfg)(cstate, cobs)
    err = max_dpos(first, ref)
    log(f"[path W (exact_jvp)] first frame vs the CPU: max |dpos| "
        f"{err:.3e}; iterations {its.tolist()}")
    require(err <= 1e-5 and torch.equal(first_aux.solver_iterations.cpu(),
                                        ref_aux.solver_iterations),
            f"path W (exact_jvp) off the CPU frame by {err}")

    # -- 36. path X: demo_ramp.json as shipped ------------------------------
    xpath = os.path.join(REPO, "configs", "demo_ramp.json")
    xcfg, xobj, xstate, xobs = entry.load_config(xpath, dev)
    ccfg, cobj, cstate, cobs = entry.load_config(xpath, "cpu")
    require(xobj.damping_beta == 2e-3 and xobs.half_p is not None
            and xobs.box_lo is not None, "demo_ramp.json: no β or obstacles")
    check_not_whole_frame("X", xobj, xcfg)
    frame_x = sim.make_frame_fn(xobj, xcfg)
    (first, first_aux), s, its, got, _ = run_frames("X", frame_x, xstate,
                                                     xobs, FRAMES_X)
    k3 = int((1 + its).sum())
    log(f"[path X] β {xobj.damping_beta}: K3's G(K)·x enters A at "
        f"c = dt·(dt + β) = {implicit.system_coeff(xcfg.delta_time, xobj.damping_beta):.6e} "
        f"(dt² = {xcfg.delta_time ** 2:.6e}); the half-space and the box "
        f"through the SDF pass of the plain advection; K3 Σ(1 + "
        f"iterations) = {k3}")
    require(got == only(blocked_prep=FRAMES_X * xcfg.sim_count,
                        blocked_matvec=k3), f"path X launches {got}")
    ref, ref_aux = sim.make_frame_fn(cobj, ccfg)(cstate, cobs)
    err = max_dpos(first, ref)
    log(f"[path X] first frame vs the CPU: max |dpos| {err:.3e}")
    require(err <= 1e-5 and torch.equal(first_aux.solver_iterations.cpu(),
                                        ref_aux.solver_iterations),
            f"path X off the CPU frame by {err}")
    golden_arc_check(torch, f"path X, {FRAMES_X} frames", s.pos,
                     GOLDEN_RAMP_31)
    later = []
    for _ in range(3):
        s, aux = frame_x(s, xobs)
        later.append(aux.solver_iterations.tolist())
    log(f"[path X] CG iterations a substep, frames 31-33 (counted from 0): "
        f"{later}")
    windows.append(("path X (K2 + K3 2D, β, SDF)", [frame_x], [xstate], xobs,
                    FRAMES))
    # Its explicit variant: β through rayleigh_damping_grad, K9a 2D.
    xecfg = dataclasses.replace(xcfg, use_explicit_method=True)
    check_not_whole_frame("X (explicit)", xobj, xecfg)
    (first, _), s, _, got, _ = run_frames(
        "X (explicit)", sim.make_frame_fn(xobj, xecfg), xstate, xobs,
        FRAMES_EXT)
    n_sub = FRAMES_EXT * xcfg.sim_count
    require(got == only(hessian_blocks=n_sub, blocked_grad_prep=n_sub),
            f"path X (explicit) launches {got}")
    launches[2]["hessian_blocks"] = got["hessian_blocks"]
    ref, _ = sim.make_frame_fn(cobj, xecfg)(cstate, cobs)
    err = max_dpos(first, ref)
    log(f"[path X (explicit)] first frame vs the CPU: max |dpos| {err:.3e}")
    require(err <= 1e-5, f"path X (explicit) off the CPU frame by {err}")

    cpu_obj = convert.object_from_arrays(*convert.object_to_arrays(obj), "cpu")
    cpu_cstate = cpu_state(state)
    cpu_obs = type(obs)(obs.centers.cpu(), obs.radii.cpu())

    # -- 37. path Y: the flagship under hessian="exact_jvp" -----------------
    ycfg = dataclasses.replace(cfg, hessian="exact_jvp")
    check_not_whole_frame("Y", obj, ycfg)
    kw = sim.substep_kwargs(ycfg)
    one, one_aux = sim.substep(obj, state, obs, **kw)
    ref, ref_aux = sim.substep(cpu_obj, cpu_cstate, cpu_obs, **kw)
    err = max_dpos(one, ref)
    log(f"[path Y] first substep vs the CPU: max |dpos| {err:.3e}; "
        f"iterations {int(one_aux.solver_iterations)} (CPU "
        f"{int(ref_aux.solver_iterations)})")
    require(err <= 1e-5, f"path Y off the CPU substep by {err}")
    require(int(one_aux.solver_iterations) == int(ref_aux.solver_iterations),
            "path Y iterations")
    frame_y = sim.make_frame_fn(obj, ycfg)
    _, s, its, got, _ = run_frames("Y", frame_y, state, obs, FRAMES_EXT)
    log(f"[path Y] CG iterations (normal equations over the exact "
        f"operator) {its.tolist()}")
    require(got == only(implicit_force=FRAMES_EXT * cfg.sim_count),
            f"path Y launches {got}")
    require(bool(torch.isfinite(s.pos).all()), "path Y non-finite")
    launches[3]["implicit_force"] = got["implicit_force"]
    windows.append(("path Y (K9b 3D, exact_jvp)", [frame_y], [state], obs,
                    FRAMES_EXT))

    # -- 38. path Z: block-Jacobi PCG with a pin box over the top 1 % -------
    rest = state0.pos
    top = float(rest[:, 1].max() - 0.01 * (rest[:, 1].max()
                                            - rest[:, 1].min()))
    pins = (((-1e3, top, -1e3), (1e3, 1e3, 1e3)),)
    zcfg, zobj, zstate0, zobs = entry.flagship(dev, pin_boxes=pins)
    zcfg = dataclasses.replace(zcfg, cg_precond="block_jacobi")
    zstate = entry.deformed(zstate0)
    check_not_whole_frame("Z", zobj, zcfg)
    zheld = zobj.free_mask[:, 0] == 0
    frame_z = sim.make_frame_fn(zobj, zcfg)
    (first, first_aux), s, its, got, _ = run_frames("Z", frame_z, zstate,
                                                     zobs, FRAMES_EXT)
    k3 = int((1 + its).sum())
    log(f"[path Z] {int(zheld.sum())} pinned vertices; PCG iterations "
        f"{its.tolist()}; K3 Σ(1 + iterations) = {k3}")
    require(got == only(blocked_prep=FRAMES_EXT * zcfg.sim_count,
                        blocked_matvec=k3), f"path Z launches {got}")
    require(int(zheld.sum()) > 0 and torch.equal(s.pos[zheld],
                                                 zstate.pos[zheld]),
            "path Z pinned vertices moved")
    _, czobj, czstate0, czobs = entry.flagship("cpu", pin_boxes=pins)
    ref, ref_aux = sim.make_frame_fn(czobj, zcfg)(entry.deformed(czstate0),
                                                   czobs)
    err = max_dpos(first, ref)
    log(f"[path Z] first frame vs the CPU: max |dpos| {err:.3e}; iterations "
        f"{first_aux.solver_iterations.tolist()} (CPU "
        f"{ref_aux.solver_iterations.tolist()})")
    require(err <= 1e-5, f"path Z off the CPU frame by {err}")
    require(all(abs(a - b) <= 1 for a, b in zip(
        first_aux.solver_iterations.tolist(),
        ref_aux.solver_iterations.tolist())), "path Z iterations")
    windows.append(("path Z (K2 + K3 3D, block-Jacobi, pins)", [frame_z],
                    [zstate], zobs, FRAMES_EXT))

    # -- 39. path Z': the explicit flagship with β and a load box -----------
    load = (((-1e3, -1e3, -1e3), (1e3, 1e3, 2.0), (0.0, 0.0, 2.0)),)
    over = dict(damping_beta=BETA_Z, load_boxes=load)
    ecfg, eobj, estate, eobs = entry.explicit_flagship(dev, **over)
    check_not_whole_frame("Z'", eobj, ecfg)
    frame_e = sim.make_frame_fn(eobj, ecfg)
    (first, _), s, _, got, _ = run_frames("Z'", frame_e, estate, eobs,
                                          FRAMES_EXT)
    n_sub = FRAMES_EXT * ecfg.sim_count
    require(got == only(blocked_grad_prep=n_sub, hessian_blocks=n_sub),
            f"path Z' launches {got}")
    require(bool(torch.isfinite(s.pos).all()), "path Z' non-finite")
    launches[3]["hessian_blocks"] = got["hessian_blocks"]
    _, ceobj, cestate, ceobs = entry.explicit_flagship("cpu", **over)
    ref, _ = sim.make_frame_fn(ceobj, ecfg)(cestate, ceobs)
    err = max_dpos(first, ref)
    log(f"[path Z'] β {BETA_Z}, load {float(eobj.static_load.sum(0)[2])} "
        f"N over {int((eobj.static_load != 0).any(1).sum())} vertices; "
        f"first frame vs the CPU: max |dpos| {err:.3e}")
    require(err <= 1e-5, f"path Z' off the CPU frame by {err}")
    windows.append(("path Z' (K7b + K9a 3D, β, load)", [frame_e], [estate],
                    eobs, FRAMES_EXT))

    # -- 40. path AD: the advection steps with backend="pallas" ------------
    for d, (o, s, c, ob) in ((3, (obj, state, cfg, obs)),
                             (2, (dobj, dstate, dcfg, dobs))):
        decay = advect.damping_decay(c.delta_time, o.damping)
        gravity = advect.gravity_vector(tuple(c.g_dir), o.device)
        cpu_o = convert.object_from_arrays(*convert.object_to_arrays(o),
                                           "cpu")
        cpu_ob = type(ob)(ob.centers.cpu(), ob.radii.cpu())
        for name, method in (("advect_implicit", "implicit"),
                             ("kinematic", "explicit")):
            zero_counts()
            st, first = s, None
            for i in range(SUBSTEPS_AD):
                if method == "implicit":
                    st, _ = implicit.implicit_velocity_solve(
                        o, st, c.delta_time, 1, c.preconditioned)
                    st = advect.advect_implicit_step(
                        st, ob, c.delta_time, decay, gravity,
                        backend="pallas")
                else:
                    grad = explicit.analytic_energy_gradient(o, st.pos)
                    st = advect.kinematic_step(
                        st, grad, o.mass, ob, c.delta_time, decay, gravity,
                        backend="pallas")
                if i == 0:
                    first = st
            torch.cuda.synchronize()
            got = counts()
            pre = c.preconditioned == 1
            want = (dict(element_chain=SUBSTEPS_AD, fused_cg=SUBSTEPS_AD)
                    if method == "implicit"
                    else dict(blocked_grad_prep=SUBSTEPS_AD))
            require(got == only(**{name: SUBSTEPS_AD}, **want),
                    f"path AD {name} {d}D launches {got}")
            launches[d][name] = got[name]
            skw = sim.substep_kwargs(dataclasses.replace(
                c, use_explicit_method=method == "explicit", auto_diff=False,
                implicit_method=1, preconditioned=int(pre)))
            ref, _ = sim.substep(cpu_o, cpu_state(s), cpu_ob, **skw)
            err = max_dpos(first, ref)
            log(f"[path AD] {d}D {SUBSTEPS_AD} {method} substeps through "
                f"{name} (backend='pallas', "
                f"{advect_plan_text(getattr(ak, name))}); "
                f"launches {got}; first substep vs the CPU's XLA advection: "
                f"max |dpos| {err:.3e}")
            require(err <= 1e-5, f"path AD {name} {d}D off the CPU by {err}")
            require(bool(torch.isfinite(st.pos).all()),
                    f"path AD {name} {d}D non-finite")
    return dict(launches=launches, errors=errors, timing=timing,
                windows=windows)


def time_extension_kernels(torch, d, timing):
    """K9a's, K9b's, K10a's and K10b's device ms a launch (profiler), their
    plain versions' ms (CUDA events) and their bounds: {row name: dict of
    the kernels line's time keys}.  No single PyTorch call computes any of
    them (``library_ms`` null)."""
    from fem_tpu_torch.ops import advect_kernels as ak
    from fem_tpu_torch.ops import element_kernels as ek

    ops = EXT_OPS[d]
    out = {}
    for name, fn, plain, kernel, work in (
        ("hessian_blocks", ek.hessian_blocks, ek.hessian_blocks_plain,
         K9A_KERNEL, ops["k9a"]),
        ("implicit_force", ek.implicit_force_columns,
         ek.implicit_force_columns_plain, K9B_KERNEL, ops["k9b"]),
    ):
        args = timing[name]
        y = fn(*args)
        bnd, by = bound(nbytes(*args[:4], y), work * args[1].shape[0])
        out[name] = dict(ms=kernel_ms(torch, lambda: fn(*args), 200, [kernel]),
                         plain_ms=cuda_ms(torch, lambda: plain(*args), 20),
                         bound_ms=bnd, bound_by=by, library_ms=None,
                         **element_plan_keys(fn))
    for name, fn, plain, kernel, step, circle in (
        ("kinematic", ak.kinematic, ak.kinematic_plain, "kinematic_kernel",
         OPS[d]["kinematic"], ops["circle_a"]),
        ("advect_implicit", ak.advect_implicit, ak.advect_implicit_plain,
         "advect_implicit_kernel", OPS[d]["advect"], ops["circle_b"]),
    ):
        args, kw = timing[name]
        y = fn(*args, **kw)
        n, b = args[0].shape[0], args[-1].shape[0]
        bnd, by = bound(nbytes(*args, kw["gravity"], *y),
                        n * (step + b * circle))
        out[name] = dict(
            ms=kernel_ms(torch, lambda: fn(*args, **kw), 200, [kernel]),
            plain_ms=cuda_ms(torch, lambda: plain(*args, **kw), 20),
            bound_ms=bnd, bound_by=by, library_ms=None, circles=b,
            **advect_plan_keys(fn))
    return out


# -- The last four kernels (sections 42-47) ----------------------------------

FRAMES_AF = 3  # path AF: the mxu frame's CG reads |r|^2 on the host
SUBSTEPS_AG = 10  # path AG: the edge-matrix CG substep
P1_ITERS = 50  # P1's probe run, applies timed per pair
P2_OUTER = 5  # P2's probe run, launches timed per variant
K11B_CLUSTERS = (1, 3, 16)  # forced cluster sizes of section 43
# NVIDIA H100 SXM data sheet (dense, at the 700 W limit): tensor rates.
PEAK_BF16_OPS_PER_S = 989e12
PEAK_INT8_OPS_PER_S = 1979e12
LAST_SOURCES = {
    "edge_cg": ("fem_tpu_torch/csrc/edge_cg.cu",
                "fem_tpu/experiments/pallas_cg.py:181"),
    "fused_frame": ("fem_tpu_torch/csrc/fused_frame.cu",
                    "fem_tpu/experiments/pallas_frame.py:395"),
    "paired_matvec": ("fem_tpu_torch/csrc/probe_pairblock.cu",
                      "tools/probe_pairblock.py:62"),
    "chained_dot": ("fem_tpu_torch/csrc/probe_int8.cu",
                    "tools/probe_int8.py:78"),
}


def frames_go(frame, start, obs, frames):
    """A callable that runs ``frames`` frames of ``frame`` from ``start``."""
    def go():
        s = start
        for _ in range(frames):
            s, _ = frame(s, obs)
    return go


def rhs_of(torch, obj, state, H, dt):
    """b = v + dt·f/m from the rhs force columns H (plain PyTorch)."""
    from fem_tpu_torch.ops.assembly import element_contrib_full, gather_assemble

    f = gather_assemble(element_contrib_full(H), obj.plan.idx)
    return (state.vel + dt * f / obj.mass[:, None]).contiguous()


def run_last_kernels(torch, dev, zero_counts, counts, only, card):
    """Sections 42-47: K11a, K11b, P1 and P2 against their plain versions,
    their paths (AE the fused frame, AF the mxu operator, AG the edge-matrix
    CG substep, the probes' own entry points), their times and the kernels
    line's rows.  Returns (rows, phase seconds)."""
    from fem_tpu_torch import convert, entry, sim
    from fem_tpu_torch.experiments import edge_cg
    from fem_tpu_torch.experiments import fused_frame as ff
    from fem_tpu_torch.ops import blocked_kernels as bk
    from fem_tpu_torch.ops import element_kernels as ek
    from fem_tpu_torch.ops.blocking import blocked_scatter_sum
    from fem_tpu_torch.probes import int8 as p2
    from fem_tpu_torch.probes import pairblock as p1
    from fem_tpu_torch.solvers.advect import (
        advect_implicit_step, damping_decay, gravity_vector)
    from fem_tpu_torch.solvers.implicit import build_edge_matrix

    t_start = time.perf_counter()
    rows = []

    def cpu_copy(obj, state, obs):
        return (convert.object_from_arrays(*convert.object_to_arrays(obj),
                                           "cpu"),
                convert.state_from_arrays(convert.state_to_arrays(state),
                                          "cpu"),
                type(obs)(obs.centers.cpu(), obs.radii.cpu()))

    def row(name, d, launches, err, ms, plain_ms, moved, ops, peak=None,
            library=None, **extra):
        t_bytes = moved / PEAK_BYTES_PER_S
        t_ops = ops / (PEAK_F32_OPS_PER_S if peak is None else peak)
        bnd = max(t_bytes, t_ops) * 1e3
        by = "bytes" if t_bytes >= t_ops else "operations"
        source, replaces = LAST_SOURCES[name]
        log(f"[time] {name}{'' if d is None else f' {d}D'} {ms:.5f} ms a "
            f"launch on the device "
            f"(profiler){'' if library is None else f'; library {library:.5f} ms'}"
            f"; plain {plain_ms:.4f} ms; bound {bnd:.6f} ms ({by}); "
            f"launches {launches}; {extra}; card {card}")
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, dim=d,
            launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bnd, bound_by=by, library_ms=library, **extra))

    # -- 42. K11a against its plain version, and path AG --------------------
    cfg, obj, state0, obs = entry.flagship(dev)
    state = entry.deformed(state0)
    dpath = os.path.join(REPO, "configs", "default.json")
    dcfg, dobj, dstate0, dobs = entry.load_config(
        dpath, dev, sim_overrides=OVERRIDES_2D["implicit_cg"])
    dstate = squeezed_2d(torch, dstate0, torch.Generator().manual_seed(7))
    k11a = {}
    for d, o, s, c in ((3, obj, state, cfg), (2, dobj, dstate, dcfg)):
        s_mat = torch.as_tensor(build_edge_matrix(
            o.element_indices.cpu().numpy(), o.particle_cnt), device=dev)
        K, H = ek.hessian_and_force(s.pos, o.element_indices, o.ref_inv,
                                    o.volume, o.mu, o.s_lambda)
        b = rhs_of(torch, o, s, H, c.delta_time)
        worst = 0.0
        for pre in (False, True):
            kw = dict(dim=d, dt2=c.delta_time * c.delta_time,
                      preconditioned=pre)
            x, it = edge_cg.cg_solve_edge(s_mat, K, b, o.mass, **kw)
            xp, itp = edge_cg.cg_solve_edge_plain(s_mat, K, b, o.mass, **kw)
            x2, it2 = edge_cg.cg_solve_edge(s_mat, K, b, o.mass, **kw)
            torch.cuda.synchronize()
            err = float((x - xp).abs().max())
            worst = max(worst, err)
            log(f"[K11a {d}D] S {tuple(s_mat.shape)} "
                f"({s_mat.numel() * 4 / 1e6:.1f} MB) preconditioned="
                f"{int(pre)}: iterations {int(it)} (plain {int(itp)}), max "
                f"abs error {err:.3e}")
            require(int(it) == int(itp), f"K11a {d}D iterations differ")
            torch.testing.assert_close(x, xp, rtol=5e-4, atol=1e-6)
            require(torch.equal(x, x2) and torch.equal(it, it2),
                    f"K11a {d}D runs differ")
        k11a[d] = dict(err=worst, args=(s_mat, K, b, o.mass),
                       kw=dict(dim=d, dt2=c.delta_time * c.delta_time,
                               preconditioned=True), it=int(it))
    log("[K11a] two runs bit-identical in every case")
    k11a_rows = run_k11a_variants(torch, card, (
        ("flagship", k11a[3]["args"], 3, cfg.delta_time),
        ("default.json", k11a[2]["args"], 2, dcfg.delta_time)))
    log(json.dumps({"k11a_variants": k11a_rows}))
    # Path AG: the implicit substep with K11a as its solve (the JAX
    # package's cg_solve_pallas has no caller but its tests): K1, the rhs,
    # K11a, the plain advection, on the flagship deformed and on
    # default.json squeezed; its first substep equals the K1 + K4 substep
    # (sim.substep: the same semantics) to 1e-5.
    for d, o, s_start, c, ob in ((3, obj, state, cfg, obs),
                                 (2, dobj, dstate, dcfg, dobs)):
        s_mat = k11a[d]["args"][0]
        decay = damping_decay(c.delta_time, o.damping)
        grav = gravity_vector(tuple(c.g_dir), dev)

        def edge_substep(s, o=o, c=c, ob=ob, s_mat=s_mat, decay=decay,
                         grav=grav, d=d):
            K, H = ek.hessian_and_force(s.pos, o.element_indices, o.ref_inv,
                                        o.volume, o.mu, o.s_lambda)
            x, it = edge_cg.cg_solve_edge(
                s_mat, K, rhs_of(torch, o, s, H, c.delta_time), o.mass,
                dim=d, dt2=c.delta_time ** 2, preconditioned=True)
            return advect_implicit_step(s.replace(vel=x), ob, c.delta_time,
                                        decay, grav), it

        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        s, its = s_start, []
        for i in range(SUBSTEPS_AG):
            s, it = edge_substep(s)
            its.append(it)
            if i == 0:
                first_ag = s
        its = torch.stack(its).cpu()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
        log(f"[path AG {d}D] {SUBSTEPS_AG} substeps in {wall:.4f} s: "
            f"{SUBSTEPS_AG / wall:.1f} steps/s; launches {got}; CG "
            f"iterations {its.tolist()}")
        require(got == only(element_chain=SUBSTEPS_AG, edge_cg=SUBSTEPS_AG),
                f"path AG {d}D launches {got}")
        k11a[d]["launches"] = got["edge_cg"]
        ref_c, _ = sim.substep(o, s_start, ob, **sim.substep_kwargs(c))
        err = float((first_ag.pos - ref_c.pos).abs().max())
        log(f"[path AG {d}D] first substep vs the K1 + K4 substep: max "
            f"|dpos| {err:.3e}")
        require(err <= 1e-5, f"path AG {d}D off the K1 + K4 substep by {err}")

    # -- 43. K11b against its plain version, and path AE --------------------
    k11b = {}
    for d, c, o, s, ob in ((3, cfg, obj, state, obs),
                           (2, dcfg, dobj, dstate, dobs)):
        args = (s.pos, s.vel, s.vel_g, o.ref_inv, o.volume, o.element_indices,
                o.plan, o.mass, ob.centers, ob.radii)
        worst = 0.0
        for pre in (False, True):
            kw = dict(dt=c.delta_time, damping=o.damping, g_dir=tuple(c.g_dir),
                      mu=o.mu, s_lambda=o.s_lambda, preconditioned=pre,
                      sim_count=c.sim_count)
            out = ff.fused_frame(*args, **kw)
            ref = ff.fused_frame_plain(*args, **kw)
            again = ff.fused_frame(*args, **kw)
            ref64 = ff.fused_frame_plain(*[
                a.double() if a.is_floating_point() else a for a in args[:6]],
                args[6], *[a.double() for a in args[7:]], **kw)
            torch.cuda.synchronize()
            err = float((out[0] - ref[0]).abs().max())
            err_v = float((out[1] - ref[1]).abs().max())
            err_g = float((out[2] - ref[2]).abs().max())
            top_v = float(ref[1].abs().max())
            worst = max(worst, err)
            it, itp = out[3].tolist(), ref[3].tolist()
            log(f"[K11b {d}D] preconditioned={int(pre)}: iterations {it} "
                f"(plain {itp}); max |dpos| {err:.3e}, max |dvel| "
                f"{err_v:.3e} of max {top_v:.3e}, max |dvel_g| {err_g:.3e}; "
                f"max |dvel| from the f64 plain frame: kernel "
                f"{float((out[1].double() - ref64[1]).abs().max()):.3e}, "
                f"f32 plain "
                f"{float((ref[1].double() - ref64[1]).abs().max()):.3e}")
            require(err <= 1e-5, f"K11b {d}D positions off by {err}")
            # The velocity is a CG solve stopped after a few iterations:
            # the f32 plain frame itself lies 3e-5 to 5e-5 of the largest
            # |vel| from the f64 plain frame here (logged above), so vel is
            # held to 1e-4 of it, vel_g (no solve) to 1e-5.
            require(err_v <= 1e-4 * top_v,
                    f"K11b {d}D velocities off by {err_v} of {top_v}")
            require(err_g <= 1e-5, f"K11b {d}D vel_g off by {err_g}")
            require(all(abs(a - b) <= 1 for a, b in zip(it, itp)),
                    f"K11b {d}D iterations differ")
            require(all(torch.equal(a, b) for a, b in zip(out, again)),
                    f"K11b {d}D runs differ")
        k11b[d] = dict(err=worst, args=args, kw=kw)
    log("[K11b] two runs bit-identical in every case")
    # K11b's variants — the plan's, the single CTA, clusters of
    # K11B_CLUSTERS CTAs — against the plain frame (normal equations) on the
    # flagship and default.json: the tolerances above, twice bit-identical,
    # the barriers the kernel counted equal to frame_barriers; a cluster
    # whose CTA's state exceeds its shared memory (the flagship at 1 and 3
    # CTAs) is refused before any launch.
    k11b_variants = []
    for d in (3, 2):
        args, kw = k11b[d]["args"], k11b[d]["kw"]
        ref = ff.fused_frame_plain(*args, **kw)
        itp, top_v = ref[3].tolist(), float(ref[1].abs().max())
        for name, opts in (("auto", {}), ("single", dict(single=True))) + \
                tuple((f"cluster {c}", dict(cluster=c))
                      for c in K11B_CLUSTERS):
            try:
                out = ff.fused_frame(*args, **kw, **opts)
            except ValueError as exc:
                require(name not in ("auto", "single", "cluster 16"),
                        f"K11b {d}D {name} refused: {exc}")
                log(f"[K11b variants] {d}D {name}: refused as it must (its "
                    f"state exceeds a CTA's shared memory): {exc}")
                continue
            plan = ff.fused_frame.last_plan
            barriers = int(ff.fused_frame.last_barriers.item())
            again = ff.fused_frame(*args, **kw, **opts)
            torch.cuda.synchronize()
            it = out[3].tolist()
            err = [float((out[k] - ref[k]).abs().max()) for k in range(3)]
            want = ff.frame_barriers(plan.variant, True, it)
            require(err[0] <= 1e-5 and err[1] <= 1e-4 * top_v
                    and err[2] <= 1e-5, f"K11b {d}D {name} off by {err}")
            require(all(abs(a - b) <= 1 for a, b in zip(it, itp)),
                    f"K11b {d}D {name} iterations {it}, plain {itp}")
            require(all(torch.equal(a, b) for a, b in zip(out, again)),
                    f"K11b {d}D {name} runs differ")
            require(barriers == want, f"K11b {d}D {name}: {barriers} "
                    f"barriers counted, frame_barriers says {want}")
            ms = kernel_ms(torch, lambda: ff.fused_frame(*args, **kw, **opts),
                           10, ["fused_frame_kernel"])
            log(f"[K11b variants] {d}D {name}: {plan.variant} of "
                f"{plan.size} CTAs, {plan.smem} B of shared memory a CTA; "
                f"{ms:.5f} ms a frame (profiler); {barriers} barriers (= "
                f"frame_barriers); iterations {it} (plain {itp}); max "
                f"|dpos| {err[0]:.3e}, |dvel| {err[1]:.3e}, |dvel_g| "
                f"{err[2]:.3e}; twice bit-identical; card {card}")
            k11b_variants.append(dict(
                dim=d, launch=name, variant=plan.variant, ctas=plan.size,
                smem=plan.smem, ms=ms, barriers_per_frame=barriers,
                iterations=sum(it), max_abs_err=err[0]))
    log(json.dumps({"k11b_variants": k11b_variants}))
    # Path AE: configs/demo_spot.json with frame_backend="fused", 30
    # frames from the deformed state; then default.json's implicit_cg
    # variant from its squeezed state.
    for d, label, path, over, start_fn in (
        (3, "AE", entry.FLAGSHIP_CONFIG, {}, entry.deformed),
        (2, "AE 2D", dpath, OVERRIDES_2D["implicit_cg"],
         lambda s0: squeezed_2d(torch, s0, torch.Generator().manual_seed(7))),
    ):
        c, o, s0, ob = entry.load_config(
            path, dev, sim_overrides=dict(over, frame_backend="fused"))
        start = start_fn(s0)
        require(ff.supports_fused_frame(o, c), f"path {label} not eligible")
        frame = sim.make_frame_fn(o, c)
        warm, warm_aux = frame(start, ob)  # warm-up frame, not counted
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        s, its = start, []
        for _ in range(FRAMES):
            s, aux = frame(s, ob)
            its.append(aux.solver_iterations)
        its = torch.stack(its).cpu()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
        log(f"[path {label}] {FRAMES} frames x {c.sim_count} substeps in "
            f"{wall:.4f} s: {FRAMES * c.sim_count / wall:.1f} steps/s; "
            f"launches {got}; CG iterations a frame "
            f"{its.sum(dim=1).tolist()}")
        require(got == only(fused_frame=FRAMES), f"path {label} launches {got}")
        ae_plan = ff.fused_frame.last_plan
        ae_barriers = int(ff.fused_frame.last_barriers.item())
        want = ff.frame_barriers(ae_plan.variant, c.preconditioned == 1,
                                 its[-1].tolist())
        log(f"[path {label}] K11b launches by (variant, CTAs) "
            f"{ff.fused_frame.variant_launches}; the last frame's "
            f"{ae_barriers} barriers (frame_barriers: {want})")
        require(ff.fused_frame.variant_launches == {
            ("cluster", ae_plan.size): FRAMES},
            f"path {label} ran K11b's {ff.fused_frame.variant_launches}")
        require(ae_barriers == want, f"path {label}: {ae_barriers} barriers "
                f"counted, frame_barriers says {want}")
        k11b[d]["plan"] = ae_plan
        require(bool(torch.isfinite(s.pos).all()),
                f"path {label} non-finite positions")
        k11b[d]["launches"] = got["fused_frame"]
        k11b[d]["steps_per_s"] = FRAMES * c.sim_count / wall
        co, cs, cob = cpu_copy(o, start, ob)
        ref, ref_aux = sim.make_frame_fn(co, c)(cs, cob)
        err = float((warm.pos.cpu() - ref.pos).abs().max())
        err_v = float((warm.vel.cpu() - ref.vel).abs().max())
        err_g = float((warm.vel_g.cpu() - ref.vel_g).abs().max())
        log(f"[path {label}] first frame vs the CPU plain fused frame: max "
            f"|dpos| {err:.3e}, |dvel| {err_v:.3e}, |dvel_g| {err_g:.3e}; "
            f"iterations {warm_aux.solver_iterations.tolist()}, CPU "
            f"{ref_aux.solver_iterations.tolist()}")
        require(max(err, err_g) <= 1e-5
                and err_v <= 1e-4 * float(ref.vel.abs().max()),
                f"path {label} off the CPU frame by {err}, {err_v}, {err_g}")
        require(torch.equal(warm_aux.solver_iterations.cpu(),
                            ref_aux.solver_iterations),
                f"path {label} iterations differ from the CPU's")
        k5_frame = sim.make_frame_fn(o, dataclasses.replace(
            c, frame_backend="auto"))
        k5, k5_aux = k5_frame(start, ob)
        err = float((warm.pos - k5.pos).abs().max())
        diff = (warm_aux.solver_iterations - k5_aux.solver_iterations).abs()
        log(f"[path {label}] first frame vs path "
            f"{'A' if d == 3 else 'I'}'s K5 frame: max |dpos| {err:.3e}; "
            f"K5 iterations {k5_aux.solver_iterations.tolist()}")
        require(err <= 1e-5, f"path {label} off the K5 frame by {err}")
        require(int(diff.max()) <= 1, f"path {label} iterations vs K5")
        k11b[d]["device_ms"] = profile_window(
            torch, f"path {label} (K11b {d}D)",
            frames_go(frame, start, ob, FRAMES), FRAMES)
        k5_dev = profile_window(
            torch, f"path {label}'s K5 frame, for comparison",
            frames_go(k5_frame, start, ob, FRAMES), FRAMES)
        log(f"[path {label}] K11b / K5 device ms a frame: "
            f"{k11b[d]['device_ms']:.4f} / {k5_dev:.4f} = "
            f"{k11b[d]['device_ms'] / k5_dev:.2f}; card {card}")

    # -- 44. path AF: operator_mode="mxu" on the flagship -------------------
    c, o, s0, ob = entry.flagship(dev, sim_overrides=dict(operator_mode="mxu"))
    require(o.edge_matrix is not None and edge_cg.supports_edge_cg(o),
            "path AF: no edge matrix")
    require(not sim.supports_blocked_frame(o, c), "path AF routed to K5")
    start = entry.deformed(s0)
    frame = sim.make_frame_fn(o, c)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    s, its = start, []
    for i in range(FRAMES_AF):
        s, aux = frame(s, ob)
        its.append(aux.solver_iterations)
        if i == 0:
            first_af = s
    its = torch.stack(its).cpu()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    log(f"[path AF] {FRAMES_AF} frames in {wall:.4f} s: "
        f"{FRAMES_AF * c.sim_count / wall:.1f} steps/s; launches {got}; CG "
        f"iterations {its.tolist()}")
    require(got == only(element_chain=FRAMES_AF * c.sim_count),
            f"path AF launches {got}")
    require(bool(torch.isfinite(s.pos).all()), "path AF non-finite")
    co, cs, cob = cpu_copy(o, start, ob)
    require(co.edge_matrix is not None, "path AF: S not carried to the CPU")
    ref, _ = sim.make_frame_fn(co, c)(cs, cob)
    err = float((first_af.pos.cpu() - ref.pos).abs().max())
    log(f"[path AF] first frame vs the CPU: max |dpos| {err:.3e}")
    require(err <= 1e-5, f"path AF off the CPU frame by {err}")
    profile_window(torch, "path AF (K1 + the S products 3D, mxu)",
                   frames_go(frame, start, ob, FRAMES_AF), FRAMES_AF)

    # -- 45. P1 against its plain version and K3, and its probe run ---------
    blk = obj.blocking
    noisy = state.vel + 0.3 * torch.randn(
        state.vel.shape, generator=torch.Generator().manual_seed(3)).to(dev)
    Kb, _ = bk.blocked_prep(blk, state.pos, obj.mu, obj.s_lambda)
    kp = p1.make_kplane(blk, Kb)
    y = bk.blocked_graph_apply(blk, Kb, noisy)
    p1_in = {}
    p1_err = 0.0
    for pair in p1.PAIRS:
        bp, kpp, xb = p1.padded_inputs(blk, kp, noisy, pair)
        out = p1.paired_matvec(bp, kpp, xb, 3, pair)
        ref = p1.paired_matvec_plain(bp, kpp, xb, 3, pair)
        again = p1.paired_matvec(bp, kpp, xb, 3, pair)
        torch.cuda.synchronize()
        plan, launch = p1.paired_matvec.last_plan, p1.last_launch()
        log(f"[P1] pair {pair}, {bp.num_blocks} blocks: {launch.ctas} CTAs "
            f"of {launch.threads} threads in clusters of {launch.cluster}, "
            f"{launch.smem} bytes of shared memory a CTA (the launch)")
        require(launch == (plan.ctas * bp.num_blocks // pair, plan.threads,
                           plan.ctas, plan.smem),
                f"P1 pair {pair}: the launch {launch} is not {plan}")
        top = float(ref.abs().max())
        err = float((out - ref).abs().max())
        # K3's G(K)·x: P1's per-block products summed over each
        # particle's slots.
        err_k3 = float((blocked_scatter_sum(
            out[: blk.num_blocks].transpose(1, 2), blk) - y).abs().max())
        p1_err = max(p1_err, err)
        log(f"[P1] pair {pair}, {bp.num_blocks} blocks: max abs error "
            f"{err:.3e} (plain), {err_k3:.3e} (K3's product, slot-summed) "
            f"of max {top:.3e}")
        require(err <= 1e-5 * top and err_k3 <= 1e-5 * top,
                f"P1 pair {pair} error")
        require(torch.equal(out, again), f"P1 pair {pair} runs differ")
        require(not out[blk.num_blocks:].any(), "P1 padded blocks not zero")
        p1_in[pair] = (bp, kpp, xb, launch)
    log("[P1] two runs bit-identical for every pair")
    zero_counts()
    rc = p1.main(["--config", entry.FLAGSHIP_CONFIG, "--iters",
                  str(P1_ITERS)])
    torch.cuda.synchronize()
    got = counts()
    log(f"[P1 probe] launches {got}")
    require(rc == 0, "P1's probe run failed")
    # Per pair: for each profiler window the probe took (one, or more
    # where the profiler returned a window without the kernel's launches)
    # a warm-up and the timed applies; then a checked one; pair 1 also the
    # baseline.
    p1_counts = {pair: p1.paired_matvec.instance_launches.get((pair,), 0)
                 for pair in p1.PAIRS}
    log(f"[P1 probe] launches by pair {p1_counts}; profiler windows by "
        f"pair {p1.main.windows}")
    require(p1_counts == {pair: p1.main.windows[pair] * (P1_ITERS + 1) + 1
                          + (pair == 1) for pair in p1.PAIRS},
            f"P1's probe run launches by pair {p1_counts}")
    require(got == only(hessian_blocks=1,
                        paired_matvec=sum(p1_counts.values())),
            f"P1's probe run launches {got}")

    # -- 46. P2 against its plain version, and its probe run ----------------
    p2_in = {}
    for name in p2.VARIANTS:
        a, w = p2.probe_inputs(6, 1024, 2048, name, dev)
        out = p2.chained_dot(a, w, 200, name)
        ref = p2.chained_dot_plain(a, w, 200, name)
        again = p2.chained_dot(a, w, 200, name)
        torch.cuda.synchronize()
        top = float(ref.abs().max())
        err = float((out.double() - ref.double()).abs().max())
        log(f"[P2] {name}: max abs error {err:.3e} of max {top:.3e}")
        if name == "int8xint8":
            require(torch.equal(out, ref), "P2 int8xint8 not exact")
        else:
            require(err <= 1e-4 * top, f"P2 {name} error {err}")
        require(torch.equal(out, again), f"P2 {name} runs differ")
        plan = p2.chained_dot.last_plan
        macs = int(p2.chained_dot.last_macs.item())
        real = 200 * 6 * 1024 * 2048
        log(f"[P2] {name}: {plan}; the kernel issued {macs} MACs on the "
            f"tensor cores (reps x rows x n x cols = {real}: "
            f"{real / macs:.4f} of them real)")
        require(macs == plan.macs and macs >= real,
                f"P2 {name} issued {macs} MACs, fewer than the {real} of "
                f"its {200} reps or not its plan's {plan.macs}")
        p2_in[name] = (a, w, err, plan, macs)  # macs: the kernel's count
    log("[P2] two runs bit-identical for every variant")
    zero_counts()
    rc = p2.main(["--outer", str(P2_OUTER)])
    got = counts()
    log(f"[P2 probe] launches {got}")
    require(rc == 0, "P2's probe run failed")
    # Per variant: a warm-up and the timed launches.
    p2_counts = {name: p2.chained_dot.instance_launches.get((name,), 0)
                 for name in p2.VARIANTS}
    log(f"[P2 probe] launches by variant {p2_counts}")
    require(p2_counts == {name: P2_OUTER + 1 for name in p2.VARIANTS},
            f"P2's probe run launches by variant {p2_counts}")
    require(got == only(chained_dot=sum(p2_counts.values())),
            f"P2's probe run launches {got}")

    # -- 47. times and bounds -----------------------------------------------
    for d in (3, 2):
        s_mat, K, b, mass = k11a[d]["args"]
        kw = k11a[d]["kw"]
        ep = edge_cg.edge_plan(s_mat, d)
        x, it = edge_cg.cg_solve_edge(*k11a[d]["args"], **kw)
        k11a_keys = k11a_plan_keys(True, int(it))
        e, n = K.shape[0], b.shape[0]
        row("edge_cg", d, k11a[d]["launches"],
            k11a[d]["err"],
            kernel_ms(torch, lambda: edge_cg.cg_solve_edge(
                *k11a[d]["args"], **kw), 100, [k11a_kernel_name()]),
            cuda_ms(torch, lambda: edge_cg.cg_solve_edge_plain(
                *k11a[d]["args"], **kw), 3),
            nbytes(K, b, mass, ep.element_indices, ep.plan.ptr,
                   ep.plan.rows, x) + 4,
            cg_ops(e, n, k11a[d]["it"], True, d), iterations=k11a[d]["it"],
            library_note="no single PyTorch call runs a CG solve",
            **k11a_keys)
        args, kw = k11b[d]["args"], k11b[d]["kw"]
        out = ff.fused_frame(*args, **kw)
        o = obj if d == 3 else dobj
        iters = out[3].tolist()
        fplan = ff.fused_frame.last_plan
        barriers = int(ff.fused_frame.last_barriers.item())
        require(barriers == ff.frame_barriers(fplan.variant, True, iters),
                f"K11b {d}D timed frame: {barriers} barriers")
        row("fused_frame", d, k11b[d]["launches"], k11b[d]["err"],
            kernel_ms(torch, lambda: ff.fused_frame(*args, **kw), FRAMES,
                      ["fused_frame_kernel"]),
            cuda_ms(torch, lambda: ff.fused_frame_plain(*args, **kw), 2),
            nbytes(*args[:6], args[7], o.plan.ptr, o.plan.rows, *args[8:],
                   *out),
            frame_ops(o.element_cnt, o.particle_cnt, o.plan.rows.numel(),
                      iters, True, d),
            iterations=iters, steps_per_s=k11b[d]["steps_per_s"],
            device_ms_a_frame=k11b[d]["device_ms"],
            variant=fplan.variant, ctas=fplan.size,
            barriers_per_frame=barriers,
            path_variant=k11b[d]["plan"].variant,
            path_ctas=k11b[d]["plan"].size,
            library_note="no single PyTorch call runs a frame")
    tables = (blk.plus, blk.minus, blk.block_elements, blk.local_ptr,
              blk.local_rows)
    gmat = graph_matrix(torch, obj.element_indices,
                        Kb[blk.element_slot.long()], obj.particle_cnt)
    xcol = noisy.reshape(-1, 1)
    lib_err = float((torch.sparse.mm(gmat, xcol).reshape(-1, 3) - y).abs()
                    .max())
    require(lib_err <= 1e-4 * float(y.abs().max()), "P1 library differs")
    lib = library_device_ms(torch, lambda: torch.sparse.mm(gmat, xcol), 200)
    base_us = None
    for pair in p1.PAIRS:
        bp, kpp, xb, launch = p1_in[pair]
        out = p1.paired_matvec(bp, kpp, xb, 3, pair)
        ms = kernel_ms(torch, lambda: p1.paired_matvec(bp, kpp, xb, 3, pair),
                       200, ["paired_matvec_kernel"])
        base_us = ms * 1e3 if pair == 1 else base_us
        row("paired_matvec", 3, p1_counts[pair], p1_err, ms,
            cuda_ms(torch, lambda: p1.paired_matvec_plain(bp, kpp, xb, 3,
                                                          pair), 20),
            nbytes(kpp, xb, *tables, out),
            OPS[3]["apply"] * obj.element_cnt, library=lib, pair=pair,
            blocks=bp.num_blocks, us_per_apply=ms * 1e3,
            ratio_to_pair_1=ms * 1e3 / base_us, ctas=launch.ctas,
            threads=launch.threads, cluster=launch.cluster)
    per_dot = {}
    for name in p2.VARIANTS:
        a, w, err, plan, issued = p2_in[name]
        reps = 200
        out = p2.chained_dot(a, w, reps, name)
        ms = kernel_ms(torch, lambda: p2.chained_dot(a, w, reps, name), 20,
                       ["chained_dot_kernel"])
        per_dot[name] = ms * 1e3 / reps
        a_stack = p2.stacked(a, reps)
        w_lib = w if name != "int8xbf16" else w.to(torch.bfloat16)
        lib_out = p2.library_call(a_stack, w_lib, name)
        lib_sum = lib_out[: reps * a.shape[0]].reshape(
            reps, a.shape[0], -1).double().sum(dim=0)
        # int8: exact; bf16: the library rounds each product row to bf16.
        tol = 0.0 if name == "int8xint8" else 1e-2
        require(float((lib_sum - out.double()).abs().max())
                <= tol * float(out.double().abs().max()),
                f"P2 {name} library differs")
        macs = a.shape[0] * a.shape[1] * w.shape[1] * reps
        row("chained_dot", None, p2_counts[name], err, ms,
            cuda_ms(torch, lambda: p2.chained_dot_plain(a, w, reps, name), 3),
            nbytes(a, w, out), 2 * macs,
            peak=(PEAK_INT8_OPS_PER_S if name == "int8xint8"
                  else PEAK_BF16_OPS_PER_S),
            library=library_device_ms(
                torch, lambda: p2.library_call(a_stack, w_lib, name), 50),
            variant=name, reps=reps, us_per_dot=per_dot[name],
            width=plan.width, cluster=plan.cluster, groups=plan.groups,
            ctas=plan.slices * plan.cluster * plan.groups,
            issued_macs=issued)
    log(f"[P2] int8xint8 speedup over bf16: "
        f"{per_dot['bf16xbf16'] / per_dot['int8xint8']:.2f}x; int8xbf16 "
        f"over bf16: {per_dot['bf16xbf16'] / per_dot['int8xbf16']:.2f}x; "
        f"card {card}")
    return rows, time.perf_counter() - t_start


# -- K5's variants (section 48) ---------------------------------------------

K5_CLUSTERS = (1, 3, 16)  # forced cluster sizes of section 48


def run_k5_variants(torch, card, cases):
    """Section 48: K5 in each variant — the automatic plan, the grid variant
    (one CTA a block) and clusters of K5_CLUSTERS CTAs — against
    ``fused_blocked_frame_plain`` on the card for each of ``cases`` (label,
    body, state, obstacles, frame kwargs): positions within 1e-5, iterations
    within 1 per substep where the plain solves stay at 20 or fewer,
    velocities and ``vel_g`` as the module docstring says, two runs
    bit-identical, a cluster too large for a CTA's shared memory raising;
    each variant's device ms a frame (profiler) and the barriers its kernel
    counted in a frame.  Returns the rows of the ``k5_variants`` line."""
    from fem_tpu_torch.ops import frame_kernels as fk

    rows = []
    for label, obj, state, obs, kw in cases:
        blk = obj.blocking
        args = (blk, state.pos, state.vel, state.vel_g, obj.mass, obs.centers,
                obs.radii)
        ref = fk.fused_blocked_frame_plain(*args, preconditioned=True, **kw)
        itp = ref[3].tolist()
        limits = fk.device_limits(0, obj.dim)
        variants = [("auto", {}), ("grid", dict(grid=blk.num_blocks))] + [
            (f"cluster {c}", dict(cluster=c)) for c in K5_CLUSTERS]
        for name, launch in variants:
            def go(launch=launch):
                return fk.fused_blocked_frame(*args, preconditioned=True,
                                              **kw, **launch)
            if "cluster" in launch and fk.cluster_smem(
                    blk.num_blocks, blk.eb, blk.pb, obj.particle_cnt,
                    obj.dim, launch["cluster"]) > limits.smem_optin:
                try:
                    go()
                except RuntimeError as exc:
                    log(f"[K5 variants] {label}, {name}: raised as it must "
                        f"(its state exceeds a CTA's shared memory): {exc}")
                    continue
                require(False, f"K5 {label}, {name} did not raise")
            out, again = go(), go()
            torch.cuda.synchronize()
            plan = fk.fused_blocked_frame.last_plan
            it = out[3].tolist()
            err = float((out[0] - ref[0]).abs().max())
            require(err <= 1e-5, f"K5 {label}, {name}: positions off by {err}")
            verr = [float((out[k] - ref[k]).abs().max()) for k in (1, 2)]
            # A CG stopped at |r|^2 <= tol fixes vel to about sqrt(tol).
            require(verr[0] <= kw.get("tol", 1e-5) ** 0.5
                    and verr[1] <= 1e-5, f"K5 {label}, {name}: |dvel| "
                    f"{verr[0]}, |dvel_g| {verr[1]}")
            if max(itp) <= 20:
                require(all(abs(a - b) <= 1 for a, b in zip(it, itp)),
                        f"K5 {label}, {name}: iterations {it}, plain {itp}")
            require(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                        for a, b in zip(out, again)),
                    f"K5 {label}, {name}: runs differ")
            ms = kernel_ms(torch, go, 20, [k5_kernel_name()])
            keys = k5_plan_keys(it)
            log(f"[K5 variants] {label}, {name}: {keys}; {ms:.5f} ms a frame "
                f"(profiler); iterations {it} (plain {itp}); max |dpos| "
                f"{err:.3e}, |dvel| {verr[0]:.3e}, |dvel_g| {verr[1]:.3e}; "
                f"twice bit-identical; card {card}")
            rows.append(dict(scene=label, launch=name, ms=ms,
                             max_abs_err=err, iterations=sum(it), **keys))
    return rows


# -- K8's and K4's variants (sections 49 and 50) ----------------------------

K8_CLUSTERS = (1, 3, 16)  # forced cluster sizes of section 49
K4_CLUSTERS = (1, 3, 16)  # and of section 50


def run_k8_variants(torch, card, cases):
    """Section 49: K8 in each variant — the automatic plan, the grid variant
    (one CTA a block) and clusters of K8_CLUSTERS CTAs — against
    ``fused_explicit_frame_plain`` on the card for each of ``cases`` (label,
    body, state, obstacles, frame kwargs with the internal state when the
    body is inelastic): positions and the internal inverses within 1e-5,
    two runs bit-identical, every variant bit-identical to the grid
    variant, a cluster the plan refuses (more CTAs than blocks, or a CTA
    beyond the shared memory) raising before any launch; each variant's
    device ms a frame (profiler) and the barriers its kernel counted in a
    frame.  Returns the rows of the ``k8_variants`` line."""
    from fem_tpu_torch.ops import frame_kernels as fk

    rows = []
    for label, obj, state, obs, kw in cases:
        blk = obj.blocking
        args = (blk, state.pos, state.vel, obj.mass, obs.centers, obs.radii)
        inelastic = kw.get("plastic_inv") is not None or \
            kw.get("viscous_inv") is not None
        ref = fk.fused_explicit_frame_plain(*args, **kw)
        grid_out = fk.fused_explicit_frame(*args, **kw, grid=blk.num_blocks)
        variants = [("auto", {}), ("grid", dict(grid=blk.num_blocks))] + [
            (f"cluster {c}", dict(cluster=c)) for c in K8_CLUSTERS]
        for name, launch in variants:
            def go(launch=launch):
                return fk.fused_explicit_frame(*args, **kw, **launch)
            before = fk.fused_explicit_frame.launches
            try:
                out = go()
            except ValueError as exc:
                require(fk.fused_explicit_frame.launches == before,
                        f"K8 {label}, {name}: launched, then raised")
                require("cluster" in launch, f"K8 {label}, {name}: {exc}")
                log(f"[K8 variants] {label}, {name}: refused before the "
                    f"launch, as it must be: {exc}")
                continue
            again = go()
            torch.cuda.synchronize()
            keys = k8_plan_keys(inelastic, kw["sim_count"])
            if name == "auto":
                require(keys["variant"] == "cluster",
                        f"K8 {label}: the plan chose {keys}")
            err = float((out[0] - ref[0]).abs().max())
            serr = max([float((a - b).abs().max())
                        for a, b in zip(out[2:], ref[2:])] or [0.0])
            verr = float((out[1] - ref[1]).abs().max())
            require(err <= 1e-5 and serr <= 1e-5,
                    f"K8 {label}, {name}: positions off by {err}, the "
                    f"internal state by {serr}")
            require(all(torch.equal(a, b) for a, b in zip(out, again)),
                    f"K8 {label}, {name}: runs differ")
            require(all(torch.equal(a, b) for a, b in zip(out, grid_out)),
                    f"K8 {label}, {name}: differs from the grid variant")
            ms = kernel_ms(torch, go, 20, [k8_kernel_name()])
            log(f"[K8 variants] {label}, {name}: {keys}; {ms:.5f} ms a frame "
                f"(profiler); max |dpos| {err:.3e}, |dvel| {verr:.3e}, "
                f"|dF_i^-1| {serr:.3e}; twice bit-identical and equal to the "
                f"grid variant; card {card}")
            rows.append(dict(scene=label, launch=name, ms=ms,
                             max_abs_err=max(err, serr), **keys))
    return rows


def run_k4_variants(torch, card, cases):
    """Section 50: K4 in each variant — the automatic plan, the single CTA
    and clusters of K4_CLUSTERS CTAs — against ``fused_cg_solve_plain`` on
    the card for each of ``cases`` (label, body, state, dt), both
    ``preconditioned`` values: velocities rtol 5e-4 / atol 1e-6, equal
    iterations (the plain solves stay short), two runs bit-identical, the
    barriers the kernel counted; each variant's device ms a solve
    (profiler).  Returns the rows of the ``k4_variants`` line."""
    from fem_tpu_torch.ops import cg_kernels as cg, element_kernels as ek

    rows = []
    for label, obj, state, dt in cases:
        K, H = ek.hessian_and_force(state.pos, obj.element_indices,
                                    obj.ref_inv, obj.volume, obj.mu,
                                    obj.s_lambda)
        for pre in (True, False):
            solve = (K, H, obj.element_indices, obj.plan, state.vel, obj.mass,
                     dt, pre)
            vp, itp, _ = cg.fused_cg_solve_plain(*solve)
            require(int(itp) <= 20, f"K4 {label}: a long plain solve ({itp})")
            variants = [("auto", {}), ("single", dict(single=True))] + [
                (f"cluster {c}", dict(cluster=c)) for c in K4_CLUSTERS]
            for name, launch in variants:
                def go(launch=launch):
                    return cg.fused_cg_solve(*solve, **launch)
                before = cg.fused_cg_solve.launches
                try:
                    v, it, res = go()
                except ValueError as exc:
                    require(cg.fused_cg_solve.launches == before
                            and "cluster" in launch,
                            f"K4 {label}, {name}: {exc}")
                    log(f"[K4 variants] {label}, {name}: refused before the "
                        f"launch, as it must be: {exc}")
                    continue
                v2, it2, res2 = go()
                torch.cuda.synchronize()
                keys = k4_plan_keys(pre, int(it))
                if name == "auto":
                    require(keys["variant"] == "cluster",
                            f"K4 {label}: the plan chose {keys}")
                err = float((v - vp).abs().max())
                torch.testing.assert_close(v, vp, rtol=5e-4, atol=1e-6)
                require(int(it) == int(itp),
                        f"K4 {label}, {name}: {int(it)} iterations, plain "
                        f"{int(itp)}")
                require(torch.equal(v, v2) and torch.equal(it, it2)
                        and torch.equal(res, res2),
                        f"K4 {label}, {name}: runs differ")
                ms = kernel_ms(torch, go, 20, [k4_kernel_name()])
                log(f"[K4 variants] {label}, preconditioned={int(pre)}, "
                    f"{name}: {keys}; {ms:.5f} ms a solve (profiler); "
                    f"iterations {int(it)} (plain {int(itp)}); max |dvel| "
                    f"{err:.3e}; twice bit-identical; card {card}")
                rows.append(dict(scene=label, preconditioned=pre,
                                 launch=name, ms=ms, iterations=int(it),
                                 max_abs_err=err, **keys))
    return rows


K11A_CLUSTERS = (1, 3, 16)  # forced cluster sizes of section 42
K3_CLUSTERS = (1, 3, 16)  # and of section 51


def run_k11a_variants(torch, card, cases):
    """Section 42's variants: K11a in each — the automatic plan, the single
    CTA and clusters of K11A_CLUSTERS CTAs — against
    ``cg_solve_edge_plain`` on the card for each of ``cases`` (label, (S,
    K, b, mass), dim, dt), both ``preconditioned`` values: equal
    iterations, x within 1e-5 of its largest entry, two runs bit-identical,
    the barriers the kernel counted; a cluster whose CTA exceeds the shared
    memory refused before the launch; each variant's device ms a solve
    (profiler).  Returns the rows of the ``k11a_variants`` line."""
    from fem_tpu_torch.experiments import edge_cg

    rows = []
    for label, args, d, dt in cases:
        for pre in (True, False):
            kw = dict(dim=d, dt2=dt * dt, preconditioned=pre)
            xp, itp = edge_cg.cg_solve_edge_plain(*args, **kw)
            top = float(xp.abs().max())
            require(int(itp) <= 20, f"K11a {label}: a long plain solve")
            variants = [("auto", {}), ("single", dict(single=True))] + [
                (f"cluster {c}", dict(cluster=c)) for c in K11A_CLUSTERS]
            for name, launch in variants:
                def go(launch=launch):
                    return edge_cg.cg_solve_edge(*args, **kw, **launch)
                before = edge_cg.cg_solve_edge.launches
                try:
                    x, it = go()
                except ValueError as exc:
                    require(edge_cg.cg_solve_edge.launches == before
                            and "cluster" in launch,
                            f"K11a {label}, {name}: {exc}")
                    log(f"[K11a variants] {label}, {name}: refused before "
                        f"the launch, as it must be: {exc}")
                    continue
                x2, it2 = go()
                torch.cuda.synchronize()
                keys = k11a_plan_keys(pre, int(it))
                if name == "auto":
                    require(keys["variant"] == "cluster",
                            f"K11a {label}: the plan chose {keys}")
                err = float((x - xp).abs().max())
                require(int(it) == int(itp) and err <= 1e-5 * top,
                        f"K11a {label}, {name}: {int(it)} iterations (plain "
                        f"{int(itp)}), max |dx| {err} of {top}")
                require(torch.equal(x, x2) and torch.equal(it, it2),
                        f"K11a {label}, {name}: runs differ")
                ms = kernel_ms(torch, go, 20, [k11a_kernel_name()])
                log(f"[K11a variants] {label}, preconditioned={int(pre)}, "
                    f"{name}: {keys}; {ms:.5f} ms a solve (profiler); "
                    f"iterations {int(it)} (plain {int(itp)}); max |dx| "
                    f"{err:.3e} of {top:.3e}; twice bit-identical; card "
                    f"{card}")
                rows.append(dict(scene=label, preconditioned=pre,
                                 launch=name, ms=ms, iterations=int(it),
                                 max_abs_err=err, **keys))
    return rows


def run_k3_variants(torch, card, cases):
    """Section 51: K3 in each variant — the automatic plan, the two-kernel
    variant and clusters of K3_CLUSTERS CTAs — for each of ``cases``
    (label, blocking, K, x), both transposes: within 1e-5 of the plain
    version's largest entry, two runs bit-identical and bit-identical to
    the two-kernel variant, the barriers the cluster kernel counted; a
    cluster of more CTAs than blocks refused before the launch; each
    variant's device ms an apply (profiler).  Returns the rows of the
    ``k3_variants`` line."""
    from fem_tpu_torch.ops import blocked_kernels as bk

    rows = []
    for label, blk, K, x in cases:
        for tr in (False, True):
            yp = bk.blocked_graph_apply_plain(blk, K, x, tr)
            top = float(yp.abs().max())
            grid = bk.blocked_graph_apply(blk, K, x, tr, grid=True)
            variants = [("auto", {}), ("grid", dict(grid=True))] + [
                (f"cluster {c}", dict(cluster=c)) for c in K3_CLUSTERS]
            for name, launch in variants:
                def go(launch=launch):
                    return bk.blocked_graph_apply(blk, K, x, tr, **launch)
                before = bk.blocked_graph_apply.launches
                try:
                    y = go()
                except ValueError as exc:
                    require(bk.blocked_graph_apply.launches == before
                            and "cluster" in launch,
                            f"K3 {label}, {name}: {exc}")
                    log(f"[K3 variants] {label}, {name}: refused before the "
                        f"launch, as it must be: {exc}")
                    continue
                y2 = go()
                torch.cuda.synchronize()
                keys = k3_plan_keys()
                if name == "auto":
                    require(keys["variant"] == "cluster",
                            f"K3 {label}: the plan chose {keys}")
                err = float((y - yp).abs().max())
                require(top > 0 and err <= 1e-5 * top,
                        f"K3 {label}, {name}: max |dy| {err} of {top}")
                require(torch.equal(y, y2), f"K3 {label}, {name}: runs differ")
                require(torch.equal(y, grid),
                        f"K3 {label}, {name}: differs from the two-kernel "
                        f"variant")
                ms = kernel_ms(torch, go, 50, k3_kernel_names())
                log(f"[K3 variants] {label}, transpose_k={int(tr)}, {name}: "
                    f"{keys}; {ms:.5f} ms an apply (profiler); max |dy| "
                    f"{err:.3e} of {top:.3e}; twice bit-identical and equal "
                    f"to the two-kernel variant; card {card}")
                rows.append(dict(scene=label, transpose_k=tr, launch=name,
                                 ms=ms, max_abs_err=err, **keys))
    return rows


PREP_CLUSTERS = (1, 3, 16)  # forced cluster sizes of section 52


def run_prep_variants(torch, card, cases):
    """Section 52: K2, K7b and K7a in each variant — the automatic plan
    (the cluster variant), the grid variant and clusters of PREP_CLUSTERS
    CTAs — for each of ``cases`` (label, object, state): within
    1e-5 of the plain version's largest entry (K2's K 1e-5
    block-relative), twice bit-identical and bit-identical to the grid
    variant, the barriers the cluster kernel counted equal to
    ``blocked_barriers``', a cluster of more CTAs than blocks refused before
    the launch, each variant's device ms a launch (profiler); then K7b
    edges, twice bit-identical and within 1e-5 of the plain version.
    Returns the rows of the ``prep_variants`` line."""
    from fem_tpu_torch.ops import blocked_kernels as bk
    from fem_tpu_torch.ops import element_kernels as ek

    def tup(out):
        return out if isinstance(out, tuple) else (out,)

    rows = []
    for label, o, st in cases:
        blk = o.blocking
        args = (blk, st.pos, o.mu, o.s_lambda)
        cols = ek.explicit_grad_columns_plain(
            st.pos, blk.element_indices, blk.ref_inv, blk.volume, o.mu,
            o.s_lambda)
        for counter, call, plain in (
                ("blocked_prep",
                 lambda **kw: bk.blocked_prep_force(*args, **kw),
                 bk.blocked_prep_force_plain(*args)),
                ("blocked_grad_prep",
                 lambda **kw: bk.blocked_grad_force(*args, **kw),
                 bk.blocked_grad_force_plain(*args)),
                ("blocked_assemble",
                 lambda **kw: bk.blocked_assemble(blk, cols, **kw),
                 bk.blocked_assemble_plain(blk, cols))):
            fn = getattr(bk, counter)
            plain = tup(plain)
            grid = tup(call(grid=True))
            top = float(plain[-1].abs().max())
            variants = [("auto", {}), ("grid", dict(grid=True))] + [
                (f"cluster {c}", dict(cluster=c)) for c in PREP_CLUSTERS]
            for name, opts in variants:
                before = fn.launches
                try:
                    out = tup(call(**opts))
                except ValueError as exc:
                    require(fn.launches == before and "cluster" in opts,
                            f"{counter} {label}, {name}: {exc}")
                    log(f"[prep variants] {label}, {counter}, {name}: "
                        f"refused before the launch, as it must be: {exc}")
                    continue
                again = tup(call(**opts))
                torch.cuda.synchronize()
                keys = source_plan_keys(counter)
                if name == "auto":
                    require(keys["variant"] == "cluster",
                            f"{counter} {label}: the plan chose {keys}")
                err = float((out[-1] - plain[-1]).abs().max())
                require(top > 0 and err <= 1e-5 * top,
                        f"{counter} {label}, {name}: max |d| {err} of {top}")
                if counter == "blocked_prep":
                    rel = block_rel_err(out[0], plain[0])
                    require(rel <= 1e-5, f"K2 {label}, {name}: K "
                            f"block-relative error {rel}")
                require(all(torch.equal(a, b) for a, b in zip(out, again)),
                        f"{counter} {label}, {name}: runs differ")
                require(all(torch.equal(a, b) for a, b in zip(out, grid)),
                        f"{counter} {label}, {name}: differs from the grid "
                        f"variant")
                ms = kernel_ms(torch, lambda: call(**opts), 50,
                               source_kernel_names(counter))
                log(f"[prep variants] {label}, {counter}, {name}: "
                    f"{keys}; {ms:.5f} ms a launch (profiler); max |d| {err:.3e} of {top:.3e}; twice bit-identical "
                    f"and equal to the grid variant; card {card}")
                rows.append(dict(scene=label, kernel=counter, launch=name,
                                 ms=ms, max_abs_err=err, **keys))
        xp = bk.blocked_edges_plain(blk, st.pos)
        top = float(xp.abs().max())
        x = bk.blocked_edges(blk, st.pos)
        again = bk.blocked_edges(blk, st.pos)
        err = float((x - xp).abs().max())
        require(err <= 1e-5 * top, f"K7b edges {label}: {err} of {top}")
        require(torch.equal(x, again), f"K7b edges {label}: runs differ")
        ms = kernel_ms(torch, lambda: bk.blocked_edges(blk, st.pos), 50,
                       ["blocked_edges_kernel"])
        log(f"[prep variants] {label}, K7b edges over {EDGE_CTAS} CTAs a "
            f"block: {ms:.5f} ms a launch (profiler); max |d| {err:.3e} of "
            f"{top:.3e}; card {card}")
        rows.append(dict(scene=label, kernel="blocked_edges",
                         launch=f"{EDGE_CTAS} CTAs a block",
                         ctas=blk.num_blocks * EDGE_CTAS, ms=ms,
                         max_abs_err=err))
    return rows


# -- J1 and the Jacobi paths (sections 53-58) --------------------------------

FRAMES_AH = 200  # path AH: demo_passage_jacobi.json as shipped
FRAMES_PROFILED_AH = 10  # path AH's profiled window, in contact
FRAMES_AI = 3  # paths AI and AJ: the flagship, serial and snapshot
FRAMES_AK = 10  # path AK, each solver
J1_REPS = 20  # J1's timed launches a system
# The profiler's names of J1's two variants (csrc/jacobi_serial.cu).
J1_KERNELS = {"levels": "jacobi_levels_kernel",
              "serial": "jacobi_serial_kernel"}


def j1_device_ms(torch, go, frames, expected, windows=3, variant="levels"):
    """(J1's device ms a launch, its launches, the window's device ms a
    frame and busy share) over ``frames`` frames of ``go`` under the
    profiler, whose count of launches of J1's ``variant`` must be
    ``expected`` (one a substep); a window that missed some is taken
    again, as in kernel_ms."""
    name = J1_KERNELS[variant]
    for _ in range(windows):
        per_kernel, wall_ms = profile_kernels(torch, go, 1)
        hits = [v for k, v in per_kernel.items() if name in k]
        launches = sum(c for _, c in hits)
        if launches == expected:
            break
        log(f"[profiler] a window of {frames} frames saw {launches} "
            f"launches of {name}, not {expected}; taken again")
    require(launches == expected, f"the profiler saw {launches} launches of "
            f"{name} in {frames} frames, not {expected}")
    dev_ms = sum(t for t, _ in per_kernel.values())
    return (sum(t for t, _ in hits) / launches, launches, dev_ms / frames,
            100 * dev_ms / wall_ms)


def run_jacobi(torch, dev, zero_counts, counts, only, card):
    """Sections 53-58: J1 against its plain version, paths AH-AK and the
    implicit_jacobi golden.  Returns (the kernels line's J1 rows, phase
    seconds)."""
    from fem_tpu_torch import convert, entry, scene, sim
    from fem_tpu_torch.ops import element_kernels, jacobi_kernels as jk
    from fem_tpu_torch.ops.assembly import element_contrib_full, gather_assemble
    from fem_tpu_torch.solvers import dense, implicit

    import numpy as np

    t_phase = time.perf_counter()
    passage = os.path.join(REPO, "configs", "demo_passage_jacobi.json")
    default = os.path.join(REPO, "configs", "default.json")

    def on_cpu(obj, state, obs):
        return (convert.object_from_arrays(*convert.object_to_arrays(obj),
                                           "cpu"),
                convert.state_from_arrays(convert.state_to_arrays(state),
                                          "cpu"),
                type(obs)(obs.centers.cpu(), obs.radii.cpu()))

    def system(obj, state, dt, seed):
        """(sparse args, dense args or None) of J1 for one implicit
        substep at ``state``: K and the rhs from K1, a random anchor."""
        K, H = element_kernels.hessian_and_force(
            state.pos, obj.element_indices, obj.ref_inv, obj.volume, obj.mu,
            obj.s_lambda)
        f = gather_assemble(element_contrib_full(H), obj.plan.idx)
        b = (state.vel + dt * f / obj.mass[:, None]).contiguous()
        rows = implicit.sparse_system_rows(obj, K, dt).contiguous()
        rng = np.random.default_rng(seed)
        past = torch.as_tensor(rng.normal(scale=0.01, size=tuple(b.shape))
                               .astype(np.float32), device=dev)
        sparse = (rows, b, past, obj.jacobi_nb)
        if obj.dim == 3:
            return sparse, None
        a = dense.assemble_dense_system(obj, K, dt).contiguous()
        return sparse, (a, b, past)

    def squashed(state, seed):
        """The body squashed to 110 % across and 80 % up about its
        centroid, moving at random (numpy seed): the sweeps iterate."""
        rng = np.random.default_rng(seed)
        c = state.pos.mean(dim=0, keepdim=True)
        pos = c + (state.pos - c) * torch.tensor([[1.1, 0.8]], device=dev)
        vel = torch.as_tensor(rng.uniform(-0.3, 0.3, tuple(pos.shape))
                              .astype(np.float32), device=dev)
        return state.replace(pos=pos.contiguous(), vel=vel)

    errors = {2: 0.0, 3: 0.0}
    times = {}

    # -- 53. J1 against its plain version -------------------------------------
    def check_j1(label, d, args, pattern=None):
        """J1 (its plan's variant: the level variant on the sparse rows and
        on the dense rows with their ``pattern``) against its plain version,
        twice bit-identical; on the level variant also bit-identical to the
        serial variant, with the levels the kernel counted equal to L x
        sweeps."""
        kw = {} if pattern is None else dict(pattern=pattern)
        got = jk.jacobi_serial(*args, **kw)
        plan, counted = jk.jacobi_serial.last_plan, jk.jacobi_serial.last_levels
        again = jk.jacobi_serial(*args, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = jk.jacobi_serial_plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        it, itp = int(got.iterations), int(ref.iterations)
        top = float(ref.x.abs().max())
        err = max(float((got.x - ref.x).abs().max()),
                  float((got.past_x - ref.past_x).abs().max()))
        log(f"[J1] {label}: iterations {it} (plain {itp}), error "
            f"{float(got.error):.3e} (plain {float(ref.error):.3e}); max abs "
            f"error {err:.3e} of max {top:.3e}; plan {plan._asdict()}")
        require(it == itp and it > 1, f"J1 {label} iterations {it} vs {itp}")
        require(err <= 1e-5 * top, f"J1 {label} off by {err} of {top}")
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"J1 {label} runs differ")
        table = args[3] if len(args) > 3 else pattern
        levels = jk.level_plan(table).levels
        serial = jk.jacobi_serial(*args, variant="serial", **kw)
        torch.cuda.synchronize()
        require(plan.variant == "levels" and plan.levels == levels
                and plan.dense == (len(args) == 3),
                f"J1 {label} plan {plan}")
        require(all(torch.equal(a, b) for a, b in zip(got, serial)),
                f"J1 {label}: the level variant differs from the serial "
                "variant")
        require(int(counted) == levels * it,
                f"J1 {label}: the kernel ran {int(counted)} levels, not "
                f"{levels} x {it}")
        log(f"[J1] {label}: the level variant bit-identical to the "
            f"serial variant (x, past, iterations, error); {levels} "
            f"levels a sweep, {int(counted)} run (read from the kernel)")
        errors[d] = max(errors[d], err)
        return it, plain_ms

    cfg_p, obj_p, state_p, obs_p = entry.load_config(passage, dev)
    require((obj_p.particle_cnt, obj_p.element_cnt,
             obj_p.jacobi_nb.shape[1]) == (121, 200, 7),
            f"demo_passage_jacobi.json: {obj_p.particle_cnt} particles, "
            f"max_nb {obj_p.jacobi_nb.shape[1]}")
    cfg_f, obj_f, state_f, obs_f = entry.flagship(
        dev, sim_overrides=dict(implicit_method=0))
    require(obj_f.jacobi_nb.shape == (1007, 29),
            f"flagship Jacobi plan {tuple(obj_f.jacobi_nb.shape)}")
    deformed = entry.deformed(state_f)
    sparse2, dense2 = system(obj_p, squashed(state_p, 3), cfg_p.delta_time, 5)
    sparse3, _ = system(obj_f, deformed, cfg_f.delta_time, 6)
    checked = {}
    for label, d, args, pattern in (
            ("2D sparse rows (demo_passage_jacobi.json squashed)", 2,
             sparse2, None),
            ("2D dense rows", 2, dense2, obj_p.jacobi_nb),
            ("3D sparse rows (flagship deformed, one substep's system)", 3,
             sparse3, None)):
        checked[label] = (d, args) + check_j1(label, d, args, pattern)
    log("[J1] two runs bit-identical in every case")

    def solve_row(d, args, it, plain_ms, extra):
        """J1's kernels-line row of dimension ``d`` for the system
        ``args`` (sparse), which takes ``it`` sweeps: the level variant's
        time beside the serial variant's, from one run."""
        rows_t, b, past, nb = args
        n, dd = b.shape
        max_nb = nb.shape[1]
        levels = jk.level_plan(nb).levels
        ms = kernel_ms(torch, lambda: jk.jacobi_serial(*args), J1_REPS,
                       [J1_KERNELS["levels"]])
        serial_ms = kernel_ms(
            torch, lambda: jk.jacobi_serial(*args, variant="serial"),
            J1_REPS, [J1_KERNELS["serial"]])
        # Inputs read once and outputs written once; the products of a
        # sweep and of its error (2 flops a block entry each) and ~10
        # flops a component of the update.
        bytes_ = nbytes(rows_t, b, past, nb) + 2 * nbytes(b) + 8
        ops = it * (2 * 2 * n * max_nb * dd * dd + 10 * n * dd)
        bound_ms, bound_by = bound(bytes_, ops)
        sweep_bytes = nbytes(rows_t, nb, b) + nbytes(b)
        t = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=bound_by, library_ms=None, variant="levels",
                 levels=levels, iterations=it, ms_per_sweep=ms / it,
                 us_per_level=1e3 * ms / (it * levels),
                 us_per_row=1e3 * ms / (it * n), chain_levels=it * levels,
                 serial_ms=serial_ms, serial_ms_per_sweep=serial_ms / it,
                 serial_us_per_row=1e3 * serial_ms / (it * n),
                 sweep_bytes_bound_ms=1e3 * sweep_bytes / PEAK_BYTES_PER_S,
                 **extra)
        log(f"[time] {d}D jacobi_serial, level variant: {ms:.5f} ms a solve "
            f"of {it} sweeps on the device (profiler): "
            f"{t['ms_per_sweep']:.5f} ms a sweep of {levels} levels, "
            f"{t['us_per_level']:.4f} us a level, {t['us_per_row']:.4f} us a "
            f"row; serial variant {serial_ms:.5f} ms "
            f"({t['serial_us_per_row']:.4f} us a row); plain {plain_ms:.2f} "
            f"ms; bound {bound_ms:.6f} ms ({bound_by}), a sweep's bytes "
            f"{t['sweep_bytes_bound_ms']:.6f} ms; card {card}")
        return t

    def dense_row(args, pattern, it, plain_ms):
        """The dense rows' fields of J1's 2D row: the level variant on the
        pattern's schedule beside the serial variant, from one run; the
        least-work bound of the same solve — A's nonzero blocks (the
        pattern's, and a lone particle's diagonal block) and the pattern
        read once, b, past in, x, past out; those blocks' products in the
        sweeps and error passes and the updates — beside the whole
        matrix's (every entry read, every product), and its chain of L x
        sweeps levels."""
        a, b, past = args
        n, dd = b.shape
        nd = n * dd
        levels = jk.level_plan(pattern).levels
        ids = torch.arange(n, dtype=pattern.dtype, device=pattern.device)
        blocks = int((pattern >= 0).sum()) + int(
            (~(pattern == ids[:, None]).any(dim=1)).sum())
        ms = kernel_ms(torch, lambda: jk.jacobi_serial(*args,
                                                       pattern=pattern),
                       J1_REPS, [J1_KERNELS["levels"]])
        ran = int(jk.jacobi_serial.last_levels)
        serial_ms = kernel_ms(torch, lambda: jk.jacobi_serial(*args),
                              J1_REPS, [J1_KERNELS["serial"]])
        io = nbytes(b, past) + 2 * nbytes(b) + 8
        bound_ms, bound_by = bound(
            4 * blocks * dd * dd + nbytes(pattern) + io,
            it * (2 * 2 * blocks * dd * dd + 10 * nd))
        whole_ms, whole_by = bound(nbytes(a) + io,
                                   it * (2 * 2 * nd * nd + 10 * nd))
        t = dict(dense_ms=ms, dense_variant="levels", dense_levels=levels,
                 dense_levels_run=ran, dense_iterations=it,
                 dense_ms_per_sweep=ms / it,
                 dense_us_per_level=1e3 * ms / (it * levels),
                 dense_serial_ms=serial_ms, dense_plain_ms=plain_ms,
                 dense_bound_ms=bound_ms, dense_bound_by=bound_by,
                 dense_blocks=blocks, dense_bound_ms_whole_matrix=whole_ms,
                 dense_bound_by_whole_matrix=whole_by,
                 dense_chain_levels=it * levels,
                 dense_sweep_bytes_bound_ms=1e3 * nbytes(a)
                 / PEAK_BYTES_PER_S)
        log(f"[time] 2D jacobi_serial over the dense rows, level variant "
            f"({levels} levels, {ran} run, read from the kernel): {ms:.5f} ms "
            f"a solve of {it} sweeps (profiler), {t['dense_ms_per_sweep']:.5f} "
            f"ms a sweep, {t['dense_us_per_level']:.4f} us a level; serial "
            f"variant {serial_ms:.5f} ms; plain {plain_ms:.2f} ms; bound "
            f"{bound_ms:.6f} ms ({bound_by}; A's {blocks} nonzero blocks), "
            f"the whole matrix's {whole_ms:.6f} ms ({whole_by}), a sweep's "
            f"rows {t['dense_sweep_bytes_bound_ms']:.6f} ms; card {card}")
        return t

    # -- 54. path AH: demo_passage_jacobi.json as shipped ---------------------
    cobj_p, cstate_p, cobs_p = on_cpu(obj_p, state_p, obs_p)
    frame_p = sim.make_frame_fn(obj_p, cfg_p)
    cframe_p = sim.make_frame_fn(cobj_p, cfg_p)
    subs = FRAMES_AH * cfg_p.sim_count
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    s, states, iters = state_p, [], []
    for _ in range(FRAMES_AH):
        states.append(s)
        s, aux = frame_p(s, obs_p)
        iters.append(aux.solver_iterations)
    states.append(s)
    iters = torch.stack(iters).cpu()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_ah = counts()
    per_frame = iters.sum(dim=1)
    log(f"[path AH] {FRAMES_AH} frames x {cfg_p.sim_count} substeps in "
        f"{wall:.4f} s: {subs / wall:.1f} steps/s; launches {launches_ah}; "
        f"sweeps a frame: median {float(per_frame.median()):.0f}, max "
        f"{int(per_frame.max())}, mean {float(per_frame.float().mean()):.1f};"
        f" the first 60 frames' sweeps {per_frame[:60].tolist()}")
    require(launches_ah == only(element_chain=subs, jacobi_serial=subs),
            f"path AH launches {launches_ah}")
    require(jk.jacobi_serial.variant_launches == {"levels": subs},
            f"path AH's J1 variants {jk.jacobi_serial.variant_launches}")
    require(bool(torch.isfinite(s.pos).all()), "path AH non-finite")
    require(int(per_frame.sum()) > 0, "path AH never iterated")
    busiest = int(per_frame.argmax())
    for label, i in (("first frame", 0), (f"frame {busiest + 1} (the most "
                                          "sweeps)", busiest)):
        _, cst, _ = on_cpu(obj_p, states[i], obs_p)
        ref, ref_aux = cframe_p(cst, cobs_p)
        err = float((states[i + 1].pos.cpu() - ref.pos).abs().max())
        it, itp = iters[i].tolist(), ref_aux.solver_iterations.tolist()
        log(f"[path AH] {label} from the card's state, on the CPU: max "
            f"|dpos| {err:.3e}; sweeps {it} (CPU {itp})")
        require(err <= 1e-5, f"path AH {label} off the CPU by {err}")
        require(all(abs(a - b) <= 1 for a, b in zip(it, itp)),
                f"path AH {label} sweeps differ")
    contact = states[busiest]
    j1_ms_ah, j1_n_ah, dev_ms_ah, busy_ah = j1_device_ms(
        torch, frames_go(frame_p, contact, obs_p, FRAMES_PROFILED_AH),
        FRAMES_PROFILED_AH, FRAMES_PROFILED_AH * cfg_p.sim_count)
    sweeps_ah = float(iters[busiest:busiest + FRAMES_PROFILED_AH]
                      .float().mean())
    log(f"[path AH] {FRAMES_PROFILED_AH} frames from frame {busiest + 1} "
        f"under the profiler: J1 {j1_ms_ah:.5f} ms a solve ({j1_n_ah} "
        f"launches seen by the profiler, one a substep; ~{sweeps_ah:.1f} "
        f"sweeps a solve: "
        f"{j1_ms_ah / max(sweeps_ah, 1):.5f} ms a sweep); device "
        f"{dev_ms_ah:.4f} ms a frame, busy {busy_ah:.1f}%; card {card}")
    label2 = "2D sparse rows (demo_passage_jacobi.json squashed)"
    d2, args2, it2, plain2 = checked[label2]
    times[2] = solve_row(2, args2, it2, plain2, dict(
        path_ms_per_solve=j1_ms_ah, path_sweeps_per_solve=sweeps_ah,
        path_device_ms_per_frame=dev_ms_ah, path_busy_percent=busy_ah,
        path_steps_per_s=subs / wall))
    _, dense_args, it_dense, plain_dense = checked["2D dense rows"]
    times[2].update(dense_row(dense_args, obj_p.jacobi_nb, it_dense,
                              plain_dense))

    # -- 55. path AI: the flagship under the serial sweep ---------------------
    cobj_f, cstate_f, cobs_f = on_cpu(obj_f, deformed, obs_f)

    def flagship_path(label, c, expect):
        frame = sim.make_frame_fn(obj_f, c)
        ref, ref_aux = sim.make_frame_fn(cobj_f, c)(cstate_f, cobs_f)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        s, iters = deformed, []
        for i in range(FRAMES_AI):
            s, aux = frame(s, obs_f)
            iters.append(aux.solver_iterations)
            if i == 0:
                first = s
        iters = torch.stack(iters).cpu()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
        err = float((first.pos.cpu() - ref.pos).abs().max())
        it, itp = iters[0].tolist(), ref_aux.solver_iterations.tolist()
        log(f"[path {label}] {FRAMES_AI} frames x {c.sim_count} substeps in "
            f"{wall:.4f} s: {FRAMES_AI * c.sim_count / wall:.1f} steps/s; "
            f"launches {got}; sweeps {iters.tolist()}; first frame vs the "
            f"CPU: max |dpos| {err:.3e}, sweeps {it} (CPU {itp})")
        require(got == only(**expect(iters)), f"path {label} launches {got}")
        require(bool(torch.isfinite(s.pos).all()), f"path {label} non-finite")
        require(err <= 1e-5, f"path {label} off the CPU frame by {err}")
        require(all(abs(a - b) <= 1 for a, b in zip(it, itp)),
                f"path {label} sweeps differ")
        require(int(iters.min()) > 1, f"path {label} did not iterate")
        return frame, iters, wall

    subs_f = FRAMES_AI * cfg_f.sim_count
    frame_ai, iters_ai, wall_ai = flagship_path(
        "AI (flagship, serial)", cfg_f,
        lambda it: dict(element_chain=subs_f, jacobi_serial=subs_f))
    require(jk.jacobi_serial.variant_launches == {"levels": subs_f},
            f"path AI's J1 variants {jk.jacobi_serial.variant_launches}")
    j1_ms_ai, j1_n_ai, dev_ms_ai, busy_ai = j1_device_ms(
        torch, frames_go(frame_ai, deformed, obs_f, FRAMES_AI), FRAMES_AI,
        subs_f)
    sweeps_ai = float(iters_ai.float().mean())
    log(f"[path AI] {FRAMES_AI} frames under the profiler: J1 "
        f"{j1_ms_ai:.5f} ms a solve ({j1_n_ai} launches seen by the "
        f"profiler, one a substep; ~{sweeps_ai:.1f} sweeps: "
        f"{j1_ms_ai / sweeps_ai:.5f} ms a sweep); device "
        f"{dev_ms_ai:.4f} ms a frame, busy {busy_ai:.1f}%; card {card}")
    label3 = "3D sparse rows (flagship deformed, one substep's system)"
    _, args3, it3, plain3 = checked[label3]
    times[3] = solve_row(3, args3, it3, plain3, dict(
        path_ms_per_solve=j1_ms_ai, path_sweeps_per_solve=sweeps_ai,
        path_device_ms_per_frame=dev_ms_ai, path_busy_percent=busy_ai,
        path_steps_per_s=subs_f / wall_ai))

    # -- 56. path AJ: the flagship's snapshot sweep over K3 -------------------
    cfg_j = dataclasses.replace(cfg_f, jacobi_sweep="snapshot")
    frame_aj, _, _ = flagship_path(
        "AJ (flagship, snapshot over K3)", cfg_j,
        lambda it: dict(element_chain=2 * subs_f,
                        blocked_matvec=int((1 + 2 * it).sum())))
    profile_window(torch, "AJ (flagship, snapshot over K3)",
                   frames_go(frame_aj, deformed, obs_f, FRAMES_AI), FRAMES_AI)

    # -- 57. path AK: default.json with the dense backend ---------------------
    for label, over, expect in (
        ("AK (default.json, dense CG)",
         dict(OVERRIDES_2D["implicit_cg"], solver_backend="dense"),
         lambda n: dict(element_chain=n)),
        ("AK (default.json, dense Jacobi)",
         dict(OVERRIDES_2D["implicit_jacobi"], solver_backend="dense"),
         lambda n: dict(element_chain=n, jacobi_serial=n)),
    ):
        cfg_k, obj_k, state_k, obs_k = entry.load_config(
            default, dev, sim_overrides=over)
        start = squeezed_2d(torch, state_k, torch.Generator().manual_seed(7))
        cobj_k, cstart, cobs_k = on_cpu(obj_k, start, obs_k)
        frame = sim.make_frame_fn(obj_k, cfg_k)
        ref, ref_aux = sim.make_frame_fn(cobj_k, cfg_k)(cstart, cobs_k)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        s, iters = start, []
        for i in range(FRAMES_AK):
            s, aux = frame(s, obs_k)
            iters.append(aux.solver_iterations)
            if i == 0:
                first = s
        iters = torch.stack(iters).cpu()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
        n = FRAMES_AK * cfg_k.sim_count
        err = float((first.pos.cpu() - ref.pos).abs().max())
        it, itp = iters[0].tolist(), ref_aux.solver_iterations.tolist()
        log(f"[path {label}] {FRAMES_AK} frames in {wall:.4f} s: "
            f"{n / wall:.1f} steps/s; launches {got}; iterations by frame "
            f"{iters.sum(dim=1).tolist()}; first frame vs the CPU: max "
            f"|dpos| {err:.3e}, iterations {it} (CPU {itp})")
        require(got == only(**expect(n)), f"path {label} launches {got}")
        if "Jacobi" in label:
            require(jk.jacobi_serial.last_plan.dense,
                    "path AK's J1 did not take the dense rows")
            require(jk.jacobi_serial.variant_launches == {"levels": n},
                    f"path AK's J1 variants "
                    f"{jk.jacobi_serial.variant_launches}")
            times[2]["dense_launches"] = n
            dense_go = frames_go(frame, start, obs_k, FRAMES_AK)
            ak_ms, ak_n, ak_dev, ak_busy = j1_device_ms(
                torch, dense_go, FRAMES_AK, n)
            zero_counts()
            times[2].update(ak_j1_ms=ak_ms, ak_device_ms_per_frame=ak_dev,
                            ak_busy_percent=ak_busy)
            log(f"[path AK] dense Jacobi, {FRAMES_AK} frames under the "
                f"profiler: J1 (level variant) {ak_ms:.5f} ms a solve "
                f"({ak_n} launches seen); device {ak_dev:.4f} ms a frame, "
                f"busy {ak_busy:.1f}%; card {card}")
        require(bool(torch.isfinite(s.pos).all()), f"path {label} non-finite")
        require(err <= 1e-5, f"path {label} off the CPU frame by {err}")
        require(all(abs(a - b) <= 1 for a, b in zip(it, itp)),
                f"path {label} iterations differ")
        require(int(iters[0].min()) > 0, f"path {label} did not iterate")

    # -- 58. the implicit_jacobi golden through J1 ----------------------------
    cfg_d, _, _, _ = entry.load_config(default, dev)
    gcfg = dataclasses.replace(
        cfg_d, objects=(dataclasses.replace(cfg_d.objects[0],
                                            subdivisions=6),),
        **OVERRIDES_2D["implicit_jacobi"])
    (gbody,), gobs = scene.load_scene(gcfg, device=dev)
    gframe = sim.make_frame_fn(gbody.obj, gcfg)
    zero_counts()
    t0 = time.perf_counter()
    s = gbody.state
    for _ in range(GOLDEN_FRAMES):
        s, _ = gframe(s, gobs)
    torch.cuda.synchronize()
    got = counts()
    n = GOLDEN_FRAMES * gcfg.sim_count
    log(f"[golden implicit_jacobi] {GOLDEN_FRAMES} frames through J1 in "
        f"{time.perf_counter() - t0:.2f} s; launches {got}")
    require(got == only(element_chain=n, jacobi_serial=n),
            f"golden implicit_jacobi launches {got}")
    golden_check(torch, "implicit_jacobi", s.pos)

    launches = {2: launches_ah["jacobi_serial"],
                3: FRAMES_AI * cfg_f.sim_count}
    source, replaces = next((src, rep) for name, src, rep in KERNELS
                            if name == "jacobi_serial")
    rows = [dict(name="jacobi_serial", route="cuda", source=source,
                 replaces=replaces, dim=d, launches=launches[d],
                 max_abs_err=errors[d], **times[d]) for d in (3, 2)]
    return rows, time.perf_counter() - t_phase


# -- The CLI, the API and the adaptive-dt guard (sections 59-61) -------------

FRAMES_AL = 30  # path AL: the CLI's and the API's flagship runs
CHECKPOINT_AL = 10  # path AL: the CLI's checkpoint cadence
FRAMES_AM = 5  # path AM: checked guarded frames a level
FRAMES_PROFILED = 10  # paths AL and AM: frames a profiled window
FRAMES_AN = 8  # path AN: the stiff reproducer, each way
# Path AN: tests/test_adaptive_dt.py's stiff square (7 subdivisions, E 4e5)
# at dt 2e-3 under default.json's two circles, its velocities noised by
# 1e-4 (numpy seed 0) to seed the blow-up (tests/test_torch_adaptive.py).
STIFF_AN = dict(
    dim=2, delta_time=2e-3, sim_count=10, auto_diff=False,
    use_explicit_method=False, implicit_method=1, preconditioned=1,
    g_dir=[0, -1],
    objects=[dict(center=[0.5, 0.8], side_length=0.2, subdivisions=7,
                  E=4e5)],
    blocks=[dict(id=0, block_center=[0.8, 0.5], block_radius=0.21),
            dict(id=1, block_center=[0.2, 0.5], block_radius=0.21)])


def cli_run(args):
    """``fem_tpu_torch.main.run(args)`` with its standard output kept: (exit
    code, the lines it printed)."""
    import contextlib
    import io

    from fem_tpu_torch import main as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.run(args)
    return rc, buf.getvalue().splitlines()


def export_count(frames, dt_frame, fps, bodies=1):
    """OBJ exports of a CLI run of ``frames`` frames: the reference's rule
    (its main.py:113-122), the clock advanced ``bodies`` times a frame."""
    vt, count = 0.0, 0
    for _ in range(frames):
        for _ in range(bodies):
            vt += dt_frame
        if vt / (1.0 / fps) > count:
            count += 1
    return count


def k5_substeps(torch, iterations):
    """Substeps of the last K5 launch, from the barriers its kernel counted
    (``fused_blocked_frame.last_barriers``) less those of the CG iterations
    it reported, over each substep's own (``frame_barriers`` of one
    substep at 0 and at 1 iteration)."""
    from fem_tpu_torch.ops import frame_kernels as fk

    fn = fk.fused_blocked_frame
    variant = fn.last_plan.variant
    met = int(fn.last_barriers.item())
    per_step = fk.frame_barriers(variant, True, [0]) - 1
    per_it = fk.frame_barriers(variant, True, [1]) - per_step - 1
    return (met - 1 - per_it * int(iterations.sum())) / per_step, met


def counted_window(torch, label, go, frames, expected):
    """(device ms a frame, busy share) of ``frames`` frames of ``go`` under
    the profiler, for a window that launched ``expected`` ({kernel name:
    launches}, the wrappers' counts): each expected kernel at its mean
    time a launch over the launches the profiler saw (CUPTI drops some at
    a window's edge, more than one at times), the other kernels as seen.
    Fails if it saw none of one, or more than were launched."""
    per_kernel, wall_ms = profile_kernels(torch, go, 1)
    total, seen = 0.0, {}
    for key, (t, c) in per_kernel.items():
        name = next((n for n in expected if n in key), None)
        if name is None:
            total += t
        else:
            seen.setdefault(name, [0.0, 0])
            seen[name][0] += t
            seen[name][1] += c
    for name, launched in expected.items():
        t, c = seen.get(name, (0.0, 0))
        require(0 < c <= launched, f"{label}: the profiler saw {c} of the "
                f"{launched} launches of {name}")
        total += t / c * launched
    dev_ms = total / frames
    busy = 100 * total / wall_ms
    log(f"[profile] {label}: {frames} frames under the profiler: device "
        f"time {dev_ms:.4f} ms/frame of {wall_ms / frames:.4f} ms/frame wall "
        f"in the same window: device busy {busy:.1f}%; launches seen "
        f"{ {n: v[1] for n, v in seen.items()} } of {expected}")
    return dev_ms, busy


def run_entry_points(torch, dev, zero_counts, counts, only, card):
    """Sections 59-61: paths AL (the CLI and ``Simulation``), AM (the
    guarded flagship) and AN (the stiff reproducer).  Returns (the
    ``entry_paths`` line's dict, phase seconds)."""
    import shutil

    import numpy as np

    import fem_tpu_torch
    from fem_tpu_torch import convert, entry, sim
    from fem_tpu_torch.models import mesh as pmesh
    from fem_tpu_torch.models.state import Obstacles, build_object
    from fem_tpu_torch.solvers import adaptive
    from fem_tpu_torch.utils.config import parse_config

    t_phase = time.perf_counter()
    out_dir = os.path.join(REPO, "build", "chip_smoke_entry")
    shutil.rmtree(out_dir, ignore_errors=True)
    spot = os.path.join(REPO, "configs", "demo_spot.json")
    default = os.path.join(REPO, "configs", "default.json")
    line = {}

    def on_cpu(obj, state, obs):
        return (convert.object_from_arrays(*convert.object_to_arrays(obj),
                                           "cpu"),
                convert.state_from_arrays(convert.state_to_arrays(state),
                                          "cpu"),
                type(obs)(obs.centers.cpu(), obs.radii.cpu()))

    def ckpt(folder, frame):
        return np.load(os.path.join(out_dir, folder, f"ckpt_{frame:06}.npz"))

    def first_frame_check(label, path, backend):
        """The CLI's first frame on the card within 1e-5 of the CPU frame
        (``frame_backend=backend``, the kernel's plain version)."""
        rc, _ = cli_run(["--config", path, "--frames", "1", "--no-render",
                         "--checkpoint-every", "1", "--print-every", "0",
                         "--output", os.path.join(out_dir, label + "_1")])
        require(rc == 0, f"path AL {label}: one frame exit code {rc}")
        cfg, cobj, cstate, cobs = entry.load_config(path, "cpu")
        ref, _ = sim.make_frame_fn(
            cobj, dataclasses.replace(cfg, frame_backend=backend))(cstate,
                                                                   cobs)
        err = float(np.abs(ckpt(label + "_1", 1)["b0_pos"]
                           - ref.pos.numpy()).max())
        log(f"[path AL] {label}: the CLI's first frame on the card vs the "
            f"CPU {backend} frame: max |dpos| {err:.3e}")
        require(err <= 1e-5, f"path AL {label}: first frame off by {err}")
        return err

    # -- 59. path AL: the CLI and Simulation ----------------------------------
    cwd = os.getcwd()
    os.chdir(REPO)  # the configs name their meshes relative to the repo
    try:
        scfg, _, _, _ = entry.load_config(spot, "cpu")
        args = ["--config", spot, "--no-render", "--checkpoint-every",
                str(CHECKPOINT_AL), "--print-every", str(CHECKPOINT_AL)]
        zero_counts()
        rc, printed = cli_run(args + ["--frames", str(FRAMES_AL), "--output",
                                      os.path.join(out_dir, "straight")])
        torch.cuda.synchronize()
        launches = counts()
        for text in printed:
            log(f"[path AL] CLI: {text}")
        require(rc == 0, f"path AL: the CLI's exit code {rc}")
        require(launches == only(blocked_frame=FRAMES_AL),
                f"path AL: the CLI's launches {launches}")
        last = [t for t in printed if t.startswith(f"frame {FRAMES_AL}/")]
        require(len(last) == 1, "path AL: no print at the last frame")
        cli_steps = float(last[0].split(" steps/s")[0].split()[-1])
        zero_counts()
        rc, printed = cli_run(args + ["--frames", str(FRAMES_AL), "--output",
                                      os.path.join(out_dir, "resumed"),
                                      "--resume", os.path.join(
                                          out_dir, "straight",
                                          f"ckpt_{CHECKPOINT_AL:06}.npz")])
        torch.cuda.synchronize()
        launches = counts()
        require(rc == 0 and launches == only(
            blocked_frame=FRAMES_AL - CHECKPOINT_AL),
            f"path AL resume: exit code {rc}, launches {launches}")
        a, b = ckpt("straight", FRAMES_AL), ckpt("resumed", FRAMES_AL)
        require(sorted(a.files) == sorted(b.files)
                and all(np.array_equal(a[k], b[k]) for k in a.files),
                "path AL: the resumed run differs from the straight run")
        expected = export_count(FRAMES_AL,
                                scfg.sim_count * scfg.delta_time,
                                scfg.output_fps)
        names = sorted(n for n in os.listdir(os.path.join(out_dir,
                                                          "straight"))
                       if n.endswith(".obj"))
        require(names == [f"obj_{i:06}.obj" for i in range(expected)],
                f"path AL: OBJ files {names}, {expected} expected")
        with open(os.path.join(out_dir, "straight", names[-1])) as f:
            straight_obj = f.read()
        with open(os.path.join(out_dir, "resumed", names[-1])) as f:
            require(f.read() == straight_obj,
                    "path AL: the resumed run's last OBJ differs")
        log(f"[path AL] CLI, configs/demo_spot.json: {FRAMES_AL} frames, K5 "
            f"once a frame ({FRAMES_AL} launches and no other kernel); "
            f"{cli_steps:.1f} steps/s as it printed (host clock, its first "
            f"frame plans K5's cluster); resumed from frame {CHECKPOINT_AL} "
            f"bit-equal to the straight run; {expected} OBJ files at the "
            f"cadence, the last equal; card {card}")
        err_spot = first_frame_check("demo_spot", spot, "blocked")
        # The same run with no output in a frame: OBJ export off, no
        # checkpoint, one print at the end.
        with open(spot) as f:
            quiet = json.load(f)
        quiet["is_output_obj"] = False
        quiet_path = os.path.join(out_dir, "demo_spot_no_obj.json")
        with open(quiet_path, "w") as f:
            json.dump(quiet, f)
        zero_counts()
        rc, printed = cli_run(["--config", quiet_path, "--frames",
                               str(FRAMES_AL), "--no-render",
                               "--print-every", str(FRAMES_AL), "--output",
                               os.path.join(out_dir, "quiet")])
        torch.cuda.synchronize()
        launches = counts()
        require(rc == 0 and launches == only(blocked_frame=FRAMES_AL),
                f"path AL without output: exit code {rc}, launches "
                f"{launches}")
        quiet_steps = float(printed[-1].split(" steps/s")[0].split()[-1])
        log(f"[path AL] CLI, configs/demo_spot.json without OBJ export or "
            f"checkpoints: {FRAMES_AL} frames, K5 once a frame; "
            f"{quiet_steps:.1f} steps/s as it printed")
        zero_counts()
        rc, printed = cli_run(["--config", default, "--frames",
                               str(FRAMES_AL), "--no-render",
                               "--print-every", str(FRAMES_AL), "--output",
                               os.path.join(out_dir, "default")])
        torch.cuda.synchronize()
        launches = counts()
        require(rc == 0 and launches == only(explicit_frame=FRAMES_AL),
                f"path AL default.json: exit code {rc}, launches {launches}")
        default_steps = float(printed[-1].split(" steps/s")[0].split()[-1])
        log(f"[path AL] CLI, configs/default.json: {FRAMES_AL} frames, K8 "
            f"once a frame; {default_steps:.1f} steps/s as it printed")
        err_default = first_frame_check("default", default,
                                        "blocked_explicit")

        api = fem_tpu_torch.Simulation.from_config(spot, device=dev)
        api.run(frames=1, nan_guard=True)  # warm-up: K5 plans its cluster
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        api.run(frames=FRAMES_AL, nan_guard=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts()
        require(launches == only(blocked_frame=FRAMES_AL),
                f"path AL Simulation: launches {launches}")
        m = api.metrics()
        require(not m.any_nan, f"path AL Simulation: {m}")
        api_steps = FRAMES_AL * scfg.sim_count / wall
        k5_frames = {k5_kernel_name(): FRAMES_PROFILED}
        api_ms, api_busy = counted_window(
            torch, "path AL (Simulation.run, nan_guard)",
            lambda: api.run(frames=FRAMES_PROFILED, nan_guard=True),
            FRAMES_PROFILED, k5_frames)
        plain_frame = sim.make_frame_fn(api.scene[0].obj, scfg)
        frame_ms, frame_busy = counted_window(
            torch, "path AL (the same body's frame function, path A's "
            "route)", frames_go(plain_frame, api.scene[0].state,
                                api.obstacles, FRAMES_PROFILED),
            FRAMES_PROFILED, k5_frames)
        log(f"[path AL] Simulation on the flagship, nan_guard=True: "
            f"{FRAMES_AL} frames, K5 once a frame, {api_steps:.1f} steps/s "
            f"(a small read back a frame); {api_ms:.4f} device ms a frame, "
            f"{api_busy:.1f}% busy (its frame function alone "
            f"{frame_ms:.4f}, {frame_busy:.1f}%); metrics {m}; card {card}")
        line["AL"] = dict(cli_steps_per_s=cli_steps,
                          quiet_cli_steps_per_s=quiet_steps,
                          default_cli_steps_per_s=default_steps,
                          api_steps_per_s=api_steps,
                          api_device_ms_per_frame=api_ms,
                          api_busy_percent=api_busy,
                          frame_device_ms_per_frame=frame_ms,
                          frame_busy_percent=frame_busy,
                          first_frame_err=max(err_spot, err_default))
    finally:
        os.chdir(cwd)

    # -- 60. path AM: the guarded flagship -------------------------------------
    cfg, obj, state0, obs = entry.flagship(dev)
    state = entry.deformed(state0)
    cobj, cstate, cobs = on_cpu(obj, state, obs)
    dt = cfg.delta_time
    kappa = float(adaptive.kappa_estimate(obj, state.pos, dt))
    kappa_cpu = float(adaptive.kappa_estimate(cobj, cstate.pos, dt))
    rel = abs(kappa - kappa_cpu) / kappa_cpu
    log(f"[path AM] kappa of the deformed flagship {kappa:.6e} (K2), plain "
        f"{kappa_cpu:.6e} on the CPU: relative error {rel:.3e}")
    require(rel <= 1e-5, f"path AM: kappa off by {rel} relative")
    line["AM"] = dict(kappa=kappa, kappa_rel_err=rel, levels={})
    frame_a = sim.make_frame_fn(obj, cfg)
    frame_a(state, obs)
    a_ms, a_busy = counted_window(
        torch, "path A (K5, unguarded)",
        frames_go(frame_a, state, obs, FRAMES_PROFILED), FRAMES_PROFILED,
        {k5_kernel_name(): FRAMES_PROFILED})
    for level, n in enumerate(adaptive.LEVELS):
        # κ/θ of 0.5, 2, 8 and 32: inside each level's (4^(l-1), 4^l].
        gcfg = dataclasses.replace(cfg, adaptive_dt=True,
                                   adaptive_dt_threshold=kappa / (
                                       0.5 * 4.0 ** level))
        frame = sim.make_frame_fn(obj, gcfg)
        frame(state, obs)  # warm-up, not counted
        torch.cuda.synchronize()
        zero_counts()
        reads = adaptive.read_level.reads
        s, first, barriers = state, None, []
        for i in range(FRAMES_AM):
            s, aux = frame(s, obs)
            subs, met = k5_substeps(torch, aux.solver_iterations)
            barriers.append(met)
            require(subs == cfg.sim_count * n,
                    f"path AM level {level} frame {i}: K5 counted {subs} "
                    f"substeps, not {cfg.sim_count * n}")
            if i == 0:
                first = (s, aux)
        torch.cuda.synchronize()
        launches = counts()
        require(launches == only(blocked_prep=FRAMES_AM,
                                 blocked_frame=FRAMES_AM),
                f"path AM level {level}: launches {launches}")
        require(adaptive.read_level.reads - reads == FRAMES_AM,
                f"path AM level {level}: host reads of the level")
        require(bool(torch.isfinite(s.pos).all()), f"path AM level {level} "
                "non-finite")
        ref, ref_aux = sim.make_frame_fn(
            cobj, dataclasses.replace(gcfg, frame_backend="blocked"))(cstate,
                                                                      cobs)
        err = float((first[0].pos.cpu() - ref.pos).abs().max())
        it, itp = (first[1].solver_iterations.cpu(),
                   ref_aux.solver_iterations)
        require(err <= 1e-5, f"path AM level {level}: off the CPU guarded "
                f"frame by {err}")
        require(int((it - itp).abs().max()) <= n,
                f"path AM level {level}: iterations {it.tolist()} vs "
                f"{itp.tolist()}")
        zero_counts()
        t0 = time.perf_counter()
        frames_go(frame, state, obs, FRAMES_PROFILED)()
        torch.cuda.synchronize()
        steps = FRAMES_PROFILED * cfg.sim_count / (time.perf_counter() - t0)
        ms, busy = counted_window(
            torch, f"path AM level {level} (K2 + K5 at dt/{n}, "
            f"{cfg.sim_count * n} substeps a launch)",
            frames_go(frame, state, obs, FRAMES_PROFILED), FRAMES_PROFILED,
            {k5_kernel_name(): FRAMES_PROFILED,
             SOURCE_KERNELS["blocked_prep"][0]: FRAMES_PROFILED})
        log(f"[path AM] level {level} (n {n}): {FRAMES_AM} frames, K2 and K5 "
            f"once a frame, {cfg.sim_count * n} substeps a K5 launch by its "
            f"barriers {barriers}; first frame vs the CPU guarded frame: "
            f"max |dpos| {err:.3e}, iterations {it.tolist()} (CPU "
            f"{itp.tolist()}); {ms:.4f} device ms a frame, {busy:.1f}% busy, "
            f"against path A's {a_ms:.4f}, {a_busy:.1f}%; {steps:.1f} outer "
            f"steps/s; card {card}")
        line["AM"]["levels"][level] = dict(
            device_ms_per_frame=ms, busy_percent=busy,
            path_a_device_ms_per_frame=a_ms, path_a_busy_percent=a_busy,
            steps_per_s=steps, first_frame_err=err, barriers=barriers)

    # -- 61. path AN: the stiff reproducer -------------------------------------
    pcfg = parse_config(STIFF_AN)
    v, f, t = pmesh.construct_2d_mesh(pcfg.objects[0])
    obj_n, st_n = build_object(pcfg.objects[0], v, f, t, device=dev)
    noise = np.random.default_rng(0).normal(scale=1e-4,
                                            size=tuple(st_n.vel.shape))
    st_n = st_n.replace(vel=st_n.vel + torch.as_tensor(
        noise.astype(np.float32), device=dev))
    obs_n = Obstacles.from_configs(pcfg.blocks, 2, device=dev)
    kappa_n = float(adaptive.kappa_estimate(obj_n, st_n.pos,
                                            pcfg.delta_time))
    runs = {}
    for label, guard in (("unguarded", False), ("guarded", True)):
        frame = sim.make_frame_fn(obj_n, dataclasses.replace(
            pcfg, adaptive_dt=guard))
        zero_counts()
        s, starts = st_n, []
        for i in range(FRAMES_AN):
            starts.append(s)
            s, aux = frame(s, obs_n)
        starts.append(s)
        torch.cuda.synchronize()
        launches = counts()
        finite = [bool(torch.isfinite(x.pos).all()) for x in starts[1:]]
        # Each frame's level, from its start state, outside the count.
        levels = [int(adaptive.split_level(adaptive.kappa_estimate(
            obj_n, x.pos, pcfg.delta_time), pcfg.adaptive_dt_threshold))
            for x in starts[:-1]] if guard else []
        runs[label] = (launches, finite, levels, starts[1])
        log(f"[path AN] {label}: {FRAMES_AN} frames at dt "
            f"{pcfg.delta_time} (kappa {kappa_n:.3e}); finite by frame "
            f"{finite}; levels {levels}; launches {runs[label][0]}")
    launches_u, finite_u, _, _ = runs["unguarded"]
    launches_g, finite_g, levels_g, first_g = runs["guarded"]
    require(not all(finite_u), "path AN: the unguarded run stayed finite")
    require(all(finite_g), "path AN: the guarded run went non-finite")
    require(launches_u == only(blocked_frame=FRAMES_AN),
            f"path AN unguarded launches {launches_u}")
    require(launches_g == only(blocked_prep=FRAMES_AN,
                               blocked_frame=FRAMES_AN),
            f"path AN guarded launches {launches_g}")
    require(levels_g[0] > 0, f"path AN: the guard did not split {levels_g}")
    cobj_n, cst_n, cobs_n = on_cpu(obj_n, st_n, obs_n)
    ref, _ = sim.make_frame_fn(cobj_n, dataclasses.replace(
        pcfg, adaptive_dt=True, frame_backend="blocked"))(cst_n, cobs_n)
    err = float((first_g.pos.cpu() - ref.pos).abs().max())
    log(f"[path AN] the first guarded frame vs the CPU guarded frame: max "
        f"|dpos| {err:.3e}")
    require(err <= 1e-5, f"path AN: first guarded frame off by {err}")
    line["AN"] = dict(kappa=kappa_n, unguarded_finite=finite_u,
                      guarded_levels=levels_g, first_frame_err=err)
    return line, time.perf_counter() - t_phase


# -- Contact: C1, C2 and paths AO-AS (sections 62-66) --------------------------

FRAMES_AO = 100  # path AO: demo_two_bodies_contact.json as shipped
FRAMES_GRID = 5  # the grid's paths (AO grid, AR grid), each
FRAMES_AP = 30  # path AP: two flagship bodies stacked
FRAMES_AS = 3  # path AS: the batched frame
BATCH_AS = 8
SHELLS_AR = (8192, 24576)  # tools/probe_broadphase.py's sizes
CAP_AR = 8
CONTACT_REPS = 20  # timed launches a kernel
# The profiler's names of C1's two variants (csrc/contact_pairs.cu); the
# rows variant's is a suffix of the cluster variant's.
C1_KERNELS = {"cluster": "cluster_contact_pairs_kernel",
              "rows": "contact_pairs_kernel"}
# The profiler's names of C2's kernels by variant (csrc/contact_grid.cu):
# the warp variant's soup gather and warp kernel, the thread variant's one.
C2_KERNELS = {"warp": ["grid_soup_kernel", "grid_warp_kernel"],
              "thread": ["contact_grid_kernel"]}
# f32 operations a pair, counted from the kernels' formulas: C1's matmul
# form (both squared norms, the cross term, the distance, the penalty and
# the row sums), C2's direct differences (the rest test, the distance, the
# penalty and the sum); each pair's force is due once.  C1_OPS charges
# every pair the whole chain (kept beside the least work as
# bound_ms_whole_chain); the least work charges every pair
# its squared distance (the cross term and its three-term sum and floor,
# C1_D2_OPS; each vertex's squared norm once, C1_NORM_OPS) and only the
# pairs within the radius the root, the penalty and the row sums
# (C1_CHAIN_OPS).
C1_OPS = {3: 27, 2: 21}
C1_D2_OPS = {3: 9, 2: 7}
C1_NORM_OPS = {3: 5, 2: 3}
C1_CHAIN_OPS = {3: 13, 2: 11}
C2_OPS = {3: 30, 2: 22}
# tools/self_contact_scale.py's blob at its defaults: the spot mesh at
# interior_spacing 0.04 (12,037 particles, 68,508 tets, 2,780 surface
# vertices), E 1e4, dt 2.5e-4, slammed down at 1.5 and warmed through the
# slam (0.35 virtual s).
BLOB_AQ = dict(
    dim=3, delta_time=2.5e-4, sim_count=10, auto_diff=False,
    use_explicit_method=True, g_dir=[0.0, -1.0, 0.0], contact="penalty",
    self_contact=True, contact_broadphase="dense", contact_stiffness=0.0,
    objects=[dict(id=0, center=[2.0, 0.75, 2.0], rho=1000.0, E=1e4, nu=0.35,
                  damping=6.0, obj="assets/spot.obj")],
    blocks=[])
SPACING_AQ = 0.04
IMPACT_AQ = -1.5
WARM_AQ = 0.35
SAMPLE_AQ = 5  # path AQ: frames between samples of the active self-pairs
SQUASH_AQ = 0.15  # path AQ: C1's check state, the warmed blob's height x this
MU_CHECK = 0.3  # the Coulomb form's check (contact_mu of tests/test_contact)


def sphere_shell(np, n, center, r, seed):
    """tools/probe_broadphase.py's shell: n points on a sphere (numpy
    seed)."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return (center + r * v).astype(np.float32)


def active_pairs(torch, tables, pos, radius):
    """Admitted pairs of the soup ``pos`` nearer than ``radius``: of
    different bodies, or of one body where its mask admits them."""
    body = tables.body_id
    admit = body[:, None] != body[None, :]
    first = 0
    for n, mask in zip(tables.sizes, tables.masks):
        if mask is not None:
            admit[first:first + n, first:first + n] = mask != 0
        first += n
    return int(((torch.cdist(pos, pos) < radius) & admit).sum()) // 2


def check_c1(torch, label, tables, pos, vel, radius, stiffness, friction_c,
             mu, mu_slope):
    """C1 against its plain version on the card at these inputs, twice
    bit-identical.  The matmul form's x·S − T and its three-term distance
    cancel, so the kernel and the plain version are each held to the plain
    version in float64: the kernel's error there within twice the plain
    version's own plus 1e-5 of the largest force.  The Coulomb form (direct
    differences) within 1e-5 of the largest force of the f32 plain version.
    Returns (max abs error against the f32 plain version, active pairs)."""
    from fem_tpu_torch.ops import contact_kernels as ck

    args = (radius, stiffness, friction_c, mu, mu_slope)
    n = pos.shape[0]

    def counts():
        return torch.full((n,), -1, dtype=torch.int32, device=pos.device)

    acc, acc_again, acc_rows = counts(), counts(), counts()
    got = ck.pair_forces(tables, pos, vel, *args, accepted=acc)
    plan = ck.pair_forces.last_plan
    again = ck.pair_forces(tables, pos, vel, *args, accepted=acc_again)
    rows = ck.pair_forces(tables, pos, vel, *args, variant="rows",
                          accepted=acc_rows)
    ref = ck.pair_forces_plain(tables, pos, vel, *args)
    ref64 = ck.pair_forces_plain(tables, pos.double(), vel.double(), *args)
    torch.cuda.synchronize()
    top = float(ref.abs().max())
    err = float((got - ref).abs().max())
    err64 = float((got.double() - ref64).abs().max())
    rows64 = float((rows.double() - ref64).abs().max())
    plain64 = float((ref.double() - ref64).abs().max())
    active = active_pairs(torch, tables, pos, radius)
    taken = int(acc.sum())
    log(f"[C1] {label}: {n} soup vertices, {active} active pairs; mu {mu}: "
        f"max abs error {err:.3e} of max {top:.3e}; against the f64 plain "
        f"version: kernel {err64:.3e} (rows variant {rows64:.3e}), plain "
        f"{plain64:.3e}; plan {plan._asdict()}; accepted (ordered) pairs "
        f"{taken} (rows variant {int(acc_rows.sum())}, read from the "
        f"kernels)")
    require(plan.variant == "cluster", f"C1 {label}: plan {plan}")
    require(active > 0 and top > 0, f"C1 {label}: no pair in contact")
    require(bool(torch.isfinite(got).all()), f"C1 {label}: non-finite")
    if mu > 0.0:
        require(err <= 1e-5 * top, f"C1 {label}: error {err} of {top}")
    else:
        require(err64 <= 2 * plain64 + 1e-5 * top,
                f"C1 {label}: f64 error {err64} against the plain version's "
                f"{plain64}")
    require(torch.equal(got, again) and torch.equal(acc, acc_again),
            f"C1 {label}: runs differ")
    require(taken > 0 and torch.equal(acc, acc_rows),
            f"C1 {label}: the variants accepted other pairs ({taken} and "
            f"{int(acc_rows.sum())})")
    if plan.cluster == 1:
        require(torch.equal(got, rows), f"C1 {label}: a cluster of one "
                "differs from the rows variant")
    return err, active


def grid_inputs(torch, pos, radius):
    """(cell_s, order, runs, start, m, offs) of the grid pass at ``pos``
    (broadphase.grid_contact_forces' sort and run table), with the JAX
    package's forward starts from a lookup of their own."""
    from fem_tpu_torch import broadphase as bp
    from fem_tpu_torch.ops import contact_kernels as ck

    cell, m = bp.grid_cells(pos, radius)
    order = torch.argsort(cell, stable=True)
    cell_s = cell[order]
    offs = torch.tensor(ck.forward_offsets_host(m, pos.shape[1]),
                        dtype=torch.int32, device=pos.device)
    start = torch.searchsorted(cell_s, cell_s[:, None] + offs[None, :],
                               out_int32=True)
    runs = ck.grid_runs(cell_s, m, pos.shape[1])
    return cell_s, order, runs, start, m, offs


def grid_found(torch, cell_s, start, offs, cap):
    """Pairs the forward stencil finds (fem_tpu/broadphase.py:171-181's
    valid candidates)."""
    n = cell_s.shape[0]
    slot = torch.arange(cap, device=cell_s.device)
    own = torch.arange(n, device=cell_s.device)[:, None] + 1 + slot
    idx = torch.cat([own[:, None, :], start.long()[:, :, None] + slot],
                    dim=1)
    tgt = torch.cat([cell_s[:, None], cell_s[:, None] + offs[None, :]],
                    dim=1)
    valid = (idx < n) & (cell_s[idx.clamp(max=n - 1)] == tgt[:, :, None])
    return int(valid.sum())


def check_c2(torch, label, pos, vel, rest, body, radius, stiffness, cap,
             friction_c=0.0, mu=0.0, mu_slope=0.0, self_contact=False):
    """C2 against its plain version on the card (the same sort and lookup),
    within 1e-5 of the largest force, twice bit-identical, the forces' total
    within 1e-5 of Σ|f| (Newton's third law); its warp variant (the plan's)
    bit-identical to the thread variant.  Returns (max abs error, the
    forces, pairs found)."""
    from fem_tpu_torch.ops import contact_kernels as ck

    cell_s, order, runs, start, m, offs = grid_inputs(torch, pos, radius)
    args = (pos, vel, rest if self_contact else None, body, cell_s, order)
    kw = dict(friction_c=friction_c, mu=mu, mu_slope=mu_slope,
              self_contact=self_contact)
    got = ck.grid_pair_forces(*args, runs, m, radius, stiffness, cap, **kw)
    plan = ck.grid_pair_forces.last_plan
    again = ck.grid_pair_forces(*args, runs, m, radius, stiffness, cap, **kw)
    thread = ck.grid_pair_forces(*args, runs, m, radius, stiffness, cap,
                                 variant="thread", **kw)
    ref = ck.grid_pair_forces_plain(*args, start, offs, radius, stiffness,
                                    cap, excl=2.5 * radius, **kw)
    torch.cuda.synchronize()
    top = float(ref.abs().max())
    err = float((got - ref).abs().max())
    total = float(got.sum(dim=0).abs().max())
    spread = float(got.abs().sum())
    found = grid_found(torch, cell_s, start, offs, cap)
    log(f"[C2] {label}: {pos.shape[0]} vertices, cap {cap}, {found} pairs "
        f"found: max abs error {err:.3e} of max {top:.3e}; |sum f| "
        f"{total:.3e}; plan {plan._asdict()}; the warp variant "
        f"bit-identical to the thread variant: {torch.equal(got, thread)}")
    require(plan.variant == "warp", f"C2 {label}: plan {plan}")
    require(top > 0, f"C2 {label}: no pair in contact")
    require(err <= 1e-5 * top, f"C2 {label}: error {err} of {top}")
    require(total <= 1e-5 * spread, f"C2 {label}: momentum {total} of sum "
            f"|f| {spread}")
    require(torch.equal(got, again), f"C2 {label}: runs differ")
    require(torch.equal(got, thread), f"C2 {label}: the warp variant "
            "differs from the thread variant")
    return err, got, found


def c1_ms(torch, fn, variant, windows=3):
    """Device ms a launch of C1's ``variant`` over CONTACT_REPS calls of
    ``fn`` (the profiler, as kernel_ms; the rows variant's name is told
    from the cluster variant's, of which it is a suffix)."""
    cluster = C1_KERNELS["cluster"]
    for _ in range(windows):
        per_kernel, _ = profile_kernels(torch, fn, CONTACT_REPS)
        hits = [v for k, v in per_kernel.items()
                if C1_KERNELS[variant] in k
                and (cluster in k) == (variant == "cluster")]
        launches = sum(c for _, c in hits)
        if 0 < launches <= CONTACT_REPS:
            break
    require(0 < launches <= CONTACT_REPS, f"the profiler saw {launches} "
            f"launches of C1's {variant} variant in {CONTACT_REPS} calls")
    return sum(t for t, _ in hits) / launches


def c1_row(torch, card, d, tables, pos, vel, radius, stiffness, launches,
           err, label, extra=None):
    """C1's kernels-line row at these inputs (the matmul form, no
    friction: the configs' own): the cluster variant's time beside the rows
    variant's, from one run; its bound from the least work these inputs
    need (every pair's squared distance, the rest of the chain for the
    pairs the kernel accepted), and beside it the bound that charges every
    pair the whole chain."""
    from fem_tpu_torch.ops import contact_kernels as ck

    ms = c1_ms(torch, lambda: ck.pair_forces(
        tables, pos, vel, radius, stiffness), "cluster")
    plan = ck.pair_forces.last_plan
    rows_ms = c1_ms(torch, lambda: ck.pair_forces(
        tables, pos, vel, radius, stiffness, variant="rows"), "rows")
    plain_ms = cuda_ms(torch, lambda: ck.pair_forces_plain(
        tables, pos, vel, radius, stiffness), 5)
    acc = torch.zeros(pos.shape[0], dtype=torch.int32, device=pos.device)
    ck.pair_forces(tables, pos, vel, radius, stiffness, accepted=acc)
    accepted = int(acc.sum()) // 2  # each pair counted by both its rows
    sizes = tables.sizes
    pairs = sum(a * b for i, a in enumerate(sizes) for b in sizes[i + 1:])
    pairs += sum(int(m.sum()) // 2 for m in tables.masks if m is not None)
    masks = [m for m in tables.masks if m is not None]
    bits = [] if tables.mask_bits is None else [tables.mask_bits]
    bnd, by = bound(nbytes(pos, tables.body_id, tables.body_table,
                           tables.bit_offsets, *bits) + nbytes(pos),
                    pairs * C1_D2_OPS[d] + pos.shape[0] * C1_NORM_OPS[d]
                    + accepted * C1_CHAIN_OPS[d])
    bnd_pr20, by_pr20 = bound(nbytes(pos, tables.body_id, tables.body_table,
                                     *masks) + nbytes(pos),
                              pairs * C1_OPS[d])
    cdist_ms = library_device_ms(torch, lambda: torch.cdist(pos, pos), 20)
    row = dict(name="contact_pairs", route="cuda",
               source="fem_tpu_torch/csrc/contact_pairs.cu",
               replaces="fem_tpu/contact.py:92 (XLA, no pallas_call)", dim=d,
               launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=bnd, bound_by=by, library_ms=None,
               variant=plan.variant, cluster=plan.cluster, ctas=plan.ctas,
               rows_ms=rows_ms, accepted_pairs=accepted,
               bound_ms_whole_chain=bnd_pr20, bound_by_whole_chain=by_pr20,
               cdist_yardstick_ms=cdist_ms, shapes=label, pairs=pairs,
               **(extra or {}))
    log(f"[time] {d}D contact_pairs ({label}): cluster variant, P "
        f"{plan.cluster} ({plan.ctas} CTAs): {ms:.5f} ms a launch on the "
        f"device (profiler); rows variant {rows_ms:.5f} ms; plain "
        f"{plain_ms:.4f} ms; bound {bnd:.6f} ms ({by}, {pairs} pairs, "
        f"{accepted} accepted), whole chain a pair {bnd_pr20:.6f} ms "
        f"({by_pr20}); torch.cdist yardstick {cdist_ms:.5f} ms; launches "
        f"{launches}; card {card}")
    return row


def c2_row(torch, card, d, pos, body, radius, stiffness, cap, launches, err,
           found, label, extra=None):
    """C2's kernels-line row at these inputs (no friction, no
    self-contact): the warp variant's time (its soup gather and its warp
    kernel) beside the thread variant's, from one run, and the whole grid
    pass's device time (the cell ids, the sort, the run table and C2)."""
    from fem_tpu_torch import broadphase as bp
    from fem_tpu_torch.ops import contact_kernels as ck

    cell_s, order, runs, start, m, offs = grid_inputs(torch, pos, radius)
    args = (pos, None, None, body, cell_s, order)

    def warp():
        return ck.grid_pair_forces(*args, runs, m, radius, stiffness, cap)

    soup_ms = kernel_ms(torch, warp, CONTACT_REPS, C2_KERNELS["warp"][:1])
    warp_ms = kernel_ms(torch, warp, CONTACT_REPS, C2_KERNELS["warp"][1:])
    plan = ck.grid_pair_forces.last_plan
    ms = soup_ms + warp_ms
    thread_ms = kernel_ms(torch, lambda: ck.grid_pair_forces(
        *args, runs, m, radius, stiffness, cap, variant="thread"),
        CONTACT_REPS, C2_KERNELS["thread"])
    plain_ms = cuda_ms(torch, lambda: ck.grid_pair_forces_plain(
        *args, start, offs, radius, stiffness, cap), 5)
    pass_ms = library_device_ms(torch, lambda: bp.grid_contact_forces(
        pos, body, None, radius, stiffness, cap=cap), CONTACT_REPS)
    bnd, by = bound(nbytes(pos, body, cell_s, order, start) + nbytes(pos),
                    found * C2_OPS[d])
    row = dict(name="contact_grid", route="cuda",
               source="fem_tpu_torch/csrc/contact_grid.cu",
               replaces="fem_tpu/broadphase.py:82 (XLA, no pallas_call)",
               dim=d, launches=launches, max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=bnd, bound_by=by, library_ms=None,
               variant=plan.variant, ctas=plan.ctas, soup_ms=soup_ms,
               warp_kernel_ms=warp_ms, thread_ms=thread_ms, pass_ms=pass_ms,
               shapes=label, pairs_found=found, **(extra or {}))
    log(f"[time] {d}D contact_grid ({label}): warp variant {ms:.5f} ms a "
        f"call on the device (profiler; soup gather {soup_ms:.5f}, warp "
        f"kernel {warp_ms:.5f}, {plan.ctas} CTAs); thread variant "
        f"{thread_ms:.5f} ms; the whole grid pass (cell ids, sort, run "
        f"table, C2) {pass_ms:.5f} ms; plain {plain_ms:.4f} ms; bound "
        f"{bnd:.6f} ms ({by}, {found} pairs found); launches {launches}; "
        f"card {card}")
    return row


def soup_of(torch, plan, states):
    """(positions, velocities) of the plan's vertex soup."""
    return (torch.cat([s.pos.index_select(0, sv)
                       for s, sv in zip(states, plan.surf)]),
            torch.cat([s.vel.index_select(0, sv)
                       for s, sv in zip(states, plan.surf)]))


def window_ms(torch, go, frames):
    """(device ms a frame, busy share) of ``frames`` frames of ``go`` under
    the profiler."""
    per_kernel, wall_ms = profile_kernels(torch, go, 1)
    dev_ms = sum(t for t, _ in per_kernel.values())
    return dev_ms / frames, 100 * dev_ms / wall_ms


def run_contact(torch, dev, zero_counts, counts, only, card):
    """Sections 62-66: C1 and C2 against their plain versions and paths
    AO-AS.  Returns (the kernels line's C1 and C2 rows, the
    ``contact_paths`` line's dict, phase seconds)."""
    import shutil

    import numpy as np

    import fem_tpu_torch
    from fem_tpu_torch import batch, contact, entry, sim
    from fem_tpu_torch import broadphase as bp
    from fem_tpu_torch.models import mesh as pmesh
    from fem_tpu_torch.models.state import Obstacles, build_object
    from fem_tpu_torch.ops import blocked_kernels, element_kernels
    from fem_tpu_torch.ops import contact_kernels as ck
    from fem_tpu_torch.utils.config import ObjectConfig, parse_config

    t_phase = time.perf_counter()
    out_dir = os.path.join(REPO, "build", "chip_smoke_contact")
    shutil.rmtree(out_dir, ignore_errors=True)
    ao_path = os.path.join(REPO, "configs", "demo_two_bodies_contact.json")
    rows, line = [], {}
    cwd = os.getcwd()
    os.chdir(REPO)  # the configs name their meshes relative to the repo
    try:
        # -- 62. path AO: demo_two_bodies_contact.json as shipped -------------
        with open(ao_path) as f:
            ao = json.load(f)
        subs = FRAMES_AO * ao["sim_count"]
        zero_counts()
        t0 = time.perf_counter()
        rc, printed = cli_run(["--config", ao_path, "--frames",
                               str(FRAMES_AO), "--no-render",
                               "--checkpoint-every", str(FRAMES_AO),
                               "--print-every", str(FRAMES_AO // 2),
                               "--output", os.path.join(out_dir, "ao")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts()
        for text in printed:
            log(f"[path AO] CLI: {text}")
        require(rc == 0, f"path AO: the CLI's exit code {rc}")
        require(launches == only(contact_pairs=subs,
                                 blocked_assemble=2 * subs),
                f"path AO: the CLI's launches {launches}")
        times = [float(t.split("t=")[1].split("s")[0]) for t in printed
                 if " t=" in t]
        require(times == [round(2 * n * ao["sim_count"] * ao["delta_time"],
                                3) for n in (FRAMES_AO // 2, FRAMES_AO)],
                f"path AO: the CLI's pacing {times} (N× per body)")
        cli_steps = float(printed[-1].split(" steps/s")[0].split()[-1])
        api = fem_tpu_torch.Simulation.from_config(ao_path, device=dev)
        plan = api._contact_frame.plan
        radius, stiffness, friction_c, mu_slope = api._contact_frame.constants
        zero_counts()
        t0 = time.perf_counter()
        min_dist = np.inf
        for i in range(FRAMES_AO):
            api.step_frame()
            if (i + 1) % 10 == 0:
                min_dist = min(min_dist, float(torch.cdist(
                    api.scene[0].state.pos, api.scene[1].state.pos).min()))
        torch.cuda.synchronize()
        api_wall = time.perf_counter() - t0
        launches = counts()
        require(launches == only(contact_pairs=subs,
                                 blocked_assemble=2 * subs),
                f"path AO: Simulation's launches {launches}")
        require(abs(api.virtual_time - FRAMES_AO * ao["sim_count"]
                    * ao["delta_time"]) < 1e-9,
                f"path AO: Simulation's clock {api.virtual_time}")
        end = np.load(os.path.join(out_dir, "ao",
                                   f"ckpt_{FRAMES_AO:06}.npz"))
        cli_api = max(float(np.abs(end[f"b{b}_pos"]
                                   - api.positions(b)).max())
                      for b in range(2))
        require(cli_api <= 1e-5, f"path AO: the CLI's and Simulation's end "
                f"states differ by {cli_api}")
        require(all(np.isfinite(api.positions(b)).all() for b in range(2)),
                "path AO: non-finite positions")
        log(f"[path AO] configs/demo_two_bodies_contact.json: {FRAMES_AO} "
            f"frames through the CLI ({cli_steps:.1f} steps/s as it "
            f"printed, {wall:.2f} s) and Simulation ({subs / api_wall:.1f} "
            f"steps/s), C1 once a substep and K7a once a body a substep; "
            f"the CLI's clock {times[-1]} (N× per body), Simulation's "
            f"{api.virtual_time:.4f}; end states within {cli_api:.3e}; radius "
            f"{radius:.6f}, stiffness {stiffness:.3f}; smallest distance "
            f"between the bodies {min_dist:.5f} (every 10th frame)")
        require(min_dist > 0.5 * radius,
                f"path AO: the bodies came within {min_dist}")
        one = fem_tpu_torch.Simulation.from_config(ao_path, device=dev)
        cpu = fem_tpu_torch.Simulation.from_config(ao_path, device="cpu")
        one.step_frame()
        cpu.step_frame()
        err_ao = max(float(np.abs(one.positions(b) - cpu.positions(b)).max())
                     for b in range(2))
        log(f"[path AO] first frame vs the CPU: max |dpos| {err_ao:.3e}")
        require(err_ao <= 1e-5, f"path AO: first frame off by {err_ao}")
        dev_ms, busy = window_ms(torch, lambda: api.run(frames=10), 10)
        log(f"[profile] path AO: {dev_ms:.4f} device ms a frame, busy "
            f"{busy:.1f}% (Simulation, 10 frames)")
        # C1 at the path's shapes on a state in contact: the shipped bodies
        # stay apart (above), so body 0 is moved, rigidly, onto body 1's
        # top, its lowest row half a radius into body 1's highest.
        s0, s1 = (s.state for s in api.scene)
        lo0 = s0.pos.min(dim=0).values
        shift = torch.stack([s1.pos[:, 0].min() + 0.02 - lo0[0],
                             s1.pos[:, 1].max() - 0.5 * radius - lo0[1]])
        laid = (s0.replace(pos=s0.pos + shift), s1)
        pos, vel = soup_of(torch, plan, laid)
        err_c1_2d, active = check_c1(torch, "2D AO shapes, body 0 laid on "
                                     "body 1", plan.tables, pos, vel, radius,
                                     stiffness, 0.0, 0.0, mu_slope)
        err_mu, _ = check_c1(torch, "2D AO shapes, Coulomb", plan.tables,
                             pos, vel, radius, stiffness, 1.0, MU_CHECK,
                             mu_slope)
        f_ao = ck.pair_forces(plan.tables, pos, vel, radius, stiffness)
        momentum = float(f_ao.sum(dim=0).abs().max())
        scale = float(f_ao.abs().sum())
        require(momentum < 1e-5 * scale,
                f"path AO: contact momentum {momentum} of {scale}")
        log(f"[path AO] contact forces' total {momentum:.3e} of sum |f| "
            f"{scale:.3e} (tests/test_contact.py's 1e-5)")
        rows.append(c1_row(torch, card, 2, plan.tables, pos, vel, radius,
                           stiffness, subs, max(err_c1_2d, err_mu),
                           f"AO soup {plan.sizes}, {active} active pairs",
                           dict(path_device_ms_per_frame=dev_ms,
                                path_busy_pct=busy)))
        # The grid on the same bodies: C2 once a substep.
        grid_cfg = dict(ao, contact_broadphase="grid")
        gsim = fem_tpu_torch.Simulation.from_dict(grid_cfg, device=dev)
        require(gsim._contact_frame.plan.mode == "grid", "AO grid: plan")
        for s, st in zip(gsim.scene, laid):
            s.state = st
        zero_counts()
        gsim.run(frames=FRAMES_GRID)
        torch.cuda.synchronize()
        launches = counts()
        gsubs = FRAMES_GRID * ao["sim_count"]
        require(launches == only(contact_grid=gsubs,
                                 blocked_assemble=2 * gsubs),
                f"path AO grid: launches {launches}")
        body = gsim._contact_frame.plan.body_id
        err_c2_2d, _, found = check_c2(torch, "2D AO shapes", pos, vel, pos,
                                       body, radius, stiffness, 8)
        check_c2(torch, "2D AO shapes, self-contact and Coulomb", pos, vel,
                 gsim._contact_frame.plan.rest_cat, body, radius, stiffness,
                 8, 0.5, MU_CHECK, mu_slope, True)
        rows.append(c2_row(torch, card, 2, pos, body, radius, stiffness, 8,
                           gsubs, err_c2_2d, found,
                           f"AO soup {plan.sizes}"))
        log(f"[path AO grid] {FRAMES_GRID} frames with contact_broadphase "
            f"'grid' from body 0 laid on body 1: C2 once a substep; "
            f"finite {all(np.isfinite(gsim.positions(b)).all() for b in range(2))}")
        line["AO"] = dict(cli_steps_per_s=cli_steps, api_steps_per_s=subs /
                          api_wall, device_ms_per_frame=dev_ms,
                          busy_pct=busy, first_frame_err=err_ao,
                          min_distance=min_dist, radius=radius)

        # -- 63. path AP: two flagship bodies stacked -------------------------
        with open(os.path.join(REPO, "configs", "demo_spot.json")) as f:
            spot = json.load(f)
        _, fobj, _, _ = entry.flagship("cpu")
        rest = fobj.rest_pos.numpy()
        surf = rest[np.unique(fobj.faces.numpy().reshape(-1))]
        r_ap = contact.auto_contact_radius([fobj])
        # The upper body's lift: its lowest surface vertex within half the
        # radius of the lower body's surface.
        lift = float(rest[:, 1].max() - rest[:, 1].min()) + r_ap
        while True:
            moved = surf + np.asarray([0.0, lift, 0.0], np.float32)
            gap = float(np.sqrt(((surf[:, None] - moved[None]) ** 2).sum(-1))
                        .min())
            if gap <= 0.5 * r_ap:
                break
            lift -= 0.0025
        ap = dict(spot, contact="penalty", objects=[
            dict(spot["objects"][0], id=0),
            dict(spot["objects"][0], id=1,
                 center=[2.0, spot["objects"][0]["center"][1] + lift, 2.0])])
        psim = fem_tpu_torch.Simulation.from_dict(ap, device=dev)
        pplan = psim._contact_frame.plan
        require(pplan.sizes == (642, 642) and pplan.mode == "dense",
                f"path AP: plan {pplan.mode} {pplan.sizes}")
        csim = fem_tpu_torch.Simulation.from_dict(ap, device="cpu")
        states0 = tuple(s.state for s in psim.scene)
        first, faux = psim._contact_frame(states0, psim.obstacles)
        cfirst, caux = csim._contact_frame(
            tuple(s.state for s in csim.scene), csim.obstacles)
        err_ap = max(float((a.pos.cpu() - b.pos).abs().max())
                     for a, b in zip(first, cfirst))
        its = [a.solver_iterations.tolist() for a in faux]
        cits = [a.solver_iterations.tolist() for a in caux]
        log(f"[path AP] lift {lift:.4f} (gap {gap:.5f}, radius {r_ap:.5f}); "
            f"first frame vs the CPU: max |dpos| {err_ap:.3e}; iterations "
            f"{its}, CPU {cits}")
        require(err_ap <= 1e-5, f"path AP: first frame off by {err_ap}")
        require(its == cits, "path AP: iterations differ from the CPU's")
        rad_p, k_p, _, slope_p = psim._contact_frame.constants
        pos_p, vel_p = soup_of(torch, pplan, states0)
        err_ap_c1, active_p = check_c1(torch, "3D two flagships",
                                       pplan.tables, pos_p, vel_p, rad_p,
                                       k_p, 0.0, 0.0, slope_p)
        zero_counts()
        t0 = time.perf_counter()
        psim.run(frames=FRAMES_AP)
        torch.cuda.synchronize()
        ap_wall = time.perf_counter() - t0
        launches = counts()
        psubs = FRAMES_AP * ap["sim_count"]
        require(launches == only(contact_pairs=psubs,
                                 element_chain=2 * psubs,
                                 fused_cg=2 * psubs),
                f"path AP: launches {launches}")
        require(all(np.isfinite(psim.positions(b)).all() for b in range(2)),
                "path AP: non-finite positions")
        ap_ms, ap_busy = window_ms(torch, lambda: psim.run(frames=3), 3)
        log(f"[path AP] {FRAMES_AP} frames, C1 once a substep and K1 + K4 "
            f"once a body a substep: {psubs / ap_wall:.1f} steps/s; "
            f"{ap_ms:.4f} device ms a frame, busy {ap_busy:.1f}%")
        rows.append(c1_row(torch, card, 3, pplan.tables, pos_p, vel_p, rad_p,
                           k_p, psubs, err_ap_c1,
                           f"AP soup {pplan.sizes}, {active_p} active pairs",
                           dict(path_device_ms_per_frame=ap_ms,
                                path_busy_pct=ap_busy)))
        line["AP"] = dict(steps_per_s=psubs / ap_wall,
                          device_ms_per_frame=ap_ms, busy_pct=ap_busy,
                          first_frame_err=err_ap, active_pairs=active_p)

        # -- 64. path AQ: the self-contact blob --------------------------------
        blob = json.loads(json.dumps(BLOB_AQ))
        blob["objects"][0]["obj"] = os.path.join(REPO, "assets", "spot.obj")
        t0 = time.perf_counter()
        bsim = fem_tpu_torch.Simulation.from_dict(
            blob, interior_spacing=SPACING_AQ, device=dev)
        bobj = bsim.scene[0].obj
        bplan = bsim._contact_frame.plan
        log(f"[path AQ] blob built in {time.perf_counter() - t0:.1f} s: "
            f"{bobj.particle_cnt} particles, {bobj.element_cnt} tets, "
            f"{bplan.sizes[0]} surface vertices ({bplan.mode})")
        st = bsim.scene[0].state
        vel0 = torch.zeros_like(st.vel)
        vel0[:, 1] = IMPACT_AQ
        bsim.scene[0].state = st.replace(vel=vel0)
        warm = int(WARM_AQ / (blob["sim_count"] * blob["delta_time"]))
        rad_b, k_b, fc_b, slope_b = bsim._contact_frame.constants
        # The active self-pairs, sampled every SAMPLE_AQ frames through the
        # slam.
        series = []
        zero_counts()
        t0 = time.perf_counter()
        for i in range(warm):
            bsim.step_frame()
            if (i + 1) % SAMPLE_AQ == 0:
                series.append(active_pairs(torch, bplan.tables, soup_of(
                    torch, bplan, [bsim.scene[0].state])[0], rad_b))
        torch.cuda.synchronize()
        aq_wall = time.perf_counter() - t0
        # The blob's 270 blocks take K7b's grid variant (past 32 blocks),
        # which counts() refuses on a path: the counts are read from the
        # wrappers here.
        c1_n = ck.pair_forces.launches
        grads = {fn.__name__: fn.launches for fn in (
            blocked_kernels.blocked_grad_prep,
            blocked_kernels.blocked_assemble,
            element_kernels.explicit_grad_columns)}
        zero_counts()
        bsubs = warm * blob["sim_count"]
        require(c1_n == bsubs and sum(grads.values()) == bsubs,
                f"path AQ: C1 {c1_n}, gradient kernels {grads} launches in "
                f"{bsubs} substeps")
        bst = bsim.scene[0].state
        require(bool(torch.isfinite(bst.pos).all()),
                "path AQ: non-finite after the slam")
        height = float(bst.pos[:, 1].max() - bst.pos[:, 1].min())
        log(f"[path AQ] active masked self-pairs every {SAMPLE_AQ} frames "
            f"through the slam: {series}")
        # C1 is held to its plain version where self-pairs are active: the
        # warmed state squashed to 15 % of its height about its centroid,
        # as tests/test_contact.py folds its square.
        centroid = bst.pos.mean(dim=0, keepdim=True)
        squash = torch.tensor([[1.0, SQUASH_AQ, 1.0]], device=dev)
        pos_b, vel_b = soup_of(torch, bplan, [bst.replace(
            pos=centroid + (bst.pos - centroid) * squash)])
        err_b, active_b = check_c1(torch, "3D blob squashed, masked "
                                   "self-pairs",
                                   bplan.tables, pos_b, vel_b, rad_b, k_b,
                                   fc_b, 0.0, slope_b)
        err_b_mu, _ = check_c1(torch, "3D blob squashed, Coulomb",
                               bplan.tables,
                               pos_b, vel_b, rad_b, k_b, fc_b, MU_CHECK,
                               slope_b)
        overflow = bp.grid_overflow_count(
            soup_of(torch, bplan, [bst])[0].cpu().numpy(), rad_b, 8)
        m_b, _ = bp.grid_shape(rad_b, 3)
        log(f"[path AQ] {warm} frames ({bsubs} substeps) through the slam in "
            f"{aq_wall:.2f} s (with the samples), C1 once a substep, "
            f"gradient kernels {grads}; height at the end "
            f"{height:.4f}; squashed to {SQUASH_AQ}: {active_b} active masked "
            f"self-pairs; F8: the warmed blob's grid_overflow_count "
            f"{overflow} at cap 8 (grid {m_b}^3 over the unit domain, the "
            f"blob at x, z ~ 2)")
        kw_b = sim.substep_kwargs(bsim.cfg)
        forces_b = contact.contact_forces_all(
            [bst.pos], rad_b, k_b, [bst.vel], bplan, fc_b)

        def with_contact():
            s = bst
            for _ in range(blob["sim_count"]):
                f = contact.contact_forces_all([s.pos], rad_b, k_b, [s.vel],
                                               bplan, fc_b)
                s, _ = sim.substep(bobj, s, bsim.obstacles,
                                   external_force=f[0], **kw_b)

        def without():
            s = bst
            for _ in range(blob["sim_count"]):
                s, _ = sim.substep(bobj, s, bsim.obstacles, **kw_b)

        ms_with, busy_with = window_ms(torch, with_contact, blob["sim_count"])
        ms_without, busy_without = window_ms(torch, without,
                                             blob["sim_count"])
        zero_counts()
        log(f"[path AQ] device ms a substep: with contact {ms_with:.4f} "
            f"(busy {busy_with:.1f}%), without {ms_without:.4f} (busy "
            f"{busy_without:.1f}%); max |f| {float(forces_b[0].abs().max()):.3e}")
        rows.append(c1_row(torch, card, 3, bplan.tables, pos_b, vel_b, rad_b,
                           k_b, bsubs, max(err_b, err_b_mu),
                           f"AQ blob {bplan.sizes[0]} masked, {active_b} "
                           "active pairs",
                           dict(substep_device_ms_with_contact=ms_with,
                                substep_device_ms_without=ms_without)))
        line["AQ"] = dict(steps_per_s=bsubs / aq_wall, height=height,
                          active_pairs_squashed=active_b,
                          active_series=series,
                          grid_overflow_count=overflow,
                          substep_ms_with=ms_with,
                          substep_ms_without=ms_without)

        # -- 65. path AR: the interpenetrating shells --------------------------
        line["AR"] = {}
        for ns in SHELLS_AR:
            half = ns // 2
            spacing = float(np.sqrt(4 * np.pi * 0.2 ** 2 / half))
            a = sphere_shell(np, half, np.array([0.45, 0.5, 0.5]), 0.2, 0)
            b = sphere_shell(np, half, np.array(
                [0.45 + 2 * 0.2 - 2 * spacing, 0.5, 0.5]), 0.2, 1)
            pos_s = torch.as_tensor(np.concatenate([a, b]), device=dev)
            body_s = torch.as_tensor(np.concatenate(
                [np.zeros(half, np.int32), np.ones(half, np.int32)]),
                device=dev)
            tables = ck.pair_tables((half, half), [None, None], dev)
            zero_v = torch.zeros_like(pos_s)
            err1, active_s = check_c1(torch, f"shells ns={ns}", tables,
                                      pos_s, zero_v, spacing, 1e3, 0.0, 0.0,
                                      0.0)
            err2, f2, found = check_c2(torch, f"shells ns={ns}", pos_s,
                                       zero_v, pos_s, body_s, spacing, 1e3,
                                       CAP_AR)
            overflow = bp.grid_overflow_count(pos_s.cpu().numpy(), spacing,
                                              CAP_AR)
            f1 = ck.pair_forces(tables, pos_s, None, spacing, 1e3)
            f64 = ck.pair_forces_plain(tables, pos_s.double(), None, spacing,
                                       1e3)
            gap = float((f1 - f2).abs().max())
            top = float(f64.abs().max())
            e1 = float((f1.double() - f64).abs().max())
            e2 = float((f2.double() - f64).abs().max())
            log(f"[path AR] ns={ns}: radius {spacing:.5f}, grid overflow "
                f"{overflow}; |C1 − C2| {gap:.3e} of {top:.3e}; against the "
                f"f64 dense forces C1 {e1:.3e}, C2 {e2:.3e}")
            if overflow == 0:
                require(e2 <= 1e-5 * top and gap <= e1 + 1e-5 * top,
                        f"path AR ns={ns}: C1 and C2 disagree by {gap}")
            r1 = c1_row(torch, card, 3, tables, pos_s, zero_v, spacing, 1e3,
                        0, err1, f"AR shells ns={ns}, {active_s} active "
                        "pairs")
            r2 = c2_row(torch, card, 3, pos_s, body_s, spacing, 1e3, CAP_AR,
                        0, err2, found, f"AR shells ns={ns}")
            line["AR"][ns] = dict(
                c1={k: r1[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "cdist_yardstick_ms",
                                       "pairs", "max_abs_err", "cluster",
                                       "rows_ms", "accepted_pairs",
                                       "bound_ms_whole_chain")},
                c2={k: r2[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "pairs_found",
                                       "max_abs_err", "ctas", "soup_ms",
                                       "warp_kernel_ms", "thread_ms",
                                       "pass_ms")},
                overflow=overflow, c1_c2_gap=gap, c1_f64_err=e1,
                c2_f64_err=e2)
        # C2 on a 3D path: two grid cubes (5 subdivisions, side 0.2) in the
        # unit domain, the upper half a radius into the lower, through
        # make_contact_frame_fn with contact_broadphase "grid".
        cube_cfg = parse_config(dict(
            dim=3, delta_time=5e-4, sim_count=10, auto_diff=False,
            use_explicit_method=True, g_dir=[0.0, -1.0, 0.0],
            contact="penalty", contact_broadphase="grid", blocks=[]))
        cubes = []
        for center in ([0.4, 0.1, 0.4], [0.42, 0.3, 0.4]):
            ocfg = ObjectConfig(center=tuple(center), side_length=0.2,
                                subdivisions=5)
            cubes.append(build_object(
                ocfg, *pmesh.construct_3d_grid_mesh(ocfg), device=dev))
        crad = contact.auto_contact_radius([o for o, _ in cubes])
        upper = cubes[1][1]
        cstates = (cubes[0][1], upper.replace(pos=upper.pos - torch.tensor(
            [0.0, 0.5 * crad, 0.0], device=dev)))
        cframe = fem_tpu_torch.make_contact_frame_fn([o for o, _ in cubes],
                                                     cube_cfg)
        cobs = Obstacles.from_configs((), 3, device=dev)
        zero_counts()
        for _ in range(FRAMES_GRID):
            cstates, _ = cframe(cstates, cobs)
        torch.cuda.synchronize()
        launches = counts()
        require(launches == only(contact_grid=FRAMES_GRID * 10,
                                 blocked_grad_prep=2 * FRAMES_GRID * 10),
                f"path AR grid cubes: launches {launches}")
        require(all(bool(torch.isfinite(s.pos).all()) for s in cstates),
                "path AR grid cubes: non-finite positions")
        cplan = cframe.plan
        cpos, cvel = soup_of(torch, cplan, cstates)
        crad, ck3, _, _ = cframe.constants
        err_c2_3d, _, cfound = check_c2(torch, "3D grid cubes", cpos, cvel,
                                        cplan.rest_cat, cplan.body_id, crad,
                                        ck3, cplan.cap)
        # The grid cubes' device ms a substep, with contact (the coupled
        # frame: the soup, the grid pass, the scatter and each body's
        # substep) and without (each body's substep alone).
        kw_c = sim.substep_kwargs(cube_cfg)

        def cubes_with():
            cframe(cstates, cobs)

        def cubes_without():
            ss = cstates
            for _ in range(cube_cfg.sim_count):
                ss = tuple(sim.substep(o, st, cobs, **kw_c)[0]
                           for (o, _), st in zip(cubes, ss))

        cube_with, _ = window_ms(torch, cubes_with, cube_cfg.sim_count)
        cube_without, _ = window_ms(torch, cubes_without, cube_cfg.sim_count)
        zero_counts()
        log(f"[path AR grid] the grid cubes' device ms a substep: with "
            f"contact {cube_with:.4f}, without {cube_without:.4f}; contact "
            f"{cube_with - cube_without:.4f}; card {card}")
        rows.append(c2_row(torch, card, 3, cpos, cplan.body_id, crad, ck3,
                           cplan.cap, FRAMES_GRID * 10, err_c2_3d, cfound,
                           f"two grid cubes {cplan.sizes}",
                           dict(shells={ns: v["c2"] for ns, v in
                                        line["AR"].items()},
                                substep_device_ms_with_contact=cube_with,
                                substep_device_ms_without=cube_without)))
        for r in rows:
            if r["name"] == "contact_pairs" and r["shapes"].startswith("AP"):
                r["shells"] = {ns: v["c1"] for ns, v in line["AR"].items()}
        log(f"[path AR grid] two 3D cubes stacked, {FRAMES_GRID} frames "
            f"with contact_broadphase 'grid' through make_contact_frame_fn: "
            "C2 once a substep, K7b once a body a substep")

        # -- 66. path AS: the batched frame ------------------------------------
        dpath = os.path.join(REPO, "configs", "default.json")
        dcfg, dobj, dstate, dobs = entry.load_config(dpath, dev)
        ens = batch.perturb_states(dstate, BATCH_AS, scale=1e-4, seed=0)
        bframe = batch.make_batched_frame_fn(dobj, dcfg)
        zero_counts()
        t0 = time.perf_counter()
        out = ens
        for _ in range(FRAMES_AS):
            out, baux = bframe(out, dobs)
        torch.cuda.synchronize()
        as_wall = time.perf_counter() - t0
        launches = counts()
        asubs = FRAMES_AS * dcfg.sim_count
        require(launches == only(blocked_assemble=BATCH_AS * asubs),
                f"path AS: launches {launches}")
        require(tuple(baux.solver_iterations.shape) == (BATCH_AS,
                                                         dcfg.sim_count),
                "path AS: aux shape")
        kw = sim.substep_kwargs(dcfg)
        for b in range(BATCH_AS):
            s = dstate.replace(pos=ens.pos[b])
            for _ in range(asubs):
                s, _ = sim.substep(dobj, s, dobs, **kw)
            require(torch.equal(s.pos, out.pos[b]),
                    f"path AS: member {b} differs from its single run")
        spread = float((out.pos - out.pos[0]).abs().max())
        log(f"[path AS] default.json at B={BATCH_AS}, perturbed (1e-4): "
            f"{FRAMES_AS} frames, K7a once a member a substep "
            f"({BATCH_AS * asubs}); {BATCH_AS * asubs / as_wall:.1f} member "
            f"steps/s; every member bit-equal to its single run; spread "
            f"{spread:.3e}")
        line["AS"] = dict(member_steps_per_s=BATCH_AS * asubs / as_wall,
                          spread=spread)
    finally:
        os.chdir(cwd)
        zero_counts()
    return rows, line, time.perf_counter() - t_phase


FRAMES_AT = 3  # path AT: the Newton flagship at its shipped dt
FRAMES_AU = 2  # path AU: the flagship at 8x its dt, two-level inside Newton
FRAMES_AV = 3  # path AV: the semi-implicit flagship under two_level
FRAMES_AW = 2  # path AW, each theta
DT_AU = 4e-3
# Path AW: examples/newton_large_dt.py's block (copied: the example imports
# the JAX package): 7 subdivisions, E 4e5, dt 2e-3, kappa ~60; its start
# velocities noised by 1e-4 (numpy seed 0), as
# tests/test_torch_newton_large_dt.py does, so that the solves iterate.
BLOCK_AW = {
    "dim": 2, "delta_time": 2e-3, "sim_count": 10,
    "use_explicit_method": False, "implicit_method": 1, "preconditioned": 0,
    "cg_precond": "none", "g_dir": [0.0, -1.0],
    "objects": [{"center": [0.5, 0.8], "E": 4e5, "nu": 0.2, "damping": 14.5,
                 "side_length": 0.2, "subdivisions": 7}],
}
# Path AX: the unit cube of assets/cube.stl meshed at interior spacing 0.2
# (943 particles, 4,196 tets, 17 blocks), pinned along its top face, solved
# to rest under gravity.
CUBE_AX = dict(
    dim=3, delta_time=5e-4, sim_count=10, use_explicit_method=False,
    implicit_method=1, g_dir=[0, -1, 0], blocks=[],
    objects=[dict(obj="assets/cube.stl", center=[0, 0, 0], E=4e5, nu=0.3,
                  rho=1000,
                  pin_boxes=[[[-0.01, 0.99, -0.01], [1.01, 1.01, 1.01]]])])
SPACING_AX = 0.2


class ApplyCounter:
    """Counts the calls of H1's wrapper (``stiffness_kernels.
    stiffness_apply``, which ``element_linearization``'s products look up
    at each call) while it is entered: on the card each must be one
    launch.  The stand-in shares the wrapper's attributes (its launch
    count among them), which the wrapper updates through the module's
    name."""

    def __enter__(self):
        from fem_tpu_torch.ops import stiffness_kernels

        self.calls = 0
        self.mod = stiffness_kernels
        self.fn = stiffness_kernels.stiffness_apply

        def counted(*a, **k):
            self.calls += 1
            return self.fn(*a, **k)

        counted.__dict__ = self.fn.__dict__
        stiffness_kernels.stiffness_apply = counted
        return self

    def __exit__(self, *exc):
        self.mod.stiffness_apply = self.fn


class SlotsVariant:
    """Runs H1's slots variant (the first design) wherever the code calls
    H1's wrapper (``stiffness_kernels.stiffness_apply``, looked up through
    the module at each call) while it is entered.  The stand-in shares the
    wrapper's attributes (its launch count among them)."""

    def __enter__(self):
        from fem_tpu_torch.ops import stiffness_kernels

        self.mod = stiffness_kernels
        self.fn = stiffness_kernels.stiffness_apply

        def slots(binding, w):
            return self.fn(binding, w, variant="slots")

        slots.__dict__ = self.fn.__dict__
        stiffness_kernels.stiffness_apply = slots
        return self

    def __exit__(self, *exc):
        self.mod.stiffness_apply = self.fn


class PlainGuard:
    """Counts the calls of the plain versions of K1, K2, K3, K7a, K7b and H1
    (the module attributes their wrappers call on CPU tensors) while it is
    entered: a path on the card must make none."""

    NAMES = (("blocked_kernels", "blocked_graph_apply_plain"),
             ("blocked_kernels", "blocked_prep_force_plain"),
             ("blocked_kernels", "blocked_grad_force_plain"),
             ("blocked_kernels", "blocked_assemble_plain"),
             ("element_kernels", "hessian_and_force_plain"),
             ("stiffness_kernels", "stiffness_apply_plain"))

    def __enter__(self):
        from fem_tpu_torch.ops import (
            blocked_kernels,
            element_kernels,
            stiffness_kernels,
        )

        mods = dict(blocked_kernels=blocked_kernels,
                    element_kernels=element_kernels,
                    stiffness_kernels=stiffness_kernels)
        self.calls, self.saved = {}, []
        for mod_name, name in self.NAMES:
            mod = mods[mod_name]
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def counted(*a, _fn=fn, _name=name, **k):
                self.calls[_name] = self.calls.get(_name, 0) + 1
                return _fn(*a, **k)

            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def counted_then_profiled(torch, zero_counts, counts, go, units):
    """Runs ``go`` (which returns its result) twice: first with the launch
    counts zeroed before it, read after it and the plain versions guarded
    (``PlainGuard``), timed on the host; then under the profiler, whose
    device time it sums from the kernel activity records themselves (these
    paths launch hundreds of thousands of kernels a window, which
    ``key_averages`` would take minutes to aggregate).  Returns (first
    result, its wall s, its launches, the plain calls, second result,
    device ms a unit, busy share) for ``units`` units (the frames or
    solves ``go`` runs)."""
    from torch.profiler import ProfilerActivity, profile

    with PlainGuard() as guard:
        zero_counts()
        t0 = time.perf_counter()
        first = go()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts()
    cuda = torch.autograd.DeviceType.CUDA
    for attempt in range(EMPTY_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            second = go()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev_ms = 1e-6 * sum(e.duration_ns() for e in
                            prof.profiler.kineto_results.events()
                            if e.device_type() == cuda)
        if dev_ms > 0:
            break
        log(f"[profiler] a window recorded no device activity (window "
            f"{attempt + 1}); taken again")
        time.sleep(0.05 * (attempt + 1))
    require(dev_ms > 0, "the profiler recorded no device activity in "
            f"{EMPTY_WINDOWS} windows in a row")
    return (first, wall, launches, dict(guard.calls), second, dev_ms / units,
            100 * dev_ms / wall_ms)


def run_newton(torch, dev, zero_counts, counts, only, card):
    """Sections 67-71: the Newton integrator, the two-level preconditioner
    and the static solve, paths AT-AX.  Each path runs twice, counted and
    then profiled (``counted_then_profiled``), the two bit-identical.
    Returns (the ``newton_paths`` line's
    dict, phase seconds)."""
    import numpy as np

    import fem_tpu_torch
    from fem_tpu_torch import convert, entry, sim
    from fem_tpu_torch.solvers import newton

    t_phase = time.perf_counter()
    line = {}
    totals = newton.newton_velocity_solve.totals
    cfg, obj, state0, obs = entry.flagship(dev)
    state = entry.deformed(state0)
    cpu_obj = convert.object_from_arrays(*convert.object_to_arrays(obj), "cpu")
    cpu_state = convert.state_from_arrays(convert.state_to_arrays(state),
                                          "cpu")
    cpu_obs = type(obs)(obs.centers.cpu(), obs.radii.cpu())
    require(obj.num_aggregates == 25 and cpu_obj.num_aggregates == 25,
            f"the flagship's aggregates: {obj.num_aggregates}")

    def zero_all():
        zero_counts()
        totals.update(solves=0, steps=0, trials=0, cg=0)

    def run(frame_fn, frames, start=state, obstacles=obs):
        """(end state, iterations (frames, sim_count) on the host, Newton
        totals) of ``frames`` frames from ``start``."""
        totals.update(solves=0, steps=0, trials=0, cg=0)
        s, its = start, []
        for _ in range(frames):
            s, aux = frame_fn(s, obstacles)
            its.append(aux.solver_iterations)
        return s, torch.stack(its).cpu(), dict(totals)

    def same(a, b):
        return torch.equal(a.pos, b.pos) and torch.equal(a.vel, b.vel)

    def drive(label, frame_fn, frames, **kw):
        (s, its, t), wall, launches, plain, (s2, _, _), dev_ms, busy = \
            counted_then_profiled(torch, zero_all, counts,
                                  lambda: run(frame_fn, frames, **kw), frames)
        require(not plain, f"{label} ran plain versions {plain}")
        require(same(s, s2), f"{label}: two runs differ")
        require(bool(torch.isfinite(s.pos).all()), f"{label} non-finite")
        log(f"[profile] {label}: {dev_ms:.4f} device ms a frame, device busy "
            f"{busy:.1f}%; card {card}")
        return s, its, t, wall, launches, dev_ms, busy

    # -- 67. path AT: the Newton flagship (decoupled) ------------------------
    cfg_at = dataclasses.replace(cfg, integrator="newton",
                                 newton_hessian="decoupled")
    require(not sim.supports_blocked_frame(obj, cfg_at),
            "path AT routed to K5")
    frame_at = sim.make_frame_fn(obj, cfg_at)
    first, first_its, _ = run(frame_at, 1)
    # The CPU run of the same route (K2's and K3's plain versions).
    ref, ref_aux = sim.make_frame_fn(cpu_obj, dataclasses.replace(
        cfg_at, element_backend="pallas"))(cpu_state, cpu_obs)
    err = float((first.pos.cpu() - ref.pos).abs().max())
    log(f"[path AT] first frame vs the CPU (K2 and K3's plain versions): max "
        f"|dpos| {err:.3e}; inner CG a substep {first_its[0].tolist()}, CPU "
        f"{ref_aux.solver_iterations.tolist()}")
    require(err <= 1e-5, f"path AT: first frame off the CPU by {err}")
    # Within 3 a substep, as tests/test_torch_newton.py holds the CPU to the
    # JAX package: the Newton loop's last step, or a trial's acceptance,
    # rests on f32 rounding at its tolerance of 1e-5, and the kernels sum
    # in another order than their plain versions.
    require(all(abs(a - b) <= 3 for a, b in zip(
        first_its[0].tolist(), ref_aux.solver_iterations.tolist())),
        f"path AT: CG a substep {first_its[0].tolist()} vs the CPU's "
        f"{ref_aux.solver_iterations.tolist()}")
    s_at, _, t_at, wall, launches, dev_ms, busy = drive(
        "path AT (K2 + K3, Newton decoupled)", frame_at, FRAMES_AT)
    k3 = t_at["steps"] + t_at["cg"]
    require(launches == only(blocked_prep=t_at["trials"],
                             blocked_matvec=k3),
            f"path AT: launches {launches} vs K2 {t_at['trials']} "
            f"(residual evaluations), K3 {k3} (steps + CG iterations)")
    require(t_at["solves"] == FRAMES_AT * cfg.sim_count,
            f"path AT: {t_at['solves']} Newton solves")
    subs = FRAMES_AT * cfg.sim_count
    log(f"[path AT] {FRAMES_AT} frames of the Newton flagship (decoupled, "
        f"dt {cfg.delta_time}): {subs / wall:.1f} steps/s; Newton steps "
        f"{t_at['steps']}, residual evaluations {t_at['trials']}, inner CG "
        f"{t_at['cg']}; launches {launches}; runs bit-identical")
    line["AT"] = dict(frames=FRAMES_AT, steps_per_s=subs / wall,
                      device_ms_per_frame=dev_ms, busy_pct=busy,
                      newton=t_at, launches=dict(K2=t_at["trials"], K3=k3),
                      first_frame_err=err, card=card)

    # -- 68. path AU: two_level_cheb3 inside Newton at 8x the dt --------------
    cfg_au = dataclasses.replace(cfg_at, cg_precond="two_level_cheb3",
                                 delta_time=DT_AU)
    s_au, _, t_au, wall, launches, dev_ms, busy = drive(
        f"path AU (K2 + K3, Newton two_level_cheb3 at dt {DT_AU})",
        sim.make_frame_fn(obj, cfg_au), FRAMES_AU)
    k3 = 16 * t_au["solves"] + 7 * (t_au["steps"] + t_au["cg"])
    require(launches == only(blocked_prep=t_au["trials"], blocked_matvec=k3),
            f"path AU: launches {launches} vs K2 {t_au['trials']}, K3 {k3} "
            "(16 power-iteration applies a substep, 7 a PCG step and "
            "iteration)")
    zero_all()
    t0 = time.perf_counter()
    s_plain, _, t_plain = run(sim.make_frame_fn(obj, dataclasses.replace(
        cfg_at, delta_time=DT_AU)), FRAMES_AU)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    require(counts() == only(blocked_prep=t_plain["trials"],
                             blocked_matvec=t_plain["steps"] + t_plain["cg"]),
            "path AU plain-CG Newton launches")
    s_semi, _, _ = run(sim.make_frame_fn(obj, dataclasses.replace(
        cfg, delta_time=DT_AU)), FRAMES_AU)
    semi_finite = bool(torch.isfinite(s_semi.pos).all())
    subs = FRAMES_AU * cfg.sim_count
    log(f"[path AU] {FRAMES_AU} frames at dt {DT_AU} (8x shipped): inner "
        f"iterations two_level_cheb3 {t_au['cg']} in {t_au['steps']} Newton "
        f"steps, plain CG {t_plain['cg']} in {t_plain['steps']} "
        f"(finite: {bool(torch.isfinite(s_plain.pos).all())}); the "
        f"semi-implicit frame finite: {semi_finite} (printed, not a gate); "
        f"{subs / wall:.1f} steps/s (plain CG {subs / wall_plain:.1f}); "
        "runs bit-identical")
    line["AU"] = dict(frames=FRAMES_AU, dt=DT_AU, steps_per_s=subs / wall,
                      device_ms_per_frame=dev_ms, busy_pct=busy,
                      newton=t_au, plain_cg_newton=t_plain,
                      plain_cg_steps_per_s=subs / wall_plain,
                      semi_implicit_finite=semi_finite,
                      launches=dict(K2=t_au["trials"], K3=k3), card=card)

    # -- 69. path AV: the semi-implicit flagship under two_level ---------------
    cfg_av = dataclasses.replace(cfg, cg_precond="two_level")
    require(not sim.supports_blocked_frame(obj, cfg_av),
            "path AV routed to K5")
    frame_av = sim.make_frame_fn(obj, cfg_av)
    first, first_its, _ = run(frame_av, 1)
    ref, ref_aux = sim.make_frame_fn(cpu_obj, cfg_av)(cpu_state, cpu_obs)
    err = float((first.pos.cpu() - ref.pos).abs().max())
    log(f"[path AV] first frame vs the CPU: max |dpos| {err:.3e}; PCG "
        f"iterations {first_its[0].tolist()}, CPU "
        f"{ref_aux.solver_iterations.tolist()}")
    require(err <= 1e-5, f"path AV: first frame off the CPU by {err}")
    require(torch.equal(first_its[0], ref_aux.solver_iterations),
            "path AV: iterations differ from the CPU's")
    s_av, its_av, _, wall, launches, dev_ms, busy = drive(
        "path AV (K2 + K3, two_level PCG)", frame_av, FRAMES_AV)
    k3 = int((19 + 3 * its_av).sum())
    subs = FRAMES_AV * cfg.sim_count
    require(launches == only(blocked_prep=subs, blocked_matvec=k3),
            f"path AV: launches {launches} vs K2 {subs}, K3 {k3} "
            "(19 + 3 a PCG iteration, a substep)")
    log(f"[path AV] {FRAMES_AV} frames of the semi-implicit flagship with "
        f"cg_precond two_level: PCG iterations {its_av.tolist()}; "
        f"{subs / wall:.1f} steps/s; launches {launches}; runs "
        "bit-identical")
    line["AV"] = dict(frames=FRAMES_AV, steps_per_s=subs / wall,
                      device_ms_per_frame=dev_ms, busy_pct=busy,
                      iterations=its_av.tolist(),
                      launches=dict(K2=subs, K3=k3), first_frame_err=err,
                      card=card)

    # -- 70. path AW: examples/newton_large_dt.py's block, exact Newton -------
    line["AW"] = {}
    for theta in (1.0, 0.5):
        data = json.loads(json.dumps(dict(BLOCK_AW, integrator="newton",
                                          newton_theta=theta)))
        sims = []
        for device in (dev, "cpu"):
            simulation = fem_tpu_torch.Simulation.from_dict(data,
                                                            device=device)
            st = simulation.scene[0].state
            kick = np.random.default_rng(0).normal(
                scale=1e-4, size=tuple(st.vel.shape)).astype(np.float32)
            simulation.scene[0].state = st.replace(
                vel=st.vel + torch.as_tensor(kick, device=st.vel.device))
            sims.append(simulation)
        gpu_sim, cpu_sim = sims
        frame_w = sim.make_frame_fn(gpu_sim.scene[0].obj, gpu_sim.cfg)
        start = gpu_sim.scene[0].state
        label = f"path AW (exact Newton, theta {theta})"
        s_w, its_w, t_w, wall, launches, dev_ms, busy = drive(
            label, frame_w, FRAMES_AW, start=start,
            obstacles=gpu_sim.obstacles)
        h1 = t_w["steps"] + t_w["cg"]
        require(launches == only(stiffness_apply=h1), f"{label}: launches "
                f"{launches} vs H1 {h1} (Newton steps + inner CG iterations:"
                " one exact-Hessian product each)")
        gpu_sim.step_frame()
        cpu_sim.step_frame()
        err = float(np.abs(gpu_sim.positions() - cpu_sim.positions()).max())
        require(err <= 1e-3, f"{label}: first frame off the CPU by {err}")
        subs = FRAMES_AW * gpu_sim.cfg.sim_count
        log(f"[path AW] examples/newton_large_dt.py's block (kappa ~60, dt "
            f"{gpu_sim.cfg.delta_time}), exact Newton, theta {theta}: "
            f"{FRAMES_AW} frames finite, inner CG {int(its_w.sum())}; first "
            f"frame vs the CPU {err:.3e}; {subs / wall:.1f} steps/s")
        line["AW"][str(theta)] = dict(
            frames=FRAMES_AW, steps_per_s=subs / wall,
            device_ms_per_frame=dev_ms, busy_pct=busy,
            inner_cg=int(its_w.sum()), h1_launches=h1, first_frame_err=err,
            card=card)

    # -- 71. path AX: Simulation.solve_static on a pinned 3D cube -------------
    def cube(device):
        return fem_tpu_torch.Simulation.from_dict(
            CUBE_AX, device=device, interior_spacing=SPACING_AX)

    gpu_cube, cpu_cube = cube(dev), cube("cpu")
    start_x = gpu_cube.scene[0].state

    def solve():
        gpu_cube.scene[0].state = start_x
        (r,) = gpu_cube.solve_static(cg_precond="two_level_cheb3")
        return r

    with ApplyCounter() as applies:
        res, wall, launches, plain, res2, dev_ms, busy = \
            counted_then_profiled(torch, zero_counts, counts, solve, 1)
    # Two solves ran inside: the counted one and the profiled one.
    require(applies.calls % 2 == 0 and applies.calls > 0,
            f"path AX: {applies.calls} products of the exact Hessian")
    h1_ax = applies.calls // 2
    (cres,) = cpu_cube.solve_static(cg_precond="two_level_cheb3")
    state_x = gpu_cube.scene[0].state
    size = (gpu_cube.scene[0].obj.particle_cnt,
            gpu_cube.scene[0].obj.element_cnt)
    err = float((res.pos.cpu() - cres.pos).abs().max())
    sag = float((res.pos[:, 1] - start_x.pos[:, 1]).min())
    log(f"[path AX] Simulation.solve_static(two_level_cheb3) on the pinned "
        f"unit cube ({size[0]} particles, {size[1]} tets): "
        f"{int(res.iterations)} Newton iterations, "
        f"{int(res.cg_iterations)} PCG iterations, converged "
        f"{bool(res.converged)}, stalled {bool(res.stalled)}, grad norm "
        f"{float(res.grad_norm):.3e}; CPU {int(cres.iterations)}, "
        f"{int(cres.cg_iterations)}, {bool(cres.converged)}; max |dpos| vs "
        f"the CPU {err:.3e}; sag {sag:.4e}; {wall:.3f} s a solve, "
        f"{dev_ms:.4f} device ms, busy {busy:.1f}%; card {card}")
    require(launches == only(stiffness_apply=h1_ax) and not plain,
            f"path AX: launches {launches}, plain {plain} (H1 once a "
            f"product of the exact Hessian: {h1_ax})")
    require(torch.equal(res.pos, res2.pos), "path AX: two solves differ")
    require(err <= 1e-5, f"path AX off the CPU by {err}")
    require(bool(res.converged) == bool(cres.converged)
            and bool(res.stalled) == bool(cres.stalled),
            "path AX: converged/stalled differ from the CPU's")
    require(bool(res.converged) or bool(res.stalled), "path AX unfinished")
    require(sag < -1e-3, f"path AX: no sag ({sag})")
    require(not state_x.vel.any() and torch.equal(state_x.pos, res2.pos),
            "path AX: the state is not at rest at the equilibrium")
    line["AX"] = dict(particles=size[0], tets=size[1],
                      iterations=int(res.iterations),
                      cg_iterations=int(res.cg_iterations),
                      converged=bool(res.converged), wall_s=wall,
                      device_ms_per_solve=dev_ms, busy_pct=busy,
                      h1_launches=h1_ax, cpu_err=err, card=card)
    zero_counts()
    return line, time.perf_counter() - t_phase


DIFF_CG_ITERS = 32  # paths AY and AZ: the CG's fixed iterations
ADAM_STEPS = 5  # path AZ
SUBSTEPS_BA = 12  # path BA on default.json; 10 on the flagship and plastic
DIFF_TOL = 1e-3  # gradients against the CPU's, relative (a parameter) or
# of the largest entry (the initial velocity): tests/test_torch_diff*.py
TOP_OPS = 12  # path AY: device ops listed from its profile


def diff_gradient(torch, diff, cfg, obj, state, obs, target, substeps,
                  remat=True, yield_strain=None):
    """(loss, gradients) of one differentiable rollout of ``substeps``
    from ``state``: with ``target`` the trajectory MSE and its gradient in
    μ, λ, the damping and the initial velocity; without, tests/test_diff.py's
    functional (mean of the positions² and the final velocities²) in μ, λ,
    the damping (and the yield strain)."""
    rollout = diff.make_diff_rollout_fn(obj, cfg, substeps, DIFF_CG_ITERS,
                                        remat)
    p = diff.params_from_object(obj)
    leaves = [t.requires_grad_(True) for t in p[:3]]
    y = None
    if yield_strain is not None:
        y = torch.tensor(yield_strain, device=obj.device, requires_grad=True)
        leaves.append(y)
    start = state
    if target is not None:
        v0 = state.vel.clone().requires_grad_(True)
        leaves.append(v0)
        start = state.replace(vel=v0)
    final, traj = rollout(diff.DiffParams(*leaves[:3], plastic_yield=y),
                          start, obs)
    if target is not None:
        loss = torch.mean((traj - target) ** 2)
    else:
        loss = torch.mean(traj ** 2) + torch.mean(final.vel ** 2)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def grads_close(torch, label, got, ref, rel=DIFF_TOL):
    """Require ``got`` (loss, gradients) within ``rel`` of ``ref``: the loss
    1e-5 relative, a scalar gradient ``rel`` relative, a field ``rel`` of
    its largest entry; returns the largest relative error."""
    (loss, g), (rloss, r) = got, ref
    worst = abs(float(loss) - float(rloss)) / max(abs(float(rloss)), 1e-30)
    require(worst <= 1e-5, f"{label}: loss {float(loss)} vs {float(rloss)}")
    for i, (a, b) in enumerate(zip(g, r)):
        a, b = a.detach().cpu(), b.detach().cpu()
        scale = float(b.abs().max())
        require(scale > 0.0, f"{label}: gradient {i} is 0")
        err = float((a - b).abs().max()) / scale
        require(err <= rel, f"{label}: gradient {i} off by {err:.3e} "
                f"relative ({a.flatten()[:3].tolist()} vs "
                f"{b.flatten()[:3].tolist()})")
        worst = max(worst, err)
    return worst


def same_grads(torch, a, b):
    return torch.equal(a[0], b[0]) and all(
        torch.equal(x, y) for x, y in zip(a[1], b[1]))


def top_device_ops(torch, go):
    """(device ms by kernel name, sorted, the window's device ms) of one
    run of ``go`` under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(EMPTY_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            go()
            torch.cuda.synchronize()
        by = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                by[e.name()] = by.get(e.name(), 0.0) + 1e-6 * e.duration_ns()
        if by:
            break
    require(by, "the profiler recorded no device activity")
    return sorted(by.items(), key=lambda kv: -kv[1]), sum(by.values())


def run_diff(torch, dev, zero_counts, counts, only, card):
    """Sections 72-74: differentiable rollouts, paths AY-BA.  Returns (the
    ``diff_paths`` line's dict, phase seconds)."""
    import math

    from fem_tpu_torch import convert, diff, entry
    from fem_tpu_torch.ops import blocked_kernels

    t_phase = time.perf_counter()
    line = {}
    k3 = blocked_kernels.blocked_graph_apply

    def on_cpu(obj, state, obs):
        return (convert.object_from_arrays(*convert.object_to_arrays(obj),
                                           "cpu"),
                convert.state_from_arrays(convert.state_to_arrays(state),
                                          "cpu"),
                type(obs)(obs.centers.cpu(), obs.radii.cpu()))

    def counts_and_k3():
        return counts(), sum(k3.variant_launches.values())

    # -- 72. path AY: the gradient through a full flagship frame ---------------
    cfg, obj, state0, obs = entry.flagship(dev)
    state = entry.deformed(state0)
    n_sub = cfg.sim_count
    with torch.no_grad():
        p = diff.params_from_object(obj)
        target = diff.make_diff_rollout_fn(obj, cfg, n_sub, DIFF_CG_ITERS)(
            p._replace(mu=1.5 * p.mu), state, obs)[1]
    predicted = diff.implicit_graph_products(obj, n_sub, DIFF_CG_ITERS, True)

    def go(remat=True):
        return diff_gradient(torch, diff, cfg, obj, state, obs, target,
                             n_sub, remat)

    first, wall, (launches, k3_variant), plain, second, dev_ms, busy = \
        counted_then_profiled(torch, zero_counts, counts_and_k3, go, 1)
    log(f"[path AY] K3 launches by variant {dict(k3.variant_launches)}; "
        f"{k3_variant} in the counted gradient, predicted {predicted} "
        f"(diff.implicit_graph_products: 10 substeps x ((3 + 2x32) x 2 "
        f"with remat + 5 + 2x32))")
    require(not plain, f"path AY ran plain versions {plain}")
    require(k3_variant == predicted and launches == only(
        blocked_matvec=predicted), f"path AY: K3 {k3_variant} (launches "
        f"{launches}) vs predicted {predicted}")
    require(same_grads(torch, first, second), "path AY: two runs differ")
    require(all(bool(torch.isfinite(g).all()) for g in first[1]),
            "path AY: a gradient is not finite")
    c_obj, c_state, c_obs = on_cpu(obj, state, obs)
    t0 = time.perf_counter()
    cpu = diff_gradient(torch, diff, cfg, c_obj, c_state, c_obs,
                        target.cpu(), n_sub)
    cpu_s = time.perf_counter() - t0
    err_cpu = grads_close(torch, "path AY vs the CPU", first, cpu)
    # The same gradient with K3's plain version in its place, on the card.
    zero_counts()
    blocked_kernels.blocked_graph_apply = (
        lambda blk, K, x, t=False:
        blocked_kernels.blocked_graph_apply_plain(blk, K, x, t))
    try:
        plain_run = go()
    finally:
        blocked_kernels.blocked_graph_apply = k3
    require(counts() == only(), "path AY with plain products launched a "
            "kernel")
    err_plain = grads_close(torch, "path AY vs the plain products", first,
                            plain_run)
    memory = {}
    for remat in (True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        run = go(remat)
        torch.cuda.synchronize()
        memory["remat" if remat else "stored"] = dict(
            peak_mb=torch.cuda.max_memory_allocated() / 2 ** 20,
            above_start_mb=(torch.cuda.max_memory_allocated() - base)
            / 2 ** 20)
        require(same_grads(torch, run, first),
                f"path AY: remat={remat} differs from the counted run")
    ops, prof_ms = top_device_ops(torch, go)
    index_ms = sum(ms for name, ms in ops if "index" in name.lower())
    log(f"[path AY] loss {float(first[0]):.6e}; dL/dmu "
        f"{float(first[1][0]):.6e}, dL/dlambda {float(first[1][1]):.6e}, "
        f"dL/ddamping {float(first[1][2]):.6e}, max |dL/dv0| "
        f"{float(first[1][3].abs().max()):.6e}; vs the CPU {err_cpu:.3e} "
        f"({cpu_s:.1f} s there), vs the plain products {err_plain:.3e}; "
        f"runs bit-identical; {wall:.3f} s a gradient (counted run), "
        f"{dev_ms:.4f} device ms a gradient, device busy {busy:.1f}%; peak "
        f"memory remat {memory['remat']['above_start_mb']:.1f} MB above the "
        f"start ({memory['remat']['peak_mb']:.1f} MB), stored "
        f"{memory['stored']['above_start_mb']:.1f} MB "
        f"({memory['stored']['peak_mb']:.1f} MB); card {card}")
    for name, ms in ops[:TOP_OPS]:
        log(f"[path AY top op] {ms:.4f} ms ({100 * ms / prof_ms:.1f}%) "
            f"{name[:140]}")
    log(f"[path AY] index kernels {index_ms:.4f} ms of {prof_ms:.4f} device "
        f"ms ({100 * index_ms / prof_ms:.1f}%)")
    line["AY"] = dict(
        substeps=n_sub, cg_iters=DIFF_CG_ITERS, loss=float(first[0]),
        grad=dict(mu=float(first[1][0]), s_lambda=float(first[1][1]),
                  damping=float(first[1][2]),
                  v0_max=float(first[1][3].abs().max())),
        launches=dict(K3=k3_variant), predicted_k3=predicted,
        wall_s=wall, device_ms_per_gradient=dev_ms, busy_pct=busy,
        cpu_rel_err=err_cpu, plain_rel_err=err_plain, cpu_s=cpu_s,
        memory=memory, index_share_pct=100 * index_ms / prof_ms,
        top_ops=[[name[:100], ms] for name, ms in ops[:TOP_OPS]], card=card)

    # -- 73. path AZ: 5 Adam steps on log E -------------------------------------
    ocfg = cfg.objects[0]
    rollout = diff.make_diff_rollout_fn(obj, cfg, n_sub, DIFF_CG_ITERS)
    damping = torch.tensor(obj.damping, device=dev)

    def trajectory(log_e):
        mu, lam = diff.lame_from_young(torch.exp(log_e), ocfg.nu)
        return rollout(diff.DiffParams(mu, lam, damping), state, obs)[1]

    with torch.no_grad():
        target_e = trajectory(torch.log(torch.tensor(ocfg.E, device=dev)))
    log_e = torch.log(torch.tensor(2.0 * ocfg.E, device=dev))
    log_e.requires_grad_(True)
    opt = torch.optim.Adam([log_e], lr=0.1)
    losses, youngs, walls = [], [], []
    per_step = diff.implicit_graph_products(obj, n_sub, DIFF_CG_ITERS, True)
    for step in range(ADAM_STEPS):
        zero_counts()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = torch.mean((trajectory(log_e) - target_e) ** 2) * 1e6
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        youngs.append(float(torch.exp(log_e.detach())))
        walls.append(time.perf_counter() - t0)
        launches, k3_step = counts_and_k3()
        require(k3_step == per_step and launches == only(
            blocked_matvec=per_step), f"path AZ step {step + 1}: K3 "
            f"{k3_step} vs {per_step}")
        require(math.isfinite(losses[-1]), f"path AZ step {step + 1}: loss")
    log(f"[path AZ] {ADAM_STEPS} Adam steps on log E (lr 0.1, true E "
        f"{ocfg.E:.0f}, guess {2 * ocfg.E:.0f}): losses "
        f"{[f'{v:.6e}' for v in losses]}; E after each step "
        f"{[f'{v:.1f}' for v in youngs]}; {sum(walls) / len(walls):.3f} s "
        f"a step; K3 {per_step} a step; card {card}")
    require(losses[-1] < losses[0], f"path AZ: loss {losses[-1]} after step "
            f"{ADAM_STEPS} not below step 1's {losses[0]}")
    line["AZ"] = dict(steps=ADAM_STEPS, losses=losses, youngs=youngs,
                      s_per_step=sum(walls) / len(walls),
                      launches=dict(K3=per_step), card=card)

    # -- 74. paths BA: explicit, autodiff and plastic rollouts -----------------
    def squashed(state, scale):
        c = state.pos.mean(dim=0, keepdim=True)
        s = torch.tensor(scale[:state.pos.shape[1]], device=state.pos.device)
        return state.replace(pos=c + (state.pos - c) * s)

    default = os.path.join(REPO, "configs", "default.json")
    plastic = os.path.join(REPO, "configs", "demo_plastic.json")
    cases = []
    for label, over in (("default.json explicit", dict(auto_diff=False)),
                        ("default.json autodiff", {})):
        c, o, s, ob = entry.load_config(default, dev, sim_overrides=over)
        cases.append((label, c, o, squashed(s, (1.25, 1.1)), ob,
                      SUBSTEPS_BA, None))
    c, o, s, ob = entry.explicit_flagship(dev)
    cases.append(("explicit flagship dt 1e-4, deformed", c, o,
                  entry.deformed(s), ob, 10, None))
    c, os_, ss, ob = entry.load_config(plastic, dev)
    require(os_[0].plastic_yield > 0.0, "demo_plastic.json body 0 is elastic")
    cases.append(("demo_plastic.json body 0, yield traced", c, os_[0],
                  squashed(ss[0], (1.35, 0.75)), ob, 10,
                  os_[0].plastic_yield))
    line["BA"] = {}
    for label, c, o, s, ob, n, y in cases:
        def run_ba(c=c, o=o, s=s, ob=ob, n=n, y=y):
            return diff_gradient(torch, diff, c, o, s, ob, None, n,
                                 yield_strain=y)

        with PlainGuard() as guard:
            zero_counts()
            t0 = time.perf_counter()
            got = run_ba()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = counts()
        require(not guard.calls, f"path BA {label}: plain {guard.calls}")
        require(launches == only(), f"path BA {label}: launches {launches}")
        require(all(bool(torch.isfinite(g).all()) for g in got[1])
                and math.isfinite(float(got[0])),
                f"path BA {label}: not finite")
        require(same_grads(torch, got, run_ba()),
                f"path BA {label}: two runs differ")
        cpu = diff_gradient(torch, diff, c, *on_cpu(o, s, ob), None, n,
                            yield_strain=y)
        err = grads_close(torch, f"path BA {label} vs the CPU", got, cpu)
        log(f"[path BA] {label}: {n} substeps, loss {float(got[0]):.6e}, "
            f"gradients {[f'{float(g):.6e}' for g in got[1]]}; vs the CPU "
            f"{err:.3e}; runs bit-identical; no kernel; {wall:.3f} s a "
            f"gradient; card {card}")
        line["BA"][label] = dict(substeps=n, loss=float(got[0]),
                                 grads=[float(g) for g in got[1]],
                                 cpu_rel_err=err, wall_s=wall, card=card)
    zero_counts()
    return line, time.perf_counter() - t_phase


# -- The analysis solvers and H1 (sections 75-79) ---------------------------

H1_COLUMNS = 9  # the Chebyshev block of modes(k=6): kq = 9
H1_REPS = 200  # timed launches a shape
HARMONIC_FREQS = 200  # path BD
SPECTRUM_SAMPLES = 2000  # path BD: the record, numpy seed 0, at dt 1e-3
BUCKLE_E = 4e6  # path BE: the flagship's mesh 100x stiffer than shipped,
BUCKLE_PINS = 0.05  # pinned over its lowest 5 % (see run_analysis)
ARC_STEPS = 12  # path BF


def arch_object(np, torch, device, nx=48, ny=2, span=1.0, t=0.012,
                rise=0.06):
    """tests/test_riks.py's shallow sine arch (copied: that file imports the
    JAX package), both ends clamped: (object, state, crown vertices)."""
    from fem_tpu_torch.models.state import build_object
    from fem_tpu_torch.utils.config import ObjectConfig

    xs = np.linspace(0.0, span, nx + 1)
    ys = np.linspace(0.0, t, ny + 1)
    v = np.array(np.meshgrid(xs, ys)).T.reshape(-1, 2).astype(np.float32)
    v[:, 1] += (rise * np.sin(np.pi * v[:, 0] / span)).astype(np.float32)
    faces = []
    for i in range(nx):
        for j in range(ny):
            p1 = i * (ny + 1) + j
            p2, p3 = p1 + 1, p1 + ny + 1
            faces += [[p1, p2, p3 + 1], [p1, p3 + 1, p3]]
    faces = np.array(faces, np.int32)
    eps = span / nx / 4.0
    cfg = ObjectConfig(center=(0.0, 0.0),
                       pin_boxes=(((-1.0, -1.0), (eps, 1.0)),
                                  ((span - eps, -1.0), (span + 1.0, 1.0))))
    obj, state = build_object(cfg, v, faces, faces.copy(), device=device)
    pos = state.pos.cpu().numpy()
    crown = np.where(np.abs(pos[:, 0] - span / 2.0) < span / nx * 0.6)[0]
    return obj, state, crown


def h1_work(obj, c, itemsize):
    """(bytes, operations) of one K·W at c columns: J, W and the output,
    the element table and the CSR plan once each; per element and column
    the edge differences (d²), J's product (2 d⁴), vertex 0's −Σ (d²)
    and the assembly of its (d+1)·d rows."""
    e, dp1 = obj.element_indices.shape
    d, n = dp1 - 1, obj.particle_cnt
    nbytes_ = (itemsize * (e * d ** 4 + 2 * n * d * c)
               + 4 * (e * dp1 + n + 1 + e * dp1))
    ops = e * c * (d * d + 2 * d ** 4 + d * d + dp1 * d)
    return nbytes_, ops


def tensor_sha256(t):
    """The sha256 of a tensor's bytes, read back to the host."""
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()
                          ).hexdigest()


def h1_row(torch, card, label, obj, pos, launches):
    """H1 at ``obj``'s shapes and H1_COLUMNS columns: against its plain
    version (f32 and f64, 1, 8 and 9 columns, within 1e-6 / 1e-13 of the
    largest entry, twice bit-identical), the rows variant (the default)
    equal bit for bit to the slots variant (the first design) on each, its
    device ms and the slots variant's (f32 and f64), the plain version's
    ms, ``torch.sparse.mm`` of the assembled CSR (f32) and the bound.
    Returns the kernels line's row."""
    from fem_tpu_torch.convert import to_dtype
    from fem_tpu_torch.ops import stiffness_kernels as sk
    from fem_tpu_torch.solvers import modal

    n, d = obj.particle_cnt, obj.dim
    err, times, slot_times = 0.0, {}, {}
    for dtype, tol in ((torch.float32, 1e-6), (torch.float64, 1e-13)):
        kv = modal.make_stiffness_hvp(to_dtype(obj, dtype), pos.to(dtype))
        b = kv.binding
        for c in (1, 8, H1_COLUMNS):
            w = torch.randn((n, d, c), generator=torch.Generator(
                ).manual_seed(c), dtype=dtype).to(pos.device)
            got, again = kv(w), kv(w)
            plan = sk.stiffness_apply.last_plan
            slots = sk.stiffness_apply(b, w, variant="slots")
            ref = sk.stiffness_apply_plain(b.jac, w, b.element_indices,
                                           b.plan_idx)
            torch.cuda.synchronize()
            e = float((got - ref).abs().max())
            top = float(ref.abs().max())
            digest = tensor_sha256(got)
            log(f"[H1 {label}] {dtype} {c} columns: max abs error {e:.3e} "
                f"of max {top:.3e}; plan {plan}; rows variant sha256 "
                f"{digest}, slots variant {tensor_sha256(slots)}")
            require(e <= tol * top, f"H1 {label} {dtype} {c}: error {e}")
            require(torch.equal(got, again), f"H1 {label} runs differ")
            require(plan.variant == "rows" and torch.equal(got, slots),
                    f"H1 {label} {dtype} {c}: the rows variant ({plan}) "
                    "differs from the slots variant")
            if dtype == torch.float32:
                err = max(err, e)
        # Both variants in one profiled window, a call each a step.
        times[dtype], slot_times[dtype] = kernels_ms(
            torch, lambda: (kv(w), sk.stiffness_apply(b, w, variant="slots")),
            H1_REPS, [["stiffness_rows_kernel", "stiffness_sum_kernel"],
                      ["stiffness_apply_kernel"]])
        if dtype == torch.float32:
            plain_ms = cuda_ms(torch, lambda: sk.stiffness_apply_plain(
                b.jac, w, b.element_indices, b.plan_idx), 20)
            nd = n * d
            eye = torch.eye(nd, device=pos.device).reshape(n, d, nd)
            k_csr = kv(eye).reshape(nd, nd).to_sparse_csr()
            flat = w.reshape(nd, H1_COLUMNS)
            lib_ms = library_device_ms(
                torch, lambda: torch.sparse.mm(k_csr, flat), H1_REPS)
            lib_err = float((torch.sparse.mm(k_csr, flat).reshape(w.shape)
                             - kv(w)).abs().max())
            require(lib_err <= 1e-5 * float(kv(w).abs().max()),
                    f"H1 {label}: the assembled CSR's product off by "
                    f"{lib_err}")
    nb, ops = h1_work(obj, H1_COLUMNS, 4)
    bound_ms, bound_by = bound(nb, ops)
    nb64, _ = h1_work(obj, H1_COLUMNS, 8)
    row = dict(name="stiffness_apply", route="cuda",
               source="fem_tpu_torch/csrc/stiffness_apply.cu",
               replaces="fem_tpu/solvers/modal.py:68", dim=d,
               columns=H1_COLUMNS, variant="rows", launches=launches,
               # ``launches`` counts the wrapper's calls (an apply each);
               # the rows variant launches phase A and phase B in each.
               kernel_launches=2 * launches,
               max_abs_err=err, ms=times[torch.float32], plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
               ms_f64=times[torch.float64],
               bound_ms_f64=nb64 / PEAK_BYTES_PER_S * 1e3,
               ms_slots=slot_times[torch.float32],
               ms_slots_f64=slot_times[torch.float64],
               particles=n, elements=obj.element_cnt)
    log(f"[time] {d}D H1 ({label}, {H1_COLUMNS} columns) "
        f"{row['ms']:.5f} ms a launch on the device (profiler: phase A + "
        f"phase B), f64 {row['ms_f64']:.5f}; slots variant "
        f"{row['ms_slots']:.5f}, f64 {row['ms_slots_f64']:.5f}; "
        f"torch.sparse.mm {lib_ms:.5f} ms; plain {plain_ms:.4f} ms; bound "
        f"{bound_ms:.6f} ms ({bound_by}); launches {launches}; card {card}")
    return row


def run_analysis(torch, dev, zero_counts, counts, only, card):
    """Sections 75-79: H1 against its plain version and paths BB-BF.  Each
    path runs twice, counted and then profiled (``counted_then_profiled``,
    the plain versions guarded), the two bit-identical.  Returns (the
    kernels line's H1 rows, the ``analysis_paths`` line's dict, phase
    seconds)."""
    import numpy as np
    import scipy.linalg as sla

    import fem_tpu_torch
    from fem_tpu_torch import convert
    from fem_tpu_torch.ops import stiffness_kernels as sk
    from fem_tpu_torch.solvers import buckling, diagnostics, modal, riks
    from fem_tpu_torch.solvers.static import solve_static

    t_phase = time.perf_counter()
    line = {}
    h1 = sk.stiffness_apply
    with open(os.path.join(REPO, "configs", "demo_spot.json")) as f:
        spot = json.load(f)

    def simulation(device, **obj_over):
        data = json.loads(json.dumps(spot))
        data["objects"][0].update(obj_over)
        return fem_tpu_torch.Simulation.from_dict(data, device=device)

    free_sim = simulation(dev)
    rest = free_sim.scene[0].state.pos
    lo, hi = float(rest[:, 1].min()), float(rest[:, 1].max())
    top_pins = [[[-1e3, hi - 0.01 * (hi - lo), -1e3], [1e3, 1e3, 1e3]]]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b)
                   if isinstance(x, torch.Tensor))

    def path(label, go):
        """(result, wall s, launches, device ms, busy %) of ``go`` counted
        and profiled, no plain version, the two runs bit-identical."""
        first, wall, launches, plain, second, dev_ms, busy = \
            counted_then_profiled(torch, zero_counts, counts, go, 1)
        require(not plain, f"{label} ran plain versions {plain}")
        require(same(first, second), f"{label}: two runs differ")
        log(f"[path {label}] {wall:.3f} s wall, {dev_ms:.4f} device ms, "
            f"busy {busy:.1f}%; launches {launches}; card {card}")
        return first, wall, launches, dev_ms, busy

    # -- 75. H1 against its plain version; path BB: modes on the flagship ---
    bb_sim = simulation(dev, pin_boxes=top_pins)
    bobj, bpos = bb_sim.scene[0].obj, bb_sim.scene[0].state.pos
    res, wall, launches, dev_ms, busy = path(
        "BB (Chebyshev, flagship pinned over its top 1 %)",
        lambda: bb_sim.modes(k=6))
    rounds = modal.modal_analysis_chebyshev.last_rounds
    h1_bb = 41 + 152 * rounds
    require(launches == only(stiffness_apply=h1_bb),
            f"path BB: launches {launches} vs H1 41 + 152 x {rounds}")
    with SlotsVariant():
        res_s, wall_s, launches_s, dev_ms_s, busy_s = path(
            "BB on H1's slots variant", lambda: bb_sim.modes(k=6))
        last = h1.last_plan
    rounds_s = modal.modal_analysis_chebyshev.last_rounds
    require(last.variant == "slots" and rounds_s == rounds
            and launches_s == launches,
            f"path BB slots: {rounds_s} rounds, launches {launches_s}, last "
            f"plan {last}")
    require(torch.equal(res_s.omega_sq, res.omega_sq)
            and torch.equal(res_s.modes, res.modes),
            "path BB: ω² or modes differ between H1's variants")
    log(f"[path BB] the slots variant: ω² sha256 "
        f"{tensor_sha256(res_s.omega_sq)} (rows {tensor_sha256(res.omega_sq)}"
        f"), modes sha256 {tensor_sha256(res_s.modes)} (rows "
        f"{tensor_sha256(res.modes)}); {dev_ms_s:.4f} device ms against the "
        f"rows variant's {dev_ms:.4f}, wall {wall_s:.3f} s against {wall:.3f}")
    oracle = bb_sim.modes(k=6, method="sparse_f64")
    w, wo = res.omega_sq.double().cpu(), oracle.omega_sq.cpu()
    scale = float(wo[-1])
    rel = float((w - wo).abs().max()) / scale
    phi = res.modes.double()
    gram = torch.einsum("ind,n,jnd->ij", phi, bobj.mass.double(), phi)
    orth = float((gram - torch.eye(6, dtype=gram.dtype,
                                   device=dev)).abs().max())
    direct = modal.modal_residuals_f64(bobj, bpos, res).residuals.cpu()
    elastic = wo >= 0.1 * scale
    zero_counts()
    refined = bb_sim.modes(k=6, refine_f64=True)
    torch.cuda.synchronize()
    f64_launches = h1.variant_launches.get(("f64", 3), 0)
    log(f"[path BB] {int((bobj.free_mask == 0).sum())} pinned; {rounds} "
        f"rounds; ω² {w.tolist()}, sparse_f64 {wo.tolist()} (max diff "
        f"{rel:.3e} of ω²₆); f32 residuals {res.residuals.tolist()}; direct "
        f"f64 residuals {direct.tolist()}; refine_f64 residuals "
        f"{refined.residuals.tolist()} ({f64_launches} f64 launches); "
        f"M-orthonormal within {orth:.3e}")
    require(rel <= 1e-4, f"path BB: ω² off the sparse oracle by {rel}")
    require(orth <= 1e-3, f"path BB: M-orthonormal within {orth}")
    require(bool((direct[elastic] < 1e-3).all()),
            f"path BB: direct residuals {direct.tolist()}")
    require(refined.omega_sq.dtype == torch.float64 and f64_launches > 0
            and bool((refined.residuals < 1e-3).all()),
            f"path BB refine_f64: {refined.residuals.tolist()}, "
            f"{f64_launches} f64 launches")
    cpu_sim = simulation("cpu", pin_boxes=top_pins)
    two = modal.modal_analysis_chebyshev(bobj, bpos, k=6, rounds=2)
    two_cpu = modal.modal_analysis_chebyshev(
        cpu_sim.scene[0].obj, cpu_sim.scene[0].state.pos, k=6, rounds=2)
    two_err = float((two.omega_sq.cpu() - two_cpu.omega_sq).abs().max()
                    ) / float(two_cpu.omega_sq[-1])
    log(f"[path BB] 2 rounds from the same start: card {two.omega_sq.tolist()}"
        f", CPU {two_cpu.omega_sq.tolist()} (max diff {two_err:.3e} of ω²₆)")
    # Unconverged after 2 rounds, the upper Ritz values still move by
    # orders of magnitude a round, and the degree-150 filter carries the
    # card's and the CPU's f32 rounding apart: 1e-3 (2.7e-4 measured on
    # the H100).
    require(two_err <= 1e-3, f"path BB: 2 rounds off the CPU by {two_err}")
    free = free_sim.modes(k=8)
    fw = free.omega_sq.cpu()
    fscale = abs(float(fw[-1]))
    log(f"[path BB] the free flagship, k = 8: ω² {fw.tolist()}")
    require(bool((fw[:6].abs() < 1e-4 * fscale).all())
            and float(fw[6]) > 1e-2 * fscale,
            f"path BB: the free flagship's rigid modes {fw.tolist()}")
    line["BB"] = dict(rounds=rounds, launches=dict(H1=h1_bb), wall_s=wall,
                      device_ms=dev_ms, busy_pct=busy,
                      slots_variant=dict(wall_s=wall_s, device_ms=dev_ms_s,
                                         busy_pct=busy_s),
                      omega_sq=w.tolist(), sparse_f64=wo.tolist(),
                      rel_err=rel, residuals=res.residuals.tolist(),
                      direct_f64_residuals=direct.tolist(),
                      refine_f64_residuals=refined.residuals.tolist(),
                      two_round_cpu_err=two_err, free_omega_sq=fw.tolist(),
                      card=card)
    rows = [h1_row(torch, card, "flagship", bobj, bpos, h1_bb)]

    # -- 76. path BC: shift-invert on demo_hanging.json's body --------------
    hang = fem_tpu_torch.Simulation.from_config(
        os.path.join(REPO, "configs", "demo_hanging.json"), device=dev)
    res_c, wall, launches, dev_ms, busy = path(
        "BC (shift-invert, demo_hanging.json)",
        lambda: hang.modes(k=6, method="shift_invert"))
    steps = modal.modal_analysis.last_steps
    h1_bc = 32 + 400 * (1 + 2 * steps)
    require(launches == only(stiffness_apply=h1_bc),
            f"path BC: launches {launches} vs H1 32 + 400 x (1 + 2 x "
            f"{steps})")
    oc = hang.modes(k=6, method="sparse_f64").omega_sq.cpu()
    rel_c = float((res_c.omega_sq.double().cpu() - oc).abs().max()
                  ) / float(oc[-1])
    log(f"[path BC] {steps} LOBPCG steps; ω² {res_c.omega_sq.tolist()}, "
        f"sparse_f64 {oc.tolist()} (max diff {rel_c:.3e} of ω²₆)")
    require(rel_c <= 1e-4, f"path BC off the sparse oracle by {rel_c}")
    line["BC"] = dict(steps=steps, launches=dict(H1=h1_bc), wall_s=wall,
                      device_ms=dev_ms, busy_pct=busy, rel_err=rel_c,
                      card=card)
    hobj = hang.scene[0].obj
    rows.append(h1_row(torch, card, "demo_hanging.json", hobj,
                       hang.scene[0].state.pos, h1_bc))

    # -- 77. path BD: harmonic and response spectrum on BB's modes ----------
    cpu_modes = convert.modal_from_arrays(convert.modal_to_arrays(res),
                                          "cpu")
    rng = np.random.default_rng(0)
    f_hat = rng.normal(size=tuple(bpos.shape)).astype(np.float32)
    freqs = np.linspace(0.05, 2.0, HARMONIC_FREQS).astype(np.float32) * float(
        res.frequencies[-1])
    accel = rng.normal(size=SPECTRUM_SAMPLES).astype(np.float32)

    def analyses(simulation_, modes):
        hr = simulation_.harmonic(f_hat, freqs, modal=modes, zeta=0.02)
        rs = {c: simulation_.response_spectrum(accel, 1e-3, (1.0, 0.0, 0.0),
                                               modal=modes, combination=c)
              for c in ("cqc", "srss", "abssum")}
        return (hr.coeffs, hr.amplitude) + tuple(rs[c].peak for c in rs)

    got, wall, launches, dev_ms, busy = path(
        "BD (harmonic, response spectrum)", lambda: analyses(bb_sim, res))
    require(launches == only(), f"path BD: launches {launches}")
    ref = analyses(cpu_sim, cpu_modes)
    bd_err = max(float((a.cpu() - b).abs().max()) / float(b.abs().max())
                 for a, b in zip(got, ref))
    cqc, srss, abssum = got[2:]
    require(bd_err <= 1e-5, f"path BD off the CPU by {bd_err}")
    require(bool((abssum >= srss * (1 - 1e-6)).all()), "path BD: abssum < "
            "SRSS")
    log(f"[path BD] {HARMONIC_FREQS} frequencies, {SPECTRUM_SAMPLES} "
        f"samples: within {bd_err:.3e} of the CPU (of the largest entry); "
        f"peak CQC {float(cqc.max()):.4e}, SRSS {float(srss.max()):.4e}, "
        f"abssum {float(abssum.max()):.4e}")
    line["BD"] = dict(wall_s=wall, device_ms=dev_ms, busy_pct=busy,
                      cpu_rel_err=bd_err, card=card)

    # -- 78. path BE: buckling under gravity -------------------------------
    # As shipped (E 4e4) and pinned at its top or lowest 1 % (4 vertices),
    # the flagship sags by about its height under unit gravity and the
    # static base does not converge (a CPU rehearsal: 60 Newton
    # iterations); at E 4e6 over its lowest 5 % (18 vertices) the base is a
    # small deformation, reached in 2 iterations.
    low_pins = [[[-1e3, -1e3, -1e3], [1e3, lo + BUCKLE_PINS * (hi - lo),
                                      1e3]]]
    be_sim = simulation(dev, pin_boxes=low_pins, E=BUCKLE_E)
    eobj, epos = be_sim.scene[0].obj, be_sim.scene[0].state.pos
    g = tuple(be_sim.cfg.g_dir)
    zero_counts()
    with PlainGuard() as guard:
        base = solve_static(eobj, epos, g_dir=g)
        torch.cuda.synchronize()
    base_launches = counts()
    require(not guard.calls and set(k for k, v in base_launches.items()
                                    if v) <= {"stiffness_apply"},
            f"path BE base: launches {base_launches}, plain {guard.calls}")
    res_e, wall, launches, dev_ms, busy = path(
        "BE (buckling, gravity)",
        lambda: be_sim.buckling(k=4, gravity=True, base=base))
    rounds_e = buckling.linear_buckling.last_rounds
    require(launches == only(stiffness_apply=405 * rounds_e),
            f"path BE: launches {launches} vs H1 405 x {rounds_e}")
    hf = riks.make_element_hessian_fn(convert.to_dtype(eobj, torch.float64))
    n, d = epos.shape
    m = (d + 1) * d
    elem = eobj.element_indices.cpu().numpy().astype(np.int64)
    gdof = (elem[:, :, None] * d + np.arange(d)).reshape(-1, m)
    rr, cc = np.repeat(gdof, m, 1).ravel(), np.tile(gdof, (1, m)).ravel()

    def dense(p):
        k = np.zeros((n * d, n * d))
        np.add.at(k, (rr, cc), hf(p.double()).cpu().numpy().ravel())
        return k

    free = np.repeat(eobj.free_mask.cpu().numpy()[:, 0], d).astype(bool)
    k0 = dense(epos)[np.ix_(free, free)]
    kg = dense(base.pos)[np.ix_(free, free)] - k0
    mu0 = sla.eigh(kg, k0, eigvals_only=True, subset_by_index=[0, 0])[0]
    lam_cr, lam_oracle = float(res_e.load_factors[0]), -1.0 / mu0
    rel_e = abs(lam_cr - lam_oracle) / lam_oracle
    cpu_be = simulation("cpu", pin_boxes=low_pins, E=BUCKLE_E)
    cbase = base._replace(pos=base.pos.cpu())
    two_e = be_sim.buckling(k=4, gravity=True, base=base, rounds=2)
    two_ce = cpu_be.buckling(k=4, gravity=True, base=cbase, rounds=2)
    two_err_e = abs(float(two_e.load_factors[0])
                    - float(two_ce.load_factors[0])) / abs(
                        float(two_ce.load_factors[0]))
    log(f"[path BE] {int((eobj.free_mask == 0).sum())} pinned, E "
        f"{BUCKLE_E:g}; base: {int(base.iterations)} Newton iterations, "
        f"converged {bool(base.converged)}, H1 {base_launches['stiffness_apply']}"
        f"; {rounds_e} rounds; λ {res_e.load_factors.tolist()}, residuals "
        f"{res_e.residuals.tolist()}; dense f64 oracle λ_cr {lam_oracle:.6f} "
        f"({int(free.sum())} free DOFs; off by {rel_e:.3e}); 2 rounds card "
        f"{float(two_e.load_factors[0]):.6f}, CPU "
        f"{float(two_ce.load_factors[0]):.6f}")
    require(bool(base.converged) or bool(base.stalled),
            "path BE: the static base did not finish")
    require(rel_e <= 1e-3, f"path BE: λ_cr off the f64 oracle by {rel_e}")
    require(two_err_e <= 1e-3, f"path BE: 2 rounds off the CPU by "
            f"{two_err_e}")
    line["BE"] = dict(rounds=rounds_e, launches=dict(
        H1=405 * rounds_e, H1_base=base_launches["stiffness_apply"]),
        wall_s=wall, device_ms=dev_ms, busy_pct=busy, lam_cr=lam_cr,
        lam_oracle=lam_oracle, rel_err=rel_e, two_round_cpu_err=two_err_e,
        card=card)

    # -- 79. path BF: arc length on the arch, diagnostics on the flagship ---
    def arc(device):
        aobj, astate, crown = arch_object(np, torch, device)
        f = np.zeros(tuple(astate.pos.shape), np.float64)
        f[crown, 1] = -1.0 / len(crown)
        dx = riks._SparseTangent(convert.to_dtype(aobj, torch.float64)
                                 ).factor(astate.pos.double())(f)
        f = f * (0.10 * 0.06 / abs(float(np.mean(dx[crown, 1]))))
        return riks.arc_length_path(
            aobj, astate.pos, torch.as_tensor(f, device=astate.pos.device),
            n_steps=ARC_STEPS, dlam0=0.3, tol=1e-6, record_path=False)

    res_f, wall_f, launches, dev_ms_f, busy_f = path(
        "BF (arc length, the arch)", lambda: arc(dev))
    require(launches == only(), f"path BF arc: launches {launches}")
    ref_f = arc("cpu")
    lam_err = float((res_f.lam.cpu() - ref_f.lam).abs().max()) / float(
        ref_f.lam.abs().max())
    require(res_f.steps_taken == ref_f.steps_taken == ARC_STEPS
            and lam_err <= 1e-6, f"path BF: {res_f.steps_taken} steps, λ "
            f"off the CPU by {lam_err}")
    dstate = free_sim.scene[0].state
    got_d, wall_d, launches, dev_ms_d, busy_d = path(
        "BF (system_diagnostics, flagship)",
        lambda: tuple(torch.tensor(v) for v in diagnostics.system_diagnostics(
            free_sim.scene[0].obj, dstate, free_sim.cfg.delta_time)))
    require(launches == only(), f"path BF diagnostics: launches {launches}")
    cpu_free = simulation("cpu")
    ref_d = diagnostics.system_diagnostics(
        cpu_free.scene[0].obj, cpu_free.scene[0].state,
        cpu_free.cfg.delta_time)
    sym_err = abs(float(got_d[0]) - ref_d.symmetry_error) / max(
        ref_d.symmetry_error, 1e-30)
    margin_err = abs(float(got_d[2]) - ref_d.diag_dominance_margin) / abs(
        ref_d.diag_dominance_margin)
    log(f"[path BF] arc: λ {res_f.lam.tolist()}; CPU within {lam_err:.3e}; "
        f"diagnostics: symmetry {float(got_d[0]):.6e} (CPU "
        f"{ref_d.symmetry_error:.6e}), dominant {bool(got_d[1])}, margin "
        f"{float(got_d[2]):.6e} (CPU {ref_d.diag_dominance_margin:.6e})")
    require(sym_err <= 1e-5 and margin_err <= 1e-5
            and bool(got_d[1]) == ref_d.diagonally_dominant,
            f"path BF diagnostics off the CPU: {sym_err}, {margin_err}")
    line["BF"] = dict(arc_steps=res_f.steps_taken, arc_wall_s=wall_f,
                      arc_device_ms=dev_ms_f, arc_busy_pct=busy_f,
                      arc_cpu_err=lam_err, diag_wall_s=wall_d,
                      diag_device_ms=dev_ms_d, diag_busy_pct=busy_d,
                      card=card)
    zero_counts()
    return rows, line, time.perf_counter() - t_phase


def shard_sums_close(torch, label, parts, ref, rel=1e-6):
    """The ranks' partials ``parts`` summed in rank order against the
    unsharded ``ref``: within ``rel`` of its largest entry."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    err = float((total - ref).abs().max())
    top = float(ref.abs().max())
    require(top > 0 and err <= rel * top,
            f"{label}: the ranks' sum is off by {err} of {top}")
    return err / top


def run_sharding(torch, dev, zero_counts, counts, only, card):
    """Sections 80-82, element sharding (ROADMAP M20; no new kernel): BG
    the flagship through ``parallel/sharding.make_sharded_frame_fn`` on a
    one-rank NCCL group on the card against the single-device op-composed
    frame on the same blocked operator; BH the flagship's shards emulated
    in this process at 2, 4 and 8 ranks (K3, K2 on each rank's blocks; K1,
    K6 and H1 on each rank's element rows) against their plain versions
    and, summed in rank order, against the unsharded products; BI two
    ranks as two processes on the one card, gloo over CUDA tensors,
    against BG's positions.  Returns (the ``sharding_paths`` line's dict,
    phase seconds)."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from fem_tpu_torch import entry, sim
    from fem_tpu_torch.ops import assembly, blocked_kernels as bk
    from fem_tpu_torch.ops import element_kernels as ek
    from fem_tpu_torch.ops import stiffness_kernels as sk
    from fem_tpu_torch.ops.blocking import shard_blocking
    from fem_tpu_torch.parallel import sharding
    from fem_tpu_torch.parallel.launch import start_ranks
    from fem_tpu_torch.solvers import modal

    t_phase = time.perf_counter()
    frames = 3
    line = {}
    cfg, obj, state0, obstacles = entry.flagship(dev)
    start = entry.deformed(state0)
    sc = cfg.sim_count

    # -- 80. path BG ----------------------------------------------------------
    mesh = sharding.make_element_mesh(device=dev)
    require(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
            f"BG's group: {dist.get_backend()} x {dist.get_world_size()}")
    sharded = sharding.make_sharded_frame_fn(obj, cfg, mesh)
    single = sim.make_frame_fn(obj, dataclasses.replace(
        cfg, operator_mode="blocked"))

    def go(frame):
        def run():
            st, its = start, []
            for _ in range(frames):
                st, aux = frame(st, obstacles)
                its.append(aux.solver_iterations)
            return st, torch.cat(its)
        return run

    # One frame of each first: the first collective creates the NCCL
    # communicator (most of a second), which is set-up, not a frame.
    for frame in (sharded, single):
        frame(start, obstacles)
    torch.cuda.synchronize()
    calls0 = assembly.all_reduce_sum.calls
    (s_bg, it_bg), wall, launches, plain, (s_bg2, it_bg2), dev_ms, busy = \
        counted_then_profiled(torch, zero_counts, counts, go(sharded), frames)
    reduces = assembly.all_reduce_sum.calls - calls0
    iters = it_bg.cpu().tolist()
    k3_want = sum(3 + 2 * i for i in iters)
    log(f"[BG] sharded flagship, 1 NCCL rank, {frames} frames: CG "
        f"iterations {iters}; launches {launches}; all-reduces in the counted "
        f"run {reduces // 2} (K2 {launches['blocked_prep']} + K3 "
        f"{launches['blocked_matvec']}); plain calls {plain}")
    require(launches == only(blocked_prep=sc * frames, blocked_matvec=k3_want),
            f"BG launched {launches}, expected K2 {sc * frames} and K3 "
            f"{k3_want}")
    # counted_then_profiled runs the frames twice; each all-reduce once a
    # K2 force and once a K3 product.
    require(reduces == 2 * (sc * frames + k3_want),
            f"BG made {reduces} all-reduces in two runs, expected "
            f"{2 * (sc * frames + k3_want)}")
    require(not plain, f"BG called plain versions: {plain}")
    require(torch.equal(s_bg.pos, s_bg2.pos) and iters == it_bg2.cpu().tolist(),
            "BG's two runs differ")
    (s_one, it_one), wall_one, l_one, _, _, dev_one, busy_one = \
        counted_then_profiled(torch, zero_counts, counts, go(single), frames)
    err = float((s_bg.pos - s_one.pos).abs().max())
    log(f"[BG] single-device op-composed blocked frame: iterations "
        f"{it_one.cpu().tolist()}; positions within {err:.3e}")
    require(err <= 1e-5, f"BG's positions off the single-device frame by {err}")
    require(iters == it_one.cpu().tolist(), "BG's CG iterations differ from "
            f"the single-device frame's: {iters} vs {it_one.cpu().tolist()}")
    # One frame under the profiler with the host ops: the device's K2 and
    # K3 launches and the c10d all-reduces (NCCL launches no kernel for an
    # in-place all-reduce of one rank).  CUPTI drops some kernel records at
    # times (counted_window), so a window that lost one is taken again, up
    # to three; the all-reduces are host ops, recorded every one.
    best = None
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, aux = sharded(start, obstacles)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()]
        seen = dict(
            k2=sum("cluster_blocked_prep_kernel" in n for n in names),
            k3=sum("cluster_blocked_matvec_kernel" in n for n in names),
            c10d_all_reduce=sum(n == "c10d::allreduce_" for n in names),
            nccl_kernels=sum("nccl" in n.lower() and "kernel" in n.lower()
                             for n in names))
        it1 = aux.solver_iterations.cpu().tolist()
        want = dict(k2=sc, k3=sum(3 + 2 * i for i in it1))
        log(f"[BG] one frame under the profiler: {seen} (iterations {it1}, "
            f"expected K2 {want['k2']}, K3 {want['k3']}, an all-reduce each)")
        require(seen["c10d_all_reduce"] == want["k2"] + want["k3"],
                f"BG's profiler saw {seen['c10d_all_reduce']} all-reduces, "
                f"expected one a K2 and a K3 launch: "
                f"{want['k2'] + want['k3']}")
        for k in ("k2", "k3"):
            require(0 < seen[k] <= want[k], f"BG's profiler saw {seen[k]} "
                    f"{k} launches of {want[k]}")
        if best is None or seen["k2"] + seen["k3"] > best["k2"] + best["k3"]:
            best = seen
        if all(seen[k] == want[k] for k in ("k2", "k3")):
            break
    seen = best
    line["BG"] = dict(
        frames=frames, iterations=iters, launches=launches,
        all_reduces_per_frame=reduces / (2 * frames),
        profiler_one_frame=seen, device_ms_per_frame=dev_ms,
        busy_percent=busy, wall_ms_per_frame=1e3 * wall / frames,
        single_device=dict(device_ms_per_frame=dev_one, busy_percent=busy_one,
                           wall_ms_per_frame=1e3 * wall_one / frames,
                           launches=l_one),
        pos_err_vs_single=err, card=card)
    log(f"[BG] device {dev_ms:.4f} ms/frame, busy {busy:.1f}%, wall "
        f"{1e3 * wall / frames:.3f} ms/frame; single-device op-composed "
        f"blocked frame {dev_one:.4f} ms/frame, busy {busy_one:.1f}%, wall "
        f"{1e3 * wall_one / frames:.3f} ms/frame; card {card}")

    # -- 81. path BH ------------------------------------------------------------
    blk, pos = obj.blocking, start.pos
    x = start.vel + 0.3 * torch.randn(start.vel.shape, generator=torch.Generator(
        ).manual_seed(21)).to(dev)
    K, f = bk.blocked_prep_force(blk, pos, obj.mu, obj.s_lambda)
    y = bk.blocked_graph_apply(blk, K, x)
    cols = ek.explicit_grad_columns(pos, obj.element_indices, obj.ref_inv,
                                    obj.volume, obj.mu, obj.s_lambda)
    _, H = ek.hessian_and_force(pos, obj.element_indices, obj.ref_inv,
                                obj.volume, obj.mu, obj.s_lambda)
    w9 = torch.randn((obj.particle_cnt, 3, 9), generator=torch.Generator(
        ).manual_seed(9)).to(dev)
    h1_ref = modal.make_stiffness_hvp(obj, pos)(w9)
    f_ref = assembly.gather_assemble(assembly.element_contrib_full(H),
                                     obj.plan.idx)
    g_ref = assembly.gather_assemble(assembly.element_contrib_full(cols),
                                     obj.plan.idx)
    bh = {}
    for world in (2, 4, 8):
        ys, fs, hs, gs, h1s, ranks = [], [], [], [], [], []
        for rank in range(world):
            lb = shard_blocking(blk, rank, world)
            k_r, f_r = bk.blocked_prep_force(lb, pos, obj.mu, obj.s_lambda)
            k2_plan = bk.blocked_prep.last_plan
            k_p, f_p = bk.blocked_prep_force_plain(lb, pos, obj.mu,
                                                   obj.s_lambda)
            k_r2, f_r2 = bk.blocked_prep_force(lb, pos, obj.mu, obj.s_lambda)
            y_r = bk.blocked_graph_apply(lb, k_r, x)
            k3_plan = bk.blocked_graph_apply.last_plan
            y_p = bk.blocked_graph_apply_plain(lb, k_r, x)
            y_r2 = bk.blocked_graph_apply(lb, k_r, x)
            torch.cuda.synchronize()
            for label, got, ref in (("K2 f", f_r, f_p), ("K3", y_r, y_p)):
                e = float((got - ref).abs().max())
                require(e <= 1e-5 * max(float(ref.abs().max()), 1e-30),
                        f"BH {label} world {world} rank {rank}: error {e}")
            require(block_rel_err(k_r, k_p) <= 1e-5,
                    f"BH K2 K world {world} rank {rank}")
            require(torch.equal(k_r, k_r2) and torch.equal(f_r, f_r2)
                    and torch.equal(y_r, y_r2),
                    f"BH world {world} rank {rank}: two runs differ")
            k3_ms = kernel_ms(torch, lambda: bk.blocked_graph_apply(
                lb, k_r, x), 50, k3_kernel_names())
            ys.append(y_r)
            fs.append(f_r)
            local = sharding.shard_object(obj, rank, world, blocked=False)
            args = (pos, local.element_indices, local.ref_inv, local.volume,
                    obj.mu, obj.s_lambda)
            K1, H1r = ek.hessian_and_force(*args)
            K1p, H1p = ek.hessian_and_force_plain(*args)
            K1b, H1b = ek.hessian_and_force(*args)
            c6 = ek.explicit_grad_columns(*args)
            c6p = ek.explicit_grad_columns_plain(*args)
            c6b = ek.explicit_grad_columns(*args)
            kv = modal.make_stiffness_hvp(local, pos)
            h1 = kv(w9)
            h1p = sk.stiffness_apply_plain(kv.binding.jac, w9,
                                           kv.binding.element_indices,
                                           kv.binding.plan_idx)
            h1b = kv(w9)
            torch.cuda.synchronize()
            require(max(block_rel_err(K1, K1p), block_rel_err(H1r, H1p))
                    <= 1e-5, f"BH K1 world {world} rank {rank}")
            require(block_rel_err(c6, c6p) <= 1e-5,
                    f"BH K6 world {world} rank {rank}")
            e = float((h1 - h1p).abs().max())
            require(e <= 1e-6 * float(h1p.abs().max()),
                    f"BH H1 world {world} rank {rank}: error {e}")
            require(torch.equal(K1, K1b) and torch.equal(H1r, H1b)
                    and torch.equal(c6, c6b) and torch.equal(h1, h1b),
                    f"BH world {world} rank {rank}: K1/K6/H1 runs differ")
            hs.append(assembly.gather_assemble(
                assembly.element_contrib_full(H1r), local.plan.idx))
            gs.append(assembly.gather_assemble(
                assembly.element_contrib_full(c6), local.plan.idx))
            h1s.append(h1)
            ranks.append(dict(
                blocks=lb.num_blocks,
                real_blocks=int((lb.block_elements > 0).sum()),
                k3_variant=k3_plan.variant, k3_ctas=k3_plan.size,
                k2_variant=k2_plan.variant, k2_ctas=k2_plan.size,
                k3_ms=k3_ms, elements=local.element_cnt))
        errs = dict(
            k3=shard_sums_close(torch, f"BH K3 at {world}", ys, y),
            k2=shard_sums_close(torch, f"BH K2 at {world}", fs, f),
            k1=shard_sums_close(torch, f"BH K1 at {world}", hs, f_ref),
            k6=shard_sums_close(torch, f"BH K6 at {world}", gs, g_ref),
            h1=shard_sums_close(torch, f"BH H1 at {world}", h1s, h1_ref))
        bh[world] = dict(ranks=ranks, sum_rel_err=errs)
        log(f"[BH] {world} ranks: " + "; ".join(
            f"rank {r}: {d['blocks']} blocks ({d['real_blocks']} real), K3 "
            f"{d['k3_variant']} of {d['k3_ctas']} CTAs {d['k3_ms']:.5f} ms"
            for r, d in enumerate(ranks))
            + f"; the ranks' sums off the unsharded by {errs} (relative); "
            f"card {card}")
    bh["unsharded_k3_ms"] = kernel_ms(
        torch, lambda: bk.blocked_graph_apply(blk, K, x), 50,
        k3_kernel_names())
    log(f"[BH] unsharded K3 {bh['unsharded_k3_ms']:.5f} ms; card {card}")
    line["BH"] = bh

    # -- 82. path BI ------------------------------------------------------------
    t_bi = time.perf_counter()
    results = start_ranks(entry.sharded_flagship_rank, 2, args=(frames,),
                          backend="gloo", timeout=400).results()
    for r, res in enumerate(results):
        log(f"[BI] rank {r} ({res['backend']}): all-reduce of a CUDA tensor "
            f"{res['probe'].tolist()}; iterations {res['iterations'].tolist()}"
            f"; K2 {res['k2']}, K3 {res['k3']}")
        require(res["probe"].tolist() == [3.0] * 4,
                f"BI rank {r}: gloo's all-reduce of a CUDA tensor gave "
                f"{res['probe'].tolist()}")
        require(all(abs(a - b) <= 1 for a, b in zip(
            res["iterations"].tolist(), iters)),
            f"BI rank {r}: iterations {res['iterations'].tolist()} vs BG's "
            f"{iters}")
        require(res["k2"] > 0 and res["k3"] > 0, f"BI rank {r} launched no "
                "K2 or K3")
    bi_err = float(np.abs(results[0]["pos"] - s_bg.pos.cpu().numpy()).max())
    require(np.array_equal(results[0]["pos"], results[1]["pos"]),
            "BI's two ranks hold different positions")
    require(bi_err <= 1e-5, f"BI's positions off BG's by {bi_err}")
    line["BI"] = dict(ranks=2, backend=results[0]["backend"],
                      pos_err_vs_bg=bi_err,
                      k2=[r["k2"] for r in results],
                      k3=[r["k3"] for r in results],
                      iterations=results[0]["iterations"].tolist(),
                      wall_s=time.perf_counter() - t_bi)
    log(f"[BI] 2 gloo ranks on the card: positions within {bi_err:.3e} of "
        f"BG's, the ranks bit-identical (a correctness check: no time is "
        f"reported)")
    dist.destroy_process_group()
    return line, time.perf_counter() - t_phase


def launch_counters():
    """(zero_counts, counts, instances, only) over every kernel wrapper's
    launch count (the closures each path's checks use)."""
    from fem_tpu_torch.experiments import edge_cg, fused_frame
    from fem_tpu_torch.ops import (
        advect_kernels,
        blocked_kernels,
        cg_kernels,
        element_kernels,
        frame_kernels,
        jacobi_kernels,
        stiffness_kernels,
    )
    from fem_tpu_torch.ops import contact_kernels
    from fem_tpu_torch.probes import int8, pairblock

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
        "blocked_edges": blocked_kernels.blocked_edges,
        "hessian_blocks": element_kernels.hessian_blocks,
        "implicit_force": element_kernels.implicit_force_columns,
        "kinematic": advect_kernels.kinematic,
        "advect_implicit": advect_kernels.advect_implicit,
        "edge_cg": edge_cg.cg_solve_edge,
        "fused_frame": fused_frame.fused_frame,
        "paired_matvec": pairblock.paired_matvec,
        "chained_dot": int8.chained_dot,
        "jacobi_serial": jacobi_kernels.jacobi_serial,
        "contact_pairs": contact_kernels.pair_forces,
        "contact_grid": contact_kernels.grid_pair_forces,
        "stiffness_apply": stiffness_kernels.stiffness_apply,
    }

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0
            if hasattr(fn, "instance_launches"):
                fn.instance_launches = {}
        frame_kernels.fused_blocked_frame.variant_launches = {}
        frame_kernels.fused_explicit_frame.variant_launches = {}
        cg_kernels.fused_cg_solve.variant_launches = {}
        fused_frame.fused_frame.variant_launches = {}
        blocked_kernels.blocked_graph_apply.variant_launches = {}
        blocked_kernels.blocked_prep.variant_launches = {}
        blocked_kernels.blocked_grad_prep.variant_launches = {}
        blocked_kernels.blocked_assemble.variant_launches = {}
        edge_cg.cg_solve_edge.variant_launches = {}
        jacobi_kernels.jacobi_serial.variant_launches = {}
        contact_kernels.pair_forces.variant_launches = {}
        contact_kernels.grid_pair_forces.variant_launches = {}
        stiffness_kernels.stiffness_apply.variant_launches = {}

    def counts():
        """The launch counts since the last zero_counts(); K5's, K8's, K4's,
        K3's, K2's, K7b's, K7a's and K11a's launches on a path are all of
        their cluster variants (each mesh of the paths fits one cluster),
        logged by (variant, CTAs); so are C1's; C2's are all of its warp
        variant, and J1's launches are logged by variant."""
        for name, fn, other in (
                ("K5", frame_kernels.fused_blocked_frame, "grid"),
                ("K8", frame_kernels.fused_explicit_frame, "grid"),
                ("K4", cg_kernels.fused_cg_solve, "single"),
                ("K3", blocked_kernels.blocked_graph_apply, "grid"),
                ("K2", blocked_kernels.blocked_prep, "grid"),
                ("K7b", blocked_kernels.blocked_grad_prep, "grid"),
                ("K7a", blocked_kernels.blocked_assemble, "grid"),
                ("K11a", edge_cg.cg_solve_edge, "single")):
            by = fn.variant_launches
            if by:
                log(f"[{name} variant] launches by (variant, CTAs): {by}")
                require(all(v == "cluster" for v, _ in by),
                        f"{name} ran the {other} variant on a path: {by}")
        by = contact_kernels.pair_forces.variant_launches
        if by:
            log(f"[C1 variant] launches by (variant, CTAs): {by}")
            require(all(v == "cluster" for v, _ in by),
                    f"C1 ran the rows variant on a path: {by}")
        by = contact_kernels.grid_pair_forces.variant_launches
        if by:
            log(f"[C2 variant] launches by variant: {by}")
            require(set(by) == {"warp"},
                    f"C2 ran the thread variant on a path: {by}")
        if jacobi_kernels.jacobi_serial.variant_launches:
            log(f"[J1 variant] launches by variant: "
                f"{jacobi_kernels.jacobi_serial.variant_launches}")
        if stiffness_kernels.stiffness_apply.variant_launches:
            log(f"[H1 instance] launches by (dtype, d): "
                f"{stiffness_kernels.stiffness_apply.variant_launches}")
        return {k: fn.launches for k, fn in counters.items()}

    def instances():
        """{(counter, dimension, material id[, inelastic]): launches} since
        the last zero_counts()."""
        return {(k,) + key: n for k, fn in counters.items()
                for key, n in getattr(fn, "instance_launches", {}).items()}

    def only(**launched):
        """The launch counts of a run that launched ``launched`` and no
        other kernel."""
        return {k: launched.get(k, 0) for k in counters}

    return zero_counts, counts, instances, only


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
        advect_kernels,
        blocked_kernels,
        cg_kernels,
        element_kernels,
        frame_kernels,
        jacobi_kernels,
    )
    from fem_tpu_torch.experiments import edge_cg, fused_frame
    from fem_tpu_torch.probes import int8, pairblock
    from fem_tpu_torch.solvers import explicit
    from fem_tpu_torch.utils import cuda_build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    zero_counts, counts, instances, only = launch_counters()

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
    for name, (wall, cpu) in sorted(cuda_build.BUILD_SECONDS.items(),
                                    key=lambda kv: -kv[1][0]):
        log(f"[build] {name}: done {wall:.1f} s after the build's start, "
            f"{cpu:.1f} s of nvcc CPU time")
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
    log(f"[K1] block-relative error {k1_rel:.3e}, max abs error {k1_abs:.3e}"
        f"; plan {plan_text(element_kernels.hessian_and_force)}")
    require(k1_rel <= 1e-5, f"K1 block-relative error {k1_rel}")
    K_again, H_again = element_kernels.hessian_and_force(*k1_args)
    require(torch.equal(K, K_again) and torch.equal(H, H_again),
            "K1 runs differ")
    ragged = {3: check_ragged(torch, "3D", obj, state)}

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
        keys = k3_plan_keys()
        require((keys["variant"], keys["ctas"]) == ("cluster", 16),
                f"K3's plan on the flagship: {keys}")
        yp = blocked_kernels.blocked_graph_apply_plain(blk, Kb, noisy, tr)
        y2 = blocked_kernels.blocked_graph_apply(blk, Kb, noisy, tr)
        yg = blocked_kernels.blocked_graph_apply(blk, Kb, noisy, tr,
                                                 grid=True)
        yg2 = blocked_kernels.blocked_graph_apply(blk, Kb, noisy, tr,
                                                  grid=True)
        torch.cuda.synchronize()
        err = float((y - yp).abs().max())
        gerr = float((yg - yp).abs().max())
        k3_abs = max(k3_abs, err, gerr)
        top = float(yp.abs().max())
        log(f"[K3] transpose_k={int(tr)}: cluster variant {keys}: max abs "
            f"error {err:.3e} of max {top:.3e}; two-kernel variant "
            f"{gerr:.3e}")
        require(top > 0 and err <= 1e-5 * top and gerr <= 1e-5 * top,
                f"K3 error {err} (two kernels {gerr}) of {top}")
        require(torch.equal(y, y2) and torch.equal(yg, yg2), "K3 runs differ")
        require(torch.equal(y, yg), "K3's cluster variant differs from its "
                "two-kernel variant")
    log("[K2/K3] two runs bit-identical; K3's variants bit-identical")

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
    log(f"[K6] block-relative error {k6_rel:.3e}, max abs error {k6_abs:.3e}"
        f"; plan {plan_text(element_kernels.explicit_grad_columns)}")
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
    force_errs = check_force_forms(torch, "3D", blk, state.pos, obj.mu,
                                   obj.s_lambda, Kb, part, gpart, bcols)
    k2_abs = max(k2_abs, force_errs["blocked_prep"])
    k7b_abs = max(k7b_abs, force_errs["blocked_grad_prep"])

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
    # A warm-up substep, not counted: K4 plans its cluster on the host at
    # its first call on a mesh.
    fn(obj_c, state_c, obs_c)
    torch.cuda.synchronize()
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

    # -- 21.-26. inelastic materials: the kernels and paths M-Q -------------
    t_in = time.perf_counter()
    ine = run_inelastic(torch, dev, zero_counts, counts, only)
    log(f"[inelastic] sections 21-26 in {time.perf_counter() - t_in:.1f} s")

    # -- 27.-33. materials: the instances and paths R-V -----------------------
    t_mat = time.perf_counter()
    mat = run_materials(torch, dev, zero_counts, counts, only, instances)
    log(f"[materials] sections 27-33 in {time.perf_counter() - t_mat:.1f} s")
    expected = [(name, d, mid) + ((inel,) if frames else ())
                for d in (2, 3)
                for name, (has_robust, frames) in MATERIAL_KERNELS.items()
                for mid in range(1, 8) if mid != 7 or has_robust
                for inel in ((False, True) if frames and mid != 7
                             else (False,))]
    for key in expected:
        require(mat["launches"].get(key, 0) > 0,
                f"instance {key} never launched on paths R-V")
        require(key in mat["errors"], f"instance {key} never checked")

    # -- 34.-40. implicit extensions: the kernels and paths W-Z', AD --------
    t_ext = time.perf_counter()
    ext = run_extensions(torch, dev, zero_counts, counts, only)
    log(f"[extensions] sections 34-40 in {time.perf_counter() - t_ext:.1f} s")

    # -- 41. times and bounds -----------------------------------------------
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
    for label, frame_fns, start, obs, frames in (two["windows"]
                                                 + ine["windows"]
                                                 + mat["windows"]
                                                 + ext["windows"]):
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
    def k5_l():
        return frame_kernels.fused_blocked_frame(
            *largs, lstate.vel_g, *lcirc, preconditioned=True,
            **two["l_kw"]["implicit"])

    l_keys = k5_plan_keys(k5_l()[3].tolist())
    times2["blocked_frame"]["plan_40_subdivisions"] = l_keys
    def k8_l():
        return frame_kernels.fused_explicit_frame(
            *largs, *lcirc, **two["l_kw"]["explicit"])

    k8_l()
    l8_keys = k8_plan_keys(False, two["l_kw"]["explicit"]["sim_count"])
    times2["explicit_frame"]["plan_40_subdivisions"] = l8_keys
    for name, kernel, key, keys in (
        ("blocked_frame", k5_l, k5_kernel_name(), l_keys),
        ("explicit_frame", k8_l, k8_kernel_name(), l8_keys),
    ):
        ms = kernel_ms(torch, kernel, FRAMES_L, [key])
        times2[name]["ms_40_subdivisions"] = ms
        log(f"[time] 2D {name} at 40 subdivisions ({lblk.num_blocks} "
            f"blocks): {ms:.5f} ms a frame on the device (profiler); "
            f"{keys} card {card}")

    ragged[2] = two["errors"].pop("ragged")
    for d, times, launches, errors in ((3, times3, launches3, errors3),
                                       (2, times2, two["launches"],
                                        two["errors"])):
        times.update(time_inelastic_kernels(torch, d, ine["timing"][d]))
        times.update(time_extension_kernels(torch, d, ext["timing"][d]))
        launches.update(ine["launches"][d])
        launches.update(ext["launches"][d])
        errors.update(ine["errors"][d])
        errors.update(ext["errors"][d])
        # Each row's error also over section 3's and 15's ragged cuts.
        for key, err in ragged[d].items():
            into = mat["errors"] if isinstance(key, tuple) else errors
            into[key] = max(into[key], err)
    kernels = (kernel_rows(3, times3, launches3, errors3, card)
               + kernel_rows(2, times2, two["launches"], two["errors"], card))
    sources = {name: (source, replaces) for name, source, replaces in KERNELS}
    for d in (3, 2):
        mtimes = time_material_kernels(torch, d, mat["timing"],
                                       [k for k in expected if k[1] == d])
        for key, t in mtimes.items():
            name = key[0] + ("_inelastic" if len(key) > 3 and key[3] else "")
            material, robust = mat["labels"][key]
            log(f"[time] {d}D {name} {instance_name(material, robust)} "
                f"{t['ms']:.5f} ms a launch on the device (profiler); plain "
                f"{t['plain_ms']:.4f} ms; bound {t['bound_ms']:.6f} ms "
                f"({t['bound_by']}); launches {mat['launches'][key]}; card "
                f"{card}")
            kernels.append(dict(
                name=name, route="cuda", source=sources[name][0],
                replaces=sources[name][1], dim=d, material=material,
                robust=robust, launches=mat["launches"][key],
                max_abs_err=mat["errors"][key], **t))
    # -- 42.-47. the last four kernels: K11a, K11b, P1, P2 ------------------
    last_rows, last_s = run_last_kernels(torch, dev, zero_counts, counts,
                                         only, card)
    kernels.extend(last_rows)
    log(f"[last kernels] sections 42-47 in {last_s:.1f} s")

    # -- 48. K5's variants against the plain frame ---------------------------
    t_var = time.perf_counter()
    gen_l = torch.Generator().manual_seed(4)
    variant_rows = run_k5_variants(torch, card, (
        ("flagship", obj, state, obstacles, frame_kw),
        ("default.json", two["obj"], two["state"], two["obstacles"],
         two["frame_kw"]),
        ("40 subdivisions", lobj, squeezed_2d(torch, lstate, gen_l), lobs,
         two["l_kw"]["implicit"])))
    log(json.dumps({"k5_variants": variant_rows}))
    log(f"[K5 variants] section 48 in {time.perf_counter() - t_var:.1f} s")

    # -- 49. K8's variants against the plain frame ---------------------------
    from fem_tpu_torch import scene
    from fem_tpu_torch.utils.config import read_config

    t_var = time.perf_counter()
    pcfg = read_config(os.path.join(REPO, "configs", "demo_plastic.json"))
    pbodies, pobs = scene.load_scene(pcfg, device=dev)
    plastic_cases = []
    for i, pbody in enumerate(pbodies):
        po, ps = pbody.obj, pbody.state
        pkw = dict(dt=pcfg.delta_time, damping=po.damping,
                   g_dir=tuple(pcfg.g_dir), mu=po.mu, s_lambda=po.s_lambda,
                   sim_count=pcfg.sim_count, material=po.material,
                   **sim._internal_kwargs(po, ps))
        plastic_cases.append((f"demo_plastic.json body {i}", po,
                              squeezed_2d(torch, ps, gen_l), pobs, pkw))
    k8_rows = run_k8_variants(torch, card, (
        ("flagship", eobj, estate, eobs, ekw),
        ("default.json", two["obj"], two["state"], two["obstacles"],
         two["frame_kw"]),
        ("40 subdivisions", lobj, squeezed_2d(torch, lstate, gen_l), lobs,
         two["l_kw"]["explicit"]),
        *plastic_cases))
    log(json.dumps({"k8_variants": k8_rows}))
    log(f"[K8 variants] section 49 in {time.perf_counter() - t_var:.1f} s")

    # -- 50. K4's variants against the plain solve ---------------------------
    t_var = time.perf_counter()
    k4_rows = run_k4_variants(torch, card, (
        ("flagship", obj, state, cfg.delta_time),
        ("default.json", two["obj"], two["state"], two["frame_kw"]["dt"])))
    log(json.dumps({"k4_variants": k4_rows}))
    log(f"[K4 variants] section 50 in {time.perf_counter() - t_var:.1f} s")

    # -- 51. K3's variants against the plain apply ---------------------------
    t_var = time.perf_counter()
    k3_cases = []
    for label, o, st in (("flagship", obj, state),
                         ("default.json", two["obj"], two["state"]),
                         ("40 subdivisions", lobj, lstate)):
        kb, _ = blocked_kernels.blocked_prep(o.blocking, st.pos, o.mu,
                                             o.s_lambda)
        xv = st.vel + 0.3 * torch.randn(
            st.vel.shape, generator=torch.Generator().manual_seed(9)).to(dev)
        k3_cases.append((label, o.blocking, kb, xv))
    k3_rows = run_k3_variants(torch, card, k3_cases)
    log(json.dumps({"k3_variants": k3_rows}))
    log(f"[K3 variants] section 51 in {time.perf_counter() - t_var:.1f} s")

    # -- 52. K2's, K7b's, K7a's and K7b edges' variants ----------------------
    t_var = time.perf_counter()
    # The 40-subdivision grid squeezed: at its rest state the force and
    # gradient are rounding noise.
    prep_rows = run_prep_variants(torch, card, (
        ("flagship", obj, state), ("default.json", two["obj"], two["state"]),
        ("40 subdivisions", lobj, squeezed_2d(
            torch, lstate, torch.Generator().manual_seed(10)))))
    log(json.dumps({"prep_variants": prep_rows}))
    log(f"[prep variants] section 52 in {time.perf_counter() - t_var:.1f} s")

    # -- 53.-58. J1 and the Jacobi paths AH-AK ---------------------------------
    j1_rows, j1_s = run_jacobi(torch, dev, zero_counts, counts, only, card)
    kernels.extend(j1_rows)
    log(f"[jacobi] sections 53-58 in {j1_s:.1f} s")

    # -- 59.-61. the CLI, the API and the guard: paths AL-AN -----------------
    entry_line, entry_s = run_entry_points(torch, dev, zero_counts, counts,
                                           only, card)
    log(json.dumps({"entry_paths": entry_line}))
    log(f"[entry points] sections 59-61 in {entry_s:.1f} s")

    # -- 62.-66. contact: C1, C2 and paths AO-AS -----------------------------
    contact_rows, contact_line, contact_s = run_contact(
        torch, dev, zero_counts, counts, only, card)
    kernels.extend(contact_rows)
    log(json.dumps({"contact_paths": contact_line}))
    log(f"[contact] sections 62-66 in {contact_s:.1f} s")

    # -- 67.-71. Newton, the two-level PCG and the static solve: AT-AX -------
    newton_line, newton_s = run_newton(torch, dev, zero_counts, counts, only,
                                       card)
    log(json.dumps({"newton_paths": newton_line}))
    log(f"[newton] sections 67-71 in {newton_s:.1f} s")

    # -- 72.-74. differentiable rollouts: AY-BA -------------------------------
    diff_line, diff_s = run_diff(torch, dev, zero_counts, counts, only, card)
    log(json.dumps({"diff_paths": diff_line}))
    log(f"[diff] sections 72-74 in {diff_s:.1f} s")
    for r in kernels:
        if r["name"] == "blocked_matvec" and r.get("dim") == 3:
            r["ay_launches"] = diff_line["AY"]["launches"]["K3"]

    # -- 75.-79. the analysis solvers and H1: BB-BF ---------------------------
    h1_rows, analysis_line, analysis_s = run_analysis(
        torch, dev, zero_counts, counts, only, card)
    kernels.extend(h1_rows)
    analysis_line["AX"] = dict(
        device_ms=newton_line["AX"]["device_ms_per_solve"],
        wall_s=newton_line["AX"]["wall_s"], card=card)
    log(json.dumps({"analysis_paths": analysis_line}))
    log(f"[analysis] sections 75-79 in {analysis_s:.1f} s")

    # -- 80.-82. element sharding: BG-BI ----------------------------------
    sharding_line, sharding_s = run_sharding(torch, dev, zero_counts, counts,
                                             only, card)
    log(json.dumps({"sharding_paths": sharding_line}))
    log(f"[sharding] sections 80-82 in {sharding_s:.1f} s")
    for name in [k for k, _, _ in KERNELS] + ["contact_pairs",
                                              "contact_grid"]:
        for d in (2, 3):
            require(any(r["name"] == name and r.get("dim") == d
                        for r in kernels), f"no {d}D row of {name}")
    for r in contact_rows:
        require(r["launches"] > 0, f"{r['name']} {r['shapes']}: no launch "
                "on its path")
    log(f"[total] chip_smoke wall time {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
