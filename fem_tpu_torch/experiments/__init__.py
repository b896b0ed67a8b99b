# coding=utf-8
"""Alternatives kept beside the live package, as in the JAX package.

The counterparts of the JAX package's ``experiments/``, which it keeps as
measured, tested alternatives to the blocked kernels:

* ``fused_frame`` — the whole frame over the UNblocked mesh (K11b),
  reachable via ``frame_backend="fused"``;
* ``edge_cg`` — the whole CG over the edge-matrix operator S (K11a),
  called only by the tests and ``chip_smoke.py``.

Kept for their tests and as a record; neither is on any ``"auto"``
execution path.  Their times on the card are in PERF.md.
"""
