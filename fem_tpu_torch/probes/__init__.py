# coding=utf-8
"""Probes: the counterparts of the JAX package's ``tools/probe_*.py``.

Each asks one hardware question with a kernel of its own and answers it
with times on the card: ``pairblock`` (P1) whether several locality blocks
per thread block hide the blocked operator's latency, ``int8`` (P2) whether
a ±1 table streams faster through the tensor cores as int8 than as bf16.
Run each as a module on a machine with a CUDA device
(``python -m fem_tpu_torch.probes.pairblock``,
``python -m fem_tpu_torch.probes.int8``); their plain versions run on the
CPU for the tests.
"""
