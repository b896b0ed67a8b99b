# coding=utf-8
"""fem_tpu_torch — the PyTorch/CUDA port of the FEM framework.

A second package beside the JAX one (which stays the reference): the same
JSON config schema and reference semantics, with every TPU kernel on the
ported path rewritten by hand in CUDA C++ for Hopper (``csrc/``).  The ported
slices cover the flagship implicit-CG path — the whole frame in one kernel
over locality blocks (``make_frame_fn``), the blocked operator
(``operator_mode="blocked"``) and the substep's element chain and whole CG
solve — and the explicit and autodiff path: the whole explicit frame in one
kernel, and the substep's gradient through the blocked prep, the blocked
assembly or the per-tet gradient columns — for every material, inelastic
and robust, and with the implicit extensions (pins, loads, Rayleigh β,
typed SDF obstacles, block-Jacobi PCG, the exact Hessian) on the
op-composed frame — and the adaptive-dt guard over K2 and K5, with the
entry points users call: ``Simulation`` (``api.py``), the CLI
(``python -m fem_tpu_torch.main``), checkpoints, metrics, the NaN guard,
rendering and OBJ/VTU export — and body-body penalty contact
(``contact.py``, ``broadphase.py``: the pair forces and the grid's narrow
phase as hand-written kernels) and batched ensembles (``batch.py``) — and
the Newton integrator, the two-level preconditioner and the quasi-static
solve (``solvers/newton.py``, ``multilevel.py``, ``static.py``), over the
blocked kernels — and differentiable rollouts (``diff.py``: gradients
through whole trajectories, the implicit solve's adjoint a
``torch.autograd.Function`` over the blocked operator) — and the analysis
solvers (``solvers/modal.py``, ``buckling.py``, ``harmonic.py``,
``spectrum.py``, ``riks.py``, ``diagnostics.py``), their exact stiffness
products one hand-written kernel each (``ops/stiffness_kernels.py``).
CUDA kernels run on a GPU, their plain PyTorch versions on the CPU.  The package imports nothing of
the JAX package.

Precision: all math is float32, as in the JAX package (the analyses'
float64 paths aside).  Importing the package
turns TF32 off for matmuls and cuDNN and sets
``torch.set_float32_matmul_precision("highest")`` — the counterpart of the JAX
package's HIGHEST-precision pin — so that no float32 product in the process
silently rounds its inputs to 10 mantissa bits.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from fem_tpu_torch.api import Simulation  # noqa: E402
from fem_tpu_torch.batch import make_batched_frame_fn  # noqa: E402
from fem_tpu_torch.contact import make_contact_frame_fn  # noqa: E402
from fem_tpu_torch.diff import (  # noqa: E402
    DiffParams,
    lame_from_young,
    make_diff_rollout_fn,
    make_diff_substep_fn,
    params_from_object,
    trajectory_loss_fn,
)
from fem_tpu_torch.models.state import (  # noqa: E402
    FemObject,
    Obstacles,
    SimState,
    build_object,
)
from fem_tpu_torch.sim import (  # noqa: E402
    StepAux,
    make_frame_fn,
    make_substep_fn,
    substep,
)
from fem_tpu_torch.utils.config import (  # noqa: E402
    BlockConfig,
    ObjectConfig,
    SimConfig,
    parse_config,
    read_config,
)

__version__ = "0.1.0"

__all__ = [
    "BlockConfig",
    "DiffParams",
    "FemObject",
    "ObjectConfig",
    "Obstacles",
    "SimConfig",
    "SimState",
    "Simulation",
    "StepAux",
    "build_object",
    "lame_from_young",
    "make_batched_frame_fn",
    "make_contact_frame_fn",
    "make_diff_rollout_fn",
    "make_diff_substep_fn",
    "make_frame_fn",
    "make_substep_fn",
    "params_from_object",
    "parse_config",
    "read_config",
    "substep",
    "trajectory_loss_fn",
    "__version__",
]
