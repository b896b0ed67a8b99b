# coding=utf-8
"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and its entry points run on CUDA unless the caller asks for the CPU."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import fem_tpu_torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "fem_tpu_torch")


def _modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages(
            fem_tpu_torch.__path__, prefix="fem_tpu_torch."
        )
    )


def test_every_module_imports_without_jax():
    mods = _modules()
    for name in ("ops.cg_kernels", "experiments.edge_cg",
                 "experiments.fused_frame", "probes.pairblock",
                 "probes.int8"):
        assert f"fem_tpu_torch.{name}" in mods, name
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'fem_tpu' or k.startswith('fem_tpu.'))\n"
        "print(repr(bad))\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300, check=True,
    )
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


_FORBIDDEN = re.compile(r"import jax|from jax|fem_tpu\b(?!_torch)")


def test_no_source_names_jax_or_the_jax_package():
    offenders = []
    for root, _, files in os.walk(PKG):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            with open(path, encoding="utf-8") as f:
                for i, line in enumerate(f, 1):
                    if _FORBIDDEN.search(line):
                        offenders.append(f"{path}:{i}: {line.strip()}")
    assert not offenders, "\n".join(offenders)


def test_precision_pinned_at_import():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize(
    "call",
    ["flagship", "entry", "build_object", "obstacles", "object_from_arrays",
     "simulation", "cli"],
)
def test_entry_points_default_to_cuda(call):
    """Without a GPU every entry point raises unless given device='cpu'."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    import numpy as np

    import fem_tpu_torch.main
    from fem_tpu_torch import convert, entry
    from fem_tpu_torch.models.state import Obstacles, build_object
    from fem_tpu_torch.utils.config import BlockConfig, ObjectConfig

    cfg = ObjectConfig(center=(0.0, 0.0, 0.0))
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    tets = np.array([[0, 1, 2, 3]], np.int32)
    calls = {
        "flagship": lambda: entry.flagship(),
        "entry": lambda: entry.entry(),
        "build_object": lambda: build_object(cfg, verts, tets[:, :3], tets),
        "obstacles": lambda: Obstacles.from_configs((BlockConfig(),), 2),
        "object_from_arrays": lambda: convert.object_from_arrays({}, {}),
        "simulation": lambda: fem_tpu_torch.Simulation.from_config(
            os.path.join(REPO, "configs", "default.json")),
        "cli": lambda: fem_tpu_torch.main.run(
            ["--config", os.path.join(REPO, "configs", "default.json"),
             "--frames", "1", "--no-render"]),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[call]()


def test_unported_features_raise():
    import dataclasses

    from fem_tpu_torch.models.state import check_supported_object
    from fem_tpu_torch.sim import check_supported_config
    from fem_tpu_torch.utils.config import ObjectConfig, SimConfig

    base = SimConfig(
        dim=3, use_explicit_method=False, implicit_method=1,
        g_dir=(0.0, -1.0, 0.0),
    )
    check_supported_config(base)
    # Explicit and autodiff configs run; the implicit solver's options do
    # not apply to them (the reference's headline configs/default.json
    # pairs auto_diff with implicit_method=0).
    for change in (
        dict(use_explicit_method=True), dict(auto_diff=True),
        dict(auto_diff=True, implicit_method=0, robust_inversion=True),
    ):
        check_supported_config(dataclasses.replace(base, **change))
    # robust_inversion runs since ROADMAP M11; typed obstacles, wall
    # friction, block-Jacobi PCG and the exact Hessian since M13.
    from fem_tpu_torch.utils.config import ObstacleConfig

    # The Jacobi solver and the dense backend run since M10, the adaptive-dt
    # guard since M15, penalty contact since M17, the Newton integrator and
    # the two-level preconditioner since M16.
    for change in (
        dict(robust_inversion=True), dict(cg_precond="block_jacobi"),
        dict(hessian="exact_jvp"), dict(wall_friction=0.3),
        dict(implicit_method=0), dict(solver_backend="dense"),
        dict(implicit_method=0, jacobi_sweep="snapshot",
             solver_backend="dense"),
        dict(obstacles=(ObstacleConfig(type="halfspace", point=(0, 0, 0),
                                       normal=(0, 1, 0)),)),
        dict(adaptive_dt=True),
        dict(contact="penalty"), dict(contact="penalty", self_contact=True),
        dict(integrator="newton"), dict(cg_precond="two_level"),
    ):
        check_supported_config(dataclasses.replace(base, **change))
    # The analysis solvers run since M19, sharded=True since M20 (a
    # one-rank gloo group here); cg_fast_math stays refused.
    from fem_tpu_torch import Simulation

    sim = Simulation(base, sharded=True, device="cpu")
    assert len(sim._frame_fns) == len(sim.scene) == 1
    with pytest.raises(NotImplementedError, match="cg_fast_math"):
        check_supported_config(dataclasses.replace(base, cg_fast_math=True))
    # Pins, loads and Rayleigh β run since M13.
    for change in (
        dict(load_boxes=(((0, 0, 0), (1, 1, 1), (0, -1, 0)),)),
        dict(pin_boxes=(((0, 0, 0), (1, 1, 1)),)), dict(damping_beta=0.01),
    ):
        check_supported_object(ObjectConfig(**change))
    # Inelastic materials (plastic_yield, viscous_mu) run since ROADMAP
    # M14, every base material since M11; an unknown one raises.
    check_supported_object(ObjectConfig(plastic_yield=0.1, viscous_mu=1.0))
    for material in ("stvk", "linear", "corotated", "stable_neo_hookean",
                     "mooney_rivlin:0.3", "fiber:1,0,0:2"):
        check_supported_object(ObjectConfig(material=material))
    with pytest.raises(ValueError, match="unknown material"):
        check_supported_object(ObjectConfig(material="rubber"))


def test_public_names_match_the_jax_package():
    """Every name that ``fem_tpu`` exports (its ``__all__``, read with
    ``ast`` so that JAX is not imported) is in ``fem_tpu_torch.__all__``
    and importable from it."""
    import ast

    with open(os.path.join(REPO, "fem_tpu", "__init__.py"),
              encoding="utf-8") as f:
        tree = ast.parse(f.read())
    names = next(
        ast.literal_eval(node.value) for node in tree.body
        if isinstance(node, ast.Assign)
        and any(getattr(t, "id", None) == "__all__" for t in node.targets))
    assert "make_substep_fn" in names
    missing = sorted(set(names) - set(fem_tpu_torch.__all__))
    assert not missing, missing
    for name in names:
        assert hasattr(fem_tpu_torch, name), name
