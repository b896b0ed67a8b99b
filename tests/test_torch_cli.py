# coding=utf-8
"""The port's CLI (``python -m fem_tpu_torch.main``) against the JAX
package's (the repository's ``main.py``), on the CPU.

Both CLIs run the same config files into their own output folders; their
checkpoints (the same npz format) carry the end states.  Tolerances: end
positions, ``vel_g`` and every other checkpoint key within 1e-5 absolute,
the elastic velocities within √1e-5 (where a CG stopped at ‖r‖² ≤ 1e-5,
the reference's absolute tolerance, leaves them: at rest the JAX
package's carry ~1e-5 of round-off that the port's do not), CG
iterations equal (the printed iterations per substep are the same
string), OBJ vertices within 1e-5 and
VTU fields within 1e-5 absolute (von Mises within 1e-5·μ); checkpoint and
resume, and the port's own checkpoints, bit-equal.
"""

import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

import main as jax_cli
from fem_tpu_torch import main as cli
from fem_tpu_torch.utils.vtu import read_vtu

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


@pytest.fixture(autouse=True)
def _no_xla_cache(monkeypatch):
    """The JAX CLI keeps a compilation cache under the home directory
    unless told not to."""
    monkeypatch.setenv("FEM_TPU_NO_CACHE", "1")


def _write_cfg(tmp_path, name="cfg.json", **overrides):
    """tests/test_cli.py's 2D config."""
    cfg = {
        "dim": 2, "delta_time": 5e-4, "sim_count": 2, "auto_diff": True,
        "use_explicit_method": True, "implicit_method": 0,
        "preconditioned": 1, "g_dir": [0, -1], "is_output_gif": True,
        "is_output_obj": False, "output_fps": 60,
        "objects": [
            {"id": 0, "rho": 500, "center": [0.5, 0.8], "side_length": 0.2,
             "subdivisions": 4, "E": 4e4, "nu": 0.2, "damping": 14.5}
        ],
        "blocks": [{"id": 0, "block_center": [0.8, 0.5],
                    "block_radius": 0.21}],
    }
    cfg.update(overrides)
    path = tmp_path / name
    path.write_text(json.dumps(cfg))
    return str(path)


IMPLICIT = dict(auto_diff=False, use_explicit_method=False, implicit_method=1,
                is_output_gif=False)
CIRCLES = [{"id": 0, "block_center": [0.8, 0.5], "block_radius": 0.21},
           {"id": 1, "block_center": [0.2, 0.5], "block_radius": 0.21}]
TWO_BODIES = [
    {"id": 0, "rho": 500, "center": [0.3, 0.8], "side_length": 0.1,
     "subdivisions": 3, "E": 4e4, "nu": 0.2, "damping": 14.5},
    {"id": 1, "rho": 800, "center": [0.6, 0.6], "side_length": 0.12,
     "subdivisions": 4, "E": 8e4, "nu": 0.3, "damping": 10.0},
]


def _port(args):
    return cli.run(args + ["--device", "cpu"])


def _iters(text):
    return re.findall(r"solver iters/substep: ([^\n]*)", text)


def _ckpt(folder, frame):
    return np.load(os.path.join(folder, f"ckpt_{frame:06}.npz"))


def _assert_close(got, ref):
    assert sorted(ref.files) == sorted(got.files)
    for key in ref.files:
        tol = TOL ** 0.5 if key.endswith("_vel") else TOL
        np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=tol,
                                   err_msg=key)


def test_bad_config_exits_3(tmp_path):
    assert _port(["--config", str(tmp_path / "missing.json")]) == 3


@pytest.mark.parametrize("case", ["explicit", "implicit", "two_bodies_json"])
def test_end_state_matches_the_jax_cli(tmp_path, capsys, case):
    """4 frames of tests/test_cli.py's 2D config (autodiff as written, and
    its implicit-CG variant dropped onto two circles, so that CG iterates)
    and of configs/demo_two_bodies.json: the end states as stated above,
    the printed iterations equal (but where stated)."""
    if case == "two_bodies_json":
        cfg = os.path.join(REPO, "configs", "demo_two_bodies.json")
    elif case == "implicit":
        obj = dict(json.loads(json.dumps(TWO_BODIES[0])), center=[0.5, 0.68],
                   side_length=0.2, subdivisions=4)
        cfg = _write_cfg(tmp_path, delta_time=2e-3, sim_count=10,
                         objects=[obj], blocks=CIRCLES, **IMPLICIT)
    else:
        cfg = _write_cfg(tmp_path)
    args = ["--config", cfg, "--frames", "4", "--no-render",
            "--checkpoint-every", "4", "--print-every", "1"]
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_cli.run(args + ["--output", a]) == 0
    jax_out = capsys.readouterr().out
    assert _port(args + ["--output", b]) == 0
    port_out = capsys.readouterr().out
    _assert_close(_ckpt(b, 4), _ckpt(a, 4))
    got, ref = _iters(port_out), _iters(jax_out)
    if case == "implicit":
        # The solver iterated (6-14 iterations a substep).  In frame 4 two
        # substeps stop one iteration apart, where ‖r‖² meets the tolerance
        # under the two packages' summation orders: within 1 a substep.
        assert len(got) == len(ref) == 4
        assert got[:3] == ref[:3]
        assert abs(float(got[3]) - float(ref[3])) <= 1.0
    else:
        assert got == ref
    assert [ln for ln in port_out.splitlines() if "Vertex count" in ln] == \
        [ln for ln in jax_out.splitlines() if "Vertex count" in ln]
    assert "Simulation method:" in port_out


def test_multibody_virtual_time_pacing_quirk(tmp_path, capsys):
    """The reference advances virtual_time once per body per frame: 4 frames
    × 2 bodies × 10 substeps × 5e-4 = 0.040 virtual seconds, as the JAX
    CLI prints."""
    cfg = _write_cfg(tmp_path, objects=TWO_BODIES, is_output_gif=False,
                     sim_count=10)
    assert _port(["--config", cfg, "--frames", "4", "--output",
                  str(tmp_path / "out"), "--no-render",
                  "--print-every", "4"]) == 0
    assert "t=0.040s" in capsys.readouterr().out


def test_contact_config_matches_the_jax_cli(tmp_path, capsys):
    """configs/demo_two_bodies_contact.json, the coupled frame, through both
    CLIs for 3 frames: the end states as stated above and the printed
    pacing equal, virtual time advancing once per body per frame (3 × 2 ×
    10 × 5e-4 = 0.030 s), as the JAX CLI's coupled frame does."""
    cfg = os.path.join(REPO, "configs", "demo_two_bodies_contact.json")
    args = ["--config", cfg, "--frames", "3", "--no-render",
            "--checkpoint-every", "3", "--print-every", "1"]
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_cli.run(args + ["--output", a]) == 0
    jax_out = capsys.readouterr().out
    assert _port(args + ["--output", b]) == 0
    port_out = capsys.readouterr().out
    _assert_close(_ckpt(b, 3), _ckpt(a, 3))
    times = re.findall(r"t=([0-9.]+)s", port_out)
    assert times == re.findall(r"t=([0-9.]+)s", jax_out)
    assert times == ["0.010", "0.020", "0.030"]


def test_sharded_contact_is_refused(tmp_path, capsys):
    """``--sharded`` with a contact scene exits with code 3 and the root
    ``main.py``'s message, as the root ``main.py`` does (the coupled frame
    is sharded through ``Simulation(sharded=True)``)."""
    cfg = os.path.join(REPO, "configs", "demo_two_bodies_contact.json")
    assert _port(["--config", cfg, "--frames", "1", "--no-render",
                  "--sharded", "--output", str(tmp_path / "out")]) == 3
    assert ("contact='penalty' is not supported with --sharded"
            in capsys.readouterr().out)


def test_checkpoint_resume_bit_identical(tmp_path):
    """A 2-body implicit scene checkpointed at frame 2 and resumed to frame
    4 ends bit-equal, every key, to the straight run; --debug checks the
    state every frame."""
    cfg = _write_cfg(tmp_path, objects=TWO_BODIES, **IMPLICIT)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert _port(["--config", cfg, "--frames", "4", "--output", a,
                  "--checkpoint-every", "4", "--no-render", "--debug"]) == 0
    assert _port(["--config", cfg, "--frames", "4", "--output", b,
                  "--checkpoint-every", "2", "--no-render"]) == 0
    assert _port(["--config", cfg, "--frames", "4", "--output", b,
                  "--resume", os.path.join(b, "ckpt_000002.npz"),
                  "--checkpoint-every", "2", "--no-render"]) == 0
    ref, got = _ckpt(a, 4), _ckpt(b, 4)
    assert int(ref["n_bodies"]) == int(got["n_bodies"]) == 2
    assert sorted(ref.files) == sorted(got.files)
    for key in ref.files:
        np.testing.assert_array_equal(ref[key], got[key], err_msg=key)


def test_resume_body_count_mismatch_exits_3(tmp_path):
    cfg1 = _write_cfg(tmp_path, "one.json", is_output_gif=False)
    out = str(tmp_path / "out")
    assert _port(["--config", cfg1, "--frames", "2", "--output", out,
                  "--checkpoint-every", "2", "--no-render"]) == 0
    cfg2 = _write_cfg(tmp_path, "two.json", objects=TWO_BODIES,
                      is_output_gif=False)
    assert _port(["--config", cfg2, "--frames", "4", "--output",
                  str(tmp_path / "o2"), "--resume",
                  os.path.join(out, "ckpt_000002.npz"), "--no-render"]) == 3


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_between_packages(tmp_path, writer):
    """A checkpoint written at frame 2 by either CLI, resumed to frame 4 by
    the other, ends as stated above beside the writer's own resumed run."""
    cfg = _write_cfg(tmp_path, objects=TWO_BODIES, delta_time=2e-3,
                     sim_count=5, **IMPLICIT)
    runs = {"jax": jax_cli.run, "port": _port}
    other = "port" if writer == "jax" else "jax"
    w = str(tmp_path / "w")
    base = ["--config", cfg, "--frames", "4", "--no-render",
            "--checkpoint-every", "2"]
    assert runs[writer](base + ["--output", w]) == 0
    ckpt = os.path.join(w, "ckpt_000002.npz")
    for name, run in ((writer, runs[writer]), (other, runs[other])):
        assert run(base + ["--output", str(tmp_path / name),
                           "--resume", ckpt]) == 0
    _assert_close(_ckpt(tmp_path / other, 4), _ckpt(tmp_path / writer, 4))


def _cube_cfg(tmp_path):
    stl = os.path.join(REPO, "assets", "cube.stl")
    cfg = {
        "dim": 3, "delta_time": 5e-4, "sim_count": 4, "auto_diff": False,
        "use_explicit_method": True, "g_dir": [0, -1, 0],
        "is_output_gif": False, "is_output_obj": True, "output_fps": 60,
        "objects": [{"rho": 1000, "center": [0.3, 0.001, 0.3], "obj": stl,
                     "E": 4e4, "nu": 0.3, "damping": 10}],
        "blocks": [],
    }
    path = tmp_path / "cube.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _obj_file(path):
    v, f = [], []
    with open(path) as fh:
        for line in fh:
            kind, *rest = line.split()
            (v if kind == "v" else f).append(rest)
    return np.asarray(v, np.float64), f


def test_obj_and_vtu_exports_match_the_jax_cli(tmp_path):
    """A small 3D body (assets/cube.stl, explicit) dropped 1 mm onto the
    floor: 20 frames with OBJ and VTU export.  The same files, OBJ vertices
    within 1e-5 and faces equal, VTU points and velocities within 1e-5, von
    Mises within 1e-5·μ (its scale; at rest both packages' are round-off),
    connectivity equal, and the same .pvd index."""
    cfg = _cube_cfg(tmp_path)
    args = ["--config", cfg, "--frames", "20", "--no-render",
            "--export-vtu", "--print-every", "0"]
    a, b = tmp_path / "jax", tmp_path / "port"
    assert jax_cli.run(args + ["--output", str(a)]) == 0
    assert _port(args + ["--output", str(b)]) == 0
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    objs = [n for n in names if n.endswith(".obj")]
    vtus = [n for n in names if n.endswith(".vtu")]
    assert len(objs) >= 2 and len(vtus) == len(objs)
    for n in objs:
        (va, fa), (vb, fb) = _obj_file(a / n), _obj_file(b / n)
        assert fa == fb
        np.testing.assert_allclose(vb, va, rtol=0, atol=TOL, err_msg=n)
    mu = 4e4 / (2 * (1 + 0.3))
    for n in vtus:
        pa, ca, pda, cda = read_vtu(str(a / n))
        pb, cb, pdb, cdb = read_vtu(str(b / n))
        np.testing.assert_array_equal(ca, cb)
        np.testing.assert_allclose(pb, pa, rtol=0, atol=TOL)
        np.testing.assert_allclose(pdb["velocity"], pda["velocity"], rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(cdb["von_mises"], cda["von_mises"],
                                   rtol=0, atol=TOL * mu)
    assert float(cda["von_mises"].max()) > 100 * TOL * mu  # it landed
    assert (a / "sim_b0.pvd").read_text() == (b / "sim_b0.pvd").read_text()


def test_render_writes_the_same_gif_frames(tmp_path):
    """Rendering on the CPU: 12 frames of the 2D config at 10 substeps
    write a video.gif with as many frames as the JAX CLI's."""
    from PIL import Image

    cfg = _write_cfg(tmp_path, sim_count=10)
    counts = []
    for name, run in (("jax", jax_cli.run), ("port", _port)):
        out = tmp_path / name
        assert run(["--config", cfg, "--frames", "12", "--output", str(out),
                    "--print-every", "0"]) == 0
        with Image.open(out / "video.gif") as gif:
            counts.append(gif.n_frames)
    assert counts[0] == counts[1] >= 3


def test_trace_writes_a_chrome_trace(tmp_path, capsys):
    cfg = _write_cfg(tmp_path, is_output_gif=False)
    trace = tmp_path / "trace"
    assert _port(["--config", cfg, "--frames", "2", "--no-render",
                  "--output", str(tmp_path / "out"), "--trace",
                  str(trace)]) == 0
    assert "Profiler trace written" in capsys.readouterr().out
    assert json.loads((trace / "trace.json").read_text())["traceEvents"]


def test_sharded_is_refused(tmp_path, capsys):
    """``--sharded`` runs (ROADMAP M20, ported): on a one-rank process
    group here (gloo on the CPU), 3 frames of the explicit and the
    implicit-CG config write the checkpoints of the unsharded run within
    1e-5 and print the ranks."""
    for name, over in (("explicit", {}), ("implicit", IMPLICIT)):
        cfg = _write_cfg(tmp_path, name=f"{name}.json",
                         **dict(over, is_output_gif=False))
        a, b = str(tmp_path / f"{name}_a"), str(tmp_path / f"{name}_b")
        args = ["--config", cfg, "--frames", "3", "--no-render",
                "--checkpoint-every", "3"]
        assert _port(args + ["--output", a]) == 0
        assert _port(args + ["--sharded", "--output", b]) == 0
        assert "sharded over 1 ranks" in capsys.readouterr().out
        _assert_close(_ckpt(b, 3), _ckpt(a, 3))


def test_no_render_imports_no_plotting_library(tmp_path):
    """A --no-render run imports neither matplotlib, PIL nor imageio (the
    GPU machine has none of them)."""
    import subprocess
    import sys

    cfg = _write_cfg(tmp_path, is_output_gif=False)
    code = (
        "import sys\n"
        "from fem_tpu_torch import main\n"
        f"rc = main.run(['--config', {cfg!r}, '--frames', '2', '--no-render',"
        f" '--device', 'cpu', '--output', {str(tmp_path / 'out')!r}])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('matplotlib', 'PIL', 'imageio'))\n"
        "print(rc, bad)\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == "0 []", out.stdout
    shutil.rmtree(tmp_path / "out")


def test_render_without_matplotlib_raises(tmp_path):
    """A render request where matplotlib cannot be imported raises
    ``ImportError`` before the first frame; it is never skipped."""
    import subprocess
    import sys

    cfg = _write_cfg(tmp_path, is_output_gif=False)
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        "from fem_tpu_torch import main\n"
        "try:\n"
        f"    main.run(['--config', {cfg!r}, '--frames', '1', '--device',"
        f" 'cpu', '--output', {str(tmp_path / 'out')!r}])\n"
        "except ImportError as e:\n"
        "    print('ImportError', e)\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert out.stdout.strip().splitlines()[-1].startswith("ImportError"), \
        out.stdout
    assert "frame 1/1" not in out.stdout
