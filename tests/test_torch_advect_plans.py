# coding=utf-8
"""The launch in particle tiles of K10a and K10b
(``advect_kernels.advect_plan``), their wrappers' one library and launch
on the current stream, and their CPU path.

The plan is pure host code, so it is checked here at the shapes the card
sees: ragged sizes around one tile, the flagship's 1,007 particles and a
million, 2D and 3D, each particle covered by one thread once.  The
launch is checked with a fake library on the meta device: no kernel runs.
On the CPU the wrappers return their plain versions, held to the JAX
package's Pallas kernels in interpret mode at ragged sizes, with no circle
and with five, at 1e-6 absolute (the same f32 formulas; sums of 2-3 terms may round in
another order)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu.ops.pallas_advect import advect_implicit_pallas, kinematic_pallas
from fem_tpu_torch.ops import advect_kernels as ak
from fem_tpu_torch.solvers import advect
from fem_tpu_torch.utils import cuda_build

torch.set_num_threads(1)

SIZES = (0, 1, 31, 32, 33, 1007, 1048576)
DT, DAMP = 5e-4, 10.0


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("n", SIZES)
def test_advect_plan_tiles_every_particle_once(n, d):
    """CTAs of ADVECT_TILE particles, the ragged last tile; thread t of CTA
    c takes particle c · tile + t."""
    plan = ak.advect_plan(n, d)
    assert plan.tile == ak.ADVECT_TILE and plan.tile % 32 == 0
    assert plan.ctas == -(-n // plan.tile)
    if n == 0:
        assert plan.ctas == 0 and plan.last == 0
    else:
        assert 1 <= plan.last <= plan.tile
        assert (plan.ctas - 1) * plan.tile + plan.last == n
    if 0 < n <= 1007:
        seen = np.zeros(n, dtype=int)
        for cta in range(plan.ctas):
            p = cta * plan.tile + np.arange(plan.tile)
            np.add.at(seen, p[p < n], 1)
        assert np.all(seen == 1)
    assert ak.advect_plan(n, d) is ak.advect_plan(n, d)  # cached


def test_advect_plan_counts_at_the_flagship_and_a_million():
    """The flagship's 1,007 particles fill 16 CTAs of 64 (CTAs of 256: 4),
    ``default.json``'s 121 two; a million particles 16,384."""
    assert ak.advect_plan(1007, 3) == ak.AdvectPlan(64, 16, 47)
    assert ak.advect_plan(121, 2) == ak.AdvectPlan(64, 2, 57)
    assert ak.advect_plan(1048576, 3) == ak.AdvectPlan(64, 16384, 64)
    assert ak.advect_plan(64, 2) == ak.AdvectPlan(64, 1, 64)
    assert ak.advect_plan(65, 3) == ak.AdvectPlan(64, 2, 1)


def test_advect_plan_refuses_what_the_kernels_do_not_take():
    for args, match in (((10, 1), "dim 2 or 3"), ((10, 4), "dim 2 or 3"),
                        ((-1, 3), "-1 particles"), ((-5, 2), "-5 particles")):
        with pytest.raises(ValueError, match=match):
            ak.advect_plan(*args)


class _Entry:
    """A C entry's stand-in that records its arguments and returns ``rc``;
    ``argtypes`` starts unset, as a freshly loaded library's does."""

    def __init__(self, rc=0):
        self.argtypes = None
        self.restype = None
        self.calls = []
        self.rc = rc

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


class _FakeLibrary:
    def __init__(self):
        self.fem_kinematic = _Entry()
        self.fem_advect_implicit = _Entry()
        self.fem_advect_error = lambda rc: b"fake error"


def _meta(n, d, b=3):
    """K10a's and K10b's operands on the meta device (shapes only; data
    pointers 0): (pos, vel, grad or vel_g, m⁻¹, centers, radii, gravity)."""
    meta = torch.device("meta")
    rows = [torch.empty((n, d), device=meta) for _ in range(3)]
    return (*rows, torch.empty((n,), device=meta),
            torch.empty((b, d), device=meta), torch.empty((b,), device=meta),
            torch.empty((d,), device=meta))


def test_library_is_bound_once_and_launches_on_the_current_stream(
        monkeypatch):
    """Both wrappers launch through one library, loaded at the first launch
    with its entries' argument types set, in 2D and 3D alike.  Launches are
    counted, the plan kept, d passed first and the current stream last; no
    device context is entered when the current device is the tensors', one
    is when it is not; a failed launch raises and counts nothing."""
    loads, contexts = [], []

    def fake_load(name, material=None):
        loads.append((name, material))
        return _FakeLibrary()

    class Context:
        def __init__(self, dev):
            contexts.append(dev)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(cuda_build, "load", fake_load)
    monkeypatch.setattr(ak, "_LIB", None)
    # The device checks and the stream need a card: stand-ins on the meta
    # device, whose index (None) is the current device's.
    monkeypatch.setattr(ak, "_check", lambda pos, *a, **k: (
        pos.shape[0], pos.shape[1], pos.device))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                        types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(torch.cuda, "device", Context)
    for fn in (ak.kinematic, ak.advect_implicit):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "last_plan", None)

    pos, vel, aux, minv, centers, radii, gravity = _meta(33, 3)
    kw = dict(dt=DT, decay=0.99, gravity=gravity)
    assert loads == []
    for _ in range(3):
        p, v = ak.kinematic(pos, vel, aux, minv, centers, radii, **kw)
        assert p.shape == (33, 3) and v.device.type == "meta"
        outs = ak.advect_implicit(pos, vel, aux, centers, radii, **kw)
        assert len(outs) == 3 and outs[2].shape == (33, 3)
    assert loads == [("advect", None)]
    lib = ak._library()
    assert lib.fem_kinematic.argtypes is not None
    assert lib.fem_advect_implicit.argtypes is not None
    assert lib.fem_advect_error.restype is not None
    plan = ak.advect_plan(33, 3)
    for entry, n_at in ((lib.fem_kinematic, 11), (lib.fem_advect_implicit, 10)):
        assert len(entry.calls) == 3
        assert all(c[0] == 3 and c[n_at] == 33 and c[-1] == 7
                   for c in entry.calls)
    assert ak.kinematic.launches == 3 and ak.advect_implicit.launches == 3
    assert ak.kinematic.last_plan == ak.advect_implicit.last_plan == plan
    assert contexts == []

    # d = 2 launches through the same library, with its own plan.
    *ops2, gravity2 = _meta(5, 2, b=0)
    ak.kinematic(*ops2, dt=DT, decay=0.99, gravity=gravity2)
    assert loads == [("advect", None)] and ak._library() is lib
    assert lib.fem_kinematic.calls[-1][0] == 2
    assert lib.fem_kinematic.calls[-1][7] == 0  # no circle
    assert ak.kinematic.last_plan == ak.advect_plan(5, 2)

    # Another current device: the launch enters the tensors' device.
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    ak.advect_implicit(pos, vel, aux, centers, radii, **kw)
    assert contexts == [pos.device] and ak.advect_implicit.launches == 4

    lib.fem_kinematic.rc = 1
    with pytest.raises(RuntimeError,
                       match="kinematic kernel launch failed: fake error"):
        ak.kinematic(pos, vel, aux, minv, centers, radii, **kw)
    assert ak.kinematic.launches == 4 and len(lib.fem_kinematic.calls) == 5
    lib.fem_advect_implicit.rc = 1
    with pytest.raises(RuntimeError, match="implicit advection kernel launch "
                       "failed: fake error"):
        ak.advect_implicit(pos, vel, aux, centers, radii, **kw)
    assert ak.advect_implicit.launches == 4 and len(loads) == 1


def _case(n, d, b, seed):
    """Particles in and past the unit box, a third inside the first two
    of ``b`` circles (the last of radius 0); random velocities, gravity
    channel, gradients and masses."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.1, 1.1, (n, d)).astype(np.float32)
    centers = rng.uniform(0.3, 0.7, (b, d)).astype(np.float32)
    radii = np.linspace(0.25, 0.0, b).astype(np.float32)
    if b:
        k = -(-n // 3)
        pos[:k] = (centers[rng.integers(0, min(b, 2), k)]
                   + rng.uniform(-0.12, 0.12, (k, d))).astype(np.float32)
    vel, vel_g, grad = (rng.normal(scale=s, size=(n, d)).astype(np.float32)
                        for s in (0.5, 0.5, 10.0))
    mass = rng.uniform(0.5, 2.0, (n,)).astype(np.float32)
    return pos, vel, vel_g, grad, mass, centers, radii


def _g(d):
    return (0.0, -1.0) if d == 2 else (0.0, -1.0, 0.0)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("b", [0, 5])
@pytest.mark.parametrize("n", [1, 33])
def test_plain_versions_match_pallas_at_ragged_sizes(n, b, d):
    """``kinematic`` and ``advect_implicit`` on CPU tensors (their plain
    versions) against ``kinematic_pallas`` / ``advect_implicit_pallas`` in
    interpret mode: 1e-6 absolute, no launch counted.  The plain versions
    get ``b`` circles, B = 0 included."""
    pos, vel, vel_g, grad, mass, centers, radii = _case(n, d, b, 7 * n + b + d)
    t = torch.as_tensor
    kw = dict(dt=DT, decay=advect.damping_decay(DT, DAMP),
              gravity=advect.gravity_vector(_g(d), torch.device("cpu")))
    before = (ak.kinematic.launches, ak.advect_implicit.launches)
    got_k = ak.kinematic(t(pos), t(vel), t(grad), 1.0 / t(mass), t(centers),
                         t(radii), **kw)
    got_i = ak.advect_implicit(t(pos), t(vel), t(vel_g), t(centers),
                               t(radii), **kw)
    # Pallas's interpreter takes no zero-size operand: with no circle the
    # reference gets one of radius 0, which by the kernels' rule never hits.
    jcenters = jnp.asarray(centers) if b else jnp.full((1, d), 0.5)
    jradii = jnp.asarray(radii)[None, :] if b else jnp.zeros((1, 1))
    ref_k = kinematic_pallas(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(grad),
        (1.0 / jnp.asarray(mass))[:, None], jcenters, jradii, dt=DT,
        damping=DAMP, g_dir=_g(d), interpret=True)
    ref_i = advect_implicit_pallas(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(vel_g), jcenters,
        jradii, dt=DT, damping=DAMP, g_dir=_g(d), interpret=True)
    for got, ref, names in ((got_k, ref_k, ("pos", "vel")),
                            (got_i, ref_i, ("pos", "vel", "vel_g"))):
        for a, r, name in zip(got, ref, names):
            assert a.shape == (n, d)
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0,
                                       atol=1e-6, err_msg=name)
    assert (ak.kinematic.launches, ak.advect_implicit.launches) == before
