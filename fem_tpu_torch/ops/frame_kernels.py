# coding=utf-8
"""K5 and K8, the whole frame: ``sim_count`` substeps in one launch.

``fused_blocked_frame`` (K5: implicit-CG substeps) and
``fused_explicit_frame`` (K8: explicit substeps, also for autodiff configs)
launch ``fem_tpu_torch/csrc/blocked_frame.cu`` and
``fem_tpu_torch/csrc/explicit_frame.cu`` cooperatively for tensors on a
CUDA device; they replace the JAX package's Pallas kernels
``ops/pallas_blocked_frame.py:_frame_kernel`` (entry ``fused_blocked_frame``)
and ``_explicit_frame_kernel`` (entry ``fused_explicit_frame``), for every
material of ``ops/element.py`` (K5 also ``robust``), with their plastic and
Maxwell branches, in the blocking's dimension (2 or 3; one kernel template
per kernel, an instance per dimension, material and elastic or inelastic,
each material's instances in a library of their own).  For tensors on the
CPU each runs its plain version: ``fused_blocked_frame_plain`` runs per substep the plain blocked
prep, the slot-sum assembly, the reference CG over the plain blocked
operator and the plain advection; ``fused_explicit_frame_plain`` per
substep the plain blocked gradient prep, the slot sum and the plain
kinematic step.  On CUDA each launches its kernel or raises — also when the
grid cannot be co-resident, since a grid barrier in a grid that is not
would hang.

Inelastic materials (ops/inelastic.py): ``plastic_inv`` (F_p⁻¹, when
``plastic_yield`` > 0) and ``viscous_inv`` (F_v⁻¹, when ``viscous_mu`` > 0)
enter and leave in mesh element order, (E, d, d); each frame returns them
after the ones it returns for an elastic material.  The kernels keep them
per element slot through ``Blocking.element_perm``, run the base chain on
R⁻¹·F_p⁻¹ and add the stable Neo-Hookean branch (λ = 0, μ_v) on R⁻¹·F_v⁻¹,
and update both after each substep's advection (csrc/inelastic.cuh).  The
plain frames do the same through ``ops/inelastic.advance_blocked`` with the
plain edge matrices.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from fem_tpu_torch.models.state import Obstacles, SimState
from fem_tpu_torch.ops.blocked_kernels import (
    BlockTablesC,
    block_tables,
    blocked_edges_plain,
    blocked_grad_prep_layers_plain,
    blocked_graph_apply_plain,
    blocked_prep_layers_plain,
    blocked_velocity_solve,
    check_slot_plan,
)
from fem_tpu_torch.ops.blocking import Blocking, blocked_scatter_sum
from fem_tpu_torch.ops.element import kernel_material_id
from fem_tpu_torch.ops.element_kernels import (
    MaterialParamsC,
    count_launch,
    material_params,
)
from fem_tpu_torch.ops.inelastic import (
    BRANCH_MATERIAL,
    advance_blocked,
    layer_ref_inv_blocked,
    relax_decay,
)
from fem_tpu_torch.solvers.advect import (
    advect_implicit_step,
    damping_decay,
    gravity_vector,
    kinematic_step,
)
from fem_tpu_torch.utils import cuda_build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


# The inelastic tail both frames' argument structs share
# (csrc/inelastic.cuh: InelasticArgs).
_INELASTIC_FIELDS = [
    ("element_perm", _P), ("plastic_in", _P), ("viscous_in", _P),
    ("plastic", _P), ("viscous", _P),
    ("plastic_yield", _F), ("viscous_mu", _F), ("relax", _F),
]


class FrameArgsC(ctypes.Structure):
    """Mirror of ``FemFrameArgs`` (csrc/blocked_frame.cu)."""

    _fields_ = [
        ("T", BlockTablesC),
        ("slot_ptr", _P), ("slot_rows", _P),
        ("pos_in", _P), ("vel_in", _P), ("velg_in", _P),
        ("mass", _P), ("centers", _P), ("radii", _P),
        ("n", _I), ("n_obst", _I), ("sim_count", _I), ("max_iter", _I),
        ("normal", _I), ("material", _I),
        ("dt", _F), ("dt2", _F), ("decay", _F),
        ("g0", _F), ("g1", _F), ("g2", _F),
        ("mat", MaterialParamsC), ("tol", _F),
        ("pos", _P), ("vel", _P), ("velg", _P), ("scratch", _P),
        ("iters", _P), ("res", _P),
    ] + _INELASTIC_FIELDS


def _gravity3(g_dir, d):
    """9.8·g_dir as the kernels' three gravity floats (the third is 0 and
    unused in 2D), after checking that ``g_dir`` has ``d`` components."""
    if len(g_dir) != d:
        raise ValueError(f"g_dir has {len(g_dir)} components, expected {d}")
    grav = gravity_vector(tuple(g_dir), torch.device("cpu")).tolist()
    return grav + [0.0] * (3 - d)


class _Internal:
    """The material and inelastic state of one frame call: which branches
    are on, their constants, and the plain versions' layers and update."""

    def __init__(self, blk, mu, s_lambda, plastic_inv, plastic_yield,
                 viscous_inv, viscous_mu, viscous_tau, dt,
                 material="neo_hookean"):
        self.plastic = plastic_yield > 0.0
        self.viscous = viscous_mu > 0.0
        for on, fi, name in ((self.plastic, plastic_inv, "plastic_inv"),
                             (self.viscous, viscous_inv, "viscous_inv")):
            if on != (fi is not None):
                raise ValueError(
                    f"{name} must be given exactly when its branch is on")
        self.blk, self.mu, self.lam = blk, mu, s_lambda
        self.material = material
        self.plastic_yield, self.viscous_mu = plastic_yield, viscous_mu
        self.relax = relax_decay(dt, viscous_tau) if self.viscous else 0.0
        self.state = (plastic_inv, viscous_inv)

    @property
    def on(self):
        return self.plastic or self.viscous

    def layers(self):
        plastic, viscous = self.state
        out = [(layer_ref_inv_blocked(self.blk, plastic), self.mu, self.lam,
                self.material)]
        if viscous is not None:
            out.append((layer_ref_inv_blocked(self.blk, viscous),
                        self.viscous_mu, 0.0, BRANCH_MATERIAL))
        return out

    def advance(self, pos):
        if self.on:
            self.state = advance_blocked(
                self.blk, pos, *self.state, self.plastic_yield, self.relax,
                edges=blocked_edges_plain)

    def outputs(self):
        return tuple(fi for fi in self.state if fi is not None)


def fused_blocked_frame_plain(
    blk: Blocking, pos, vel, vel_g, mass, centers, radii, *, dt, damping,
    g_dir, mu, s_lambda, preconditioned, sim_count, max_iter=500, tol=1e-5,
    robust=False, material="neo_hookean", plastic_inv=None,
    plastic_yield=0.0, viscous_inv=None, viscous_mu=0.0, viscous_tau=0.1,
):
    """Plain PyTorch version of :func:`fused_blocked_frame`."""
    internal = _Internal(blk, mu, s_lambda, plastic_inv, plastic_yield,
                         viscous_inv, viscous_mu, viscous_tau, dt, material)
    state = SimState(pos=pos, vel=vel, vel_g=vel_g, force=torch.zeros_like(pos))
    obstacles = Obstacles(centers=centers, radii=radii)
    decay = damping_decay(dt, damping, pos.dtype)
    gravity = gravity_vector(tuple(g_dir), pos.device)
    iters, res = [], []
    for _ in range(sim_count):
        sol = blocked_velocity_solve(
            blk, blocked_prep_layers_plain(blk, state.pos, internal.layers(),
                                           robust),
            state.vel, mass, dt, bool(preconditioned),
            apply=blocked_graph_apply_plain, max_iter=max_iter, tol=tol,
        )
        state = advect_implicit_step(
            state.replace(vel=sol.x), obstacles, dt, decay, gravity
        )
        internal.advance(state.pos)
        iters.append(sol.iterations)
        res.append(sol.residual)
    return (state.pos, state.vel, state.vel_g, torch.stack(iters),
            torch.stack(res)) + internal.outputs()


def _inelastic_args(blk, internal, n_elem, d):
    """(C field values of the inelastic tail, output tensors) of a launch;
    null pointers and no outputs for an elastic material."""
    if not internal.on:
        return [None, None, None, None, None, 0.0, 0.0, 0.0], ()
    dev = blk.volume.device
    ins, outs = [], []
    for on, fi, name in zip((internal.plastic, internal.viscous),
                            internal.state, ("plastic_inv", "viscous_inv")):
        if not on:
            ins.append(None)
            outs.append(None)
            continue
        cuda_build.check_operand(name, fi, (n_elem, d, d), torch.float32, dev)
        ins.append(fi.data_ptr())
        outs.append(torch.empty_like(fi))
    cuda_build.check_operand("blocking.element_perm", blk.element_perm,
                             (blk.num_blocks * blk.eb,), torch.int32, dev)
    fields = [blk.element_perm.data_ptr(), *ins,
              *(None if o is None else o.data_ptr() for o in outs),
              internal.plastic_yield, internal.viscous_mu, internal.relax]
    return fields, tuple(o for o in outs if o is not None)


def _library(material_id: int):
    lib = cuda_build.load("blocked_frame", material_id)
    if lib.fem_blocked_frame.argtypes is None:
        lib.fem_blocked_frame_scratch_floats.argtypes = [_I, _I, _I, _I, _I]
        lib.fem_blocked_frame_scratch_floats.restype = ctypes.c_longlong
        out = ctypes.POINTER(_I)
        lib.fem_blocked_frame_plan.argtypes = [
            _I, _I, _I, _I, _I, _I, _I, out, out, out,
        ]
        lib.fem_blocked_frame_plan.restype = _I
        lib.fem_blocked_frame.argtypes = [
            ctypes.POINTER(FrameArgsC), _I, _I, _P,
        ]
        lib.fem_blocked_frame.restype = _I
        lib.fem_blocked_frame_error.argtypes = [_I]
        lib.fem_blocked_frame_error.restype = ctypes.c_char_p
    return lib


def _plan(lib, plan_fn, error_fn, what, device_index, num_blocks, eb, pb,
          grid, dim, material_id, inelastic):
    g, smem, most = _I(0), _I(0), _I(0)
    with torch.cuda.device(device_index):
        rc = plan_fn(
            num_blocks, eb, pb, grid, dim, material_id, int(inelastic),
            ctypes.byref(g), ctypes.byref(smem), ctypes.byref(most),
        )
    if rc != 0:
        msg = error_fn(rc).decode()
        raise RuntimeError(
            f"{what}: {msg} (grid {g.value} CTAs, at most "
            f"{most.value} co-resident, {smem.value} B of shared memory each)"
        )
    return g.value, smem.value


@functools.lru_cache(maxsize=64)
def frame_plan(device_index: int, num_blocks: int, eb: int, pb: int,
               grid: int, dim: int, material_id: int = 0,
               inelastic: bool = False):
    """(grid, dynamic shared bytes) of K5's cooperative launch of the
    instance (``dim``, ``material_id``, elastic or inelastic): ``grid``
    CTAs, or with 0 one per locality block and at most one per SM.  Raises
    when the grid cannot be co-resident or its K blocks do not fit."""
    lib = _library(material_id)
    return _plan(lib, lib.fem_blocked_frame_plan, lib.fem_blocked_frame_error,
                 "whole-frame kernel", device_index, num_blocks, eb, pb, grid,
                 dim, material_id, inelastic)


def fused_blocked_frame(
    blk: Blocking,
    pos: torch.Tensor,
    vel: torch.Tensor,
    vel_g: torch.Tensor,
    mass: torch.Tensor,
    centers: torch.Tensor,
    radii: torch.Tensor,
    *,
    dt: float,
    damping: float,
    g_dir: Tuple[float, ...],
    mu: float,
    s_lambda: float,
    preconditioned: bool,
    sim_count: int,
    max_iter: int = 500,
    tol: float = 1e-5,
    grid: int = 0,
    robust: bool = False,
    material: str = "neo_hookean",
    plastic_inv=None,
    plastic_yield: float = 0.0,
    viscous_inv=None,
    viscous_mu: float = 0.0,
    viscous_tau: float = 0.1,
):
    """One rendered frame of ``sim_count`` implicit-CG substeps: returns
    (pos', vel', vel_g' (N, d), iterations (S,) int32, ‖r‖² (S,) f32), then
    plastic_inv' and viscous_inv' (E, d, d) for the branches that are on —
    the contract of the JAX package's ``fused_blocked_frame``.

    CUDA tensors: one cooperative launch of the whole-frame kernel's
    instance of ``material`` (robust Neo-Hookean when ``robust``; ``robust``
    leaves every other material's chain as it is), with its plastic and
    Maxwell branches when they are on, 2D or 3D, with no host
    synchronisation; ``grid`` sets its CTAs (0: one per locality block, at
    most one per SM; the tests set it to walk blocks grid-stride and to ask
    for a grid that cannot be co-resident).  CPU tensors:
    :func:`fused_blocked_frame_plain`."""
    inelastic = dict(plastic_inv=plastic_inv, plastic_yield=plastic_yield,
                     viscous_inv=viscous_inv, viscous_mu=viscous_mu,
                     viscous_tau=viscous_tau)
    mid = kernel_material_id(material, robust)
    if pos.device.type == "cpu":
        return fused_blocked_frame_plain(
            blk, pos, vel, vel_g, mass, centers, radii, dt=dt,
            damping=damping, g_dir=g_dir, mu=mu, s_lambda=s_lambda,
            preconditioned=preconditioned, sim_count=sim_count,
            max_iter=max_iter, tol=tol, robust=robust, material=material,
            **inelastic,
        )
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    internal = _Internal(blk, mu, s_lambda, dt=dt, material=material,
                         **inelastic)
    tables = block_tables(blk)
    dev = pos.device
    n, d = pos.shape[0], tables.dim
    o = radii.shape[0]
    plan = blk.slot_plan
    f32 = torch.float32
    for name, t, shape in (
        ("pos", pos, (n, d)), ("vel", vel, (n, d)), ("vel_g", vel_g, (n, d)),
        ("mass", mass, (n,)), ("centers", centers, (o, d)),
        ("radii", radii, (o,)),
    ):
        cuda_build.check_operand(name, t, shape, f32, blk.volume.device)
    check_slot_plan(blk, n, dev)
    g, smem = frame_plan(dev.index or 0, blk.num_blocks, blk.eb, blk.pb,
                         int(grid), d, mid, internal.on)
    lib = _library(mid)
    scratch = torch.empty(
        lib.fem_blocked_frame_scratch_floats(n, blk.num_blocks, blk.pb, g, d),
        dtype=f32, device=dev,
    )
    out = [torch.empty((n, d), dtype=f32, device=dev) for _ in range(3)]
    iters = torch.empty((sim_count,), dtype=torch.int32, device=dev)
    res = torch.empty((sim_count,), dtype=f32, device=dev)
    grav = _gravity3(g_dir, d)
    tail, state_out = _inelastic_args(blk, internal, blk.element_slot.shape[0],
                                      d)
    args = FrameArgsC(
        tables, plan.ptr.data_ptr(), plan.rows.data_ptr(), pos.data_ptr(),
        vel.data_ptr(), vel_g.data_ptr(), mass.data_ptr(), centers.data_ptr(),
        radii.data_ptr(), n, o, int(sim_count), int(max_iter),
        int(bool(preconditioned)), mid, dt, dt * dt,
        damping_decay(dt, damping), *grav, material_params(material, mu,
                                                           s_lambda, d),
        tol, out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(), scratch.data_ptr(),
        iters.data_ptr(), res.data_ptr(), *tail,
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fem_blocked_frame(ctypes.byref(args), g, smem, stream)
    if rc != 0:
        msg = lib.fem_blocked_frame_error(rc).decode()
        raise RuntimeError(f"whole-frame kernel launch failed: {msg}")
    count_launch(fused_blocked_frame, d, mid, internal.on)
    return (out[0], out[1], out[2], iters, res) + state_out


fused_blocked_frame.launches = 0
fused_blocked_frame.instance_launches = {}


class ExplicitFrameArgsC(ctypes.Structure):
    """Mirror of ``FemExplicitFrameArgs`` (csrc/explicit_frame.cu)."""

    _fields_ = [
        ("T", BlockTablesC),
        ("slot_ptr", _P), ("slot_rows", _P),
        ("pos_in", _P), ("vel_in", _P),
        ("mass", _P), ("centers", _P), ("radii", _P),
        ("n", _I), ("n_obst", _I), ("sim_count", _I), ("material", _I),
        ("dt", _F), ("decay", _F),
        ("g0", _F), ("g1", _F), ("g2", _F),
        ("mat", MaterialParamsC),
        ("pos", _P), ("vel", _P), ("partials", _P),
    ] + _INELASTIC_FIELDS


def fused_explicit_frame_plain(
    blk: Blocking, pos, vel, mass, centers, radii, *, dt, damping, g_dir,
    mu, s_lambda, sim_count, material="neo_hookean", plastic_inv=None,
    plastic_yield=0.0, viscous_inv=None, viscous_mu=0.0, viscous_tau=0.1,
):
    """Plain PyTorch version of :func:`fused_explicit_frame`: it multiplies
    the gradient by m⁻¹, as the kernel does."""
    internal = _Internal(blk, mu, s_lambda, plastic_inv, plastic_yield,
                         viscous_inv, viscous_mu, viscous_tau, dt, material)
    state = SimState(pos=pos, vel=vel, vel_g=torch.zeros_like(vel),
                     force=torch.zeros_like(pos))
    obstacles = Obstacles(centers=centers, radii=radii)
    decay = damping_decay(dt, damping, pos.dtype)
    gravity = gravity_vector(tuple(g_dir), pos.device, pos.dtype)
    inv_mass = 1.0 / mass
    for _ in range(sim_count):
        grad = blocked_scatter_sum(
            blocked_grad_prep_layers_plain(blk, state.pos, internal.layers()),
            blk)
        state = kinematic_step(state, grad, mass, obstacles, dt, decay,
                               gravity, inv_mass=inv_mass)
        internal.advance(state.pos)
    return (state.pos, state.vel) + internal.outputs()


def _explicit_library(material_id: int):
    lib = cuda_build.load("explicit_frame", material_id)
    if lib.fem_explicit_frame.argtypes is None:
        out = ctypes.POINTER(_I)
        lib.fem_explicit_frame_plan.argtypes = [
            _I, _I, _I, _I, _I, _I, _I, out, out, out,
        ]
        lib.fem_explicit_frame_plan.restype = _I
        lib.fem_explicit_frame.argtypes = [
            ctypes.POINTER(ExplicitFrameArgsC), _I, _I, _P,
        ]
        lib.fem_explicit_frame.restype = _I
        lib.fem_explicit_frame_error.argtypes = [_I]
        lib.fem_explicit_frame_error.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=64)
def explicit_frame_plan(device_index: int, num_blocks: int, eb: int, pb: int,
                        grid: int, dim: int, material_id: int = 0,
                        inelastic: bool = False):
    """(grid, dynamic shared bytes) of K8's cooperative launch, as
    :func:`frame_plan`."""
    lib = _explicit_library(material_id)
    return _plan(lib, lib.fem_explicit_frame_plan,
                 lib.fem_explicit_frame_error, "explicit whole-frame kernel",
                 device_index, num_blocks, eb, pb, grid, dim, material_id,
                 inelastic)


def fused_explicit_frame(
    blk: Blocking,
    pos: torch.Tensor,
    vel: torch.Tensor,
    mass: torch.Tensor,
    centers: torch.Tensor,
    radii: torch.Tensor,
    *,
    dt: float,
    damping: float,
    g_dir: Tuple[float, ...],
    mu: float,
    s_lambda: float,
    sim_count: int,
    grid: int = 0,
    material: str = "neo_hookean",
    plastic_inv=None,
    plastic_yield: float = 0.0,
    viscous_inv=None,
    viscous_mu: float = 0.0,
    viscous_tau: float = 0.1,
):
    """One rendered frame of ``sim_count`` explicit substeps: returns
    (pos', vel') (N, d), then plastic_inv' and viscous_inv' (E, d, d) for
    the branches that are on — the contract of the JAX package's
    ``fused_explicit_frame``.

    CUDA tensors: one cooperative launch of the explicit whole-frame
    kernel's instance of ``material``, with its plastic and Maxwell branches
    when they are on, 2D or 3D, with no host synchronisation; ``grid`` as
    in :func:`fused_blocked_frame`.  CPU tensors:
    :func:`fused_explicit_frame_plain`."""
    inelastic = dict(plastic_inv=plastic_inv, plastic_yield=plastic_yield,
                     viscous_inv=viscous_inv, viscous_mu=viscous_mu,
                     viscous_tau=viscous_tau)
    mid = kernel_material_id(material)
    if pos.device.type == "cpu":
        return fused_explicit_frame_plain(
            blk, pos, vel, mass, centers, radii, dt=dt, damping=damping,
            g_dir=g_dir, mu=mu, s_lambda=s_lambda, sim_count=sim_count,
            material=material, **inelastic,
        )
    internal = _Internal(blk, mu, s_lambda, dt=dt, material=material,
                         **inelastic)
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    if sim_count < 1:
        raise ValueError(f"sim_count must be at least 1 (got {sim_count})")
    tables = block_tables(blk)
    dev = pos.device
    n, d = pos.shape[0], tables.dim
    o = radii.shape[0]
    plan = blk.slot_plan
    f32 = torch.float32
    for name, t, shape in (
        ("pos", pos, (n, d)), ("vel", vel, (n, d)), ("mass", mass, (n,)),
        ("centers", centers, (o, d)), ("radii", radii, (o,)),
    ):
        cuda_build.check_operand(name, t, shape, f32, blk.volume.device)
    check_slot_plan(blk, n, dev)
    g, smem = explicit_frame_plan(dev.index or 0, blk.num_blocks, blk.eb,
                                  blk.pb, int(grid), d, mid, internal.on)
    lib = _explicit_library(mid)
    partials = torch.empty((blk.num_blocks * blk.pb, d), dtype=f32, device=dev)
    out = [torch.empty((n, d), dtype=f32, device=dev) for _ in range(2)]
    grav = _gravity3(g_dir, d)
    tail, state_out = _inelastic_args(blk, internal, blk.element_slot.shape[0],
                                      d)
    args = ExplicitFrameArgsC(
        tables, plan.ptr.data_ptr(), plan.rows.data_ptr(), pos.data_ptr(),
        vel.data_ptr(), mass.data_ptr(), centers.data_ptr(),
        radii.data_ptr(), n, o, int(sim_count), mid, dt,
        damping_decay(dt, damping), *grav,
        material_params(material, mu, s_lambda, d), out[0].data_ptr(),
        out[1].data_ptr(), partials.data_ptr(), *tail,
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fem_explicit_frame(ctypes.byref(args), g, smem, stream)
    if rc != 0:
        msg = lib.fem_explicit_frame_error(rc).decode()
        raise RuntimeError(f"explicit whole-frame kernel launch failed: {msg}")
    count_launch(fused_explicit_frame, d, mid, internal.on)
    return (out[0], out[1]) + state_out


fused_explicit_frame.launches = 0
fused_explicit_frame.instance_launches = {}
