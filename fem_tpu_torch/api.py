# coding=utf-8
"""The high-level user API: one object holding a scene, its frame
functions and a virtual clock.

The port of the JAX package's ``api.py``::

    import fem_tpu_torch
    sim = fem_tpu_torch.Simulation.from_config("configs/default.json")
    sim.run(seconds=1.0)                   # advance the virtual clock
    frame = sim.render()                   # RGB frame of the current state
    sim.save_checkpoint("state.npz")
    metrics = sim.metrics()                # energies, min det F, NaN flag

It runs on the CUDA device unless ``device="cpu"`` is passed.  Everything
stays reachable underneath (``sim.scene[i].obj`` / ``.state``,
``fem_tpu_torch.sim.substep``).  The analyses — ``solve_static``,
``modes``, ``buckling``, ``harmonic``, ``response_spectrum`` and
``arc_length`` — run on the scene's device.  ``sharded=True`` runs every
body's elements sharded over the ranks of ``torch.distributed``
(``parallel/sharding.py``: one rank, set up on the scene's device, when no
process group runs; one rank a GPU under ``torchrun``); every rank holds
the same state.
``contact="penalty"`` with more than one body, or with ``self_contact``,
steps every body jointly through ``contact.make_contact_frame_fn`` (the
sharded contact frame under ``sharded=True``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from fem_tpu_torch.contact import contact_scene, make_contact_frame_fn
from fem_tpu_torch.ops.element import deformation_gradients, element_stresses
from fem_tpu_torch.scene import SceneObject, load_scene, method_banner
from fem_tpu_torch.sim import element_phi, element_von_mises, make_frame_fn
from fem_tpu_torch.utils import io as fio
from fem_tpu_torch.utils.config import SimConfig, parse_config, read_config
from fem_tpu_torch.utils.io import to_numpy
from fem_tpu_torch.utils.device import resolve_device
from fem_tpu_torch.utils.profiling import (
    FrameMetrics,
    check_state,
    frame_metrics,
)


class Simulation:
    """A loaded scene, one frame function per body (or the coupled contact
    frame of all of them) and a virtual clock."""

    def __init__(self, cfg: SimConfig,
                 interior_spacing: Optional[float] = None,
                 sharded: bool = False, device="cuda"):
        """``sharded=True`` builds each body's frame function (or the
        coupled contact frame) with its elements sharded over a 1-D mesh of
        all ranks (``parallel/sharding.make_element_mesh``; the JAX
        package's ``jax.devices()`` mesh): locality blocks shared out whole,
        one all-reduce an assembly and an operator apply, the same state on
        every rank as single-device up to the order of the sums."""
        self.cfg = cfg
        self.device = resolve_device(device)
        if sharded:  # before any tensor: under torchrun a rank's GPU
            from fem_tpu_torch.parallel.sharding import init_ranks

            init_ranks(self.device)
        self.scene: List[SceneObject]
        self.scene, self.obstacles = load_scene(cfg, interior_spacing,
                                                device=self.device)
        self._contact_frame, self._frame_fns = None, []
        objs = [s.obj for s in self.scene]
        if sharded:
            from fem_tpu_torch.parallel import sharding

            mesh = sharding.make_element_mesh(device=self.device)
            if contact_scene(cfg, len(self.scene)):
                self._contact_frame = sharding.make_sharded_contact_frame_fn(
                    objs, cfg, mesh)
            else:
                self._frame_fns = [sharding.make_sharded_frame_fn(o, cfg, mesh)
                                   for o in objs]
        elif contact_scene(cfg, len(self.scene)):
            self._contact_frame = make_contact_frame_fn(objs, cfg)
        else:
            self._frame_fns = [make_frame_fn(o, cfg) for o in objs]
        self.virtual_time = 0.0
        self.frame_count = 0
        self.last_aux = None

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_config(cls, path: str, **kw) -> "Simulation":
        return cls(read_config(path), **kw)

    @classmethod
    def from_dict(cls, data: dict, **kw) -> "Simulation":
        return cls(parse_config(data), **kw)

    # -- stepping ---------------------------------------------------------
    def step_frame(self) -> None:
        """Advance one rendered frame (``sim_count`` substeps) of every
        body; nothing is read back.  Coupled by contact, the bodies advance
        jointly and ``last_aux`` is the last body's, as in the JAX
        package; the clock advances once either way."""
        if self._contact_frame is not None:
            states, auxes = self._contact_frame(
                tuple(s.state for s in self.scene), self.obstacles)
            for s, st in zip(self.scene, states):
                s.state = st
            self.last_aux = auxes[-1]
        else:
            for s, fn in zip(self.scene, self._frame_fns):
                s.state, self.last_aux = fn(s.state, self.obstacles)
        self.virtual_time += self.cfg.sim_count * self.cfg.delta_time
        self.frame_count += 1

    def run(self, seconds: Optional[float] = None,
            frames: Optional[int] = None, nan_guard: bool = False) -> None:
        """Advance by virtual ``seconds`` or an explicit ``frames`` count;
        ``nan_guard`` checks body 0 after every frame
        (``utils/profiling.check_state``: one small read back a frame)."""
        if frames is None:
            if seconds is None:
                raise ValueError("pass seconds= or frames=")
            frames = int(seconds / (self.cfg.sim_count * self.cfg.delta_time))
        for _ in range(frames):
            self.step_frame()
            if nan_guard:
                check_state(self.scene[0].obj, self.scene[0].state,
                            self.frame_count * self.cfg.sim_count)

    # -- the analysis solvers -----------------------------------------------
    def solve_static(self, gravity: bool = True, index: Optional[int] = None,
                     **kw) -> list:
        """Solve each body (or just ``index``) to quasi-static equilibrium
        under gravity (``cfg.g_dir``; none with ``gravity=False``) and set
        its state there with zero velocity (``solvers/static.py``: Newton
        on the pinned body; ``kw`` its settings).  Returns the
        ``StaticResult`` list."""
        from fem_tpu_torch.solvers.static import solve_static as _solve

        results = []
        targets = self.scene if index is None else [self.scene[index]]
        for s in targets:
            res = _solve(s.obj, s.state.pos,
                         g_dir=self.cfg.g_dir if gravity else None, **kw)
            zeros = torch.zeros_like(s.state.pos)
            s.state = s.state.replace(pos=res.pos, vel=zeros, vel_g=zeros,
                                      force=zeros)
            results.append(res)
        return results

    def modes(self, k: int = 6, index: int = 0, at_equilibrium: bool = False,
              method: str = "chebyshev", **kw):
        """Smallest-``k`` natural frequencies and M-orthonormal mode shapes
        of body ``index`` linearized at its current state (at the static
        equilibrium first with ``at_equilibrium=True``, which needs
        ``pin_boxes``): ``solvers/modal.py``.  Returns a ``ModalResult``;
        an unpinned body reports its rigid motions as the leading ω ≈ 0
        modes.  ``method``: "chebyshev" (filtered subspace iteration, the
        default), "shift_invert" (LOBPCG with inner CG solves) or
        "sparse_f64" (the direct f64 oracle: exact element Hessians and
        scipy's ARPACK on the host).  ``refine_f64=True`` follows the f32
        solve with a float64 Chebyshev pass on the body's device
        (``modal_refine_f64``)."""
        from fem_tpu_torch.solvers import modal

        refine = bool(kw.pop("refine_f64", False))
        if at_equilibrium:
            self.solve_static(index=index)
        s = self.scene[index]
        if method == "sparse_f64":
            return modal.modal_analysis_sparse_f64(s.obj, s.state.pos, k=k)
        if method == "chebyshev":
            res = modal.modal_analysis_chebyshev(s.obj, s.state.pos, k=k,
                                                 **kw)
        else:
            res = modal.modal_analysis(s.obj, s.state.pos, k=k, **kw)
        if refine:
            res = modal.modal_refine_f64(s.obj, s.state.pos, result=res, k=k)
        return res

    def buckling(self, k: int = 4, index: int = 0,
                 f_ext: Optional[np.ndarray] = None,
                 gravity: bool = False, **kw):
        """Linearized buckling of body ``index`` (``solvers/buckling.py``):
        the critical multipliers λ of the applied load (``f_ext`` per
        vertex, gravity with ``gravity``, and the body's ``load_boxes``) at
        which K₀ + λ·K_g goes singular, and the buckling modes.  Requires
        ``pin_boxes``.  Returns a ``BucklingResult``."""
        from fem_tpu_torch.solvers.buckling import linear_buckling

        s = self.scene[index]
        return linear_buckling(
            s.obj, s.state.pos,
            f_ext=None if f_ext is None else torch.as_tensor(
                f_ext, dtype=s.state.pos.dtype, device=self.device),
            g_dir=self.cfg.g_dir if gravity else None, k=k, **kw)

    def harmonic(self, f_hat: np.ndarray, freqs_hz: np.ndarray,
                 k: int = 6, index: int = 0, modal=None, **kw):
        """Steady-state frequency response of body ``index`` to the load
        amplitude ``f_hat`` (N, d) over ``freqs_hz`` by modal superposition
        on the smallest-``k`` modes (or a precomputed ``modal``):
        ``solvers/harmonic.py``; ``alpha=``/``beta=`` or ``zeta=``.
        Returns a ``HarmonicResult``."""
        from fem_tpu_torch.solvers.harmonic import harmonic_response

        if modal is None:
            modal = self.modes(k=k, index=index)
        return harmonic_response(modal, torch.as_tensor(f_hat),
                                 torch.as_tensor(freqs_hz), **kw)

    def response_spectrum(self, accel: np.ndarray, dt: float,
                          direction, k: int = 6, index: int = 0,
                          zeta: float = 0.05, combination: str = "cqc",
                          modal=None):
        """Response-spectrum analysis of body ``index`` under a rigid base
        excitation along ``direction`` (``solvers/spectrum.py``): the
        displacement spectrum of the ground-acceleration record ``accel``
        (sampled at ``dt``) at the modal frequencies, the per-mode peaks
        combined by ``combination`` ("cqc" | "srss" | "abssum").  Requires
        ``pin_boxes``.  Returns an ``RSResult``."""
        from fem_tpu_torch.solvers.spectrum import (
            response_spectrum as _spectrum,
            response_spectrum_analysis,
        )

        if modal is None:
            modal = self.modes(k=k, index=index)
        omegas = torch.sqrt(torch.clamp(modal.omega_sq, min=0.0))
        sp = _spectrum(accel, dt, omegas, zeta=zeta)
        return response_spectrum_analysis(
            modal, self.scene[index].obj.mass, direction, spectrum=sp,
            zeta=zeta, combination=combination)

    def arc_length(self, f_pattern: np.ndarray, index: int = 0, **kw):
        """Arc-length (Riks) continuation of body ``index`` under the load
        λ·``f_pattern`` (``solvers/riks.py``): the equilibrium path through
        limit points, in float64 with direct sparse tangent solves.
        Requires ``pin_boxes``.  Returns an ``ArcLengthResult``; the
        simulation state is not changed."""
        from fem_tpu_torch.solvers.riks import arc_length_path

        s = self.scene[index]
        return arc_length_path(s.obj, s.state.pos,
                               torch.as_tensor(f_pattern), **kw)

    # -- observation ------------------------------------------------------
    def metrics(self, index: int = 0) -> FrameMetrics:
        s = self.scene[index]
        return frame_metrics(s.obj, s.state)

    def positions(self, index: int = 0) -> np.ndarray:
        return to_numpy(self.scene[index].state.pos)

    def stress(self, index: int = 0) -> np.ndarray:
        """Per-element Cauchy stress tensors (E, d, d) at the current state
        (``ops/element.cauchy_stress``)."""
        s = self.scene[index]
        return to_numpy(element_stresses(
            s.state.pos, s.obj.element_indices, s.obj.ref_inv, s.obj.mu,
            s.obj.s_lambda, s.obj.material))

    def von_mises(self, index: int = 0) -> np.ndarray:
        """Per-element von Mises equivalent stress (E,)."""
        s = self.scene[index]
        return to_numpy(element_von_mises(s.obj, s.state))

    def render(self, msgs: Sequence[str] = (),
               color: str = "energy") -> np.ndarray:
        """RGB frame (640×640 uint8) of the current state, all bodies.
        ``color="energy"`` tints 2D triangles by V·φ (the reference's
        look), ``"stress"`` by von Mises stress over the scene's maximum.
        Needs matplotlib (``ImportError`` without it)."""
        from fem_tpu_torch.render.raster import render_frame_2d, render_frame_3d

        pos = [to_numpy(s.state.pos) for s in self.scene]
        faces = [to_numpy(s.obj.faces) for s in self.scene]
        if self.cfg.dim == 2:
            if color == "stress":
                vm = [self.von_mises(i) for i in range(len(self.scene))]
                peak = max(float(v.max()) for v in vm) or 1.0
                phi = [v / peak for v in vm]
            else:
                phi = [to_numpy(element_phi(s.obj, s.state))
                       for s in self.scene]
            return render_frame_2d(pos, faces, phi,
                                   to_numpy(self.obstacles.centers),
                                   to_numpy(self.obstacles.radii), msgs)
        return render_frame_3d(pos, faces, msgs)

    # -- persistence ------------------------------------------------------
    def save_checkpoint(self, path: str, index: int = 0) -> None:
        fio.save_checkpoint(path, self.scene[index].state, self.frame_count,
                            self.virtual_time)

    def load_checkpoint(self, path: str, index: int = 0) -> None:
        state, frame, vt = fio.load_checkpoint(path, self.device)
        self.scene[index].state = state
        self.frame_count = frame
        self.virtual_time = vt

    def export_obj(self, path: str, index: int = 0) -> None:
        s = self.scene[index]
        if "map_index" not in s.aux:
            raise ValueError("OBJ export requires a 3D mesh-file object")
        fio.export_deformed_obj(path, s.state.pos, s.aux["obj_vertices"],
                                s.aux["obj_faces"], s.aux["map_index"])

    def export_vtu(self, path: str, index: int = 0) -> None:
        """Write the body's volume mesh and fields as a VTK ``.vtu``
        snapshot (``utils/vtu.py``): point velocity and mass, per-cell von
        Mises stress and det F."""
        from fem_tpu_torch.utils.vtu import write_vtu

        s = self.scene[index]
        f_def = to_numpy(deformation_gradients(
            s.state.pos, s.obj.element_indices, s.obj.ref_inv))
        write_vtu(
            path,
            to_numpy(s.state.pos),
            to_numpy(s.obj.element_indices),
            point_data={"velocity": to_numpy(s.state.vel),
                        "mass": to_numpy(s.obj.mass)},
            cell_data={
                "von_mises": self.von_mises(index),
                "det_F": np.linalg.det(f_def.astype(np.float64)).astype(
                    np.float32),
            },
        )

    def __repr__(self) -> str:
        bodies = ", ".join(
            f"{s.obj.particle_cnt}p/{s.obj.element_cnt}e" for s in self.scene
        )
        return (
            f"<Simulation dim={self.cfg.dim} t={self.virtual_time:.4f}s "
            f"bodies=[{bodies}] {method_banner(self.cfg)!r}>"
        )
