# coding=utf-8
"""Headless rendering: offscreen rasterization to RGB frames.

A copy of the JAX package's ``render/raster.py``.  Compute hosts have no
display, so the reference's interactive ``ti.GUI`` / ``ti.ui.Window``
(render/render.py:26,30-43) becomes an offscreen matplotlib Agg
rasterizer producing the same imagery: 2D triangles colored by
per-element energy plus particle/obstacle circles
(render/render.py:64-84), and a 3D
wireframe mesh inside the [0,5]³ boundary box (render/render.py:86-106).
Frame pacing matches the reference: a frame is captured whenever
``virtual_time / frame_time`` passes the output counter
(render/render.py:77,101).

matplotlib (and imageio, Pillow for the videos) is imported when a
renderer is made or a frame is drawn, not when this module is imported: a
run that renders nothing needs none of them, and a render on a machine
without matplotlib raises ``ImportError``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


WIDTH = 640  # reference render/render.py:11-12
HEIGHT = 640
_ENERGY_BASE = 0.13  # reference render2d base_ (render/render.py:65)


def _pyplot():
    """matplotlib's pyplot on the offscreen Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _fig_to_rgb(fig) -> np.ndarray:
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    return buf.copy()


def render_frame_2d(
    pos,
    faces,
    phi,
    block_centers: np.ndarray,
    block_radii: np.ndarray,
    msgs: Sequence[str] = (),
) -> np.ndarray:
    """One 640×640 RGB frame of the 2D scene (render/render.py:64-84):
    energy-tinted triangles, particle dots, obstacle circles.

    ``pos``/``faces``/``phi`` may be single arrays or lists of per-body
    arrays — the reference draws every object in the scene
    (render/render.py:66).
    """
    from matplotlib.collections import PolyCollection

    plt = _pyplot()
    bodies = (
        list(zip(pos, faces, phi))
        if isinstance(pos, (list, tuple))
        else [(pos, faces, phi)]
    )
    fig = plt.figure(figsize=(WIDTH / 100, HEIGHT / 100), dpi=100)
    fig.patch.set_facecolor("black")  # ti.GUI default background
    ax = fig.add_axes([0, 0, 1, 1])
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.set_facecolor("black")
    ax.set_axis_off()

    for body_pos, body_faces, body_phi in bodies:
        tris = body_pos[body_faces]  # (M, 3, 2)
        # Reference color: rgb(phi + base, base, base) per triangle.
        r = np.clip(body_phi + _ENERGY_BASE, 0.0, 1.0)
        colors = np.stack(
            [r, np.full_like(r, _ENERGY_BASE), np.full_like(r, _ENERGY_BASE)],
            -1,
        )
        ax.add_collection(
            PolyCollection(tris, facecolors=colors, linewidths=0)
        )
        ax.scatter(body_pos[:, 0], body_pos[:, 1], s=4, c="#AAAA00",
                   linewidths=0)
    for c, rad in zip(block_centers, block_radii):
        if rad > 0:
            ax.add_patch(plt.Circle(c, rad, color="#343434"))
    for i, msg in enumerate(msgs):
        ax.text(0.02, 0.97 - 0.03 * i, msg, color="white", fontsize=8)
    rgb = _fig_to_rgb(fig)
    plt.close(fig)
    return rgb


_BOX_EDGES = [
    (0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7), (6, 7),
    (0, 4), (1, 5), (2, 6), (3, 7),
]  # reference render/render.py:59


# Reference lighting (render/render.py:93-94): ambient 0.8, white point
# light at (3.5, 3.5, 3.5); ti.ui's default mesh albedo is mid-gray.
_AMBIENT = 0.8
_LIGHT_POS = np.array([3.5, 3.5, 3.5])
_ALBEDO = np.array([0.73, 0.73, 0.73])


def _shade_faces(tris: np.ndarray) -> np.ndarray:
    """Per-face Lambertian colors for (M, 3, 3) triangles: ambient 0.8 +
    diffuse from the reference's point light, on a mid-gray albedo — the
    headless counterpart of ``scene.mesh`` under the reference's lights."""
    centers = tris.mean(axis=1)
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    l = _LIGHT_POS[None, :] - centers
    l /= np.maximum(np.linalg.norm(l, axis=1, keepdims=True), 1e-12)
    # Two-sided: surface orientation is CCW-outward from the mesher, but
    # |cos| keeps interior-facing normals lit rather than black.
    diff = np.abs(np.sum(n * l, axis=1))
    lum = np.clip(_AMBIENT + diff, 0.0, 1.6) / 1.6
    return np.clip(_ALBEDO[None, :] * lum[:, None], 0.0, 1.0)


def render_frame_3d(
    pos,
    faces,
    msgs: Sequence[str] = (),
    elev: float = 15.0,
    azim: float = -80.0,
    box: Tuple[float, float] = (0.0, 5.0),
    style: str = "shaded",
) -> np.ndarray:
    """One RGB frame of the 3D scene: lit surface mesh with wireframe
    overlay (the reference draws ``scene.mesh(..., show_wireframe=True)``
    under ambient + point lighting, render/render.py:86-106) + [0,5]³ box
    lines.  ``pos``/``faces`` may be lists of per-body arrays (the
    reference draws every object, render/render.py:97).
    ``style="wireframe"`` renders edges only (cheaper at very large
    surface counts)."""
    plt = _pyplot()
    from mpl_toolkits.mplot3d.art3d import Line3DCollection, Poly3DCollection

    bodies = (
        list(zip(pos, faces))
        if isinstance(pos, (list, tuple))
        else [(pos, faces)]
    )
    fig = plt.figure(figsize=(WIDTH / 100, HEIGHT / 100), dpi=100)
    ax = fig.add_axes([0, 0, 1, 1], projection="3d")
    lo, hi = box
    corners = np.array(
        [
            [lo, lo, lo], [lo, hi, lo], [hi, lo, lo], [hi, hi, lo],
            [lo, lo, hi], [lo, hi, hi], [hi, lo, hi], [hi, hi, hi],
        ]
    )
    box_lines = [(corners[a], corners[b]) for a, b in _BOX_EDGES]
    ax.add_collection3d(
        Line3DCollection(box_lines, colors=(0.99, 0.68, 0.28), linewidths=1.5)
    )
    for body_pos, body_faces in bodies:
        if not body_faces.shape[0]:
            continue
        if style == "shaded":
            tris = body_pos[body_faces]  # (M, 3, 3)
            coll = Poly3DCollection(
                tris,
                facecolors=_shade_faces(tris),
                edgecolors=(1.0, 1.0, 1.0, 0.25),
                linewidths=0.2,
                zsort="average",
            )
            ax.add_collection3d(coll)
            continue
        # Unique undirected edges: shared triangle edges drawn once (halves
        # the segment count, matplotlib's bottleneck at large meshes).
        e = np.concatenate(
            [
                body_faces[:, [0, 1]], body_faces[:, [1, 2]],
                body_faces[:, [2, 0]],
            ],
            axis=0,
        )
        e = np.unique(np.sort(e, axis=1), axis=0)
        ax.add_collection3d(
            Line3DCollection(body_pos[e], colors="white", linewidths=0.3)
        )
    ax.set_xlim(lo, hi)
    ax.set_ylim(lo, hi)
    ax.set_zlim(lo, hi)
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()
    ax.set_facecolor("black")
    fig.patch.set_facecolor("black")
    for i, msg in enumerate(msgs):
        ax.text2D(0.02, 0.97 - 0.03 * i, msg, color="white", fontsize=8,
                  transform=ax.transAxes)
    rgb = _fig_to_rgb(fig)
    plt.close(fig)
    return rgb


class HeadlessRenderer:
    """Frame-paced renderer + video writer (reference Render +
    ti.tools.VideoManager, render/render.py:9-23, 77-82)."""

    def __init__(
        self,
        dim: int,
        output_dir: str = "./output",
        output_fps: int = 60,
        is_output_gif: bool = False,
        camera: "Optional[Tuple[float, float]]" = None,
        style: str = "shaded",
    ):
        import os

        _pyplot()  # without matplotlib, raise here rather than at a frame
        self.dim = dim
        self.camera = camera  # (elev, azim) degrees; None = default view
        self.style = style  # 3D: "shaded" (reference ti.ui look) | "wireframe"
        self.output_dir = output_dir
        self.output_fps = output_fps
        self.frame_time = 1.0 / output_fps
        self.is_output_gif = is_output_gif
        self.output_frame_cnt = 0
        self.frames: List[np.ndarray] = []
        os.makedirs(output_dir, exist_ok=True)

    def maybe_capture(
        self,
        virtual_time: float,
        pos: np.ndarray,
        faces: np.ndarray,
        phi: Optional[np.ndarray],
        block_centers: np.ndarray,
        block_radii: np.ndarray,
        msgs: Sequence[str] = (),
    ) -> bool:
        """Capture a frame if the virtual clock has passed the next output
        slot (reference pacing, render/render.py:77,101)."""
        if not (virtual_time / self.frame_time > self.output_frame_cnt):
            return False
        if self.dim == 2:
            if phi is None:
                if isinstance(faces, (list, tuple)):
                    phi = [np.zeros(f.shape[0]) for f in faces]
                else:
                    phi = np.zeros(faces.shape[0])
            frame = render_frame_2d(
                pos, faces, phi, block_centers, block_radii, msgs,
            )
        else:
            if self.camera is not None:
                frame = render_frame_3d(
                    pos, faces, msgs, elev=self.camera[0],
                    azim=self.camera[1], style=self.style,
                )
            else:
                frame = render_frame_3d(pos, faces, msgs, style=self.style)
        self.frames.append(frame)
        self.output_frame_cnt += 1
        return True

    def make_video(self, gif: bool = True, mp4: bool = True) -> List[str]:
        """Write accumulated frames (reference: VideoManager.make_video,
        main.py:131-133) via imageio/ffmpeg."""
        import os

        written = []
        if not self.frames:
            return written
        import imageio.v2 as imageio

        if gif:
            path = os.path.join(self.output_dir, "video.gif")
            imageio.mimsave(path, self.frames, fps=min(self.output_fps, 50))
            written.append(path)
        if mp4:
            try:
                path = os.path.join(self.output_dir, "video.mp4")
                imageio.mimsave(path, self.frames, fps=self.output_fps)
                written.append(path)
            except Exception:
                # No ffmpeg backend installed — write a true
                # .mp4 with the dependency-free MJPEG muxer (render/mp4.py)
                # plus an MJPEG AVI (render/avi.py) for maximal player
                # coverage.  Reference parity: make_video(gif, mp4),
                # render/render.py:22.
                from fem_tpu_torch.render.avi import write_mjpeg_avi
                from fem_tpu_torch.render.mp4 import write_mjpeg_mp4

                path = os.path.join(self.output_dir, "video.mp4")
                write_mjpeg_mp4(path, self.frames, fps=self.output_fps)
                written.append(path)
                path = os.path.join(self.output_dir, "video.avi")
                write_mjpeg_avi(path, self.frames, fps=self.output_fps)
                written.append(path)
        return written
