# coding=utf-8
"""Minimal dependency-free MJPEG-AVI video writer.

A copy of the JAX package's ``render/avi.py``.  The reference builds mp4+gif
through ffmpeg (`ti.tools.VideoManager`, render/render.py:22;
main.py:131-133).  Where neither ffmpeg nor the imageio-ffmpeg plugin is
installed, gif (via Pillow) is the only stock option; this module adds a
real video container: Motion-JPEG in a RIFF/AVI wrapper, written
directly — every mainstream player handles MJPEG AVI.
"""

from __future__ import annotations

import io
import struct
from typing import List, Sequence

import numpy as np


def _jpeg_bytes(frame: np.ndarray, quality: int = 90) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=quality)
    data = buf.getvalue()
    if len(data) % 2:  # RIFF chunks are word-aligned
        data += b"\0"
    return data


def write_mjpeg_avi(
    path: str, frames: Sequence[np.ndarray], fps: int = 30,
    quality: int = 90,
) -> None:
    """Write RGB uint8 frames (H, W, 3) as an MJPEG AVI file."""
    if not frames:
        raise ValueError("no frames")
    h, w = frames[0].shape[:2]
    n = len(frames)
    jpegs: List[bytes] = [_jpeg_bytes(f, quality) for f in frames]
    max_size = max(len(j) for j in jpegs)

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        return fourcc + struct.pack("<I", len(payload)) + payload

    def lst(fourcc: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", fourcc + payload)

    # avih: main AVI header.
    avih = struct.pack(
        "<IIIIIIIIIIIIII",
        int(1e6 // fps),  # microseconds per frame
        max_size * fps,  # max bytes per second (approx)
        0,  # padding granularity
        0x10,  # flags: AVIF_HASINDEX
        n,  # total frames
        0,  # initial frames
        1,  # number of streams
        max_size,  # suggested buffer size
        w, h, 0, 0, 0, 0,
    )
    # strh: stream header (video / MJPG).
    strh = (
        b"vids" + b"MJPG"
        + struct.pack("<IHHIIIIIIIIhhhh",
                      0, 0, 0, 0,  # flags, priority, language, initial frames
                      1, fps,      # scale, rate -> fps
                      0, n, max_size, 0xFFFFFFFF, 0,  # start, length, bufsize,
                                                      # quality, samplesize
                      0, 0, w, h)  # rcFrame
    )
    # strf: BITMAPINFOHEADER.
    strf = struct.pack(
        "<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0
    )
    hdrl = lst(
        b"hdrl",
        chunk(b"avih", avih)
        + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)),
    )

    movi_payload = b"".join(chunk(b"00dc", j) for j in jpegs)
    movi = lst(b"movi", movi_payload)

    # idx1: one entry per frame chunk, offsets relative to 'movi' fourcc.
    idx_entries = []
    offset = 4  # skip the 'movi' fourcc itself
    for j in jpegs:
        idx_entries.append(
            b"00dc" + struct.pack("<III", 0x10, offset, len(j))
        )
        offset += 8 + len(j)
    idx1 = chunk(b"idx1", b"".join(idx_entries))

    riff_payload = b"AVI " + hdrl + movi + idx1
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff_payload)) + riff_payload)
