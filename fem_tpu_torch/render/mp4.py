# coding=utf-8
"""Dependency-free MP4 (ISO BMFF) muxer for Motion-JPEG video.

A copy of the JAX package's ``render/mp4.py``.  The reference's
``VideoManager.make_video(gif=True, mp4=True)`` (render/render.py:22,
main.py:131-133) shells out to ffmpeg for the mp4; without ffmpeg this
module writes the ISO base-media container directly: one video track
whose samples are JPEG images, declared as an MPEG-4 visual stream with
objectTypeIndication 0x6C (ISO/IEC 10918-1 = JPEG) in the ``esds``
descriptor — the same codec identification ffmpeg emits for ``-c:v
mjpeg`` in an .mp4, decoded by mainstream players (ffmpeg/VLC/QuickTime).

Layout: ``ftyp`` + ``mdat`` (concatenated JPEG frames) + ``moov`` written
last so the chunk-offset table (``stco``) can point at absolute file
offsets inside the already-written ``mdat``.
"""

from __future__ import annotations

import struct
from typing import List, Sequence

import numpy as np


def _box(fourcc: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + fourcc + payload


def _full_box(fourcc: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(fourcc, struct.pack(">I", (version << 24) | flags) + payload)


def _descriptor(tag: int, payload: bytes) -> bytes:
    """MPEG-4 descriptor with the expandable length field (14496-1 §8.3.3):
    7 bits per byte, high bit = continuation."""
    size = len(payload)
    lenbytes = [size & 0x7F]
    size >>= 7
    while size:
        lenbytes.append(0x80 | (size & 0x7F))
        size >>= 7
    return bytes([tag]) + bytes(reversed(lenbytes)) + payload


def _esds(avg_bitrate: int, max_sample: int) -> bytes:
    """ES_Descriptor for a JPEG visual stream."""
    # DecoderConfigDescriptor (tag 0x04): OTI 0x6C (JPEG, 10918-1),
    # streamType 4 (visual) << 2 | reserved 1.
    dec_cfg = _descriptor(
        0x04,
        struct.pack(
            ">BBBHII",
            0x6C,  # objectTypeIndication: Visual ISO/IEC 10918-1 (JPEG)
            (4 << 2) | 1,  # streamType visual, upStream 0, reserved 1
            (max_sample >> 16) & 0xFF,  # bufferSizeDB, 24-bit
            max_sample & 0xFFFF,
            max(avg_bitrate, 1),  # maxBitrate
            max(avg_bitrate, 1),  # avgBitrate
        ),
    )
    sl_cfg = _descriptor(0x06, b"\x02")  # SLConfig: predefined MP4
    es = _descriptor(
        0x03, struct.pack(">HB", 1, 0) + dec_cfg + sl_cfg
    )  # ES_ID 1, no flags
    return _full_box(b"esds", 0, 0, es)


def _sample_entry_mp4v(w: int, h: int, esds: bytes) -> bytes:
    """VisualSampleEntry 'mp4v' (14496-12 §12.1.3)."""
    payload = (
        b"\x00" * 6  # reserved
        + struct.pack(">H", 1)  # data_reference_index
        + struct.pack(">HH", 0, 0)  # pre_defined, reserved
        + b"\x00" * 12  # pre_defined[3]
        + struct.pack(">HH", w, h)
        + struct.pack(">II", 0x00480000, 0x00480000)  # 72 dpi
        + struct.pack(">I", 0)  # reserved
        + struct.pack(">H", 1)  # frame_count
        + b"\x00" * 32  # compressorname (pascal string, zeroed)
        + struct.pack(">Hh", 0x0018, -1)  # depth 24, pre_defined -1
        + esds
    )
    return _box(b"mp4v", payload)


def write_mjpeg_mp4(
    path: str, frames: Sequence[np.ndarray], fps: int = 30,
    quality: int = 90,
) -> None:
    """Write RGB uint8 frames (H, W, 3) as an MJPEG .mp4 file."""
    from fem_tpu_torch.render.avi import _jpeg_bytes

    if not frames:
        raise ValueError("no frames")
    fps = max(int(fps), 1)
    h, w = frames[0].shape[:2]
    jpegs: List[bytes] = [_jpeg_bytes(f, quality) for f in frames]
    n = len(jpegs)
    sizes = [len(j) for j in jpegs]
    max_sample = max(sizes)
    duration = n  # mdhd timescale = fps → one tick per frame
    avg_bitrate = int(sum(sizes) * 8 * fps / max(n, 1))

    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2mp41")
    mdat = _box(b"mdat", b"".join(jpegs))
    first_sample_offset = len(ftyp) + 8  # into mdat payload

    mvhd = _full_box(
        b"mvhd", 0, 0,
        struct.pack(">IIII", 0, 0, fps, duration)  # created/modified 0
        + struct.pack(">IHH", 0x00010000, 0x0100, 0)  # rate 1.0, volume 1.0
        + b"\x00" * 8  # reserved
        + struct.pack(  # unity matrix
            ">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000
        )
        + b"\x00" * 24  # pre_defined[6]
        + struct.pack(">I", 2),  # next_track_ID
    )
    tkhd = _full_box(
        b"tkhd", 0, 3,  # flags: enabled | in_movie
        struct.pack(">IIIII", 0, 0, 1, 0, duration)  # track_ID 1
        + b"\x00" * 8
        + struct.pack(">HHHH", 0, 0, 0, 0)  # layer, group, volume, reserved
        + struct.pack(
            ">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000
        )
        + struct.pack(">II", w << 16, h << 16),  # 16.16 fixed
    )
    mdhd = _full_box(
        b"mdhd", 0, 0,
        struct.pack(">IIIIHH", 0, 0, fps, duration, 0x55C4, 0),  # lang 'und'
    )
    hdlr = _full_box(
        b"hdlr", 0, 0,
        struct.pack(">I", 0) + b"vide" + b"\x00" * 12 + b"VideoHandler\x00",
    )
    vmhd = _full_box(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0))
    dref = _full_box(
        b"dref", 0, 0,
        struct.pack(">I", 1) + _full_box(b"url ", 0, 1, b""),
    )
    dinf = _box(b"dinf", dref)
    stsd = _full_box(
        b"stsd", 0, 0,
        struct.pack(">I", 1)
        + _sample_entry_mp4v(w, h, _esds(avg_bitrate, max_sample)),
    )
    stts = _full_box(
        b"stts", 0, 0, struct.pack(">III", 1, n, 1)
    )  # n samples, 1 tick each
    # One chunk holding every sample, declared once.
    stsc = _full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
    stsz = _full_box(
        b"stsz", 0, 0,
        struct.pack(">II", 0, n) + b"".join(struct.pack(">I", s) for s in sizes),
    )
    stco = _full_box(
        b"stco", 0, 0, struct.pack(">II", 1, first_sample_offset)
    )
    # All samples are sync samples (JPEG intra frames) → stss omitted.
    stbl = _box(b"stbl", stsd + stts + stsc + stsz + stco)
    minf = _box(b"minf", vmhd + dinf + stbl)
    mdia = _box(b"mdia", mdhd + hdlr + minf)
    trak = _box(b"trak", tkhd + mdia)
    moov = _box(b"moov", mvhd + trak)

    with open(path, "wb") as f:
        f.write(ftyp + mdat + moov)
