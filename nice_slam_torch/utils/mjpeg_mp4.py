"""A Motion-JPEG video in an MP4 (ISO base media) container, in numpy
and the stdlib.

The machines the port runs on need not have OpenCV or FFmpeg, so the
replay viewer writes its video with this: every frame a baseline JPEG
from the port's encoder (``utils/jpeg.py``, 4:2:0 chroma), one video
track whose sample entry is 'jpeg' (Photo-JPEG), the frames in one chunk
of the 'mdat' box, and the 'moov' box after it.  FFmpeg (and so
OpenCV's ``VideoCapture``) and the common players read it.
"""

from __future__ import annotations

import struct
from typing import Sequence

import numpy as np

from nice_slam_torch.utils.jpeg import encode_jpeg

_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def _box(kind: bytes, *payload: bytes) -> bytes:
    body = b"".join(payload)
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full(kind: bytes, version: int, flags: int, *payload: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags), *payload)


def mp4_bytes(jpegs: Sequence[bytes], W: int, H: int, fps: float) -> bytes:
    """The file holding the JPEG frames ``jpegs`` (each W x H) at ``fps``."""
    n = len(jpegs)
    if sum(map(len, jpegs)) + 1024 >= 2 ** 32:
        raise ValueError("a video past 4 GiB needs 64-bit boxes, which this writer lacks")
    timescale = int(round(fps * 1000))
    delta = 1000
    duration_ms = int(round(1000 * n / fps))
    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 512), b"isomiso2mp41")
    mdat_offset = len(ftyp) + 8  # the first frame, past mdat's header
    mdat = _box(b"mdat", *jpegs)
    mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000, duration_ms),
                 struct.pack(">IH", 0x10000, 0x100), bytes(10), _MATRIX, bytes(24),
                 struct.pack(">I", 2))
    tkhd = _full(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, duration_ms),
                 bytes(8), struct.pack(">hhhH", 0, 0, 0, 0), _MATRIX,
                 struct.pack(">II", W << 16, H << 16))
    mdhd = _full(b"mdhd", 0, 0, struct.pack(">IIII", 0, 0, timescale, n * delta),
                 struct.pack(">HH", 0x55C4, 0))  # language 'und'
    hdlr = _full(b"hdlr", 0, 0, bytes(4), b"vide", bytes(12), b"VideoHandler\0")
    vmhd = _full(b"vmhd", 0, 1, bytes(8))
    dinf = _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1),
                               _full(b"url ", 0, 1)))
    name = b"Photo - JPEG"
    entry = _box(b"jpeg", bytes(6), struct.pack(">H", 1), bytes(16),
                 struct.pack(">HHIIIH", W, H, 0x480000, 0x480000, 0, 1),
                 bytes([len(name)]) + name + bytes(31 - len(name)),
                 struct.pack(">Hh", 0x18, -1))
    stbl = _box(b"stbl",
                _full(b"stsd", 0, 0, struct.pack(">I", 1), entry),
                _full(b"stts", 0, 0, struct.pack(">III", 1, n, delta)),
                _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1)),
                _full(b"stsz", 0, 0, struct.pack(">II", 0, n),
                      struct.pack(f">{n}I", *[len(j) for j in jpegs])),
                _full(b"stco", 0, 0, struct.pack(">II", 1, mdat_offset)))
    minf = _box(b"minf", vmhd, dinf, stbl)
    trak = _box(b"trak", tkhd, _box(b"mdia", mdhd, hdlr, minf))
    return ftyp + mdat + _box(b"moov", mvhd, trak)


def write_mp4(path: str, frames: Sequence[np.ndarray], fps: float = 30.0) -> str:
    """Write (H, W, 3) uint8 RGB frames of one size as a Motion-JPEG MP4."""
    H, W = frames[0].shape[:2]
    if any(f.shape != frames[0].shape for f in frames):
        raise ValueError("every frame of a video must have one size")
    jpegs = [encode_jpeg(f, 90, libjpeg_defaults=True) for f in frames]
    with open(path, "wb") as f:
        f.write(mp4_bytes(jpegs, W, H, fps))
    return path


def read_mp4_jpegs(path: str) -> list:
    """The JPEG frames of a file ``write_mp4`` wrote, in order (read back
    through its 'stsz' and 'stco' boxes)."""
    with open(path, "rb") as f:
        data = f.read()

    def find(buf, kind, start=0, end=None):
        end = len(buf) if end is None else end
        i = start
        while i + 8 <= end:
            size, k = struct.unpack_from(">I4s", buf, i)
            if size < 8:
                raise ValueError(f"box {k!r} of size {size}: not a file write_mp4 wrote")
            if k == kind:
                return i + 8, i + size
            i += size
        raise ValueError(f"no {kind!r} box")

    s, e = find(data, b"moov")
    for kind in (b"trak", b"mdia", b"minf", b"stbl"):
        s, e = find(data, kind, s, e)
    ss, _ = find(data, b"stsz", s, e)
    _, n = struct.unpack_from(">II", data, ss + 4)
    sizes = struct.unpack_from(f">{n}I", data, ss + 12)
    cs, _ = find(data, b"stco", s, e)
    (offset,) = struct.unpack_from(">I", data, cs + 8)
    out = []
    for size in sizes:
        out.append(data[offset:offset + size])
        offset += size
    return out
