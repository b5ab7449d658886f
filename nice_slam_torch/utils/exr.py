"""Minimal OpenEXR scanline codec (pure numpy + zlib).

CoFusion ships depth as OpenEXR files (reference reader:
src/utils/datasets.py:12-44, via the OpenEXR package).  Neither the
OpenEXR package nor an EXR-enabled OpenCV is a given (this image's cv2 is
built without OpenEXR), so the CoFusion path carries its own reader for
the subset of EXR that depth maps actually use:

  * single-part scanline images, EXR version 2
  * compression NONE (0), ZIPS (2, 1 line/block) and ZIP (3, 16 lines/block)
  * pixel types UINT (0), HALF (1) and FLOAT (2)

The writer emits ZIP-compressed FLOAT scanline files (what OpenEXR's
python bindings produce for float depth) and exists so tests can
manufacture real on-disk fixtures without network egress.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

_MAGIC = 20000630
_PIXEL_DTYPE = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}
_LINES_PER_BLOCK = {0: 1, 2: 1, 3: 16}  # NONE, ZIPS, ZIP


def _read_cstr(buf: bytes, off: int) -> Tuple[str, int]:
    end = buf.index(b"\0", off)
    return buf[off:end].decode("latin-1"), end + 1


def _zip_uncompress(data: bytes, expected: int) -> bytes:
    raw = np.frombuffer(zlib.decompress(data), np.uint8)
    if raw.size != expected:
        raise IOError("EXR zip block has wrong uncompressed size")
    # undo the delta predictor (ImfZip.cpp): out[i] = out[i-1] + raw[i] - 128
    d = raw.astype(np.int64)
    d[1:] -= 128
    out = (np.cumsum(d) % 256).astype(np.uint8)
    # de-interleave: first half -> even byte positions, second half -> odd
    half = (expected + 1) // 2
    res = np.empty(expected, np.uint8)
    res[0::2] = out[:half]
    res[1::2] = out[half:]
    return res.tobytes()


def _zip_compress(data: bytes) -> bytes:
    src = np.frombuffer(data, np.uint8)
    half = (src.size + 1) // 2
    inter = np.empty(src.size, np.uint8)
    inter[:half] = src[0::2]
    inter[half:] = src[1::2]
    # delta predictor: enc[i] = inter[i] - inter[i-1] + 128
    enc = inter.astype(np.int64)
    enc[1:] = (enc[1:] - enc[:-1].copy() + 128) % 256
    return zlib.compress(enc.astype(np.uint8).tobytes())


def read_exr(path: str) -> Dict[str, np.ndarray]:
    """Read a scanline EXR into {channel_name: (H, W) float32/uint32}."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise IOError(f"{path}: not an EXR file")
    # version-field feature bits (OpenEXR spec §"version field"):
    # 0x200 = single-part tiled, 0x800 = deep data, 0x1000 = multi-part
    if version & 0x200:
        raise IOError(f"{path}: tiled EXR not supported (scanline only)")
    if version & 0x800:
        raise IOError(f"{path}: deep-data EXR not supported")
    if version & 0x1000:
        raise IOError(f"{path}: multi-part EXR not supported")
    off = 8

    channels = []  # (name, pixel_type)
    compression = 0
    data_window = None
    while True:
        name, off = _read_cstr(buf, off)
        if not name:
            break
        atype, off = _read_cstr(buf, off)
        (size,) = struct.unpack_from("<i", buf, off)
        off += 4
        payload = buf[off:off + size]
        off += size
        if name == "channels" and atype == "chlist":
            p = 0
            while payload[p] != 0:
                cname, p = _read_cstr(payload, p)
                (ptype,) = struct.unpack_from("<i", payload, p)
                p += 16  # type + pLinear/reserved + xSampling + ySampling
                channels.append((cname, ptype))
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<4i", payload)

    if data_window is None or not channels:
        raise IOError(f"{path}: missing EXR header attributes")
    if compression not in _LINES_PER_BLOCK:
        raise IOError(f"{path}: unsupported EXR compression {compression} "
                      "(supported: NONE, ZIPS, ZIP)")
    xmin, ymin, xmax, ymax = data_window
    W, H = xmax - xmin + 1, ymax - ymin + 1
    channels.sort(key=lambda c: c[0])  # storage order is alphabetical
    lpb = _LINES_PER_BLOCK[compression]
    n_blocks = (H + lpb - 1) // lpb
    off += 8 * n_blocks  # skip the scanline offset table (blocks are in order)

    out = {c: np.empty((H, W), _PIXEL_DTYPE[t]) for c, t in channels}
    line_bytes = sum(W * _PIXEL_DTYPE[t].itemsize for _, t in channels)
    for _ in range(n_blocks):
        y, nbytes = struct.unpack_from("<ii", buf, off)
        off += 8
        raw = buf[off:off + nbytes]
        off += nbytes
        y0 = y - ymin
        lines = min(lpb, H - y0)
        expected = line_bytes * lines
        if compression in (2, 3) and nbytes < expected:
            raw = _zip_uncompress(raw, expected)
        p = 0
        for li in range(lines):
            for cname, ptype in channels:
                dt = _PIXEL_DTYPE[ptype]
                row = np.frombuffer(raw, dt, count=W, offset=p)
                out[cname][y0 + li] = row
                p += W * dt.itemsize
    return {c: (v.astype(np.float32) if v.dtype != np.dtype("<u4") else v)
            for c, v in out.items()}


def read_exr_depth(path: str) -> np.ndarray:
    """The depth plane of an EXR: channel 'Z'/'depth'/'Y' if present,
    otherwise the first channel (CoFusion writes single-channel files)."""
    planes = read_exr(path)
    for key in ("Z", "depth", "Y", "R"):
        if key in planes:
            return np.asarray(planes[key], np.float32)
    first = sorted(planes)[0]
    return np.asarray(planes[first], np.float32)


def write_exr(path: str, channels: Dict[str, np.ndarray],
              compression: int = 3) -> None:
    """Write float32 channels as a scanline EXR (default: ZIP blocks)."""
    names = sorted(channels)
    H, W = channels[names[0]].shape
    lpb = _LINES_PER_BLOCK[compression]

    def attr(name: str, atype: str, payload: bytes) -> bytes:
        return (name.encode() + b"\0" + atype.encode() + b"\0"
                + struct.pack("<i", len(payload)) + payload)

    chlist = b""
    for n in names:
        chlist += n.encode() + b"\0" + struct.pack("<i", 2)  # FLOAT
        chlist += struct.pack("<4B", 0, 0, 0, 0) + struct.pack("<2i", 1, 1)
    chlist += b"\0"
    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    header = (
        attr("channels", "chlist", chlist)
        + attr("compression", "compression", bytes([compression]))
        + attr("dataWindow", "box2i", box)
        + attr("displayWindow", "box2i", box)
        + attr("lineOrder", "lineOrder", b"\0")
        + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0))
        + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\0"
    )

    blocks = []
    for y0 in range(0, H, lpb):
        lines = min(lpb, H - y0)
        raw = b"".join(
            np.ascontiguousarray(channels[n][y0 + li], np.float32)
            .astype("<f4").tobytes()
            for li in range(lines) for n in names
        )
        if compression in (2, 3):
            comp = _zip_compress(raw)
            data = comp if len(comp) < len(raw) else raw
        else:
            data = raw
        blocks.append(struct.pack("<ii", y0, len(data)) + data)

    preamble = struct.pack("<ii", _MAGIC, 2) + header
    table_pos = len(preamble)
    data_pos = table_pos + 8 * len(blocks)
    offsets, cur = [], data_pos
    for b in blocks:
        offsets.append(cur)
        cur += len(b)
    with open(path, "wb") as f:
        f.write(preamble)
        f.write(struct.pack(f"<{len(offsets)}q", *offsets))
        for b in blocks:
            f.write(b)
