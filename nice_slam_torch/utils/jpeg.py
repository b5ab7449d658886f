"""A baseline JPEG writer in numpy, for the residual panels.

The machines the port runs on need not have an imaging library, so the
visualizer writes its ``.jpg`` panels with this: 8-bit baseline
sequential JPEG (JFIF), three components at 4:4:4, the standard
quantization tables scaled to ``quality`` as libjpeg scales them, and
Huffman tables that give every symbol a code of one length (4 bits for
the 12 DC categories, 9 bits for the 251 AC symbol values), which every
decoder accepts at the cost of a larger file.
"""

from __future__ import annotations

import struct

import numpy as np

# the JPEG standard's example quantization tables (ITU T.81 Annex K.1),
# row-major
_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.full(64, 99)
_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]
# zigzag position -> row-major index
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50,
    43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63])
_DC_BITS, _AC_BITS = 4, 9
_N_DC, _N_AC = 12, 251  # DC categories 0-11; AC symbols 0x00-0xFA
# the orthonormal 8-point DCT-II, which is JPEG's forward DCT
_U = np.arange(8)
_DCT = np.sqrt(np.where(_U == 0, 1.0, 2.0) / 8.0)[:, None] * np.cos(
    (2 * _U[None, :] + 1) * _U[:, None] * np.pi / 16)


def _scaled(table: np.ndarray, quality: int) -> np.ndarray:
    s = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((table * s + 50) // 100, 1, 255)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) with H, W multiples of 8 -> (H/8 * W/8, 8, 8), raster order."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)


def _category(v: np.ndarray) -> np.ndarray:
    """Bits needed for |v| (0 for 0)."""
    return np.where(v == 0, 0, np.floor(np.log2(np.maximum(np.abs(v), 1))).astype(np.int64) + 1)


def _amplitude(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    """JPEG's amplitude bits: v itself, or v - 1 in ones' complement below 0."""
    return np.where(v >= 0, v, v + (1 << size) - 1)


def _fields(coeffs: np.ndarray) -> tuple:
    """The Huffman-coded fields (values, bit lengths) of quantized zigzag
    coefficient blocks ``coeffs`` (n_blocks, 3, 64), in scan order."""
    vals, lens = [], []
    prev = np.zeros(3, np.int64)
    dc = coeffs[:, :, 0]
    diff = dc - np.concatenate([prev[None], dc[:-1]])
    dc_size = _category(diff)
    dc_amp = _amplitude(diff, dc_size)
    ac = coeffs[:, :, 1:]
    for b in range(coeffs.shape[0]):
        for c in range(3):
            vals += [int(dc_size[b, c]), int(dc_amp[b, c])]
            lens += [_DC_BITS, int(dc_size[b, c])]
            row = ac[b, c]
            nz = np.flatnonzero(row)
            last = -1
            for k in nz:
                run = k - last - 1
                while run > 15:
                    vals.append(0xF0)
                    lens.append(_AC_BITS)
                    run -= 16
                v = int(row[k])
                size = int(abs(v)).bit_length()
                vals += [(run << 4) | size, v if v >= 0 else v + (1 << size) - 1]
                lens += [_AC_BITS, size]
                last = k
            if last < 62:
                vals.append(0x00)  # EOB
                lens.append(_AC_BITS)
    return np.array(vals, np.uint64), np.array(lens, np.int64)


def _pack(vals: np.ndarray, lens: np.ndarray) -> bytes:
    """Concatenate the fields' bits MSB first, pad with ones to a byte and
    stuff a zero byte after every 0xFF."""
    keep = lens > 0
    vals, lens = vals[keep], lens[keep]
    total = int(lens.sum())
    owner = np.repeat(np.arange(len(lens)), lens)
    start = np.cumsum(lens) - lens
    shift = (lens[owner] - 1 - (np.arange(total) - start[owner])).astype(np.uint64)
    bits = ((vals[owner] >> shift) & np.uint64(1)).astype(np.uint8)
    pad = (-total) % 8
    bits = np.concatenate([bits, np.ones(pad, np.uint8)])
    data = np.packbits(bits)
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def _dht(table_class: int, table_id: int, n: int, length: int) -> bytes:
    bits = [0] * 16
    bits[length - 1] = n
    return bytes([(table_class << 4) | table_id, *bits, *range(n)])


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 90) -> None:
    """Write an (H, W, 3) uint8 RGB image as a baseline JPEG file."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape} {rgb.dtype}")
    H, W = rgb.shape[:2]
    x = rgb.astype(np.float64)
    ycc = np.stack([
        0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2],
        -0.168736 * x[..., 0] - 0.331264 * x[..., 1] + 0.5 * x[..., 2] + 128.0,
        0.5 * x[..., 0] - 0.418688 * x[..., 1] - 0.081312 * x[..., 2] + 128.0])
    ycc = np.pad(ycc, ((0, 0), (0, -H % 8), (0, -W % 8)), mode="edge")
    qt = [_scaled(_LUMA_Q, quality), _scaled(_CHROMA_Q, quality)]
    coeffs = []
    for c in range(3):
        blocks = _DCT @ (_blocks(ycc[c]) - 128.0) @ _DCT.T
        q = np.rint(blocks.reshape(-1, 64) / qt[min(c, 1)]).astype(np.int64)
        coeffs.append(q[:, _ZIGZAG])
    scan = _pack(*_fields(np.stack(coeffs, axis=1)))
    out = [b"\xff\xd8",
           _segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
           _segment(0xFFDB, bytes([0, *qt[0][_ZIGZAG]]) + bytes([1, *qt[1][_ZIGZAG]])),
           _segment(0xFFC0, struct.pack(">BHHB", 8, H, W, 3)
                    + bytes([1, 0x11, 0, 2, 0x11, 1, 3, 0x11, 1])),
           _segment(0xFFC4, _dht(0, 0, _N_DC, _DC_BITS) + _dht(1, 0, _N_AC, _AC_BITS)),
           _segment(0xFFDA, bytes([3, 1, 0x00, 2, 0x00, 3, 0x00, 0, 63, 0])),
           scan, b"\xff\xd9"]
    with open(path, "wb") as f:
        f.write(b"".join(out))
