"""A PNG writer in numpy and the standard library's ``zlib``, for the
synthetic dataset export: 8-bit RGB colour and 16-bit gray depth (the
two kinds of PNG the real datasets ship), every row with filter type 0
(None), so the file is exactly the samples, deflated."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB image or an (H, W) uint16 gray image."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        depth, color_type, rows = 8, 2, img.reshape(img.shape[0], -1)
    elif img.dtype == np.uint16 and img.ndim == 2:
        depth, color_type, rows = 16, 0, img.astype(">u2").view(np.uint8)
    else:
        raise ValueError(f"expected (H, W, 3) uint8 or (H, W) uint16, got "
                         f"{img.shape} {img.dtype}")
    H, W = img.shape[:2]
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], axis=1)
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, color_type, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)
