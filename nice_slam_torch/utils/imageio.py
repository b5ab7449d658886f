"""Image reading and resampling without an imaging library.

The dataset readers need OpenCV's ``imread``, ``resize`` and
``undistort``; the machines the port runs on need not have OpenCV, so
this module gives the same pixels from the port's own code:

* ``imread_color`` / ``imread_unchanged`` decode baseline JPEG (the host
  decoder in ``csrc/image_codecs.cpp``: libjpeg's integer IDCT, fancy
  chroma upsampling and colour tables, as OpenCV's imread) and PNG
  (inflated with the standard library's ``zlib``, rows unfiltered in the
  same C++ library: 8-bit gray, RGB and RGBA, 16-bit gray and RGB).
  Progressive, arithmetic-coded, lossless and 12-bit JPEGs, and
  interlaced, palette and sub-byte PNGs, raise ``ValueError``.
* ``resize_linear`` is OpenCV's INTER_LINEAR on float32 (half-pixel
  centres, the source index and weight clamped at the border);
  ``resize_nearest`` is its INTER_NEAREST, which samples
  ``floor(i * src / dst)``, not the pixel centres.
* ``undistort`` is OpenCV's ``undistort`` with the camera matrix as the
  new one: the rectification map of ``initUndistortRectifyMap``, quantised
  to 1/32 px, then a bilinear remap with 15-bit weights and a constant-0
  border.  ``undistort_map`` computes the map once for a camera so that a
  reader can reuse it.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

from nice_slam_torch.ops import kernels

_U8 = ctypes.POINTER(ctypes.c_uint8)
_I32 = ctypes.POINTER(ctypes.c_int32)
_ERR_LEN = 256
_bound: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """The codec library with its C signatures bound."""
    global _bound
    if _bound is not None:
        return _bound
    lib = kernels.library("image_codecs")
    lib.jpeg_header.restype = ctypes.c_int
    lib.jpeg_header.argtypes = [ctypes.c_char_p, ctypes.c_int64, _I32,
                                ctypes.c_char_p, ctypes.c_int]
    lib.jpeg_decode.restype = ctypes.c_int
    lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, _U8,
                                ctypes.c_char_p, ctypes.c_int]
    lib.png_unfilter.restype = ctypes.c_int
    lib.png_unfilter.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int, _U8, ctypes.c_char_p, ctypes.c_int]
    lib.remap_bilinear_u8.restype = None
    lib.remap_bilinear_u8.argtypes = [_U8, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      _I32, _I32, ctypes.c_int64, _I32, _U8]
    _bound = lib
    return lib


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(typ)


def decode_jpeg(data: bytes) -> np.ndarray:
    """A baseline JPEG's pixels: (H, W) gray or (H, W, 3) RGB, uint8."""
    lib = _lib()
    err = ctypes.create_string_buffer(_ERR_LEN)
    dims = np.zeros(3, np.int32)
    if lib.jpeg_header(data, len(data), _ptr(dims, _I32), err, _ERR_LEN):
        raise ValueError(err.value.decode())
    H, W, C = (int(v) for v in dims)
    out = np.empty((H, W, 3) if C == 3 else (H, W), np.uint8)
    if lib.jpeg_decode(data, len(data), _ptr(out, _U8), err, _ERR_LEN):
        raise ValueError(err.value.decode())
    return out


_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # gray, RGB, RGBA


def decode_png(data: bytes) -> np.ndarray:
    """A PNG's samples in the file's channel order: (H, W) gray, (H, W, 3)
    RGB or (H, W, 4) RGBA, uint8 or (16-bit files) native-order uint16."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG file without IHDR or IDAT")
    W, H, depth, color_type, _, _, interlace = header
    if color_type not in _PNG_CHANNELS:
        raise ValueError(f"unsupported PNG colour type {color_type} "
                         "(gray, RGB and RGBA are supported)")
    if depth not in (8, 16):
        raise ValueError(f"unsupported PNG bit depth {depth} (8 and 16 are supported)")
    if interlace:
        raise ValueError("unsupported PNG: Adam7 interlacing")
    C = _PNG_CHANNELS[color_type]
    bpp = C * depth // 8
    raw = zlib.decompress(b"".join(idat))
    rowbytes = W * bpp
    if len(raw) < H * (rowbytes + 1):
        raise ValueError("truncated PNG image data")
    out = np.empty((H, rowbytes), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if _lib().png_unfilter(raw, H, rowbytes, bpp, _ptr(out, _U8), err, _ERR_LEN):
        raise ValueError(err.value.decode())
    img = out.view(">u2").astype(np.uint16) if depth == 16 else out
    img = img.reshape(H, W, C)
    return img[..., 0] if C == 1 else img


def _read(path: str) -> Tuple[str, bytes]:
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _PNG_SIG:
        return "png", data
    if data[:2] == b"\xff\xd8":
        return "jpeg", data
    raise ValueError(f"{path}: neither a JPEG nor a PNG file")


def imread_color(path: str) -> np.ndarray:
    """An 8-bit image file as (H, W, 3) RGB uint8 (gray replicated, alpha
    dropped), the pixels of ``cv2.imread(path)`` in RGB order."""
    kind, data = _read(path)
    img = decode_jpeg(data) if kind == "jpeg" else decode_png(data)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: 16-bit colour images are not supported")
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def imread_unchanged(path: str) -> np.ndarray:
    """What ``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` returns for a JPEG
    or PNG: gray (H, W), colour in OpenCV's BGR / BGRA order, uint8 or
    uint16."""
    kind, data = _read(path)
    img = decode_jpeg(data) if kind == "jpeg" else decode_png(data)
    if img.ndim == 3:
        order = [2, 1, 0, 3][:img.shape[2]]
        img = np.ascontiguousarray(img[..., order])
    return img


def _linear_taps(src: int, dst: int, clamp_weight: bool):
    """OpenCV's INTER_LINEAR taps along one axis: (index0, index1, w0, w1)
    per destination position.  The x axis zeroes the fraction where the
    index is clamped; the y axis keeps it and clamps only the rows."""
    f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    i0 = np.floor(f).astype(np.int64)
    frac = f - i0  # float64: the weights are rounded to float32 once
    if clamp_weight:
        frac[(i0 < 0) | (i0 >= src - 1)] = 0.0
        i0 = np.clip(i0, 0, src - 1)
        i1 = np.minimum(i0 + 1, src - 1)
    else:
        i1 = np.clip(i0 + 1, 0, src - 1)
        i0 = np.clip(i0, 0, src - 1)
    return i0, i1, (1.0 - frac).astype(np.float32), frac.astype(np.float32)


def resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """OpenCV's INTER_LINEAR resize of a float32 (H, W[, C]) image to
    ``size`` = (height, width)."""
    img = np.asarray(img, np.float32)
    th, tw = size
    H, W = img.shape[:2]
    x0, x1, ax0, ax1 = _linear_taps(W, tw, True)
    y0, y1, by0, by1 = _linear_taps(H, th, False)
    extra = (None,) * (img.ndim - 2)
    rows = img[:, x0] * ax0[(None, slice(None)) + extra] \
        + img[:, x1] * ax1[(None, slice(None)) + extra]
    out = rows[y0] * by0[(slice(None), None) + extra] \
        + rows[y1] * by1[(slice(None), None) + extra]
    return out.astype(np.float32)


def resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """OpenCV's INTER_NEAREST resize to ``size`` = (height, width): output
    pixel i reads source pixel floor(i * src / dst)."""
    th, tw = size
    H, W = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(th) * (H / th)).astype(np.int64), H - 1)
    xs = np.minimum(np.floor(np.arange(tw) * (W / tw)).astype(np.int64), W - 1)
    return img[ys][:, xs]


def _remap_weights() -> np.ndarray:
    """OpenCV's bilinear remap table: for each of the 32 x 32 sub-pixel
    positions (row-major, y then x) the four corner weights (0,0), (0,1),
    (1,0), (1,1) in 15-bit fixed point: the products of the float32 1-D
    weights, rounded, the difference of their sum from 32768 taken off the
    first largest weight (sum too small) or the first smallest (too
    large)."""
    t = np.arange(32, dtype=np.float32) / np.float32(32)
    w1 = np.stack([np.float32(1) - t, t], axis=1)  # (32, 2)
    v = (w1[:, None, :, None] * w1[None, :, None, :]).reshape(32, 32, 4)
    it = np.rint(v * np.float32(32768)).astype(np.int32).reshape(-1, 4)
    diff = it.sum(axis=1) - 32768
    rows = np.arange(len(it))
    corner = np.where(diff < 0, np.argmax(it, axis=1), np.argmin(it, axis=1))
    it[rows, corner] -= diff
    return it


_REMAP_W = _remap_weights()


def undistort_map(K: np.ndarray, dist, H: int, W: int) -> Tuple[np.ndarray, np.ndarray]:
    """The source position of every output pixel of ``undistort(img, K,
    dist)`` in 1/32 px, as int32 (x, y) arrays of shape (H, W): the
    distortion model (k1, k2, p1, p2[, k3[, k4, k5, k6]]) applied to the
    normalised pinhole ray, computed in float64 in OpenCV's order
    (stripes of rows, each with the camera's cy shifted to its first row,
    the column terms accumulated) and rounded to the nearest 1/32."""
    K = np.asarray(K, np.float64)
    k = np.zeros(8, np.float64)
    d = np.asarray(dist, np.float64).ravel()
    k[:len(d)] = d
    k1, k2, p1, p2, k3, k4, k5, k6 = k
    fx, fy, u0, v0 = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    stripe = min(max(1, (1 << 12) // max(W, 1)), H)
    ix = np.empty((H, W), np.int32)
    iy = np.empty((H, W), np.int32)
    for y0 in range(0, H, stripe):
        n = min(stripe, H - y0)
        Ar = K.copy()
        Ar[1, 2] = v0 - y0
        ir = np.linalg.inv(Ar).ravel()
        i = np.arange(n, dtype=np.float64)[:, None]
        _x = np.cumsum(np.concatenate(
            [i * ir[1] + ir[2], np.broadcast_to(ir[0], (n, W - 1))], axis=1), axis=1)
        _y = np.cumsum(np.concatenate(
            [i * ir[4] + ir[5], np.broadcast_to(ir[3], (n, W - 1))], axis=1), axis=1)
        _w = np.cumsum(np.concatenate(
            [i * ir[7] + ir[8], np.broadcast_to(ir[6], (n, W - 1))], axis=1), axis=1)
        w = 1.0 / _w
        x, y = _x * w, _y * w
        x2, y2 = x * x, y * y
        r2 = x2 + y2
        _2xy = 2 * x * y
        kr = (1 + ((k3 * r2 + k2) * r2 + k1) * r2) / (1 + ((k6 * r2 + k5) * r2 + k4) * r2)
        u = fx * (x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)) + u0
        v = fy * (y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy) + v0
        ix[y0:y0 + n] = np.rint(u * 32)
        iy[y0:y0 + n] = np.rint(v * 32)
    return ix, iy


def remap(img: np.ndarray, maps: Tuple[np.ndarray, np.ndarray]) -> np.ndarray:
    """Bilinear remap of an (H, W[, C]) uint8 image at the 1/32-px source
    positions ``maps`` (from ``undistort_map``), constant-0 border."""
    src = np.ascontiguousarray(img, np.uint8)
    if src.ndim not in (2, 3):
        raise ValueError(f"expected an (H, W[, C]) image, got {src.shape}")
    ix = np.ascontiguousarray(maps[0], np.int32)
    iy = np.ascontiguousarray(maps[1], np.int32)
    H, W = src.shape[:2]
    C = 1 if src.ndim == 2 else src.shape[2]
    out = np.empty(ix.shape + src.shape[2:], np.uint8)
    _lib().remap_bilinear_u8(_ptr(src, _U8), H, W, C, _ptr(ix, _I32), _ptr(iy, _I32),
                             ix.size, _ptr(_REMAP_W, _I32), _ptr(out, _U8))
    return out


def undistort(img: np.ndarray, K: np.ndarray, dist) -> np.ndarray:
    """``cv2.undistort(img, K, dist)`` of a uint8 (H, W[, C]) image (a
    reader that undistorts every frame keeps ``undistort_map`` and calls
    ``remap``)."""
    return remap(img, undistort_map(K, dist, img.shape[0], img.shape[1]))
