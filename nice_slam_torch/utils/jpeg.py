"""A baseline JPEG writer in numpy, for the residual panels and the
synthetic dataset export.

The machines the port runs on need not have an imaging library, so the
visualizer writes its ``.jpg`` panels with this: 8-bit baseline
sequential JPEG (JFIF), three components, the standard quantization
tables scaled to ``quality`` as libjpeg scales them.  By default the
chroma is kept at 4:4:4 and the Huffman tables give every symbol a code
of one length (4 bits for the 12 DC categories, 9 bits for the 251 AC
symbol values), which every decoder accepts at the cost of a larger
file.  ``libjpeg_defaults=True`` writes what libjpeg (and so OpenCV)
writes by default instead: 4:2:0 chroma (2x2 means) and the example
Huffman tables of ITU T.81 Annex K.3.
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
# the orthonormal 8-point DCT-II, which is JPEG's forward DCT
_U = np.arange(8)
_DCT = np.sqrt(np.where(_U == 0, 1.0, 2.0) / 8.0)[:, None] * np.cos(
    (2 * _U[None, :] + 1) * _U[:, None] * np.pi / 16)

# Huffman tables as (BITS: codes per length 1-16, HUFFVAL: the symbols)
_FLAT_DC = ([0, 0, 0, 12] + [0] * 12, list(range(12)))
_FLAT_AC = ([0] * 8 + [251] + [0] * 7, list(range(251)))
# ITU T.81 Annex K.3: luminance and chrominance DC and AC tables
_K3_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_K3_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_K3_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125], list(bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f024"
    "33627282090a161718191a25262728292a3435363738393a434445464748494a53"
    "5455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")))
_K3_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119], list(bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f015"
    "6272d10a162434e125f11718191a262728292a35363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a8283848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")))


def _codes(table) -> tuple:
    """Canonical Huffman codes of a (BITS, HUFFVAL) table: (code, length)
    arrays indexed by symbol (length 0 for a symbol not in the table)."""
    bits, vals = table
    code_of = np.zeros(256, np.uint64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, count in enumerate(bits, start=1):
        for _ in range(count):
            code_of[vals[k]] = code
            len_of[vals[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _scaled(table: np.ndarray, quality: int) -> np.ndarray:
    s = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((table * s + 50) // 100, 1, 255)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) with H, W multiples of 8 -> (H/8, W/8, 8, 8)."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _category(v: np.ndarray) -> np.ndarray:
    """Bits needed for |v| (0 for 0)."""
    return np.where(v == 0, 0, np.floor(np.log2(np.maximum(np.abs(v), 1))).astype(np.int64) + 1)


def _amplitude(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    """JPEG's amplitude bits: v itself, or v - 1 in ones' complement below 0."""
    return np.where(v >= 0, v, v + (1 << size) - 1).astype(np.uint64)


def _fields(coeffs: np.ndarray, comp: np.ndarray, dc_tabs, ac_tabs) -> tuple:
    """The Huffman-coded fields (values, bit lengths) of quantized zigzag
    coefficient blocks ``coeffs`` (n_blocks, 64) in scan order, block b of
    component ``comp[b]`` coded with that component's (code, length)
    tables, in the order DC size, DC amplitude, then per nonzero AC
    coefficient the 16-zero runs (ZRL), its (run, size) symbol and
    amplitude, then EOB unless the last coefficient is nonzero."""
    n = coeffs.shape[0]
    dc = coeffs[:, 0]
    diff = np.empty_like(dc)
    for c in np.unique(comp):  # DC predicted from the component's last block
        m = comp == c
        d = dc[m]
        diff[m] = d - np.concatenate([[0], d[:-1]])
    dc_size = _category(diff)
    ac = coeffs[:, 1:]
    b_nz, k_nz = np.nonzero(ac)  # row-major: blocks in order, k ascending
    v_nz = ac[b_nz, k_nz]
    first = np.ones(len(b_nz), bool)
    first[1:] = b_nz[1:] != b_nz[:-1]
    prev_k = np.where(first, -1, np.concatenate([[-1], k_nz[:-1]]))
    run = k_nz - prev_k - 1
    n_zrl = run // 16
    size = _category(v_nz)
    sym = ((run % 16) << 4) | size
    last_k = np.full(n, -1)
    last_k[b_nz] = k_nz  # the last write per block wins: its largest k
    eob = last_k < 62
    # fields per block: 2 (DC) + sum(n_zrl + 2) over its nonzeros + eob
    per_nz = n_zrl + 2
    nz_fields = np.bincount(b_nz, weights=per_nz, minlength=n).astype(np.int64)
    count = 2 + nz_fields + eob
    start = np.cumsum(count) - count
    total = int(count.sum())
    vals = np.zeros(total, np.uint64)
    lens = np.zeros(total, np.int64)
    dc_code = np.zeros(n, np.uint64)
    dc_len = np.zeros(n, np.int64)
    ac_code = np.zeros(len(b_nz), np.uint64)
    ac_len = np.zeros(len(b_nz), np.int64)
    zrl_code = np.zeros(len(b_nz), np.uint64)
    zrl_len = np.zeros(len(b_nz), np.int64)
    eob_code = np.zeros(n, np.uint64)
    eob_len = np.zeros(n, np.int64)
    for c in np.unique(comp):
        (dcc, dcl), (acc, acl) = dc_tabs[c], ac_tabs[c]
        m = comp == c
        dc_code[m], dc_len[m] = dcc[dc_size[m]], dcl[dc_size[m]]
        eob_code[m], eob_len[m] = acc[0x00], acl[0x00]
        mz = comp[b_nz] == c
        ac_code[mz], ac_len[mz] = acc[sym[mz]], acl[sym[mz]]
        zrl_code[mz], zrl_len[mz] = acc[0xF0], acl[0xF0]
    vals[start], lens[start] = dc_code, dc_len
    vals[start + 1], lens[start + 1] = _amplitude(diff, dc_size), dc_size
    # offset of each nonzero's first field within its block
    cum = np.cumsum(per_nz) - per_nz
    first_idx = np.flatnonzero(first)
    block_cum0 = np.zeros(n, np.int64)
    block_cum0[b_nz[first_idx]] = cum[first_idx]
    off = start[b_nz] + 2 + cum - block_cum0[b_nz]
    zr_owner = np.repeat(np.arange(len(b_nz)), n_zrl)
    zr_pos = off[zr_owner] + (np.arange(len(zr_owner))
                              - np.repeat(np.cumsum(n_zrl) - n_zrl, n_zrl))
    vals[zr_pos], lens[zr_pos] = zrl_code[zr_owner], zrl_len[zr_owner]
    sym_pos = off + n_zrl
    vals[sym_pos], lens[sym_pos] = ac_code, ac_len
    vals[sym_pos + 1], lens[sym_pos + 1] = _amplitude(v_nz, size), size
    eob_pos = (start + count - 1)[eob]
    vals[eob_pos], lens[eob_pos] = eob_code[eob], eob_len[eob]
    return vals, lens


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


def _dht(table_class: int, table_id: int, table) -> bytes:
    bits, vals = table
    return bytes([(table_class << 4) | table_id, *bits, *vals])


def _quantized(plane: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """(H/8, W/8, 64) quantized zigzag coefficients of a level-shifted
    plane whose sides are multiples of 8."""
    blocks = _DCT @ (_blocks(plane) - 128.0) @ _DCT.T
    bh, bw = blocks.shape[:2]
    q = np.rint(blocks.reshape(bh, bw, 64) / qt).astype(np.int64)
    return q[..., _ZIGZAG]


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 90,
               libjpeg_defaults: bool = False) -> None:
    """Write an (H, W, 3) uint8 RGB image as a baseline JPEG file;
    ``libjpeg_defaults`` selects 4:2:0 chroma and the Annex K Huffman
    tables (see the module docstring)."""
    data = encode_jpeg(rgb, quality, libjpeg_defaults)
    with open(path, "wb") as f:
        f.write(data)


def encode_jpeg(rgb: np.ndarray, quality: int = 90,
                libjpeg_defaults: bool = False) -> bytes:
    """The bytes of ``write_jpeg``'s file."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape} {rgb.dtype}")
    H, W = rgb.shape[:2]
    x = rgb.astype(np.float64)
    ycc = np.stack([
        0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2],
        -0.168736 * x[..., 0] - 0.331264 * x[..., 1] + 0.5 * x[..., 2] + 128.0,
        0.5 * x[..., 0] - 0.418688 * x[..., 1] - 0.081312 * x[..., 2] + 128.0])
    qt = [_scaled(_LUMA_Q, quality), _scaled(_CHROMA_Q, quality)]
    mcu = 16 if libjpeg_defaults else 8
    ycc = np.pad(ycc, ((0, 0), (0, -H % mcu), (0, -W % mcu)), mode="edge")
    Y = _quantized(ycc[0], qt[0])
    if libjpeg_defaults:
        h2, w2 = ycc.shape[1] // 2, ycc.shape[2] // 2
        chroma = ycc[1:].reshape(2, h2, 2, w2, 2).mean(axis=(2, 4))
        Cb, Cr = (_quantized(chroma[c], qt[1]) for c in range(2))
        my, mx = Cb.shape[:2]
        # MCU order: four luma blocks (row-major within the 2x2), Cb, Cr
        y4 = Y.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my, mx, 4, 64)
        coeffs = np.concatenate([y4, Cb[:, :, None], Cr[:, :, None]], axis=2)
        comp = np.tile([0, 0, 0, 0, 1, 2], my * mx)
        dc_t, ac_t = [_K3_DC_LUMA, _K3_DC_CHROMA], [_K3_AC_LUMA, _K3_AC_CHROMA]
        sampling, tables = 0x22, [0, 1, 1]
    else:
        Cb, Cr = (_quantized(ycc[c], qt[1]) for c in (1, 2))
        coeffs = np.stack([Y, Cb, Cr], axis=2)
        comp = np.tile([0, 1, 2], Y.shape[0] * Y.shape[1])
        dc_t, ac_t = [_FLAT_DC, _FLAT_DC], [_FLAT_AC, _FLAT_AC]
        sampling, tables = 0x11, [0, 0, 0]
    dc_codes = [_codes(dc_t[t]) for t in tables]
    ac_codes = [_codes(ac_t[t]) for t in tables]
    scan = _pack(*_fields(coeffs.reshape(-1, 64), comp, dc_codes, ac_codes))
    dht = b"".join(_dht(0, t, dc_t[t]) + _dht(1, t, ac_t[t])
                   for t in sorted(set(tables)))
    out = [b"\xff\xd8",
           _segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
           _segment(0xFFDB, bytes([0, *qt[0][_ZIGZAG]]) + bytes([1, *qt[1][_ZIGZAG]])),
           _segment(0xFFC0, struct.pack(">BHHB", 8, H, W, 3)
                    + bytes([1, sampling, 0, 2, 0x11, 1, 3, 0x11, 1])),
           _segment(0xFFC4, dht),
           _segment(0xFFDA, bytes([3, 1, 0x00, 2, tables[1] * 0x11,
                                   3, tables[2] * 0x11, 0, 63, 0])),
           scan, b"\xff\xd9"]
    return b"".join(out)
