"""The port's image I/O (``nice_slam_torch/utils/imageio.py`` over the host
codecs of ``csrc/image_codecs.cpp``) against OpenCV, on files OpenCV
writes in the test, and on the fixtures under ``tests/data/imageio/``
(written by OpenCV: ``PYTHONPATH=. python tests/test_torch_imageio.py``
rewrites them;
``manifest.json`` holds the SHA-256 of OpenCV's decoded pixels).

Tolerances reached and held: JPEG decode, PNG decode, nearest resize and
``undistort`` equal OpenCV's output exactly (0 levels); linear resize on
float32 within 1e-6 (OpenCV's own sum order differs by an ulp).
"""

import hashlib
import json
import os

import cv2
import numpy as np
import pytest
import yaml

from nice_slam_torch.utils import imageio
from nice_slam_torch.utils.jpeg import write_jpeg
from nice_slam_torch.utils.png import write_png

DATA = os.path.join(os.path.dirname(__file__), "data", "imageio")
FR1_DESK = os.path.join(os.path.dirname(__file__), "..", "configs", "TUM_RGBD",
                        "freiburg1_desk.yaml")
LINEAR_ATOL = 1e-6

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}


def textured(h, w, seed=0):
    """Smooth gradients, sharp stripes and noise: every DCT band busy."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7.0 + y / 13.0),
                     128 + 90 * np.cos(x / 5.0), (x * 3 + y * 5) % 256], -1)
    return np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("size", [(47, 61), (48, 64)])
@pytest.mark.parametrize("rst", [0, 2])
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("quality", [50, 95, 100])
def test_jpeg_equals_cv2(tmp_path, quality, sampling, rst, size):
    rgb = textured(*size, seed=quality)
    path = str(tmp_path / "a.jpg")
    cv2.imwrite(path, rgb[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality,
                                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                                       cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
    np.testing.assert_array_equal(imageio.imread_color(path), cv2.imread(path)[..., ::-1])
    np.testing.assert_array_equal(imageio.imread_unchanged(path),
                                  cv2.imread(path, cv2.IMREAD_UNCHANGED))


def test_gray_jpeg_equals_cv2(tmp_path):
    path = str(tmp_path / "g.jpg")
    cv2.imwrite(path, textured(33, 17)[..., 0], [cv2.IMWRITE_JPEG_QUALITY, 90])
    got = imageio.imread_unchanged(path)
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(imageio.imread_color(path), np.repeat(got[..., None], 3, 2))


def test_progressive_jpeg_raises(tmp_path):
    path = str(tmp_path / "p.jpg")
    cv2.imwrite(path, textured(40, 40), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="progressive.*SOF2"):
        imageio.imread_color(path)


def _segment(data: bytearray, marker: bytes) -> int:
    """Offset of the first ``marker`` segment's length field."""
    return data.index(marker) + 2


def _dht_overfull(data):
    # three 1-bit codes, a 3-bit count lowered to keep the total: the third
    # code (2) does not fit in one bit
    p = _segment(data, b"\xff\xc4") + 3
    assert data[p] == 0 and data[p + 2] >= 3
    data[p], data[p + 2] = 3, data[p + 2] - 3


def _shorten(marker: bytes, length: int):
    def corrupt(data):
        p = _segment(data, marker)
        data[p:p + 2] = length.to_bytes(2, "big")
    return corrupt


MALFORMED = {
    "dht_code_overflows_length": (_dht_overfull, "bad Huffman table"),
    "dht_bits_past_segment": (_shorten(b"\xff\xc4", 2 + 10), "bad DHT segment"),
    "dqt_table_past_segment": (_shorten(b"\xff\xdb", 2 + 1 + 30), "bad DQT segment"),
    "sof_components_past_segment": (_shorten(b"\xff\xc0", 2 + 6 + 3),
                                    "bad JPEG frame header"),
    "sof_header_past_segment": (_shorten(b"\xff\xc0", 2 + 3), "bad JPEG frame header"),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_jpeg_headers_raise(tmp_path, case):
    """Header tables that do not fit their segment, or a Huffman table
    whose codes outgrow their lengths, raise instead of being read."""
    path = str(tmp_path / "m.jpg")
    cv2.imwrite(path, textured(24, 40), [cv2.IMWRITE_JPEG_QUALITY, 90])
    data = bytearray(open(path, "rb").read())
    corrupt, message = MALFORMED[case]
    corrupt(data)
    with pytest.raises(ValueError, match=message):
        imageio.decode_jpeg(bytes(data))


def _png_image(kind, rng):
    y, x = np.mgrid[0:47, 0:61]
    if kind == "gray8":
        return ((x * 3 + y * 7) % 256 + rng.integers(0, 3, x.shape)).clip(0, 255).astype(np.uint8)
    if kind == "rgb8":
        a = rng.integers(0, 256, (47, 61, 3)).astype(np.uint8)
        a[:20] = (x[:20, :, None] * 4 % 256).astype(np.uint8)  # smooth rows: Sub/Up/Paeth
        return a
    if kind == "rgba8":
        a = rng.integers(0, 256, (47, 61, 4)).astype(np.uint8)
        a[:, :30] = (x[:, :30, None] * 4 + y[:, :30, None]).astype(np.uint8)
        return a
    return ((x * 1000 + y * 37) % 65536).astype(np.uint16)  # gray16


@pytest.mark.parametrize("compression", range(10))
@pytest.mark.parametrize("kind", ["gray8", "rgb8", "rgba8", "gray16"])
def test_png_equals_cv2(tmp_path, kind, compression):
    img = _png_image(kind, np.random.default_rng(compression))
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, compression])
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    got = imageio.imread_unchanged(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    if img.dtype == np.uint8:
        np.testing.assert_array_equal(imageio.imread_color(path), cv2.imread(path)[..., ::-1])


def test_png_refuses_interlaced_and_palette(tmp_path):
    path = str(tmp_path / "a.png")
    write_png(path, np.zeros((4, 5, 3), np.uint8))
    data = bytearray(open(path, "rb").read())
    bad = bytearray(data)
    bad[28] = 1  # IHDR interlace byte
    with pytest.raises(ValueError, match="interlac"):
        imageio.decode_png(bytes(bad))
    bad = bytearray(data)
    bad[25] = 3  # IHDR colour type: palette
    with pytest.raises(ValueError, match="colour type 3"):
        imageio.decode_png(bytes(bad))


RESIZES = [((48, 64), (40, 56)), ((680, 1200), (340, 600)), ((47, 61), (100, 33)),
           ((30, 40), (60, 80))]


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_nearest_equals_cv2(src, dst):
    d = np.random.default_rng(0).random(src).astype(np.float32)
    np.testing.assert_array_equal(imageio.resize_nearest(d, dst),
                                  cv2.resize(d, dst[::-1], interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_linear_within_tolerance_of_cv2(src, dst, channels):
    shape = src if channels == 1 else src + (channels,)
    a = np.random.default_rng(1).random(shape).astype(np.float32)
    got = imageio.resize_linear(a, dst)
    ref = cv2.resize(a, dst[::-1], interpolation=cv2.INTER_LINEAR)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=LINEAR_ATOL)


TUM_DIST = [0.2624, -0.9531, -0.0054, 0.0026, 1.1633]  # freiburg1_desk.yaml
UNDISTORT = [((480, 640), [[517.3, 0, 318.6], [0, 516.5, 255.3], [0, 0, 1]], TUM_DIST),
             ((48, 64), [[50, 0, 31.5], [0, 52, 23.5], [0, 0, 1]], TUM_DIST),
             ((680, 1200), [[600, 0, 599.5], [0, 600, 339.5], [0, 0, 1]],
              [0.1, -0.05, 0.001, -0.002])]


@pytest.mark.parametrize("size,K,dist", UNDISTORT)
def test_undistort_equals_cv2(size, K, dist):
    img = textured(*size, seed=3)
    K = np.array(K)
    np.testing.assert_array_equal(imageio.undistort(img, K, dist),
                                  cv2.undistort(img, K, np.array(dist)))
    m1, m2 = cv2.initUndistortRectifyMap(K, np.array(dist), None, K, size[::-1], cv2.CV_16SC2)
    ix, iy = imageio.undistort_map(K, dist, *size)
    np.testing.assert_array_equal(ix, m1[..., 0].astype(np.int32) * 32 + (m2 & 31))
    np.testing.assert_array_equal(iy, m1[..., 1].astype(np.int32) * 32 + (m2 >> 5))


def test_writers_are_read_back_by_cv2(tmp_path):
    rgb = textured(47, 61)
    png = str(tmp_path / "c.png")
    write_png(png, rgb)
    np.testing.assert_array_equal(cv2.imread(png)[..., ::-1], rgb)
    depth = np.random.default_rng(2).integers(0, 65536, (47, 61)).astype(np.uint16)
    write_png(png, depth)
    ref = cv2.imread(png, cv2.IMREAD_UNCHANGED)
    assert ref.dtype == np.uint16
    np.testing.assert_array_equal(ref, depth)
    jpg = str(tmp_path / "c.jpg")
    write_jpeg(jpg, rgb, quality=95, libjpeg_defaults=True)
    ref = cv2.imread(jpg)[..., ::-1]
    np.testing.assert_array_equal(imageio.imread_color(jpg), ref)
    psnr = 10 * np.log10(255.0 ** 2 / np.mean((ref.astype(float) - rgb) ** 2))
    assert psnr > 15.0  # the noisy texture loses detail at 4:2:0; a broken file would not
    with open(jpg, "rb") as f:
        data = f.read()
    sof = data.index(b"\xff\xc0")
    assert data[sof + 11] == 0x22  # luma sampled 2x2: 4:2:0


def test_default_jpeg_writer_keeps_444(tmp_path):
    jpg = str(tmp_path / "p.jpg")
    write_jpeg(jpg, textured(24, 40))
    with open(jpg, "rb") as f:
        data = f.read()
    sof = data.index(b"\xff\xc0")
    assert [data[sof + 11], data[sof + 14], data[sof + 17]] == [0x11, 0x11, 0x11]
    np.testing.assert_array_equal(imageio.imread_color(jpg), cv2.imread(jpg)[..., ::-1])


# SHA-256 of the files the panel writer wrote before its entropy coder was
# vectorised; its default output stays byte for byte the same
DEFAULT_JPEG_SHA256 = {
    None: "b944fee57789f8c384588eff9eff44be9bec812ac057cd30fd6a6dbcf2aa2311",
    50: "4948c376535a2d67c70a0e7fd74e6225b7654bb097c5a49906104d003b0a5e3f",
    100: "a46dac8d3f9ab32eb715dc4a75f6dc78f989daca317c3dab73e664e8b2e68404",
}


@pytest.mark.parametrize("quality", [None, 50, 100])
def test_default_jpeg_writer_bytes_are_pinned(tmp_path, quality):
    y, x = np.mgrid[0:37, 0:53]
    img = np.stack([(x * 7 + y * 13) % 256, (x * y) % 256, ((x ^ y) * 9) % 256],
                   -1).astype(np.uint8)
    img[:16, :24] = (200, 120, 40)  # flat blocks: DC and end-of-block only
    img[20:, :8] = ((x[20:, :8] // 4) % 2 * 255)[..., None]  # stripes
    path = str(tmp_path / "d.jpg")
    write_jpeg(path, img, **({} if quality is None else {"quality": quality}))
    with open(path, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == DEFAULT_JPEG_SHA256[quality]


def _manifest():
    with open(os.path.join(DATA, "manifest.json")) as f:
        return json.load(f)


def fixture_pixels(name: str, entry: dict) -> np.ndarray:
    """The port's pixels of a manifest entry: a decoded file, or (``read:
    undistort``) its ``source``'s colour cropped to ``shape`` and
    undistorted with the entry's ``K`` and ``dist``."""
    if entry["read"] == "undistort":
        H, W = entry["shape"][:2]
        src = imageio.imread_color(os.path.join(DATA, entry["source"]))[:H, :W]
        return imageio.undistort(src, np.array(entry["K"]), entry["dist"])
    path = os.path.join(DATA, name)
    if entry["read"] == "color":
        return imageio.imread_color(path)
    return imageio.imread_unchanged(path)


def cv2_pixels(name: str, entry: dict, folder: str = DATA) -> np.ndarray:
    """OpenCV's pixels of a manifest entry in ``folder``, RGB where colour."""
    if entry["read"] == "undistort":
        H, W = entry["shape"][:2]
        src = cv2.imread(os.path.join(folder, entry["source"]))[:H, :W, ::-1]
        return cv2.undistort(np.ascontiguousarray(src), np.array(entry["K"]),
                             np.array(entry["dist"]))
    path = os.path.join(folder, name)
    if entry["read"] == "color":
        return cv2.imread(path)[..., ::-1]
    return cv2.imread(path, cv2.IMREAD_UNCHANGED)


@pytest.mark.parametrize("name", sorted(_manifest()))
def test_committed_fixtures(name):
    """OpenCV's pixels of each fixture are the recorded ones, and so are
    the port's (the smoke runs the same comparison on the card)."""
    entry = _manifest()[name]
    assert sha(cv2_pixels(name, entry)) == entry["sha256"]
    got = fixture_pixels(name, entry)
    assert list(got.shape) == entry["shape"] and str(got.dtype) == entry["dtype"]
    assert sha(got) == entry["sha256"]


def test_undistort_fixture_uses_freiburg1_desk_camera():
    with open(FR1_DESK) as f:
        cam = yaml.safe_load(f)["cam"]
    entry = _manifest()["cv2_undistort_fr1desk_480x640"]
    assert entry["shape"][:2] == [cam["H"], cam["W"]]
    assert entry["K"] == [[cam["fx"], 0.0, cam["cx"]], [0.0, cam["fy"], cam["cy"]],
                          [0.0, 0.0, 1.0]]
    assert entry["dist"] == cam["distortion"]


def write_fixtures(folder: str) -> None:
    """Write the OpenCV fixtures and their manifest into ``folder``."""
    from nice_slam_torch.utils.datasets import Synthetic

    os.makedirs(folder, exist_ok=True)
    cam = {"H": 680, "W": 1200, "fx": 600.0, "fy": 600.0, "cx": 599.5, "cy": 339.5,
           "png_depth_scale": 6553.5, "crop_edge": 0}
    _, color, depth, _ = Synthetic({"dataset": "synthetic", "cam": cam,
                                    "data": {"n_frames": 5}})[2]
    frame = (np.clip(color, 0, 1) * 255).astype(np.uint8)
    files = {
        "cv2_420_q95_680x1200.jpg": (frame, [cv2.IMWRITE_JPEG_QUALITY, 95], "color"),
        "cv2_420_q90_47x61_rst3.jpg": (textured(47, 61, 7), [
            cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 3], "color"),
        "cv2_422_q50_33x17.jpg": (textured(33, 17, 8), [
            cv2.IMWRITE_JPEG_QUALITY, 50,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["422"]], "color"),
        "cv2_rgb8_120x160.png": (frame[::4, ::4][:120, :160], [
            cv2.IMWRITE_PNG_COMPRESSION, 9], "color"),
        "cv2_gray16_120x160.png": (np.round(depth[::4, ::4][:120, :160] * 6553.5)
                                   .astype(np.uint16), [cv2.IMWRITE_PNG_COMPRESSION, 3],
                                   "unchanged"),
    }
    manifest = {}
    for name, (img, params, read) in files.items():
        cv2.imwrite(os.path.join(folder, name), img[..., ::-1] if img.ndim == 3 else img,
                    params)
        manifest[name] = {"read": read}
    # OpenCV's undistort at freiburg1_desk's camera, of the large fixture's
    # top-left 480x640 (no file of its own: the manifest holds its hash)
    with open(FR1_DESK) as f:
        cam = yaml.safe_load(f)["cam"]
    manifest["cv2_undistort_fr1desk_480x640"] = {
        "read": "undistort", "source": "cv2_420_q95_680x1200.jpg",
        "K": [[cam["fx"], 0.0, cam["cx"]], [0.0, cam["fy"], cam["cy"]], [0.0, 0.0, 1.0]],
        "dist": cam["distortion"], "shape": [cam["H"], cam["W"], 3]}
    for name, entry in manifest.items():
        ref = cv2_pixels(name, entry, folder)
        entry.update(shape=list(ref.shape), dtype=str(ref.dtype), sha256=sha(ref))
    with open(os.path.join(folder, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)


if __name__ == "__main__":  # PYTHONPATH=. python tests/test_torch_imageio.py
    write_fixtures(DATA)
