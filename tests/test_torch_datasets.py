"""The port's dataset readers against the JAX package's.

Each reader reads a sequence that the JAX package's
``tools/export_synthetic.py`` writes in the dataset's own on-disk layout
(as test_data_rehearsal.py does) and must give the same frames and poses
as its JAX counterpart, exactly: both run the same host code (OpenCV
decode, the same f32 arithmetic, the same pose flips).  The EXR codec,
``quantize_frame`` and the registry are held to the JAX package's too.
"""

import os

import numpy as np
import pytest

from nice_slam_tpu.tools import export_synthetic as ex
from nice_slam_tpu.utils import datasets as jds
from nice_slam_tpu.utils import exr as jexr
from nice_slam_torch.utils import datasets as tds
from nice_slam_torch.utils import exr as texr

# dataset name -> (exporter, frames, png_depth_scale override)
FORMATS = {
    "replica": (ex.export_replica, 5, None),
    "scannet": (ex.export_scannet, 4, None),
    "tumrgbd": (ex.export_tum, 6, None),
    "cofusion": (ex.export_cofusion, 4, 1.0),  # EXR depth is metric float
    "azure": (ex.export_azure, 5, None),
}


def _reader_cfg(folder, name, n, depth_scale):
    cfg = ex._default_cfg(n_frames=n, H=48, W=64)
    cfg["dataset"] = name
    cfg["data"] = dict(cfg["data"], input_folder=folder)
    cfg["cam"] = dict(cfg["cam"])
    if depth_scale is not None:
        cfg["cam"]["png_depth_scale"] = depth_scale
    return cfg


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_reader_matches_jax(tmp_path, name):
    export, n, depth_scale = FORMATS[name]
    export(str(tmp_path), ex._default_cfg(n_frames=n, H=48, W=64))
    cfg = _reader_cfg(str(tmp_path), name, n, depth_scale)
    j = jds.get_dataset(cfg, None, 1.0)
    t = tds.get_dataset(cfg, None, 1.0)
    assert type(t).__name__ == type(j).__name__
    assert len(t) == len(j) == n
    for i in range(n):
        for a, b in zip(j[i], t[i]):
            assert np.asarray(b).dtype == np.asarray(a).dtype
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_reader_crops_resize_and_scale_like_jax(tmp_path):
    """crop_size (resize), crop_edge and a non-unit scale on Replica."""
    ex.export_replica(str(tmp_path), ex._default_cfg(n_frames=2, H=48, W=64))
    cfg = _reader_cfg(str(tmp_path), "replica", 2, None)
    cfg["cam"].update(crop_size=[40, 56], crop_edge=3)
    j = jds.get_dataset(cfg, None, 0.5)
    t = tds.get_dataset(cfg, None, 0.5)
    for a, b in zip(j[1], t[1]):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    assert t[1][1].shape == (34, 50, 3)


def test_synthetic_and_registry_match_jax():
    assert sorted(tds.dataset_dict) == sorted(jds.dataset_dict)
    cfg = ex._default_cfg(n_frames=3, H=24, W=32)
    cfg["data"].update(room=[[-2.9, 8.9], [-3.2, 5.5], [-3.5, 3.3]])
    j, t = jds.Synthetic(cfg, None, 1.0), tds.Synthetic(cfg, None, 1.0)
    for a, b in zip(j[2], t[2]):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_quantize_frame_matches_jax():
    rng = np.random.default_rng(0)
    color = rng.uniform(0, 1, (12, 16, 3)).astype(np.float32)
    depth = rng.uniform(0, 8, (12, 16)).astype(np.float32)
    for qscale in (6553.5, 5000.0):
        jq, tq = jds.quantize_frame(color, depth, qscale), tds.quantize_frame(color, depth, qscale)
        for a, b in zip(jq, tq):
            assert b.dtype == a.dtype
            np.testing.assert_array_equal(b, a)
    assert tds.quantize_frame(color, depth, 1e5) is None  # would clip at u16


def test_exr_codec_and_depth_reader_match_jax(tmp_path):
    depth = np.random.default_rng(1).uniform(0.1, 5.0, (20, 24)).astype(np.float32)
    path = str(tmp_path / "d.exr")
    texr.write_exr(path, {"R": depth, "G": depth, "B": depth})
    j, t = jexr.read_exr(path), texr.read_exr(path)
    assert sorted(t) == sorted(j)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k])
    np.testing.assert_array_equal(tds.readEXR_onlydepth(path), jds.readEXR_onlydepth(path))
    np.testing.assert_array_equal(tds.readEXR_onlydepth(path), depth)
