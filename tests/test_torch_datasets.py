"""The port's dataset readers against the JAX package's.

Each reader reads a sequence that the JAX package's
``tools/export_synthetic.py`` (OpenCV's writers) or the port's (its own
writers) writes in the dataset's own on-disk layout (as
test_data_rehearsal.py does) and must give the same frames and poses as
its JAX counterpart, exactly: the port decodes with its own codecs, which
give OpenCV's pixels, and runs the same f32 arithmetic and pose flips.
Only a linear resize (crop_size) differs from OpenCV's, by at most an ulp,
so that case holds the colour to test_torch_imageio.py's 1e-6.  The EXR
codec, ``quantize_frame`` and the registry are held to the JAX package's
too, and the readers and the evaluation tools are run with no imaging
library importable.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from nice_slam_tpu.tools import export_synthetic as ex
from nice_slam_torch.tools import export_synthetic as tex
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
    (ji, jc, jd, jp), (ti, tc, td, tp) = j[1], t[1]
    assert ti == ji and tc.dtype == jc.dtype
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-6)  # linear resize
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tp, jp)
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


PORT_EXPORTERS = {"replica": "replica", "scannet": "scannet", "tumrgbd": "tum",
                  "cofusion": "cofusion", "azure": "azure"}


@pytest.mark.parametrize("name", sorted(PORT_EXPORTERS))
def test_port_export_read_by_both_packages(tmp_path, name):
    """The port's exporter (its own JPEG, PNG and EXR writers) writes a
    layout both packages' readers read to the same frames; the depth is
    the generator's, quantised to the PNG step (EXR: exact)."""
    _, n, depth_scale = FORMATS[name]
    tex.EXPORTERS[PORT_EXPORTERS[name]](str(tmp_path), tex._default_cfg(n_frames=n, H=48, W=64))
    cfg = _reader_cfg(str(tmp_path), name, n, depth_scale)
    j = jds.get_dataset(cfg, None, 1.0)
    t = tds.get_dataset(cfg, None, 1.0)
    gen = tds.Synthetic(tex._default_cfg(n_frames=n, H=48, W=64))
    assert len(t) == len(j) == n
    for i in range(n):
        for a, b in zip(j[i], t[i]):
            assert np.asarray(b).dtype == np.asarray(a).dtype
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        depth = gen[i][2]
        if name == "cofusion":
            np.testing.assert_array_equal(t[i][2], depth)
        else:
            q = cfg["cam"]["png_depth_scale"]
            np.testing.assert_array_equal(
                t[i][2], (np.round(depth * q).astype(np.uint16).astype(np.float32) / q))


BLOCKED = ("cv2", "PIL", "matplotlib", "jax", "nice_slam_tpu")

NO_IMAGING_SCRIPT = """
import sys
for name in {blocked!r}:
    sys.modules[name] = None  # any import of it raises ImportError
import argparse, os
import numpy as np
import torch
torch.set_num_threads(1)
from nice_slam_torch.tools import export_synthetic as tex, selfcheck
from nice_slam_torch.tools.cull_mesh import cull_mesh
from nice_slam_torch.tools.eval_recon import calc_2d_metric, calc_3d_metric
from nice_slam_torch.utils import datasets as tds
out = {out!r}
layouts = {{"replica": "replica", "scannet": "scannet", "tumrgbd": "tum",
           "cofusion": "cofusion", "azure": "azure"}}
for name, fmt in layouts.items():
    folder = os.path.join(out, name)
    tex.EXPORTERS[fmt](folder, tex._default_cfg(3, 24, 32))
    cfg = tex._default_cfg(3, 24, 32)
    cfg["dataset"] = name
    cfg["data"]["input_folder"] = folder
    if name == "cofusion":
        cfg["cam"]["png_depth_scale"] = 1.0
    if name == "tumrgbd":
        cfg["cam"]["distortion"] = [0.2624, -0.9531, -0.0054, 0.0026, 1.1633]
    ds = tds.get_dataset(cfg, None, 1.0)
    for i in range(len(ds)):
        _, color, depth, pose = ds[i]
        assert color.shape == (24, 32, 3) and np.isfinite(depth).all()
args = selfcheck.parser().parse_args([
    "--device", "cpu", "--frames", "4", "--iters", "2", "--iters_first", "3",
    "--resolution", "24", "--depth_l1_imgs", "2", "--track_iters", "2",
    "--out", os.path.join(out, "selfcheck")])
summary = selfcheck.run(args)
gt = os.path.join(out, "selfcheck", "gt_room.ply")
rec = os.path.join(out, "selfcheck", "mesh", "final_mesh_eval_rec.ply")
calc_3d_metric(rec, gt)
calc_2d_metric(rec, gt, n_imgs=2, seed=0)
v = np.array([[0, 0, -2], [0.1, 0, -2], [0, 0.1, -2]], np.float32)
assert len(cull_mesh(v, np.array([[0, 1, 2]]), [np.eye(4)], 60, 80, 60.0, 60.0, 39.5, 29.5)) == 1
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r}
                and sys.modules[m] is not None)
assert not leaked, leaked
print("NO_IMAGING_OK", sorted(summary))
"""


def test_readers_and_tools_need_no_imaging_library(tmp_path):
    """Every reader (TUM with undistortion), the exporter, eval_recon,
    cull_mesh and a tiny selfcheck run in a process where cv2, PIL,
    matplotlib, jax and the JAX package cannot be imported."""
    script = NO_IMAGING_SCRIPT.format(blocked=BLOCKED, out=str(tmp_path))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(script)], cwd=root,
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "NO_IMAGING_OK" in proc.stdout
