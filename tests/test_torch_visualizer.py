"""The port's full-frame renderer and residual panels against the JAX
package's.

``render_img`` of a 24x32 frame in 300-ray chunks (the last one short, so
the JAX side pads it) on the same converted scene with the pretrained
decoders: depth, uncertainty and colour at atol 1e-3.  The two sides run
the same f32 ops in the same order and differ only by rounding through
the Fourier embedding (about 1e-6 here; the JAX package's numerics tests
bound raw logits at 0.05 in the worst case).  A tiny strict-loop run then writes its panels
at the due (frame, iteration) pairs, as test_viz.py checks for the JAX
package, and a run with vis frequencies that are never due writes none.
"""

import argparse
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nice_slam_tpu.config import load_config as jload_config
from nice_slam_tpu.models import pretrain as jpre
from nice_slam_tpu.models import scene as jscene
from nice_slam_tpu.ops import render as jrender
from nice_slam_tpu.utils.datasets import Synthetic
from nice_slam_torch.config import load_config
from nice_slam_torch.convert import scene_from_jax
from nice_slam_torch.models import scene as tscene
from nice_slam_torch.ops import render as trender
from nice_slam_torch.utils.jpeg import write_jpeg
from nice_slam_torch.utils.visualizer import compose_panel

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
H, W = 24, 32
CAM = (24.0, 24.0, 15.5, 11.5)
ATOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tier-1 run puts several workers on few cores, and torch's
    thread pool in each would oversubscribe them (tiny loop runs took
    ~10x longer that way), so this module's runs use one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    cfg = jload_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                       os.path.join(ROOT, "configs", "nice_slam.yaml"))
    cfg["coarse"] = True
    for k in ("coarse", "middle_fine"):
        cfg["pretrained_decoders"][k] = os.path.join(ROOT, cfg["pretrained_decoders"][k])
    cfg["cam"].update({"H": H, "W": W, "fx": CAM[0], "fy": CAM[1], "cx": CAM[2],
                       "cy": CAM[3]})
    cfg["data"]["n_frames"] = 6
    return cfg


@pytest.mark.parametrize("with_depth", [True, False])
def test_render_img_matches_jax(with_depth):
    cfg = _cfg()
    jspec, jstate = jscene.build_scene(cfg, nice=True, seed=3)
    jstate = jpre.load_pretrain(cfg, jspec, jstate, verbose=False)
    rng = np.random.default_rng(4)
    jstate = jstate._replace(grids={
        k: jnp.asarray(0.3 * rng.standard_normal(v.shape), jnp.float32)
        for k, v in jstate.grids.items()})
    tspec, _ = tscene.build_scene(cfg, nice=True, device="cpu")
    tstate = scene_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    _, _, depth, c2w = Synthetic(cfg)[2]
    jr = jrender.RenderConfig(**{**jrender.RenderConfig.from_cfg(cfg).__dict__,
                                 "ray_batch_size": 300})
    tr = trender.RenderConfig(**{**trender.RenderConfig.from_cfg(cfg).__dict__,
                                 "ray_batch_size": 300})
    j = jrender.render_img(jspec, jstate, jnp.asarray(c2w), H, W, *CAM, "color",
                           jnp.asarray(depth) if with_depth else None, jr)
    t = trender.render_img(tspec, tstate, torch.tensor(c2w), H, W, *CAM, "color",
                           torch.tensor(depth) if with_depth else None, tr)
    assert [tuple(x.shape) for x in t] == [(H, W), (H, W), (H, W, 3)]
    assert not t[0].requires_grad
    for a, b in zip(j, t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL, rtol=0)
    assert float(t[2].std()) > 0.01  # a real image, not a constant


@pytest.mark.parametrize("shape", [(454, 1203), (64, 128), (8, 8), (13, 7)])
def test_jpeg_writer_decodes_in_opencv(tmp_path, shape):
    """The panels' JPEG writer against OpenCV's decoder: the same size and
    within 2 levels on average at quality 90 (smooth content, on the
    larger images a noisy patch, odd sizes that need edge padding)."""
    H, W = shape
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.stack([128 + 100 * np.sin(xx / 37.0), 128 + 100 * np.cos(yy / 23.0),
                    (xx + yy) % 256], -1).astype(np.uint8)
    if H >= 64:  # a noisy patch a quarter of each side
        img[H // 4:H // 2, W // 4:W // 2] = np.random.default_rng(0).integers(
            0, 256, (H // 2 - H // 4, W // 2 - W // 4, 3))
    path = str(tmp_path / "t.jpg")
    write_jpeg(path, img)
    out = cv2.imread(path)
    assert out is not None and out.shape == (H, W, 3)
    assert np.abs(out[..., ::-1].astype(np.float64) - img).mean() < 2.0
    with pytest.raises(ValueError):
        write_jpeg(path, img.astype(np.float32))


def test_panel_layout():
    rows = [[np.full((680, 1200, 3), v) for v in (0.0, 0.5, 1.0)],
            [np.full((680, 1200, 3), v) for v in (0.25, 0.75, 1.0)]]
    panel = compose_panel(rows)
    assert panel.shape == (2 * 227 + 4, 3 * 400 + 8, 3)  # 12-inch figure width
    assert panel[0, 0, 0] == 0 and panel[0, 404, 0] == 128
    assert panel[300, 0, 0] == 64 and (panel[227:231] == 255).all()


def _run_cfg(out, vis):
    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "nice_slam.yaml"))
    for k in ("coarse", "middle_fine"):
        cfg["pretrained_decoders"][k] = os.path.join(ROOT, cfg["pretrained_decoders"][k])
    cfg["coarse"] = False
    cfg["verbose"] = False
    cfg["meshing"] = None
    cfg["data"].update({"n_frames": 6, "output": str(out)})
    cfg["cam"].update({"H": 30, "W": 40, "fx": 30.0, "fy": 30.0, "cx": 19.5, "cy": 14.5})
    cfg["tracking"].update({"pixels": 30, "iters": 6, "ignore_edge_W": 2,
                            "ignore_edge_H": 2, **vis[0]})
    cfg["mapping"].update({"pixels": 100, "iters_first": 10, "iters": 20,
                           "color_refine": False, **vis[1]})
    cfg["rendering"].update({"N_samples": 8, "N_surface": 4})
    return cfg


def _files(path):
    return sorted(os.listdir(path)) if os.path.isdir(path) else []


def test_panels_at_due_iterations(tmp_path):
    """Tracking: 6 iterations, inside_freq 4 -> frame 5 at 0 and 4 (frame 0
    is mapped, not tracked).  Mapping: 20 iterations per call, inside_freq
    10 -> frame 5 at 0 and 10 (frame 0 has no_vis_on_first_frame)."""
    from nice_slam_torch.slam.slam import NiceSLAM

    args = argparse.Namespace(nice=True, input_folder=None, output=None)
    vis = ({"vis_freq": 5, "vis_inside_freq": 4}, {"vis_freq": 5, "vis_inside_freq": 10})
    slam = NiceSLAM(_run_cfg(tmp_path / "due", vis), args, device="cpu")
    slam.run()
    assert _files(os.path.join(slam.output, "tracking_vis")) == [
        "00005_0000.jpg", "00005_0004.jpg"]
    assert _files(os.path.join(slam.output, "mapping_vis")) == [
        "00005_0000.jpg", "00005_0010.jpg"]
    # 2 x 3 images of 30 x 40 with 4 px gutters; the bottom-left one is
    # the input colour (within JPEG's loss)
    img = cv2.imread(os.path.join(slam.output, "mapping_vis", "00005_0010.jpg"))
    assert img is not None and img.shape == (64, 128, 3)
    gt_color = slam.frame_reader[5][1]
    cell = img[34:64, 0:40, ::-1].astype(np.float64) / 255.0
    assert np.abs(cell - gt_color).mean() < 0.03

    never = ({"vis_freq": 7, "vis_inside_freq": 4}, {"vis_freq": 7, "vis_inside_freq": 10})
    quiet = NiceSLAM(_run_cfg(tmp_path / "quiet", never), args, device="cpu")
    quiet.run()
    assert _files(os.path.join(quiet.output, "tracking_vis")) == []
    assert _files(os.path.join(quiet.output, "mapping_vis")) == []
