"""The port's tracking loss, its pose gradient and the per-frame tracking
loop against the JAX package, on the same scene state and the same
pre-drawn pixels (``presample_pixels`` is shared numpy Philox code).

Tolerances: the loss sums uncertainty-weighted residuals through the
Fourier embedding (see test_torch_decoders.py), so losses agree to 1e-3
relative and pose gradients to 1e-2 relative of their norm; the tracked
pose agrees to 1e-4 after 6 Adam iterations at lr 1e-3.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nice_slam_tpu.config import load_config
from nice_slam_tpu.models import pretrain as jpre
from nice_slam_tpu.models import scene as jscene
from nice_slam_tpu.ops import geometry as jgeo
from nice_slam_tpu.ops.render import RenderConfig as JRender
from nice_slam_tpu.slam import tracker as jtr
from nice_slam_tpu.utils.datasets import Synthetic as JSynthetic
from nice_slam_torch.convert import scene_from_jax
from nice_slam_torch.models import scene as tscene
from nice_slam_torch.ops import geometry as tgeo
from nice_slam_torch.ops.render import RenderConfig as TRender
from nice_slam_torch.slam import tracker as ttr
from nice_slam_torch.utils.datasets import Synthetic as TSynthetic

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tier-1 run puts several workers on few cores, and torch's
    thread pool in each would oversubscribe them (tiny loop runs took
    ~10x longer that way), so this module's runs use one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cfg():
    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "nice_slam.yaml"))
    cfg["coarse"] = False
    cfg["cam"].update({"H": 30, "W": 40, "fx": 30.0, "fy": 30.0, "cx": 19.5,
                       "cy": 14.5})
    cfg["tracking"].update({"pixels": 64, "iters": 6, "ignore_edge_W": 2,
                            "ignore_edge_H": 2})
    cfg["rendering"].update({"N_samples": 12, "N_surface": 6})
    cfg["data"]["n_frames"] = 10
    for k in ("coarse", "middle_fine"):
        cfg["pretrained_decoders"][k] = os.path.join(
            ROOT, cfg["pretrained_decoders"][k])
    return cfg


@pytest.fixture(scope="module")
def setup():
    cfg = small_cfg()
    jspec, jstate = jscene.build_scene(cfg, nice=True, seed=1)
    jstate = jpre.load_pretrain(cfg, jspec, jstate, verbose=False)
    tspec, _ = tscene.build_scene(cfg, nice=True, device="cpu")
    tstate = scene_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    cam = cfg["cam"]
    return dict(cfg=cfg, jspec=jspec, jstate=jstate, tspec=tspec, tstate=tstate,
                jt=jtr.TrackerConfig.from_cfg(cfg, cam, True),
                tt=ttr.TrackerConfig.from_cfg(cfg, cam, True),
                jr=JRender.from_cfg(cfg), tr=TRender.from_cfg(cfg))


def _frame(cfg, idx):
    _, color, depth, c2w = TSynthetic(cfg)[idx]
    _, jc, jd, jp = JSynthetic(cfg)[idx]
    np.testing.assert_array_equal(color, jc)
    np.testing.assert_array_equal(depth, jd)
    np.testing.assert_array_equal(c2w, jp)
    return color, depth, c2w


def test_presample_pixels_is_shared(setup):
    color, depth, _ = _frame(setup["cfg"], 3)
    a = ttr.presample_pixels(42, 3, setup["tt"], color, depth)
    b = jtr.presample_pixels(42, 3, setup["jt"], color, depth)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_tracking_loss_and_pose_gradient_match_jax(setup):
    s = setup
    color, depth, c2w = _frame(s["cfg"], 4)
    pi, pj, pd, pc = ttr.presample_pixels(7, 4, s["tt"], color, depth)
    # a perturbed pose, so the gradient is far from zero
    cam = np.asarray(jgeo.tensor_from_pose(jnp.asarray(c2w)))
    cam = cam + np.array([0.01, -0.02, 0.015, 0.0, 0.03, -0.02, 0.01], np.float32)
    lj, gj = jax.jit(jax.value_and_grad(lambda c: jtr.tracking_loss_sampled(
        s["jspec"], s["jstate"], c, jnp.asarray(pi[0]), jnp.asarray(pj[0]),
        jnp.asarray(pd[0]), jnp.asarray(pc[0]), s["jt"], s["jr"])))(
            jnp.asarray(cam))
    ct = torch.tensor(cam, requires_grad=True)
    lt = ttr.tracking_loss_sampled(
        s["tspec"], s["tstate"], ct, torch.tensor(pi[0]), torch.tensor(pj[0]),
        torch.tensor(pd[0]), torch.tensor(pc[0]), s["tt"], s["tr"])
    (gt,) = torch.autograd.grad(lt, ct)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-3)
    gj = np.asarray(gj)
    assert np.linalg.norm(gt.numpy() - gj) <= 1e-2 * np.linalg.norm(gj)


def test_track_frame_sampled_matches_jax(setup):
    s = setup
    color, depth, c2w = _frame(s["cfg"], 2)
    pix = ttr.presample_pixels(11, 2, s["tt"], color, depth)
    init = np.asarray(jgeo.tensor_from_pose(jnp.asarray(c2w)))
    init = init + np.array([0.0, 0.004, -0.003, 0.002, 0.01, 0.0, -0.01],
                           np.float32)
    cj, lj, _, _ = jtr.track_frame_sampled(
        s["jspec"], s["jstate"], jnp.asarray(init),
        *(jnp.asarray(a) for a in pix), s["jt"], s["jr"])
    ctt, ltt, cams, final = ttr.track_frame_sampled(
        s["tspec"], s["tstate"], torch.tensor(init),
        *(torch.tensor(a) for a in pix), s["tt"], s["tr"])
    np.testing.assert_allclose(ltt.numpy(), np.asarray(lj), rtol=1e-3)
    np.testing.assert_allclose(ctt.numpy(), np.asarray(cj), atol=1e-4)
    assert cams.shape == (s["tt"].iters, 7)
    assert torch.equal(final, cams[-1])


def test_const_speed_init_matches_jax():
    a = np.asarray(jgeo.pose_from_tensor(jnp.asarray(
        np.array([0.9, 0.1, -0.2, 0.3, 0.2, -0.1, 0.4], np.float32))))
    b = np.asarray(jgeo.pose_from_tensor(jnp.asarray(
        np.array([0.88, 0.12, -0.2, 0.31, 0.25, -0.1, 0.38], np.float32))))
    a44 = np.concatenate([a, [[0, 0, 0, 1]]]).astype(np.float32)
    b44 = np.concatenate([b, [[0, 0, 0, 1]]]).astype(np.float32)
    ref = jtr.const_speed_init(b44, a44)
    got = ttr.const_speed_init(torch.tensor(b44), torch.tensor(a44))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(tgeo.c2w44(torch.tensor(a)).numpy(), a44)
