"""The frame source and the operation counts."""

import numpy as np
import pytest
import torch

from slambench import flops, frames
from slambench.tests.tiny import ROOT  # noqa: F401  (puts the checkout on the path)

ROOM = [[-2.9, 8.9], [-3.2, 5.5], [-3.5, 3.3]]
CAM = {"H": 30, "W": 40, "fx": 20.0, "fy": 20.0, "cx": 19.5, "cy": 14.5}
TRAFFIC = {"ring": 5, "step": 0.0049}


def test_frames_are_the_same_for_a_seed_and_differ_between_seeds():
    a = frames.make_reader(ROOM, CAM, 0.1, TRAFFIC, 20, 2**40 + 3, "cpu")
    b = frames.make_reader(ROOM, CAM, 0.1, TRAFFIC, 20, 2**40 + 3, "cpu")
    c = frames.make_reader(ROOM, CAM, 0.1, TRAFFIC, 20, 2**40 + 4, "cpu")
    for k in range(20):
        for x, y in zip(a[k][1:], b[k][1:]):
            assert np.array_equal(x, y)
    assert not np.array_equal(a[0][2], c[0][2])


def test_the_ring_walks_forward_then_back():
    r = frames.make_reader(ROOM, CAM, 1.0, TRAFFIC, 20, 1, "cpu")
    assert [r.ring_index(i) for i in range(10)] == [0, 1, 2, 3, 4, 3, 2, 1, 0, 1]
    assert np.array_equal(r[5][3], r[3][3]) and len(r) == 20


def test_depth_equals_the_systems_synthetic_room():
    from nice_slam_torch.utils.datasets import Synthetic

    n = 8
    cfg = {"dataset": "synthetic",
           "cam": dict(CAM, png_depth_scale=1.0, crop_edge=0),
           "data": {"n_frames": n, "room": ROOM, "orbit_radians": 0.0049 * n}}
    syn = Synthetic(cfg, None, 0.1)
    room = np.asarray(ROOM, np.float32)
    for i in (0, 3, 7):
        ang = 0.0049 * n * i / n
        pose = frames.orbit_pose(room, ang)
        color, depth = frames.render_frame(torch.as_tensor(room), torch.as_tensor(pose), CAM)
        _, c_ref, d_ref, p_ref = syn[i]
        p = pose.copy()
        p[:3, 3] *= 0.1
        np.testing.assert_allclose(p, p_ref, rtol=0, atol=1e-6)
        np.testing.assert_allclose(depth.numpy() * 0.1, d_ref, rtol=1e-5, atol=1e-6)
        assert np.mean(np.abs(color.numpy() - c_ref) > 1e-4) < 1e-3  # checker edges may flip


def test_imap_iteration_counts():
    w = {"hidden": 256, "embed": 93, "n_blocks": 4, "out": 4}
    mapping = 5000 * flops.imap_ray_flops(w, 32, 12, 32, True)
    tracking = 5000 * flops.imap_ray_flops(w, 32, 12, 0, False)
    # 2 x (3 x 93 + 93 x 256 + 3 x 256^2 + 256 x 4) a point; 260 and 120 points a ray
    assert flops.imap_point_flops(w) == 443438
    assert mapping == 5000 * 260 * 443438 and tracking == 5000 * 120 * 443438
    assert mapping / 67e12 * 1e3 == pytest.approx(8.60, abs=0.01)  # ms at the f32 peak
    assert mapping == pytest.approx(5.76e11, rel=1e-3) and tracking == pytest.approx(2.66e11, rel=1e-3)


class Dec:
    def __init__(self, emb, feat, feat2, fc, out):
        self.emb, self.feat, self.feat2, self.fc, self.out = emb, feat, feat2, fc, out


def test_nice_decoder_counts():
    w = {"hidden": 32, "embed": 93}
    middle = Dec(True, 0, -1, True, 1)
    # 93x32 + 3 x 32x32 + (93+32)x32 + 5 x 32x32 (injections) + 32x1 + 3x93
    fwd, bwd = flops.dec_work(w, 32, [middle], False, [False], [False])
    assert (fwd, bwd) == (2976 + 3072 + 4000 + 5120 + 32 + 279, 0)
    fine = Dec(True, 1, 0, True, 1)
    fwd, _ = flops.dec_work(w, 32, [fine], False, [False, False], [False])
    assert fwd == 2976 + 3072 + 4000 + 5 * 64 * 32 + 32 + 279
    # tracking: the points' gradient, no weight gradient
    one = 15479
    _, bwd = flops.dec_work(w, 32, [middle], True, [False], [False])
    assert bwd == one + 32 + 4 * 32 * 32 + 2 * 93 * 32 + 279
    coarse = Dec(False, 0, -1, False, 1)
    fwd, bwd = flops.dec_work(w, 32, [coarse], False, [True], [False])
    assert fwd == 32 * 32 + 3 * 32 * 32 + 64 * 32 + 32
    assert bwd == fwd + 32 + 4 * 32 * 32 + 2 * 32 * 32
