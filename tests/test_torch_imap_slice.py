"""The iMAP* slice: 4 frames of the strict loop (the first mapping, tracking,
one mapping event split into 3 calls, the final colour refinement in 5) on
a tiny box scene, run by the JAX package and by the port from the same
initial MLP and the same pre-drawn tracking pixels.

The mapper's pixel and regulariser draws come from ``jax.random`` in one
run and a ``torch.Generator`` in the other, and the JAX loop tracks
mapping frames on its own draws, so the runs are not bitwise equal.  The
bounds are what the different draws allow: tracked positions within 1 cm
of each other (the box is 0.4 m across at the iMAP configs' 0.1 scale),
the port's ATE within 0.5 cm of the JAX run's, the first mapping event's
mean loss within 10 % and every later call's within a factor 1.5, and the
first event's loss falling in both.
"""

import argparse
import os

import jax
import numpy as np
import pytest
import torch

from nice_slam_tpu.config import load_config
from nice_slam_tpu.slam.slam import NiceSLAM as JSLAM
from nice_slam_tpu.tools.eval_ate import align as jalign
from nice_slam_torch.convert import scene_from_jax
from nice_slam_torch.slam.slam import NiceSLAM as TSLAM
from nice_slam_torch.tools.eval_ate import ate_rmse

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


def tiny_cfg(out):
    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "imap.yaml"))
    cfg["verbose"] = False
    cfg["meshing"] = None  # no meshes: this test compares the loops
    cfg["data"].update({"n_frames": 4, "output": str(out),
                        "orbit_radians": 0.05})
    cfg["cam"].update({"H": 30, "W": 40, "fx": 30.0, "fy": 30.0, "cx": 19.5,
                       "cy": 14.5})
    cfg["tracking"].update({"pixels": 64, "iters": 6, "ignore_edge_W": 2,
                            "ignore_edge_H": 2})
    cfg["mapping"].update({"pixels": 64, "iters_first": 40, "iters": 6,
                           "every_frame": 2})
    cfg["rendering"].update({"N_samples": 8, "N_importance": 4})
    return cfg


def _record_losses(mapper, sink):
    inner = mapper.optimize_map

    def wrapped(*a, **k):
        out = inner(*a, **k)
        sink.append(np.asarray(out[2].cpu() if hasattr(out[2], "cpu")
                               else out[2]))
        return out

    mapper.optimize_map = wrapped


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    args = argparse.Namespace(nice=False, input_folder=None, output=None)
    js = JSLAM(tiny_cfg(tmp_path_factory.mktemp("jax")), args)
    init = jax.tree.map(np.asarray, js.state)
    jl, tl = [], []
    _record_losses(js.mapper, jl)
    js.run()
    ts = TSLAM(tiny_cfg(tmp_path_factory.mktemp("torch")), args, device="cpu")
    assert not ts.nice and ts.coarse_mapper is None
    ts.state = scene_from_jax(init, device="cpu")
    _record_losses(ts.mapper, tl)
    ts.run()
    return js, ts, (jl, tl)


def test_schedule_and_outputs(runs):
    js, ts, (jl, tl) = runs
    # frame 0: 40; frame 2: 3 calls of 6 // 3; frame 3 (last): 5 x 6
    assert [len(x) for x in tl] == [len(x) for x in jl] == [40] + [2] * 3 + [6] * 5
    for k in ("tracked_frames", "mapping_events", "coarse_mapping_events"):
        assert ts.timings[k] == js.timings[k], k
    assert ts.timings["coarse_mapping_events"] == 0
    assert ts.keyframes.frame_ids == js.keyframes.frame_ids == [0, 2]
    assert os.path.exists(os.path.join(ts.output, "ckpts", "00003.tar"))
    saved = np.load(os.path.join(ts.output, "poses.npz"))
    np.testing.assert_array_equal(saved["gt_c2w_list"], js.gt_c2w_list)


def test_tracked_poses_agree(runs):
    js, ts, _ = runs
    je = js.estimate_c2w_list
    te = ts.estimate_c2w_list.cpu().numpy()
    np.testing.assert_array_equal(te[0], je[0])
    assert np.all(np.linalg.norm(je[:, :3, 3] - te[:, :3, 3], axis=1) < 0.01)
    assert np.abs(je[:, :3, :3] - te[:, :3, :3]).max() < 0.03
    gt = js.gt_c2w_list
    _, _, err = jalign(je[:, :3, 3].T.astype(np.float64),
                       gt[:, :3, 3].T.astype(np.float64))
    ate_j = float(np.sqrt(np.mean(err ** 2)))
    assert ate_rmse(te, gt) <= ate_j + 0.005


def test_mapping_losses_agree(runs):
    _, _, (jl, tl) = runs
    assert all(np.isfinite(x).all() for x in tl)
    np.testing.assert_allclose(tl[0].mean(), jl[0].mean(), rtol=0.1)
    for x in (jl[0], tl[0]):
        assert x[-10:].mean() < x[:10].mean()
    for a, b in zip(tl[1:], jl[1:]):
        assert 1 / 1.5 < a.mean() / b.mean() < 1.5
