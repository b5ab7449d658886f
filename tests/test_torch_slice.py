"""The whole slice: 4 frames of the strict NICE-SLAM loop (init mapping,
tracking, coarse mapping, the final color-refine mapping) on a tiny box
scene, run by the JAX package and by the port from the same initial scene
state and the same pre-drawn tracking pixels.

The two runs cannot be bitwise equal: the mapper's pixel draws come from
``jax.random`` in one and a ``torch.Generator`` in the other, and the JAX
loop tracks mapping frames on its own draws.  So the test bounds what the
different draws allow: tracked positions within 1.5 cm of each other
(both drift 1-3 cm from the truth at this size), the port's ATE within
1 cm of the JAX run's, and every mapping event's mean loss within a
factor 1.5 (150 rays x 10 iterations per event; the 150-iteration first
event within 10 %).
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
                      os.path.join(ROOT, "configs", "nice_slam.yaml"))
    cfg["coarse"] = True
    cfg["verbose"] = False
    cfg["meshing"] = None  # no meshes: this test compares the loops
    cfg["data"].update({"n_frames": 4, "output": str(out),
                        "orbit_radians": 0.05})
    cfg["cam"].update({"H": 30, "W": 40, "fx": 30.0, "fy": 30.0, "cx": 19.5,
                       "cy": 14.5})
    cfg["tracking"].update({"pixels": 64, "iters": 6, "ignore_edge_W": 2,
                            "ignore_edge_H": 2})
    cfg["mapping"].update({"pixels": 150, "iters_first": 150, "iters": 10})
    cfg["rendering"].update({"N_samples": 12, "N_surface": 6})
    for k in ("coarse", "middle_fine"):
        cfg["pretrained_decoders"][k] = os.path.join(
            ROOT, cfg["pretrained_decoders"][k])
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
    args = argparse.Namespace(nice=True, input_folder=None, output=None)
    js = JSLAM(tiny_cfg(tmp_path_factory.mktemp("jax")), args)
    init = jax.tree.map(np.asarray, js.state)
    jl, tl, jc, tc = [], [], [], []
    _record_losses(js.mapper, jl)
    _record_losses(js.coarse_mapper, jc)
    js.run()
    ts = TSLAM(tiny_cfg(tmp_path_factory.mktemp("torch")), args, device="cpu")
    ts.state = scene_from_jax(init, device="cpu")
    _record_losses(ts.mapper, tl)
    _record_losses(ts.coarse_mapper, tc)
    ts.run()
    return js, ts, (jl, tl), (jc, tc)


def test_schedule_and_outputs(runs):
    js, ts, (jl, tl), (jc, tc) = runs
    # frame 0 init + frame 3 (last) refined in 5 outer rounds; coarse at 0
    assert [len(x) for x in tl] == [len(x) for x in jl] == [150] + [10] * 5
    assert [len(x) for x in tc] == [len(x) for x in jc] == [150]
    for k in ("tracked_frames", "mapping_events", "coarse_mapping_events"):
        assert ts.timings[k] == js.timings[k], k
    assert os.path.exists(os.path.join(ts.output, "timings.json"))
    saved = np.load(os.path.join(ts.output, "poses.npz"))
    np.testing.assert_array_equal(saved["gt_c2w_list"], js.gt_c2w_list)
    assert ts.keyframes.frame_ids == js.keyframes.frame_ids


def test_tracked_poses_agree(runs):
    js, ts, _, _ = runs
    je = js.estimate_c2w_list
    te = ts.estimate_c2w_list.cpu().numpy()
    np.testing.assert_array_equal(te[0], je[0])
    assert np.all(np.linalg.norm(je[:, :3, 3] - te[:, :3, 3], axis=1) < 0.015)
    assert np.abs(je[:, :3, :3] - te[:, :3, :3]).max() < 0.03
    gt = js.gt_c2w_list
    _, _, err = jalign(je[:, :3, 3].T.astype(np.float64),
                       gt[:, :3, 3].T.astype(np.float64))
    ate_j = float(np.sqrt(np.mean(err ** 2)))
    assert ate_rmse(te, gt) <= ate_j + 0.01


def test_mapping_losses_agree(runs):
    _, _, (jl, tl), (jc, tc) = runs
    np.testing.assert_allclose(tl[0].mean(), jl[0].mean(), rtol=0.1)
    np.testing.assert_allclose(tc[0].mean(), jc[0].mean(), rtol=0.1)
    for a, b in zip(tl[1:], jl[1:]):
        assert 1 / 1.5 < a.mean() / b.mean() < 1.5
