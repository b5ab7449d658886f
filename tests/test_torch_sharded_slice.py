"""Six frames of the strict NICE-SLAM loop with the scene's grids spatially
sharded, in the JAX package (over the conftest's 8 virtual CPU devices)
and in the port (over ``devices=[cpu] * 3``), against each other and
against the port's dense run, from the same scene and the same pre-drawn
tracking pixels, as ``tests/test_torch_slice.py`` runs the dense loop;
held to that file's tolerances.  It stands apart from
``tests/test_torch_grid_sharding.py`` only for time (the JAX side's
sharded programs compile for ~40 s here).
"""

import argparse
import os

import jax
import numpy as np
import pytest
import torch

from nice_slam_tpu.config import load_config
from nice_slam_tpu.parallel import grid_sharding as jgs
from nice_slam_torch.convert import scene_from_jax
from nice_slam_torch.parallel import grid_sharding as tgs

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several workers share few cores in the tier-1 run: one torch
    thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _halo_equal(sg):
    for lo, hi in zip(sg.slabs[:-1], sg.slabs[1:]):
        assert torch.equal(lo[-1], hi[0]), "halo planes diverged"


def _box_cfg(out):
    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "nice_slam.yaml"))
    cfg["coarse"] = False
    cfg["verbose"] = False
    cfg["meshing"] = None  # no meshes: this test compares the loops
    cfg["data"].update({"n_frames": 6, "output": str(out), "orbit_radians": 0.05})
    cfg["cam"].update({"H": 60, "W": 80, "fx": 60.0, "fy": 60.0, "cx": 39.5,
                       "cy": 29.5})
    # each frame tracked from the last pose: the constant-speed guess
    # (2 x_t - x_t-1) doubles the last-ulp differences of the two packages'
    # Adam steps into centimetres within a few frames
    cfg["tracking"].update({"pixels": 100, "iters": 20, "ignore_edge_W": 2,
                            "ignore_edge_H": 2, "const_speed_assumption": False})
    cfg["mapping"].update({"pixels": 150, "iters_first": 150, "iters": 10,
                           "every_frame": 5, "color_refine": False})
    cfg["rendering"].update({"N_samples": 12, "N_surface": 6})
    for k in ("coarse", "middle_fine"):
        cfg["pretrained_decoders"][k] = os.path.join(ROOT, cfg["pretrained_decoders"][k])
    return cfg


def test_sharded_slam_box_run_matches_jax_and_dense(tmp_path, monkeypatch):
    """Six frames of the strict loop (60x80, pixels pre-drawn from the
    config's seed as in tests/test_torch_slice.py) with spatial sharding
    forced in both packages (JAX over its 8 virtual devices, the port over
    [cpu] * 3), from the same scene: the port's tracked positions within
    1.5 cm and rotations within 0.03 of the JAX run's and of its own dense
    run, its ATE within 1 cm of the JAX run's; the final grids sharded,
    their halo planes bitwise equal."""
    from nice_slam_tpu.slam.slam import NiceSLAM as JSLAM
    from nice_slam_tpu.tools.eval_ate import align as jalign
    from nice_slam_torch.slam.slam import NiceSLAM as TSLAM
    from nice_slam_torch.tools.eval_ate import ate_rmse

    args = argparse.Namespace(nice=True, input_folder=None, output=None)
    monkeypatch.setenv("NICE_SLAM_TPU_SPATIAL", "1")
    js = JSLAM(_box_cfg(tmp_path / "jax"), args)
    assert js.spatial_mesh is not None and js.spatial_mesh.size == 8
    init = jax.tree.map(np.asarray, jgs.dense_grids(js.state.grids))
    decoders = jax.tree.map(np.asarray, js.state.decoders)
    js.run()

    runs = {}
    for kind, spatial in (("sharded", "1"), ("dense", "0")):
        monkeypatch.setenv("NICE_SLAM_TORCH_SPATIAL", spatial)
        ts = TSLAM(_box_cfg(tmp_path / kind), args,
                   devices=[CPU] * 3 if spatial == "1" else [CPU])
        base = scene_from_jax({"decoders": decoders, "grids": init,
                               "bound": np.asarray(js.state.bound),
                               "coarse_bound": np.asarray(js.state.coarse_bound)}, CPU)
        ts.state = base
        if spatial == "1":
            assert ts.spatial_devices == [CPU] * 3 and ts.mapper.devices is None
            ts.state = base._replace(grids=tgs.shard_scene_grids(base.grids, [CPU] * 3))
        ts.run()
        runs[kind] = ts
    for sg in runs["sharded"].state.grids.values():
        assert isinstance(sg, tgs.ShardedGrid)
        _halo_equal(sg)

    je = js.estimate_c2w_list
    gt = js.gt_c2w_list
    _, _, err = jalign(je[:, :3, 3].T.astype(np.float64), gt[:, :3, 3].T.astype(np.float64))
    ate_j = float(np.sqrt(np.mean(err ** 2)))
    te = runs["sharded"].estimate_c2w_list.numpy()
    for ref in (je, runs["dense"].estimate_c2w_list.numpy()):
        np.testing.assert_array_equal(te[0], ref[0])
        assert np.all(np.linalg.norm(ref[:, :3, 3] - te[:, :3, 3], axis=1) < 0.015)
        assert np.abs(ref[:, :3, :3] - te[:, :3, :3]).max() < 0.03
    assert ate_rmse(te, gt) <= ate_j + 0.01
    assert runs["sharded"].mapping_idx == js.mapping_idx == 5
