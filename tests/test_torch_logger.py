"""The port's checkpoints against the JAX package's, and resume.

Checkpoints hold the same tensors in both packages (grids in the
reference's [1, C, Z, Y, X] layout, decoder weights as (out, in)), so
everything here is exact: the converters round-trip, a ``.tar`` written by
either package loads in the other with equal values, and a resumed run
restores its state and poses bit for bit before it goes on (the resume
test of test_resume.py, on the port at 60x80, 6 then 10 frames, with
fewer iterations and pixels).
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nice_slam_tpu.config import load_config as jload_config
from nice_slam_tpu.models import pretrain as jpre
from nice_slam_tpu.models import scene as jscene
from nice_slam_tpu.utils import logger as jlog
from nice_slam_torch.config import load_config
from nice_slam_torch.convert import scene_from_jax, scene_to_numpy
from nice_slam_torch.models import scene as tscene
from nice_slam_torch.utils import logger as tlog

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


def _box_cfg():
    cfg = jload_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                       os.path.join(ROOT, "configs", "nice_slam.yaml"))
    cfg["coarse"] = True
    for k in ("coarse", "middle_fine"):
        cfg["pretrained_decoders"][k] = os.path.join(ROOT, cfg["pretrained_decoders"][k])
    return cfg


@pytest.fixture(scope="module")
def scenes():
    cfg = _box_cfg()
    jspec, jstate = jscene.build_scene(cfg, nice=True, seed=3)
    jstate = jpre.load_pretrain(cfg, jspec, jstate, verbose=False)
    rng = np.random.default_rng(4)
    jstate = jstate._replace(grids={
        k: jnp.asarray(rng.standard_normal(v.shape), jnp.float32)
        for k, v in jstate.grids.items()})
    tspec, ttemplate = tscene.build_scene(cfg, nice=True, seed=9, device="cpu")
    tstate = scene_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    poses = rng.standard_normal((7, 4, 4)).astype(np.float32)
    return jspec, jstate, tspec, ttemplate, tstate, poses


def _assert_tree_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_layout_converters_round_trip_and_match_jax():
    grid = np.random.default_rng(0).standard_normal((5, 4, 3, 8)).astype(np.float32)
    t = tlog.grid_to_torch_layout(torch.tensor(grid))
    assert t.shape == (1, 8, 3, 4, 5) and t.device.type == "cpu"
    assert torch.equal(t, jlog.grid_to_torch_layout(grid))
    np.testing.assert_array_equal(tlog.grid_from_torch_layout(t).numpy(), grid)
    np.testing.assert_array_equal(tlog.grid_from_torch_layout(t[0]).numpy(), grid)
    np.testing.assert_array_equal(jlog.grid_from_torch_layout(t), grid)


def test_state_dict_converters_round_trip_and_match_jax(scenes):
    jspec, jstate, tspec, ttemplate, tstate, _ = scenes
    tsd = tlog.decoders_to_state_dict(tspec, tstate.decoders)
    jsd = jlog.decoders_to_state_dict(jspec, jstate.decoders)
    assert sorted(tsd) == sorted(jsd)
    for k in jsd:
        assert tsd[k].device.type == "cpu"
        assert torch.equal(tsd[k], jsd[k]), k
    back = tlog.decoders_from_state_dict(tspec, tsd, ttemplate.decoders)
    _assert_tree_equal(back, tstate.decoders)


def test_jax_checkpoint_loads_in_port(scenes, tmp_path):
    jspec, jstate, tspec, ttemplate, _, poses = scenes
    path = jlog.Logger(str(tmp_path), jspec, verbose=False).log(
        6, jstate, poses, poses[::-1].copy(), [0, 5], selected_keyframes=None)
    state, est, gt, kfs, idx = tlog.load_checkpoint(path, tspec, ttemplate)
    _assert_tree_equal(scene_to_numpy(state)["grids"], jax.tree.map(np.asarray, jstate.grids))
    _assert_tree_equal(scene_to_numpy(state)["decoders"],
                       jax.tree.map(np.asarray, jstate.decoders))
    np.testing.assert_array_equal(est, poses)
    np.testing.assert_array_equal(gt, poses[::-1])
    assert (kfs, idx) == ([0, 5], 6)


def test_port_checkpoint_loads_in_jax_with_the_same_keys(scenes, tmp_path):
    jspec, jstate, tspec, _, tstate, poses = scenes
    path = tlog.Logger(str(tmp_path), tspec, verbose=False).log(
        4, tstate, torch.tensor(poses), poses[::-1].copy(), [0, 5])
    assert path == os.path.join(str(tmp_path), "ckpts", "00004.tar")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    jpath = jlog.Logger(str(tmp_path / "jax"), jspec, verbose=False).log(
        4, jstate, poses, poses[::-1].copy(), [0, 5])
    jckpt = torch.load(jpath, map_location="cpu", weights_only=False)
    assert sorted(ckpt) == sorted(jckpt)
    assert sorted(ckpt["c"]) == sorted(jckpt["c"])
    for k, v in ckpt["c"].items():
        assert v.device.type == "cpu" and torch.equal(v, jckpt["c"][k])
    assert torch.equal(ckpt["bound"], jckpt["bound"])
    state, est, gt, kfs, idx = jlog.load_checkpoint(path, jspec, jstate)
    _assert_tree_equal(state.grids, jstate.grids)
    _assert_tree_equal(state.decoders, jstate.decoders)
    np.testing.assert_array_equal(est, poses)
    np.testing.assert_array_equal(gt, poses[::-1])
    assert (kfs, idx) == ([0, 5], 4)


def _run_cfg(tmp, n_frames):
    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "nice_slam.yaml"))
    for k in ("coarse", "middle_fine"):
        cfg["pretrained_decoders"][k] = os.path.join(ROOT, cfg["pretrained_decoders"][k])
    cfg["coarse"] = False
    cfg["verbose"] = False
    cfg["data"].update({"n_frames": n_frames, "output": str(tmp)})
    cfg["cam"].update({"H": 60, "W": 80, "fx": 60.0, "fy": 60.0, "cx": 39.5, "cy": 29.5})
    cfg["tracking"].update({"pixels": 50, "iters": 4, "ignore_edge_W": 4,
                            "ignore_edge_H": 4})
    cfg["mapping"].update({"pixels": 100, "iters_first": 20, "iters": 5,
                           "every_frame": 5, "keyframe_every": 5,
                           "mesh_freq": 10 ** 6, "ckpt_freq": 10 ** 6})
    cfg["rendering"].update({"N_samples": 8, "N_surface": 4})
    cfg["meshing"]["resolution"] = 32
    return cfg


def test_resume_continues_run(tmp_path):
    from nice_slam_torch.slam.slam import NiceSLAM

    args = argparse.Namespace(nice=True, input_folder=None, output=None)
    # phase 1: the first 6 frames (a final checkpoint at frame 5)
    slam1 = NiceSLAM(_run_cfg(tmp_path, 6), args, device="cpu")
    slam1.run()
    assert os.path.exists(tmp_path / "ckpts" / "00005.tar")
    assert os.path.exists(tmp_path / "mesh" / "final_mesh.ply")
    est_prefix = slam1.estimate_c2w_list[:6].clone()

    # phase 2: a fresh system over the longer sequence resumes from it
    slam2 = NiceSLAM(_run_cfg(tmp_path, 10), args, device="cpu")
    assert slam2.resume() == 6
    assert torch.equal(slam2.estimate_c2w_list[:6], est_prefix)
    assert slam2.keyframes.frame_ids == slam1.keyframes.frame_ids
    for name, g in slam1.state.grids.items():
        assert torch.equal(slam2.state.grids[name], g), name
    _assert_tree_equal(scene_to_numpy(slam2.state)["decoders"],
                       scene_to_numpy(slam1.state)["decoders"])

    slam2.run()
    assert slam2.timings["frames"] == 4 and slam2.timings["tracked_frames"] == 4
    assert torch.isfinite(slam2.estimate_c2w_list[:10]).all()
    assert bool((slam2.estimate_c2w_list[9] != 0).any())
    # the pre-resume prefix is untouched by the continued run
    assert torch.equal(slam2.estimate_c2w_list[:6], est_prefix)
    assert os.path.exists(tmp_path / "ckpts" / "00009.tar")
