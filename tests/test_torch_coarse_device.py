"""The coarse mapper on a device of its own, case for case with
``tests/test_coarse_device.py``: the pinned call against the default one,
the system engaging the pin over several devices and merging the coarse
grid back, and the strict loop issuing the main and the coarse mapping
calls with no host sync between them.  The port runs over ``devices=[cpu]
* 8`` (the card's form of the last rule, a CUDA event still pending at
the coarse call, is in ``tests/test_torch_cuda.py``); the JAX side on the
conftest's 8 virtual CPU devices.
"""

import argparse
import os

import jax
import numpy as np
import pytest
import torch

from nice_slam_tpu.config import load_config
from nice_slam_torch.convert import scene_from_jax

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CPU = torch.device("cpu")
DEVICES = [CPU] * 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several workers share few cores in the tier-1 run: one torch
    thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _coarse_cfg():
    return {
        "scale": 1, "coarse": True, "occupancy": True,
        "grid_len": {"coarse": 2, "middle": 1.1, "fine": 0.55, "color": 0.55,
                     "bound_divisible": 1.1},
        "model": {"c_dim": 8, "coarse_bound_enlarge": 2,
                  "pos_embedding_method": "fourier"},
        "data": {"dim": 3},
        "mapping": {"bound": [[-2.2, 2.2]] * 3},
        "rendering": {"N_samples": 8, "N_surface": 4, "N_importance": 0,
                      "lindisp": False, "perturb": 0.0},
    }


def test_pinned_coarse_call_matches_default(monkeypatch):
    """Mapper.optimize_map pinned to the last device equals the default
    placement (bit for bit: the same draws from a generator made again
    from the same seed), its output lies on the pinned device, and its
    losses are those of the JAX package's coarse call within the factor
    1.5 of tests/test_torch_slice.py (the two draw different pixels)."""
    from nice_slam_tpu.models.scene import build_scene as jbuild
    from nice_slam_tpu.ops import interp as jinterp
    from nice_slam_tpu.ops.render import RenderConfig as JRender
    from nice_slam_tpu.slam.keyframes import KeyframeStore as JStore
    from nice_slam_tpu.slam.mapper import Mapper as JMapper
    from nice_slam_tpu.slam.mapper import MapperConfig as JMC
    from nice_slam_torch.models.scene import build_scene as tbuild
    from nice_slam_torch.ops.render import RenderConfig
    from nice_slam_torch.slam.keyframes import KeyframeStore
    from nice_slam_torch.slam.mapper import Mapper, MapperConfig

    monkeypatch.setattr(jinterp, "_DGRAD_BF16", False)
    cfg = _coarse_cfg()
    jspec, jstate = jbuild(cfg, nice=True, seed=0)
    tspec, _ = tbuild(cfg, nice=True, device="cpu")
    state = scene_from_jax(jax.tree.map(np.asarray, jstate), CPU)
    cam = {"H": 48, "W": 64, "fx": 48.0, "fy": 48.0, "cx": 31.5, "cy": 23.5}
    cfg_m = {
        "pixels": 256, "iters": 3, "iters_first": 3, "every_frame": 1,
        "keyframe_every": 1, "mapping_window_size": 2,
        "middle_iter_ratio": 0.4, "fine_iter_ratio": 0.7,
        "w_color_loss": 0.2, "BA": False, "BA_cam_lr": 0.001,
        "fix_fine": True, "fix_color": False,
        "frustum_feature_selection": False,
        "keyframe_selection_method": "global", "lr_first_factor": 5,
        "lr_factor": 1, "color_refine": False,
        "stage": {s: {"decoders_lr": 0.001, "coarse_lr": 0.01,
                      "middle_lr": 0.01, "fine_lr": 0.01, "color_lr": 0.01}
                  for s in ("coarse", "middle", "fine", "color")},
    }
    m = {"mapping": cfg_m, "occupancy": True}
    mcfg = MapperConfig.from_cfg(m, cam, nice=True, coarse_mapper=True)
    rcfg = RenderConfig.from_cfg(cfg)
    rng = np.random.default_rng(0)
    color = rng.random((48, 64, 3)).astype(np.float32)
    depth = (1.0 + rng.random((48, 64))).astype(np.float32)
    c2w = np.eye(4, dtype=np.float32)

    results = {}
    for name, dev in (("default", None), ("pinned", DEVICES[-1])):
        mapper = Mapper(tspec, mcfg, rcfg, "cpu", seed=7)
        mapper.devices = DEVICES  # the pin must turn ray parallelism off
        if dev is not None:
            mapper.pin(dev)
            assert mapper.device == dev and mapper.devices is None
        else:
            mapper.devices = None
        new_state, _, losses = mapper.optimize_map(
            state, 3, 1.0, torch.tensor(color), torch.tensor(depth),
            KeyframeStore(4, 48, 64, "cpu"), torch.tensor(c2w), False)
        results[name] = (losses.numpy(), new_state.grids["grid_coarse"].numpy())
        if dev is not None:
            assert new_state.grids["grid_coarse"].device == dev
    np.testing.assert_allclose(results["pinned"][0], results["default"][0], rtol=1e-5)
    np.testing.assert_allclose(results["pinned"][1], results["default"][1], atol=1e-6)
    assert np.abs(results["default"][1] - state.grids["grid_coarse"].numpy()).max() > 0

    jm = JMapper(jspec, JMC.from_cfg(m, cam, nice=True, coarse_mapper=True),
                 JRender.from_cfg(cfg), seed=7)
    jm.mesh = None
    jm.device = jax.devices()[-1]
    _, _, jl = jm.optimize_map(jstate, 3, 1.0, 0, color, depth, c2w,
                               JStore(4, 48, 64), c2w, False)
    ratio = results["pinned"][0].mean() / np.asarray(jl).mean()
    assert 1 / 1.5 < ratio < 1.5


def _box_cfg(out, n_frames=6):
    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "nice_slam.yaml"))
    big = 10 ** 6
    cfg["coarse"] = True
    cfg["verbose"] = False  # the verbose loss print syncs by design
    cfg["meshing"] = None
    cfg["data"]["n_frames"] = n_frames
    cfg["data"]["output"] = str(out)
    cfg["cam"].update({"H": 60, "W": 80, "fx": 60.0, "fy": 60.0,
                       "cx": 39.5, "cy": 29.5})
    cfg["tracking"].update({"pixels": 100, "iters": 4, "gt_camera": True,
                            "vis_freq": big, "vis_inside_freq": big})
    cfg["mapping"].update({"pixels": 320, "iters_first": 20, "iters": 10,
                           "every_frame": 5, "keyframe_every": 5,
                           "color_refine": False, "mesh_freq": big, "ckpt_freq": big,
                           "vis_freq": big, "vis_inside_freq": big})
    cfg["rendering"].update({"N_samples": 8, "N_surface": 4})
    for k in ("coarse", "middle_fine"):
        cfg["pretrained_decoders"][k] = os.path.join(ROOT, cfg["pretrained_decoders"][k])
    return cfg


def test_slam_engages_coarse_device_and_merges(tmp_path):
    """A strict run over 8 devices pins the coarse mapper to the last one
    (no ray parallelism there), merges each updated coarse grid back onto
    the main state's device, and keeps the main grids advancing; with
    NICE_SLAM_TORCH_COARSE_DEVICE=0 the coarse mapper is not pinned."""
    from nice_slam_torch.slam.slam import NiceSLAM

    args = argparse.Namespace(nice=True, input_folder=None, output=None)
    slam = NiceSLAM(_box_cfg(tmp_path), args, devices=DEVICES)
    assert slam.coarse_mapper is not None
    assert slam.coarse_mapper.device == DEVICES[-1]
    assert slam.coarse_mapper.devices is None and slam.mapper.devices == DEVICES
    before = slam.state.grids["grid_coarse"].clone()
    middle = slam.state.grids["grid_middle"].clone()
    slam.run()
    after = slam.state.grids["grid_coarse"]
    assert after.device == slam.state.grids["grid_middle"].device == slam.device
    assert float((after - before).abs().max()) > 0
    assert float((slam.state.grids["grid_middle"] - middle).abs().max()) > 0
    assert slam.mapping_idx == 5 and slam.timings["coarse_mapping_events"] == 1
    assert torch.isfinite(slam.estimate_c2w_list[:6]).all()

    os.environ["NICE_SLAM_TORCH_COARSE_DEVICE"] = "0"
    try:
        other = NiceSLAM(_box_cfg(tmp_path / "off"), args, devices=DEVICES)
    finally:
        del os.environ["NICE_SLAM_TORCH_COARSE_DEVICE"]
    assert other.coarse_mapper.device is None
    assert other.coarse_mapper.devices == DEVICES


def test_paired_event_dispatches_overlap(tmp_path, monkeypatch):
    """The point of the pin: the strict loop reaches the coarse call with
    no host sync after the main mapper's call (at frames 0 and 5, where
    each paired event also adds a keyframe).  On the CPU the host syncs
    are the system's ``_sync`` calls, recorded in order with the two
    calls; the run without the pin shows the sync the pin removes."""
    from nice_slam_torch.slam.slam import NiceSLAM

    args = argparse.Namespace(nice=True, input_folder=None, output=None)
    for pinned in (True, False):
        monkeypatch.setenv("NICE_SLAM_TORCH_COARSE_DEVICE", "1" if pinned else "0")
        slam = NiceSLAM(_box_cfg(tmp_path / str(pinned), n_frames=7), args,
                        devices=DEVICES)
        assert (slam.coarse_mapper.device is not None) == pinned
        events = []
        real_main, real_coarse = slam.mapper.optimize_map, slam.coarse_mapper.optimize_map
        real_sync = slam._sync

        def spy_main(*a, **k):
            out = real_main(*a, **k)
            events.append("main")
            return out

        def spy_coarse(*a, **k):
            events.append("coarse")
            return real_coarse(*a, **k)

        def spy_sync():
            events.append("sync")
            real_sync()

        slam.mapper.optimize_map = spy_main
        slam.coarse_mapper.optimize_map = spy_coarse
        slam._sync = spy_sync
        slam.run()
        pairs = [i for i, e in enumerate(events) if e == "coarse"]
        assert len(pairs) == 2, events  # frames 0 and 5 (6 is the last)
        for i in pairs:
            last_main = max(j for j in range(i) if events[j] == "main")
            between = events[last_main + 1:i]
            assert ("sync" in between) != pinned, (pinned, events)
        assert len(slam.keyframes) == 2 and slam.mapping_idx == 6
