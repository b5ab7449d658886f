"""The port's ``tools/selfcheck.py`` end to end at a tiny size on the CPU
(NICE tracked, NICE from ground-truth cameras, iMAP*), its summary against
the JAX tool's keys, and the mapper's selected-keyframe record
(``mapping.save_selected_keyframes_info``) against the JAX mapper's, in
the checkpoint both packages write.

The record test maps from ground-truth cameras with 'global' keyframe
selection and a window larger than the keyframe count, so every mapping
call's window holds every keyframe: the selection is the same set in both
packages (its order is a random draw in each) and the poses are exact.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

from nice_slam_tpu.config import load_config
from nice_slam_tpu.slam.slam import NiceSLAM as JSLAM
from nice_slam_torch.config import load_config as tload
from nice_slam_torch.slam.slam import NiceSLAM as TSLAM
from nice_slam_torch.tools import selfcheck

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
# the keys of the JAX tool's summary line (nice_slam_tpu/tools/selfcheck.py)
SUMMARY_KEYS = ["accuracy_cm", "ate_rmse_cm", "completion_cm", "completion_ratio_pct",
                "depth_l1_cm", "frames", "orbit_radians", "timings"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several test workers share few cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = ["--device", "cpu", "--frames", "6", "--iters", "3", "--iters_first", "5",
        "--resolution", "32", "--depth_l1_imgs", "5"]


@pytest.mark.parametrize("flags,kind", [([], "tracked"), (["--gt_camera"], "gt_tour"),
                                        (["--imap"], "imap")])
def test_tiny_selfcheck_summary(tmp_path, flags, kind):
    record = str(tmp_path / "quality.json")
    args = selfcheck.parser().parse_args(
        TINY + flags + ["--out", str(tmp_path / "run"), "--record", record])
    summary = selfcheck.run(args)
    line = json.dumps(summary, allow_nan=False)  # strict JSON
    assert sorted(json.loads(line)) == SUMMARY_KEYS
    assert summary["frames"] == 6 and summary["orbit_radians"] == 0.05
    for k in ("accuracy_cm", "completion_cm", "completion_ratio_pct", "ate_rmse_cm"):
        assert np.isfinite(summary[k]), k
    if "--gt_camera" in flags:
        assert summary["ate_rmse_cm"] == 0.0
        assert summary["timings"]["tracking_s"] < summary["timings"]["mapping_s"]
    for k in ("gt_mesh_s", "eval_3d_s", "eval_2d_s", "fps", "meshing_s"):
        assert summary["timings"][k] > 0, k
    for f in ("gt_room.ply", "gt_room_pc_unseen.npy", "mesh/final_mesh_eval_rec.ply"):
        assert os.path.exists(tmp_path / "run" / f), f
    with open(record) as f:
        assert json.load(f) == {kind: json.loads(line)}
    assert sorted(os.listdir(tmp_path)) == ["quality.json", "run"]  # nothing else written


def test_record_kind_matches_jax_naming():
    p = selfcheck.parser()
    cases = [([], "tracked"), (["--gt_camera"], "gt_tour"), (["--imap"], "imap"),
             (["--no_pretrain", "--seed", "3"], "tracked_scratch_s3"),
             (["--imap", "--keyframe_every", "5"], "imap_kf5"),
             (["--gt_camera", "--kind", "x"], "x")]
    for flags, kind in cases:
        assert selfcheck.record_kind(p.parse_args(flags)) == kind


def _record_cfg(out, load):
    cfg = load(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
               os.path.join(ROOT, "configs", "nice_slam.yaml"))
    cfg["coarse"] = False
    cfg["verbose"] = False
    cfg["meshing"] = None
    cfg["data"].update({"n_frames": 11, "output": str(out), "orbit_radians": 0.05})
    cfg["cam"].update({"H": 30, "W": 40, "fx": 30.0, "fy": 30.0, "cx": 19.5, "cy": 14.5})
    cfg["tracking"]["gt_camera"] = True
    cfg["mapping"].update({"pixels": 100, "iters_first": 6, "iters": 3,
                           "keyframe_selection_method": "global",
                           "mapping_window_size": 8,
                           "save_selected_keyframes_info": True})
    cfg["rendering"].update({"N_samples": 8, "N_surface": 4})
    cfg["pretrained_decoders"] = {"coarse": "", "middle_fine": ""}
    return cfg


def test_selected_keyframes_record_matches_jax(tmp_path):
    args = argparse.Namespace(nice=True, input_folder=None, output=None)
    js = JSLAM(_record_cfg(tmp_path / "jax", load_config), args)
    js.run()
    ts = TSLAM(_record_cfg(tmp_path / "torch", tload), args, device="cpu")
    ts.run()
    jck = torch.load(str(tmp_path / "jax" / "ckpts" / "00010.tar"), weights_only=False)
    tck = torch.load(str(tmp_path / "torch" / "ckpts" / "00010.tar"), weights_only=False)
    jsel, tsel = jck["selected_keyframes"], tck["selected_keyframes"]
    assert sorted(tsel) == sorted(jsel) == [0, 5, 10]
    assert [e["idx"] for e in tsel[10]][-1] == 10  # the current frame last
    for idx in jsel:
        j = sorted(jsel[idx][:-1], key=lambda e: e["idx"]) + jsel[idx][-1:]
        t = sorted(tsel[idx][:-1], key=lambda e: e["idx"]) + tsel[idx][-1:]
        assert [e["idx"] for e in t] == [e["idx"] for e in j]
        for a, b in zip(t, j):
            for k in ("gt_c2w", "est_c2w"):
                np.testing.assert_array_equal(np.asarray(a[k], np.float32),
                                              np.asarray(b[k], np.float32))
    assert [e["idx"] for e in tsel[10]] == [0, 5, 10]


def test_selected_keyframes_off_by_default(tmp_path):
    cfg = _record_cfg(tmp_path, tload)
    cfg["mapping"]["save_selected_keyframes_info"] = False
    cfg["data"]["n_frames"] = 2
    ts = TSLAM(cfg, argparse.Namespace(nice=True, output=None), device="cpu")
    ts.run()
    assert ts.mapper.selected_keyframes is None
    ck = torch.load(str(tmp_path / "ckpts" / "00001.tar"), weights_only=False)
    assert ck["selected_keyframes"] is None
