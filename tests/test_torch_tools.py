"""The port's tools against the JAX package's: the tracking envelope's
config edits and record, one real envelope run at a cut size, the loss
landscape's losses and its CLI, ``prep_own_data``, and ``get_model``.

Tolerance of the landscape comparison: the tracking loss through the
Fourier embedding agrees to 1e-3 relative (the tracker's test).
"""

import argparse
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from nice_slam_tpu.models import pretrain as jpre
from nice_slam_tpu.models import scene as jscene
from nice_slam_tpu.ops import geometry as jgeo
from nice_slam_tpu.ops.render import RenderConfig as JRender
from nice_slam_tpu.slam import tracker as jtr
from nice_slam_torch.convert import scene_from_jax
from nice_slam_torch.tools import loss_landscape as tll
from nice_slam_torch.tools import track_envelope as tte

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several tier-1 workers share few cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _StubSLAM:
    """Stands in for NiceSLAM: records the config it was built with and
    returns a fixed drifting trajectory."""

    made = []

    def __init__(self, cfg, args, device=None):
        _StubSLAM.made.append(json.loads(json.dumps(cfg)))
        n = cfg["data"]["n_frames"]
        self.gt_c2w_list = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        self.gt_c2w_list[:, 0, 3] = np.linspace(0, 1, n)
        est = self.gt_c2w_list.copy()
        est[:, 1, 3] += 0.01 * np.arange(n) * cfg["data"]["orbit_radians"]
        self._est = est

    def run(self):
        pass


def test_envelope_config_edits_and_record_equal_jax(tmp_path, monkeypatch):
    import nice_slam_tpu.slam.slam as jslam
    import nice_slam_torch.slam.slam as tslam
    from nice_slam_tpu.tools import track_envelope as jte

    class JStub(_StubSLAM):
        @property
        def estimate_c2w_list(self):
            return self._est

    class TStub(_StubSLAM):
        @property
        def estimate_c2w_list(self):
            return torch.tensor(self._est)

    flags = ["--frames", "3", "--deg", "1.0,2.5", "--cf_iters", "4", "--cf_mult", "3.0"]
    books = {}
    made = {}
    for name, module, stub, run in (
            ("jax", jslam, JStub, lambda argv: (monkeypatch.setattr(
                sys, "argv", ["track_envelope"] + argv), jte.main())),
            ("port", tslam, TStub, tte.main)):
        monkeypatch.setattr(module, "NiceSLAM", stub)
        monkeypatch.chdir(ROOT)  # the JAX tool's relative paths
        book = tmp_path / f"{name}.json"
        book.write_text(json.dumps({"gt_tour": {"accuracy_cm": 0.9}}))
        _StubSLAM.made = []
        run(flags + ["--out", str(tmp_path / name), "--record", str(book)])
        made[name] = _StubSLAM.made
        books[name] = json.loads(book.read_text())
    assert len(made["port"]) == len(made["jax"]) == 4
    for j, t in zip(made["jax"], made["port"]):
        # the port resolves the pretrained decoders against the repo
        assert t["pretrained_decoders"] == {
            k: os.path.join(ROOT, v) for k, v in j["pretrained_decoders"].items()}
        for cfg, name in ((j, "jax"), (t, "port")):
            cfg.pop("pretrained_decoders")
            cfg["data"]["output"] = os.path.relpath(cfg["data"]["output"],
                                                    str(tmp_path / name))
        assert t == j
    # the record merges under 'envelope' and keeps the other keys
    assert books["port"] == books["jax"]
    assert books["port"]["gt_tour"] == {"accuracy_cm": 0.9}
    rows = books["port"]["envelope"]["rows"]
    assert [(r["deg_per_frame"], r["mode"]) for r in rows] == [
        (1.0, "default"), (1.0, "cf"), (2.5, "default"), (2.5, "cf")]


def test_envelope_run_once_at_a_cut_size(tmp_path):
    cfg = tte.base_cfg()
    cfg["mapping"].update(iters_first=8, iters=4, pixels=200)
    cfg["tracking"].update(iters=3, pixels=64)
    cfg["rendering"].update(N_samples=8, N_surface=4)
    cfg["meshing"]["resolution"] = 24
    ate = tte.run_once(cfg, 3, 1.0, str(tmp_path / "out"), cf=(2, 5.0), device="cpu")
    assert math.isfinite(ate) and 0.0 <= ate < 0.2
    # the config's own geometry: 3 frames turning 1 deg each
    one = tte.once_cfg(cfg, 3, 1.0, "x", (2, 5.0))
    assert one["data"]["orbit_radians"] == pytest.approx(math.radians(3.0))
    assert (one["tracking"]["cf_iters"], one["tracking"]["cf_lr_mult"]) == (2, 5.0)
    assert "cf_iters" not in cfg["tracking"]  # the base is not edited


@pytest.fixture(scope="module")
def landscape():
    args = tll.parser().parse_args(["--out", "unused", "--no_resume", "--pixels", "64",
                                    "--n_frames", "4", "--device", "cpu"])
    cfg = tll.landscape_cfg(args)
    cfg["cam"].update({"H": 30, "W": 40, "fx": 30.0, "fy": 30.0, "cx": 19.5,
                       "cy": 14.5})
    cfg["tracking"].update({"ignore_edge_W": 2, "ignore_edge_H": 2})
    cfg["rendering"].update({"N_samples": 12, "N_surface": 6})
    return cfg


def test_landscape_losses_match_jax(landscape, tmp_path):
    from nice_slam_torch.slam.slam import NiceSLAM

    cfg = json.loads(json.dumps(landscape))
    cfg["data"]["output"] = str(tmp_path)
    jspec, jstate = jscene.build_scene(cfg, nice=True, seed=1)
    jstate = jpre.load_pretrain(cfg, jspec, jstate, verbose=False)
    ns = argparse.Namespace(nice=True, input_folder=None, output=None)
    slam = NiceSLAM(cfg, ns, device="cpu")
    slam.state = scene_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    deltas = np.array([-0.02, 0.0, 0.01])
    losses = tll.sweep_losses(slam, 2, deltas)
    gt_c2w, pix = tll.frame_pixels(slam, 2)
    pix = [jnp.asarray(x.numpy()) for x in pix]
    jt = jtr.TrackerConfig.from_cfg(cfg, slam.cam, True)
    jr = JRender.from_cfg(cfg)
    loss = jax.jit(lambda cam: jtr.tracking_loss_sampled(jspec, jstate, cam, *pix, jt, jr))
    poses = tll.offset_poses(gt_c2w, deltas)
    assert set(losses) == {"lateral-x", "vertical-y", "yaw"}
    for name, vals in losses.items():
        assert len(vals) == len(deltas)
        for v, c2w in zip(vals, poses[name]):
            want = float(loss(jgeo.tensor_from_pose(jnp.asarray(c2w[:3]))))
            np.testing.assert_allclose(v, want, rtol=1e-3)
    # the rows: the loss at the zero offset is the base
    rows = tll.probe_frame(slam, 2, deltas)
    assert rows["yaw"]["base"] == round(losses["yaw"][1], 1)
    assert rows["yaw"]["biased"] == (int(np.argmin(losses["yaw"])) != 1)


def test_landscape_main_no_resume(tmp_path):
    """The CLI's plumbing, as tests/test_loss_landscape.py runs the JAX
    tool: a fresh map, two frames, a three-point sweep."""
    rec = tmp_path / "landscape.json"
    book = tll.main(["--out", str(tmp_path / "out"), "--no_resume",
                     "--frames", "0", "2", "--deltas_cm", "-2", "0", "2",
                     "--pixels", "64", "--n_frames", "4", "--record", str(rec),
                     "--device", "cpu"])
    assert json.loads(rec.read_text()) == json.loads(json.dumps(book))
    assert set(book) == {"0", "2"}
    for rows in book.values():
        assert set(rows) == {"lateral-x", "vertical-y", "yaw"}
        for r in rows.values():
            assert len(r["losses"]) == 3
            assert all(isinstance(v, float) and math.isfinite(v) for v in r["losses"])
            assert r["argmin_delta"] in (-0.02, 0.0, 0.02)


def test_prep_own_data_writes_the_jax_yaml(tmp_path, monkeypatch):
    from nice_slam_torch.tools import prep_own_data as tprep
    from nice_slam_torch.utils.meshlib import write_ply
    from nice_slam_tpu.tools import prep_own_data as jprep

    scene = tmp_path / "myscan"
    (scene / "scene").mkdir(parents=True)
    intr = {"width": 640, "height": 480,
            "intrinsic_matrix": [600.0, 0, 0, 0, 601.0, 0, 319.5, 239.5, 1.0]}
    (scene / "intrinsic.json").write_text(json.dumps(intr))
    rng = np.random.default_rng(0)
    verts = rng.uniform(-3, 4, size=(50, 3)).astype(np.float32)
    tris = rng.integers(0, 50, size=(20, 3))
    write_ply(str(scene / "scene" / "integrated.ply"), verts, tris)

    monkeypatch.setattr(sys, "argv", ["prep", "--ouput_config", str(tmp_path / "j.yaml"),
                                      "--scene_folder", str(scene)])
    jprep.main()
    cfg = tprep.main(["--output_config", str(tmp_path / "t.yaml"),
                      "--scene_folder", str(scene)])
    assert (tmp_path / "t.yaml").read_text() == (tmp_path / "j.yaml").read_text()
    assert cfg == yaml.safe_load((tmp_path / "t.yaml").read_text())
    np.testing.assert_allclose(np.asarray(cfg["mapping"]["bound"])[:, 0],
                               verts.min(axis=0) - 1.0, rtol=1e-6)


def test_get_model_is_build_scene():
    from nice_slam_torch import config
    from nice_slam_torch.models.registry import get_model
    from nice_slam_torch.models.scene import build_scene
    from nice_slam_torch.slam.optim import tree_leaves

    cfg = config.load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                             os.path.join(ROOT, "configs", "nice_slam.yaml"))
    for nice in (True, False):
        spec_a, state_a = config.get_model(cfg, nice=nice, device="cpu")
        spec_b, state_b = build_scene(cfg, nice=nice, device="cpu")
        spec_c, state_c = get_model(cfg, nice=nice, seed=0, device="cpu")
        assert spec_a == spec_b == spec_c
        for s in (state_a, state_c):
            la, lb = tree_leaves(s.decoders), tree_leaves(state_b.decoders)
            assert len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))
            assert sorted(s.grids) == sorted(state_b.grids)
            assert all(torch.equal(s.grids[k], state_b.grids[k]) for k in s.grids)
