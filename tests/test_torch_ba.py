"""Local bundle adjustment (BA), the NICE default (``configs/nice_slam.yaml``
sets ``BA: true``), in the port against the JAX package.

(a) The strict loop with BA on a tiny box (60x80; a keyframe and a mapping
event every frame over a window of 3, 7 frames, so BA engages at frames 5
and 6, when the store holds five keyframes) run by the JAX package and by
the port from the same initial scene state, the same pre-drawn tracking
pixels, the same windows ('global' selection: numpy's generator with the
same seed in both) and each mapping call's pixels as the JAX call draws
them.  Held as ``tests/test_torch_slice.py`` holds the BA-off loop:
tracked positions (and the keyframe store's BA-refined poses) within 1.5 cm
of each other, the port's ATE within 1 cm of the JAX run's, every mapping
event's mean loss within a factor 1.5 (the first event within 10 %); and
BA engages in the same calls in both.  Rotation entries within 0.05, not
``test_torch_slice.py``'s 0.03 over 3 tracked frames: the two loops'
rounding compounds through 6 tracked frames here, and they read 0.032
apart at the last one.  The orbit is slow (0.01 rad over the run): tracking
at this size random-walks ~0.7 cm a frame whatever the motion, and at
0.05 rad (0.8 cm a frame, the tracker's 10 x lr reach) it lags, which
drove two port runs on different mapping draws 2-5 cm apart by the last
frame, and the two packages on the same draws 2.3 cm apart.

(b) One ``optimize_map`` call (middle 2, fine 2, color 1 iterations) fed
the JAX call's pixel draws: the camera group takes a step in every stage,
at lr 0 before the color stage, so Adam's camera moments enter the color
stage's first camera step.  The poses agree with JAX's within 1e-6, and a
port whose camera group sat out the middle and fine stages would miss by
more than 1e-5 (checked here by running that variant).

(c) The port's loop with the coarse mapper, the default window (5) and
the final refinement: BA never engages in a coarse call, nor before the
fifth keyframe, and each BA call writes back every non-oldest valid window
keyframe's pose, leaves the oldest one equal bit for bit, and leaves the
current frame at its refined pose.
"""

import argparse
import functools
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nice_slam_tpu.config import load_config
from nice_slam_tpu.models import pretrain as jpre
from nice_slam_tpu.models import scene as jscene
from nice_slam_tpu.ops.render import RenderConfig as JRender
from nice_slam_tpu.slam import mapper as jm
from nice_slam_tpu.slam.slam import NiceSLAM as JSLAM
from nice_slam_tpu.tools.eval_ate import align as jalign
from nice_slam_tpu.utils.datasets import Synthetic
from nice_slam_torch.convert import scene_from_jax
from nice_slam_torch.models import scene as tscene
from nice_slam_torch.ops.render import RenderConfig as TRender
from nice_slam_torch.slam import mapper as tm
from nice_slam_torch.slam.slam import NiceSLAM as TSLAM
from nice_slam_torch.tools.eval_ate import ate_rmse

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARGS = argparse.Namespace(nice=True, input_folder=None, output=None)
N_FRAMES = 7
H, W = 60, 80


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several test workers share few cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(out, coarse=False):
    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "nice_slam.yaml"))
    cfg["coarse"] = coarse
    cfg["verbose"] = False
    cfg["meshing"] = None  # no meshes: the tests compare the loops
    cfg["data"].update({"n_frames": N_FRAMES, "output": str(out),
                        "orbit_radians": 0.01})
    cfg["cam"].update({"H": H, "W": W, "fx": 60.0, "fy": 60.0, "cx": 39.5,
                       "cy": 29.5})
    cfg["tracking"].update({"pixels": 200, "iters": 10, "ignore_edge_W": 4,
                            "ignore_edge_H": 4})
    cfg["mapping"].update({"pixels": 150, "iters_first": 150, "iters": 10,
                           "BA": True, "every_frame": 1, "keyframe_every": 1,
                           "mapping_window_size": 3, "color_refine": False})
    cfg["rendering"].update({"N_samples": 12, "N_surface": 6})
    for k in ("coarse", "middle_fine"):
        cfg["pretrained_decoders"][k] = os.path.join(
            ROOT, cfg["pretrained_decoders"][k])
    return cfg


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _jax_pixel_draws(key, n_iters, F, n):
    """The flat pixel indices optimize_map_jit draws: per global iteration
    i, fold_in(key, i) -> split -> split(F) -> randint over H*W."""
    def one(i):
        k_frames, _ = jax.random.split(jax.random.fold_in(key, i))
        fk = jax.random.split(k_frames, F)
        return jax.vmap(lambda k: jax.random.randint(k, (n,), 0, H * W))(fk)
    return jax.vmap(one)(jnp.arange(n_iters))


def _record(mapper, sink, n_keyframes):
    """Append (BA, keyframes in the store, losses) of each optimize_map call."""
    inner = mapper.optimize_map
    sig = inspect.signature(inner)

    def wrapped(*a, **k):
        b = sig.bind(*a, **k).arguments
        n_kf = n_keyframes(b["keyframes"])
        out = inner(*a, **k)
        losses = out[2].cpu() if hasattr(out[2], "cpu") else out[2]
        sink.append((bool(b["BA"]), n_kf, np.asarray(losses)))
        return out

    mapper.optimize_map = wrapped


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    """The JAX loop, then the port's on the same draws: the window's
    keyframes ('global' selection: both mappers draw them from
    numpy's generator with the same seed) and each mapping call's pixels,
    which the JAX call draws from its key and the port's call is given."""
    mp = pytest.MonkeyPatch()
    draws = []
    inner_jit = jm.optimize_map_jit
    jit_sig = inspect.signature(inner_jit)

    def recorded_jit(*a, **k):
        b = jit_sig.bind(*a, **k).arguments
        assert b["adam_in"] is None  # one jit call per optimize_map call
        n_iters = sum(n for _, n in b["stage_plan"])
        draws.append(np.asarray(_jax_pixel_draws(b["key"], n_iters,
                                                 b["colors"].shape[0],
                                                 b["pixs_per_image"])))
        return inner_jit(*a, **k)

    inner_core = tm.optimize_map_core

    def given_core(*a, **k):
        k["pix_idx"] = torch.tensor(draws.pop(0))
        return inner_core(*a, **k)

    try:
        mp.setattr(jm, "optimize_map_jit", recorded_jit)
        mp.setattr(tm, "optimize_map_core", given_core)
        cfg = tiny_cfg(tmp_path_factory.mktemp("jax"))
        cfg["mapping"]["keyframe_selection_method"] = "global"
        js = JSLAM(cfg, ARGS)
        init = jax.tree.map(np.asarray, js.state)
        jcalls, tcalls = [], []
        _record(js.mapper, jcalls, lambda kf: len(kf.frame_ids))
        js.run()
        cfg = tiny_cfg(tmp_path_factory.mktemp("torch"))
        cfg["mapping"]["keyframe_selection_method"] = "global"
        ts = TSLAM(cfg, ARGS, device="cpu")
        ts.state = scene_from_jax(init, device="cpu")
        _record(ts.mapper, tcalls, len)
        ts.run()
    finally:
        mp.undo()
    assert not draws
    return js, ts, jcalls, tcalls


def test_ba_engages_in_the_same_calls(loops):
    js, ts, jcalls, tcalls = loops
    # events at frames 0-6, the last one the 5-call final refinement; five
    # keyframes (frames 0-4) first exist at frame 5's event
    want = [False] * 5 + [True] * 2
    assert [c[0] for c in tcalls] == [c[0] for c in jcalls] == want
    assert [c[1] for c in tcalls] == [c[1] for c in jcalls]
    assert ts.keyframes.frame_ids == js.keyframes.frame_ids == list(range(N_FRAMES))
    for k in ("tracked_frames", "mapping_events"):
        assert ts.timings[k] == js.timings[k], k


def test_ba_loop_poses_agree(loops):
    js, ts, _, _ = loops
    je = js.estimate_c2w_list
    te = ts.estimate_c2w_list.cpu().numpy()
    np.testing.assert_array_equal(te[0], je[0])
    assert np.all(np.linalg.norm(je[:, :3, 3] - te[:, :3, 3], axis=1) < 0.015)
    assert np.abs(je[:, :3, :3] - te[:, :3, :3]).max() < 0.05
    gt = js.gt_c2w_list
    _, _, err = jalign(je[:, :3, 3].T.astype(np.float64),
                       gt[:, :3, 3].T.astype(np.float64))
    assert ate_rmse(te, gt) <= float(np.sqrt(np.mean(err ** 2))) + 0.01
    # the keyframe store's poses, refined by BA in both
    jk = np.asarray(js.keyframes.arrays.est_c2w)[:N_FRAMES]
    tk = ts.keyframes.arrays.est_c2w[:N_FRAMES].numpy()
    assert np.all(np.linalg.norm(jk[:, :3, 3] - tk[:, :3, 3], axis=1) < 0.015)


def test_ba_loop_mapping_losses_agree(loops):
    _, _, jcalls, tcalls = loops
    np.testing.assert_allclose(tcalls[0][2].mean(), jcalls[0][2].mean(), rtol=0.1)
    for (_, _, a), (_, _, b) in zip(tcalls[1:], jcalls[1:]):
        assert 1 / 1.5 < a.mean() / b.mean() < 1.5


# ---------------------------------------------------------------------------
# (b) the camera group in every stage
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def window():
    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "nice_slam.yaml"))
    cfg["coarse"] = False
    cfg["cam"].update({"H": H, "W": W, "fx": 60.0, "fy": 60.0, "cx": 39.5, "cy": 29.5})
    cfg["rendering"].update({"N_samples": 12, "N_surface": 6})
    cfg["data"]["n_frames"] = 10
    for k in ("coarse", "middle_fine"):
        cfg["pretrained_decoders"][k] = os.path.join(ROOT, cfg["pretrained_decoders"][k])
    jspec, jstate = jscene.build_scene(cfg, nice=True, seed=1)
    jstate = jpre.load_pretrain(cfg, jspec, jstate, verbose=False)
    tspec, _ = tscene.build_scene(cfg, nice=True, device="cpu")
    tstate = scene_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    frames = [Synthetic(cfg)[i] for i in (0, 2, 4)]
    c2w = np.stack([f[3] for f in frames])
    # the window's poses off the truth, so the camera gradients are large
    c2w[1:, :3, 3] += np.array([[0.02, -0.01, 0.015], [-0.015, 0.02, 0.01]], np.float32)
    return dict(cfg=cfg, jspec=jspec, jstate=jstate, tspec=tspec, tstate=tstate,
                colors=np.stack([f[1] for f in frames]),
                depths=np.stack([f[2] for f in frames]), c2w=c2w)


def _port_call(s, cams, opt_mask, plan, n, pix):
    cfg = s["cfg"]
    tmc = tm.MapperConfig.from_cfg(cfg, cfg["cam"], True)
    F = cams.shape[0]
    _, tc, _ = tm.optimize_map_core(
        s["tspec"], s["tstate"], torch.tensor(s["colors"]), torch.tensor(s["depths"]),
        torch.tensor(s["c2w"]), torch.tensor(cams), torch.tensor(opt_mask),
        torch.ones(F, dtype=torch.bool), 1.0, tmc, TRender.from_cfg(cfg), plan, True,
        n, pix_idx=torch.tensor(pix))
    return tc.numpy()


def test_camera_group_steps_in_every_stage(window, monkeypatch):
    s = window
    cfg = s["cfg"]
    jmc = jm.MapperConfig.from_cfg(cfg, cfg["cam"], True)
    cams = np.asarray(jax.vmap(jm.tensor_from_pose)(jnp.asarray(s["c2w"])))
    opt_mask = np.array([0, 1, 1], np.float32)
    plan = (("middle", 2), ("fine", 2), ("color", 1))
    n_iters, F, n = 5, 3, 20
    key = jax.random.PRNGKey(11)
    _, jc, _, _ = jm.optimize_map_jit(
        s["jspec"], s["jstate"], jnp.asarray(s["colors"]), jnp.asarray(s["depths"]),
        jnp.asarray(s["c2w"]), jnp.asarray(cams), jnp.asarray(opt_mask),
        jnp.ones(F, bool), None, jnp.asarray(1.0, jnp.float32), key, None, jmc,
        JRender.from_cfg(cfg), plan, True, n)
    jc = np.asarray(jc)
    pix = np.asarray(_jax_pixel_draws(key, n_iters, F, n))

    got = _port_call(s, cams, opt_mask, plan, n, pix)
    np.testing.assert_array_equal(got[0], cams[0])  # the oldest stays fixed
    assert np.abs(got[1:] - cams[1:]).max() > 1e-4  # the color step moved them
    np.testing.assert_allclose(got, jc, atol=1e-6, rtol=0)

    # the same call with the camera group active in the color stage only
    inner = tm._active_groups

    def color_only(stage, groups):
        active = inner(stage, groups)
        if "cams" in active and stage != "color":
            active["cams"] = False
        return active

    monkeypatch.setattr(tm, "_active_groups", color_only)
    wrong = _port_call(s, cams, opt_mask, plan, n, pix)
    assert np.abs(wrong - jc).max() > 1e-5


# ---------------------------------------------------------------------------
# (c) where BA engages, and the write-back
# ---------------------------------------------------------------------------

def test_ba_engagement_rule_and_write_back(tmp_path, monkeypatch):
    """The port's strict loop with the coarse mapper on: BA in exactly the
    main-mapper calls made with more than four keyframes in the store,
    never in a coarse call; each BA call rewrites the non-oldest valid
    window keyframes' poses, keeps the oldest bit for bit, and leaves the
    current frame at its refined pose."""
    cfg = tiny_cfg(tmp_path, coarse=True)
    # the default window and the final refinement's 5 calls (with a
    # window of twice the size)
    cfg["mapping"].update(iters=4, iters_first=20, mapping_window_size=5,
                          color_refine=True)
    cfg["tracking"]["iters"] = 3
    ts = TSLAM(cfg, ARGS, device="cpu")
    calls = []
    windows = []  # the valid keyframe positions of each overlap window
    inner_window = tm.prepare_window

    def prepare_window(*a, **k):
        out = inner_window(*a, **k)
        positions, valid = out[6], out[5][:-1]
        windows.append(sorted(set(int(p) for p, v in zip(positions, valid) if v)))
        return out

    monkeypatch.setattr(tm, "prepare_window", prepare_window)

    def watch(mapper, coarse):
        inner = mapper.optimize_map
        sig = inspect.signature(inner)

        def wrapped(*a, **k):
            b = sig.bind(*a, **k).arguments
            kf = b["keyframes"]
            n_kf = len(kf)
            before = kf.arrays.est_c2w[:n_kf].clone()
            seen = len(windows)
            written = []
            set_inner = getattr(kf, "set_est_c2w", None)
            if set_inner is not None:
                kf.set_est_c2w = lambda pos, c2w: (written.append(int(pos)),
                                                   set_inner(pos, c2w))[1]
            try:
                out = inner(*a, **k)
            finally:
                if set_inner is not None:
                    del kf.set_est_c2w
            after = kf.arrays.est_c2w[:n_kf]
            changed = sorted(i for i in range(n_kf) if not torch.equal(after[i], before[i]))
            calls.append(dict(coarse=coarse, BA=bool(b["BA"]), n_kf=n_kf,
                              written=sorted(written), changed=changed, idx=b["idx"],
                              window=windows[-1] if len(windows) > seen else None,
                              cur=None if out[1] is None else out[1].clone()))
            return out

        mapper.optimize_map = wrapped

    watch(ts.mapper, False)
    watch(ts.coarse_mapper, True)
    ts.run()
    main = [c for c in calls if not c["coarse"]]
    coarse = [c for c in calls if c["coarse"]]
    assert coarse and not any(c["BA"] for c in coarse)
    assert [c["BA"] for c in main] == [c["n_kf"] > 4 for c in main]
    assert sum(c["BA"] for c in main) == 6
    for c in main:
        if not c["BA"]:
            assert c["written"] == [] and c["changed"] == [] and c["cur"] is None
            continue
        # every valid window keyframe but the oldest is written back, once,
        # and no other keyframe's pose changes (the oldest's stays bit for bit)
        assert c["window"] is not None and c["n_kf"] - 1 in c["window"]
        assert c["written"] == c["window"][1:]
        assert c["changed"] == c["written"]
        assert c["cur"] is not None
    # the current frame's pose after a BA event is the refined one
    last = {}
    for c in main:
        if c["BA"]:
            last[c["idx"]] = c["cur"]
    for idx, pose in last.items():
        assert torch.equal(ts.estimate_c2w_list[idx], pose), idx
