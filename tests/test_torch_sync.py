"""The port's loose and free schedules on the CPU: the tracker, the mapper
and the coarse mapper as concurrent threads (no CUDA streams here; the
card runs them in ``chip_smoke.py``'s threaded phases).

Mirrors the JAX package's threaded tests (``test_sync_hardening.py``,
``test_threaded_failures.py``): the loose lag bound under a slow mapper,
loose ATE against strict, the coarse-grid merge under concurrent real
mapping calls with no lost update (bit for bit), free mode, failures that
surface as ``RuntimeError``, resume, iMAP*, the CLI; and the warm-up's event
order against the JAX package's.  Every run joins with a timeout, so a
deadlock fails its test instead of hanging the suite.  The thread-safety
repairs under the schedule are held here too: exact launch counts from
many threads, one kernel build for threads that load it together, and the
keyframe snapshot.
"""

import argparse
import os
import shutil
import sys
import threading
import time

import numpy as np
import pytest
import torch

from nice_slam_torch.config import load_config
from nice_slam_torch.ops import interp, kernels
from nice_slam_torch.slam.keyframes import KeyframeStore
from nice_slam_torch.slam.slam import NiceSLAM
from nice_slam_torch.tools.eval_ate import ate_rmse

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARGS = argparse.Namespace(nice=True, input_folder=None, output=None)
RUN_TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tier-1 run puts several workers on few cores, and torch's
    thread pool in each would oversubscribe them, so this module's runs use
    one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cfg(out, n_frames, sync_method, coarse=True, base="nice_slam.yaml"):
    """The JAX threaded tests' slow-orbit box, cut to 30x40 for the CPU."""
    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", base))
    cfg["sync_method"] = sync_method
    cfg["coarse"] = coarse
    cfg["verbose"] = False
    cfg["meshing"] = None
    cfg["data"].update({"n_frames": n_frames, "output": str(out),
                        "orbit_radians": 0.15})
    cfg["cam"].update({"H": 30, "W": 40, "fx": 30.0, "fy": 30.0, "cx": 19.5,
                       "cy": 14.5})
    cfg["tracking"].update({"pixels": 64, "iters": 6, "ignore_edge_W": 2,
                            "ignore_edge_H": 2})
    cfg["mapping"].update({"pixels": 100, "iters_first": 30, "iters": 8,
                           "every_frame": 4, "keyframe_every": 4,
                           "mesh_freq": 10 ** 6, "ckpt_freq": 10 ** 6})
    cfg["rendering"].update({"N_samples": 8, "N_surface": 4})
    for k in ("coarse", "middle_fine"):
        cfg["pretrained_decoders"][k] = os.path.join(
            ROOT, cfg["pretrained_decoders"][k])
    return cfg


def run_bounded(slam, timeout=RUN_TIMEOUT_S):
    """``slam.run()`` on a helper thread joined with a timeout; re-raises
    what the run raised."""
    raised = []

    def target():
        try:
            slam.run()
        except BaseException as e:  # noqa: BLE001 -- handed to the test
            raised.append(e)

    th = threading.Thread(target=target, daemon=True)
    th.start()
    th.join(timeout)
    if th.is_alive():
        abort = getattr(slam, "_abort", None)
        if abort is not None:
            abort.set()  # release the poll loops
        pytest.fail(f"run() did not finish within {timeout} s")
    if raised:
        raise raised[0]
    return slam


def ate(slam):
    return ate_rmse(slam.estimate_c2w_list.numpy(), slam.gt_c2w_list)


@pytest.fixture(scope="module")
def strict_run(tmp_path_factory):
    """8 frames of the strict loop, checkpointed at frame 4 and the last."""
    cfg = small_cfg(tmp_path_factory.mktemp("strict"), 8, "strict")
    cfg["mapping"]["ckpt_freq"] = 4
    return run_bounded(NiceSLAM(cfg, ARGS, device="cpu"))


def test_loose_bounded_lag_with_slow_mapper(tmp_path):
    """The tracker stays within every + every // 2 frames of the last
    mapped frame when the mapper is much slower than tracking."""
    n = 10
    cfg = small_cfg(tmp_path, n, "loose", coarse=False)
    slam = NiceSLAM(cfg, ARGS, device="cpu")
    inner_map = slam.mapper.optimize_map

    def slow_map(*a, **k):
        time.sleep(0.4)
        return inner_map(*a, **k)

    slam.mapper.optimize_map = slow_map
    lags = []
    inner_track = slam.track_one

    def recording_track(idx, *a, **k):
        lags.append((idx, slam.mapping_idx))
        return inner_track(idx, *a, **k)

    slam.track_one = recording_track
    run_bounded(slam)
    every = cfg["mapping"]["every_frame"]
    assert [i for i, _ in lags] == list(range(1, n))
    worst = max(idx - mapped for idx, mapped in lags)
    assert worst <= every + every // 2, lags
    assert torch.isfinite(slam.estimate_c2w_list).all()
    assert slam.mapping_idx == n - 1 and slam.idx == n - 1


def test_loose_ate_comparable_to_strict(tmp_path, strict_run):
    n = strict_run.n_img
    slam = run_bounded(NiceSLAM(small_cfg(tmp_path, n, "loose"), ARGS,
                                device="cpu"))
    ate_s, ate_l = ate(strict_run), ate(slam)
    assert ate_s < 0.1, f"strict ATE regressed: {ate_s}"
    assert ate_l < max(3 * ate_s, 0.12), f"loose ATE {ate_l} vs strict {ate_s}"
    assert slam.timings["tracked_frames"] == n - 1
    assert slam.timings["coarse_mapping_events"] >= 2


def test_coarse_merge_no_lost_updates(tmp_path):
    """Concurrent real map_one calls of the main and the coarse mapper:
    the state ends with the last coarse output's coarse grid and the last
    main output's other grids, bit for bit, though each mapper's input
    holds a stale copy of the other's grid."""
    cfg = small_cfg(tmp_path, 4, "strict")
    cfg["mapping"]["iters"] = 4
    slam = NiceSLAM(cfg, ARGS, device="cpu")
    frames = []
    for i in (0, 1):
        _, c, d, p = slam.frame_reader[i]
        frames.append((torch.as_tensor(c), torch.as_tensor(d), p))
        slam.estimate_c2w_list[i] = torch.as_tensor(p)
        slam.gt_c2w_list[i] = p
    c0, d0, p0 = frames[0]
    slam.map_one(0, c0, d0, p0, init=True)
    slam.map_one(0, c0, d0, p0, init=True, coarse=True)

    outputs = {False: [], True: []}
    for coarse, mapper in ((False, slam.mapper), (True, slam.coarse_mapper)):
        def recorded(*a, _inner=mapper.optimize_map, _key=coarse, **k):
            out = _inner(*a, **k)
            outputs[_key].append(out[0])
            return out

        mapper.optimize_map = recorded
    coarse_after_init = slam.state.grids["grid_coarse"].clone()
    rounds, errors = 3, []
    barrier = threading.Barrier(2)
    c1, d1, p1 = frames[1]

    def mapping(coarse):
        try:
            for _ in range(rounds):
                barrier.wait(timeout=60)
                slam.map_one(1, c1, d1, p1, init=False, coarse=coarse)
        except Exception as e:  # noqa: BLE001 -- asserted below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the threads finely
    try:
        threads = [threading.Thread(target=mapping, args=(c,), daemon=True)
                   for c in (False, True)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(RUN_TIMEOUT_S)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads), "mapping threads hung"
    assert not errors, errors
    assert len(outputs[False]) == len(outputs[True]) == rounds
    final = slam.state.grids
    assert torch.equal(final["grid_coarse"],
                       outputs[True][-1].grids["grid_coarse"])
    assert not torch.equal(final["grid_coarse"], coarse_after_init)
    for g in ("grid_middle", "grid_fine", "grid_color"):
        assert torch.equal(final[g], outputs[False][-1].grids[g]), g


def test_free_mode_completes_and_tracks(tmp_path):
    n = 8
    slam = run_bounded(NiceSLAM(small_cfg(tmp_path, n, "free"), ARGS,
                                device="cpu"))
    assert torch.isfinite(slam.estimate_c2w_list).all()
    assert slam.mapping_idx == n - 1, "final frame was never mapped"
    assert slam.timings["tracked_frames"] == n - 1
    assert ate(slam) < 0.3


def test_ba_pose_writes_survive_the_tracker(tmp_path):
    """Under loose with BA, every pose the mapper refines is the one the
    run ends with, though the tracker writes the pose list concurrently."""
    n = 10
    cfg = small_cfg(tmp_path, n, "loose", coarse=False)
    cfg["mapping"].update({"BA": True, "every_frame": 2, "keyframe_every": 1,
                           "iters": 6})
    slam = NiceSLAM(cfg, ARGS, device="cpu")
    refined = {}
    inner = slam.mapper.optimize_map

    def recorded(*a, **k):
        out = inner(*a, **k)
        if out[1] is not None:
            refined[k["idx"]] = out[1].clone()
        return out

    slam.mapper.optimize_map = recorded
    run_bounded(slam)
    assert len(refined) >= 2, sorted(refined)
    for idx, pose in refined.items():
        assert torch.equal(slam.estimate_c2w_list[idx], pose), idx
    assert torch.isfinite(slam.estimate_c2w_list).all()


@pytest.mark.parametrize("where", ["mapper", "tracker"])
def test_thread_failure_surfaces(tmp_path, where):
    """A failing thread raises from run() instead of hanging the others;
    the warm-up's calls go through, the threads' first call fails."""
    slam = NiceSLAM(small_cfg(tmp_path, 8, "loose"), ARGS, device="cpu")
    name = "map_one" if where == "mapper" else "track_one"
    inner = getattr(slam, name)
    warm = {"map_one": 4, "track_one": 2}[name]  # main + coarse at 0 and 2
    calls = []

    def failing(*a, **k):
        calls.append(a[0])
        if len(calls) > warm:
            raise ValueError(f"injected {where} fault")
        return inner(*a, **k)

    setattr(slam, name, failing)
    with pytest.raises(RuntimeError, match="SLAM thread failed"):
        run_bounded(slam)


def test_warmup_failure_surfaces(tmp_path):
    slam = NiceSLAM(small_cfg(tmp_path, 6, "loose"), ARGS, device="cpu")

    def broken(*a, **k):
        raise ValueError("injected mapper fault")

    slam.map_one = broken
    with pytest.raises(RuntimeError, match="SLAM thread failed"):
        run_bounded(slam)


def test_strict_checkpoint_resumes_under_loose(tmp_path, strict_run):
    """A strict run's mid-sequence checkpoint (frame 4) resumes under loose
    and finishes the sequence."""
    out = tmp_path / "resumed"
    shutil.copytree(os.path.join(strict_run.output, "ckpts"), out / "ckpts")
    os.remove(out / "ckpts" / "00007.tar")
    cfg = small_cfg(out, strict_run.n_img, "loose")
    cfg["mapping"]["ckpt_freq"] = 4
    slam = NiceSLAM(cfg, ARGS, device="cpu")
    assert slam.resume() == 5
    restored = slam.estimate_c2w_list[4].clone()
    events = []
    inner = slam.map_one

    def recorded(idx, *a, **k):
        events.append((idx, k.get("init", a[3] if len(a) > 3 else None)))
        return inner(idx, *a, **k)

    slam.map_one = recorded
    run_bounded(slam)
    assert events[0] == (4, True)  # the warm-up maps the checkpoint's frame
    assert torch.equal(slam.estimate_c2w_list[:4], strict_run.estimate_c2w_list[:4])
    assert slam.timings["tracked_frames"] == 3  # frames 5, 6, 7
    assert slam.mapping_idx == 7
    assert torch.isfinite(slam.estimate_c2w_list).all()
    assert os.path.exists(out / "ckpts" / "00007.tar")
    assert ate(slam) < 0.12
    # the resumed pose of frame 4 is kept, not re-anchored at ground truth
    assert not torch.equal(restored, torch.as_tensor(slam.gt_c2w_list[4]))


def test_imap_loose_completes(tmp_path):
    n = 6
    cfg = small_cfg(tmp_path, n, "loose", base="imap.yaml")
    cfg["rendering"].update({"N_samples": 8, "N_importance": 4})
    cfg["mapping"].update({"pixels": 64, "iters_first": 30, "iters": 6})
    slam = NiceSLAM(cfg, argparse.Namespace(nice=False, input_folder=None,
                                            output=None), device="cpu")
    calls = []
    inner = slam.mapper.optimize_map

    def counted(*a, **k):
        out = inner(*a, **k)
        calls.append(int(out[2].shape[0]))
        return out

    slam.mapper.optimize_map = counted
    run_bounded(slam)
    assert slam.coarse_mapper is None and "coarse_mapper" not in slam.streams
    assert slam.mapping_idx == n - 1
    assert torch.isfinite(slam.estimate_c2w_list).all()
    # first mapping 30 in one call; later events 3 calls of 2, the final
    # colour refinement 5 calls of 6
    assert calls[0] == 30 and calls[-5:] == [6] * 5
    assert set(calls[1:-5]) == {2} and len(calls[1:-5]) % 3 == 0


def test_cli_runs_loose_yaml(tmp_path):
    """``nice_slam_torch.run`` on a YAML inheriting box.yaml with
    ``sync_method: loose``."""
    from nice_slam_torch.run import main

    yaml = tmp_path / "loose.yaml"
    yaml.write_text(f"""inherit_from: {ROOT}/configs/Synthetic/box.yaml
sync_method: loose
verbose: false
cam: {{H: 30, W: 40, fx: 30.0, fy: 30.0, cx: 19.5, cy: 14.5}}
tracking: {{pixels: 64, iters: 4, ignore_edge_W: 2, ignore_edge_H: 2}}
mapping: {{pixels: 64, iters_first: 20, iters: 4, every_frame: 2,
          keyframe_every: 2, mesh_freq: 1000000}}
rendering: {{N_samples: 8, N_surface: 4}}
meshing: {{resolution: 16, eval_rec: false}}
data: {{n_frames: 5, orbit_radians: 0.1, output: {tmp_path}/out}}
""")
    cwd = os.getcwd()
    os.chdir(ROOT)  # box.yaml names its pretrained decoders from the root
    try:
        slam = main([str(yaml), "--device", "cpu"])
    finally:
        os.chdir(cwd)
    assert slam.sync_method == "loose" and slam.mapping_idx == 4
    for f in ("ckpts/00004.tar", "mesh/final_mesh.ply", "poses.npz",
              "timings.json"):
        assert os.path.exists(tmp_path / "out" / f), f


@pytest.mark.parametrize("nice", [True, False], ids=["nice", "imap"])
def test_warmup_events_match_jax(tmp_path, nice):
    """From the same initial scene and config under loose, the warm-up
    runs the same events in the same order in both packages: map 0
    (init), coarse 0, track 1, track 2, map 2, coarse 2 (iMAP*, which has
    no coarse mapper: map 0, track 1, track 2, map 2).  (The threads'
    events after it interleave nondeterministically, and there is no RNG
    parity, so only the order is compared.)"""
    import jax

    from nice_slam_torch.convert import scene_from_jax
    from nice_slam_tpu.config import load_config as jload_config
    from nice_slam_tpu.slam.slam import NiceSLAM as JSLAM

    args = argparse.Namespace(nice=nice, input_folder=None, output=None)

    def cfg_for(load, out):
        cfg = load(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                   os.path.join(ROOT, "configs",
                                "nice_slam.yaml" if nice else "imap.yaml"))
        cfg.update(sync_method="loose", coarse=nice, verbose=False, meshing=None)
        cfg["data"].update({"n_frames": 4, "output": str(out),
                            "orbit_radians": 0.05})
        cfg["cam"].update({"H": 30, "W": 40, "fx": 30.0, "fy": 30.0,
                           "cx": 19.5, "cy": 14.5})
        cfg["tracking"].update({"pixels": 32, "iters": 2, "ignore_edge_W": 2,
                                "ignore_edge_H": 2})
        cfg["mapping"].update({"pixels": 64, "iters_first": 4,
                               "iters": 2 if nice else 3,  # iMAP*: 3 calls of 1
                               "mesh_freq": 10 ** 6, "ckpt_freq": 10 ** 6,
                               "color_refine": False})  # one compile less
        cfg["rendering"].update({"N_samples": 8, "N_surface": 4} if nice
                                else {"N_samples": 8, "N_importance": 4})
        if nice:
            for k in ("coarse", "middle_fine"):
                cfg["pretrained_decoders"][k] = os.path.join(
                    ROOT, cfg["pretrained_decoders"][k])
        return cfg

    def record(slam):
        events = []
        inner_map, inner_track = slam.map_one, slam.track_one

        def map_one(idx, *a, **k):
            events.append(("map", idx, k.get("init"), k.get("coarse", False)))
            return inner_map(idx, *a, **k)

        def track_one(idx, *a, **k):
            events.append(("track", idx))
            return inner_track(idx, *a, **k)

        slam.map_one, slam.track_one = map_one, track_one
        return events

    js = JSLAM(cfg_for(jload_config, tmp_path / "jax"), args)
    ts = NiceSLAM(cfg_for(load_config, tmp_path / "torch"), args, device="cpu")
    ts.state = scene_from_jax(jax.tree.map(np.asarray, js.state), device="cpu")
    jev, tev = record(js), record(ts)
    run_bounded(js)
    run_bounded(ts)
    warm = [("map", 0, True, False), ("map", 0, True, True), ("track", 1),
            ("track", 2), ("map", 2, False, False), ("map", 2, False, True)]
    if not nice:
        warm = [ev for ev in warm if ev[0] == "track" or not ev[3]]
    k = len(warm)
    assert jev[:k] == tev[:k] == warm
    # then the threads: frame 3 tracked, and the last frame mapped by each
    # mapper (each thread always maps it; the strict loop skips the
    # coarse one there)
    for ev in (jev, tev):
        assert ev[k:].count(("track", 3)) == 1
        assert ev[k:].count(("map", 3, False, False)) == 1
        assert ev[k:].count(("map", 3, False, True)) == int(nice)
    assert js.mapping_idx == ts.mapping_idx == 3


def test_launch_counts_are_exact_across_threads():
    """The kernels' launch counts are read-modify-writes shared by the
    tracker's and mappers' threads: a lost update would show here."""
    interp.reset_launch_counts()
    n_threads, per = 8, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda s=s: [interp._count("trilinear_fwd", s)
                                for _ in range(per)], daemon=True)
            for s in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert interp.launch_counts["trilinear_fwd"] == n_threads * per
    assert all(interp.launches_by_stream[("trilinear_fwd", s)] == per
               for s in range(n_threads))
    interp.reset_launch_counts()
    assert interp.launches_by_stream == {}


def test_library_loads_once_for_concurrent_callers(monkeypatch):
    """Threads that first ask for a kernel library together build it once
    and share one handle."""
    path = kernels.build(["mesh_kernels"])["mesh_kernels"]
    builds = []

    def slow_build(names):
        builds.append(list(names))
        time.sleep(0.05)
        return {name: path for name in names}

    monkeypatch.setattr(kernels, "_loaded", {})
    monkeypatch.setattr(kernels, "build", slow_build)
    got = []
    threads = [threading.Thread(
        target=lambda: got.append(kernels.library("mesh_kernels")), daemon=True)
        for _ in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    assert builds == [["mesh_kernels"]]
    assert len(got) == 6 and all(lib is got[0] for lib in got)


def test_keyframe_snapshot_is_isolated_from_later_writes():
    """A snapshot keeps the count and the poses it was taken with, while
    the store grows past its capacity and has a pose rewritten."""
    store = KeyframeStore(2, 3, 4, "cpu")
    img, depth = np.ones((3, 4, 3), np.float32), np.ones((3, 4), np.float32)
    pose = np.eye(4, dtype=np.float32)
    for i in range(2):
        store.add(i, img * i, depth * i, pose * (i + 1), pose)
    snap = store.snapshot()
    est_before = snap.arrays.est_c2w.clone()
    store.set_est_c2w(1, pose * 7)
    store.add(5, img, depth, pose, pose)  # grows the arrays
    assert len(snap) == 2 and snap.frame_ids == [0, 1]
    assert torch.equal(snap.arrays.est_c2w, est_before)
    assert len(store) == 3 and store.frame_ids == [0, 1, 5]
    assert torch.equal(store.arrays.est_c2w[1], torch.as_tensor(pose * 7))
    assert torch.equal(store.arrays.colors[:2], snap.arrays.colors[:2])
