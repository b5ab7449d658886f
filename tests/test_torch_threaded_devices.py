"""The port's loose and free schedules over a device list on the CPU,
against the JAX package's over its mesh: the JAX side on the conftest's 8
virtual CPU devices, the port over ``devices=[cpu] * 8``, in both
multi-device modes the strict loop has: the grids spatially sharded
(``NICE_SLAM_TPU_SPATIAL`` / ``NICE_SLAM_TORCH_SPATIAL`` = 1; K1-K3 per
slab), and ray data parallelism with the coarse mapper pinned to the
last device (each package's default over several devices).

Held here, at the 30x40 box of ``tests/test_torch_sync.py``: the warm-up's
events and the threads' first events equal to the JAX package's; a free
run over sharded grids that ends with its halo planes equal and a dense
checkpoint the JAX package loads; and the coarse merge under concurrent
real mapping calls with no lost update, bit for bit.  (No CUDA streams
here: the hand-offs' lock alone orders the threads on the CPU; the card
runs the same schedules in ``chip_smoke.py``'s ``threaded_sharded``
phase.)  Every run joins with a timeout.
"""

import argparse
import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from nice_slam_torch.config import load_config
from nice_slam_torch.convert import scene_from_jax
from nice_slam_torch.parallel import grid_sharding as tgs
from nice_slam_torch.slam.optim import tree_leaves
from nice_slam_torch.slam.slam import NiceSLAM

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARGS = argparse.Namespace(nice=True, input_folder=None, output=None)
CPU = torch.device("cpu")
DEVICES = [CPU] * 8
RUN_TIMEOUT_S = 240
MODES = ("sharded", "ray_dp")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several workers share few cores in the tier-1 run: one torch
    thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def mode_env(request, monkeypatch):
    """Sharding forced on (``sharded``) or off (``ray_dp``) in both
    packages."""
    spatial = "1" if request.param == "sharded" else "0"
    monkeypatch.setenv("NICE_SLAM_TPU_SPATIAL", spatial)
    monkeypatch.setenv("NICE_SLAM_TORCH_SPATIAL", spatial)
    return request.param


def box_cfg(load, out, sync_method, n_frames=4):
    """The 30x40 slow-orbit box of tests/test_torch_sync.py's warm-up test
    (either package's ``load_config``)."""
    cfg = load(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
               os.path.join(ROOT, "configs", "nice_slam.yaml"))
    cfg.update(sync_method=sync_method, coarse=True, verbose=False, meshing=None)
    cfg["data"].update({"n_frames": n_frames, "output": str(out),
                        "orbit_radians": 0.05})
    cfg["cam"].update({"H": 30, "W": 40, "fx": 30.0, "fy": 30.0,
                       "cx": 19.5, "cy": 14.5})
    cfg["tracking"].update({"pixels": 32, "iters": 2, "ignore_edge_W": 2,
                            "ignore_edge_H": 2})
    cfg["mapping"].update({"pixels": 64, "iters_first": 4, "iters": 2,
                           "mesh_freq": 10 ** 6, "ckpt_freq": 10 ** 6,
                           "color_refine": False})
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


def check_engaged(slam, mode):
    """The port's system runs over DEVICES in ``mode``."""
    if mode == "sharded":
        assert slam.spatial_devices == DEVICES and slam.mapper.devices is None
        assert all(isinstance(g, tgs.ShardedGrid) and g.D == len(DEVICES)
                   for g in slam.state.grids.values())
        assert slam.coarse_mapper.device is None
    else:
        assert slam.spatial_devices is None and slam.mapper.devices == DEVICES
        assert slam.coarse_mapper.device == DEVICES[-1]


def halo_equal(slam):
    for k, sg in slam.state.grids.items():
        for lo, hi in zip(sg.slabs[:-1], sg.slabs[1:]):
            assert torch.equal(lo[-1], hi[0]), f"{k}: halo planes diverged"


def clone_grid(g):
    if isinstance(g, tgs.ShardedGrid):
        return g._replace([s.clone() for s in g.slabs])
    return g.clone()


def same_grid(a, b) -> bool:
    if isinstance(a, tgs.ShardedGrid):
        return all(torch.equal(x, y) for x, y in zip(a.slabs, b.slabs))
    return torch.equal(a, b)


@pytest.mark.parametrize("mode_env", MODES, indirect=True)
def test_loose_warmup_events_match_jax_over_devices(tmp_path, mode_env):
    """Under loose over several devices, from the same initial scene, the
    warm-up runs the same events in the same order in both packages (map
    0 init, coarse 0, track 1, track 2, map 2, coarse 2), and then the
    threads track frame 3 once and map it once with each mapper."""
    from nice_slam_tpu.config import load_config as jload_config
    from nice_slam_tpu.parallel import grid_sharding as jgs
    from nice_slam_tpu.slam.slam import NiceSLAM as JSLAM

    js = JSLAM(box_cfg(jload_config, tmp_path / "jax", "loose"), ARGS)
    if mode_env == "sharded":
        assert js.spatial_mesh is not None and js.spatial_mesh.size == len(DEVICES)
    else:
        assert js.spatial_mesh is None
        assert js.coarse_mapper.device == jax.devices()[-1]
        assert js.mapper.mesh is not None and js.mapper.mesh.size == len(DEVICES)
    ts = NiceSLAM(box_cfg(load_config, tmp_path / "torch", "loose"), ARGS,
                  devices=DEVICES)
    check_engaged(ts, mode_env)
    dense = jax.tree.map(np.asarray, jgs.dense_grids(js.state.grids))
    base = scene_from_jax({"decoders": jax.tree.map(np.asarray, js.state.decoders),
                           "grids": dense, "bound": np.asarray(js.state.bound),
                           "coarse_bound": np.asarray(js.state.coarse_bound)}, CPU)
    if mode_env == "sharded":
        base = base._replace(grids=tgs.shard_scene_grids(base.grids, DEVICES))
    ts.state = base

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

    jev, tev = record(js), record(ts)
    run_bounded(js)
    run_bounded(ts)
    warm = [("map", 0, True, False), ("map", 0, True, True), ("track", 1),
            ("track", 2), ("map", 2, False, False), ("map", 2, False, True)]
    assert jev[:6] == tev[:6] == warm
    for ev in (jev, tev):
        assert ev[6:].count(("track", 3)) == 1
        assert ev[6:].count(("map", 3, False, False)) == 1
        assert ev[6:].count(("map", 3, False, True)) == 1
    assert js.mapping_idx == ts.mapping_idx == 3
    assert torch.isfinite(ts.estimate_c2w_list).all()
    if mode_env == "sharded":
        halo_equal(ts)


def test_free_sharded_completes_and_checkpoint_loads_in_jax(tmp_path, monkeypatch):
    """free over sharded grids: every frame tracked, the last one mapped,
    the halo planes bitwise equal; the final checkpoint is dense and the
    JAX package's loader restores the run's grids, decoders and poses
    from it."""
    from nice_slam_tpu.config import load_config as jload_config
    from nice_slam_tpu.models.scene import build_scene as jbuild
    from nice_slam_tpu.utils import logger as jlog

    monkeypatch.setenv("NICE_SLAM_TORCH_SPATIAL", "1")
    n = 6
    cfg = box_cfg(load_config, tmp_path, "free", n_frames=n)
    cfg["mapping"].update({"every_frame": 2, "iters": 3})
    slam = NiceSLAM(cfg, ARGS, devices=DEVICES)
    check_engaged(slam, "sharded")
    run_bounded(slam)
    assert slam.timings["tracked_frames"] == n - 1 and slam.mapping_idx == n - 1
    assert slam.timings["mapping_events"] >= 2
    assert torch.isfinite(slam.estimate_c2w_list).all()
    assert all(isinstance(g, tgs.ShardedGrid) for g in slam.state.grids.values())
    halo_equal(slam)

    jcfg = box_cfg(jload_config, tmp_path / "jax", "free", n_frames=n)
    jspec, jstate = jbuild(jcfg, nice=True)
    path = os.path.join(str(tmp_path), "ckpts", f"{n - 1:05d}.tar")
    state, est, _, kfs, idx = jlog.load_checkpoint(path, jspec, jstate)
    assert idx == n - 1 and kfs == slam.keyframes.frame_ids
    np.testing.assert_array_equal(est, slam.estimate_c2w_list.numpy())
    restored = scene_from_jax(jax.tree.map(np.asarray, state), CPU)
    for k, sg in slam.state.grids.items():
        assert torch.equal(restored.grids[k], tgs.unshard_grid(sg)), k
    for a, b in zip(tree_leaves(restored.decoders), tree_leaves(slam.state.decoders)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode_env", MODES, indirect=True)
def test_coarse_merge_no_lost_updates_over_devices(tmp_path, mode_env):
    """Concurrent real map_one calls of the main and the coarse mapper over
    the devices: the state ends with the last coarse output's coarse grid
    and the last main output's other grids, bit for bit, though each
    mapper's input holds a stale copy of the other's grid."""
    cfg = box_cfg(load_config, tmp_path, "strict")
    cfg["mapping"]["iters"] = 4
    slam = NiceSLAM(cfg, ARGS, devices=DEVICES)
    check_engaged(slam, mode_env)
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
    coarse_after_init = clone_grid(slam.state.grids["grid_coarse"])
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
    assert same_grid(final["grid_coarse"], outputs[True][-1].grids["grid_coarse"])
    assert not same_grid(final["grid_coarse"], coarse_after_init)
    for g in ("grid_middle", "grid_fine", "grid_color"):
        assert same_grid(final[g], outputs[False][-1].grids[g]), g
    if mode_env == "sharded":
        halo_equal(slam)
