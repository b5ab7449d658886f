"""Where a tracking frame's and a mapping call's time goes on the card.

    python -m nice_slam_torch.tools.profile_step [--out DIR] [--ba]
        [--imap | --schedules [strict,loose,free]] [--devices LIST] [--items LIST]
        [--reps N]

Runs the Replica-scale synthetic workload (``tools/workloads.py``) for
17 frames of the strict loop, so the map and a full 5-frame keyframe
window exist,
then traces under ``torch.profiler`` one tracked frame (10 iterations),
one main-mapper call (60 iterations), one coarse-mapper call, one mesh at
resolution 256 and at 128 (``Mesher.get_mesh``) and one full-frame
render (``render_img``, 680x1200).  For each
it prints one JSON line: wall time of an unprofiled run (host clock,
ending in a synchronize), the device's busy time in a profiled run (union
of its kernel, copy and memset intervals), the idle share (1 - busy /
wall), the number of device operations, the operations taking the
most device time, (``kernels``) the device ms and launch count of
each hand-written kernel, the trilinear K1-K3, the decoder stage's K4-K6,
the integrator's K7-K8, the Adam step's K9 and the frustum mask's K10,
whether or not it ranks in ``top``, (``gemm_ms``) the device time of the
cuBLAS GEMMs, and (``items``) the device ms and calls of the integrator's,
the Adam step's and the frustum mask's entry points, each traced as a
``record_function`` range (the forward's range: the integrator's
backward runs in autograd's), which also reads a port older than K7-K10,
whose plain chains they were.  Needs a CUDA device.

``--ba`` adds a row for the same main-mapper call with bundle adjustment
(``mapping_call_ba``: the window poses but the oldest trained with the map,
so K3 runs in every iteration; each run of it writes the refined window
poses back into the keyframe store, as a BA call does), beside the BA-off
``mapping_call``.  With ``--devices`` (and no ``--schedules``) the system
runs over that device list under the environment's multi-device knobs:
``NICE_SLAM_TORCH_SPATIAL=1`` shards the grids into x-slabs, so the calls
are the sharded ones; otherwise the main mapper's rays are split over the
devices (ray data parallelism).  Each row then names the devices and
whether the grids are sharded.

``--items`` keeps only the rows it names (e.g. ``tracking_frame``);
``--reps N`` times each row's unprofiled run N times, ``wall_ms`` their
median and ``wall_ms_runs`` each.

``--imap`` profiles the iMAP* model instead (``replica_imap_cfg``, 17
frames, the first mapping 300 iterations): one tracked frame (50
iterations x 5000 px), one mapping call (100 iterations x 5000 px: the
third of a mapping event the strict loop runs per call), one mesh at
resolution 256 and one full-frame render; each row also gives the MLP's
floating-point work (``mlp_tflop``, from the shapes) and its time at the
card's float32 peak (``mlp_bound_ms``).

``--schedules`` profiles whole runs instead: the 12-frame loop of the
Replica-scale workload (first mapping 300 iterations, no meshes) under
the strict, loose and free schedules (or those listed), one row each with the run's wall
time, fps, tracking ms per frame, mapping and coarse-mapping ms per event
and events of an unprofiled run, and the wall, device busy time and idle
share of a second run traced for device activity only (the threads'
streams together; the threaded schedules' event counts vary from run to
run, so both runs' are given).  ``--devices`` runs them over a device list
(comma-separated, it may repeat a card, e.g. ``cuda:0,cuda:1``; by default
every visible card), with the multi-device knobs of the environment
(``NICE_SLAM_TORCH_SPATIAL=1`` shards the grids, else ray data parallelism
with the coarse mapper on the last device).  Where the list spans two or
more cards each row also gives, per card, the device busy time and idle
share of the traced run and ``torch.cuda.max_memory_allocated`` of the
untraced one, and the peer copies' time (the ``Memcpy PtoP`` spans) and
its share of the traced run's wall.

Run as a file with another checkout first on ``PYTHONPATH`` to measure
that checkout's port with this instrumentation.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

KERNELS = ("trilinear_fwd", "trilinear_bwd_dgrid", "trilinear_bwd_dp",
           "decoder_fwd", "decoder_bwd", "decoder_wgrad_sum",
           "integrate_fwd", "integrate_bwd", "group_adam", "frustum_mask",
           "frustum_depth_max")  # the last: the first kernel of an older two-launch K10
# the entry points of the integrator, the Adam step and the frustum mask
# (K7-K10; plain PyTorch chains in a port older than them): (module,
# attribute) each traced as a record_function range named after it, where
# the port has it
ITEMS = {"raw2outputs_nerf_color": ("nice_slam_torch.ops.render", "raw2outputs_nerf_color"),
         "group_adam_step": ("nice_slam_torch.slam.optim", "GroupAdam.step"),
         "frustum_mask": ("nice_slam_torch.slam.mapper", "frustum_mask"),
         "frustum_masks": ("nice_slam_torch.slam.mapper", "frustum_masks")}
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores


def imap_point_flops(hidden: int = 256, embed: int = 93, n_blocks: int = 4,
                     out: int = 4, dim: int = 3) -> int:
    """Forward floating-point operations of the iMAP* MLP on one point:
    2 x the multiply-adds of the embedding and the dense layers."""
    macs = dim * embed + embed * hidden + (n_blocks - 1) * hidden * hidden + hidden * out
    return 2 * macs


def imap_iteration_flops(rays: int, samples: int, importance: int,
                         reg_samples: int, mapping: bool) -> float:
    """MLP floating-point operations of one iMAP* iteration over ``rays``
    rays: the importance pass forward only; the merged samples forward
    and backward (the backward is 2 x forward with weight gradients, the
    mapper's, 1 x without, the tracker's, which only needs the input
    gradient); the mapper's regulariser samples forward and backward."""
    f = imap_point_flops()
    bwd = 2 if mapping else 1
    per_ray = samples + (1 + bwd) * (samples + importance)
    if mapping:
        per_ray += 3 * reg_samples
    return float(rays) * per_ray * f


def _busy_us(evts) -> float:
    """The union of the events' device intervals, in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in evts)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _cuda_events(prof):
    """The device's kernel, copy and memset events.  An ITEMS range also
    shows on the device timeline, spanning its kernels and the gaps
    between them; it is left out, or the busy time would count those gaps."""
    import torch

    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in ITEMS]


def _device_summary(prof, wall_ms: float, top: int = 12) -> dict:
    evts = _cuda_events(prof)
    busy = _busy_us(evts)
    by_name: dict = {}
    for e in evts:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    kernels = {}
    gemm = sum(t for n, (t, _) in by_name.items() if "gemm" in n.lower())
    for k in KERNELS:
        hits = [(t, c) for n, (t, c) in by_name.items() if k + "_kernel" in n]
        kernels[k] = {"ms": sum(t for t, _ in hits) / 1e3,
                      "count": sum(c for _, c in hits)}
    return {"wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / 1e3 / wall_ms,
            "device_ops": len(evts),
            "top": [{"name": n[:80], "ms": t / 1e3, "count": c}
                    for n, (t, c) in ranked],
            "gemm_ms": gemm / 1e3, "kernels": kernels}


def _annotate_items() -> None:
    """Wrap each ITEMS function the port has in a record_function range of
    its name."""
    import functools
    import importlib

    import torch

    for name, (module, attr) in ITEMS.items():
        owner = importlib.import_module(module)
        *path, leaf = attr.split(".")
        for part in path:
            owner = getattr(owner, part)
        inner = getattr(owner, leaf, None)
        if inner is None:
            continue

        def wrapped(*a, __inner=inner, __name=name, **k):
            with torch.profiler.record_function(__name):
                return __inner(*a, **k)

        setattr(owner, leaf, functools.wraps(inner)(wrapped))


def _items_summary(prof) -> dict:
    """Device ms and calls of each ITEMS function: the device time of the
    kernels launched inside its host-side range (the range's span on the
    device timeline would also count the gaps and other streams' work)."""
    import torch

    out = {}
    for e in prof.events():
        if e.name in ITEMS and e.device_type == torch.autograd.DeviceType.CPU:
            row = out.setdefault(e.name, {"device_ms": 0.0, "calls": 0})
            row["device_ms"] += e.device_time_total / 1e3
            row["calls"] += 1
    return out


def _per_card(prof, wall_ms: float) -> dict:
    """Each card's device busy time and idle share, and the peer copies'
    time and share of the wall, from a trace of several cards."""
    evts = _cuda_events(prof)
    cards = {}
    for i in sorted({e.device_index for e in evts}):
        busy = _busy_us([e for e in evts if e.device_index == i]) / 1e3
        cards[f"cuda:{i}"] = {"device_busy_ms": busy,
                              "device_idle_share": 1.0 - busy / wall_ms}
    peer = [e for e in evts if "PtoP" in e.name]
    peer_ms = sum(e.time_range.elapsed_us() for e in peer) / 1e3
    return {"cards": cards, "peer_copies": len(peer), "peer_copy_ms": peer_ms,
            "peer_copy_share": peer_ms / wall_ms}


def profile_schedules(out: str, schedules, devices=None) -> None:
    """One row per schedule: a whole 12-frame run without meshes over
    ``devices`` (None: every visible card).  A strict run first builds the
    kernels and warms the cards; then each schedule runs unprofiled (wall
    time, fps, each card's peak memory), then each once more under the
    profiler (device activity only: the host-side trace of ~400k operations
    would slow the threads it measures)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nice_slam_torch.slam.slam import NiceSLAM
    from nice_slam_torch.tools.workloads import replica_synthetic_cfg

    def fresh(sync):
        cfg = replica_synthetic_cfg(os.path.join(out, sync), n_frames=12,
                                    iters_first=300)
        cfg.update(sync_method=sync, meshing=None)
        slam = NiceSLAM(cfg, argparse.Namespace(nice=True, output=None), "cuda",
                        devices=devices)
        for i in range(slam.n_img):  # frame synthesis is not timed
            slam.frame_reader[i]
        for c in cards:
            torch.cuda.synchronize(c)
        return slam

    card = torch.cuda.get_device_name(0)
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    cards = sorted({torch.device(d) for d in devices}, key=lambda d: d.index)
    several = len(cards) > 1
    fresh("strict").run()  # warm-up
    rows = {}
    for sync in schedules:
        slam = fresh(sync)
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)
        t0 = time.perf_counter()
        slam.run()
        wall = 1e3 * (time.perf_counter() - t0)
        t = slam.timings
        rows[sync] = (wall, {"what": f"loop_{sync}", "device": card,
                             "devices": [str(d) for d in devices],
                             "spatial": slam.spatial_devices is not None,
                             "coarse_device": str(getattr(slam.coarse_mapper, "device", None)),
                             "frames": slam.n_img, **{k: t.get(k) for k in (
                                 "fps", "tracking_ms_per_frame",
                                 "mapping_ms_per_event",
                                 "coarse_mapping_ms_per_event",
                                 "mapping_events", "coarse_mapping_events")}})
        if several:
            rows[sync][1]["peak_mem_gib"] = {
                str(c): torch.cuda.max_memory_allocated(c) / 2 ** 30 for c in cards}
    for sync in schedules:
        traced = fresh(sync)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            traced.run()
            traced_wall = 1e3 * (time.perf_counter() - t0)
        wall, row = rows[sync]
        row["untraced_wall_ms"] = wall
        row.update(_device_summary(prof, traced_wall))
        if several:
            row.update(_per_card(prof, traced_wall))
        row["traced_mapping_events"] = traced.timings["mapping_events"]
        row["traced_coarse_mapping_events"] = traced.timings["coarse_mapping_events"]
        print(json.dumps(row), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="output directory")
    group = parser.add_mutually_exclusive_group()
    group.add_argument("--imap", action="store_true",
                       help="profile the iMAP* model")
    group.add_argument("--schedules", nargs="?", const="strict,loose,free",
                       help="profile whole runs of these schedules "
                            "(comma-separated; default all three)")
    parser.add_argument("--ba", action="store_true",
                        help="also profile the mapping call with bundle adjustment")
    parser.add_argument("--reps", type=int, default=1,
                        help="unprofiled runs of each row; wall_ms is their median")
    parser.add_argument("--items", default=None,
                        help="profile only these rows (comma-separated, e.g. "
                             "tracking_frame,mapping_call)")
    parser.add_argument("--devices", default=None,
                        help="run over this comma-separated device list (it may "
                             "repeat a card; --schedules' default: every visible "
                             "card; otherwise cuda)")
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from nice_slam_torch.ops.geometry import tensor_from_pose
    from nice_slam_torch.ops.render import render_img
    from nice_slam_torch.slam.slam import NiceSLAM
    from nice_slam_torch.slam.tracker import presample_pixels, track_frame_sampled
    from nice_slam_torch.tools.workloads import (
        ROOT,
        replica_imap_cfg,
        replica_synthetic_cfg,
    )

    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    _annotate_items()
    out = args.out or os.path.join(ROOT, "output",
                                   "profile_step_imap" if args.imap else "profile_step")
    if args.schedules:
        profile_schedules(out, args.schedules.split(","),
                          args.devices and args.devices.split(","))
        return
    make = replica_imap_cfg if args.imap else replica_synthetic_cfg
    cfg = make(out, n_frames=17, iters_first=300)
    devices = args.devices and args.devices.split(",")
    slam = NiceSLAM(cfg, argparse.Namespace(nice=not args.imap, output=None), "cuda",
                    devices=devices)
    slam.run()  # keyframes at 0, 5, 10, 15
    m = slam.mapper  # undo the final frame's color-refine settings
    for attr in ("mapping_window_size", "middle_iter_ratio", "fine_iter_ratio",
                 "fix_color", "frustum_feature_selection"):
        setattr(m, attr, getattr(m.mcfg, attr))

    idx = slam.n_img - 1
    _, color, depth, _ = slam.frame_reader[idx]
    dev = slam.device
    pix = [torch.as_tensor(a, device=dev)
           for a in presample_pixels(1, idx, slam.tcfg, color, depth)]
    init = tensor_from_pose(slam.estimate_c2w_list[idx])
    color_d = torch.as_tensor(color, device=dev)
    depth_d = torch.as_tensor(depth, device=dev)
    cur = slam.estimate_c2w_list[idx].clone()
    cfg_m = cfg["mapping"]
    mesher = slam.mesher

    def mesh(resolution):
        def run():
            mesher.resolution = resolution
            mesher.get_mesh(os.path.join(out, "mesh", f"profile_{resolution}.ply"),
                            slam.state, slam.keyframes, slam.estimate_c2w_list, idx)
        return run

    # the strict loop's iMAP* mapping events run as 3 calls of iters // 3
    map_iters = cfg_m["iters"] // (1 if slam.nice else 3)
    work = {
        "tracking_frame": lambda: track_frame_sampled(
            slam.spec, slam.state, init, *pix, slam.tcfg, slam.rcfg),
        "mapping_call": lambda: slam.mapper.optimize_map(
            slam.state, map_iters, cfg_m["lr_factor"], color_d, depth_d,
            slam.keyframes, cur, False),
        "mapping_call_ba": lambda: slam.mapper.optimize_map(
            slam.state, map_iters, cfg_m["lr_factor"], color_d, depth_d,
            slam.keyframes, cur, True),
        "coarse_mapping_call": lambda: slam.coarse_mapper.optimize_map(
            slam.state, cfg_m["iters"], cfg_m["lr_factor"], color_d, depth_d,
            slam.keyframes, cur, False),
        "mesh_res256": mesh(256),
        "mesh_res128": mesh(128),
        "render_frame": lambda: render_img(
            slam.spec, slam.state, cur, slam.H, slam.W, slam.cam["fx"],
            slam.cam["fy"], slam.cam["cx"], slam.cam["cy"], "color",
            gt_depth=depth_d, rcfg=slam.rcfg),
    }
    if not args.ba:
        del work["mapping_call_ba"]
    if not slam.nice:
        for k in ("coarse_mapping_call", "mesh_res128"):
            del work[k]
        r = slam.rcfg
        mlp_tflop = {
            "tracking_frame": slam.tcfg.iters * imap_iteration_flops(
                slam.tcfg.pixels, r.N_samples, r.N_importance, 0, False),
            "mapping_call": map_iters * imap_iteration_flops(
                cfg_m["pixels"], r.N_samples, r.N_importance, r.N_samples, True)}
    if args.items:
        unknown = set(args.items.split(",")) - set(work)
        if unknown:
            raise SystemExit(f"profile_step: no rows {sorted(unknown)}; rows: {sorted(work)}")
        work = {k: v for k, v in work.items() if k in args.items.split(",")}
    card = torch.cuda.get_device_name(0)
    for name, fn in work.items():
        fn()  # warm
        torch.cuda.synchronize()
        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))  # without the profiler
        wall = statistics.median(walls)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        row = {"what": name, "device": card}
        if devices:
            row.update(devices=devices, sharded=slam.spatial_devices is not None,
                       ray_dp=slam.mapper.devices is not None)
        if name.startswith("mapping_call"):
            row["iterations"] = map_iters
        row.update(_device_summary(prof, wall))
        if args.reps > 1:
            row["wall_ms_runs"] = walls
        row["items"] = _items_summary(prof)
        if not slam.nice and name in mlp_tflop:
            row["mlp_tflop"] = mlp_tflop[name] / 1e12
            row["mlp_bound_ms"] = 1e3 * mlp_tflop[name] / F32_FLOPS_PER_S
        if name.startswith("mesh"):
            row["mesher_steps"] = mesher.last
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
