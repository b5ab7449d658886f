"""Where a tracking frame's and a mapping call's time goes on the card.

    python -m nice_slam_torch.tools.profile_step [--out DIR]

Runs the Replica-scale synthetic workload (``tools/workloads.py``) for
17 frames of the strict loop, so the map and a full 5-frame keyframe
window exist,
then traces under ``torch.profiler`` one tracked frame (10 iterations),
one main-mapper call (60 iterations) and one coarse-mapper call.  For each
it prints one JSON line: wall time of an unprofiled run (host clock,
ending in a synchronize), the device's busy time in a profiled run (union
of its kernel, copy and memset intervals), the idle share (1 - busy /
wall), the number of device operations, the operations taking the
most device time, and (``kernels``) the device ms and launch count of
each trilinear kernel, K1-K3, whether or not it ranks in ``top``.  Needs
a CUDA device.

Run as a file with another checkout first on ``PYTHONPATH`` to measure
that checkout's port with this instrumentation.
"""

from __future__ import annotations

import argparse
import json
import os
import time

TRILINEAR_KERNELS = ("trilinear_fwd", "trilinear_bwd_dgrid", "trilinear_bwd_dp")


def _device_summary(prof, wall_ms: float, top: int = 12) -> dict:
    import torch

    evts = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
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
    by_name: dict = {}
    for e in evts:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    kernels = {}
    for k in TRILINEAR_KERNELS:
        hits = [(t, c) for n, (t, c) in by_name.items() if k + "_kernel" in n]
        kernels[k] = {"ms": sum(t for t, _ in hits) / 1e3,
                      "count": sum(c for _, c in hits)}
    return {"wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / 1e3 / wall_ms,
            "device_ops": len(evts),
            "top": [{"name": n[:80], "ms": t / 1e3, "count": c}
                    for n, (t, c) in ranked],
            "kernels": kernels}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="output directory")
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from nice_slam_torch.ops.geometry import tensor_from_pose
    from nice_slam_torch.slam.slam import NiceSLAM
    from nice_slam_torch.slam.tracker import presample_pixels, track_frame_sampled
    from nice_slam_torch.tools.workloads import ROOT, replica_synthetic_cfg

    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    out = args.out or os.path.join(ROOT, "output", "profile_step")
    cfg = replica_synthetic_cfg(out, n_frames=17, iters_first=300)
    slam = NiceSLAM(cfg, argparse.Namespace(nice=True, output=None), "cuda")
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
    work = {
        "tracking_frame": lambda: track_frame_sampled(
            slam.spec, slam.state, init, *pix, slam.tcfg, slam.rcfg),
        "mapping_call": lambda: slam.mapper.optimize_map(
            slam.state, cfg_m["iters"], cfg_m["lr_factor"], color_d, depth_d,
            slam.keyframes, cur, False),
        "coarse_mapping_call": lambda: slam.coarse_mapper.optimize_map(
            slam.state, cfg_m["iters"], cfg_m["lr_factor"], color_d, depth_d,
            slam.keyframes, cur, False),
    }
    card = torch.cuda.get_device_name(0)
    for name, fn in work.items():
        fn()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)  # without the profiler
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        row = {"what": name, "device": card}
        row.update(_device_summary(prof, wall))
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
