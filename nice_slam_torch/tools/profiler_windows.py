"""How often torch.profiler loses a kernel record on the card, with and
without K10's cooperative launch in the process, and after a traced run.

    python nice_slam_torch/tools/profiler_windows.py --mode none [--windows 40]
    python nice_slam_torch/tools/profiler_windows.py --mode k10_once
    python nice_slam_torch/tools/profiler_windows.py --mode k10_each
    python nice_slam_torch/tools/profiler_windows.py --mode after_profile [--kernel k3]

A window is what ``chip_smoke.device_time_ms`` records once: 20 calls of
K2 (``trilinear_bwd_dgrid``, the fine grid at the color stage's 48,000
points), each after a read that evicts the L2, inside one
``torch.profiler.profile`` context.  It is lost when it holds fewer than
20 K2 records or one of zero duration; this tool counts lost windows
instead of retrying them.
``k10_once`` launches K10 (the Replica room's three grids, a 680x1200
depth frame) once before the first window, ``k10_each`` before every
window, neither profiled; ``none`` never launches it.  ``after_profile``
first runs ``chip_smoke.phase_profile`` (``nice_slam_torch.run --profile``
on three box frames: a torch.profiler trace of a whole run, host
threads included, as the smoke runs it before its later device_ms rows).
``--kernel k3`` times K3 (``trilinear_bwd_dp``) over the same grid and
points instead of K2.  Prints one JSON
line: the mode, the windows, the lost ones and the K2 records of each lost
window.  Run the modes in alternating processes in one call: the rate of
lost records differs from machine to machine.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REPS = 20
L2_FLUSH_BYTES = 256 << 20  # chip_smoke.L2_FLUSH_BYTES


def room_camera(dev):
    """The Replica room's bound and grids and a camera looking into it
    over a smooth 680x1200 depth image, 5 % of it zero."""
    import torch

    from nice_slam_torch.ops.geometry import c2w44

    gen = torch.Generator().manual_seed(0)
    bound = torch.tensor([[-2.9, 8.94], [-3.2, 5.76], [-3.5, 3.54]])
    shapes = [(37, 28, 21), (74, 56, 43), (74, 56, 43)]
    H, W, fx, fy, cx, cy = 680, 1200, 600.0, 600.0, 599.5, 339.5
    c, s = math.cos(0.4), math.sin(0.4)
    rt = torch.tensor([[c, 0.0, s, 2.0], [0.0, 1.0, 0.0, 0.5], [-s, 0.0, c, 0.3]])
    yy, xx = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    depth = 2.0 + 1.5 * torch.sin(xx / 97.0) * torch.cos(yy / 61.0) \
        + 0.1 * torch.rand((H, W), generator=gen)
    depth[torch.rand((H, W), generator=gen) < 0.05] = 0.0
    return (c2w44(rt).to(dev), depth.to(dev), bound.to(dev), shapes, H, W, fx, fy, cx, cy)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("none", "k10_once", "k10_each", "after_profile"),
                    required=True)
    ap.add_argument("--kernel", choices=("k2", "k3"), default="k2")
    ap.add_argument("--windows", type=int, default=40)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profiler_windows: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import phase_profile, ray_points, smi
    from nice_slam_torch.ops import frustum as Fm
    from nice_slam_torch.ops import interp

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    shape = (74, 56, 43, 32)
    p = ray_points(1000, gen, dev)
    cot = torch.randn((p.shape[0], shape[3]), generator=gen).to(dev)
    cam = room_camera(dev)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    flush.zero_()
    if args.kernel == "k2":
        name = "trilinear_bwd_dgrid"

        def call():
            interp.trilinear_bwd_dgrid(p, cot, shape)
    else:
        name = "trilinear_bwd_dp"
        grid = torch.randn(shape, generator=gen).to(dev)

        def call():
            interp.trilinear_bwd_dp(grid, p, cot)
    if args.mode == "after_profile":
        phase_profile(dev)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    lost = []
    for w in range(args.windows):
        if args.mode == "k10_each" or (args.mode == "k10_once" and w == 0):
            Fm.frustum_masks(*cam)
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                flush.sum()
                call()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
        if len(us) != REPS or min(us, default=0) <= 0:
            lost.append(len(us))
    print(json.dumps({"mode": args.mode, "kernel": name, "windows": args.windows,
                      "lost": len(lost),
                      "records_in_lost": lost, "k10_launches": Fm.launch_counts["frustum_mask"],
                      "card": smi()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
