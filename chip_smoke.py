#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  build    compile every CUDA source of the port with nvcc (sm_90a), one
           process per source, all started together;
  capture  a 2-frame run of the slice's own workload (Replica-scale room,
           first mapping 60 iterations) that records the backward kernels'
           arguments on the main path: one tracking iteration's lookups
           (K3 over the middle, fine and color grids), one color-stage
           mapping iteration's (K2 over the same three grids) and one
           coarse-mapping iteration's (K2 over the coarse grid);
  kernels  hold K1 trilinear_fwd, K2 trilinear_bwd_dgrid and K3
           trilinear_bwd_dp against their plain PyTorch versions on random
           ray points at the main path's shapes (fine grid 74x56x43x32 at
           48k mapping / 9.6k tracking points, coarse grid 11x8x7x32 at
           48k) and on the three captured cases; time each per call with
           CUDA events around 20 calls (``ms``: the host's issue rate
           included) and with torch.profiler (``device_ms``: the kernel's
           own device time per call, each call after the L2 was evicted),
           beside its plain version and torch.nn.functional.grid_sample
           (library yardstick only; the port never calls it); fail if a
           kernel's device_ms is below its bound_ms; check the whole
           decoder stack on the card against the CPU on a small input;
  slice    the strict loop (track every frame, map + coarse-map every 5th)
           at full width on the Replica-scale synthetic room, 12 frames of
           680x1200, with every kernel's launches counted over the run
           (K3 once per tracking iteration, K2 once per mapping iteration);
  quality  the 30-frame tracked box run (0.25 rad orbit, mapping iters 60,
           first 400, coarse off) and its ATE against the 9.5 cm gate.

Then the card's name and power limit, the kernels line and, last,
{"ok": true, "device": {...}}.  Any failure exits non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
L2_FLUSH_BYTES = 256 << 20  # read before each profiled call: 5x the 50 MB L2
SLICE_ITERS_FIRST = 300     # the Replica config's 1500, cut for time
CAPTURE_ITERS_FIRST = 60    # enough for the middle, fine and color stages
ATE_GATE_CM = 9.5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Per-call time between CUDA events around ``reps`` back-to-back
    calls: at small sizes this is the host's issue rate, not the kernel."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# profiling windows retried because they recorded no kernel of the name
PROFILER_RETRIES = {"windows": 0}


def device_time_ms(fn, match: str, reps: int = 20, warmup: int = 3) -> float:
    """Per-call device time of the kernels whose name contains ``match``,
    from torch.profiler's CUDA activity over ``reps`` calls.  Each call
    follows a read of L2_FLUSH_BYTES that evicts the L2, so the kernel
    finds its inputs in HBM, as the bound (bytes over the HBM rate)
    assumes and as a mapping iteration finds them (its Adam step alone
    sweeps the grids and their moments, ~145 MB).  A window now and then
    records no kernel at all (seen on an H100); it is retried up to 5
    times, then the run fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    flush.zero_()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.sum()
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and match in e.name]
        if us:
            return sum(us) / 1e3 / reps
        PROFILER_RETRIES["windows"] += 1
    raise RuntimeError(f"torch.profiler recorded no {match} kernel in 5 windows")


def ray_points(n_rays: int, gen, device):
    """Lookup points shaped like the renderer's: 48 sorted samples along
    each of ``n_rays`` rays from inside the box, some past its faces."""
    import torch

    o = (torch.rand((n_rays, 1, 3), generator=gen) - 0.5)
    d = torch.nn.functional.normalize(torch.randn((n_rays, 1, 3), generator=gen),
                                      dim=-1)
    t = torch.sort(torch.rand((n_rays, 48, 1), generator=gen) * 1.8, dim=1).values
    return (o + d * t).reshape(-1, 3).contiguous().to(device)


def phase_build():
    from nice_slam_torch.ops import kernels

    t0 = time.perf_counter()
    names = sorted(f[:-3] for f in os.listdir(kernels.CSRC) if f.endswith(".cu"))
    libs = kernels.build(names)
    for name in names:
        kernels.library(name)
    ptxas = [ln.strip() for log in kernels.build_logs.values()
             for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "ok": True, "sources": names,
          "seconds": time.perf_counter() - t0, "libraries": list(libs.values()),
          "ptxas": ptxas})


def phase_capture(dev):
    """Cases of the main path: (points, grids, cotangents) as the slice's
    backward passes hand them to K2 and K3."""
    from nice_slam_torch.ops import interp
    from nice_slam_torch.slam.slam import NiceSLAM
    from nice_slam_torch.tools.workloads import replica_synthetic_cfg

    t0 = time.perf_counter()
    cfg = replica_synthetic_cfg(os.path.join(HERE, "output", "chip_smoke", "capture"),
                                n_frames=2, iters_first=CAPTURE_ITERS_FIRST)
    slam = NiceSLAM(cfg, argparse.Namespace(nice=True, output=None), dev)
    coarse_shape = tuple(slam.state.grids["grid_coarse"].shape)
    seen = {}
    dgrid_multi = interp.trilinear_bwd_dgrid_multi
    dp_multi = interp.trilinear_bwd_dp_multi

    def keep(p, gs):
        return {"p": p.detach().clone(), "gs": [g.detach().clone() for g in gs]}

    def rec_dgrid(p, gs, shapes):
        if len(gs) == 3:
            seen["map_color"] = keep(p, gs)
        elif len(gs) == 1 and tuple(shapes[0]) == coarse_shape:
            seen["map_coarse"] = keep(p, gs)
        return dgrid_multi(p, gs, shapes)

    def rec_dp(grids, p, gs):
        seen["track"] = dict(keep(p, gs), grids=[g.detach().clone() for g in grids])
        return dp_multi(grids, p, gs)

    interp.trilinear_bwd_dgrid_multi = rec_dgrid
    interp.trilinear_bwd_dp_multi = rec_dp
    try:
        slam.run()
    finally:
        interp.trilinear_bwd_dgrid_multi = dgrid_multi
        interp.trilinear_bwd_dp_multi = dp_multi
    g = slam.state.grids
    # the color stage looks up middle, fine, color in that order
    seen["map_color"]["grids"] = [g["grid_middle"], g["grid_fine"], g["grid_color"]]
    seen["map_coarse"]["grids"] = [g["grid_coarse"]]
    cases = {k: seen[k] for k in ("track", "map_color", "map_coarse")}
    emit({"phase": "capture", "ok": True, "seconds": time.perf_counter() - t0,
          "cases": {k: {"n": v["p"].shape[0], "grids": [list(x.shape) for x in v["grids"]]}
                    for k, v in cases.items()}})
    return cases


def dgrid_f64(p, g, shape):
    """K2's plain version with the kernel's float32 weights and products,
    summed in float64 (exact to float32 rounding), and the same sum of
    |w_k g| (the scale of K2's tolerance).  Built here from the plain
    version's helpers."""
    import torch

    from nice_slam_torch.ops import interp

    i0, i1, frac, _ = interp._corners(shape, p)
    weights, _ = interp._corner_weights(frac)
    out = torch.zeros((2, shape[0] * shape[1] * shape[2], shape[3]),
                      dtype=torch.float64, device=p.device)
    for r, w in zip(interp._corner_rows(shape, i0, i1), weights):
        c = (w[:, None] * g).double()
        out[0].index_add_(0, r, c)
        out[1].index_add_(0, r, c.abs())
    return out[0].reshape(shape), out[1].reshape(shape)


def kernel_rows(label, grids, p, gs):
    """K1, K2 and K3 over the grids of one case (one lookup Function of a
    decoder stage): error against the plain versions (raises above its
    tolerance), ms, device_ms, plain_ms, grid_sample's ms and device_ms,
    and the bytes and flops of the bound.  Bytes count what each kernel
    itself must move, each once: the points, the cotangents or features,
    the grid rows the points touch (K1, K3 read them; K2 reads and writes
    them in the zeroed gradient, which its wrapper fills with a separate
    kernel that device_ms leaves out) and dp.

    K2 is held against its plain version summed in float64
    (``dgrid_f64``): a main-path coarse cell takes ~10^4
    contributions, and a float32 sum of that many in any order (the plain
    version's index_add_ also sums with atomics) is off by tens of ulps of
    the cell's sum of |w_k g| on its own."""
    import torch
    import torch.nn.functional as F

    from nice_slam_torch.ops import interp

    eps = torch.finfo(torch.float32).eps
    shapes = [tuple(g.shape) for g in grids]
    n = p.shape[0]
    pts_b = n * 3 * 4
    gather_b = feat_b = 0
    lib = []
    for grid, g in zip(grids, gs):
        C = grid.shape[3]
        i0, i1, _, _ = interp._corners(grid.shape, p)
        touched = torch.unique(torch.cat(interp._corner_rows(grid.shape, i0, i1))).numel()
        gather_b += touched * C * 4
        feat_b += n * C * 4
        # grid_sample's layout of the same lookup: [1, C, Z, Y, X], (x, y, z)
        lib.append((grid.permute(3, 2, 1, 0)[None].contiguous(),
                    g.t().reshape(1, C, n, 1, 1).contiguous()))
    lib_pts = p[None, :, None, None, :]
    C = shapes[0][3]
    base = dict(case=label, n=n, grids=len(grids))

    def lib_fwd():
        for x, _ in lib:
            F.grid_sample(x, lib_pts, mode="bilinear", padding_mode="border",
                          align_corners=True)

    def lib_bwd(mask):
        def run():
            for x, g in lib:
                torch.ops.aten.grid_sampler_3d_backward(g, x, lib_pts, 0, 1, True, mask)
        return run

    def timed(fn, plain, lib_fn, lib_match, kernel):
        return dict(ms=cuda_time_ms(fn), device_ms=device_time_ms(fn, kernel),
                    plain_ms=cuda_time_ms(plain, 5),
                    library_ms=cuda_time_ms(lib_fn),
                    library_device_ms=device_time_ms(lib_fn, lib_match))

    def held(kernel, err, tol):
        if not err <= tol:
            raise AssertionError(f"{kernel} {label}: max abs err {err} > {tol}")
        return dict(base, kernel=kernel, max_abs_err=err, tol=tol)

    rows = []
    # K1 (one launch per grid)
    err = max(float((interp.trilinear_fwd(gr, p) - interp.trilinear_fwd_plain(gr, p)).abs().max())
              for gr in grids)
    rows.append(dict(held("trilinear_fwd", err, 1e-5),
                     bytes=gather_b + pts_b + feat_b, flops=n * C * 21 * len(grids),
                     **timed(lambda: [interp.trilinear_fwd(gr, p) for gr in grids],
                             lambda: [interp.trilinear_fwd_plain(gr, p) for gr in grids],
                             lib_fwd, "grid_sampler_3d", "trilinear_fwd")))
    # K2
    dgs = interp.trilinear_bwd_dgrid_multi(p, gs, shapes)
    held_k2 = []  # (err, tol) per grid; the row keeps the grid nearest its limit
    for dg, g, s in zip(dgs, gs, shapes):
        ref, scale = dgrid_f64(p, g, s)
        held_k2.append((float((dg.double() - ref).abs().max()),
                        32 * eps * float(scale.max())))
    err, tol = max(held_k2, key=lambda et: et[0] - et[1])
    rows.append(dict(held("trilinear_bwd_dgrid", err, tol),
                     bytes=pts_b + feat_b + 2 * gather_b, flops=n * 8 * C * 2 * len(grids),
                     **timed(lambda: interp.trilinear_bwd_dgrid_multi(p, gs, shapes),
                             lambda: [interp.trilinear_bwd_dgrid_plain(p, g, s)
                                      for g, s in zip(gs, shapes)],
                             lib_bwd([True, False]), "grid_sampler_3d",
                             "trilinear_bwd_dgrid")))
    # K3
    dp = interp.trilinear_bwd_dp_multi(grids, p, gs)
    ref = sum(interp.trilinear_bwd_dp_plain(gr, p, g) for gr, g in zip(grids, gs))
    err = float((dp - ref).abs().max())
    rows.append(dict(held("trilinear_bwd_dp", err, 1e-4 * float(ref.abs().max())),
                     bytes=gather_b + pts_b + feat_b + pts_b,
                     flops=n * 8 * C * 2 * len(grids),
                     **timed(lambda: interp.trilinear_bwd_dp_multi(grids, p, gs),
                             lambda: sum(interp.trilinear_bwd_dp_plain(gr, p, g)
                                         for gr, g in zip(grids, gs)),
                             lib_bwd([False, True]), "grid_sampler_3d",
                             "trilinear_bwd_dp")))
    return rows


def phase_kernels(dev, cases):
    import torch

    gen = torch.Generator().manual_seed(0)
    random_cases = [("fine_map", (74, 56, 43, 32), 1000),
                    ("fine_track", (74, 56, 43, 32), 200),
                    ("coarse_map", (11, 8, 7, 32), 1000)]
    rows = []
    for label, shape, n_rays in random_cases:
        grid = torch.randn(shape, generator=gen).to(dev)
        p = ray_points(n_rays, gen, dev)
        g = torch.randn((p.shape[0], shape[3]), generator=gen).to(dev)
        rows += kernel_rows(label, [grid], p, [g])
    for label, c in cases.items():
        rows += kernel_rows(label, c["grids"], c["p"], c["gs"])
    for r in rows:
        t_bytes = 1e3 * r["bytes"] / HBM_BYTES_PER_S
        t_ops = 1e3 * r["flops"] / F32_FLOPS_PER_S
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    torch.cuda.synchronize()
    under = [(r["case"], r["kernel"]) for r in rows if r["device_ms"] < r["bound_ms"]]
    if under:
        raise AssertionError(f"device_ms below bound_ms (a wrong bound or timing): {under}")
    emit({"phase": "kernels", "ok": True, "rows": rows,
          "profiler_retries": PROFILER_RETRIES["windows"],
          "stack_max_abs_err": stack_check(dev)})
    return rows


def stack_check(dev) -> float:
    """The whole decoder stack (grids, batched decoders, sentinel) on the
    card against the same port on the CPU, small input; atol 0.05 on raw
    logits (the Fourier embedding's sin at O(100) rad)."""
    import torch

    from nice_slam_torch.config import load_config
    from nice_slam_torch.convert import scene_from_jax, scene_to_numpy
    from nice_slam_torch.models.pretrain import load_pretrain
    from nice_slam_torch.models.scene import build_scene, eval_points

    cfg = load_config(os.path.join(HERE, "configs", "Synthetic", "box.yaml"),
                      os.path.join(HERE, "configs", "nice_slam.yaml"))
    for k in ("coarse", "middle_fine"):
        cfg["pretrained_decoders"][k] = os.path.join(HERE, cfg["pretrained_decoders"][k])
    spec, state = build_scene(cfg, device="cpu")
    state = load_pretrain(cfg, spec, state, verbose=False)
    gen = torch.Generator().manual_seed(1)
    state = state._replace(grids={k: 0.3 * torch.randn(v.shape, generator=gen)
                                  for k, v in state.grids.items()})
    on_dev = scene_from_jax(scene_to_numpy(state), dev)
    p = torch.rand((2000, 3), generator=gen) * 5.2 - 2.6
    worst = 0.0
    for stage in ("coarse", "middle", "fine", "color"):
        a = eval_points(spec, state, p, stage)
        b = eval_points(spec, on_dev, p.to(dev), stage).cpu()
        worst = max(worst, float((a - b).abs().max()))
    if not worst <= 0.05:
        raise AssertionError(f"decoder stack cuda vs cpu: {worst} > 0.05")
    return worst


def count_iterations(mapper, sink, key) -> None:
    """Add each optimize_map call's iteration count to ``sink[key]``."""
    inner = mapper.optimize_map

    def counted(*a, **k):
        out = inner(*a, **k)
        sink[key] += int(out[2].shape[0])
        return out

    mapper.optimize_map = counted


def phase_slice(dev):
    import torch

    from nice_slam_torch.ops import interp
    from nice_slam_torch.slam.slam import NiceSLAM
    from nice_slam_torch.tools.eval_ate import ate_rmse
    from nice_slam_torch.tools.workloads import replica_synthetic_cfg

    out = os.path.join(HERE, "output", "chip_smoke", "slice")
    cfg = replica_synthetic_cfg(out, n_frames=12, iters_first=SLICE_ITERS_FIRST)
    slam = NiceSLAM(cfg, argparse.Namespace(nice=True, output=None), dev)
    for i in range(slam.n_img):  # frame synthesis is not part of the timing
        slam.frame_reader[i]
    iters = {"mapping": 0, "coarse_mapping": 0}
    count_iterations(slam.mapper, iters, "mapping")
    count_iterations(slam.coarse_mapper, iters, "coarse_mapping")
    interp.reset_launch_counts()
    slam.run()
    counts = dict(interp.launch_counts)

    est = slam.estimate_c2w_list.cpu().numpy()
    if not torch.isfinite(slam.estimate_c2w_list).all():
        raise AssertionError("non-finite poses in the slice run")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    t = slam.timings
    track_iters = t["tracked_frames"] * slam.tcfg.iters
    map_iters = iters["mapping"] + iters["coarse_mapping"]
    # one lookup Function per decoder stage: one K3 per tracking iteration
    # (BA off: mapping never needs the points' gradient), one K2 per
    # mapping iteration
    if counts["trilinear_bwd_dp"] != track_iters:
        raise AssertionError(f"K3 launched {counts['trilinear_bwd_dp']} times "
                             f"for {track_iters} tracking iterations")
    if counts["trilinear_bwd_dgrid"] != map_iters:
        raise AssertionError(f"K2 launched {counts['trilinear_bwd_dgrid']} times "
                             f"for {map_iters} mapping iterations")
    grids = {k: list(v.shape) for k, v in slam.state.grids.items()}
    emit({"phase": "slice", "ok": True, "frames": slam.n_img,
          "H": slam.H, "W": slam.W, "grids": grids,
          "iters_first": SLICE_ITERS_FIRST,
          "tracking_ms_per_frame": t.get("tracking_ms_per_frame"),
          "mapping_ms_per_event": t.get("mapping_ms_per_event"),
          "coarse_mapping_ms_per_event": t.get("coarse_mapping_ms_per_event"),
          "mapping_ms_per_iter": 1e3 * t["mapping_s"] / iters["mapping"],
          "coarse_mapping_ms_per_iter":
              1e3 * t["coarse_mapping_s"] / iters["coarse_mapping"],
          "tracking_ms_per_iter":
              t["tracking_ms_per_frame"] / slam.tcfg.iters,
          "mapping_iters": iters, "tracking_iters": track_iters,
          "fps": t.get("fps"), "total_s": t.get("total_s"),
          "mapping_events": t["mapping_events"],
          "coarse_mapping_events": t["coarse_mapping_events"],
          "tracked_frames": t["tracked_frames"],
          "ate_cm": 100 * ate_rmse(est, slam.gt_c2w_list),
          "launches": counts,
          "launches_per_tracking_iter": counts["trilinear_bwd_dp"] / track_iters,
          "k2_launches_per_mapping_iter": counts["trilinear_bwd_dgrid"] / map_iters})
    return counts


def phase_quality(dev):
    from nice_slam_torch.slam.slam import NiceSLAM
    from nice_slam_torch.tools.eval_ate import ate_rmse
    from nice_slam_torch.tools.workloads import box_quality_cfg

    cfg = box_quality_cfg(os.path.join(HERE, "output", "chip_smoke", "quality"))
    slam = NiceSLAM(cfg, argparse.Namespace(nice=True, output=None), dev)
    slam.run()
    ate = 100 * ate_rmse(slam.estimate_c2w_list.cpu().numpy(), slam.gt_c2w_list)
    ok = ate <= ATE_GATE_CM
    emit({"phase": "quality", "ok": ok, "frames": 30, "ate_rmse_cm": ate,
          "gate_cm": ATE_GATE_CM, "fps": slam.timings.get("fps")})
    if not ok:
        raise AssertionError(f"tracked ATE {ate:.3f} cm above the {ATE_GATE_CM} cm gate")


# kernel -> (TPU-side code it replaces, the case its line reports: K1 at
# the fine grid's mapping shape, K2 and K3 at their captured main-path
# launches)
KERNEL_META = {
    "trilinear_fwd": ("nice_slam_tpu/ops/interp.py:141", "fine_map"),
    "trilinear_bwd_dgrid": ("nice_slam_tpu/ops/interp.py:186", "map_color"),
    "trilinear_bwd_dp": ("nice_slam_tpu/ops/interp.py:321", "track"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    dev = torch.device("cuda")
    card = smi()
    try:
        phase_build()
        cases = phase_capture(dev)
        rows = phase_kernels(dev, cases)
        counts = phase_slice(dev)
        phase_quality(dev)
    except Exception:  # any phase failure fails the run, with its traceback
        traceback.print_exc()
        return 1
    kernels = []
    for name, (replaces, case) in KERNEL_META.items():
        r = next(r for r in rows if r["kernel"] == name and r["case"] == case)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "nice_slam_torch/csrc/trilinear.cu", "replaces": replaces,
            "case": case, "launches": counts[name],
            "max_abs_err": max(x["max_abs_err"] for x in rows if x["kernel"] == name),
            "ms": r["ms"], "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
