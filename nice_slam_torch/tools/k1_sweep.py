"""K1, the trilinear lookup, against the designs it was chosen over.

    python -m nice_slam_torch.tools.k1_sweep [--rounds 2] [--out FILE]

Builds ``k1_sweep.cu`` (the K1 the port shipped before its own, the
register walk and a run-time-L K1; see its header) beside the port's own
``csrc/trilinear.cu``, and takes every K1 case of ``chip_smoke.py``: the
captured main-path lookups (one tracking iteration's and one color-stage
mapping iteration's over the middle, fine and color grids, one
coarse-mapping iteration's over the coarse grid, a mesher chunk's 500k
lattice points over the middle and fine grids, a render chunk's 4.8M ray
samples over three grids), the smoke's three random-ray cases, the
pretrainer's first coarse and fine steps, and the D = 4 slab launch owning
the most points of the smoke's sharded cases.  For every case it holds
each variant against ``trilinear_fwd_multi_plain`` at 1e-5 and the port's
K1 against the baseline bit for bit, then takes each variant's
``device_ms`` as the smoke does (torch.profiler, the kernel's own time per
lookup, the L2 evicted before each call), the variants in turn and in
reverse order on every other round.  Each call reads its own copy of the
grids, cycled through enough copies that the rows a call touches were
last read ~150 MB of touched rows earlier.  Variants:

  baseline       the K1 the port shipped before: one thread per (grid,
                 point, float4), one launch round after another
  shipped        ``trilinear_fwd_multi``: the port's K1 as built
  per_grid       the port's K1, one launch per grid
  runtime_L      baseline with L a run-time argument (no slab window)
  walk_*         the register walk (no slab window): walk_auto halves
                 per_team from L until the launch has 8 warps per SM,
                 128-thread blocks; walk_ptK per_team = K; *_minb4 capped
                 at 128 registers; walk_auto_t256 256-thread blocks

Prints one JSON line per case (``device_ms``: variant -> one time per
round; ``write_ms``: the device time of writing the case's features with
nothing computed, k1_sweep.cu's k1_write, the store floor), then one with
each variant's K1 time summed over a tracked frame, a mapping call, a
680x1200 render and a resolution-256 mesh at the main path's launch
counts (``ITEM_LAUNCHES``), its worst ratio to the baseline over the
cases and its largest spread over the rounds; whether the port's K1 is
no more than 3 % slower than the baseline at every case; the port's K1's
compiled resources; the host time of one K1 call at the tracking case
and of its launch geometry; and the card's name and power limit.  Needs
a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import itertools
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
SOURCE = os.path.join(HERE, "k1_sweep.cu")
WALK_LANES = 8          # L at the main path's C = 32
WALK_WARPS_PER_SM = 8   # what walk_auto's per_team aims the launch at
COPY_BYTES = 150 << 20  # touched grid rows read between two calls on one copy
COPIES_AT_MOST = 4 << 30  # bytes of grid copies per case
SLOWER_AT_MOST = 1.03   # the rule: no case more than 3 % slower than the baseline
# K1 launches per item of the main path (PERF.md's kernel table): a tracked
# frame (10 tracking iterations), a mapping call (60 iterations, each taken
# as the color stage's three-grid lookup: an upper bound, its middle and
# fine stages look up fewer grids), a 680x1200 render (9 ray chunks) and a
# resolution-256 mesh (35 lattice chunks)
ITEM_LAUNCHES = {"track": 10, "map_color": 60, "render_color": 9, "mesh_fine": 35}

# name -> (kernel name the profiler matches, how the lookup is made)
VARIANTS = {
    "baseline": ("k1_baseline_kernel", ("baseline",)),
    "shipped": ("trilinear_fwd_kernel", ("shipped",)),
    "per_grid": ("trilinear_fwd_kernel", ("per_grid",)),
    "runtime_L": ("k1_runtime_l_kernel", ("runtime_l",)),
    "walk_auto": ("k1_walk_kernel", ("walk", None, 128, 1)),
    "walk_pt1": ("k1_walk_kernel", ("walk", 1, 128, 1)),
    "walk_pt2": ("k1_walk_kernel", ("walk", 2, 128, 1)),
    "walk_pt4": ("k1_walk_kernel", ("walk", 4, 128, 1)),
    "walk_pt8": ("k1_walk_kernel", ("walk", 8, 128, 1)),
    "walk_auto_minb4": ("k1_walk_kernel", ("walk", None, 128, 4)),
    "walk_pt2_minb4": ("k1_walk_kernel", ("walk", 2, 128, 4)),
    "walk_auto_t256": ("k1_walk_kernel", ("walk", None, 256, 1)),
}
# variants that take a slab window (the others skip the slab cases)
WINDOWED = ("baseline", "shipped")


def auto_per_team(n: int, sms: int) -> int:
    """walk_auto's points per team: halved from L while the launch has
    fewer than WALK_WARPS_PER_SM warps per SM (a warp walks 32 / L teams'
    runs of per_team points)."""
    per_team = WALK_LANES
    while per_team > 1 and -(-n // (32 // WALK_LANES * per_team)) < sms * WALK_WARPS_PER_SM:
        per_team //= 2
    return per_team


def build():
    """Compile k1_sweep.cu (it includes csrc/trilinear.cu) with the port's
    nvcc flags, alongside the port's own library; returns the loaded
    library and ptxas's log."""
    from nice_slam_torch.ops import kernels

    h = hashlib.sha256()
    for path in (SOURCE, os.path.join(kernels.CSRC, "trilinear.cu")):
        with open(path, "rb") as f:
            h.update(f.read())
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    so = os.path.join(kernels.BUILD_DIR, f"libk1_sweep-{h.hexdigest()[:16]}.so")
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", tmp, SOURCE],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    kernels.library("trilinear")  # the port's build, meanwhile
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for k1_sweep.cu:\n{log}")
    os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    d, i, v = ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p
    lib.k1_walk.argtypes = [d, i, v, i, i, i, i, i, v]
    lib.k1_runtime_l.argtypes = [d, i, v, i, i, v]
    lib.k1_baseline.argtypes = [d, i, v, i, i, v]
    lib.k1_write.argtypes = [v, i, i, v]
    for fn in (lib.k1_walk, lib.k1_runtime_l, lib.k1_baseline, lib.k1_write):
        fn.restype = ctypes.c_int
    return lib, log


def registers(log: str) -> dict:
    """ptxas's register and spill lines per K1 kernel of the build log."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif name and ("fwd" in name or "k1_" in name) and (
                "registers" in ln or "spill" in ln):
            out.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return out


def lookup(lib, how, grids, p, windows, sms):
    """One K1 lookup of ``grids`` (with their slab ``windows``, None:
    dense) at ``p`` by the variant ``how``."""
    import torch

    from nice_slam_torch.ops import interp, kernels

    if how[0] == "per_grid":
        return [interp.trilinear_fwd(g, p) for g in grids]
    if how[0] == "shipped":
        return interp.trilinear_fwd_multi(grids, p, windows)
    n, C = p.shape[0], grids[0].shape[3]
    outs = [torch.empty((n, C), dtype=torch.float32, device=p.device) for _ in grids]
    stream = torch.cuda.current_stream().cuda_stream
    desc = []
    if how[0] in WINDOWED:
        ws = windows or [interp.dense_window(g.shape[0]) for g in grids]
        for grid, out, w in zip(grids, outs, ws):
            desc += interp._desc(grid, out, grid.shape, w)
    else:
        for grid, out in zip(grids, outs):
            desc += [grid.data_ptr(), out.data_ptr(), *grid.shape[:3]]
    desc = (ctypes.c_longlong * len(desc))(*desc)
    if how[0] == "baseline":
        rc = lib.k1_baseline(desc, len(grids), p.data_ptr(), n, C, stream)
    elif how[0] == "runtime_l":
        rc = lib.k1_runtime_l(desc, len(grids), p.data_ptr(), n, C, stream)
    else:
        _, per_team, block, min_blocks = how
        rc = lib.k1_walk(desc, len(grids), p.data_ptr(), n, C,
                         per_team or auto_per_team(n, sms), block, min_blocks, stream)
    kernels.check(rc, how[0])
    return outs


def touched_bytes(grids, p, windows) -> int:
    """The grid (or slab) rows a lookup touches, in bytes."""
    import torch

    from nice_slam_torch.ops import interp

    total = 0
    for grid, w in zip(grids, windows or [None] * len(grids)):
        i0, i1, _, _, own = interp._slab_corners(grid.shape, w, p)
        rows = interp._corner_rows(grid.shape, i0, i1)
        if own is not None:
            rows = [r[own] for r in rows]
        total += torch.unique(torch.cat(rows)).numel() * grid.shape[3] * 4
    return total


def bound_ms(grids, p, windows, hbm_bytes_per_s: float) -> float:
    """The smoke's K1 bound: the points, the touched rows and each (n, C)
    output, each moved once, over the HBM rate."""
    n = p.shape[0]
    moved = n * 3 * 4 + touched_bytes(grids, p, windows) + n * grids[0].shape[3] * 4 * len(grids)
    return 1e3 * moved / hbm_bytes_per_s


def sweep_cases(dev):
    """Every K1 case of chip_smoke.py: label -> (grids, points, windows)."""
    import torch

    import chip_smoke
    from nice_slam_torch.parallel import grid_sharding as gs
    from nice_slam_torch.tools import pretrain_decoders as P

    captured, lookups, _ = chip_smoke.phase_capture(dev)
    captured.pop("decoder")
    cases = {k: (v["grids"], v["p"], None) for k, v in {**captured, **lookups}.items()}
    gen = torch.Generator().manual_seed(0)  # the smoke's random cases, in its order
    for label, shape, n_rays in chip_smoke.RANDOM_CASES:
        grid = torch.randn(shape, generator=gen).to(dev)
        p = chip_smoke.ray_points(n_rays, gen, dev)
        torch.randn((p.shape[0], shape[3]), generator=gen)  # the smoke's cotangent
        cases[label] = ([grid], p, None)
    seen, restore = chip_smoke.pretrain_captures()
    try:
        P.pretrain(1, 1, chip_smoke.PRETRAIN_SAMPLES, seed=0, device=dev, verbose=False)
    finally:
        restore()
    for name in ("pretrain_coarse", "pretrain_fine"):
        cases[name] = (seen["fwd_" + name]["grids"], seen["fwd_" + name]["p"], None)
    for label in chip_smoke.SHARD_CASES:  # the slab owning the most points
        grids, p, _ = cases[label]
        sharded = [gs.shard_grid(g, [dev] * 4) for g in grids]

        def owned(d):
            return chip_smoke.slab_bytes([sg.slabs[d] for sg in sharded],
                                         [sg.window(d) for sg in sharded], p)[0][0]
        d = max(range(4), key=owned)
        cases[f"{label}_D4"] = ([sg.slabs[d] for sg in sharded], p,
                                [sg.window(d) for sg in sharded])
    return cases


def summary(lines) -> dict:
    """Each variant's K1 ms summed over the main path's items (None if it
    skipped one of them), its worst ratio to the baseline and the case of
    it, and its largest spread over the rounds ((max - min) / mean); and
    whether the port's K1 is within SLOWER_AT_MOST of the baseline at
    every case."""
    mean = {ln["case"]: {k: sum(v) / len(v) for k, v in ln["device_ms"].items()}
            for ln in lines}
    out = {}
    for name in [n for n in VARIANTS if any(n in t for t in mean.values())]:
        ratios = {c: t[name] / t["baseline"] for c, t in mean.items() if name in t}
        spreads = [(max(v) - min(v)) * len(v) / sum(v) for ln in lines
                   for k, v in ln["device_ms"].items() if k == name]
        out[name] = {
            "items_ms": (sum(k * mean[c][name] for c, k in ITEM_LAUNCHES.items())
                         if all(name in mean[c] for c in ITEM_LAUNCHES) else None),
            "worst_ratio_to_baseline": max(ratios.values()),
            "worst_case": max(ratios, key=ratios.get),
            "largest_spread": max(spreads)}
    return {"variants": out,
            "shipped_within_3_percent": out["shipped"]["worst_ratio_to_baseline"]
            <= SLOWER_AT_MOST}


def host_us(fn, calls: int = 2000) -> float:
    """Host microseconds per call of ``fn`` (the card's queue drained
    before and after, so at a small case it is the host's issue time)."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", help="also write every line's object to this JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("k1_sweep: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from nice_slam_torch.ops import interp, kernels

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib, log = build()
    cases = sweep_cases(dev)

    lines = []
    for label, (grids, p, windows) in cases.items():
        names = [n for n, (_, how) in VARIANTS.items()
                 if windows is None or how[0] in WINDOWED]
        ref = interp.trilinear_fwd_multi_plain(grids, p, windows)
        base = lookup(lib, VARIANTS["baseline"][1], grids, p, windows, sms)
        errs, bitwise = {}, {}
        for name in names:
            got = lookup(lib, VARIANTS[name][1], grids, p, windows, sms)
            errs[name] = max(float((a - b).abs().max()) for a, b in zip(got, ref))
            bitwise[name] = all(torch.equal(a, b) for a, b in zip(got, base))
            if not errs[name] <= 1e-5:
                raise AssertionError(f"{name} {label}: max abs err {errs[name]} > 1e-5")
            if VARIANTS[name][1][0] in ("shipped", "per_grid") and not bitwise[name]:
                raise AssertionError(f"{name} {label}: not the baseline's features bit for bit")
        del ref, base
        # copies of the grids, cycled per call (see the module's docstring)
        grid_bytes = sum(g.numel() * 4 for g in grids)
        copies = [grids] + [[g.clone() for g in grids] for _ in range(min(
            -(-COPY_BYTES // max(1, touched_bytes(grids, p, windows))),
            COPIES_AT_MOST // grid_bytes))]
        times = {name: [] for name in names}
        for r in range(args.rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                match, how = VARIANTS[name]
                turn = itertools.cycle(copies)
                times[name].append(chip_smoke.device_time_ms(
                    lambda: lookup(lib, how, next(turn), p, windows, sms), match,
                    per_call=len(grids) if how[0] == "per_grid" else 1))
        feats = torch.empty(len(grids) * p.shape[0] * grids[0].shape[3], device=dev)
        write_ctas = interp.k1_launch_geometry(p.shape[0], len(grids), grids[0].shape[3],
                                               dev).ctas
        write_ms = [chip_smoke.device_time_ms(lambda: kernels.check(lib.k1_write(
            feats.data_ptr(), feats.numel() // 4, write_ctas,
            torch.cuda.current_stream().cuda_stream), "k1_write"), "k1_write_kernel")
            for _ in range(args.rounds)]
        del feats
        line = {"case": label, "n": p.shape[0], "grids": [list(g.shape) for g in grids],
                "write_ms": write_ms,
                "windows": [list(w) for w in windows] if windows else None,
                "copies": len(copies),
                "bound_ms": bound_ms(grids, p, windows, chip_smoke.HBM_BYTES_PER_S),
                "walk_auto_per_team": auto_per_team(p.shape[0], sms),
                "device_ms": times, "max_abs_err": errs, "bitwise_baseline": bitwise}
        chip_smoke.emit(line)
        lines.append(line)
        del copies
    grids, p, _ = cases["track"]
    n, C = p.shape[0], grids[0].shape[3]
    tail = {"summary": summary(lines), "card": chip_smoke.smi(), "sms": sms,
            "registers": registers(log), "shipped": interp.k1_kernel_info(C, dev),
            "host_us": {"trilinear_fwd_multi": host_us(
                            lambda: interp.trilinear_fwd_multi(grids, p)),
                        "k1_launch_geometry": host_us(
                            lambda: interp.k1_launch_geometry(n, len(grids), C, dev))},
            "profiler_retries": chip_smoke.PROFILER_RETRIES["windows"]}
    chip_smoke.emit(tail)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"cases": lines, **tail}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
