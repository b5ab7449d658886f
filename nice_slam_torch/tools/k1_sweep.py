"""K1, the trilinear lookup, against the designs it was chosen over.

    python -m nice_slam_torch.tools.k1_sweep [--rounds 2] [--out FILE]

Builds ``k1_sweep.cu`` (the register-walk design and the shipped kernel
with L at run time; see its header) beside the port's own
``csrc/trilinear.cu``, captures the main-path lookups as
``chip_smoke.py`` does (one tracking iteration's and one color-stage
mapping iteration's over the middle, fine and color grids, one
coarse-mapping iteration's over the coarse grid, a mesher chunk's 500k
lattice points over the middle and fine grids and a render chunk's 4.8M
ray samples over three grids) and makes the smoke's three random-ray
cases, then for every case holds each variant against
``trilinear_fwd_multi_plain`` at 1e-5 and takes its ``device_ms`` as the
smoke does (torch.profiler, the kernel's own time per lookup, the L2
evicted before each call).  Variants:

  per_grid       the shipped kernel, one launch per grid (the launch
                 pattern before one launch per stage)
  shipped        ``trilinear_fwd_multi``: one launch over the stage's grids
  runtime_L      ``shipped`` with L a run-time argument
  walk_auto      the register walk, per_team halved from L until the launch
                 has 8 warps per SM, 128-thread blocks
  walk_ptK       the register walk with per_team = K
  *_minb4        capped at 128 registers (4 blocks of 128 per SM)
  walk_auto_t256 256-thread blocks

Variants are timed in turn, ``--rounds`` times over.  Prints one JSON line
per case (``device_ms``: variant -> one time per round), then one with
the registers ptxas gave each variant and the card's name and power
limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
SOURCE = os.path.join(HERE, "k1_sweep.cu")
WALK_LANES = 8          # L at the main path's C = 32
WALK_WARPS_PER_SM = 8   # what walk_auto's per_team aims the launch at

# name -> (kernel name the profiler matches, how the lookup is made)
VARIANTS = {
    "per_grid": ("trilinear_fwd_kernel", ("per_grid",)),
    "shipped": ("trilinear_fwd_kernel", ("shipped",)),
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
    lib.k1_walk.restype = lib.k1_runtime_l.restype = ctypes.c_int
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


def lookup(lib, how, grids, p, sms):
    """One K1 lookup of ``grids`` at ``p`` by the variant ``how``."""
    import torch

    from nice_slam_torch.ops import interp, kernels

    if how[0] == "per_grid":
        return [interp.trilinear_fwd(g, p) for g in grids]
    if how[0] == "shipped":
        return interp.trilinear_fwd_multi(grids, p)
    n, C = p.shape[0], grids[0].shape[3]
    outs = [torch.empty((n, C), dtype=torch.float32, device=p.device) for _ in grids]
    desc = []
    for grid, out in zip(grids, outs):
        desc += [grid.data_ptr(), out.data_ptr(), *grid.shape[:3]]
    desc = (ctypes.c_longlong * len(desc))(*desc)
    stream = torch.cuda.current_stream().cuda_stream
    if how[0] == "runtime_l":
        rc = lib.k1_runtime_l(desc, len(grids), p.data_ptr(), n, C, stream)
    else:
        _, per_team, block, min_blocks = how
        rc = lib.k1_walk(desc, len(grids), p.data_ptr(), n, C,
                         per_team or auto_per_team(n, sms), block, min_blocks, stream)
    kernels.check(rc, how[0])
    return outs


def bound_ms(grids, p, hbm_bytes_per_s: float) -> float:
    """The smoke's K1 bound: the points, each grid's touched rows and each
    (n, C) output, each moved once, over the HBM rate."""
    import torch

    from nice_slam_torch.ops import interp

    n = p.shape[0]
    moved = n * 3 * 4
    for grid in grids:
        i0, i1, _, _ = interp._corners(grid.shape, p)
        touched = torch.unique(torch.cat(interp._corner_rows(grid.shape, i0, i1))).numel()
        moved += (touched + n) * grid.shape[3] * 4
    return 1e3 * moved / hbm_bytes_per_s


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
    from nice_slam_torch.ops import interp

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib, log = build()
    captured, lookups = chip_smoke.phase_capture(dev)
    cases = {k: (v["grids"], v["p"]) for k, v in {**captured, **lookups}.items()}
    gen = torch.Generator().manual_seed(0)  # the smoke's random cases, in its order
    for label, shape, n_rays in (("fine_map", (74, 56, 43, 32), 1000),
                                 ("fine_track", (74, 56, 43, 32), 200),
                                 ("coarse_map", (11, 8, 7, 32), 1000)):
        grid = torch.randn(shape, generator=gen).to(dev)
        p = chip_smoke.ray_points(n_rays, gen, dev)
        torch.randn((p.shape[0], shape[3]), generator=gen)  # the smoke's cotangent
        cases[label] = ([grid], p)

    lines = []
    for label, (grids, p) in cases.items():
        ref = interp.trilinear_fwd_multi_plain(grids, p)
        errs = {}
        for name, (_, how) in VARIANTS.items():
            got = lookup(lib, how, grids, p, sms)
            errs[name] = max(float((a - b).abs().max()) for a, b in zip(got, ref))
            if not errs[name] <= 1e-5:
                raise AssertionError(f"{name} {label}: max abs err {errs[name]} > 1e-5")
        times = {name: [] for name in VARIANTS}
        for _ in range(args.rounds):
            for name, (match, how) in VARIANTS.items():
                times[name].append(chip_smoke.device_time_ms(
                    lambda: lookup(lib, how, grids, p, sms), match,
                    per_call=len(grids) if how[0] == "per_grid" else 1))
        line = {"case": label, "n": p.shape[0], "grids": [list(g.shape) for g in grids],
                "bound_ms": bound_ms(grids, p, chip_smoke.HBM_BYTES_PER_S),
                "walk_auto_per_team": auto_per_team(p.shape[0], sms),
                "device_ms": times, "max_abs_err": errs}
        chip_smoke.emit(line)
        lines.append(line)
    tail = {"card": chip_smoke.smi(), "sms": sms, "registers": registers(log),
            "profiler_retries": chip_smoke.PROFILER_RETRIES["windows"]}
    chip_smoke.emit(tail)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"cases": lines, **tail}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
