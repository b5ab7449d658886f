"""The frustum mask (K10) of one checkout's port, timed on the card on the
main path's captured frustum call, for before/after runs of a K10 change
on one card.

    python nice_slam_torch/tools/frustum_ab.py --capture call.pt
    python nice_slam_torch/tools/frustum_ab.py --cases call.pt --label change \\
        --masks change.pt
    PYTHONPATH=OTHER python nice_slam_torch/tools/frustum_ab.py --cases call.pt \\
        --label parent --masks parent.pt
    python nice_slam_torch/tools/frustum_ab.py --diff parent.pt change.pt

``--capture`` records the arguments of the first frustum call of the main
path (``chip_smoke.phase_capture``: a 2-frame run of the Replica-scale
room, its middle, fine and color grids and a 680x1200 depth frame) to a
file, so every timed run gets the same inputs.  ``--cases`` loads them and
runs the ``frustum_masks`` of the port that ``import`` finds first
(``PYTHONPATH=DIR``: another checkout, e.g. the parent unpacked with ``git
archive``), with this checkout's timing helpers (``chip_smoke.py``):
K10's launches a call, device ms of all of them and of each kernel
(torch.profiler, the L2 evicted before each call), ms (CUDA events around
20 calls), the wrapper's host microseconds a call (100 calls on the host
clock, no synchronize inside), the bound both ways (two passes over every
grid's mask; one pass over the distinct grids), and K10's resources;
``--masks`` saves the masks.  ``--diff A B`` counts the nodes whose mask
differs between two saved runs.  Run parent, change, change, parent in
one call: times of two calls are not comparable.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM


def _smoke():
    """This checkout's chip_smoke.py, whichever port is first on the path."""
    spec = importlib.util.spec_from_file_location("frustum_ab_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_us(fn, calls: int = 100, rounds: int = 3):
    """Host microseconds per call of ``fn`` (enqueueing only: no synchronize
    between the calls), after a warm-up; one figure per round."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return out


def run_cases(path: str, label: str, masks_out) -> dict:
    import torch

    smoke = _smoke()
    from nice_slam_torch.ops import frustum as Fm

    dev = torch.device("cuda", 0)
    args = tuple(x.to(dev) if torch.is_tensor(x) else x
                 for x in torch.load(path, weights_only=False))
    _, depth, _, shapes, H, W = args[:6]
    fn = lambda: Fm.frustum_masks(*args)  # noqa: E731
    Fm.reset_launch_counts()
    masks = fn()
    torch.cuda.synchronize()
    launched = {k: v for k, v in Fm.launch_counts.items() if v}
    per_call = sum(launched.values())
    if masks_out:
        torch.save([m.cpu() for m in masks], masks_out)
    nodes = [a * b * c for a, b, c in shapes]
    distinct = [a * b * c for a, b, c in sorted(set(map(tuple, shapes)))]
    img = H * W * 4
    line = {"label": label, "port": os.path.dirname(os.path.dirname(Fm.__file__)),
            "card": smoke.smi(), "inputs": path, "shapes": [list(s) for s in shapes],
            "nodes": sum(nodes), "distinct_nodes": sum(distinct),
            "launches_per_call": launched,
            "device_ms": smoke.device_time_ms(fn, "frustum", per_call=per_call),
            "device_ms_by_kernel": {
                k: smoke.device_time_ms(fn, k + "_kernel") for k in
                ("frustum_depth_max", "frustum_mask") if k in Fm.launch_counts},
            "ms": smoke.cuda_time_ms(fn), "host_us": host_us(fn),
            # two passes (the depth image each, every grid's mask once, the
            # maxima) and one (the depth image once, each distinct mask once)
            "bound_ms_two_passes": (2 * img + 4 * len(shapes) + 4 * sum(nodes))
            / HBM_BYTES_PER_S * 1e3,
            "bound_ms_one_pass": (img + 4 * sum(distinct)) / HBM_BYTES_PER_S * 1e3}
    if hasattr(Fm, "frustum_geometry"):
        info = Fm.frustum_kernel_info(dev)
        geo = Fm.frustum_geometry(distinct, torch.cuda.get_device_properties(dev)
                                  .multi_processor_count, info["ctas_per_sm"])
        line["resources"] = {**info, **geo._asdict()}
    else:
        line["resources"] = {k: Fm.frustum_kernel_info(k, dev)
                             for k in ("frustum_depth_max", "frustum_mask")}
    line["depth_max"] = float(depth.max())
    return line


def diff(a: str, b: str) -> dict:
    import torch

    ma, mb = torch.load(a), torch.load(b)
    per = [int(((x[..., 0] > 0) != (y[..., 0] > 0)).sum()) for x, y in zip(ma, mb)]
    bits = [int((x.view(torch.int32) != y.view(torch.int32)).sum()) for x, y in zip(ma, mb)]
    return {"diff": [a, b], "nodes_differing": per, "values_not_bitwise_equal": bits,
            "nodes": [x[..., 0].numel() for x in ma]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--capture", help="record the main path's frustum call to this file")
    mode.add_argument("--cases", help="check and time the call recorded in this file")
    mode.add_argument("--diff", nargs=2, help="count the nodes two saved runs' masks differ on")
    ap.add_argument("--label", default="", help="a name for this run's lines")
    ap.add_argument("--masks", help="save this run's masks to this file")
    ap.add_argument("--out", help="append every line to this JSON-lines file")
    args = ap.parse_args(argv)
    sys.path.append(ROOT)  # after PYTHONPATH: the port under test comes first
    if args.diff:
        line = diff(*args.diff)
    else:
        import torch

        if not torch.cuda.is_available():
            print("frustum_ab: no CUDA device available", file=sys.stderr)
            return 1
        if args.capture:
            smoke = _smoke()
            call = smoke.phase_capture(torch.device("cuda", 0))[0]["k7_k10"]["frustum"]
            torch.save(tuple(x.cpu() if torch.is_tensor(x) else x for x in call), args.capture)
            return 0
        line = run_cases(args.cases, args.label, args.masks)
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
