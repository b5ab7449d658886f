"""Run one cell of the benchmark once and print its result line.

    python3 slambench/run.py --workload nice_tum.strict --seed 7 --seconds 51 --trace 0

From the checkout's root.  Needs an NVIDIA card (it never falls back to
the CPU).  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and with
``--trace 1`` ``breakdown``), then ``compared``: each number the
comparison read beside its limit; the same numbers end standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="put the reference computed in TF32 in the system's place")
    args = ap.parse_args(argv)

    # every build and kernel cache inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", "slambench", sub)
    sys.path.insert(0, ROOT)
    bench_path = os.path.join(ROOT, "BENCHMARK.json")
    try:
        with open(bench_path) as f:
            bench = json.load(f)
        import torch
        import nice_slam_torch  # noqa: F401  (the system under test)
    except Exception as e:  # noqa: BLE001
        print(f"slambench: cannot start: {e!r}", file=sys.stderr)
        return 2
    chips = next((w["chips"] for w in bench["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        print(f"slambench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"slambench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3

    from slambench import harness

    run = harness.Run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                      bench, T_START, control=args.control)
    out = run.execute()
    if out["found"] or harness.forbidden_modules():
        print("slambench: loaded modules it must not: "
              + ", ".join(out["found"] or harness.forbidden_modules()), file=sys.stderr)
        return 4
    line = harness.result_line(run, out, bench)
    print("poses " + json.dumps(out["e2e"].get("_pose_err")), file=sys.stderr)
    for b in out["judged"]["blocks"]:
        print("block " + json.dumps(b), file=sys.stderr)
    if "system_numbers" in out["judged"]:
        print("system " + json.dumps(out["judged"]["system_numbers"]), file=sys.stderr)
    for k, v in out["judged"]["numbers"].items():
        if k not in line["compared"]:
            print(f"reported {k} {v!r} (not compared)", file=sys.stderr)
    for k, v in line["compared"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
