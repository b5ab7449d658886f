"""Readings of the comparison at a cell's own size, on the card, several
seeds in one process: the system as it is, the control (the reference
computed in TF32 in the system's place) and each planted fault of
``faults.py``.  One JSON line per run: the numbers, ``correct``, and for
the control the system's own numbers of the same blocks.

    python3 slambench/tests/card_readings.py --workload imap_replica.strict \\
        --seconds 10 --seeds 11,12,13 --modes control,state_unchanged,half_batch

From the checkout's root.  The window may be short: it has only to hold
the blocks the comparison keeps.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--modes", required=True,
                    help="comma-separated: system, control or a fault of faults.py")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from slambench import harness
    from slambench.tests import faults

    if not torch.cuda.is_available():
        print("card_readings: needs a CUDA device", file=sys.stderr)
        return 3
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for mode in args.modes.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            undo = []

            def patch(owner, name, value):
                undo.append((owner, name, getattr(owner, name)))
                setattr(owner, name, value)

            rec = {"mode": mode, "seed": seed}
            try:
                if mode not in ("system", "control"):
                    faults.plant(mode, patch)
                run = harness.Run(args.workload, seed, args.seconds, False, "cuda:0", bench,
                                  time.perf_counter(), control=mode == "control")
                out = run.execute()
                j = out["judged"]
                rec.update(correct=j["correct"], complete=j["complete"], numbers=j["numbers"],
                           limits=run.conf["limits"], fps=out["e2e"].get("fps"),
                           peak=out["peak"])
                if "system_numbers" in j:
                    rec["system_numbers"] = j["system_numbers"]
            except Exception as e:  # noqa: BLE001  (a run that crashes gives no number)
                rec["error"] = repr(e)[:500]
            finally:
                for owner, name, value in reversed(undo):
                    setattr(owner, name, value)
                gc.collect()
                torch.cuda.empty_cache()
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
