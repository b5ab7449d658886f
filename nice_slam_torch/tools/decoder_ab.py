"""The decoder kernels (K4, K5, K6) of one checkout's port, checked and
timed on the card on the main path's decoder-stage calls, for
before/after runs of a kernel change on one card.

    python nice_slam_torch/tools/decoder_ab.py --capture cases.pt
    python nice_slam_torch/tools/decoder_ab.py --cases cases.pt --label change
    PYTHONPATH=OTHER python nice_slam_torch/tools/decoder_ab.py --cases cases.pt \\
        --label parent

``--capture`` records the arguments of every K5 call of the main path
(``chip_smoke.phase_capture``: tracking, mapping's middle, fine and color
stages, the coarse mapper; a 2-frame run of the Replica-scale room) to a
file, so every timed run gets the same inputs.  ``--cases`` loads them
and runs ``chip_smoke.decoder_rows`` on each: the smoke's kernels-phase
rows and gates, with the port and the ``chip_smoke.py`` that ``import``
finds first (``PYTHONPATH=DIR``: another checkout, e.g. the parent
unpacked with ``git archive``, is checked by its own smoke).  Run parent,
change, change, parent in one call: times of two calls are not
comparable.

``--ray_dp N`` instead runs the smoke's ray data-parallel check
(``chip_smoke.data_parallel_checks``: a mapping call with its rays over two
replicas against one device, per-iteration losses within 1e-4 relative) N
times on one capture and prints each draw's largest relative loss
difference: the replicas sum K6's partials over other tile splits, and K2
sums with atomics, so the draws spread.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--capture", help="record the main path's K5 calls to this file")
    mode.add_argument("--cases", help="check and time the calls recorded in this file")
    mode.add_argument("--ray_dp", type=int,
                      help="run the ray data-parallel check this many times")
    ap.add_argument("--label", default="", help="a name for this run's lines")
    ap.add_argument("--out", help="append every line to this JSON-lines file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("decoder_ab: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.append(ROOT)  # after PYTHONPATH: the port under test comes first
    import chip_smoke
    from nice_slam_torch.ops import decoder_stage as DS

    dev = torch.device("cuda", 0)
    if args.ray_dp:
        cap = chip_smoke.phase_capture(dev)[2]
        draws = [chip_smoke.data_parallel_checks(dev, cap)["loss_max_rel_diff"]
                 for _ in range(args.ray_dp)]
        chip_smoke.emit({"label": args.label, "card": chip_smoke.smi(),
                         "ray_dp_loss_max_rel_diff": draws})
        return 0
    if args.capture:
        cases = chip_smoke.phase_capture(dev)[0]["decoder"]
        torch.save({k: {kk: (vv.cpu() if torch.is_tensor(vv) else
                             [x.cpu() for x in vv] if kk in ("feats", "weights") else vv)
                        for kk, vv in v.items()} for k, v in cases.items()}, args.capture)
        return 0
    raw = torch.load(args.cases, weights_only=False)
    cases = {k: {kk: (vv.to(dev) if torch.is_tensor(vv) else
                      [x.to(dev) for x in vv] if kk in ("feats", "weights") else vv)
                 for kk, vv in v.items()} for k, v in raw.items()}
    head = {"label": args.label, "port": os.path.dirname(os.path.dirname(DS.__file__)),
            "smoke": chip_smoke.__file__, "card": chip_smoke.smi(), "inputs": args.cases}
    chip_smoke.emit(head)
    lines = [head]
    for label in chip_smoke.DEC_CASES:
        for row in chip_smoke.decoder_rows(label, cases[label]):
            lines.append(dict(row, label=args.label))
            chip_smoke.emit(lines[-1])
    if args.out:
        with open(args.out, "a") as f:
            for ln in lines:
                f.write(json.dumps(ln) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
