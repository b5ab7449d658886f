"""Tracking operating envelope: ATE against per-frame camera motion; the
port's counterpart of the JAX package's ``tools/track_envelope.py``.

Sweeps the synthetic orbit's per-frame angular motion and runs full
tracked SLAM (no ground-truth camera) at each level, reporting the ATE
RMSE: where the default 10-iteration tracking budget diverges
(reference budget: configs/nice_slam.yaml:40-42), and what the opt-in
coarse-to-fine LR schedule (``tracking: {cf_iters, cf_lr_mult}``,
slam/tracker.py) buys on top.

CLI:
  python -m nice_slam_torch.tools.track_envelope \\
      [--frames 20] [--deg 0.5,1,1.5,2,2.5,3] [--cf_iters 5] [--cf_mult 5] \\
      [--record FILE] [--device cuda|cpu]

Prints one JSON line per (motion, mode) with ate_rmse_cm.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def base_cfg() -> Dict[str, Any]:
    """configs/Synthetic/box.yaml on nice_slam.yaml with the envelope's
    edits: coarse mapper off, no intermediate meshes or checkpoints, no
    eval_rec mesh, a first mapping of 400 iterations; the pretrained
    decoders' paths resolved against the repo."""
    from nice_slam_torch.config import load_config

    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "nice_slam.yaml"))
    cfg["coarse"] = False
    cfg["verbose"] = False
    cfg["mapping"]["mesh_freq"] = 10 ** 6
    cfg["mapping"]["ckpt_freq"] = 10 ** 6
    cfg["meshing"]["eval_rec"] = False
    cfg["mapping"]["iters_first"] = 400
    cfg["pretrained_decoders"] = {k: os.path.join(ROOT, v) if v else v
                                  for k, v in cfg["pretrained_decoders"].items()}
    return cfg


def once_cfg(cfg_base: Dict[str, Any], frames: int, deg_per_frame: float,
             out_dir: str, cf: Optional[Tuple[int, float]] = None) -> Dict[str, Any]:
    """One sweep point's config: ``frames`` frames of an orbit turning
    ``deg_per_frame`` degrees per frame, optionally with the coarse-to-fine
    schedule ``cf = (cf_iters, cf_lr_mult)``."""
    cfg = copy.deepcopy(cfg_base)
    cfg["data"]["n_frames"] = frames
    cfg["data"]["orbit_radians"] = math.radians(deg_per_frame) * frames
    cfg["data"]["output"] = out_dir
    if cf is not None:
        cfg["tracking"]["cf_iters"] = cf[0]
        cfg["tracking"]["cf_lr_mult"] = cf[1]
    return cfg


def run_once(cfg_base, frames, deg_per_frame, out_dir, cf=None, device="cuda") -> float:
    """Run one sweep point; returns its ATE RMSE in metres."""
    from nice_slam_torch.slam.slam import NiceSLAM
    from nice_slam_torch.tools.eval_ate import align

    cfg = once_cfg(cfg_base, frames, deg_per_frame, out_dir, cf)
    args = argparse.Namespace(nice=True, input_folder=None, output=None)
    slam = NiceSLAM(cfg, args, device=device)
    slam.run()
    gt = slam.gt_c2w_list[:frames, :3, 3].T.astype(np.float64)
    est = slam.estimate_c2w_list[:frames, :3, 3].cpu().numpy().T.astype(np.float64)
    _, _, err = align(est, gt)
    return float(np.sqrt(np.mean(err ** 2)))


def record(path: str, frames: int, cf_iters: int, cf_mult: float,
           rows: List[Dict[str, Any]]) -> None:
    """Merge the rows into the JSON book ``path`` under 'envelope' (other
    keys kept), with an atomic replace: a reader never sees a partial
    file."""
    book = {}
    if os.path.exists(path):
        with open(path) as f:
            book = json.load(f)
    book["envelope"] = {"frames": frames, "cf_iters": cf_iters,
                        "cf_lr_mult": cf_mult, "rows": rows}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(book, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--deg", type=str, default="0.5,1.0,1.5,2.0,2.5,3.0",
                   help="comma-separated per-frame motions (degrees)")
    p.add_argument("--cf_iters", type=int, default=5)
    p.add_argument("--cf_mult", type=float, default=5.0)
    p.add_argument("--out", type=str, default="output/envelope")
    p.add_argument("--skip_cf", action="store_true")
    p.add_argument("--record", type=str, default=None,
                   help="write the envelope rows into this JSON file under key "
                        "'envelope'")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None) -> List[Dict[str, Any]]:
    """The sweep for the flags ``argv``; returns the rows."""
    args = parser().parse_args(argv)
    cfg = base_cfg()
    rows = []
    for deg in [float(x) for x in args.deg.split(",")]:
        modes = [("default", None)]
        if not args.skip_cf:
            modes.append(("cf", (args.cf_iters, args.cf_mult)))
        for name, cf in modes:
            out = os.path.join(args.out, f"{name}_{deg:g}")
            ate = run_once(cfg, args.frames, deg, out, cf, device=args.device)
            row = {"deg_per_frame": deg, "mode": name,
                   "ate_rmse_cm": round(ate * 100, 2)}
            rows.append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps({"envelope": rows}))
    if args.record:
        record(args.record, args.frames, args.cf_iters, args.cf_mult, rows)
    return rows


if __name__ == "__main__":
    main()
