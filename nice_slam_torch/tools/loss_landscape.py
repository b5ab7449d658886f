"""Tracking-loss landscape probe: sweep the loss along single pose DOFs;
the port's counterpart of the JAX package's ``tools/loss_landscape.py``.

For each requested frame, evaluates the tracking loss (the
``tracking_loss_sampled`` the per-frame optimizer descends, reference
``src/Tracker.py:71-128``) on a frozen map at the ground-truth pose and
at offsets along three camera-frame DOFs:

  * ``lateral-x``  translation along the camera x axis (metres)
  * ``vertical-y`` translation along the camera y axis (metres)
  * ``yaw``        rotation about the camera y axis (radians = 2.5 * delta)

The frame's pixels are drawn once (``presample_pixels``), so every offset
is scored on the same pixels.  If the minimum over the sweep is not at
the zero offset, the tracker's fixed point is biased away from the true
pose on this map: per-frame descent converges off the ground truth
however many iterations it gets.  That separates the two failure modes
of a drifting tracked run: biased minima on a consistent map (the loss or
the render is at fault) from clean minima on a degraded map (the map
feedback is at fault; RESULTS.md 2b).  Each evaluation runs under
``torch.no_grad()``: one K1 launch, no K2 or K3.

Usage (after a selfcheck or run left a checkpoint in OUT):

  python -m nice_slam_torch.tools.loss_landscape --out OUT \\
      --frames 5 30 60 --n_frames 150 --orbit_radians 1.257 \\
      --texture hash --scene furnished --pixels 2000 [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Dict

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PIXEL_SEED = 0  # one pixel draw per frame, shared by every offset


def offset_poses(gt_c2w: np.ndarray, deltas: np.ndarray) -> Dict[str, list]:
    """The swept 4x4 poses around ``gt_c2w``, per DOF."""
    xaxis, yaxis = gt_c2w[:3, 0], gt_c2w[:3, 1]
    out = {}
    for name, axis in (("lateral-x", xaxis), ("vertical-y", yaxis)):
        poses = []
        for d in deltas:
            c = gt_c2w.copy()
            c[:3, 3] = c[:3, 3] + d * axis
            poses.append(c)
        out[name] = poses
    poses = []
    for d in deltas:
        ang = d * 2.5  # 1 cm of sweep step = 1.43 deg of yaw
        c = gt_c2w.copy()
        K = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]], np.float32)
        c[:3, :3] = c[:3, :3] @ K
        poses.append(c)
    out["yaw"] = poses
    return out


def frame_pixels(slam, i: int):
    """Frame ``i``'s ground-truth pose and one batch of ``tcfg.pixels``
    pixels (column, row, depth, colour) as device tensors."""
    from nice_slam_torch.slam.tracker import presample_pixels

    _, color, depth, gt_c2w = slam.frame_reader[i]
    tcfg = dataclasses.replace(slam.tcfg, iters=1)
    pix = presample_pixels(PIXEL_SEED, i, tcfg, np.asarray(color), np.asarray(depth))
    return np.asarray(gt_c2w, np.float32), [
        torch.as_tensor(x[0], device=slam.device) for x in pix]


def sweep_losses(slam, i: int, deltas: np.ndarray) -> Dict[str, list]:
    """The tracking loss at every swept pose around frame ``i``'s
    ground-truth pose, on one pixel draw: {dof: [loss per delta]}."""
    from nice_slam_torch.ops.geometry import tensor_from_pose
    from nice_slam_torch.slam.tracker import tracking_loss_sampled

    gt_c2w, (pi, pj, pd, pc) = frame_pixels(slam, i)

    @torch.no_grad()
    def at(c2w):
        cam = tensor_from_pose(torch.as_tensor(c2w[:3], device=slam.device))
        return float(tracking_loss_sampled(slam.spec, slam.state, cam, pi, pj, pd, pc,
                                           slam.tcfg, slam.rcfg))

    return {name: [at(c) for c in poses]
            for name, poses in offset_poses(gt_c2w, deltas).items()}


def probe_frame(slam, i: int, deltas: np.ndarray) -> Dict[str, Any]:
    """Sweep the tracking loss around frame ``i``'s ground-truth pose.
    Returns {dof: {"losses": [...], "argmin_delta": d, "base": loss at 0,
    "biased": bool}}."""
    rows = {}
    z = int(np.argmin(np.abs(deltas)))
    for name, vals in sweep_losses(slam, i, deltas).items():
        k = int(np.argmin(vals))
        rows[name] = {"losses": [round(v, 1) for v in vals],
                      "argmin_delta": float(deltas[k]),
                      "base": round(vals[z], 1),
                      "biased": k != z}
    return rows


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--out", type=str, required=True,
                   help="output dir of a previous run (resumed from its latest "
                        "checkpoint); also used as cfg data.output")
    p.add_argument("--frames", type=int, nargs="+", default=[5, 30, 60])
    p.add_argument("--deltas_cm", type=float, nargs="+",
                   default=[-4, -2, -1, 0, 1, 2, 4])
    p.add_argument("--pixels", type=int, default=2000)
    p.add_argument("--n_frames", type=int, default=150)
    p.add_argument("--orbit_radians", type=float, default=None)
    p.add_argument("--texture", type=str, default=None, choices=["checker", "hash"])
    p.add_argument("--scene", type=str, default=None, choices=["box", "furnished"])
    p.add_argument("--imap", action="store_true")
    p.add_argument("--no_resume", action="store_true",
                   help="probe the fresh (untrained) map: plumbing mode, the "
                        "landscape itself is meaningless")
    p.add_argument("--record", type=str, default=None,
                   help="write the per-frame sweep rows as JSON")
    p.add_argument("--device", type=str, default="cuda")
    return p


def landscape_cfg(args) -> Dict[str, Any]:
    """configs/Synthetic/box.yaml on the model's base with the probe's
    edits (the pretrained decoders' paths resolved against the repo)."""
    from nice_slam_torch.config import load_config

    base = "imap.yaml" if args.imap else "nice_slam.yaml"
    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", base))
    cfg["coarse"] = False
    cfg["verbose"] = False
    cfg["data"]["n_frames"] = args.n_frames
    if args.orbit_radians is not None:
        cfg["data"]["orbit_radians"] = args.orbit_radians
    cfg["data"]["output"] = args.out
    cfg["tracking"]["pixels"] = args.pixels
    cfg["mapping"]["ckpt_freq"] = 10 ** 6
    if args.texture is not None:
        cfg["data"]["texture"] = args.texture
    if args.scene is not None:
        cfg["data"]["scene"] = args.scene
    if "pretrained_decoders" in cfg:
        cfg["pretrained_decoders"] = {k: os.path.join(ROOT, v) if v else v
                                      for k, v in cfg["pretrained_decoders"].items()}
    return cfg


def main(argv=None) -> Dict[str, Any]:
    """The probe for the flags ``argv``; returns {frame: rows}."""
    from nice_slam_torch.slam.slam import NiceSLAM

    args = parser().parse_args(argv)
    ns = argparse.Namespace(nice=not args.imap, input_folder=None, output=None)
    slam = NiceSLAM(landscape_cfg(args), ns, device=args.device)
    if not args.no_resume:
        slam.resume()
    deltas = np.asarray(args.deltas_cm, np.float64) / 100.0

    book = {}
    for i in args.frames:
        rows = probe_frame(slam, i, deltas)
        book[str(i)] = rows
        print(f"frame {i} (deltas cm: {np.asarray(args.deltas_cm)}):")
        for name, r in rows.items():
            base = r["base"]
            rel = " ".join(f"{v - base:+9.1f}" for v in r["losses"])
            mark = ("OK" if not r["biased"]
                    else f"BIASED-MIN@{r['argmin_delta'] * 100:g}cm")
            print(f"  {name:11s} {rel}   [{mark}] base={base}")
    if args.record:
        with open(args.record, "w") as f:
            json.dump(book, f, indent=1)
        print(f"recorded -> {args.record}")
    return book


if __name__ == "__main__":
    main()
