"""Absolute trajectory error (TUM protocol): the port's counterpart of the
JAX package's ``tools/eval_ate.py``.

Greedy nearest-timestamp association, Horn's closed-form alignment with
the reflection guard, and the RMSE / mean / median / std / min / max of
the aligned translational error; ground-truth poses with NaN or Inf
(ScanNet) are masked out.  The aligned trajectories' x-y plot is drawn
with the port's JPEG writer (no plotting library): ground truth black,
estimate blue, on white, without axes or a title (the numbers are
printed).

CLI: python -m nice_slam_torch.tools.eval_ate <config> [--output DIR]
     [--nice|--imap]
Reads the run's last checkpoint and writes ``eval_ate_plot.jpg`` beside
its ``ckpts/``.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Tuple

import numpy as np


def associate(first_list: Dict[float, np.ndarray],
              second_list: Dict[float, np.ndarray], offset: float = 0.0,
              max_difference: float = 0.02):
    """Greedy closest-timestamp matching of two {stamp: pose} dicts."""
    first_keys = set(first_list.keys())
    second_keys = set(second_list.keys())
    potential = sorted(
        (abs(a - (b + offset)), a, b)
        for a in first_keys
        for b in second_keys
        if abs(a - (b + offset)) < max_difference
    )
    matches = []
    for _, a, b in potential:
        if a in first_keys and b in second_keys:
            first_keys.remove(a)
            second_keys.remove(b)
            matches.append((a, b))
    matches.sort()
    return matches


def align(model: np.ndarray, data: np.ndarray):
    """Align a (3, N) trajectory ``model`` to ``data``.  Returns (rot (3,3),
    trans (3,1), per-point translational error (N,))."""
    model_zc = model - model.mean(axis=1, keepdims=True)
    data_zc = data - data.mean(axis=1, keepdims=True)
    W = model_zc @ data_zc.T
    U, _, Vh = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vh
    trans = data.mean(axis=1, keepdims=True) - rot @ model.mean(axis=1,
                                                                keepdims=True)
    err = rot @ model + trans - data
    return rot, trans, np.sqrt(np.sum(err * err, axis=0))


def ate_rmse(est_c2w: np.ndarray, gt_c2w: np.ndarray) -> float:
    """ATE RMSE in metres between (N, 4, 4) estimated and true poses."""
    _, _, err = align(np.asarray(est_c2w)[:, :3, 3].T.astype(np.float64),
                      np.asarray(gt_c2w)[:, :3, 3].T.astype(np.float64))
    return float(np.sqrt(np.mean(err ** 2)))


PLOT_HW = (480, 640)


def plot_trajectories(path: str, first_xy: np.ndarray, second_xy: np.ndarray) -> None:
    """Draw two (2, N) x-y polylines, ``first_xy`` black and ``second_xy``
    blue, on a white ``PLOT_HW`` JPEG with equal axis scales and a 5 %
    margin."""
    from nice_slam_torch.utils.jpeg import write_jpeg

    H, W = PLOT_HW
    img = np.full((H, W, 3), 255, np.uint8)
    pts = np.concatenate([first_xy, second_xy], axis=1)
    lo, hi = pts.min(axis=1), pts.max(axis=1)
    span = max(float((hi - lo).max()), 1e-9)
    s = 0.9 * min(H, W) / span
    mid = (lo + hi) / 2

    def to_px(xy):  # x right, y up
        return (W / 2 + (xy[0] - mid[0]) * s, H / 2 - (xy[1] - mid[1]) * s)

    for xy, color in ((first_xy, (0, 0, 0)), (second_xy, (0, 0, 255))):
        u, v = to_px(xy)
        for k in range(len(u) - 1):
            n = int(max(abs(u[k + 1] - u[k]), abs(v[k + 1] - v[k]))) + 2
            t = np.linspace(0.0, 1.0, n)
            uu = np.rint(u[k] + t * (u[k + 1] - u[k])).astype(int)
            vv = np.rint(v[k] + t * (v[k + 1] - v[k])).astype(int)
            for dv in (0, 1):  # two pixels thick
                ok = (uu >= 0) & (uu < W) & (vv + dv >= 0) & (vv + dv < H)
                img[vv[ok] + dv, uu[ok]] = color
    write_jpeg(path, img, quality=90)


def evaluate_ate(first_list: Dict[float, np.ndarray],
                 second_list: Dict[float, np.ndarray], plot: str = "",
                 offset: float = 0.0, scale: float = 1.0,
                 max_difference: float = 0.02) -> Dict[str, float]:
    """ATE statistics of ``second_list`` aligned to ``first_list`` (the
    ground truth), each {stamp: [tx, ty, tz, ...]}; ``plot`` a JPEG path."""
    matches = associate(first_list, second_list, offset, max_difference)
    if len(matches) < 2:
        raise ValueError(
            "Couldn't find matching timestamp pairs between groundtruth and "
            "estimated trajectory!")
    first_xyz = np.array([first_list[a][:3] for a, _ in matches], float).T
    second_xyz = np.array(
        [np.asarray(second_list[b][:3], float) * scale for _, b in matches]).T
    rot, trans, trans_error = align(second_xyz, first_xyz)
    if plot:
        plot_trajectories(plot, first_xyz[:2], (rot @ second_xyz + trans)[:2])
    return {
        "compared_pose_pairs": len(trans_error),
        "absolute_translational_error.rmse": float(np.sqrt(np.mean(trans_error ** 2))),
        "absolute_translational_error.mean": float(np.mean(trans_error)),
        "absolute_translational_error.median": float(np.median(trans_error)),
        "absolute_translational_error.std": float(np.std(trans_error)),
        "absolute_translational_error.min": float(np.min(trans_error)),
        "absolute_translational_error.max": float(np.max(trans_error)),
    }


def convert_poses(c2w_list: np.ndarray, N: int, scale: float,
                  gt: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """The first N + 1 4x4 poses as [t, quat] vectors (translation divided
    by ``scale``), and the mask of the ground-truth poses kept (no NaN or
    Inf)."""
    import torch

    from nice_slam_torch.ops.geometry import tensor_from_pose

    poses = []
    mask = np.ones(N + 1, bool)
    for idx in range(N + 1):
        c2w = np.array(c2w_list[idx], np.float64)
        if gt and (np.isinf(c2w).any() or np.isnan(c2w).any()):
            mask[idx] = False
            continue
        c2w[:3, 3] /= scale
        qt = tensor_from_pose(torch.from_numpy(c2w.astype(np.float32))).numpy()
        poses.append(np.concatenate([qt[4:], qt[:4]]))
    return np.stack(poses), mask


def evaluate(poses_gt: np.ndarray, poses_est: np.ndarray, plot: str):
    N = poses_gt.shape[0]
    gt_dict = {i: poses_gt[i] for i in range(N)}
    est_dict = {i: poses_est[i] for i in range(poses_est.shape[0])}
    results = evaluate_ate(gt_dict, est_dict, plot)
    print(results)
    return results


def main() -> None:
    import torch

    from nice_slam_torch.config import load_config

    parser = argparse.ArgumentParser(description="Arguments to eval the tracking ATE.")
    parser.add_argument("config", type=str)
    parser.add_argument("--output", type=str, default=None)
    group = parser.add_mutually_exclusive_group()
    group.add_argument("--nice", dest="nice", action="store_true")
    group.add_argument("--imap", dest="nice", action="store_false")
    parser.set_defaults(nice=True)
    args = parser.parse_args()

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cfg = load_config(args.config, os.path.join(
        root, "configs", "nice_slam.yaml" if args.nice else "imap.yaml"))
    scale = cfg["scale"]
    output = args.output or cfg["data"]["output"]
    ckptsdir = os.path.join(output, "ckpts")
    ckpts = [os.path.join(ckptsdir, f) for f in sorted(os.listdir(ckptsdir)) if "tar" in f]
    if not ckpts:
        raise SystemExit(f"no checkpoints in {ckptsdir}")
    print("Get ckpt :", ckpts[-1])
    ckpt = torch.load(ckpts[-1], map_location="cpu", weights_only=False)
    estimate_c2w_list = np.asarray(ckpt["estimate_c2w_list"])
    gt_c2w_list = np.asarray(ckpt["gt_c2w_list"])
    N = int(ckpt["idx"])
    poses_gt, mask = convert_poses(gt_c2w_list, N, scale)
    poses_est, _ = convert_poses(estimate_c2w_list, N, scale, gt=False)
    poses_est = poses_est[mask]
    evaluate(poses_gt, poses_est, plot=os.path.join(output, "eval_ate_plot.jpg"))


if __name__ == "__main__":
    main()
