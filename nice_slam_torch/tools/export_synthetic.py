"""Export the procedural synthetic scene in real datasets' on-disk layouts:
the port's counterpart of the JAX package's ``tools/export_synthetic.py``.

It renders the synthetic box-room sequence (``utils/datasets.py``
``Synthetic``) to disk in the directory layouts the real readers consume,
with the port's own writers (no imaging library):

  * Replica   -- results/frame%06d.jpg + results/depth%06d.png (uint16 x
    png_depth_scale) + traj.txt of 4x4 c2w rows;
  * TUM RGB-D -- rgb/*.png, depth/*.png (uint16), timestamped rgb.txt /
    depth.txt / groundtruth.txt (t tx ty tz qx qy qz qw);
  * ScanNet   -- frames/{color/*.jpg, depth/*.png, pose/*.txt};
  * CoFusion  -- colour/*.png + float EXR depth in depth_noise/ (identity
    poses in the reader, so none are written);
  * Azure     -- color/*.jpg + depth/*.png + an Open3D scene/trajectory.log.

Colour JPEGs are 4:2:0 at quality 95 with the Annex K Huffman tables, as
OpenCV writes them; depth PNGs are round(depth x png_depth_scale).  Pose
conventions invert each reader's transform (the y/z column flips, TUM's
quaternion encoding), so a round trip through the reader gives back the
generator's poses.

Usage:
    python -m nice_slam_torch.tools.export_synthetic OUT_DIR
        [--format replica|tum|scannet|cofusion|azure] [--n_frames N]
        [--H H --W W]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np

from nice_slam_torch.utils.exr import write_exr
from nice_slam_torch.utils.jpeg import write_jpeg
from nice_slam_torch.utils.png import write_png


def _default_cfg(n_frames: int, H: int, W: int) -> Dict:
    return {
        "dataset": "synthetic",
        "scale": 1,
        "cam": {"H": H, "W": W, "fx": H * 1.0, "fy": H * 1.0,
                "cx": W / 2 - 0.5, "cy": H / 2 - 0.5,
                "png_depth_scale": 6553.5, "crop_edge": 0},
        "data": {"n_frames": n_frames},
    }


def _frames(cfg):
    from nice_slam_torch.utils.datasets import Synthetic

    ds = Synthetic(cfg)
    for i in range(len(ds)):
        idx, color, depth, c2w = ds[i]
        yield idx, np.asarray(color), np.asarray(depth), np.asarray(c2w)


def _u8(color: np.ndarray) -> np.ndarray:
    return (np.clip(color, 0, 1) * 255).astype(np.uint8)


def _write_color_jpg(path: str, color: np.ndarray) -> None:
    write_jpeg(path, _u8(color), quality=95, libjpeg_defaults=True)


def _write_color_png(path: str, color: np.ndarray) -> None:
    write_png(path, _u8(color))


def _write_depth_png(path: str, depth: np.ndarray, scale: float) -> None:
    write_png(path, np.round(depth * scale).astype(np.uint16))


def _unflip(c2w: np.ndarray) -> np.ndarray:
    """Invert the readers' y/z column flip (an involution)."""
    out = c2w.astype(np.float64).copy()
    out[:3, 1] *= -1
    out[:3, 2] *= -1
    return out


def export_replica(out: str, cfg: Dict) -> None:
    os.makedirs(os.path.join(out, "results"), exist_ok=True)
    scale = cfg["cam"]["png_depth_scale"]
    rows = []
    for i, color, depth, c2w in _frames(cfg):
        _write_color_jpg(os.path.join(out, "results", f"frame{i:06d}.jpg"), color)
        _write_depth_png(os.path.join(out, "results", f"depth{i:06d}.png"), depth, scale)
        rows.append(" ".join(f"{v:.9f}" for v in _unflip(c2w).reshape(-1)))
    with open(os.path.join(out, "traj.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")


def export_scannet(out: str, cfg: Dict) -> None:
    base = os.path.join(out, "frames")
    for sub in ("color", "depth", "pose"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    scale = cfg["cam"]["png_depth_scale"]
    for i, color, depth, c2w in _frames(cfg):
        _write_color_jpg(os.path.join(base, "color", f"{i}.jpg"), color)
        _write_depth_png(os.path.join(base, "depth", f"{i}.png"), depth, scale)
        np.savetxt(os.path.join(base, "pose", f"{i}.txt"), _unflip(c2w))


def _quat_from_rot(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (qx, qy, qz, qw), scipy's convention."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = [0.0, 0.0, 0.0, 0.0]
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        qx, qy, qz, qw = q
    return np.array([qx, qy, qz, qw])


def export_tum(out: str, cfg: Dict, fps: float = 30.0) -> None:
    os.makedirs(os.path.join(out, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(out, "depth"), exist_ok=True)
    scale = cfg["cam"]["png_depth_scale"]
    rgb_rows, depth_rows, gt_rows = [], [], []
    for i, color, depth, c2w in _frames(cfg):
        t = i / fps
        _write_color_png(os.path.join(out, "rgb", f"{t:.6f}.png"), color)
        _write_depth_png(os.path.join(out, "depth", f"{t:.6f}.png"), depth, scale)
        rgb_rows.append(f"{t:.6f} rgb/{t:.6f}.png")
        depth_rows.append(f"{t:.6f} depth/{t:.6f}.png")
        raw = _unflip(c2w)
        q = _quat_from_rot(raw[:3, :3])
        tx, ty, tz = raw[:3, 3]
        gt_rows.append(f"{t:.6f} {tx:.9f} {ty:.9f} {tz:.9f} "
                       f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}")
    with open(os.path.join(out, "rgb.txt"), "w") as f:
        f.write("\n".join(rgb_rows) + "\n")
    with open(os.path.join(out, "depth.txt"), "w") as f:
        f.write("\n".join(depth_rows) + "\n")
    with open(os.path.join(out, "groundtruth.txt"), "w") as f:
        f.write("# ground truth trajectory\n" + "\n".join(gt_rows) + "\n")


def export_cofusion(out: str, cfg: Dict) -> None:
    os.makedirs(os.path.join(out, "colour"), exist_ok=True)
    os.makedirs(os.path.join(out, "depth_noise"), exist_ok=True)
    for i, color, depth, _ in _frames(cfg):
        _write_color_png(os.path.join(out, "colour", f"Color{i:04d}.png"), color)
        write_exr(os.path.join(out, "depth_noise", f"Depth{i:04d}.exr"),
                  {"Z": depth.astype(np.float32)})


def export_azure(out: str, cfg: Dict) -> None:
    """Open3D trajectory.log: 5 lines per pose (a metadata triple, then
    the 4 matrix rows)."""
    for sub in ("color", "depth", "scene"):
        os.makedirs(os.path.join(out, sub), exist_ok=True)
    scale = cfg["cam"]["png_depth_scale"]
    rows = []
    for i, color, depth, c2w in _frames(cfg):
        _write_color_jpg(os.path.join(out, "color", f"{i:05d}.jpg"), color)
        _write_depth_png(os.path.join(out, "depth", f"{i:05d}.png"), depth, scale)
        rows.append(f"{i} {i} {i + 1}")
        for r in _unflip(c2w):
            rows.append(" ".join(f"{v:.9f}" for v in r))
    with open(os.path.join(out, "scene", "trajectory.log"), "w") as f:
        f.write("\n".join(rows) + "\n")


EXPORTERS = {"replica": export_replica, "tum": export_tum,
             "scannet": export_scannet, "cofusion": export_cofusion,
             "azure": export_azure}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("out")
    ap.add_argument("--format", choices=sorted(EXPORTERS), default="replica")
    ap.add_argument("--n_frames", type=int, default=40)
    ap.add_argument("--H", type=int, default=120)
    ap.add_argument("--W", type=int, default=160)
    args = ap.parse_args()
    cfg = _default_cfg(args.n_frames, args.H, args.W)
    EXPORTERS[args.format](args.out, cfg)
    print(f"exported {args.n_frames} synthetic frames to {args.out} "
          f"({args.format} layout)")


if __name__ == "__main__":
    main()
