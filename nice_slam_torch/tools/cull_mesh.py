"""Cull a mesh to the union of camera frustums (ground-truth mesh
preparation): the port's counterpart of the JAX package's
``tools/cull_mesh.py``.

Every face whose vertices all lie outside every camera frustum of the
trajectory is dropped.  The intrinsics default to Replica's.

CLI: python -m nice_slam_torch.tools.cull_mesh --input_mesh M --traj T
     --output_mesh O [--H --W --fx --fy --cx --cy]
"""

from __future__ import annotations

import argparse

import numpy as np

from nice_slam_torch.utils.meshlib import read_ply, write_ply


def load_poses(path: str):
    """Replica traj.txt: one flattened 4x4 c2w per line, y/z flipped."""
    poses = []
    with open(path) as f:
        for line in f.readlines():
            c2w = np.array(list(map(float, line.split()))).reshape(4, 4)
            c2w[:3, 1] *= -1
            c2w[:3, 2] *= -1
            poses.append(c2w.astype(np.float32))
    return poses


def cull_mesh(verts: np.ndarray, faces: np.ndarray, poses, H: int, W: int,
              fx: float, fy: float, cx: float, cy: float):
    """The faces with at least one vertex inside some camera's frustum
    (camera looking along -z, x flipped as the reference projects)."""
    outside_all = np.ones(len(verts), bool)
    for c2w in poses:
        w2c = np.linalg.inv(c2w)
        cam = verts @ w2c[:3, :3].T + w2c[:3, 3]
        z = cam[:, 2] + 1e-5
        u = (fx * (-cam[:, 0]) + cx * cam[:, 2]) / z
        v = (fy * cam[:, 1] + cy * cam[:, 2]) / z
        inside = (0 <= -z) & (u < W) & (u > 0) & (v < H) & (v > 0)
        outside_all &= ~inside
    drop = outside_all[faces].all(axis=1)
    return faces[~drop]


def main() -> None:
    parser = argparse.ArgumentParser(description="Arguments to cull the mesh.")
    parser.add_argument("--input_mesh", type=str, required=True)
    parser.add_argument("--traj", type=str, required=True)
    parser.add_argument("--output_mesh", type=str, required=True)
    parser.add_argument("--H", type=int, default=680)
    parser.add_argument("--W", type=int, default=1200)
    parser.add_argument("--fx", type=float, default=600.0)
    parser.add_argument("--fy", type=float, default=600.0)
    parser.add_argument("--cx", type=float, default=599.5)
    parser.add_argument("--cy", type=float, default=339.5)
    args = parser.parse_args()

    poses = load_poses(args.traj)
    verts, faces, colors = read_ply(args.input_mesh)
    faces = cull_mesh(verts, faces, poses, args.H, args.W, args.fx, args.fy,
                      args.cx, args.cy)
    write_ply(args.output_mesh, verts, faces, colors)
    print(f"culled mesh written to {args.output_mesh}")


if __name__ == "__main__":
    main()
