"""Reconstruction evaluation, 3D accuracy / completion and 2D depth L1:
the port's counterpart of the JAX package's ``tools/eval_recon.py``, over
the port's ``utils/meshlib.py`` (PLY reader, area-weighted surface
sampling, the BVH raycaster of ``csrc/mesh_kernels.cpp``) and scipy's
``cKDTree``.

  * 3D: ICP-align the reconstructed mesh to the ground truth, sample
    200k surface points on each, report accuracy (rec -> GT mean
    nearest-neighbour distance, cm), completion (GT -> rec, cm) and the
    completion ratio (share of GT points within 5 cm, %);
  * 2D: render depth maps of both meshes from ``n_imgs`` random camera
    poses inside the room, rejecting views that see the unseen-region
    point cloud ``*_pc_unseen.npy`` (at most 1000 attempts per view, and
    three views in a row without a free one end the search), and report
    mean |delta depth| x 100 (cm).  With ``seed`` it draws from Python's
    ``random`` and numpy's global generator in the JAX tool's order, so
    one seed gives both packages the same views.

All of it runs on the host.

CLI: python -m nice_slam_torch.tools.eval_recon --rec_mesh R --gt_mesh G
     [-2d] [-3d] [--n_imgs N]
"""

from __future__ import annotations

import argparse
import random
from typing import Optional

import numpy as np
from scipy.spatial import cKDTree as KDTree

from nice_slam_torch.utils.meshlib import MeshRaycaster, read_ply, sample_surface


def normalize(x):
    return x / np.linalg.norm(x)


def viewmatrix(z, up, pos):
    """Camera-to-world (3x4) with +z the view direction."""
    vec2 = normalize(z)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def completion_ratio(gt_points, rec_points, dist_th=0.05):
    distances, _ = KDTree(rec_points).query(gt_points)
    return float(np.mean(distances < dist_th))


def accuracy(gt_points, rec_points):
    distances, _ = KDTree(gt_points).query(rec_points)
    return float(np.mean(distances))


def completion(gt_points, rec_points):
    distances, _ = KDTree(rec_points).query(gt_points)
    return float(np.mean(distances))


def icp_p2p(src: np.ndarray, dst: np.ndarray, threshold: float = 0.1,
            max_iters: int = 30) -> np.ndarray:
    """Point-to-point ICP from the identity: the 4x4 transform aligning
    ``src`` to ``dst`` (pairs farther apart than ``threshold`` ignored)."""
    T = np.eye(4)
    cur = src.copy()
    tree = KDTree(dst)
    prev_err = np.inf
    for _ in range(max_iters):
        dist, idx = tree.query(cur)
        m = dist < threshold
        if m.sum() < 10:
            break
        a = cur[m]
        b = dst[idx[m]]
        ca, cb = a.mean(0), b.mean(0)
        H = (a - ca).T @ (b - cb)
        U, _, Vt = np.linalg.svd(H)
        S = np.eye(3)
        if np.linalg.det(U @ Vt) < 0:
            S[2, 2] = -1
        R = Vt.T @ S @ U.T
        t = cb - R @ ca
        step = np.eye(4)
        step[:3, :3] = R
        step[:3, 3] = t
        T = step @ T
        cur = cur @ R.T + t
        err = float(np.mean(dist[m]))
        if abs(prev_err - err) < 1e-7:
            break
        prev_err = err
    return T


def get_align_transformation(rec_meshfile: str, gt_meshfile: str) -> np.ndarray:
    rec_v, _, _ = read_ply(rec_meshfile)
    gt_v, _, _ = read_ply(gt_meshfile)
    return icp_p2p(rec_v, gt_v, threshold=0.1)


def calc_3d_metric(rec_meshfile: str, gt_meshfile: str, align: bool = True):
    rec_v, rec_t, _ = read_ply(rec_meshfile)
    gt_v, gt_t, _ = read_ply(gt_meshfile)
    if align:
        T = get_align_transformation(rec_meshfile, gt_meshfile)
        rec_v = rec_v @ T[:3, :3].T + T[:3, 3]
    rec_pc = sample_surface(rec_v, rec_t, 200_000, seed=0)
    gt_pc = sample_surface(gt_v, gt_t, 200_000, seed=1)
    acc = accuracy(gt_pc, rec_pc) * 100
    comp = completion(gt_pc, rec_pc) * 100
    ratio = completion_ratio(gt_pc, rec_pc) * 100
    print("accuracy: ", acc)
    print("completion: ", comp)
    print("completion ratio: ", ratio)
    return {"accuracy_cm": acc, "completion_cm": comp,
            "completion_ratio_pct": ratio}


def get_cam_position(gt_meshfile: str):
    """The box cameras are drawn from: a PCA-oriented bound of the GT
    mesh, shrunk to 0.3 / 0.7 / 0.7 of its extents and lifted 0.4 in z.
    Returns (extents (3,), transform (4, 4))."""
    gt_v, _, _ = read_ply(gt_meshfile)
    center = gt_v.mean(axis=0)
    cov = np.cov((gt_v - center).T)
    evals, evecs = np.linalg.eigh(cov)
    order = np.argsort(evals)[::-1]
    evecs = evecs[:, order]
    if np.linalg.det(evecs) < 0:
        evecs[:, 2] *= -1
    local = (gt_v - center) @ evecs
    lo, hi = local.min(0), local.max(0)
    extents = hi - lo
    mid = center + evecs @ ((lo + hi) / 2)
    transform = np.eye(4)
    transform[:3, :3] = evecs
    transform[:3, 3] = mid
    extents = extents.copy()
    extents[2] *= 0.7
    extents[1] *= 0.7
    extents[0] *= 0.3
    transform[2, 3] += 0.4
    return extents, transform


def check_proj(points, W, H, fx, fy, cx, cy, c2w) -> bool:
    """True if any point projects into the view (the reference's camera
    convention: y and z flipped, -z forward, x mirrored)."""
    c2w = c2w.copy()
    c2w[:3, 1] *= -1.0
    c2w[:3, 2] *= -1.0
    w2c = np.linalg.inv(c2w)
    cam = points @ w2c[:3, :3].T + w2c[:3, 3]
    z = cam[:, 2:3] + 1e-5
    u = (fx * (-cam[:, 0:1]) + cx * cam[:, 2:3]) / z
    v = (fy * cam[:, 1:2] + cy * cam[:, 2:3]) / z
    mask = ((0 <= -z[:, 0]) & (u[:, 0] < W) & (u[:, 0] > 0)
            & (v[:, 0] < H) & (v[:, 0] > 0))
    return bool(mask.sum() > 0)


def calc_2d_metric(rec_meshfile: str, gt_meshfile: str, align: bool = True,
                   n_imgs: int = 1000, seed: Optional[int] = None):
    H = W = 500
    focal = 300.0
    fx = fy = focal
    cx = H / 2.0 - 0.5
    cy = W / 2.0 - 0.5

    gt_v, gt_t, _ = read_ply(gt_meshfile)
    rec_v, rec_t, _ = read_ply(rec_meshfile)
    unseen_file = gt_meshfile.replace(".ply", "_pc_unseen.npy")
    try:
        pc_unseen = np.load(unseen_file)
    except FileNotFoundError:
        print(f"WARN: {unseen_file} missing; skipping unseen-view rejection")
        pc_unseen = np.zeros((0, 3))
    if align:
        T = get_align_transformation(rec_meshfile, gt_meshfile)
        rec_v = rec_v @ T[:3, :3].T + T[:3, 3]

    extents, transform = get_cam_position(gt_meshfile)
    gt_caster = MeshRaycaster(gt_v, gt_t)
    rec_caster = MeshRaycaster(rec_v, rec_t)
    if seed is not None:
        random.seed(seed)
        np.random.seed(seed)

    errors = []
    hit_fracs = []
    exhausted = 0
    for _ in range(n_imgs):
        # a bounded search for an unseen-free view: with large unobserved
        # regions an unbounded one would never end
        c2w = None
        for _attempt in range(1000):
            up = np.array([0.0, 0.0, -1.0])
            local = (np.random.rand(3) - 0.5) * extents
            origin = transform[:3, :3] @ local + transform[:3, 3]
            target = np.array([random.uniform(-10000, 10000) for _ in range(3)]) - origin
            cand = np.eye(4)
            cand[:3, :] = viewmatrix(target, up, origin)
            if len(pc_unseen) == 0 or not check_proj(pc_unseen, W, H, fx, fy, cx, cy, cand):
                c2w = cand
                break
        if c2w is None:
            exhausted += 1
            if exhausted >= 3:  # views are i.i.d.: three misses in a row
                break           # means the rest would burn attempts too
            continue
        exhausted = 0
        gt_depth = gt_caster.render_depth(c2w, H, W, fx, fy, cx, cy, z_far=20.0)
        ours_depth = rec_caster.render_depth(c2w, H, W, fx, fy, cx, cy, z_far=20.0)
        errors.append(np.abs(gt_depth - ours_depth).mean())
        hit_fracs.append(float((gt_depth > 0).mean()))

    if not errors:
        print("WARN: no unseen-free views found; Depth L1 undefined")
        return {"depth_l1_cm": float("nan")}
    if len(errors) < n_imgs:
        print(f"WARN: only {len(errors)}/{n_imgs} unseen-free views found; "
              "Depth L1 averaged over the reduced sample")
    if np.mean(hit_fracs) < 0.05:
        print(f"WARN: GT mesh hit fraction {np.mean(hit_fracs):.1%} — "
              "no-hit pixels compare as equal (reference metric semantics); "
              "Depth L1 is unreliable on this coverage")
    depth_l1 = float(np.mean(errors) * 100)
    print("Depth L1: ", depth_l1)
    return {"depth_l1_cm": depth_l1}


def main() -> None:
    parser = argparse.ArgumentParser(description="Arguments to evaluate the reconstruction.")
    parser.add_argument("--rec_mesh", type=str, required=True)
    parser.add_argument("--gt_mesh", type=str, required=True)
    parser.add_argument("-2d", "--metric_2d", action="store_true")
    parser.add_argument("-3d", "--metric_3d", action="store_true")
    parser.add_argument("--n_imgs", type=int, default=1000)
    args = parser.parse_args()
    if args.metric_3d:
        calc_3d_metric(args.rec_mesh, args.gt_mesh)
    if args.metric_2d:
        calc_2d_metric(args.rec_mesh, args.gt_mesh, n_imgs=args.n_imgs)


if __name__ == "__main__":
    main()
