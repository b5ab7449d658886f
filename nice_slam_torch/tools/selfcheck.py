"""End-to-end acceptance run: full SLAM on the synthetic scene, then its
metrics; the port's counterpart of the JAX package's ``tools/selfcheck.py``.

Runs tracking, mapping and meshing on the procedural box room, then
scores:
  * the ATE RMSE of the trajectory (``tools/eval_ate.py``);
  * 3D accuracy / completion / completion ratio and 2D depth L1
    (``tools/eval_recon.py``) of ``final_mesh_eval_rec.ply`` against the
    analytic ground-truth room mesh, frustum-culled to the trajectory.

Prints one JSON summary line (strict JSON: a depth L1 without views is
null) with the keys of the JAX tool and the port's ``timings`` (the
loop's, plus the seconds of the ground-truth mesh and of the 3D and 2D
metrics).  ``run(args)`` is the same path for a caller that has parsed
the flags itself.

CLI: python -m nice_slam_torch.tools.selfcheck [--frames 30] [--out DIR]
     [--gt_camera] [--imap] [--device cuda|cpu] [--record FILE] ...
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Any, Dict

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def gt_room_mesh(room: np.ndarray, path: str, poses, cam, resolution: int = 96,
                 sdf=None) -> str:
    """A finely triangulated analytic scene mesh, culled to the
    trajectory's frustums, written to ``path``; beside it
    ``*_pc_unseen.npy``, the vertices only culled faces use (the 2D
    metric's unseen-view rejection).  ``sdf`` is the dataset's
    ``scene_sdf`` (walls and furniture); without it, the walls only."""
    from nice_slam_torch.tools.cull_mesh import cull_mesh
    from nice_slam_torch.utils.meshlib import marching_cubes, write_ply

    lo, hi = room[:, 0], room[:, 1]
    pad = 0.2
    axes = [np.linspace(lo[k] - pad, hi[k] + pad, resolution) for k in range(3)]
    X, Y, Z = np.meshgrid(*axes, indexing="ij")
    if sdf is not None:
        field = sdf(np.stack([X, Y, Z], axis=-1)).astype(np.float32)
    else:  # > 0 inside the room: the iso-surface is the walls
        field = np.minimum.reduce([
            X - lo[0], hi[0] - X, Y - lo[1], hi[1] - Y, Z - lo[2], hi[2] - Z,
        ]).astype(np.float32)
    spacing = tuple((a[1] - a[0]) for a in axes)
    verts, tris = marching_cubes(field, 0.0, origin=(axes[0][0], axes[1][0], axes[2][0]),
                                 spacing=spacing)
    all_tris = tris
    tris = cull_mesh(verts, tris, poses, cam["H"], cam["W"], cam["fx"], cam["fy"],
                     cam["cx"], cam["cy"])
    write_ply(path, verts, tris)
    kept = np.zeros(len(verts), bool)
    if len(tris):
        kept[np.unique(tris)] = True
    in_any = np.zeros(len(verts), bool)
    if len(all_tris):
        in_any[np.unique(all_tris)] = True
    np.save(path.replace(".ply", "_pc_unseen.npy"), verts[in_any & ~kept].astype(np.float32))
    return path


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--out", type=str, default="output/selfcheck")
    p.add_argument("--resolution", type=int, default=128)
    p.add_argument("--iters", type=int, default=60)
    p.add_argument("--iters_first", type=int, default=400)
    p.add_argument("--orbit_radians", type=float, default=None,
                   help="total orbit sweep; default 0.25 rad per 30 frames")
    p.add_argument("--depth_l1_imgs", type=int, default=200,
                   help="random interior views of the 2D depth-L1 metric")
    p.add_argument("--gt_camera", action="store_true",
                   help="map from ground-truth poses (no tracking)")
    p.add_argument("--imap", action="store_true",
                   help="the iMAP* single-MLP model instead of NICE")
    p.add_argument("--keyframe_every", type=int, default=None,
                   help="override mapping.keyframe_every")
    p.add_argument("--no_pretrain", action="store_true",
                   help="no pretrained decoders (scratch init)")
    p.add_argument("--seed", type=int, default=None,
                   help="override the config's seed (tracking pixel draws)")
    p.add_argument("--texture", type=str, default=None, choices=["checker", "hash"],
                   help="synthetic wall texture")
    p.add_argument("--track_pixels", type=int, default=None,
                   help="override tracking.pixels")
    p.add_argument("--track_iters", type=int, default=None,
                   help="override tracking.iters")
    p.add_argument("--cf_iters", type=int, default=0,
                   help="coarse-to-fine tracking: boosted LR for the first N iterations")
    p.add_argument("--cf_lr_mult", type=float, default=5.0,
                   help="LR multiplier for the cf_iters window")
    p.add_argument("--scene", type=str, default=None, choices=["box", "furnished"],
                   help="synthetic scene geometry")
    p.add_argument("--ba", action="store_true", help="enable mapping.BA")
    p.add_argument("--ksel", type=str, default=None, choices=["overlap", "global"],
                   help="override mapping.keyframe_selection_method")
    p.add_argument("--kind", type=str, default=None, help="override the --record key")
    p.add_argument("--record", type=str, default=None,
                   help="merge the summary into this JSON file under a key "
                        "derived from the run kind")
    p.add_argument("--device", type=str, default="cuda")
    return p


def selfcheck_cfg(args) -> Dict[str, Any]:
    """The run's config: configs/Synthetic/box.yaml on the model's base,
    coarse mapper off, final mesh only (with its eval_rec variant)."""
    from nice_slam_torch.config import load_config

    base = "imap.yaml" if args.imap else "nice_slam.yaml"
    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", base))
    cfg["coarse"] = False
    cfg["verbose"] = False
    cfg["data"]["n_frames"] = args.frames
    cfg["data"]["orbit_radians"] = (args.orbit_radians if args.orbit_radians is not None
                                    else 0.25 * args.frames / 30.0)
    cfg["data"]["output"] = args.out
    cfg["mapping"]["iters"] = args.iters
    cfg["mapping"]["iters_first"] = args.iters_first
    cfg["mapping"]["mesh_freq"] = 10 ** 6
    cfg["mapping"]["ckpt_freq"] = 10 ** 6
    cfg["meshing"]["resolution"] = args.resolution
    cfg["meshing"]["eval_rec"] = True
    if args.gt_camera:
        cfg["tracking"]["gt_camera"] = True
    if args.no_pretrain:
        cfg["pretrained_decoders"] = {"coarse": "", "middle_fine": ""}
    elif "pretrained_decoders" in cfg:
        cfg["pretrained_decoders"] = {k: os.path.join(ROOT, v) if v else v
                                      for k, v in cfg["pretrained_decoders"].items()}
    if args.keyframe_every is not None:
        cfg["mapping"]["keyframe_every"] = args.keyframe_every
    if args.seed is not None:
        cfg["seed"] = args.seed
    if args.cf_iters > 0:
        cfg["tracking"]["cf_iters"] = args.cf_iters
        cfg["tracking"]["cf_lr_mult"] = args.cf_lr_mult
    if args.track_pixels is not None:
        cfg["tracking"]["pixels"] = args.track_pixels
    if args.track_iters is not None:
        cfg["tracking"]["iters"] = args.track_iters
    if args.texture is not None:
        cfg["data"]["texture"] = args.texture
    if args.ba:
        cfg["mapping"]["BA"] = True
    if args.scene is not None:
        cfg["data"]["scene"] = args.scene
    if args.ksel is not None:
        cfg["mapping"]["keyframe_selection_method"] = args.ksel
    return cfg


def record_kind(args) -> str:
    """The --record key: imap / gt_tour / tracked plus the run's levers."""
    kind = "imap" if args.imap else ("gt_tour" if args.gt_camera else "tracked")
    if args.no_pretrain:
        kind += "_scratch"
    if args.keyframe_every is not None:
        kind += f"_kf{args.keyframe_every}"
    if args.seed is not None:
        kind += f"_s{args.seed}"
    return args.kind if args.kind is not None else kind


def run(args) -> Dict[str, Any]:
    """The whole check for parsed flags ``args``; returns the summary."""
    from nice_slam_torch.slam.slam import NiceSLAM
    from nice_slam_torch.tools.eval_ate import align
    from nice_slam_torch.tools.eval_recon import calc_2d_metric, calc_3d_metric

    cfg = selfcheck_cfg(args)
    ns = argparse.Namespace(nice=not args.imap, input_folder=None, output=None)
    slam = NiceSLAM(cfg, ns, device=args.device)
    slam.run()

    n = args.frames
    est_c2w = slam.estimate_c2w_list.cpu().numpy()
    _, _, err = align(est_c2w[:n, :3, 3].T.astype(np.float64),
                      slam.gt_c2w_list[:n, :3, 3].T.astype(np.float64))
    ate_rmse = float(np.sqrt(np.mean(err ** 2)))

    t0 = time.perf_counter()
    gt_mesh = gt_room_mesh(
        np.asarray(slam.frame_reader.room), os.path.join(args.out, "gt_room.ply"),
        [slam.gt_c2w_list[i] for i in range(n)], slam.cam,
        sdf=slam.frame_reader.scene_sdf)
    t1 = time.perf_counter()
    rec_mesh = os.path.join(args.out, "mesh", "final_mesh_eval_rec.ply")
    metrics = calc_3d_metric(rec_mesh, gt_mesh, align=True)
    t2 = time.perf_counter()
    depth_l1 = calc_2d_metric(rec_mesh, gt_mesh, align=True, n_imgs=args.depth_l1_imgs,
                              seed=0)["depth_l1_cm"]
    t3 = time.perf_counter()
    summary = {
        "frames": n,
        "orbit_radians": round(cfg["data"]["orbit_radians"], 3),
        "ate_rmse_cm": round(ate_rmse * 100, 3),
        "accuracy_cm": round(metrics["accuracy_cm"], 3),
        "completion_cm": round(metrics["completion_cm"], 3),
        "completion_ratio_pct": round(metrics["completion_ratio_pct"], 2),
        "depth_l1_cm": round(float(depth_l1), 3) if math.isfinite(depth_l1) else None,
        "timings": dict(slam.timings, gt_mesh_s=t1 - t0, eval_3d_s=t2 - t1,
                        eval_2d_s=t3 - t2),
    }
    if args.record:
        kind = record_kind(args)
        book = {}
        if os.path.exists(args.record):
            with open(args.record) as f:
                book = json.load(f)
        book[kind] = summary
        tmp = args.record + ".tmp"
        with open(tmp, "w") as f:
            json.dump(book, f, indent=1, sort_keys=True)
        os.replace(tmp, args.record)  # a reader never sees a partial file
        print(f"INFO: recorded '{kind}' into {args.record}")
    return summary


def main() -> None:
    print(json.dumps(run(parser().parse_args()), allow_nan=False))


if __name__ == "__main__":
    main()
