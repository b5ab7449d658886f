"""Run viewer: replay a run's tracked trajectory over its mesh; the port's
counterpart of the root ``visualizer.py`` (reference visualizer.py:15-37).

    python -m nice_slam_torch.visualizer <config> [--output DIR]
        [--save_rendering] [--vis_input_frame] [--no_gt_traj]
        [--frontend auto|open3d|web|offline] [--port 8765] [--host ADDR]
        [--fps F] [--online] [--nice | --imap]

Loads the run's last checkpoint (``{output}/ckpts/*.tar``, the port's or
the JAX package's) and its meshes (``{output}/mesh/*.ply``, each attached
from its frame on), replays the estimated trajectory and, with
``--save_rendering``, writes ``{output}/vis.mp4`` (Motion-JPEG, see
``tools/viz.py``).  ``--frontend web`` serves the live scene to a browser
and stays up after the replay; ``--vis_input_frame`` writes each input
frame beside its depth in the plasma colour map to
``{output}/inputs/NNNNN.jpg``.  Everything runs on the host and needs no
imaging library.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Arguments to visualize the SLAM run.")
    p.add_argument("config", type=str)
    p.add_argument("--input_folder", type=str, default=None)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--save_rendering", action="store_true")
    p.add_argument("--vis_input_frame", action="store_true")
    p.add_argument("--no_gt_traj", action="store_true")
    p.add_argument("--online", action="store_true",
                   help="force the live Open3D window (default: live when open3d "
                        "imports, the offline raycast replay otherwise)")
    p.add_argument("--frontend", choices=["auto", "open3d", "web", "offline"],
                   default="auto",
                   help="viewer backend: 'web' serves a live browser viewer over "
                        "HTTP (works on headless hosts), 'open3d' the GUI window, "
                        "'offline' the raycast replay")
    p.add_argument("--port", type=int, default=8765, help="HTTP port for --frontend web")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address for --frontend web (loopback by default; "
                        "0.0.0.0 exposes it remotely)")
    p.add_argument("--fps", type=float, default=0.0,
                   help="pace the replay (e.g. 30 for web viewing; 0 = as fast as "
                        "possible)")
    group = p.add_mutually_exclusive_group()
    group.add_argument("--nice", dest="nice", action="store_true")
    group.add_argument("--imap", dest="nice", action="store_false")
    p.set_defaults(nice=True)
    return p


def input_panel(color: np.ndarray, depth: np.ndarray) -> np.ndarray:
    """An input frame (RGB in [0, 1]) beside its depth, scaled to the
    frame's maximum and coloured with the plasma map: (H, 2W, 3) uint8."""
    from nice_slam_torch.utils.colormap import apply_plasma

    rgb = (np.clip(color, 0, 1) * 255).astype(np.uint8)
    d = depth / max(float(depth.max()), 1e-6)
    d8 = (np.clip(d, 0, 1) * 255).astype(np.uint8)
    return np.concatenate([rgb, apply_plasma(d8)], axis=1)


def main(argv=None):
    """The viewer on ``argv``; returns the frontend (the web frontend's
    caller never gets it back: it serves until interrupted)."""
    args = parser().parse_args(argv)

    import torch

    from nice_slam_torch.config import load_config
    from nice_slam_torch.tools.viz import make_frontend

    base = os.path.join(ROOT, "configs", "nice_slam.yaml" if args.nice else "imap.yaml")
    cfg = load_config(args.config, base)
    scale = cfg["scale"]
    output = args.output or cfg["data"]["output"]

    ckptsdir = os.path.join(output, "ckpts")
    ckpts = [os.path.join(ckptsdir, f)
             for f in sorted(os.listdir(ckptsdir)) if "tar" in f]
    if not ckpts:
        raise SystemExit(f"no checkpoints in {ckptsdir}")
    print("Get ckpt :", ckpts[-1])
    ckpt = torch.load(ckpts[-1], map_location="cpu", weights_only=False)
    estimate_c2w_list = np.asarray(ckpt["estimate_c2w_list"], np.float32)
    gt_c2w_list = np.asarray(ckpt["gt_c2w_list"], np.float32)
    N = int(ckpt["idx"])
    estimate_c2w_list[:, :3, 3] /= scale
    gt_c2w_list[:, :3, 3] /= scale

    frontend = make_frontend(
        output, init_pose=estimate_c2w_list[0], save_rendering=args.save_rendering,
        estimate_c2w_list=estimate_c2w_list,
        gt_c2w_list=None if args.no_gt_traj else gt_c2w_list,
        online=True if args.online else None,
        frontend=None if args.frontend == "auto" else args.frontend,
        port=args.port, host=args.host)

    frame_reader = None
    if args.vis_input_frame:
        # the input RGB-D stream beside the replay (the reference shows it
        # in a window, reference visualizer.py:60-71)
        from nice_slam_torch.utils.datasets import get_dataset

        frame_reader = get_dataset(cfg, args, scale)
        os.makedirs(os.path.join(output, "inputs"), exist_ok=True)

    meshes = sorted(glob.glob(f"{output}/mesh/*.ply"))
    mesh_i = 0
    for i in range(0, N + 1):
        if frame_reader is not None and i < len(frame_reader):
            from nice_slam_torch.utils.jpeg import write_jpeg

            _, color, depth, _ = frame_reader[i]
            write_jpeg(os.path.join(output, "inputs", f"{i:05d}.jpg"),
                       input_panel(np.asarray(color), np.asarray(depth)))
        # attach the freshest mesh at this frame (reference
        # visualizer.py:72-79 streams meshes as they appear)
        while (mesh_i < len(meshes)
               and os.path.basename(meshes[mesh_i])[:5].isdigit()
               and int(os.path.basename(meshes[mesh_i])[:5]) <= i):
            frontend.update_mesh(meshes[mesh_i])
            mesh_i += 1
        if frontend.renderer is None and meshes:
            frontend.update_mesh(meshes[-1])
        frontend.update_pose(i, estimate_c2w_list[i])
        if args.fps > 0:
            time.sleep(1.0 / args.fps)
        if i % 50 == 0:
            print(f"rendered frame {i}/{N}")

    if args.save_rendering:
        path = os.path.join(output, "vis.mp4")
        frontend.finalize_video(path)
        print(f"video saved at {path}")
    if args.frontend == "web":
        frontend.finalize_video("")  # flags 'done' in the HUD
        print("replay finished; web viewer stays up (ctrl-c to exit)", flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
    return frontend


if __name__ == "__main__":
    main()
