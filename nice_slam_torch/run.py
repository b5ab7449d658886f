"""Command-line entry point of the PyTorch port.

    python -m nice_slam_torch.run configs/<scene>.yaml [--nice | --imap]
        [--input_folder DIR] [--output DIR] [--resume] [--device cuda|cpu]

``--nice`` (the default) runs the hierarchical-grid model over
``configs/nice_slam.yaml``, ``--imap`` the single-MLP iMAP* model over
``configs/imap.yaml``.  It loads the config over that base, runs the strict
schedule and writes the JAX package's output tree to the output
directory (``ckpts/``, ``mesh/``, ``tracking_vis/``, ``mapping_vis/``)
plus ``poses.npz`` (estimated and true poses) and ``timings.json``.
``--resume`` continues from the output directory's last checkpoint.  The
CUDA kernels are built with ``nvcc``, the mesh kernels with ``g++``, on
first use.
"""

from __future__ import annotations

import argparse
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); returns the
    finished system."""
    parser = argparse.ArgumentParser(
        description="NICE-SLAM on PyTorch/CUDA: dense neural-implicit RGB-D SLAM.")
    parser.add_argument("config", type=str, help="path to scene config file")
    parser.add_argument("--input_folder", type=str, default=None,
                        help="override cfg data.input_folder")
    parser.add_argument("--output", type=str, default=None,
                        help="override cfg data.output")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the output folder's last checkpoint")
    group = parser.add_mutually_exclusive_group()
    group.add_argument("--nice", dest="nice", action="store_true",
                       help="hierarchical-grid model (the default)")
    group.add_argument("--imap", dest="nice", action="store_false",
                       help="single-MLP iMAP* model")
    parser.set_defaults(nice=True)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from nice_slam_torch.config import load_config
    from nice_slam_torch.slam.slam import NiceSLAM
    from nice_slam_torch.tools.eval_ate import ate_rmse

    base = os.path.join(ROOT, "configs",
                        "nice_slam.yaml" if args.nice else "imap.yaml")
    cfg = load_config(args.config, base)
    slam = NiceSLAM(cfg, args, device=args.device)
    if args.resume:
        slam.resume()
    slam.run()
    est = slam.estimate_c2w_list.cpu().numpy()
    print(f"INFO: ATE RMSE {100 * ate_rmse(est, slam.gt_c2w_list):.3f} cm; "
          f"{slam.timings.get('fps', 0.0):.3f} frames/s; outputs in "
          f"{slam.output}")
    return slam


if __name__ == "__main__":
    main()
