#!/usr/bin/env python
"""The JAX package's 30-frame tracked box run and its final mesh, for the
box-mesh statistic the port's ``chip_smoke.py`` quality phase gates.

    JAX_PLATFORMS=cpu python scripts/jax_box_mesh.py [--seed 42] [--out DIR]

Runs ``configs/Synthetic/box.yaml`` on ``configs/nice_slam.yaml`` as the
port's ``box_quality_cfg`` does (coarse off, 30 frames, 0.25 rad orbit,
mapping iters 60, first 400, the given pixel seed), then prints one JSON
line: the ATE, the final mesh's vertex and face counts, and the median
over its vertices of | max(|x|,|y|,|z|) - 2 | in metres (the walls are at
+-2 m).
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default=os.path.join(HERE, "output", "jax_box_mesh"))
    args = ap.parse_args()

    import numpy as np

    from nice_slam_tpu.config import load_config
    from nice_slam_tpu.slam.slam import NiceSLAM
    from nice_slam_tpu.tools.eval_ate import align
    from nice_slam_tpu.utils.cache import setup_cache
    from nice_slam_tpu.utils.meshlib import read_ply

    setup_cache(HERE)
    cfg = load_config(os.path.join(HERE, "configs", "Synthetic", "box.yaml"),
                      os.path.join(HERE, "configs", "nice_slam.yaml"))
    for k in ("coarse", "middle_fine"):
        cfg["pretrained_decoders"][k] = os.path.join(HERE, cfg["pretrained_decoders"][k])
    cfg.update(coarse=False, verbose=False, seed=args.seed)
    cfg["data"].update(n_frames=30, orbit_radians=0.25, output=args.out)
    cfg["mapping"].update(iters=60, iters_first=400)
    t0 = time.perf_counter()
    slam = NiceSLAM(cfg, argparse.Namespace(nice=True, input_folder=None, output=None))
    slam.run()
    est, gt = slam.estimate_c2w_list, slam.gt_c2w_list
    _, _, err = align(est[:, :3, 3].T.astype(np.float64), gt[:, :3, 3].T.astype(np.float64))
    verts, faces, _ = read_ply(os.path.join(args.out, "mesh", "final_mesh.ply"))
    print(json.dumps({
        "seed": args.seed, "ate_rmse_cm": 100 * float(np.sqrt(np.mean(err ** 2))),
        "vertices": len(verts), "faces": len(faces),
        "mesh_wall_m": float(np.median(np.abs(np.abs(verts).max(axis=1) - 2.0))),
        "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
