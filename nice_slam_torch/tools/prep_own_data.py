"""Generate a scene config from an Open3D-style reconstruction folder; the
port's counterpart of the JAX package's ``tools/prep_own_data.py``
(reference src/tools/prep_own_data.py).

Reads ``intrinsic.json`` for the camera, derives the scene bound from the
reconstruction mesh's bounding box +-1 m, and writes a config inheriting
``configs/Own/own.yaml``.  Host only (numpy, YAML).

CLI: python -m nice_slam_torch.tools.prep_own_data --ouput_config C
     --scene_folder F
(the reference's 'ouput' spelling is kept; --output_config is accepted)
"""

from __future__ import annotations

import argparse
import json
import os

from nice_slam_torch.utils.meshlib import read_ply


def main(argv=None) -> dict:
    """Write the config for the flags ``argv``; returns it."""
    import yaml

    parser = argparse.ArgumentParser(description="Arguments for prep own data.")
    parser.add_argument("--ouput_config", "--output_config", dest="ouput_config",
                        type=str, required=True)
    parser.add_argument("--scene_folder", type=str, required=True)
    args = parser.parse_args(argv)

    with open(os.path.join(args.scene_folder, "intrinsic.json")) as f:
        intrinsic = json.load(f)
    K = intrinsic["intrinsic_matrix"]  # column-major 3x3

    config = {
        "inherit_from": "configs/Own/own.yaml",
        "cam": {"H": intrinsic["height"], "W": intrinsic["width"],
                "fx": K[0], "fy": K[4], "cx": K[6], "cy": K[7]},
        "data": {"input_folder": args.scene_folder,
                 "output": f"output/Own/{os.path.basename(args.scene_folder)}"},
    }
    verts, _, _ = read_ply(os.path.join(args.scene_folder, "scene", "integrated.ply"))
    lo = verts.min(axis=0) - 1.0
    hi = verts.max(axis=0) + 1.0
    bound = [[float(a), float(b)] for a, b in zip(lo, hi)]
    config["mapping"] = {"bound": bound, "marching_cubes_bound": bound}

    with open(args.ouput_config, "w") as f:
        yaml.safe_dump(config, f, default_flow_style=None)
    print(f"config written to {args.ouput_config}")
    return config


if __name__ == "__main__":
    main()
