"""Configurations the port is measured on.

``replica_synthetic_cfg``: the Replica-room workload of the JAX package's
``bench.py`` (room0's bound, 680x1200 camera, 32+16 samples per ray,
tracking 10 iters x 200 px, mapping 60 iters x 1000 px over a 5-frame
window every 5th frame, coarse mapper on, BA off) on the procedural
synthetic room, with random decoder weights from the config's seed.  A
keyframe is kept every 5th frame (the Replica config keeps every 50th)
so the 5-frame window fills within a short run.  It meshes as the
Replica configs do: the room as marching-cubes bound, resolution 256,
``eval_rec`` on (a final mesh and its all-frames eval_rec variant).

``replica_ba_cfg``: the same room with local bundle adjustment on, as
``configs/nice_slam.yaml`` (the NICE default every Replica, ScanNet, TUM,
Apartment and CoFusion config inherits) sets it: the window poses but the
oldest are optimised with the map, at ``BA_cam_lr`` in the color stage
and lr 0 before it.  BA engages once the store holds five keyframes, so
with a keyframe every 5th frame the default 30 frames give BA mapping
events at frames 25 and 29 (the last, 5 calls of the final refinement).
With ``NICE_SLAM_TORCH_SPATIAL=1`` and a device list the same room runs
BA over grids sharded into x-slabs (``parallel/grid_sharding.py``).

``box_quality_cfg``: the 30-frame tracked box run whose ATE the quality
gate of the JAX package holds to 9.5 cm (box.yaml on nice_slam.yaml,
coarse off, 0.25 rad orbit, mapping iters 60, first 400); ``ba`` turns
bundle adjustment on (box.yaml turns it off).

``replica_imap_cfg``: the iMAP* model at the Replica iMAP configs' widths
(``configs/Replica/replica_imap.yaml`` on ``configs/imap.yaml``: tracking
50 iters x 5000 px, mapping 300 iters x 5000 px over a 5-frame window
every 5th frame with 'global' selection, 32 + 12 importance samples per
ray, a 32-sample free-space regulariser, BA off, perturb 0, the final
colour refinement on) on the synthetic room with room0's bound at
680x1200, random decoder weights from the config's seed.  Cut for time:
``n_frames`` frames, the first mapping ``iters_first`` iterations (config
1500), a keyframe every 5th frame (config 50), one final mesh (the config
also writes its ``eval_rec`` variant).  ``ba`` turns bundle adjustment on
(``configs/imap.yaml`` turns it off; the camera learning rate is then on
in every iteration) and maps and keeps a keyframe every 2nd frame: BA
engages once the store holds five keyframes (frames 0-8), so 12 frames
give BA calls at frame 10 (3 calls) and frame 11 (the final
refinement's 5); with a mapping event every 5th frame, as the config
has it, 12 frames keep only 3 keyframes.

``box_imap_quality_cfg``: the JAX package's ``selfcheck --imap`` run
(box.yaml on imap.yaml, 30 frames, 0.25 rad orbit, mapping iters 60,
first 400, coarse off, resolution 128) whose per-seed ATE
``tests/test_quality_gates.py`` holds to 5 cm.  ``ba`` turns bundle
adjustment on at the box's own rate, a mapping event and a keyframe every
5th frame: five keyframes (frames 0-20) give BA calls at frame 25 (3
calls) and frame 29 (the final refinement's 5).
"""

from __future__ import annotations

import os
from typing import Any, Dict

from nice_slam_torch.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REPLICA_ROOM = [[-2.9, 8.9], [-3.2, 5.5], [-3.5, 3.3]]


def replica_synthetic_cfg(out_dir: str, n_frames: int = 12,
                          iters_first: int = 1500) -> Dict[str, Any]:
    cfg = load_config(os.path.join(ROOT, "configs", "nice_slam.yaml"))
    cfg.update(dataset="synthetic", verbose=False, seed=0, coarse=True)
    cfg["pretrained_decoders"] = {"coarse": "", "middle_fine": ""}
    cfg["data"] = {"dim": 3, "n_frames": n_frames, "room": REPLICA_ROOM,
                   "output": out_dir, "orbit_radians": 0.3}
    cfg["mapping"].update(bound=REPLICA_ROOM, marching_cubes_bound=REPLICA_ROOM,
                          BA=False, keyframe_every=5, iters_first=iters_first)
    cfg["meshing"]["eval_rec"] = True
    cfg["tracking"].update(ignore_edge_W=100, ignore_edge_H=100)
    return cfg


def replica_ba_cfg(out_dir: str, n_frames: int = 30,
                   iters_first: int = 1500) -> Dict[str, Any]:
    cfg = replica_synthetic_cfg(out_dir, n_frames, iters_first)
    cfg["mapping"]["BA"] = True
    return cfg


def box_quality_cfg(out_dir: str, ba: bool = False) -> Dict[str, Any]:
    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "nice_slam.yaml"))
    for k in ("coarse", "middle_fine"):
        cfg["pretrained_decoders"][k] = os.path.join(
            ROOT, cfg["pretrained_decoders"][k])
    cfg["coarse"] = False
    cfg["verbose"] = False
    cfg["data"].update(n_frames=30, orbit_radians=0.25, output=out_dir)
    cfg["mapping"].update(iters=60, iters_first=400, BA=ba)
    return cfg


def replica_imap_cfg(out_dir: str, n_frames: int = 12,
                     iters_first: int = 1500, ba: bool = False) -> Dict[str, Any]:
    cfg = load_config(os.path.join(ROOT, "configs", "Replica", "replica_imap.yaml"),
                      os.path.join(ROOT, "configs", "imap.yaml"))
    cfg.update(dataset="synthetic", verbose=False, seed=0)
    cfg["data"] = {"dim": 3, "n_frames": n_frames, "room": REPLICA_ROOM,
                   "output": out_dir, "orbit_radians": 0.3}
    cfg["mapping"].update(bound=REPLICA_ROOM, marching_cubes_bound=REPLICA_ROOM,
                          BA=False, keyframe_every=5, iters_first=iters_first)
    cfg["meshing"]["eval_rec"] = False
    if ba:
        cfg["mapping"].update(BA=True, every_frame=2, keyframe_every=2)
    return cfg


def box_imap_quality_cfg(out_dir: str, ba: bool = False) -> Dict[str, Any]:
    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "imap.yaml"))
    cfg["coarse"] = False
    cfg["verbose"] = False
    cfg["data"].update(n_frames=30, orbit_radians=0.25, output=out_dir)
    cfg["mapping"].update(iters=60, iters_first=400, BA=ba)
    return cfg
