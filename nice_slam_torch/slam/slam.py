"""The NiceSLAM system: counterpart of the JAX package's ``slam/slam.py``, for
the NICE model (``args.nice``) and the iMAP* model, on the strict, loose
and free schedules.

The strict schedule: map frame 0 (main mapper, then coarse mapper), then
for every later frame track it, and on every ``every_frame``-th frame (and
the last) map it with the main mapper and then the coarse mapper.  The
iMAP* model has no coarse mapper and no pretrained decoders, and splits
each mapping event after the first into 3 calls (the final color
refinement into 5, as for NICE).  Frames are read on a background thread;
a frame that is only tracked ships just its pre-drawn tracking pixels to
the device.

Any other ``sync_method`` runs the threaded schedule: after a warm-up on
the calling thread, the tracker, the mapper and the coarse mapper are
host threads polling ``idx`` / ``mapping_idx``, each issuing its work on
its own CUDA stream.  ``loose`` keeps the tracker within ``every +
every // 2`` frames of the last mapped frame and maps every ``every //
2`` frames; ``free`` has no gates.  Shared device data passes between the
streams through ``Handoff``s (``slam/handoff.py``).

Stage times are host clocks around work that ends in a synchronize of
the calling thread's stream, so they are device-true for that thread.

Over several devices (``devices``: a list, which may repeat one device),
as the JAX package over several chips: the main mapper splits its rays
over them (ray data parallelism), the mesher its lattice chunks, and the
coarse mapper runs on the last device (``NICE_SLAM_TORCH_COARSE_DEVICE``,
default 1), its grid merged back to the main state's device; the strict
loop then issues the main and the coarse mapping calls with no host sync
between them, so the main call's stage time is its issue time and the
coarse call's ends when both devices are done.  With
``NICE_SLAM_TORCH_SPATIAL`` (``parallel/grid_sharding.py``) the grids are
spatially sharded over the devices instead, which turns the ray data
parallelism, the lattice split and the coarse device off.  The threaded
schedules run over the same list: each thread has a CUDA stream of its
own on every card in use, current on all of them, so its kernels, its
peer copies and its hand-offs stay on its streams wherever they run.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import threading
import time
from contextlib import ExitStack
from typing import Any, Dict, List

import numpy as np
import torch

from nice_slam_torch.models.pretrain import load_pretrain
from nice_slam_torch.models.scene import build_scene
from nice_slam_torch.ops.geometry import (
    c2w44,
    pose_from_tensor,
    tensor_from_pose,
)
from nice_slam_torch.ops.render import RenderConfig
from nice_slam_torch.parallel.grid_sharding import maybe_shard_state, shard_scene_grids
from nice_slam_torch.parallel.sharding import make_mesh
from nice_slam_torch.slam.handoff import Handoff, cuda_cards, hold
from nice_slam_torch.slam.keyframes import KeyframeStore
from nice_slam_torch.slam.mapper import Mapper, MapperConfig
from nice_slam_torch.slam.optim import tree_leaves
from nice_slam_torch.slam.tracker import (
    TrackerConfig,
    const_speed_init,
    presample_pixels,
    track_frame_sampled,
)
from nice_slam_torch.utils.datasets import Prefetcher, get_dataset
from nice_slam_torch.utils.logger import Logger, load_checkpoint
from nice_slam_torch.utils.mesher import Mesher
from nice_slam_torch.utils.visualizer import Visualizer


def update_cam(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Apply crop_size / crop_edge to the intrinsics."""
    cam = dict(cfg["cam"])
    H, W = cam["H"], cam["W"]
    fx, fy, cx, cy = cam["fx"], cam["fy"], cam["cx"], cam["cy"]
    if cam.get("crop_size") is not None:
        th, tw = cam["crop_size"]
        fx, cx = fx * tw / W, cx * tw / W
        fy, cy = fy * th / H, cy * th / H
        H, W = th, tw
    edge = cam.get("crop_edge", 0)
    if edge > 0:
        H -= 2 * edge
        W -= 2 * edge
        cx -= edge
        cy -= edge
    cam.update({"H": H, "W": W, "fx": fx, "fy": fy, "cx": cx, "cy": cy})
    return cam


def resolve_devices(device="cuda", devices=None) -> List[torch.device]:
    """The devices a system runs on: ``devices`` when given (a list, which
    may repeat one device); else ``cuda`` means every visible CUDA device
    and any other device (``cuda:i``, ``cpu``) that device alone."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("an empty device list")
        return devs
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        return make_mesh()
    return [device]


class NiceSLAM:
    """The NICE-SLAM system on ``device`` (every visible CUDA device unless
    asked) or the explicit ``devices`` list, the scene and the poses on the
    first; ``args.nice`` false selects the iMAP* model."""

    def __init__(self, cfg: Dict[str, Any], args, device="cuda", devices=None):
        self.cfg = cfg
        self.sync_method = cfg["sync_method"]
        self.devices = resolve_devices(device, devices)
        self.device = self.devices[0]
        self.verbose = cfg["verbose"]
        self.nice = bool(getattr(args, "nice", True))
        self.coarse = bool(cfg["coarse"]) and self.nice
        self.scale = cfg["scale"]
        self.output = getattr(args, "output", None) or cfg["data"]["output"]
        os.makedirs(os.path.join(self.output, "mesh"), exist_ok=True)

        self.cam = update_cam(cfg)
        self.H, self.W = self.cam["H"], self.cam["W"]
        self.spec, self.state = build_scene(cfg, nice=self.nice,
                                            device=self.device)
        if self.nice:
            self.state = load_pretrain(cfg, self.spec, self.state, self.verbose)
        # spatial grid sharding: forced by NICE_SLAM_TORCH_SPATIAL=1, or
        # engaged when the dense grids exceed the device memory budget
        self.state, self.spatial_devices = maybe_shard_state(
            self.state, self.devices, self.verbose)
        multi = len(self.devices) > 1

        self.frame_reader = get_dataset(cfg, args, self.scale)
        self.n_img = len(self.frame_reader)
        self.estimate_c2w_list = torch.zeros((self.n_img, 4, 4),
                                             device=self.device)
        self.gt_c2w_list = np.zeros((self.n_img, 4, 4), np.float32)

        self.rcfg = RenderConfig.from_cfg(cfg)
        self.tcfg = TrackerConfig.from_cfg(cfg, self.cam, self.nice)
        self.mcfg = MapperConfig.from_cfg(cfg, self.cam, self.nice, False)
        self.keyframes = KeyframeStore(
            self.n_img // self.mcfg.keyframe_every + 3, self.H, self.W,
            self.device)
        self.mapper = Mapper(
            self.spec, self.mcfg, self.rcfg, self.device,
            save_selected_keyframes_info=cfg["mapping"].get(
                "save_selected_keyframes_info", False))
        self.coarse_mapper = None
        if self.coarse:
            self.coarse_mapper = Mapper(
                self.spec, MapperConfig.from_cfg(cfg, self.cam, True, True),
                self.rcfg, self.device, seed=7)
        if multi and self.spatial_devices is None:
            # ray data parallelism (off by itself over sharded grids)
            self.mapper.devices = self.devices
            if self.coarse_mapper is not None:
                self.coarse_mapper.devices = self.devices
                # the coarse mapper on its own device: main and coarse
                # mapping share no grid, so their calls run concurrently
                if os.environ.get("NICE_SLAM_TORCH_COARSE_DEVICE", "1") == "1":
                    self.coarse_mapper.pin(self.devices[-1])
        self.seed = int(cfg.get("seed", 42))
        self.logger = Logger(self.output, self.spec, self.verbose)
        in_demo = "Demo" in self.output
        self.tracking_visualizer = Visualizer(
            cfg["tracking"]["vis_freq"], cfg["tracking"]["vis_inside_freq"],
            os.path.join(self.output, "vis" if in_demo else "tracking_vis"),
            self.spec, self.rcfg, self.cam, self.verbose)
        self.mapping_visualizer = None
        if not in_demo:  # the reference draws no mapping panels in Demo
            self.mapping_visualizer = Visualizer(
                cfg["mapping"]["vis_freq"], cfg["mapping"]["vis_inside_freq"],
                os.path.join(self.output, "mapping_vis"), self.spec, self.rcfg,
                self.cam, self.verbose)
        self.mesher = None
        if cfg.get("meshing") is not None:
            self.mesher = Mesher(cfg, self.cam, self.spec, self.rcfg)
            if multi:
                self.mesher.devices = self.devices  # lattice data parallelism
        # one record per mesh written: path, seconds, vertices, faces, the
        # mesher's device chunks and per-step host seconds
        self.meshes: List[Dict[str, Any]] = []
        self._start_idx = 0
        self.idx = 0               # latest tracked frame
        self.mapping_idx = -1      # latest frame of the main mapper
        self.mapping_cnt = 0
        # the scene state and the pose list, shared by the threads of the
        # loose and free schedules (keyframes carry their own Handoff)
        self._state_handoff = Handoff(self.devices)
        self._est_handoff = Handoff(self.devices)
        # the CUDA streams of each thread of the last threaded run, one per
        # card in use
        self.streams: Dict[str, Dict[torch.device, torch.cuda.Stream]] = {}
        self.timings = {"tracking_s": 0.0, "mapping_s": 0.0,
                        "coarse_mapping_s": 0.0, "meshing_s": 0.0, "frames": 0,
                        "tracked_frames": 0, "mapping_events": 0,
                        "coarse_mapping_events": 0}

    def _sync(self) -> None:
        """Wait for the calling thread's stream on every device in use (the
        other threads' streams run on)."""
        for dev in set(self.devices):  # the coarse mapper's is the last
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()

    def _snapshot(self):
        """The current scene state, ready to read on this thread's stream."""
        with self._state_handoff.access():
            state = self.state
        hold(tree_leaves(state))
        return state

    def _publish(self, new_state, coarse: bool) -> None:
        """Make a mapper's output the current state.  The coarse mapper
        owns only the coarse grid; the main mapper's output carries a copy
        of the coarse grid from its snapshot, which the current one
        replaces (a concurrent coarse update is kept)."""
        with self._state_handoff.access():
            if coarse:
                grids = dict(self.state.grids)
                gc = new_state.grids["grid_coarse"]
                if self.coarse_mapper.device is not None:
                    # from the coarse mapper's device back to the main
                    # state's (ordered on both devices' streams)
                    gc = gc.to(self.device, non_blocking=True)
                grids["grid_coarse"] = gc
                self.state = self.state._replace(grids=grids)
            else:
                grids = dict(new_state.grids)
                if "grid_coarse" in self.state.grids:
                    grids["grid_coarse"] = self.state.grids["grid_coarse"]
                self.state = new_state._replace(grids=grids)

    def _poses(self, *idxs: int) -> List[torch.Tensor]:
        """Copies of the estimated poses of frames ``idxs``."""
        with self._est_handoff.access():
            return [self.estimate_c2w_list[i].clone() for i in idxs]

    def _set_pose(self, idx: int, c2w: torch.Tensor) -> None:
        with self._est_handoff.access():
            self.estimate_c2w_list[idx] = c2w

    def _all_poses(self) -> torch.Tensor:
        with self._est_handoff.access():
            return self.estimate_c2w_list.clone()

    def _to_dev(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=self.device)

    # ------------------------------------------------------------------
    def track_one(self, idx: int, pix, gt_c2w, color=None, depth=None) -> None:
        """Track frame ``idx`` from its pre-drawn pixels ``pix`` = (i, j,
        depth, color) arrays shaped (iters, pixels[, 3]).  The full frame
        (``color``, ``depth``) is read only for a residual panel."""
        t0 = time.perf_counter()
        self.gt_c2w_list[idx] = gt_c2w
        vis = self.tracking_visualizer
        state = self._snapshot()
        if self.tcfg.gt_camera:
            c2w = self._to_dev(gt_c2w)
            self._set_pose(idx, c2w)
            if idx % vis.freq == 0:
                vis.vis(idx, 0, depth, color, c2w, state)
        else:
            pre, pre_pre = self._poses(idx - 1, max(idx - 2, 0))
            init = pre
            if self.tcfg.const_speed_assumption and idx >= 2:
                init = const_speed_init(pre, pre_pre)
            init_tensor = tensor_from_pose(init)
            pi, pj, pd, pc = (self._to_dev(a) for a in pix)
            cand, losses, cams, _ = track_frame_sampled(
                self.spec, state, init_tensor, pi, pj, pd, pc, self.tcfg,
                self.rcfg)
            self._set_pose(idx, c2w44(pose_from_tensor(cand)))
            if idx % vis.freq == 0:
                # iteration it renders at its pre-step pose
                for it in range(0, self.tcfg.iters, vis.inside_freq):
                    vis.vis(idx, it, depth, color,
                            init_tensor if it == 0 else cams[it - 1], state)
            if self.verbose:
                l = losses.cpu().numpy()
                print(f"Tracking Frame {idx}  re-rendering loss: "
                      f"{l[0]:.2f}->{l[-1]:.2f}")
        self._sync()
        self.idx = idx  # the pose is written and visible to other streams
        self.timings["tracking_s"] += time.perf_counter() - t0
        self.timings["tracked_frames"] += 1

    def map_one(self, idx: int, color: torch.Tensor, depth: torch.Tensor,
                gt_c2w, init: bool, coarse: bool = False,
                sync: bool = True) -> None:
        """One mapping event of the main (or coarse) mapper on frame
        ``idx`` (color and depth on the device).  ``sync`` false leaves its
        device work queued (the coarse call on its own device follows)."""
        t0 = time.perf_counter()
        mapper = self.coarse_mapper if coarse else self.mapper
        cfg_m = self.cfg["mapping"]
        outer_joint_iters = 1
        if init:
            lr_factor = cfg_m["lr_first_factor"]
            num_joint_iters = cfg_m["iters_first"]
        else:
            lr_factor = cfg_m["lr_factor"]
            num_joint_iters = cfg_m["iters"]
            if idx == self.n_img - 1 and cfg_m["color_refine"] and not coarse:
                # final color refinement
                outer_joint_iters = 5
                mapper.mapping_window_size = self.mcfg.mapping_window_size * 2
                mapper.middle_iter_ratio = 0.0
                mapper.fine_iter_ratio = 0.0
                num_joint_iters *= 5
                mapper.fix_color = True
                mapper.frustum_feature_selection = False
            elif not self.nice:
                outer_joint_iters = 3
        num_joint_iters //= outer_joint_iters
        (cur_c2w,) = self._poses(idx)
        # the coarse mapper reads the keyframes the main mapper writes
        keyframes = self.keyframes.snapshot() if coarse else self.keyframes
        add_kf = (not coarse and (idx % self.mcfg.keyframe_every == 0
                                  or idx == self.n_img - 2)
                  and idx not in self.keyframes.frame_ids)
        # uploaded before the mapping work is queued: an upload after it
        # would wait for that work
        gt_kf = self._to_dev(gt_c2w) if add_kf else None
        vis_hook, vis_every = None, 0
        vis = self.mapping_visualizer
        if (not coarse and vis is not None and idx % vis.freq == 0
                and not (idx == 0 and cfg_m["no_vis_on_first_frame"])):
            vis_every = vis.inside_freq

            def vis_hook(it, state):
                vis.vis(idx, it, depth, color, self._poses(idx)[0], state)

        for outer in range(outer_joint_iters):
            BA = len(keyframes) > 4 and cfg_m["BA"] and not coarse
            new_state, cur_out, losses = mapper.optimize_map(
                self._snapshot(), num_joint_iters, lr_factor, color, depth,
                keyframes, cur_c2w, BA, vis_hook=vis_hook,
                vis_every=vis_every, idx=idx, gt_cur_c2w=gt_c2w)
            self._publish(new_state, coarse)
            if BA and cur_out is not None:
                cur_c2w = cur_out
                self._set_pose(idx, cur_c2w)
            if outer == outer_joint_iters - 1 and add_kf:
                self.keyframes.add(idx, color, depth, cur_c2w, gt_kf)
        if self.verbose:
            l = losses.cpu().numpy()
            print(f"{'Coarse ' if coarse else ''}Mapping Frame {idx}  loss: "
                  f"{l[0]:.2f}->{l[-1]:.2f}")
        if sync:
            self._sync()
        if not coarse:
            self.mapping_idx = idx
            self.mapping_cnt += 1
        key = "coarse_mapping" if coarse else "mapping"
        self.timings[key + "_s"] += time.perf_counter() - t0
        self.timings[key + "_events"] += 1

    def log_and_mesh(self, idx: int) -> None:
        """The checkpoint and meshes due after the main mapping event of
        frame ``idx``."""
        cfg_m = self.cfg["mapping"]
        last = idx == self.n_img - 1
        if last or (idx % cfg_m["ckpt_freq"] == 0
                    and not (idx == 0 and cfg_m["no_log_on_first_frame"])):
            self.logger.log(idx, self._snapshot(), self._all_poses(),
                            self.gt_c2w_list, self.keyframes.frame_ids,
                            selected_keyframes=self.mapper.selected_keyframes)
        if self.mesher is None:
            return
        mesh_dir = os.path.join(self.output, "mesh")
        if idx % cfg_m["mesh_freq"] == 0 and not (
                idx == 0 and cfg_m["no_mesh_on_first_frame"]):
            self._mesh(os.path.join(mesh_dir, f"{idx:05d}_mesh.ply"), idx)
        if last:
            final = os.path.join(mesh_dir, "final_mesh.ply")
            self._mesh(final, idx)
            shutil.copyfile(final, os.path.join(mesh_dir, f"{idx:05d}_mesh.ply"))
            if self.cfg["meshing"]["eval_rec"]:
                self._mesh(os.path.join(mesh_dir, "final_mesh_eval_rec.ply"), idx,
                           eval_rec=True)

    def _mesh(self, path: str, idx: int, eval_rec: bool = False) -> None:
        t0 = time.perf_counter()
        m = self.cfg["meshing"]
        self.mesher.get_mesh(
            path, self._snapshot(), self.keyframes, self._all_poses(), idx,
            show_forecast=m["mesh_coarse_level"] and not eval_rec,
            clean_mesh=m["clean_mesh"], get_mask_use_all_frames=eval_rec)
        self._sync()
        seconds = time.perf_counter() - t0
        self.timings["meshing_s"] += seconds
        self.meshes.append(dict(self.mesher.last, path=path, seconds=seconds))

    def resume(self) -> int:
        """Restore the output folder's last checkpoint (grids, decoders,
        poses, and the keyframes re-read from the dataset); ``run()`` then
        starts at the frame after it.  Returns that frame (0 without a
        checkpoint)."""
        ckpts = sorted(glob.glob(os.path.join(self.output, "ckpts", "*.tar")))
        if not ckpts:
            return 0
        self.state, est, gt, kf_list, idx = load_checkpoint(
            ckpts[-1], self.spec, self.state, self.device)
        if self.spatial_devices is not None:  # checkpoints are dense
            self.state = self.state._replace(grids=shard_scene_grids(
                self.state.grids, self.spatial_devices))
        n = min(len(est), self.n_img)
        self.estimate_c2w_list[:n] = self._to_dev(est[:n])
        self.gt_c2w_list[:n] = gt[:n]
        # keyframe images are not checkpointed: read them again
        for kf_idx in kf_list:
            _, color, depth, gt_c2w = self.frame_reader[kf_idx]
            self.keyframes.add(kf_idx, color, depth,
                               self.estimate_c2w_list[kf_idx], gt_c2w)
        self._start_idx = idx + 1
        self.idx = self.mapping_idx = idx
        print(f"INFO: resumed from {ckpts[-1]} at frame {idx}")
        return self._start_idx

    # ------------------------------------------------------------------
    def _packer(self, item):
        """Runs on the reader thread: draw the tracking pixels of a frame."""
        idx, color, depth, c2w = item
        pix = None
        if idx > 0 and not self.tcfg.gt_camera:
            pix = presample_pixels(self.seed, idx, self.tcfg, color, depth)
        return idx, color, depth, c2w, pix

    def _should_map(self, idx: int) -> bool:
        return idx % self.mcfg.every_frame == 0 or idx == self.n_img - 1

    def _map_event(self, idx: int, color, depth, gt_c2w, init: bool) -> None:
        """Map frame ``idx`` (host arrays) with the main mapper, log and mesh
        what is due, then map it with the coarse mapper unless it is the
        last frame."""
        color_d, depth_d = self._to_dev(color), self._to_dev(depth)
        coarse = self.coarse_mapper is not None and idx != self.n_img - 1
        # the coarse mapper on its own device: no host sync between the two
        # calls, so they run concurrently (the coarse call's sync waits
        # for both)
        pinned = coarse and self.coarse_mapper.device is not None
        self.map_one(idx, color_d, depth_d, gt_c2w, init=init, sync=not pinned)
        self.log_and_mesh(idx)
        if coarse:
            self.map_one(idx, color_d, depth_d, gt_c2w, init=init, coarse=True)

    def run(self) -> None:
        t0 = time.perf_counter()
        if self.sync_method == "strict":
            self._run_strict()
        else:
            self._run_threaded()
        t = self.timings
        t["total_s"] = time.perf_counter() - t0
        t["frames"] = self.n_img - self._start_idx
        if t["frames"] > 0:
            t["fps"] = t["frames"] / max(t["total_s"], 1e-9)
        for skey, nkey, out in (
                ("tracking_s", "tracked_frames", "tracking_ms_per_frame"),
                ("mapping_s", "mapping_events", "mapping_ms_per_event"),
                ("coarse_mapping_s", "coarse_mapping_events",
                 "coarse_mapping_ms_per_event")):
            if t[nkey] > 0:
                t[out] = 1e3 * t[skey] / t[nkey]
        self.save()

    def _run_strict(self) -> None:
        prefetch = Prefetcher(self.frame_reader, depth=4, start=self._start_idx,
                              packer=self._packer)
        try:
            for idx, color, depth, gt_c2w, pix in prefetch:
                if idx == 0:
                    self._set_pose(0, self._to_dev(gt_c2w))
                    self.gt_c2w_list[0] = gt_c2w
                else:
                    self.track_one(idx, pix, gt_c2w, color, depth)
                if idx == 0 or self._should_map(idx):
                    self._map_event(idx, color, depth, gt_c2w, init=idx == 0)
        finally:
            prefetch.close()
        self._sync()

    def _run_threaded(self) -> None:
        """loose/free: a warm-up on the calling thread (map the start frame,
        track the next two, map the last of them), then the tracker and the
        mapper(s) as host threads, each on its own CUDA stream.  The tracker
        reads frames from a Prefetcher and publishes them, as host arrays,
        to a small cache the mappers read (each uploads on its own
        stream).  A thread failure is recorded and trips a shared abort
        that every poll loop watches; ``run`` then raises.  Over several
        cards each thread has a stream on every one of them (its kernels,
        its peer copies and its hand-offs order themselves on the current
        streams of the cards they touch), and the coarse mapper's card is
        its current device."""
        n, every = self.n_img, self.mcfg.every_frame
        loose = self.sync_method == "loose"
        frame_cache: Dict[int, tuple] = {}
        cache_lock = threading.Lock()

        def read_frame(idx: int):
            with cache_lock:
                if idx in frame_cache:
                    return frame_cache[idx]
            _, color, depth, gt_c2w = self.frame_reader[idx]
            return color, depth, gt_c2w

        def publish_frame(idx: int, color, depth, gt_c2w) -> None:
            with cache_lock:
                frame_cache[idx] = (color, depth, gt_c2w)
                for k in [k for k in frame_cache if k < idx - 2 * every]:
                    del frame_cache[k]

        try:
            idx0 = self.idx
            _, c0, d0, p0 = self.frame_reader[idx0]
            publish_frame(idx0, c0, d0, p0)
            if self._start_idx == 0:  # a resumed run keeps its estimate
                self._set_pose(idx0, self._to_dev(p0))
                self.gt_c2w_list[idx0] = p0
            self._map_event(idx0, c0, d0, p0, init=True)
            warm_last = idx0
            for t in range(idx0 + 1, min(idx0 + 3, n)):
                _, ct, dt, pt, pix = self._packer(self.frame_reader[t])
                publish_frame(t, ct, dt, pt)
                self.track_one(t, pix, pt, ct, dt)
                warm_last = t
            if warm_last > idx0:
                self._map_event(warm_last, *read_frame(warm_last), init=False)
            self._sync()
        except Exception as e:  # same contract as a thread failure
            raise RuntimeError(f"SLAM thread failed: {e!r}") from e

        errors: List[BaseException] = []
        abort = threading.Event()
        self._abort = abort

        def tracker() -> None:
            prefetch = Prefetcher(self.frame_reader, depth=3,
                                  start=warm_last + 1, packer=self._packer)
            try:
                for idx, color, depth, gt_c2w, pix in prefetch:
                    publish_frame(idx, color, depth, gt_c2w)
                    if loose:
                        while self.mapping_idx < idx - every - every // 2:
                            if abort.is_set():
                                return
                            time.sleep(0.005)
                    if abort.is_set():
                        return
                    self.track_one(idx, pix, gt_c2w, color, depth)
            finally:
                prefetch.close()

        def mapper(coarse: bool) -> None:
            prev = warm_last
            while not abort.is_set() and prev != n - 1:
                idx = self.idx
                due = idx != prev and (idx == n - 1 or not loose
                                       or idx >= prev + every // 2)
                if not due:
                    time.sleep(0.005)
                    continue
                prev = idx
                color, depth, gt_c2w = read_frame(idx)
                color_d, depth_d = self._to_dev(color), self._to_dev(depth)
                self.map_one(idx, color_d, depth_d, gt_c2w, init=False,
                             coarse=coarse)
                if not coarse:
                    self.log_and_mesh(idx)

        cards = cuda_cards(self.devices)

        def guarded(name: str, home: torch.device, fn, *args):
            streams = self.streams[name] = {c: torch.cuda.Stream(c) for c in cards}
            # the home card's stream entered last: its card stays current
            order = sorted(streams, key=lambda c: c == home)

            def body() -> None:
                try:
                    with ExitStack() as stack:
                        for c in order:
                            stack.enter_context(torch.cuda.stream(streams[c]))
                        fn(*args)
                except Exception as e:  # noqa: BLE001 -- reported by run()
                    errors.append(e)
                    abort.set()
            return threading.Thread(target=body, name=name, daemon=True)

        self.streams = {}
        threads = [guarded("mapper", self.device, mapper, False)]
        if self.coarse_mapper is not None:
            threads.append(guarded("coarse_mapper",
                                   self.coarse_mapper.device or self.device,
                                   mapper, True))
        threads.append(guarded("tracker", self.device, tracker))
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for c in cards:
            torch.cuda.synchronize(c)
        if errors:
            raise RuntimeError(f"SLAM thread failed: {errors[0]!r}") from errors[0]

    def save(self) -> None:
        """Write poses.npz (estimated and true c2w per frame) and
        timings.json to the output directory."""
        np.savez(os.path.join(self.output, "poses.npz"),
                 estimate_c2w_list=self.estimate_c2w_list.cpu().numpy(),
                 gt_c2w_list=self.gt_c2w_list)
        with open(os.path.join(self.output, "timings.json"), "w") as f:
            json.dump(self.timings, f, indent=2)
