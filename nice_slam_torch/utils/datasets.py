"""RGB-D dataset readers: counterpart of the JAX package's ``utils/datasets.py``.

Frames come back as host numpy arrays (color (H, W, 3) f32 in [0, 1],
depth (H, W) f32 metres, c2w (4, 4) f32); the SLAM loop moves to the
device what it needs.  Files are decoded and resampled by the port's own
``utils/imageio.py`` (OpenCV's pixels, no imaging library needed) and
``utils/exr.py``.  The readers keep the reference's preprocessing order:
decode, optional undistortion (color only), color / 255, depth /
png_depth_scale * scale, resize of the color to the depth's shape,
resize to crop_size (bilinear color, nearest depth) and crop_edge, the
y/z axis flips of each dataset's poses, ScanNet's numeric frame order,
and TUM's timestamp association (<= 0.08 s) with frame-rate subsampling
and first-pose normalization.  ``Synthetic`` is the procedural box room
(bare or furnished).
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from typing import Any, Dict, List, Tuple

import numpy as np

from nice_slam_torch.ops.geometry import as_intrinsics_matrix
from nice_slam_torch.utils.exr import read_exr_depth
from nice_slam_torch.utils.imageio import (
    imread_color,
    imread_unchanged,
    remap,
    resize_linear,
    resize_nearest,
    undistort_map,
)


def readEXR_onlydepth(filename: str) -> np.ndarray:
    """The depth channel of an EXR file (CoFusion), read by the port's
    scanline codec (``utils/exr.py``)."""
    return read_exr_depth(filename)


class BaseDataset:
    """Sequence of (index, color[H,W,3] f32, depth[H,W] f32, c2w[4,4] f32)."""

    def __init__(self, cfg: Dict[str, Any], args=None, scale: float = 1.0):
        self.name = cfg["dataset"]
        self.scale = scale
        self.png_depth_scale = cfg["cam"]["png_depth_scale"]
        self.H = cfg["cam"]["H"]
        self.W = cfg["cam"]["W"]
        self.fx = cfg["cam"]["fx"]
        self.fy = cfg["cam"]["fy"]
        self.cx = cfg["cam"]["cx"]
        self.cy = cfg["cam"]["cy"]
        self.distortion = (
            np.array(cfg["cam"]["distortion"]) if "distortion" in cfg["cam"] else None
        )
        self.crop_size = cfg["cam"].get("crop_size")
        self.crop_edge = cfg["cam"]["crop_edge"]
        input_folder = getattr(args, "input_folder", None) if args else None
        self.input_folder = input_folder or cfg["data"].get("input_folder", "")
        self.color_paths: List[str] = []
        self.depth_paths: List[str] = []
        self.poses: List[np.ndarray] = []
        self.n_img = 0
        self._undistort_maps = None

    def __len__(self) -> int:
        return self.n_img

    def _read_depth(self, path: str) -> np.ndarray:
        if path.endswith(".exr"):
            return readEXR_onlydepth(path)
        return imread_unchanged(path).astype(np.float32)

    def __getitem__(self, index: int):
        color = imread_color(self.color_paths[index])
        depth = self._read_depth(self.depth_paths[index])
        if self.distortion is not None:
            if self._undistort_maps is None:  # one map per reader
                K = as_intrinsics_matrix([self.fx, self.fy, self.cx, self.cy])
                self._undistort_maps = undistort_map(
                    K, self.distortion, color.shape[0], color.shape[1])
            color = remap(color, self._undistort_maps)
        color = color.astype(np.float32) / 255.0
        depth = depth.astype(np.float32) / self.png_depth_scale * self.scale
        H, W = depth.shape
        if color.shape[:2] != (H, W):
            color = resize_linear(color, (H, W))
        if self.crop_size is not None:
            th, tw = self.crop_size
            color = resize_linear(color, (th, tw))
            depth = resize_nearest(depth, (th, tw))
        edge = self.crop_edge
        if edge > 0:
            color = color[edge:-edge, edge:-edge]
            depth = depth[edge:-edge, edge:-edge]
        pose = self.poses[index].copy()
        pose[:3, 3] *= self.scale
        return index, color, depth, pose.astype(np.float32)


class Replica(BaseDataset):
    """Replica renders: results/frame*.jpg + depth*.png + traj.txt."""

    def __init__(self, cfg, args=None, scale=1.0):
        super().__init__(cfg, args, scale)
        self.color_paths = sorted(glob.glob(f"{self.input_folder}/results/frame*.jpg"))
        self.depth_paths = sorted(glob.glob(f"{self.input_folder}/results/depth*.png"))
        self.n_img = len(self.color_paths)
        with open(f"{self.input_folder}/traj.txt") as f:
            lines = f.readlines()
        for i in range(self.n_img):
            self.poses.append(_flip_yz(np.array(list(map(float, lines[i].split())))
                                       .reshape(4, 4)))


class Azure(BaseDataset):
    """Azure Kinect captures with an Open3D .log trajectory (identity poses
    when there is none)."""

    def __init__(self, cfg, args=None, scale=1.0):
        super().__init__(cfg, args, scale)
        self.color_paths = sorted(glob.glob(os.path.join(self.input_folder, "color", "*.jpg")))
        self.depth_paths = sorted(glob.glob(os.path.join(self.input_folder, "depth", "*.png")))
        self.n_img = len(self.color_paths)
        path = os.path.join(self.input_folder, "scene", "trajectory.log")
        if os.path.exists(path):
            with open(path) as f:
                content = f.readlines()
            for i in range(0, len(content), 5):
                vals = "".join(content[i + 1:i + 5]).strip().split()
                self.poses.append(_flip_yz(np.array(list(map(float, vals))).reshape(4, 4)))
        else:
            self.poses = [np.eye(4, dtype=np.float32) for _ in range(self.n_img)]


def _numbered(paths: List[str]) -> List[str]:
    return sorted(paths, key=lambda p: int(os.path.basename(p).split(".")[0]))


class ScanNet(BaseDataset):
    """ScanNet exports: frames/{color,depth,pose} with numeric file names."""

    def __init__(self, cfg, args=None, scale=1.0):
        super().__init__(cfg, args, scale)
        self.input_folder = os.path.join(self.input_folder, "frames")
        self.color_paths = _numbered(glob.glob(os.path.join(self.input_folder, "color", "*.jpg")))
        self.depth_paths = _numbered(glob.glob(os.path.join(self.input_folder, "depth", "*.png")))
        for pose_path in _numbered(glob.glob(os.path.join(self.input_folder, "pose", "*.txt"))):
            with open(pose_path) as f:
                rows = [list(map(float, line.split())) for line in f.readlines()]
            self.poses.append(_flip_yz(np.array(rows).reshape(4, 4)))
        self.n_img = len(self.color_paths)


class CoFusion(BaseDataset):
    """CoFusion synthetic sequences: colour/*.png + noisy EXR depth, with
    identity poses (the reference could not align CoFusion's frame
    either; ATE alignment absorbs it)."""

    def __init__(self, cfg, args=None, scale=1.0):
        super().__init__(cfg, args, scale)
        self.color_paths = sorted(glob.glob(os.path.join(self.input_folder, "colour", "*.png")))
        self.depth_paths = sorted(glob.glob(os.path.join(self.input_folder, "depth_noise", "*.exr")))
        self.n_img = len(self.color_paths)
        self.poses = [np.eye(4, dtype=np.float32) for _ in range(self.n_img)]


class TUM_RGBD(BaseDataset):
    """TUM RGB-D: timestamped rgb/depth/groundtruth association."""

    def __init__(self, cfg, args=None, scale=1.0):
        super().__init__(cfg, args, scale)
        self.color_paths, self.depth_paths, self.poses = self._loadtum(
            self.input_folder, frame_rate=32)
        self.n_img = len(self.color_paths)

    @staticmethod
    def _parse_list(filepath, skiprows=0):
        return np.loadtxt(filepath, delimiter=" ", dtype=np.str_, skiprows=skiprows)

    @staticmethod
    def _associate(t_img, t_depth, t_pose, max_dt=0.08):
        out = []
        for i, t in enumerate(t_img):
            j = np.argmin(np.abs(t_depth - t))
            k = np.argmin(np.abs(t_pose - t))
            if np.abs(t_depth[j] - t) < max_dt and np.abs(t_pose[k] - t) < max_dt:
                out.append((i, j, k))
        return out

    def _loadtum(self, datapath, frame_rate=-1):
        pose_list = os.path.join(datapath, "groundtruth.txt")
        if not os.path.isfile(pose_list):
            pose_list = os.path.join(datapath, "pose.txt")
        image_data = self._parse_list(os.path.join(datapath, "rgb.txt"))
        depth_data = self._parse_list(os.path.join(datapath, "depth.txt"))
        pose_data = self._parse_list(pose_list, skiprows=1)
        pose_vecs = pose_data[:, 1:].astype(np.float64)
        t_img = image_data[:, 0].astype(np.float64)
        t_depth = depth_data[:, 0].astype(np.float64)
        t_pose = pose_data[:, 0].astype(np.float64)
        associations = self._associate(t_img, t_depth, t_pose)
        indices = [0]
        for i in range(1, len(associations)):
            t0 = t_img[associations[indices[-1]][0]]
            t1 = t_img[associations[i][0]]
            if t1 - t0 > 1.0 / frame_rate:
                indices.append(i)
        images, depths, poses = [], [], []
        inv_pose = None
        for ix in indices:
            i, j, k = associations[ix]
            images.append(os.path.join(datapath, str(image_data[i, 1])))
            depths.append(os.path.join(datapath, str(depth_data[j, 1])))
            c2w = self._pose_from_quat(pose_vecs[k])
            if inv_pose is None:
                inv_pose = np.linalg.inv(c2w)
                c2w = np.eye(4)
            else:
                c2w = inv_pose @ c2w
            poses.append(_flip_yz(c2w))
        return images, depths, poses

    @staticmethod
    def _pose_from_quat(pvec):
        from scipy.spatial.transform import Rotation

        pose = np.eye(4)
        pose[:3, :3] = Rotation.from_quat(pvec[3:]).as_matrix()
        pose[:3, 3] = pvec[:3]
        return pose


def _flip_yz(c2w: np.ndarray) -> np.ndarray:
    """A dataset's camera-to-world pose in the system's convention (camera
    y up, looking along -z): negate the y and z columns."""
    c2w = np.array(c2w, dtype=np.float64)
    c2w[:3, 1] *= -1
    c2w[:3, 2] *= -1
    return c2w.astype(np.float32)


class Synthetic(BaseDataset):
    """Procedural box-room RGB-D sequence with exact poses and depth.

    A camera orbits inside an axis-aligned box; per-pixel depth is the
    analytic ray/box exit distance and color encodes the hit wall + a
    position checker pattern.  Enables full tracking+mapping integration
    tests in seconds with known ground truth.

    Extra config (optional, under ``data``): ``n_frames``, ``room`` bound.
    """

    def __init__(self, cfg, args=None, scale=1.0):
        super().__init__(cfg, args, scale)
        self.n_img = int(cfg["data"].get("n_frames", 40))
        room = cfg["data"].get("room", [[-2.0, 2.0], [-2.0, 2.0], [-2.0, 2.0]])
        self.room = np.asarray(room, dtype=np.float32)
        # scene geometry: "box" (bare walls) or "furnished" (walls + a
        # fixed ring of analytic pillars, dressers and spheres)
        self.scene = str(cfg["data"].get("scene", "box"))
        self.spheres, self.boxes = self._furniture() if (
            self.scene == "furnished") else (np.zeros((0, 4), np.float32),
                                             np.zeros((0, 6), np.float32))
        # total orbit sweep; per-frame motion scales with radians / n_frames
        self.orbit_radians = float(cfg["data"].get("orbit_radians", 0.5 * np.pi))
        # wall texture: "checker" (0.5 m periodic checker + positional
        # gradients) or "hash" (the checker plus a pseudo-random bit per
        # 0.5 m cell); geometry is the same for both
        self.texture = str(cfg["data"].get("texture", "checker"))
        self.poses = [self._pose(i) for i in range(self.n_img)]
        self._cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def _pose(self, i: int) -> np.ndarray:
        """Smooth orbit: small circle around the room center, looking outward."""
        t = i / max(self.n_img, 1)
        ang = self.orbit_radians * t
        center = self.room.mean(axis=1)
        radius = 0.25 * float(np.min(self.room[:, 1] - self.room[:, 0]))
        eye = center + radius * np.array(
            [np.cos(ang), 0.1 * np.sin(2 * ang), np.sin(ang)], dtype=np.float32
        )
        # look away from center (at the walls), camera -z = view direction
        view = eye - center
        view = view / np.linalg.norm(view)
        up = np.array([0.0, 1.0, 0.0], dtype=np.float32)
        zaxis = -view  # camera +z is behind
        xaxis = np.cross(up, zaxis)
        xaxis /= np.linalg.norm(xaxis)
        yaxis = np.cross(zaxis, xaxis)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0] = xaxis
        c2w[:3, 1] = yaxis
        c2w[:3, 2] = zaxis
        c2w[:3, 3] = eye
        return c2w

    def _furniture(self) -> Tuple[np.ndarray, np.ndarray]:
        """Deterministic interior layout: 8 spheres + 8 axis-aligned boxes
        on TWO staggered rings between the camera orbit (r = 0.25 * room
        size) and the walls.  The outward-looking orbit camera's ~34 deg
        half-FOV sees a ring object only while its center is within
        ~±(12-17) deg of the view axis, so 22.5 deg effective spacing
        (8 per ring, rings staggered by half a step) keeps at least one
        object in view from every orbit angle while each stays small
        enough to leave most of the background wall visible.  Fixed (not
        random) so every run, test and GT mesh agrees bit-for-bit."""
        center = self.room.mean(axis=1)
        size = float(np.min(self.room[:, 1] - self.room[:, 0]))
        lo_y, hi_y = float(self.room[1, 0]), float(self.room[1, 1])
        spheres, boxes = [], []
        # every feature spans >= 2 fine-grid voxels (0.16 m) so the map can
        # represent it, and objects stay near the walls so textured wall
        # remains visible around every silhouette.
        # 8 floor-to-ceiling square pillars, 45 deg apart:
        for k in range(8):
            ang = 2.0 * np.pi * k / 8.0
            ring = 0.42 * size
            half = (0.18, 0.20)[k % 2]
            c = center + np.array(
                [ring * np.cos(ang), 0.0, ring * np.sin(ang)], np.float32)
            h = np.array([half, 0.5 * (hi_y - lo_y), half], np.float32)
            boxes.append(np.concatenate([c - h, c + h]))
        # 8 chunky slabs ("dressers"): horizontal top edges constrain
        # vertical translation + pitch the way the pillars do yaw
        for k in range(8):
            ang = 2.0 * np.pi * k / 8.0 + np.pi / 8.0
            y = (0.35, -0.35)[k % 2]
            c = center + np.array(
                [0.42 * size * np.cos(ang), y, 0.42 * size * np.sin(ang)],
                np.float32)
            h = np.array([0.22, 0.18, 0.22], np.float32)
            boxes.append(np.concatenate([c - h, c + h]))
        # 8 spheres: curved silhouettes constrain all image-plane DOF.
        # Azimuths coincide with the NEXT dresser slot (3pi/8 = pi/8 +
        # 2pi/8), so the y parity is chosen OPPOSITE that dresser's:
        # sphere and dresser share a column at different heights, like a
        # lamp above a cabinet.
        for k in range(8):
            ang = 2.0 * np.pi * k / 8.0 + 3.0 * np.pi / 8.0
            y = (0.3, -0.3)[k % 2]
            c = center + np.array(
                [0.40 * size * np.cos(ang), y, 0.40 * size * np.sin(ang)],
                np.float32)
            spheres.append([c[0], c[1], c[2], 0.18 + 0.02 * (k % 3)])
        return (np.asarray(spheres, np.float32),
                np.asarray(boxes, np.float32))

    def scene_sdf(self, pts: np.ndarray) -> np.ndarray:
        """Signed distance of the whole scene, positive in free space: its
        zero level set is the walls and furniture, the surfaces ``_render``
        hits (the ground-truth mesh of ``tools/selfcheck.py``)."""
        pts = np.asarray(pts, np.float32)
        lo, hi = self.room[:, 0], self.room[:, 1]
        f = np.minimum.reduce([
            pts[..., 0] - lo[0], hi[0] - pts[..., 0],
            pts[..., 1] - lo[1], hi[1] - pts[..., 1],
            pts[..., 2] - lo[2], hi[2] - pts[..., 2],
        ]).astype(np.float32)
        for s in self.spheres:
            f = np.minimum(f, np.linalg.norm(pts - s[:3], axis=-1) - s[3])
        for b in self.boxes:
            c, h = (b[:3] + b[3:]) / 2.0, (b[3:] - b[:3]) / 2.0
            q = np.abs(pts - c) - h
            f = np.minimum(
                f, np.linalg.norm(np.maximum(q, 0.0), axis=-1)
                + np.minimum(np.max(q, axis=-1), 0.0))
        return f

    def _render(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        if index in self._cache:
            return self._cache[index]
        H, W = self.H, self.W
        c2w = self.poses[index]
        j, i = np.meshgrid(np.arange(H, dtype=np.float32),
                           np.arange(W, dtype=np.float32), indexing="ij")
        dirs = np.stack(
            [(i - self.cx) / self.fx, -(j - self.cy) / self.fy, -np.ones_like(i)], -1
        )
        rays_d = dirs @ c2w[:3, :3].T
        rays_o = c2w[:3, 3]
        # exit distance from the (open) box along each ray
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (self.room[None, None, :, :] - rays_o[None, None, :, None]) / rays_d[
                ..., None
            ]
        t_exit = np.min(np.max(t, axis=-1), axis=-1)
        depth = t_exit.astype(np.float32)
        # furnished scene: nearest analytic primitive hit wins over the wall
        obj_id = np.full(depth.shape, -1, np.int32)  # -1 = wall
        oid = 0
        for s in self.spheres:
            oc = (rays_o - s[:3]).astype(np.float32)
            a = np.sum(rays_d * rays_d, axis=-1)
            b = 2.0 * (rays_d @ oc)
            cc = float(oc @ oc - s[3] * s[3])
            disc = b * b - 4.0 * a * cc
            with np.errstate(invalid="ignore"):
                th = (-b - np.sqrt(disc)) / (2.0 * a)
            m = (disc > 0) & (th > 1e-4) & (th < depth)
            depth[m] = th[m].astype(np.float32)
            obj_id[m] = oid
            oid += 1
        for bx in self.boxes:
            lo_hi = bx.reshape(2, 3)
            with np.errstate(divide="ignore", invalid="ignore"):
                tb = (lo_hi[None, None] - rays_o[None, None, None, :]) \
                    / rays_d[..., None, :]
            tn = np.max(np.min(tb, axis=-2), axis=-1)
            tf = np.min(np.max(tb, axis=-2), axis=-1)
            m = (tn <= tf) & (tn > 1e-4) & (tn < depth)
            depth[m] = tn[m].astype(np.float32)
            obj_id[m] = oid
            oid += 1
        hit = rays_o[None, None, :] + rays_d * depth[..., None]
        # wall id = argmax |hit - center| scaled; color = wall base + checker
        rel = (hit - self.room[:, 0]) / (self.room[:, 1] - self.room[:, 0])
        if self.texture == "hash":
            # the checker parity stays in B (a sharp edge every 0.5 m) and a
            # pseudo-random bit per cell rides R, so cells are aperiodic
            cell = np.floor(hit * 2.0).astype(np.int64)
            h = (cell[..., 0] * 73856093 ^ cell[..., 1] * 19349663
                 ^ cell[..., 2] * 83492791 ^ 0x9E3779B1)
            rbit = ((h >> 7) & 1).astype(np.float32)
            checker = ((cell[..., 0] + cell[..., 1] + cell[..., 2]) % 2
                       ).astype(np.float32)
            color = np.stack(
                [
                    0.15 + 0.5 * rel[..., 0] + 0.25 * rbit,
                    0.2 + 0.6 * rel[..., 1],
                    0.3 + 0.4 * checker,
                ],
                axis=-1,
            ).astype(np.float32)
        else:
            checker = ((np.floor(hit[..., 0] * 2) + np.floor(hit[..., 1] * 2)
                        + np.floor(hit[..., 2] * 2)) % 2).astype(np.float32)
            color = np.stack(
                [
                    0.2 + 0.6 * rel[..., 0],
                    0.2 + 0.6 * rel[..., 1],
                    0.3 + 0.4 * checker,
                ],
                axis=-1,
            ).astype(np.float32)
        if oid > 0:
            # per-object tint blended over the (continuous-3D) wall texture:
            # objects stay individually identifiable while keeping the
            # texture pipeline's edge density on their surfaces
            palette = np.array(
                [[0.9, 0.3, 0.2], [0.2, 0.8, 0.3], [0.25, 0.4, 0.95],
                 [0.95, 0.8, 0.2], [0.8, 0.3, 0.85], [0.2, 0.85, 0.8],
                 [0.95, 0.55, 0.15], [0.55, 0.95, 0.25]], np.float32)
            on_obj = obj_id >= 0
            tint = palette[np.where(on_obj, obj_id, 0) % len(palette)]
            color = np.where(on_obj[..., None],
                             0.45 * color + 0.55 * tint, color)
        out = (np.clip(color, 0, 1), depth)
        self._cache[index] = out
        return out

    def __getitem__(self, index: int):
        color, depth = self._render(index)
        edge = self.crop_edge
        if edge > 0:
            color = color[edge:-edge, edge:-edge]
            depth = depth[edge:-edge, edge:-edge]
        pose = self.poses[index].copy()
        pose[:3, 3] *= self.scale
        return index, color, depth * self.scale, pose


def quantize_frame(color: np.ndarray, depth: np.ndarray, qscale: float):
    """Re-quantize a preprocessed f32 RGB-D frame to its source precision
    (u8 color, u16 depth at ``qscale`` = png_depth_scale / scale).  For a
    png-backed reader without resampling the round trip color = u8 / 255,
    depth = u16 / qscale is exact.  None if a depth would clip at the u16
    ceiling."""
    d = np.rint(np.asarray(depth) * qscale)
    if d.max() > 65535.0:
        return None
    c8 = np.rint(np.asarray(color) * 255.0)
    np.clip(c8, 0.0, 255.0, out=c8)
    return c8.astype(np.uint8), d.astype(np.uint16)


class Prefetcher:
    """Reads frames on a background thread, ``depth`` ahead of the
    consumer.  ``packer`` (optional) runs on each raw ``(idx, color, depth,
    c2w)`` item in that thread and its result is yielded instead.  Close
    it (or exhaust it) to stop the thread."""

    def __init__(self, dataset: BaseDataset, depth: int = 2, start: int = 0,
                 packer=None):
        self.dataset = dataset
        self.start = start
        self.packer = packer
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for i in range(self.start, len(self.dataset)):
                if self._stop.is_set():
                    return
                item = self.dataset[i]
                if self.packer is not None:
                    item = self.packer(item)
                if not self._put(item):
                    return
            self._put(None)
        except Exception as e:  # re-raised in the consumer by __iter__
            self._put(e)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    def close(self):
        self._stop.set()
        self.thread.join(timeout=10)


dataset_dict = {
    "replica": Replica,
    "scannet": ScanNet,
    "cofusion": CoFusion,
    "azure": Azure,
    "tumrgbd": TUM_RGBD,
    "synthetic": Synthetic,
}


def get_dataset(cfg: Dict[str, Any], args=None, scale: float = 1.0) -> BaseDataset:
    """Registry lookup by ``cfg['dataset']``."""
    return dataset_dict[cfg["dataset"]](cfg, args, scale)
