"""Mesher: counterpart of the JAX package's ``utils/mesher.py``.

Extract a culled, coloured triangle mesh from the scene:

  1. a uniform ``resolution``^3 lattice over ``marching_cubes_bound`` with a
     0.05 pad (``get_grid_uniform``);
  2. its occupancy through the 'fine' stage on the device in chunks of
     ``points_batch_size`` (``chunked_eval``: one K1 launch over the middle
     and fine grids per chunk; the iMAP* model's volume density, no K1); lattice points outside the scene hull (the
     convex hull of the keyframes' back-projected depth and camera
     centres, scipy on the host) get +100.  With ``show_forecast`` (and a
     coarse grid) the seen region uses 'fine', the forecast region
     'coarse' + 0.2 and the rest -100;
  3. the iso-surface at ``level_set`` by the host marching cubes
     (``utils/meshlib.py``);
  4. cleaning: drop faces whose vertices no keyframe sees (``point_masks``
     on the device) and components below ``remove_small_geometry_threshold``
     (or all but the largest);
  5. vertex colours by a 'color'-stage query of each vertex
     (``direct_point_query``: one K1 launch over three grids per chunk),
     or (``render_ray_along_normal``, the iMAP* configs) by rendering a
     0.1 m ray that ends at each vertex along its inward normal, sensor
     depth 0.1, in chunks of ``ray_batch_size`` rays;
  6. vertices / scale, written as a binary PLY.

Over several devices (``Mesher.devices``) each lattice and colour chunk
is split over them when it divides evenly (lattice data parallelism: the
scene replicated, the blocks' answers joined on the first device); not
over a spatially sharded scene, whose grids own the devices themselves.

Everything runs without a gradient.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from nice_slam_torch.models.scene import SceneSpec, SceneState, eval_points
from nice_slam_torch.ops.geometry import invert
from nice_slam_torch.ops.interp import bilinear_sample_2d
from nice_slam_torch.ops.render import RenderConfig, render_batch_ray
from nice_slam_torch.parallel.grid_sharding import ShardedGrid
from nice_slam_torch.parallel.sharding import data_parallel, over_blocks
from nice_slam_torch.utils import meshlib


@torch.no_grad()
def _eval_chunk(spec: SceneSpec, state: SceneState, pts: torch.Tensor,
                stage: str, devices=None) -> torch.Tensor:
    """raw of one chunk of points, split over ``devices`` when they divide
    it evenly, joined on the points' device."""
    if not data_parallel(devices, pts.shape[0]):
        return eval_points(spec, state, pts, stage)
    parts = over_blocks(devices, lambda st, p: eval_points(spec, st, p, stage),
                        state, pts)
    return torch.cat([x.to(pts.device) for x in parts])


def _query_devices(state: SceneState, devices=None):
    """The devices for lattice queries (None: one device).  A spatially
    sharded scene's grids own the devices themselves, so its lattice
    points are not split."""
    if any(isinstance(g, ShardedGrid) for g in state.grids.values()):
        return None
    return devices if devices is not None and len(devices) > 1 else None


@torch.no_grad()
def _chunked(spec: SceneSpec, state: SceneState, points: np.ndarray,
             stage: str, chunk: int, take, devices=None) -> np.ndarray:
    """``take(raw)`` of host points through ``stage``, ``chunk`` points per
    device call, back on the host."""
    dev = state.bound.device
    devices = _query_devices(state, devices)
    outs = [take(torch.zeros((0, 4)))]
    for i in range(0, len(points), chunk):
        p = torch.from_numpy(np.ascontiguousarray(points[i:i + chunk],
                                                  np.float32)).to(dev)
        outs.append(take(_eval_chunk(spec, state, p, stage, devices)).cpu())
    return torch.cat(outs).numpy()


def chunked_eval(spec: SceneSpec, state: SceneState, points: np.ndarray,
                 stage: str, chunk: int, devices=None) -> np.ndarray:
    """Occupancy (raw[:, 3]) of a host point set, ``chunk`` points per
    device call."""
    return _chunked(spec, state, points, stage, chunk, lambda raw: raw[:, 3],
                    devices)


def chunked_color(spec: SceneSpec, state: SceneState, points: np.ndarray,
                  chunk: int, devices=None) -> np.ndarray:
    """'color'-stage rgb of a host point set, ``chunk`` points per call."""
    return _chunked(spec, state, points, "color", chunk, lambda raw: raw[:, :3],
                    devices)


@torch.no_grad()
def render_along_normals(spec: SceneSpec, state: SceneState,
                         verts: np.ndarray, faces: np.ndarray,
                         rcfg: RenderConfig) -> np.ndarray:
    """Rendered rgb of each vertex: a ray from 0.1 m outside the vertex
    along its area-weighted inward normal, sensor depth 0.1, rendered at
    the 'color' stage in chunks of ``rcfg.ray_batch_size`` rays."""
    dev = state.bound.device
    length = 0.1
    normals = vertex_normals(verts, faces)
    rays_o = torch.from_numpy((verts - length * normals).astype(np.float32)).to(dev)
    rays_d = torch.from_numpy(normals.astype(np.float32)).to(dev)
    bs = rcfg.ray_batch_size
    out = [np.zeros((0, 3), np.float32)]
    for i in range(0, len(verts), bs):
        ro, rd = rays_o[i:i + bs], rays_d[i:i + bs]
        gt = torch.full((ro.shape[0],), length, device=dev)
        _, _, c = render_batch_ray(spec, state, ro, rd, "color", gt_depth=gt,
                                   rcfg=rcfg)
        out.append(c.cpu().numpy())
    return np.concatenate(out)


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted unit vertex normals (zero where no face touches)."""
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    norm[norm == 0] = 1.0
    return vn / norm


def _frame_masks(points: torch.Tensor, c2w: torch.Tensor,
                 depth_img: torch.Tensor, H: int, W: int, fx: float,
                 fy: float, cx: float, cy: float, depth_test: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame (seen, forecast) masks of (N, 3) points: inside the image
    (forecast: within 1000 px of it) and in front of the camera; with
    ``depth_test`` within +-2.4 of the bilinear depth lookup (forecast:
    nearer than the largest lookup); without it nearer than 1.1 x the
    image's largest depth, and unbounded for an all-zero image."""
    w2c = invert(c2w)
    cam = points @ w2c[:3, :3].T + w2c[:3, 3]
    zc = cam[:, 2] + 1e-8
    u = (fx * (-cam[:, 0]) + cx * cam[:, 2]) / zc
    v = (fy * cam[:, 1] + cy * cam[:, 2]) / zc
    in_front = zc < 0
    seen = (u < W) & (u > 0) & (v < H) & (v > 0) & in_front
    edge = -1000.0
    forecast = (u < W - edge) & (u > edge) & (v < H - edge) & (v > edge) & in_front
    proj_depth = -cam[:, 2]
    if depth_test:
        depth_sample = bilinear_sample_2d(depth_img, u, v)
        forecast = forecast & (proj_depth < torch.max(depth_sample))
        seen = seen & (proj_depth < depth_sample + 2.4) & (depth_sample - 2.4 < proj_depth)
    else:
        md = torch.max(depth_img)
        max_depth = torch.where(md > 0, md * 1.1, torch.full_like(md, float("inf")))
        forecast = forecast & (proj_depth < max_depth)
        seen = seen & (proj_depth < max_depth)
    return seen, forecast


class Mesher:
    def __init__(self, cfg, cam, spec: SceneSpec,
                 rcfg: Optional[RenderConfig] = None):
        m = cfg["meshing"]
        self.resolution = m["resolution"]
        self.level_set = m["level_set"]
        self.clean_mesh_bound_scale = m["clean_mesh_bound_scale"]
        self.remove_small_geometry_threshold = m["remove_small_geometry_threshold"]
        self.color_mesh_extraction_method = m["color_mesh_extraction_method"]
        self.get_largest_components = m["get_largest_components"]
        self.depth_test = m["depth_test"]
        self.scale = cfg["scale"]
        self.verbose = cfg["verbose"]
        self.spec = spec
        self.cam = cam
        self.H, self.W = cam["H"], cam["W"]
        self.marching_cubes_bound = (
            np.asarray(cfg["mapping"]["marching_cubes_bound"], np.float64) * self.scale)
        self.rcfg = rcfg or RenderConfig.from_cfg(cfg)
        self.points_batch_size = self.rcfg.points_batch_size
        # what the last get_mesh did: vertex and face counts, device chunks
        # per query, and host seconds per step
        self.last: Dict[str, float] = {}
        # lattice data parallelism over these devices (None: one device)
        self.devices = None

    # ------------------------------------------------------------------
    def get_grid_uniform(self, resolution: int):
        """The query lattice over the padded marching-cubes bound, x
        slowest and z fastest."""
        b = self.marching_cubes_bound
        pad = 0.05
        x = np.linspace(b[0][0] - pad, b[0][1] + pad, resolution)
        y = np.linspace(b[1][0] - pad, b[1][1] + pad, resolution)
        z = np.linspace(b[2][0] - pad, b[2][1] + pad, resolution)
        X, Y, Z = np.meshgrid(x, y, z, indexing="ij")
        pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1).astype(np.float32)
        return pts, (x, y, z)

    @torch.no_grad()
    def point_masks(self, points: np.ndarray, keyframes, estimate_c2w_list,
                    idx: int, get_mask_use_all_frames: bool = False
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Seen / forecast / unseen masks of host points: against every
        keyframe, or (``get_mask_use_all_frames``) against the estimated
        pose of every frame up to ``idx`` with no depth bound."""
        a = keyframes.arrays
        dev = a.depths.device
        est = torch.as_tensor(estimate_c2w_list, dtype=torch.float32, device=dev)
        if get_mask_use_all_frames:
            zero = torch.zeros((self.H, self.W), device=dev)
            views = [(est[fi], zero, False) for fi in range(idx + 1)]
        else:
            views = [(a.est_c2w[k], a.depths[k], bool(self.depth_test))
                     for k in range(len(keyframes))]
        n = len(points)
        seen = np.zeros((n,), bool)
        forecast = np.zeros((n,), bool)
        chunk = self.points_batch_size
        for i in range(0, n, chunk):
            pts = torch.from_numpy(np.ascontiguousarray(points[i:i + chunk],
                                                        np.float32)).to(dev)
            s = torch.zeros(pts.shape[0], dtype=torch.bool, device=dev)
            f = torch.zeros_like(s)
            for c2w, depth, test in views:
                cs, cf = _frame_masks(pts, c2w, depth, self.H, self.W,
                                      self.cam["fx"], self.cam["fy"],
                                      self.cam["cx"], self.cam["cy"], test)
                s |= cs
                f |= cf
            seen[i:i + chunk] = s.cpu().numpy()
            forecast[i:i + chunk] = f.cpu().numpy()
        forecast &= ~seen
        unseen = ~(seen | forecast)
        return seen, forecast, unseen

    def get_bound_from_frames(self, keyframes):
        """The scene hull: a Delaunay triangulation (for ``find_simplex``)
        of the convex hull of the keyframes' back-projected depth (~5k
        pixels each) and camera centres, scaled by clean_mesh_bound_scale
        about its centre."""
        from scipy.spatial import ConvexHull, Delaunay

        H, W = self.H, self.W
        fx, fy = self.cam["fx"], self.cam["fy"]
        cx, cy = self.cam["cx"], self.cam["cy"]
        stride = max(1, int(np.sqrt(H * W / 5000)))
        j, i = np.meshgrid(np.arange(0, H, stride, dtype=np.float32),
                           np.arange(0, W, stride, dtype=np.float32), indexing="ij")
        a = keyframes.arrays
        n = len(keyframes)
        depths = a.depths[:n, ::stride, ::stride].cpu().numpy()
        c2ws = a.est_c2w[:n].cpu().numpy()
        all_pts: List[np.ndarray] = []
        for d, c2w in zip(depths, c2ws):
            valid = d > 0
            xc = (i - cx) / fx * d
            yc = -(j - cy) / fy * d
            pts_cam = np.stack([xc[valid], yc[valid], -d[valid]], axis=-1)
            all_pts.append(pts_cam @ c2w[:3, :3].T + c2w[:3, 3])
            all_pts.append(c2w[None, :3, 3])
        pts = np.concatenate(all_pts, axis=0)
        hull_pts = pts[ConvexHull(pts).vertices]
        center = hull_pts.mean(axis=0)
        hull_pts = center + self.clean_mesh_bound_scale * (hull_pts - center)
        return Delaunay(hull_pts)

    # ------------------------------------------------------------------
    def get_mesh(self, mesh_out_file: str, state: SceneState, keyframes,
                 estimate_c2w_list, idx: int, show_forecast: bool = False,
                 color: bool = True, clean_mesh: bool = True,
                 get_mask_use_all_frames: bool = False) -> Optional[str]:
        self.last = last = {}
        clock = [time.perf_counter()]

        def lap(name):
            now = time.perf_counter()
            last[name] = now - clock[0]
            clock[0] = now

        points, (x, y, z) = self.get_grid_uniform(self.resolution)
        chunk = min(self.points_batch_size, len(points))
        lap("lattice_s")
        n_eval = 0
        if show_forecast and self.spec.coarse:
            seen_mask, forecast_mask, _ = self.point_masks(
                points, keyframes, estimate_c2w_list, idx, get_mask_use_all_frames)
            occ = np.full((len(points),), -100.0, np.float32)
            if seen_mask.any():
                occ[seen_mask] = chunked_eval(self.spec, state, points[seen_mask],
                                              "fine", chunk, self.devices)
            if forecast_mask.any():
                occ[forecast_mask] = chunked_eval(
                    self.spec, state, points[forecast_mask], "coarse", chunk,
                    self.devices) + 0.2
            n_eval = -(-int(seen_mask.sum()) // chunk) + -(-int(forecast_mask.sum()) // chunk)
            lap("eval_s")
        else:
            hull = self.get_bound_from_frames(keyframes)
            inside = hull.find_simplex(points) >= 0
            lap("hull_s")
            occ = chunked_eval(self.spec, state, points, "fine", chunk, self.devices)
            occ[~inside] = 100.0
            n_eval = -(-len(points) // chunk)
            lap("eval_s")

        field = occ.reshape(len(x), len(y), len(z))
        verts, faces = meshlib.marching_cubes(
            field, float(self.level_set), origin=(x[0], y[0], z[0]),
            spacing=(x[1] - x[0], y[1] - y[0], z[1] - z[0]))
        lap("marching_cubes_s")
        last.update(lattice_chunks=n_eval, color_chunks=0, vertices=len(verts),
                    faces=len(faces))
        if len(verts) == 0:
            print("marching_cubes error. Possibly no surface extracted from "
                  "the level set.")
            return None

        if clean_mesh:
            if show_forecast:
                hull = self.get_bound_from_frames(keyframes)
                face_drop = (~(hull.find_simplex(verts) >= 0))[faces].all(axis=1)
            else:
                seen_mask, _, _ = self.point_masks(
                    verts, keyframes, estimate_c2w_list, idx, get_mask_use_all_frames)
                face_drop = (~seen_mask)[faces].all(axis=1)
            faces = faces[~face_drop]
            comp, areas = meshlib.components(verts, faces)
            if len(areas) > 0:
                if self.get_largest_components:
                    keep = comp == int(np.argmax(areas))
                else:
                    ok = areas > (self.remove_small_geometry_threshold
                                  * self.scale * self.scale)
                    keep = ok[comp]
                faces = faces[keep]
            used = np.unique(faces)
            remap = -np.ones(len(verts), np.int64)
            remap[used] = np.arange(len(used))
            verts = verts[used]
            faces = remap[faces]
            lap("clean_s")

        vertex_colors = None
        if color:
            if self.color_mesh_extraction_method == "direct_point_query":
                rgb = chunked_color(self.spec, state, verts, chunk, self.devices)
                last["color_chunks"] = -(-len(verts) // chunk)
            else:
                rgb = render_along_normals(self.spec, state, verts, faces,
                                           self.rcfg)
                last["color_chunks"] = -(-len(verts) // self.rcfg.ray_batch_size)
            vertex_colors = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
            if show_forecast:
                _, forecast_mask, _ = self.point_masks(
                    verts, keyframes, estimate_c2w_list, idx, get_mask_use_all_frames)
                vertex_colors[forecast_mask] = (0, 255, 255)  # cyan
            lap("color_s")

        meshlib.write_ply(mesh_out_file, verts / self.scale, faces, vertex_colors)
        lap("write_s")
        last.update(vertices=len(verts), faces=len(faces))
        if self.verbose:
            print("Saved mesh at", mesh_out_file)
        return mesh_out_file
