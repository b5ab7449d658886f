"""Trajectory + mesh replay rendering; the port's counterpart of the JAX
package's ``tools/viz.py``.

Capability counterpart of the reference's interactive Open3D viewer
(visualizer.py + src/tools/viz.py): loads a run's checkpoint, replays the
estimated trajectory over the reconstructed mesh and (with
``--save_rendering``) writes a video.  Without Open3D the window is
replaced by offline rendering through the port's BVH raycaster
(``csrc/mesh_kernels.cpp``) with depth-attenuated vertex colours.  It
runs on the host: the card's machine has no OpenCV, so frames are
written with the port's JPEG encoder and the video is Motion-JPEG in an
MP4 container (``utils/mjpeg_mp4.py``), where the JAX tool writes
OpenCV's 'mp4v' (MPEG-4 Part 2) codec.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from nice_slam_torch.utils.meshlib import MeshRaycaster, read_ply


class MeshRenderer:
    """Shaded colour renderer over a triangle mesh via the raycaster."""

    def __init__(self, verts: np.ndarray, tris: np.ndarray,
                 colors: Optional[np.ndarray]):
        self.verts = verts
        self.tris = tris
        self.colors = colors
        self.caster = MeshRaycaster(verts, tris)
        fn = np.cross(verts[tris[:, 1]] - verts[tris[:, 0]],
                      verts[tris[:, 2]] - verts[tris[:, 0]])
        self.face_normals = fn / (np.linalg.norm(fn, axis=1, keepdims=True) + 1e-12)
        self._vtree = None

    def render(self, c2w: np.ndarray, H: int, W: int, fx: float, fy: float,
               cx: float, cy: float) -> Tuple[np.ndarray, np.ndarray]:
        """(rgb uint8 (H, W, 3), depth (H, W)).  The camera follows the
        SLAM convention (-z forward), converted to the raycaster's CV
        convention."""
        cv = c2w.copy()
        cv[:3, 1] *= -1
        cv[:3, 2] *= -1
        depth = self.caster.render_depth(cv, H, W, fx, fy, cx, cy, z_far=100.0)
        img = np.full((H, W, 3), 255, np.uint8)
        hit = depth > 0
        if hit.any():
            j, i = np.nonzero(hit)
            d = depth[hit]
            pts_cv = np.stack([(i - cx) / fx * d, (j - cy) / fy * d, d], axis=-1)
            pts_w = pts_cv @ cv[:3, :3].T + cv[:3, 3]
            from scipy.spatial import cKDTree

            if self._vtree is None:
                self._vtree = cKDTree(self.verts)
            _, vidx = self._vtree.query(pts_w, workers=-1)
            if self.colors is not None:
                base = self.colors[vidx].astype(np.float32) / 255.0
            else:
                base = np.full((len(vidx), 3), 0.7, np.float32)
            shade = np.clip(1.0 - 0.03 * d, 0.4, 1.0)[:, None]
            img[j, i] = np.clip(base * shade * 255, 0, 255).astype(np.uint8)
        return img, depth


# ---------------------------------------------------------------------------
# Line raster: OpenCV's pixels (cv2.line, thickness 1, 8-connected)
# ---------------------------------------------------------------------------

def clip_line(W: int, H: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` to the (W, H) image: (visible, x1, y1, x2, y2)."""
    right, bottom = W - 1, H - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def line_pixels(W: int, H: int, a, b) -> List[Tuple[int, int]]:
    """The (x, y) pixels ``cv2.line(img, a, b, color, 1)`` sets on a
    (W, H) image: clipped, then walked left to right by OpenCV's
    8-connected Bresenham iterator."""
    x1, y1 = int(a[0]), int(a[1])
    x2, y2 = int(b[0]), int(b[1])
    if not (0 <= x1 < W and 0 <= x2 < W and 0 <= y1 < H and 0 <= y2 < H):
        visible, x1, y1, x2, y2 = clip_line(W, H, x1, y1, x2, y2)
        if not visible:
            return []
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x1, y1
    out = []
    for _ in range(dx + 1):
        out.append((x, y))
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if vert:
            y += sy
            x += sx if minor else 0
        else:
            x += sx
            y += sy if minor else 0
    return out


def draw_traj_overlay(img: np.ndarray, traj_px) -> np.ndarray:
    """Draw the projected trajectory as a red polyline, in place (``None``
    points break it)."""
    H, W = img.shape[:2]
    for a, b in zip(traj_px[:-1], traj_px[1:]):
        if a is None or b is None:
            continue
        for x, y in line_pixels(W, H, a, b):
            img[y, x] = (255, 0, 0)
    return img


class SLAMFrontend:
    """Offline replay: the estimated trajectory over the final mesh ->
    frames and an MP4 (the reference SLAMFrontend's replay semantics,
    src/tools/viz.py:45-209, without a GUI process)."""

    def __init__(self, output: str, init_pose, cam_scale=0.3,
                 save_rendering=False, near=0,
                 estimate_c2w_list=None, gt_c2w_list=None):
        self.output = output
        self.save_rendering = save_rendering
        self.near = int(near)  # render and record only frames past this index
        self.estimate_c2w_list = estimate_c2w_list
        self.gt_c2w_list = gt_c2w_list
        self.frames: List[np.ndarray] = []
        self.renderer: Optional[MeshRenderer] = None
        self.H, self.W = 480, 640
        self.fx = self.fy = 500.0
        self.cx, self.cy = 319.5, 239.5
        if save_rendering:
            os.makedirs(os.path.join(output, "tmp_rendering"), exist_ok=True)

    def update_mesh(self, mesh_path: str) -> None:
        verts, tris, colors = read_ply(mesh_path)
        self.renderer = MeshRenderer(verts, tris, colors)

    def update_pose(self, idx: int, c2w: np.ndarray) -> Optional[np.ndarray]:
        if self.renderer is None or idx < self.near:
            return None
        # third-person view: behind and above the camera
        view = c2w.copy()
        view[:3, 3] += view[:3, 2] * 1.5  # back along +z
        img, _ = self.renderer.render(view, self.H, self.W, self.fx, self.fy,
                                      self.cx, self.cy)
        if self.save_rendering:
            from nice_slam_torch.utils.jpeg import write_jpeg

            write_jpeg(os.path.join(self.output, "tmp_rendering", f"{idx:05d}.jpg"), img)
        self.frames.append(img)
        return img

    def finalize_video(self, path: str, fps: int = 30) -> Optional[str]:
        """Write the frames as a Motion-JPEG MP4 at ``path``."""
        if not self.frames:
            return None
        from nice_slam_torch.utils.mjpeg_mp4 import write_mp4

        return write_mp4(path, self.frames, fps)


def _frustum_lineset(o3d, c2w: np.ndarray, scale: float, color):
    """Camera frustum wireframe at ``c2w`` (SLAM convention, -z forward)."""
    pts = np.array([
        [0.0, 0.0, 0.0],
        [0.5, 0.3, -1.0], [0.5, -0.3, -1.0],
        [-0.5, -0.3, -1.0], [-0.5, 0.3, -1.0],
    ]) * scale
    pts = pts @ c2w[:3, :3].T + c2w[:3, 3]
    lines = [[0, 1], [0, 2], [0, 3], [0, 4], [1, 2], [2, 3], [3, 4], [4, 1]]
    ls = o3d.geometry.LineSet(points=o3d.utility.Vector3dVector(pts),
                              lines=o3d.utility.Vector2iVector(lines))
    ls.paint_uniform_color(color)
    return ls


class O3DFrontend:
    """Live Open3D viewer window (the reference's interactive viewer,
    src/tools/viz.py:45-209): streams meshes as they appear, draws the
    estimated (blue) and ground-truth (green) trajectories and the
    current camera frustum, and optionally keeps the rendered frames for
    a video.  Constructed only when ``open3d`` imports; the same
    update_mesh / update_pose / finalize_video interface."""

    def __init__(self, output: str, init_pose, cam_scale=0.3,
                 save_rendering=False, near=0,
                 estimate_c2w_list=None, gt_c2w_list=None):
        import open3d as o3d  # raises ImportError when unavailable

        self._o3d = o3d
        self.output = output
        self.cam_scale = cam_scale
        self.near = int(near)
        self.save_rendering = save_rendering
        self.estimate_c2w_list = estimate_c2w_list
        self.gt_c2w_list = gt_c2w_list
        self.frames: List[np.ndarray] = []
        self.renderer = None  # the "mesh attached" flag, as SLAMFrontend's
        self._mesh_geom = None
        self._frustum = None
        self._traj_pts: List[np.ndarray] = []
        self._gt_pts: List[np.ndarray] = []
        # one LineSet per trajectory, grown in place
        self._traj_ls = o3d.geometry.LineSet()
        self._gt_ls = o3d.geometry.LineSet()
        self._traj_added = False
        self._gt_added = False
        self.vis = o3d.visualization.Visualizer()
        if not self.vis.create_window(window_name="nice_slam_torch",
                                      width=1280, height=720):
            raise RuntimeError("open3d window creation failed "
                               "(headless host / no display?)")
        if save_rendering:
            os.makedirs(os.path.join(output, "tmp_rendering"), exist_ok=True)

    def update_mesh(self, mesh_path: str) -> None:
        o3d = self._o3d
        mesh = o3d.io.read_triangle_mesh(mesh_path)
        mesh.compute_vertex_normals()
        if self._mesh_geom is not None:
            self.vis.remove_geometry(self._mesh_geom, False)
        self._mesh_geom = mesh
        self.vis.add_geometry(mesh, self._frustum is None)
        self.renderer = mesh

    def _grow(self, ls, pts, color, added: bool) -> bool:
        o3d = self._o3d
        ls.points = o3d.utility.Vector3dVector(pts)
        ls.lines = o3d.utility.Vector2iVector([[i, i + 1] for i in range(len(pts) - 1)])
        ls.paint_uniform_color(color)
        if added:
            self.vis.update_geometry(ls)
        else:
            self.vis.add_geometry(ls, False)
        return True

    def update_pose(self, idx: int, c2w: np.ndarray) -> Optional[np.ndarray]:
        if idx < self.near:
            return None
        if self._frustum is not None:
            self.vis.remove_geometry(self._frustum, False)
        self._frustum = _frustum_lineset(self._o3d, c2w, self.cam_scale, [1, 0, 0])
        self.vis.add_geometry(self._frustum, False)
        self._traj_pts.append(np.asarray(c2w[:3, 3], np.float64))
        if len(self._traj_pts) >= 2:
            self._traj_added = self._grow(self._traj_ls, self._traj_pts, [0, 0, 1],
                                          self._traj_added)
        if self.gt_c2w_list is not None and idx < len(self.gt_c2w_list):
            self._gt_pts.append(np.asarray(self.gt_c2w_list[idx][:3, 3], np.float64))
            if len(self._gt_pts) >= 2:
                self._gt_added = self._grow(self._gt_ls, self._gt_pts, [0, 1, 0],
                                            self._gt_added)
        self.vis.poll_events()
        self.vis.update_renderer()
        img = None
        if self.save_rendering:
            buf = self.vis.capture_screen_float_buffer(do_render=True)
            img = (np.asarray(buf) * 255).astype(np.uint8)
            self.frames.append(img)
        return img

    def finalize_video(self, path: str, fps: int = 30) -> Optional[str]:
        self.vis.destroy_window()
        return SLAMFrontend.finalize_video(self, path, fps)


def make_frontend(*args, online: Optional[bool] = None,
                  frontend: Optional[str] = None, port: int = 8765,
                  host: str = "127.0.0.1", **kwargs):
    """Frontend factory.  ``frontend`` selects explicitly: 'open3d' (the
    live GUI window, raises if unavailable), 'web' (a live browser viewer
    served over HTTP, ``tools/webviz.py``), 'offline' (the raycast replay
    to frames and an MP4).  Default: the Open3D window when the library
    imports (``online=True`` forces the attempt), else the offline replay;
    any construction failure of the window falls back (a headless host
    fails to open one as often as the library is absent), an explicit
    request raises."""
    if frontend == "web":
        from nice_slam_torch.tools.webviz import WebFrontend

        return WebFrontend(*args, port=port, host=host, **kwargs)
    if frontend == "open3d" or (frontend is None and online is not False):
        try:
            return O3DFrontend(*args, **kwargs)
        except Exception:
            if online or frontend == "open3d":
                raise
    return SLAMFrontend(*args, **kwargs)
