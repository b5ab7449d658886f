"""Residual panels: counterpart of the JAX package's ``utils/visualizer.py``.

Every ``freq``-th frame, at every ``inside_freq``-th iteration, render the
full frame at the given pose (``render_img``, stage 'color') and save a
2x3 panel (input / generated / residual, depth on top in the plasma
colormap from 0 to the input's largest depth, RGB below) as
``{idx:05d}_{iter:04d}.jpg``, each image scaled down to at most 400 px
wide as the JAX package's 12-inch figure at 100 dpi draws it.  The panel
is composed with numpy and written by ``utils/jpeg.py`` (no plotting or
imaging library is needed), without the JAX panel's axis titles.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from nice_slam_torch.models.scene import SceneSpec, SceneState
from nice_slam_torch.ops.geometry import pose_from_tensor
from nice_slam_torch.ops.render import RenderConfig, render_img
from nice_slam_torch.utils.jpeg import write_jpeg

# matplotlib's plasma colormap at 0, 1/8, ..., 1
PLASMA = np.array([
    [0.0504, 0.0298, 0.528], [0.2999, 0.0096, 0.6316], [0.4949, 0.012, 0.6579],
    [0.6651, 0.1386, 0.5856], [0.7982, 0.2802, 0.4695], [0.9018, 0.4251, 0.3597],
    [0.9734, 0.5858, 0.2515], [0.993, 0.7717, 0.1548], [0.94, 0.9752, 0.1313]])
CELL_WIDTH = 400  # px per image in the panel
GUTTER = 4        # px of white between images


def _plasma(x: np.ndarray, vmax: float) -> np.ndarray:
    t = np.clip(x / vmax, 0.0, 1.0) * (len(PLASMA) - 1)
    i = np.minimum(t.astype(np.int64), len(PLASMA) - 2)
    f = (t - i)[..., None]
    return PLASMA[i] * (1.0 - f) + PLASMA[i + 1] * f


def _fit(img: np.ndarray) -> np.ndarray:
    """Scale an (h, w, 3) image down by area averaging to CELL_WIDTH wide."""
    h, w = img.shape[:2]
    if w <= CELL_WIDTH:
        return img
    t = torch.from_numpy(np.ascontiguousarray(img, np.float32)).permute(2, 0, 1)[None]
    t = F.interpolate(t, size=(max(1, round(h * CELL_WIDTH / w)), CELL_WIDTH),
                      mode="area")
    return t[0].permute(1, 2, 0).numpy()


def compose_panel(rows) -> np.ndarray:
    """A grid of equally sized (h, w, 3) images in [0, 1] with white gutters
    -> (H, W, 3) uint8."""
    cells = [[_fit(img) for img in row] for row in rows]
    h, w = cells[0][0].shape[:2]
    H = len(cells) * h + (len(cells) - 1) * GUTTER
    W = len(cells[0]) * w + (len(cells[0]) - 1) * GUTTER
    out = np.ones((H, W, 3))
    for r, row in enumerate(cells):
        for c, img in enumerate(row):
            y, x = r * (h + GUTTER), c * (w + GUTTER)
            out[y:y + h, x:x + w] = img
    return np.rint(np.clip(out, 0.0, 1.0) * 255.0).astype(np.uint8)


class Visualizer:
    def __init__(self, freq: int, inside_freq: int, vis_dir: str,
                 spec: SceneSpec, rcfg: RenderConfig, cam: dict,
                 verbose: bool = False):
        self.freq = freq
        self.inside_freq = inside_freq
        self.vis_dir = vis_dir
        self.spec = spec
        self.rcfg = rcfg
        self.cam = cam
        self.verbose = verbose
        os.makedirs(vis_dir, exist_ok=True)

    def vis(self, idx: int, iter: int, gt_depth, gt_color, c2w_or_tensor,
            state: SceneState) -> Optional[str]:
        """Render and save a residual panel if this (frame, iteration) is
        due.  The pose is a (3|4, 4) camera-to-world matrix or a [quat,
        trans] 7-vector; the images are (H, W) and (H, W, 3), on the host or
        the state's device."""
        if not (idx % self.freq == 0 and iter % self.inside_freq == 0):
            return None
        dev = state.bound.device
        pose = torch.as_tensor(c2w_or_tensor, dtype=torch.float32, device=dev)
        c2w = pose_from_tensor(pose) if pose.dim() == 1 else pose
        gt_depth_t = torch.as_tensor(gt_depth, dtype=torch.float32, device=dev)
        H, W = gt_depth_t.shape
        depth, _, color = render_img(
            self.spec, state, c2w, H, W, self.cam["fx"], self.cam["fy"],
            self.cam["cx"], self.cam["cy"], stage="color", gt_depth=gt_depth_t,
            rcfg=self.rcfg)
        depth = depth.cpu().numpy()
        color = color.cpu().numpy()
        gt_depth = gt_depth_t.cpu().numpy()
        gt_color = torch.as_tensor(gt_color).cpu().numpy()

        depth_res = np.abs(gt_depth - depth)
        depth_res[gt_depth == 0.0] = 0.0
        color_res = np.abs(gt_color - color)
        color_res[gt_depth == 0.0] = 0.0
        max_depth = float(np.max(gt_depth)) or 1.0
        panel = compose_panel([
            [_plasma(d, max_depth) for d in (gt_depth, depth, depth_res)],
            [np.clip(c, 0.0, 1.0) for c in (gt_color, color, color_res)]])
        path = os.path.join(self.vis_dir, f"{idx:05d}_{iter:04d}.jpg")
        write_jpeg(path, panel)
        if self.verbose:
            print(f"Saved rendering visualization of color/depth image at {path}")
        return path
