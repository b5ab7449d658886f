"""Camera tracker: counterpart of the JAX package's ``slam/tracker.py``.

The pose is an unnormalized quaternion + translation 7-vector optimized
with Adam (optionally the quaternion at 0.2 x lr).  Each iteration renders
a batch of pre-drawn pixels at stage 'color' and sums an
uncertainty-weighted depth L1 and a weighted color L1 over the rays that
end inside the scene box (every ray, for iMAP*) and pass the dynamic-pixel test
``tmp < 10 * median(tmp)``.  The pose kept for the frame is the post-step
tensor of the iteration whose pre-step loss was lowest.  Pixels are drawn
on the host with numpy (``presample_pixels``), so a tracked frame needs
only those pixels on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from nice_slam_torch.models.scene import SceneSpec, SceneState
from nice_slam_torch.ops.geometry import (
    invert,
    pose_from_tensor,
    ray_aabb_far,
    rays_from_uv,
)
from nice_slam_torch.ops.render import RenderConfig, render_batch_ray
from nice_slam_torch.slam.optim import GroupAdam


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Static tracking configuration (cfg['tracking'] + camera)."""

    H: int
    W: int
    fx: float
    fy: float
    cx: float
    cy: float
    lr: float
    iters: int
    pixels: int
    seperate_LR: bool
    w_color_loss: float
    ignore_edge_W: int
    ignore_edge_H: int
    handle_dynamic: bool
    use_color_in_tracking: bool
    const_speed_assumption: bool
    gt_camera: bool
    nice: bool
    cf_iters: int = 0
    cf_lr_mult: float = 1.0

    @staticmethod
    def from_cfg(cfg, cam, nice: bool) -> "TrackerConfig":
        t = cfg["tracking"]
        return TrackerConfig(
            H=cam["H"], W=cam["W"], fx=cam["fx"], fy=cam["fy"],
            cx=cam["cx"], cy=cam["cy"],
            lr=t["lr"], iters=t["iters"], pixels=t["pixels"],
            seperate_LR=t["seperate_LR"], w_color_loss=t["w_color_loss"],
            ignore_edge_W=t["ignore_edge_W"], ignore_edge_H=t["ignore_edge_H"],
            handle_dynamic=t["handle_dynamic"],
            use_color_in_tracking=t["use_color_in_tracking"],
            const_speed_assumption=t["const_speed_assumption"],
            gt_camera=t["gt_camera"], nice=nice,
            cf_iters=int(t.get("cf_iters", 0)),
            cf_lr_mult=float(t.get("cf_lr_mult", 1.0)),
        )


def masked_lower_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """torch.median's lower-middle convention over a masked subset, with no
    host sync."""
    s = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf")))).values
    cnt = mask.sum()
    k = torch.clamp((cnt - 1) // 2, min=0)
    return s.gather(0, k.reshape(1))[0]


def tracking_loss_sampled(spec: SceneSpec, state: SceneState,
                          cam_tensor: torch.Tensor, pix_i: torch.Tensor,
                          pix_j: torch.Tensor, pix_depth: torch.Tensor,
                          pix_color: torch.Tensor, tcfg: TrackerConfig,
                          rcfg: RenderConfig) -> torch.Tensor:
    """One tracking iteration's loss on pixels (column i, row j, full-image
    coordinates) and their sensor depth and color."""
    c2w = pose_from_tensor(cam_tensor)
    rays_o, rays_d = rays_from_uv(pix_i, pix_j, c2w, tcfg.fx, tcfg.fy,
                                  tcfg.cx, tcfg.cy)
    if tcfg.nice:
        inside = ray_aabb_far(rays_o, rays_d, state.bound).detach() >= pix_depth
    else:  # iMAP* keeps every ray
        inside = torch.ones_like(pix_depth, dtype=torch.bool)
    depth, uncertainty, color = render_batch_ray(
        spec, state, rays_o, rays_d, "color", gt_depth=pix_depth, rcfg=rcfg)
    tmp = torch.abs(pix_depth - depth) / torch.sqrt(uncertainty.detach() + 1e-10)
    mask = pix_depth > 0
    if tcfg.handle_dynamic:
        med = masked_lower_median(tmp.detach(), inside)
        mask = mask & (tmp.detach() < 10.0 * med)
    mask = mask & inside
    loss = torch.sum(torch.where(mask, tmp, torch.zeros_like(tmp)))
    if tcfg.use_color_in_tracking:
        cdiff = torch.abs(pix_color - color)
        loss = loss + tcfg.w_color_loss * torch.sum(
            torch.where(mask[:, None], cdiff, torch.zeros_like(cdiff)))
    return loss


def track_frame_sampled(spec: SceneSpec, state: SceneState,
                        init_tensor: torch.Tensor, pix_i: torch.Tensor,
                        pix_j: torch.Tensor, pix_depth: torch.Tensor,
                        pix_color: torch.Tensor, tcfg: TrackerConfig,
                        rcfg: RenderConfig):
    """The per-frame tracking loop over pre-drawn pixel batches shaped
    (iters, pixels[, 3]).  Returns (candidate (7,), losses (iters,),
    post-step cams (iters, 7), final cam (7,)), all left on the device."""
    dev = init_tensor.device
    if tcfg.seperate_LR:
        lr = torch.tensor([0.2] * 4 + [1.0] * 3, device=dev) * tcfg.lr
    else:
        lr = tcfg.lr
    cam = init_tensor.detach().clone().requires_grad_(True)
    opt = GroupAdam({"p": cam})
    losses, cams = [], []
    for it in range(tcfg.iters):
        loss = tracking_loss_sampled(spec, state, cam, pix_i[it], pix_j[it],
                                     pix_depth[it], pix_color[it], tcfg, rcfg)
        (g,) = torch.autograd.grad(loss, cam)
        lr_it = lr * (tcfg.cf_lr_mult if it < tcfg.cf_iters else 1.0)
        opt.step({"p": [g]}, {"p": lr_it}, {"p": True})
        losses.append(loss.detach())
        cams.append(cam.detach().clone())
    losses = torch.stack(losses)
    cams = torch.stack(cams)
    return cams[torch.argmin(losses)], losses, cams, cam.detach()


def presample_pixels(seed: int, idx: int, tcfg: TrackerConfig,
                     color: np.ndarray, depth: np.ndarray,
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Draw ``iters`` uniform batches of ``pixels`` pixels from the
    edge-cropped image (duplicates allowed) with a Philox stream keyed by
    (seed, idx), and gather their depth and color.  Returns (i, j, depth,
    color) as (iters, n) f32 x3 and (iters, n, 3) f32."""
    He, We = tcfg.ignore_edge_H, tcfg.ignore_edge_W
    hs = tcfg.H - 2 * He
    ws = tcfg.W - 2 * We
    rng = np.random.Generator(np.random.Philox(key=[seed, idx]))
    flat = rng.integers(0, hs * ws, size=(tcfg.iters, tcfg.pixels))
    r = flat // ws + He
    c = flat % ws + We
    return (c.astype(np.float32), r.astype(np.float32),
            np.ascontiguousarray(depth[r, c], dtype=np.float32),
            np.ascontiguousarray(color[r, c], dtype=np.float32))


def const_speed_init(pre_c2w: torch.Tensor,
                     pre_pre_c2w: Optional[torch.Tensor]) -> torch.Tensor:
    """Constant-speed motion model on 4x4 poses: repeat the last relative
    motion."""
    if pre_pre_c2w is None:
        return pre_c2w
    return (pre_c2w @ invert(pre_pre_c2w)) @ pre_c2w
