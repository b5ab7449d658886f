"""Volume renderer: counterpart of the JAX package's ``ops/render.py``.

Per ray: far plane = scene-box exit + 0.01, clamped to 1.2 x the batch's
largest sensor depth when depth is given; ``N_samples`` stratified samples
in [0.01 d, far] plus ``N_surface`` samples in [0.95 d, 1.05 d] (rays with
zero depth sweep [0.001, max depth] instead); the merged samples are
sorted, decoded and integrated.  With ``N_importance`` > 0 (the iMAP*
model) that first pass only places ``N_importance`` more samples by
inverse-CDF sampling of its weights (``sample_pdf``); the merged samples
are decoded and integrated again, and only this second pass carries a
gradient.  ``render_img`` renders a whole frame in chunks of
``ray_batch_size`` rays without a gradient.  ``regulation`` draws the
iMAP* free-space samples.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from nice_slam_torch.models.scene import SceneSpec, SceneState, eval_points
from nice_slam_torch.ops.geometry import (
    linspace,
    ray_aabb_far,
    rays_from_uv,
    sample_pdf,
    uniform,
)
from nice_slam_torch.ops.integrator import raw2outputs_nerf_color


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static rendering configuration (cfg['rendering'] + occupancy)."""

    N_samples: int = 32
    N_surface: int = 16
    N_importance: int = 0
    lindisp: bool = False
    perturb: float = 0.0
    occupancy: bool = True
    points_batch_size: int = 500_000
    ray_batch_size: int = 100_000

    @staticmethod
    def from_cfg(cfg) -> "RenderConfig":
        r = cfg["rendering"]
        return RenderConfig(N_samples=r["N_samples"], N_surface=r["N_surface"],
                            N_importance=r["N_importance"], lindisp=r["lindisp"],
                            perturb=r["perturb"], occupancy=bool(cfg["occupancy"]))


def _stratified_z(near: torch.Tensor, far: torch.Tensor, N_samples: int,
                  lindisp: bool, perturb: float,
                  gen: Optional[torch.Generator] = None,
                  t_rand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stratified z-values in [near, far] per ray; near/far are (N, 1) or
    scalars broadcast against (N, 1).  With ``perturb`` each sample moves
    within its stratum by ``t_rand`` (N, N_samples) when given, else by
    uniform draws from ``gen``."""
    t_vals = linspace(0.0, 1.0, N_samples, device=far.device)
    if not lindisp:
        z_vals = near * (1.0 - t_vals) + far * t_vals
    else:
        z_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    if perturb > 0.0:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        if t_rand is None:
            t_rand = uniform(z_vals.shape, gen, z_vals.device)
        z_vals = lower + (upper - lower) * t_rand
    return z_vals


def render_batch_ray(spec: SceneSpec, state: SceneState, rays_o: torch.Tensor,
                     rays_d: torch.Tensor, stage: str,
                     gt_depth: Optional[torch.Tensor] = None,
                     rcfg: RenderConfig = RenderConfig(),
                     gen: Optional[torch.Generator] = None,
                     depth_max: Optional[torch.Tensor] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Render (depth (N,), uncertainty (N,), color (N, 3)) for N rays.  The
    coarse stage always renders without sensor depth.  ``depth_max`` is the
    largest sensor depth of the batch (computed from ``gt_depth`` when
    None): a block of a larger batch, as ray data parallelism renders it,
    passes the whole batch's, so each ray renders as in the whole batch."""
    N_samples, N_surface = rcfg.N_samples, rcfg.N_surface
    if stage == "coarse":
        gt_depth = None
    if gt_depth is None:
        N_surface = 0
        near = torch.tensor(0.01, dtype=rays_o.dtype, device=rays_o.device)
    else:
        gt_depth = gt_depth.reshape(-1, 1)
        near = gt_depth * 0.01

    far = ray_aabb_far(rays_o, rays_d, state.bound).detach()[:, None] + 0.01
    if gt_depth is not None:
        if depth_max is None:
            depth_max = torch.max(gt_depth)
        far = torch.minimum(torch.clamp(far, min=0.0), depth_max * 1.2)

    z_vals = _stratified_z(near, far, N_samples, rcfg.lindisp, rcfg.perturb, gen)
    if N_surface > 0:
        t_surf = linspace(0.0, 1.0, N_surface, device=rays_o.device)
        d = gt_depth
        z_surf_depth = 0.95 * d * (1.0 - t_surf) + 1.05 * d * t_surf
        z_surf_zero = 0.001 * (1.0 - t_surf) + depth_max * t_surf
        z_vals_surface = torch.where(d > 0.0, z_surf_depth, z_surf_zero[None, :])
        z_vals = torch.sort(torch.cat([z_vals, z_vals_surface], dim=-1),
                            dim=-1).values

    def integrate(z):
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
        raw = eval_points(spec, state, pts.reshape(-1, 3), stage)
        return raw2outputs_nerf_color(raw.reshape(z.shape[0], z.shape[1], 4),
                                      z, rays_d, occupancy=rcfg.occupancy)

    if rcfg.N_importance > 0:
        # the first pass only places the new samples, which carry no
        # gradient, so nothing the caller reads depends on it: run it
        # without a graph
        with torch.no_grad():
            weights = integrate(z_vals)[3]
            z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
            z_samples = sample_pdf(z_mid, weights[..., 1:-1], rcfg.N_importance,
                                   det=rcfg.perturb == 0.0, gen=gen)
        z_vals = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1).values
    depth, uncertainty, color, _ = integrate(z_vals)
    return depth, uncertainty, color


def regulation(spec: SceneSpec, state: SceneState, rays_o: torch.Tensor,
               rays_d: torch.Tensor, gt_depth: torch.Tensor, N_samples: int,
               stage: str = "color", gen: Optional[torch.Generator] = None,
               t_rand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """iMAP* free-space regulariser: the raw volume density (N * N_samples,)
    at ``N_samples`` stratified samples (perturb 1, jittered by ``t_rand``
    (N, N_samples) when given, else draws from ``gen``) in [0, 0.85 *
    depth] along each ray."""
    gt_depth = gt_depth.reshape(-1, 1)
    z_vals = _stratified_z(torch.zeros_like(gt_depth), gt_depth * 0.85,
                           N_samples, lindisp=False, perturb=1.0, gen=gen,
                           t_rand=t_rand)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    return eval_points(spec, state, pts.reshape(-1, 3), stage)[:, 3]


def get_rays(H: int, W: int, fx, fy, cx, cy, c2w: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays of every pixel, row-major: (H * W, 3) origins and directions."""
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=c2w.device),
                          torch.arange(W, dtype=torch.float32, device=c2w.device),
                          indexing="ij")
    return rays_from_uv(i.reshape(-1), j.reshape(-1), c2w, fx, fy, cx, cy)


@torch.no_grad()
def render_img(spec: SceneSpec, state: SceneState, c2w: torch.Tensor, H: int,
               W: int, fx, fy, cx, cy, stage: str,
               gt_depth: Optional[torch.Tensor] = None,
               rcfg: RenderConfig = RenderConfig(),
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Render a full (H, W) frame at pose ``c2w`` (3|4, 4) in chunks of
    ``rcfg.ray_batch_size`` rays; ``gt_depth`` (H, W) guides the surface
    samples.  Returns (depth (H, W), uncertainty (H, W), color (H, W, 3))."""
    rays_o, rays_d = get_rays(H, W, fx, fy, cx, cy, c2w)
    gt_flat = None if gt_depth is None else gt_depth.reshape(-1)
    n = rays_o.shape[0]
    chunk = min(rcfg.ray_batch_size, n)
    depths, uncs, colors = [], [], []
    for i in range(0, n, chunk):
        d, u, c = render_batch_ray(
            spec, state, rays_o[i:i + chunk], rays_d[i:i + chunk], stage,
            gt_depth=None if gt_flat is None else gt_flat[i:i + chunk], rcfg=rcfg)
        depths.append(d)
        uncs.append(u)
        colors.append(c)
    return (torch.cat(depths).reshape(H, W), torch.cat(uncs).reshape(H, W),
            torch.cat(colors).reshape(H, W, 3))
