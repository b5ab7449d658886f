"""The volume-render integrator: counterpart of the JAX package's
``ops/geometry.py`` ``raw2outputs_nerf_color``.

One ``torch.autograd.Function`` over two hand-written CUDA kernels
(``nice_slam_torch/csrc/integrator.cu``), each with a plain PyTorch
version beside it:

  K7 ``integrate_fwd``  alpha, transmittance, weights, depth, depth
                        variance and rgb of each ray in one pass;
  K8 ``integrate_bwd``  the gradients of ``raw`` and, in density mode,
                        of ``rays_d`` (the intervals scale by |rays_d|),
                        by a reverse scan without division.

Both walk a ray with a group of 16 or 32 lanes, which hold its samples
in blocks of that many (coalesced loads, each sample read once) and
combine with warp shuffles: a product scan for the transmittance, a scan
of affine maps for K8's reverse recurrence, butterflies for the sums.
``integrate_geometry`` chooses the group per launch; a ray longer than a
tile (``INTEGRATE_RUN`` blocks) walks tiles, carrying the scans.

Occupancy mode: alpha = sigmoid(10 * raw[..., 3]); density mode: alpha =
1 - exp(-relu(raw[..., 3]) * dist) with |rays_d|-scaled intervals and a
1e10 last interval.  Weights w_i = a_i * prod_{j<i}(1 - a_j + 1e-10).

``z_vals`` carries no gradient on any path of the port (the far plane is
detached and the near plane and the surface samples come from sensor
depth), so the Function raises on a ``z_vals`` that requires one.  The
weights it returns are not differentiable: their one reader is the
importance pass, which runs without a graph.  A wrapper takes the plain
version only for tensors on the CPU; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from nice_slam_torch.ops import kernels

# launches per kernel (see ``kernels.LaunchCounter``)
_launches = kernels.LaunchCounter(("integrate_fwd", "integrate_bwd"))
launch_counts = _launches.counts
launches_by_stream = _launches.by_stream
launches_by_device = _launches.by_device
reset_launch_counts = _launches.reset

INTEGRATE_LANES = (16, 32)  # lanes per ray of K7's and K8's instances
INTEGRATE_RUN = 4  # blocks of a ray a lane holds, a tile (kRun in integrator.cu)
INTEGRATE_THREADS = 128  # threads per CTA (kThreads)


class IntegrateGeometry(NamedTuple):
    lanes: int         # lanes per ray; lane k holds sample b * lanes + k of block b
    per_lane: int      # samples a lane holds at once (blocks in a tile)
    tiles: int         # tiles a ray walks; above 1, the tiled path
    rays_per_cta: int
    threads: int
    ctas: int


def integrate_geometry(n: int, s: int, sms: int) -> IntegrateGeometry:
    """K7's and K8's launch geometry for ``n`` rays of ``s`` samples on a
    card of ``sms`` SMs: 16 lanes per ray where a tile of them holds the
    ray (64 samples) and the launch fills the SMs, else 32 (a render chunk
    and an iMAP* batch take 16; tracking's 200 and mapping's 1000 rays 32,
    50 and 250 CTAs; rays past 128 samples walk tiles)."""
    narrow = INTEGRATE_LANES[0]
    fills = -(-n // (INTEGRATE_THREADS // narrow)) >= sms
    lanes = narrow if s <= narrow * INTEGRATE_RUN and fills else INTEGRATE_LANES[-1]
    blocks = -(-s // lanes)
    rays = INTEGRATE_THREADS // lanes
    return IntegrateGeometry(lanes=lanes, per_lane=min(blocks, INTEGRATE_RUN),
                             tiles=-(-blocks // INTEGRATE_RUN), rays_per_cta=rays,
                             threads=INTEGRATE_THREADS, ctas=-(-n // rays))


def launch_geometry(n: int, s: int, device: torch.device) -> IntegrateGeometry:
    """``integrate_geometry`` of a launch on ``device``."""
    return integrate_geometry(n, s, kernels.sm_count(device.index))


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the reference the kernels are
# held against on the card)
# ---------------------------------------------------------------------------

def _alpha(raw: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor,
           occupancy: bool):
    """alpha (N, S); in density mode also the unscaled intervals (N, S),
    |rays_d| (N, 1) and exp(-relu(sigma) * dist) (N, S)."""
    if occupancy:
        return torch.sigmoid(10.0 * raw[..., 3]), None, None, None
    dz = z_vals[..., 1:] - z_vals[..., :-1]
    dz = torch.cat([dz, torch.full_like(dz[..., :1], 1e10)], dim=-1)
    norm = torch.linalg.norm(rays_d[..., None, :], dim=-1)
    e = torch.exp(-torch.relu(raw[..., 3]) * (dz * norm))
    return 1.0 - e, dz, norm, e


def _transmittance(alpha: torch.Tensor) -> torch.Tensor:
    """T_i = prod_{j<i}(1 - a_j + 1e-10), T_0 = 1."""
    ones = torch.ones_like(alpha[..., :1])
    return torch.cumprod(torch.cat([ones, 1.0 - alpha + 1e-10], dim=-1),
                         dim=-1)[..., :-1]


def integrate_fwd_plain(raw: torch.Tensor, z_vals: torch.Tensor,
                        rays_d: torch.Tensor, occupancy: bool = False):
    """K7's plain version: (depth (N,), depth_var (N,), rgb (N, 3),
    weights (N, S)) of raw decoder outputs (N, S, 4) along the rays."""
    alpha = _alpha(raw, z_vals, rays_d, occupancy)[0]
    weights = alpha * _transmittance(alpha)
    rgb_map = torch.sum(weights[..., None] * raw[..., :3], dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    tmp = z_vals - depth_map[..., None]
    depth_var = torch.sum(weights * tmp * tmp, dim=-1)
    return depth_map, depth_var, rgb_map, weights


def integrate_bwd_plain(raw: torch.Tensor, z_vals: torch.Tensor,
                        rays_d: torch.Tensor, depth: torch.Tensor,
                        g_depth: torch.Tensor, g_var: torch.Tensor,
                        g_rgb: torch.Tensor, occupancy: bool = False
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K8's plain version: the gradients (raw (N, S, 4), rays_d (N, 3) in
    density mode, else None) of the cotangents of depth, depth_var and
    rgb, with the forward's ``depth``.  With g_i = dL/dw_i,
    dL/da_i = T_i (g_i - R_i), R_i = sum_{k>i} g_k a_k prod_{i<j<k} f_j
    (f = 1 - a + 1e-10), written out as the reverse scan
    R_{i-1} = g_i a_i + f_i R_i: no division by f, which is 1e-10 where
    alpha saturates to 1."""
    alpha, dz, norm, e = _alpha(raw, z_vals, rays_d, occupancy)
    T = _transmittance(alpha)
    w = alpha * T
    diff = z_vals - depth[:, None]
    m = torch.sum(w * diff, dim=-1, keepdim=True)
    g = (torch.sum(g_rgb[:, None, :] * raw[..., :3], dim=-1)
         + g_depth[:, None] * z_vals
         + g_var[:, None] * (diff * diff - 2.0 * z_vals * m))
    f = 1.0 - alpha + 1e-10
    b = g * alpha
    S = raw.shape[1]
    R = torch.zeros_like(g)
    for i in range(S - 1, 0, -1):
        R[:, i - 1] = b[:, i] + f[:, i] * R[:, i]
    da = T * (g - R)
    if occupancy:
        dsig = da * 10.0 * alpha * (1.0 - alpha)
        g_rays = None
    else:
        on = raw[..., 3] > 0
        dsig = torch.where(on, da * e * (dz * norm), torch.zeros_like(da))
        gnorm = torch.sum(torch.where(on, da * e * raw[..., 3] * dz,
                                      torch.zeros_like(da)), dim=-1)
        g_rays = (gnorm / norm[:, 0])[:, None] * rays_d
    g_raw = torch.cat([w[..., None] * g_rgb[:, None, :], dsig[..., None]], dim=-1)
    return g_raw, g_rays


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...],
           device: torch.device, align: int = 4) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must lie on the rays' CUDA device {device}, "
                         f"not {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name} must be contiguous and {align}-byte aligned")


def _check_call(raw: torch.Tensor, z_vals: torch.Tensor,
                rays_d: torch.Tensor) -> Tuple[int, int]:
    if raw.dim() != 3 or raw.shape[2] != 4:
        raise ValueError(f"raw must be (N, S, 4), got {tuple(raw.shape)}")
    n, s = raw.shape[:2]
    if n * s * 4 >= 2 ** 31:
        raise ValueError("too many samples for 32-bit launch indices")
    _check("raw", raw, (n, s, 4), raw.device, 16)
    _check("z_vals", z_vals, (n, s), raw.device)
    _check("rays_d", rays_d, (n, 3), raw.device)
    return n, s


def _launch(name: str, device: torch.device, *args) -> None:
    """Launch ``name`` on ``device`` and its current stream, and count it."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(kernels.library("integrator"), name)(*args, stream)
        kernels.check(rc, name)
    _launches.count(name, stream, device.index)


def integrate_fwd(raw: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor,
                  occupancy: bool = False):
    """K7: (depth, depth_var, rgb, weights) of (N, S, 4) raw outputs along
    N rays of S samples each."""
    if not raw.is_cuda:
        return integrate_fwd_plain(raw, z_vals, rays_d, occupancy)
    n, s = _check_call(raw, z_vals, rays_d)
    dev = raw.device
    depth = torch.empty(n, dtype=torch.float32, device=dev)
    var = torch.empty(n, dtype=torch.float32, device=dev)
    rgb = torch.empty((n, 3), dtype=torch.float32, device=dev)
    weights = torch.empty((n, s), dtype=torch.float32, device=dev)
    if n and s:
        geom = launch_geometry(n, s, dev)
        _launch("integrate_fwd", dev, raw.data_ptr(), z_vals.data_ptr(),
                rays_d.data_ptr(), n, s, int(occupancy), geom.lanes, geom.ctas,
                depth.data_ptr(), var.data_ptr(), rgb.data_ptr(), weights.data_ptr())
    return depth, var, rgb, weights


def integrate_bwd(raw: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor,
                  depth: torch.Tensor, g_depth: torch.Tensor, g_var: torch.Tensor,
                  g_rgb: torch.Tensor, occupancy: bool = False,
                  need_rays: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K8: the gradients of raw (N, S, 4) and, in density mode where
    ``need_rays``, of rays_d (N, 3) (else None)."""
    if not raw.is_cuda:
        g_raw, g_rays = integrate_bwd_plain(raw, z_vals, rays_d, depth, g_depth,
                                            g_var, g_rgb, occupancy)
        return g_raw, g_rays if need_rays else None
    n, s = _check_call(raw, z_vals, rays_d)
    dev = raw.device
    for name, t, shape in (("depth", depth, (n,)), ("grad depth", g_depth, (n,)),
                           ("grad depth_var", g_var, (n,)), ("grad rgb", g_rgb, (n, 3))):
        _check(name, t, shape, dev)
    g_raw = torch.empty((n, s, 4), dtype=torch.float32, device=dev)
    g_rays = (torch.empty((n, 3), dtype=torch.float32, device=dev)
              if need_rays and not occupancy else None)
    if n and s:
        geom = launch_geometry(n, s, dev)
        # the tiled path's scratch: each tile's transmittance carry
        carry = (torch.empty((n, geom.tiles), dtype=torch.float32, device=dev)
                 if geom.tiles > 1 else None)
        _launch("integrate_bwd", dev, raw.data_ptr(), z_vals.data_ptr(),
                rays_d.data_ptr(), depth.data_ptr(), g_depth.data_ptr(),
                g_var.data_ptr(), g_rgb.data_ptr(), n, s, int(occupancy), geom.lanes,
                geom.ctas, g_raw.data_ptr(), 0 if g_rays is None else g_rays.data_ptr(),
                0 if carry is None else carry.data_ptr())
    return g_raw, g_rays


def integrate_kernel_info(bwd: bool, occupancy: bool, device: torch.device,
                          lanes: int) -> Dict[str, int]:
    """K7's (or K8's) compiled resources at ``lanes`` lanes per ray in one
    mode, read with cudaFuncGetAttributes and the occupancy API: registers,
    local (spill) bytes, threads, resident CTAs per SM and the blocks a
    lane holds."""
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        rc = kernels.library("integrator").integrate_info(int(bwd), int(occupancy),
                                                          lanes, out)
    kernels.check(rc, "integrate_info")
    return dict(zip(("registers", "local_bytes", "threads", "ctas_per_sm", "run"), out))


class _Integrate(torch.autograd.Function):
    """Forward K7, backward K8; gradients reach raw and, in density mode,
    rays_d."""

    @staticmethod
    def forward(ctx, raw, z_vals, rays_d, occupancy):
        raw = raw.contiguous()
        z_vals = z_vals.contiguous()
        rays_d = rays_d.contiguous()
        depth, var, rgb, weights = integrate_fwd(raw, z_vals, rays_d, occupancy)
        ctx.occupancy = occupancy
        ctx.mark_non_differentiable(weights)
        ctx.save_for_backward(raw, z_vals, rays_d, depth)
        return depth, var, rgb, weights

    @staticmethod
    def backward(ctx, g_depth, g_var, g_rgb, _g_weights):
        raw, z_vals, rays_d, depth = ctx.saved_tensors
        need_rays = ctx.needs_input_grad[2] and not ctx.occupancy
        g_raw, g_rays = integrate_bwd(raw, z_vals, rays_d, depth,
                                      g_depth.contiguous(), g_var.contiguous(),
                                      g_rgb.contiguous(), ctx.occupancy, need_rays)
        return (g_raw if ctx.needs_input_grad[0] else None, None,
                g_rays if need_rays else None, None)


def raw2outputs_nerf_color(raw: torch.Tensor, z_vals: torch.Tensor,
                           rays_d: torch.Tensor, occupancy: bool = False):
    """Integrate raw decoder outputs (N, S, 4) along rays: (depth (N,),
    depth_var (N,), rgb (N, 3), weights (N, S)), differentiable in raw
    and (density mode) rays_d.  Raises if ``z_vals`` requires a
    gradient, which no path of the port gives it."""
    if z_vals.requires_grad:
        raise ValueError("raw2outputs_nerf_color takes no gradient through "
                         "z_vals; detach them")
    return _Integrate.apply(raw, z_vals, rays_d, occupancy)
