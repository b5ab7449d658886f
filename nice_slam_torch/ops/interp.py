"""Trilinear feature-grid interpolation: counterpart of
the JAX package's ``ops/interp.py``, the hottest op of the system.

Grids are channels-last ``(Nx, Ny, Nz, C)``; points are ``(N, 3)``
normalized to [-1, 1] in (x, y, z) order.  Numerics follow
``grid_sample(mode='bilinear', padding_mode='border', align_corners=True)``:
u = (p+1)/2*(S-1) clamped to [0, S-1], floor corner i0, i1 = min(i0+1, S-1).

The lookup is one ``torch.autograd.Function`` over all the grids a
decoder stage reads at the same points (``trilinear_interp_multi``; the
one-grid ``trilinear_interp`` is its special case), built on three
hand-written CUDA kernels (``nice_slam_torch/csrc/trilinear.cu``), each
with a plain PyTorch version beside it:

  K1 ``trilinear_fwd``        the 8-corner gather + lerp, one launch per grid;
  K2 ``trilinear_bwd_dgrid``  the grid gradients (scatter-add of w_k * g),
                              one launch for every grid that needs one;
  K3 ``trilinear_bwd_dp``     the point gradient (g . c_k through dw_k/du,
                              with the border-clamp derivative mask), summed
                              over the grids in one launch.

The backward runs K2 only when a grid needs a gradient and K3 only when
the points do, so tracking (frozen grids, pose gradient) never runs K2.
A wrapper takes the plain version only for tensors on the CPU; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from nice_slam_torch.ops import kernels
from nice_slam_torch.ops.geometry import normalize_3d_coordinate

# launches per kernel, counted where each wrapper launches its kernel
launch_counts: Dict[str, int] = {"trilinear_fwd": 0, "trilinear_bwd_dgrid": 0,
                                 "trilinear_bwd_dp": 0}

MAX_GRIDS = 3  # grids per K2/K3 launch (kMaxGrids in trilinear.cu)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the reference the kernels are
# held against on the card)
# ---------------------------------------------------------------------------

def _corners(shape, p: torch.Tensor):
    """Clamped index, corner indices, lerp fractions and du/dp with the
    clamp-derivative mask (0.5 at exact ties, like jnp.clip's vjp)."""
    nx, ny, nz = shape[:3]
    sizes = torch.tensor([nx, ny, nz], dtype=p.dtype, device=p.device)
    raw = (p + 1.0) * 0.5 * (sizes - 1.0)
    u = torch.minimum(torch.clamp(raw, min=0.0), sizes - 1.0)
    i0f = torch.floor(u)
    frac = u - i0f
    i0 = i0f.to(torch.int64)
    i1 = torch.minimum(i0 + 1, (sizes - 1.0).to(torch.int64))
    strict = ((raw > 0.0) & (raw < sizes - 1.0)).to(p.dtype)
    tie = ((raw == 0.0) | (raw == sizes - 1.0)).to(p.dtype)
    dudp = 0.5 * (sizes - 1.0) * (strict + 0.5 * tie)
    return i0, i1, frac, dudp


def _corner_rows(shape, i0, i1):
    """Flat row of each of the 8 corners (bit0 -> x uses i1, bit1 -> y,
    bit2 -> z)."""
    _, ny, nz = shape[:3]
    rows = []
    for k in range(8):
        ix = i1[:, 0] if k & 1 else i0[:, 0]
        iy = i1[:, 1] if k & 2 else i0[:, 1]
        iz = i1[:, 2] if k & 4 else i0[:, 2]
        rows.append((ix * ny + iy) * nz + iz)
    return rows


def _corner_weights(frac):
    """The 8 trilinear weights and their derivatives wrt frac (x, y, z)."""
    fx, fy, fz = frac[:, 0], frac[:, 1], frac[:, 2]
    wx, wy, wz = (1 - fx, fx), (1 - fy, fy), (1 - fz, fz)
    one = torch.ones_like(fx)
    dw = (-one, one)
    weights, dweights = [], []
    for k in range(8):
        bx, by, bz = k & 1, (k >> 1) & 1, (k >> 2) & 1
        weights.append(wx[bx] * wy[by] * wz[bz])
        dweights.append((dw[bx] * wy[by] * wz[bz],
                         wx[bx] * dw[by] * wz[bz],
                         wx[bx] * wy[by] * dw[bz]))
    return weights, dweights


def trilinear_fwd_plain(grid: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """K1's plain version: gather the 8 corner rows, lerp z, then y, then x."""
    C = grid.shape[-1]
    i0, i1, frac, _ = _corners(grid.shape, p)
    flat = grid.reshape(-1, C)
    c = [flat.index_select(0, r) for r in _corner_rows(grid.shape, i0, i1)]
    fx, fy, fz = frac[:, 0:1], frac[:, 1:2], frac[:, 2:3]
    c00 = c[0] * (1 - fz) + c[4] * fz
    c01 = c[2] * (1 - fz) + c[6] * fz
    c10 = c[1] * (1 - fz) + c[5] * fz
    c11 = c[3] * (1 - fz) + c[7] * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


def trilinear_bwd_dgrid_plain(p: torch.Tensor, g: torch.Tensor,
                              shape: Tuple[int, int, int, int]) -> torch.Tensor:
    """K2's plain version: scatter-add w_k * g into the 8 corner rows.  A
    clamped +1 corner has weight exactly 0, so it adds nothing anywhere."""
    nx, ny, nz, C = shape
    i0, i1, frac, _ = _corners(shape, p)
    weights, _ = _corner_weights(frac)
    out = torch.zeros((nx * ny * nz, C), dtype=g.dtype, device=g.device)
    for r, w in zip(_corner_rows(shape, i0, i1), weights):
        out.index_add_(0, r, w[:, None] * g)
    return out.reshape(shape)


def trilinear_bwd_dp_plain(grid: torch.Tensor, p: torch.Tensor,
                           g: torch.Tensor) -> torch.Tensor:
    """K3's plain version: dp = sum_k (g . c_k) * dw_k/dfrac * du/dp."""
    C = grid.shape[-1]
    i0, i1, frac, dudp = _corners(grid.shape, p)
    _, dweights = _corner_weights(frac)
    flat = grid.reshape(-1, C)
    gdotc = [torch.sum(flat.index_select(0, r) * g, dim=-1)
             for r in _corner_rows(grid.shape, i0, i1)]
    df = [sum(gc * dw[a] for gc, dw in zip(gdotc, dweights)) for a in range(3)]
    return torch.stack(df, dim=-1) * dudp


def trilinear_bwd_dgrid_multi_plain(p: torch.Tensor, gs: Sequence[torch.Tensor],
                                    shapes: Sequence[Tuple[int, int, int, int]]
                                    ) -> List[torch.Tensor]:
    """K2's plain version over several grids: one gradient per grid."""
    return [trilinear_bwd_dgrid_plain(p, g, s) for g, s in zip(gs, shapes)]


def trilinear_bwd_dp_multi_plain(grids: Sequence[torch.Tensor], p: torch.Tensor,
                                 gs: Sequence[torch.Tensor]) -> torch.Tensor:
    """K3's plain version over several grids: the sum of their dp."""
    dp = trilinear_bwd_dp_plain(grids[0], p, gs[0])
    for grid, g in zip(grids[1:], gs[1:]):
        dp = dp + trilinear_bwd_dp_plain(grid, p, g)
    return dp


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, ndim: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must lie on the same CUDA device as the grid")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_launch(grid_shape, p: torch.Tensor) -> Tuple[int, int, int, int, int]:
    nx, ny, nz, C = grid_shape
    L = C // 4
    if C % 4 or L > 32 or L & (L - 1):
        raise ValueError(f"channel count {C} must be 4 x a power of two <= 128")
    if p.shape[-1] != 3:
        raise ValueError(f"points must be (N, 3), got {tuple(p.shape)}")
    if p.shape[0] * L >= 2 ** 31 or nx * ny * nz * C >= 2 ** 31:
        raise ValueError("problem too large for 32-bit launch indices")
    return p.shape[0], nx, ny, nz, C


def _check_grads(p: torch.Tensor, gs: Sequence[torch.Tensor],
                 shapes: Sequence[Tuple[int, int, int, int]]) -> Tuple[int, int]:
    """Checks shared by K2 and K3: 1..MAX_GRIDS grids of one channel count,
    one (N, C) cotangent each.  Returns (N, C)."""
    if not 1 <= len(gs) <= MAX_GRIDS or len(shapes) != len(gs):
        raise ValueError(f"one launch takes 1..{MAX_GRIDS} grids with one "
                         f"cotangent each, got {len(shapes)} and {len(gs)}")
    _check("points", p, 2)
    C = shapes[0][3]
    for g, shape in zip(gs, shapes):
        _check("grad_output", g, 2)
        n, _, _, _, c = _check_launch(shape, p)
        if c != C or g.shape != (n, C):
            raise ValueError(f"grad_output must be {(n, C)} for grid {tuple(shape)}, "
                             f"got {tuple(g.shape)}")
    return p.shape[0], C


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def trilinear_fwd(grid: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """K1: (Nx, Ny, Nz, C) grid, (N, 3) points -> (N, C) features."""
    if not grid.is_cuda:
        return trilinear_fwd_plain(grid, p)
    _check("grid", grid, 4)
    _check("points", p, 2)
    n, nx, ny, nz, C = _check_launch(grid.shape, p)
    out = torch.empty((n, C), dtype=grid.dtype, device=grid.device)
    if n:
        rc = kernels.library("trilinear").trilinear_fwd(
            grid.data_ptr(), p.data_ptr(), out.data_ptr(), n, nx, ny, nz, C,
            _stream())
        kernels.check(rc, "trilinear_fwd")
        launch_counts["trilinear_fwd"] += 1
    return out


def trilinear_bwd_dgrid_multi(p: torch.Tensor, gs: Sequence[torch.Tensor],
                              shapes: Sequence[Tuple[int, int, int, int]]
                              ) -> List[torch.Tensor]:
    """K2: the gradients of up to MAX_GRIDS grids looked up at the same
    points, in one launch; each a zeroed float32 grid accumulated by atomics
    (views of one buffer, zeroed by one memset)."""
    if not gs[0].is_cuda:
        return trilinear_bwd_dgrid_multi_plain(p, gs, shapes)
    n, C = _check_grads(p, gs, shapes)
    sizes = [s[0] * s[1] * s[2] * C for s in shapes]
    flat = torch.zeros(sum(sizes), dtype=torch.float32, device=p.device)
    outs = [o.view(s) for o, s in zip(torch.split(flat, sizes), shapes)]
    if n:
        desc = []
        for g, o, s in zip(gs, outs, shapes):
            desc += [g.data_ptr(), o.data_ptr(), s[0], s[1], s[2]]
        rc = kernels.library("trilinear").trilinear_bwd_dgrid(
            (ctypes.c_longlong * len(desc))(*desc), len(gs), p.data_ptr(), n, C,
            _stream())
        kernels.check(rc, "trilinear_bwd_dgrid")
        launch_counts["trilinear_bwd_dgrid"] += 1
    return outs


def trilinear_bwd_dp_multi(grids: Sequence[torch.Tensor], p: torch.Tensor,
                           gs: Sequence[torch.Tensor]) -> torch.Tensor:
    """K3: the point gradient (N, 3), summed over up to MAX_GRIDS grids
    looked up at the same points, in one launch."""
    if not grids[0].is_cuda:
        return trilinear_bwd_dp_multi_plain(grids, p, gs)
    for grid in grids:
        _check("grid", grid, 4)
    n, C = _check_grads(p, gs, [tuple(grid.shape) for grid in grids])
    dp = torch.empty((n, 3), dtype=torch.float32, device=p.device)
    if n:
        desc = []
        for grid, g in zip(grids, gs):
            desc += [grid.data_ptr(), g.data_ptr(), *grid.shape[:3]]
        rc = kernels.library("trilinear").trilinear_bwd_dp(
            (ctypes.c_longlong * len(desc))(*desc), len(grids), p.data_ptr(),
            dp.data_ptr(), n, C, _stream())
        kernels.check(rc, "trilinear_bwd_dp")
        launch_counts["trilinear_bwd_dp"] += 1
    return dp


def trilinear_bwd_dgrid(p: torch.Tensor, g: torch.Tensor,
                        shape: Tuple[int, int, int, int]) -> torch.Tensor:
    """K2 for one grid."""
    return trilinear_bwd_dgrid_multi(p, [g], [shape])[0]


def trilinear_bwd_dp(grid: torch.Tensor, p: torch.Tensor,
                     g: torch.Tensor) -> torch.Tensor:
    """K3 for one grid: the point gradient (N, 3)."""
    return trilinear_bwd_dp_multi([grid], p, [g])


class _Trilinear(torch.autograd.Function):
    """Lookups of several grids at the same points: forward K1 per grid;
    backward one K2 over the grids that need a gradient and one K3 summing
    dp over the grids whose feature has a cotangent."""

    @staticmethod
    def forward(ctx, p, *grids):
        ctx.set_materialize_grads(False)
        p = p.contiguous()
        grids = tuple(grid.contiguous() for grid in grids)
        ctx.save_for_backward(p, *grids)
        return tuple(trilinear_fwd(grid, p) for grid in grids)

    @staticmethod
    def backward(ctx, *gs):
        p, *grids = ctx.saved_tensors
        live = [i for i, g in enumerate(gs) if g is not None]
        gs = [None if g is None else g.contiguous() for g in gs]
        dgrids = [None] * len(grids)
        want = [i for i in live if ctx.needs_input_grad[1 + i]]
        if want:
            outs = trilinear_bwd_dgrid_multi(
                p, [gs[i] for i in want], [tuple(grids[i].shape) for i in want])
            for i, o in zip(want, outs):
                dgrids[i] = o
        dp = None
        if ctx.needs_input_grad[0] and live:
            dp = trilinear_bwd_dp_multi([grids[i] for i in live], p,
                                        [gs[i] for i in live])
        return (dp, *dgrids)


def trilinear_interp_multi(grids: Sequence[torch.Tensor],
                           p_nor: torch.Tensor) -> List[torch.Tensor]:
    """Trilinearly interpolate each channels-last grid at the same (N, 3)
    points in [-1, 1] -> one (N, C) feature per grid, differentiable in the
    grids and the points."""
    return list(_Trilinear.apply(p_nor, *grids))


def trilinear_interp(grid: torch.Tensor, p_nor: torch.Tensor) -> torch.Tensor:
    """The one-grid lookup: (N, 3) points in [-1, 1] -> (N, C)."""
    return _Trilinear.apply(p_nor, grid)[0]


def sample_grid_features(grids: Sequence[torch.Tensor], p_world: torch.Tensor,
                         bound: torch.Tensor) -> List[torch.Tensor]:
    """World-space (N, 3) points -> the features of each dense grid spanning
    the (3, 2) box ``bound``."""
    return trilinear_interp_multi(grids, normalize_3d_coordinate(p_world, bound))


def sample_grid_feature(grid: torch.Tensor, p_world: torch.Tensor,
                        bound: torch.Tensor) -> torch.Tensor:
    """World-space (N, 3) points -> features of the dense grid spanning the
    (3, 2) box ``bound``."""
    return trilinear_interp(grid, normalize_3d_coordinate(p_world, bound))


def bilinear_sample_2d(img: torch.Tensor, u: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of an (H, W) image at pixel coords (u=x, v=y), zero
    outside the image (cv2.remap INTER_LINEAR with a constant-0 border)."""
    H, W = img.shape
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = u - x0
    fy = v - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def tap(xi, yi, w):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        val = img[yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
        return torch.where(valid, val, torch.zeros_like(val)) * w

    return (tap(x0i, y0i, (1 - fx) * (1 - fy))
            + tap(x0i + 1, y0i, fx * (1 - fy))
            + tap(x0i, y0i + 1, (1 - fx) * fy)
            + tap(x0i + 1, y0i + 1, fx * fy))
