"""Frustum feature selection: the mask of the grid nodes the current camera
sees, counterpart of the JAX package's ``slam/mapper.py`` ``frustum_mask``.

A node is kept if it projects inside the image with 0 <= camera depth <=
sensor depth + 0.5 (the depth looked up bilinearly, 0 outside the image;
a 0 lookup replaced by the grid's largest lookup), or lies within 0.5 m
of the camera.  On the card this is K10 (``nice_slam_torch/csrc/
frustum.cu``), two launches over every grid of a mapping call:

  ``frustum_depth_max``  each grid's largest depth lookup;
  ``frustum_mask``       each node's mask, as the float the Adam step
                         (K9) reads as its gradient mask.

``frustum_mask_plain`` is the plain PyTorch version; a CPU tensor takes
it, a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from nice_slam_torch.ops import kernels
from nice_slam_torch.ops.geometry import invert, linspace
from nice_slam_torch.ops.interp import bilinear_sample_2d

# launches per kernel (see ``kernels.LaunchCounter``)
_launches = kernels.LaunchCounter(("frustum_depth_max", "frustum_mask"))
launch_counts = _launches.counts
launches_by_stream = _launches.by_stream
launches_by_device = _launches.by_device
reset_launch_counts = _launches.reset

MAX_GRIDS = 4  # grids per launch (kMaxGrids in frustum.cu)


def frustum_mask_plain(c2w: torch.Tensor, depth_img: torch.Tensor,
                       bound: torch.Tensor, shape: Tuple[int, int, int], H: int,
                       W: int, fx, fy, cx, cy) -> torch.Tensor:
    """K10's plain version: the boolean (nx, ny, nz) mask of one grid."""
    nx, ny, nz = shape
    axes = [linspace(bound[a, 0], bound[a, 1], n)
            for a, n in enumerate((nx, ny, nz))]
    X, Y, Z = torch.meshgrid(*axes, indexing="ij")
    points = torch.stack([X, Y, Z], dim=-1).reshape(-1, 3)
    w2c = invert(c2w)
    cam = points @ w2c[:3, :3].T + w2c[:3, 3]
    zc = cam[:, 2] + 1e-5
    u = (fx * (-cam[:, 0]) + cx * cam[:, 2]) / zc
    v = (fy * cam[:, 1] + cy * cam[:, 2]) / zc
    depths = bilinear_sample_2d(depth_img, u, v)
    depths = torch.where(depths == 0.0, torch.max(depths), depths)
    in_img = (u < W) & (u > 0) & (v < H) & (v > 0)
    mask = in_img & (-zc >= 0.0) & (-zc <= depths + 0.5)
    dist2 = torch.sum((points - c2w[:3, 3]) ** 2, dim=-1)
    return (mask | (dist2 < 0.25)).reshape(nx, ny, nz)


def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...],
           device: torch.device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must lie on the camera's CUDA device {device}, "
                         f"not {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {shape}, got {tuple(t.shape)}")


def _launch(name: str, device: torch.device, *args) -> None:
    """Launch ``name`` on ``device`` and its current stream, and count it."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = kernels.library("frustum").frustum_mask(
            *args, int(name == "frustum_mask"), stream)
        kernels.check(rc, name)
    _launches.count(name, stream, device.index)


def _launch_args(c2w, depth_img, bound, shapes, H, W, fx, fy, cx, cy):
    """K10's checked launch arguments, its (nx, ny, nz, 1) outputs and the
    per-grid buffer of the largest lookups (float bits, zeroed)."""
    if not 1 <= len(shapes) <= MAX_GRIDS:
        raise ValueError(f"one launch takes 1..{MAX_GRIDS} grids, got {len(shapes)}")
    dev = c2w.device
    c2w = c2w.contiguous()
    _check("c2w", c2w, (4, 4), dev)
    _check("depth", depth_img, (H, W), dev)
    _check("bound", bound, (3, 2), dev)
    w2c = invert(c2w).contiguous()
    outs = [torch.empty((*s, 1), dtype=torch.float32, device=dev) for s in shapes]
    desc = []
    for s, o in zip(shapes, outs):
        desc += [o.data_ptr(), *s]
    max_bits = torch.zeros(len(shapes), dtype=torch.int32, device=dev)
    args = ((ctypes.c_longlong * len(desc))(*desc), len(shapes), depth_img.data_ptr(),
            H, W, bound.data_ptr(), w2c.data_ptr(), c2w.data_ptr(),
            float(fx), float(fy), float(cx), float(cy), max_bits.data_ptr())
    # w2c and c2w stay referenced by the caller until the launches are queued
    return args, outs, max_bits, (w2c, c2w)


def frustum_masks(c2w: torch.Tensor, depth_img: torch.Tensor, bound: torch.Tensor,
                  shapes: Sequence[Tuple[int, int, int]], H: int, W: int,
                  fx, fy, cx, cy) -> List[torch.Tensor]:
    """The float (nx, ny, nz, 1) masks (1 seen, 0 not) of up to MAX_GRIDS
    grids spanning ``bound`` for one camera ``c2w`` (4, 4) and its depth
    image (H, W): on the card K10's two launches for all of them."""
    if not c2w.is_cuda:
        return [frustum_mask_plain(c2w, depth_img, bound, s, H, W, fx, fy, cx, cy)
                [..., None].to(torch.float32) for s in shapes]
    args, outs, _, keep = _launch_args(c2w, depth_img, bound, shapes, H, W, fx, fy, cx, cy)
    _launch("frustum_depth_max", c2w.device, *args)
    _launch("frustum_mask", c2w.device, *args)
    del keep
    return outs


def frustum_depth_max(c2w: torch.Tensor, depth_img: torch.Tensor, bound: torch.Tensor,
                      shapes: Sequence[Tuple[int, int, int]], H: int, W: int,
                      fx, fy, cx, cy) -> torch.Tensor:
    """K10's first kernel alone: each grid's largest depth lookup (one
    float per grid), which the mask's second kernel puts in place of a 0
    lookup."""
    args, _, max_bits, keep = _launch_args(c2w, depth_img, bound, shapes, H, W,
                                           fx, fy, cx, cy)
    _launch("frustum_depth_max", c2w.device, *args)
    del keep
    return max_bits.view(torch.float32)


def frustum_kernel_info(which: str, device: torch.device) -> Dict[str, int]:
    """The compiled resources of ``frustum_depth_max`` or ``frustum_mask``:
    registers, local (spill) bytes, threads."""
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        rc = kernels.library("frustum").frustum_info(int(which == "frustum_mask"), out)
    kernels.check(rc, "frustum_info")
    return dict(zip(("registers", "local_bytes", "threads"), out))
