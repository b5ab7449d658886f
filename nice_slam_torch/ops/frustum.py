"""Frustum feature selection: the mask of the grid nodes the current camera
sees, counterpart of the JAX package's ``slam/mapper.py`` ``frustum_mask``.

A node is kept if it projects inside the image with 0 <= camera depth <=
sensor depth + 0.5 (the depth looked up bilinearly, 0 outside the image;
a 0 lookup replaced by the grid's largest lookup), or lies within 0.5 m
of the camera.  On the card this is K10 (``nice_slam_torch/csrc/
frustum.cu``, ``frustum_mask``): one cooperative launch over the distinct
grids of a call, which writes each mask as the float the Adam step (K9)
reads as its gradient mask, and each grid's largest lookup.

The grids of one call share the camera and the bound, so grids of one
shape have one mask: ``frustum_masks`` computes each distinct shape once
and hands the same tensor to each grid of that shape (the mapper's fine
and color grids), on the card and on the CPU alike.  Nothing writes to a
mask.  A mask may be asked for in the slab layout (``rows`` x-planes,
plane i holding node plane min(i, nx - 1)), which
``parallel/grid_sharding.py`` ``mask_to_slabs`` cuts into views.

``frustum_mask_plain`` is the plain PyTorch version; a CPU tensor takes
it, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from nice_slam_torch.ops import kernels
from nice_slam_torch.ops.geometry import invert, linspace
from nice_slam_torch.ops.interp import bilinear_sample_2d

# launches per kernel (see ``kernels.LaunchCounter``)
_launches = kernels.LaunchCounter(("frustum_mask",))
launch_counts = _launches.counts
launches_by_stream = _launches.by_stream
launches_by_device = _launches.by_device
reset_launch_counts = _launches.reset

MAX_GRIDS = 4  # distinct grids per launch (kMaxGrids in frustum.cu)
FRUSTUM_THREADS = 256  # threads per CTA (kThreads in frustum.cu)

Shape = Tuple[int, int, int]


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


class FrustumGeometry(NamedTuple):
    """K10's launch: ``ctas`` CTAs of ``threads`` threads over ``items``
    (every output element of the distinct grids, grid after grid); thread
    x walks items x, x + S, x + 2S, ... (S = ctas x threads), at most
    ``per_thread`` of them."""

    ctas: int
    threads: int
    items: int
    per_thread: int


def frustum_geometry(node_counts: Sequence[int], sms: int,
                     ctas_per_sm: int) -> FrustumGeometry:
    """K10's launch geometry, a function of these numbers alone: a CTA per
    FRUSTUM_THREADS items, but no more than the card holds at once (``sms``
    x ``ctas_per_sm``), since the cooperative launch's grid barrier needs
    every CTA resident (at 6 CTAs a SM on 132 SMs, the Replica room's
    199,948 distinct nodes: 782 CTAs, one node a thread; Apartment's
    514,471: all 792 slots, three a thread)."""
    items = sum(node_counts)
    ctas = max(1, min(-(-items // FRUSTUM_THREADS), sms * ctas_per_sm))
    return FrustumGeometry(ctas=ctas, threads=FRUSTUM_THREADS, items=items,
                           per_thread=-(-items // (ctas * FRUSTUM_THREADS)))


def frustum_kernel_info(device: torch.device) -> Dict[str, int]:
    """K10's compiled resources, read with cudaFuncGetAttributes and the
    occupancy API: registers, local (spill) bytes, threads and resident
    CTAs per SM."""
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        rc = kernels.library("frustum").frustum_info(out)
    kernels.check(rc, "frustum_info")
    return dict(zip(("registers", "local_bytes", "threads", "ctas_per_sm"), out))


@functools.lru_cache(maxsize=256)
def _geometry(index: int, node_counts: Tuple[int, ...]) -> FrustumGeometry:
    """``frustum_geometry`` of a launch on card ``index``, worked out once
    per grid set: each call then costs one cache lookup."""
    return frustum_geometry(node_counts, kernels.sm_count(index),
                            frustum_kernel_info(torch.device("cuda", index))["ctas_per_sm"])


def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...],
           device: torch.device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must lie on the camera's CUDA device {device}, "
                         f"not {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {shape}, got {tuple(t.shape)}")


def _distinct(shapes: Sequence[Shape], rows: Optional[Sequence[int]]
              ) -> Tuple[List[Tuple[Shape, int]], List[int]]:
    """The distinct (shape, rows) of a call, and each requested grid's
    index among them."""
    if rows is None:
        rows = [s[0] for s in shapes]
    if len(rows) != len(shapes):
        raise ValueError(f"{len(rows)} row counts for {len(shapes)} grids")
    keys = [(tuple(int(n) for n in s), int(r)) for s, r in zip(shapes, rows)]
    for (nx, _, _), r in keys:
        if r < nx:
            raise ValueError(f"{r} rows cannot hold a grid of {nx} x-planes")
    distinct = list(dict.fromkeys(keys))
    if not 1 <= len(distinct) <= MAX_GRIDS:
        raise ValueError(f"one launch takes 1..{MAX_GRIDS} distinct grids, "
                         f"got {len(distinct)}")
    return distinct, [distinct.index(k) for k in keys]


def _plain(c2w, depth_img, bound, key, H, W, fx, fy, cx, cy) -> torch.Tensor:
    """The plain version's float mask of one distinct grid, its last
    x-plane repeated up to ``rows`` planes."""
    shape, rows = key
    m = frustum_mask_plain(c2w, depth_img, bound, shape, H, W, fx, fy, cx, cy)
    m = m[..., None].to(torch.float32)
    if rows > shape[0]:
        m = m[torch.arange(rows).clamp_(max=shape[0] - 1)]
    return m


def _k10(c2w, depth_img, bound, distinct, H, W, fx, fy, cx, cy):
    """K10's one launch on the camera's card and its current stream:
    the distinct grids' float masks and their largest lookups (a float
    each), all views of one allocation with the kernel's scratch."""
    dev = c2w.device
    c2w = c2w.contiguous()
    _check("c2w", c2w, (4, 4), dev)
    _check("depth", depth_img, (H, W), dev)
    _check("bound", bound, (3, 2), dev)
    w2c = invert(c2w).contiguous()  # the CUDA inverse comes column-major
    sizes = [r * s[1] * s[2] for s, r in distinct]
    geo = _geometry(dev.index, tuple(sizes))
    count = len(distinct)
    buf = torch.empty(sum(sizes) + count * (geo.ctas + 1), dtype=torch.float32, device=dev)
    outs, desc, at = [], [], 0
    for (shape, rows), n in zip(distinct, sizes):
        o = buf[at:at + n].view(rows, shape[1], shape[2], 1)
        outs.append(o)
        desc += [o.data_ptr(), *shape, rows]
        at += n
    slots = buf[at:at + count * geo.ctas]
    top = buf[at + count * geo.ctas:]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = kernels.library("frustum").frustum_mask(
            (ctypes.c_longlong * len(desc))(*desc), count, depth_img.data_ptr(), H, W,
            bound.data_ptr(), w2c.data_ptr(), c2w.data_ptr(), float(fx), float(fy),
            float(cx), float(cy), slots.data_ptr(), top.data_ptr(), geo.ctas, stream)
        kernels.check(rc, "frustum_mask")
    _launches.count("frustum_mask", stream, dev.index)
    return outs, top


def frustum_masks(c2w: torch.Tensor, depth_img: torch.Tensor, bound: torch.Tensor,
                  shapes: Sequence[Shape], H: int, W: int, fx, fy, cx, cy,
                  rows: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
    """The float (rows, ny, nz, 1) masks (1 seen, 0 not) of grids spanning
    ``bound`` for one camera ``c2w`` (4, 4) and its depth image (H, W), up
    to MAX_GRIDS distinct (shape, rows): on the card K10's one launch for
    all of them.  ``rows`` (default each grid's nx) >= nx lays a mask out
    for the slabs: plane i holds node plane min(i, nx - 1).  Grids of one
    shape and rows get one tensor."""
    distinct, index = _distinct(shapes, rows)
    if c2w.is_cuda:
        outs = _k10(c2w, depth_img, bound, distinct, H, W, fx, fy, cx, cy)[0]
    else:
        outs = [_plain(c2w, depth_img, bound, k, H, W, fx, fy, cx, cy) for k in distinct]
    return [outs[i] for i in index]


def frustum_depth_max(c2w: torch.Tensor, depth_img: torch.Tensor, bound: torch.Tensor,
                      shapes: Sequence[Shape], H: int, W: int,
                      fx, fy, cx, cy) -> torch.Tensor:
    """Each grid's largest depth lookup (one float per grid of ``shapes``),
    which the mask puts in place of a 0 lookup: K10's own output of one
    launch (counted as ``frustum_mask``)."""
    distinct, index = _distinct(shapes, None)
    top = _k10(c2w, depth_img, bound, distinct, H, W, fx, fy, cx, cy)[1]
    return top[index]
