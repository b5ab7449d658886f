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
with a plain PyTorch version beside it, and each one launch for all the
grids of the stage:

  K1 ``trilinear_fwd_multi``  the 8-corner gather + lerp of every grid;
  K2 ``trilinear_bwd_dgrid``  the grid gradients (scatter-add of w_k * g)
                              of every grid that needs one;
  K3 ``trilinear_bwd_dp``     the point gradient (g . c_k through dw_k/du,
                              with the border-clamp derivative mask), summed
                              over the grids.

The backward runs K2 only when a grid needs a gradient and K3 only when
the points do, so tracking (frozen grids, pose gradient) never runs K2.
A wrapper takes the plain version only for tensors on the CPU; a CUDA
tensor launches the kernel or raises.

Every grid of a launch carries a slab ``Window``: a grid spatially
sharded over D devices (``parallel/grid_sharding.py``) is looked up one
x-slab per device, each slab answering the points whose base x-plane it
owns and 0 elsewhere; a dense grid is the one slab that owns every point
(``dense_window``).  A launch runs on its points' device, on that
device's current stream.  ``sample_grid_features`` dispatches on the
grid type: a ``ShardedGrid`` goes to the sharded lookup.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from nice_slam_torch.ops import kernels
from nice_slam_torch.ops.geometry import normalize_3d_coordinate

# launches per kernel (see ``kernels.LaunchCounter``)
_launches = kernels.LaunchCounter(("trilinear_fwd", "trilinear_bwd_dgrid",
                                   "trilinear_bwd_dp"))
launch_counts = _launches.counts
launches_by_stream = _launches.by_stream
launches_by_device = _launches.by_device
reset_launch_counts = _launches.reset
_count = _launches.count

MAX_GRIDS = 3  # grids per K1/K2/K3 launch (kMaxGrids in trilinear.cu)
K1_THREADS = 256  # threads per K1 CTA (kThreads in trilinear.cu)
K1_CHUNK_FROM = 16  # items a K1 thread walks from which each CTA takes a chunk


class Window(NamedTuple):
    """The slab window of one grid in a launch: the grid holds x-planes
    [x_lo, x_lo + planes] of a full grid of ``nx`` x-planes that is cut in
    D slabs of ``planes`` owned planes each (the last plane a halo, the
    next slab's first).  It answers a point when it owns the point's base
    x-plane i0x: min(i0x // planes, D - 1) * planes == x_lo."""

    nx: int
    x_lo: int
    planes: int
    D: int


def dense_window(nx: int) -> Window:
    """A dense grid's window: the one slab, which owns every point."""
    return Window(nx, 0, nx - 1, 1)


def _windows(grids_x: Sequence[int], windows: Optional[Sequence[Window]]
             ) -> List[Window]:
    """The launch's windows (dense where not given), checked against the
    slabs' x-extents ``grids_x``."""
    if windows is None:
        return [dense_window(nx) for nx in grids_x]
    if len(windows) != len(grids_x):
        raise ValueError(f"{len(windows)} windows for {len(grids_x)} grids")
    for sx, w in zip(grids_x, windows):
        ok = sx == w.planes + 1 and w.D >= 1 and w.x_lo >= 0
        if w.D == 1:
            ok = ok and w.x_lo == 0 and w.planes == w.nx - 1
        else:
            ok = (ok and w.planes >= 1 and w.x_lo % w.planes == 0
                  and w.x_lo // w.planes < w.D and w.planes * w.D + 1 >= w.nx)
        if not ok:
            raise ValueError(f"slab of {sx} x-planes does not fit window {w}")
    return list(windows)


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


def _slab_corners(shape, window: Optional[Window], p: torch.Tensor):
    """``_corners`` on the full grid, then the slab window: the x indices
    shifted into the slab and clipped to [0, planes], and ``own`` (N,),
    the points the slab answers (None: a dense grid, which owns all)."""
    if window is None or window.D == 1:
        i0, i1, frac, dudp = _corners(shape, p)
        return i0, i1, frac, dudp, None
    i0, i1, frac, dudp = _corners((window.nx, *shape[1:3]), p)
    owner = torch.clamp(i0[:, 0] // window.planes, max=window.D - 1)
    own = owner * window.planes == window.x_lo
    shift = torch.tensor([window.x_lo, 0, 0], dtype=i0.dtype, device=i0.device)
    hi = torch.tensor([window.planes, shape[1] - 1, shape[2] - 1],
                      dtype=i0.dtype, device=i0.device)
    i0 = torch.minimum(torch.clamp(i0 - shift, min=0), hi)
    i1 = torch.minimum(torch.clamp(i1 - shift, min=0), hi)
    return i0, i1, frac, dudp, own


def trilinear_fwd_plain(grid: torch.Tensor, p: torch.Tensor,
                        window: Optional[Window] = None) -> torch.Tensor:
    """K1's plain version: gather the 8 corner rows, lerp z, then y, then x;
    0 for the points another slab owns."""
    C = grid.shape[-1]
    i0, i1, frac, _, own = _slab_corners(grid.shape, window, p)
    flat = grid.reshape(-1, C)
    c = [flat.index_select(0, r) for r in _corner_rows(grid.shape, i0, i1)]
    fx, fy, fz = frac[:, 0:1], frac[:, 1:2], frac[:, 2:3]
    c00 = c[0] * (1 - fz) + c[4] * fz
    c01 = c[2] * (1 - fz) + c[6] * fz
    c10 = c[1] * (1 - fz) + c[5] * fz
    c11 = c[3] * (1 - fz) + c[7] * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    out = c0 * (1 - fx) + c1 * fx
    if own is not None:
        out = torch.where(own[:, None], out, torch.zeros_like(out))
    return out


def trilinear_bwd_dgrid_plain(p: torch.Tensor, g: torch.Tensor,
                              shape: Tuple[int, int, int, int],
                              window: Optional[Window] = None) -> torch.Tensor:
    """K2's plain version: scatter-add w_k * g of the points the slab owns
    into the 8 corner rows of the grid (or slab) of ``shape``.  A clamped
    +1 corner has weight exactly 0, so it adds nothing anywhere."""
    nx, ny, nz, C = shape
    i0, i1, frac, _, own = _slab_corners(shape, window, p)
    weights, _ = _corner_weights(frac)
    if own is not None:
        g = torch.where(own[:, None], g, torch.zeros_like(g))
    out = torch.zeros((nx * ny * nz, C), dtype=g.dtype, device=g.device)
    for r, w in zip(_corner_rows(shape, i0, i1), weights):
        out.index_add_(0, r, w[:, None] * g)
    return out.reshape(shape)


def trilinear_bwd_dp_plain(grid: torch.Tensor, p: torch.Tensor,
                           g: torch.Tensor,
                           window: Optional[Window] = None) -> torch.Tensor:
    """K3's plain version: dp = sum_k (g . c_k) * dw_k/dfrac * du/dp, over
    the points the slab owns (0 elsewhere)."""
    C = grid.shape[-1]
    i0, i1, frac, dudp, own = _slab_corners(grid.shape, window, p)
    _, dweights = _corner_weights(frac)
    flat = grid.reshape(-1, C)
    gdotc = [torch.sum(flat.index_select(0, r) * g, dim=-1)
             for r in _corner_rows(grid.shape, i0, i1)]
    df = [sum(gc * dw[a] for gc, dw in zip(gdotc, dweights)) for a in range(3)]
    dp = torch.stack(df, dim=-1) * dudp
    if own is not None:
        dp = torch.where(own[:, None], dp, torch.zeros_like(dp))
    return dp


def _each(windows: Optional[Sequence[Window]], n: int) -> Sequence:
    return [None] * n if windows is None else windows


def trilinear_fwd_multi_plain(grids: Sequence[torch.Tensor], p: torch.Tensor,
                              windows: Optional[Sequence[Window]] = None
                              ) -> List[torch.Tensor]:
    """K1's plain version over several grids: one lookup per grid."""
    return [trilinear_fwd_plain(grid, p, w)
            for grid, w in zip(grids, _each(windows, len(grids)))]


def trilinear_bwd_dgrid_multi_plain(p: torch.Tensor, gs: Sequence[torch.Tensor],
                                    shapes: Sequence[Tuple[int, int, int, int]],
                                    windows: Optional[Sequence[Window]] = None
                                    ) -> List[torch.Tensor]:
    """K2's plain version over several grids: one gradient per grid."""
    return [trilinear_bwd_dgrid_plain(p, g, s, w)
            for g, s, w in zip(gs, shapes, _each(windows, len(gs)))]


def trilinear_bwd_dp_multi_plain(grids: Sequence[torch.Tensor], p: torch.Tensor,
                                 gs: Sequence[torch.Tensor],
                                 windows: Optional[Sequence[Window]] = None
                                 ) -> torch.Tensor:
    """K3's plain version over several grids: the sum of their dp."""
    ws = _each(windows, len(grids))
    dp = trilinear_bwd_dp_plain(grids[0], p, gs[0], ws[0])
    for grid, g, w in zip(grids[1:], gs[1:], ws[1:]):
        dp = dp + trilinear_bwd_dp_plain(grid, p, g, w)
    return dp


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, ndim: int,
           device: Optional[torch.device] = None) -> None:
    if not t.is_cuda or (device is not None and t.device != device):
        raise ValueError(f"{name} must lie on the points' CUDA device "
                         f"{device}, not {t.device}")
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
        _check("grad_output", g, 2, p.device)
        n, _, _, _, c = _check_launch(shape, p)
        if c != C or g.shape != (n, C):
            raise ValueError(f"grad_output must be {(n, C)} for grid {tuple(shape)}, "
                             f"got {tuple(g.shape)}")
    return p.shape[0], C


def _launch(name: str, p: torch.Tensor, desc: List[int], *args) -> None:
    """Launch kernel ``name`` with the per-grid descriptor ``desc`` on the
    points' device and that device's current stream (the CUDA runtime
    launches on its current device, so a slab on another card than the
    current one must switch to it), and count the launch."""
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = getattr(kernels.library("trilinear"), name)(
            (ctypes.c_longlong * len(desc))(*desc), *args, stream)
        kernels.check(rc, name)
    _count(name, stream, p.device.index)


def _desc(a: torch.Tensor, b: torch.Tensor, shape, w: Window) -> List[int]:
    """One grid's descriptor entry: two pointers, the full grid's nx, ny,
    nz, and the slab window."""
    return [a.data_ptr(), b.data_ptr(), w.nx, shape[1], shape[2],
            w.x_lo, w.planes, w.D]


class K1Geometry(NamedTuple):
    """K1's launch: ``ctas`` CTAs of ``threads`` threads over ``items``
    (grid, point, lane) items, at most ``per_thread`` of them a thread:
    thread g walks items g, g + S, g + 2S, ... (S = ctas x threads) where
    ``chunk`` is 0, else CTA b walks its own ``chunk`` items from b x chunk;
    ``slots``: the CTAs the card holds at once; ``rounds``: of them the
    launch takes."""

    ctas: int
    threads: int
    items: int
    per_thread: int
    chunk: int
    slots: int
    rounds: int


def k1_geometry(n: int, count: int, L: int, sms: int, ctas_per_sm: int) -> K1Geometry:
    """K1's launch geometry, a function of these numbers alone: one item
    per (grid, point, float4 of channels), and one CTA per K1_THREADS
    items, but no more than the card holds at once (``sms`` x
    ``ctas_per_sm``), so the launch is one round of resident CTAs
    (tracking's 9,600 points x 3 grids x 8 lanes: 900 CTAs of one item a
    thread at 8 CTAs a SM on 132 SMs, 660 CTAs of 1-2 at 5).  Their
    threads walk the rest with a grid stride, or, from K1_CHUNK_FROM items
    a thread on (a mesh or render chunk), each CTA walks a contiguous
    chunk of them, so the rows the previous rays or lattice rows read are
    still in its SM's L1."""
    items = count * n * L
    slots = sms * ctas_per_sm
    ctas = max(1, min(-(-items // K1_THREADS), slots))
    per_thread = -(-items // (ctas * K1_THREADS))
    return K1Geometry(ctas=ctas, threads=K1_THREADS, items=items, per_thread=per_thread,
                      chunk=per_thread * K1_THREADS if per_thread >= K1_CHUNK_FROM else 0,
                      slots=slots, rounds=-(-ctas // slots))


def k1_kernel_info(c: int, device: torch.device) -> Dict[str, int]:
    """K1's compiled resources at ``c`` channels, read with
    cudaFuncGetAttributes and the occupancy API (trilinear.cu's
    trilinear_fwd_info): registers, local (spill) bytes, threads and
    resident CTAs per SM."""
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        rc = kernels.library("trilinear").trilinear_fwd_info(c, out)
    kernels.check(rc, "trilinear_fwd_info")
    return dict(zip(("registers", "local_bytes", "threads", "ctas_per_sm"), out))


@functools.lru_cache(maxsize=4096)
def _k1_launch(index: Optional[int], n: int, count: int, c: int) -> K1Geometry:
    dev = torch.device("cuda", index)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return k1_geometry(n, count, c // 4, sms, k1_kernel_info(c, dev)["ctas_per_sm"])


def k1_launch_geometry(n: int, count: int, c: int, device: torch.device) -> K1Geometry:
    """``k1_geometry`` of a K1 launch of ``count`` grids of ``c`` channels
    at ``n`` points on ``device``, worked out once per such launch: the
    main path repeats a few launch shapes, and each K1 call then costs
    one cache lookup."""
    return _k1_launch(device.index, n, count, c)


def trilinear_fwd_multi(grids: Sequence[torch.Tensor], p: torch.Tensor,
                        windows: Optional[Sequence[Window]] = None
                        ) -> List[torch.Tensor]:
    """K1: up to MAX_GRIDS channels-last (Nx, Ny, Nz, C) grids (or slabs
    with their ``windows``) of one C looked up at the same (N, 3) points,
    in one launch -> one (N, C) feature per grid."""
    if not grids[0].is_cuda:
        return trilinear_fwd_multi_plain(grids, p, windows)
    if not 1 <= len(grids) <= MAX_GRIDS:
        raise ValueError(f"one launch takes 1..{MAX_GRIDS} grids, got {len(grids)}")
    _check("points", p, 2)
    C = grids[0].shape[-1]
    for grid in grids:
        _check("grid", grid, 4, p.device)
        if _check_launch(grid.shape, p)[4] != C:
            raise ValueError("the grids of one launch must share their channel "
                             f"count, got {[tuple(g.shape) for g in grids]}")
    ws = _windows([g.shape[0] for g in grids], windows)
    n = p.shape[0]
    if len(grids) * n * (C // 4) >= 2 ** 31:
        raise ValueError("problem too large for 32-bit launch indices")
    outs = [torch.empty((n, C), dtype=torch.float32, device=p.device) for _ in grids]
    if n:
        desc = []
        for grid, out, w in zip(grids, outs, ws):
            desc += _desc(grid, out, grid.shape, w)
        geom = k1_launch_geometry(n, len(grids), C, p.device)
        _launch("trilinear_fwd", p, desc, len(grids), p.data_ptr(), n, C, geom.ctas,
                geom.chunk)
    return outs


def trilinear_fwd(grid: torch.Tensor, p: torch.Tensor,
                  window: Optional[Window] = None) -> torch.Tensor:
    """K1 for one grid: (Nx, Ny, Nz, C) grid, (N, 3) points -> (N, C)."""
    return trilinear_fwd_multi([grid], p, None if window is None else [window])[0]


def trilinear_bwd_dgrid_multi(p: torch.Tensor, gs: Sequence[torch.Tensor],
                              shapes: Sequence[Tuple[int, int, int, int]],
                              windows: Optional[Sequence[Window]] = None
                              ) -> List[torch.Tensor]:
    """K2: the gradients of up to MAX_GRIDS grids (or slabs of ``shapes``
    with their ``windows``) looked up at the same points, in one launch;
    each a zeroed float32 grid accumulated by atomics (views of one
    buffer, zeroed by one memset)."""
    if not gs[0].is_cuda:
        return trilinear_bwd_dgrid_multi_plain(p, gs, shapes, windows)
    n, C = _check_grads(p, gs, shapes)
    ws = _windows([s[0] for s in shapes], windows)
    sizes = [s[0] * s[1] * s[2] * C for s in shapes]
    flat = torch.zeros(sum(sizes), dtype=torch.float32, device=p.device)
    outs = [o.view(s) for o, s in zip(torch.split(flat, sizes), shapes)]
    if n:
        desc = []
        for g, o, s, w in zip(gs, outs, shapes, ws):
            desc += _desc(g, o, s, w)
        _launch("trilinear_bwd_dgrid", p, desc, len(gs), p.data_ptr(), n, C)
    return outs


def trilinear_bwd_dp_multi(grids: Sequence[torch.Tensor], p: torch.Tensor,
                           gs: Sequence[torch.Tensor],
                           windows: Optional[Sequence[Window]] = None
                           ) -> torch.Tensor:
    """K3: the point gradient (N, 3), summed over up to MAX_GRIDS grids (or
    slabs with their ``windows``) looked up at the same points, in one
    launch."""
    if not grids[0].is_cuda:
        return trilinear_bwd_dp_multi_plain(grids, p, gs, windows)
    n, C = _check_grads(p, gs, [tuple(grid.shape) for grid in grids])
    for grid in grids:
        _check("grid", grid, 4, p.device)
    ws = _windows([g.shape[0] for g in grids], windows)
    dp = torch.empty((n, 3), dtype=torch.float32, device=p.device)
    if n:
        desc = []
        for grid, g, w in zip(grids, gs, ws):
            desc += _desc(grid, g, grid.shape, w)
        _launch("trilinear_bwd_dp", p, desc, len(grids), p.data_ptr(),
                dp.data_ptr(), n, C)
    return dp


def trilinear_bwd_dgrid(p: torch.Tensor, g: torch.Tensor,
                        shape: Tuple[int, int, int, int],
                        window: Optional[Window] = None) -> torch.Tensor:
    """K2 for one grid."""
    return trilinear_bwd_dgrid_multi(p, [g], [shape],
                                     None if window is None else [window])[0]


def trilinear_bwd_dp(grid: torch.Tensor, p: torch.Tensor, g: torch.Tensor,
                     window: Optional[Window] = None) -> torch.Tensor:
    """K3 for one grid: the point gradient (N, 3)."""
    return trilinear_bwd_dp_multi([grid], p, [g],
                                  None if window is None else [window])


class _Trilinear(torch.autograd.Function):
    """Lookups of several grids (or slabs, with their windows; None: dense)
    at the same points: forward one K1 over the grids; backward one K2 over
    the grids that need a gradient and one K3 summing dp over the grids
    whose feature has a cotangent."""

    @staticmethod
    def forward(ctx, p, windows, *grids):
        ctx.set_materialize_grads(False)
        p = p.contiguous()
        grids = tuple(grid.contiguous() for grid in grids)
        ctx.save_for_backward(p, *grids)
        ctx.windows = windows
        # a dense lookup calls the wrappers with their dense signatures
        extra = () if windows is None else (windows,)
        return tuple(trilinear_fwd_multi(grids, p, *extra))

    @staticmethod
    def backward(ctx, *gs):
        p, *grids = ctx.saved_tensors
        ws = ctx.windows

        def extra(idx):  # the windows of the grids ``idx``, if any
            return () if ws is None else ([ws[i] for i in idx],)

        live = [i for i, g in enumerate(gs) if g is not None]
        gs = [None if g is None else g.contiguous() for g in gs]
        dgrids = [None] * len(grids)
        want = [i for i in live if ctx.needs_input_grad[2 + i]]
        if want:
            outs = trilinear_bwd_dgrid_multi(
                p, [gs[i] for i in want], [tuple(grids[i].shape) for i in want],
                *extra(want))
            for i, o in zip(want, outs):
                dgrids[i] = o
        dp = None
        if ctx.needs_input_grad[0] and live:
            dp = trilinear_bwd_dp_multi([grids[i] for i in live], p,
                                        [gs[i] for i in live], *extra(live))
        return (dp, None, *dgrids)


def trilinear_interp_multi(grids: Sequence[torch.Tensor], p_nor: torch.Tensor,
                           windows: Optional[Sequence[Window]] = None
                           ) -> List[torch.Tensor]:
    """Trilinearly interpolate each channels-last grid (or slab, with its
    window) at the same (N, 3) points in [-1, 1] -> one (N, C) feature per
    grid, differentiable in the grids and the points."""
    return list(_Trilinear.apply(p_nor, windows, *grids))


def trilinear_interp(grid: torch.Tensor, p_nor: torch.Tensor) -> torch.Tensor:
    """The one-grid lookup: (N, 3) points in [-1, 1] -> (N, C)."""
    return _Trilinear.apply(p_nor, None, grid)[0]


def _sharded(grids) -> bool:
    return any(hasattr(g, "slabs") for g in grids)


def sample_grid_features(grids: Sequence, p_world: torch.Tensor,
                         bound: torch.Tensor) -> List[torch.Tensor]:
    """World-space (N, 3) points -> the features of each grid spanning the
    (3, 2) box ``bound``: dense grids in one launch, spatially sharded
    ones (``ShardedGrid``) in one launch per device."""
    p_nor = normalize_3d_coordinate(p_world, bound)
    if _sharded(grids):
        from nice_slam_torch.parallel.grid_sharding import sharded_trilinear_interp_multi

        return sharded_trilinear_interp_multi(grids, p_nor)
    return trilinear_interp_multi(grids, p_nor)


def sample_grid_feature(grid, p_world: torch.Tensor,
                        bound: torch.Tensor) -> torch.Tensor:
    """World-space (N, 3) points -> features of the grid (dense or
    sharded) spanning the (3, 2) box ``bound``."""
    return sample_grid_features([grid], p_world, bound)[0]


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
