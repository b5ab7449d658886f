"""The port's CUDA kernels on the card: each held against its plain
PyTorch version, the wrappers' argument checks, and the launch counts of
a tiny strict-loop run.  Every test here needs an NVIDIA GPU and nvcc and
skips elsewhere; ``python3 chip_smoke.py`` runs the same checks at full
width.

Tolerances: K1 and K3 gather the same corner rows and differ from the
plain versions only by fused multiply-adds and the order of the 32-channel
dot product (atol 1e-5 on unit-scale grids; K3 relative 1e-4 of max |dp|).
K2 sums runs of points in registers (or a block's shared memory) and then
with float32 atomics, in an order that changes from run to run, so it is
held to 32 ulps of the largest per-cell sum of |w_k * g| (the new tests
against the plain version summed in float64, which is exact to float32
rounding).
"""

import argparse
import contextlib
import os
import time

import numpy as np
import pytest
import torch

from nice_slam_torch.ops import interp

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _case(dev, shape, n, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    grid = torch.randn(shape, generator=g).to(dev)
    p = (torch.rand((n, 3), generator=g) * 3.2 - 1.6)
    p[:6] = torch.tensor([[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0], [2.0, 0.0, 0.0],
                          [0.0, -3.0, 1.0], [1.0, 0.3, -0.2], [-1.0, 0.5, 1.0]])
    cot = torch.randn((n, shape[3]), generator=g).to(dev)
    return grid, p.to(dev), cot


@pytest.mark.parametrize("shape,n", [((74, 56, 43, 32), 48000),
                                     ((11, 8, 7, 32), 9600),
                                     ((6, 9, 7, 8), 333)])
def test_kernels_match_plain(dev, shape, n):
    grid, p, cot = _case(dev, shape, n)
    out = interp.trilinear_fwd(grid, p)
    torch.testing.assert_close(out, interp.trilinear_fwd_plain(grid, p),
                               atol=1e-5, rtol=0)
    dp = interp.trilinear_bwd_dp(grid, p, cot)
    ref = interp.trilinear_bwd_dp_plain(grid, p, cot)
    assert float((dp - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    dg = interp.trilinear_bwd_dgrid(p, cot, tuple(shape))
    ref = interp.trilinear_bwd_dgrid_plain(p, cot, tuple(shape))
    scale = interp.trilinear_bwd_dgrid_plain(p, cot.abs(), tuple(shape))
    tol = 32 * torch.finfo(torch.float32).eps * float(scale.max())
    assert float((dg - ref).abs().max()) <= tol
    torch.cuda.synchronize()


def _ray_samples(n_rays, seed=0):
    """Normalized points shaped like the renderer's: per ray 32 stratified
    samples to 1.2 x its depth and 16 within +-5 % of it, sorted by depth,
    so neighbouring points share a cell."""
    g = torch.Generator().manual_seed(seed)
    o = torch.rand((n_rays, 1, 3), generator=g) - 0.5
    d = torch.nn.functional.normalize(torch.randn((n_rays, 1, 3), generator=g), dim=-1)
    depth = 0.3 + torch.rand((n_rays, 1), generator=g)
    t = torch.linspace(0.0, 1.0, 32)[None] * 1.2 * depth
    s = depth * (0.95 + 0.1 * torch.linspace(0.0, 1.0, 16)[None])
    z = torch.sort(torch.cat([t, s], dim=1), dim=1).values
    return (o + d * z[..., None]).reshape(-1, 3).contiguous()


def _dgrid_err_tol(dg, p, cot, shape):
    """K2's error against its plain version with the same float32 weights
    and products summed in float64 (exact to f32 rounding), and 32 f32 ulps
    of the largest per-cell sum of |w_k g|."""
    i0, i1, frac, _ = interp._corners(shape, p)
    weights, _ = interp._corner_weights(frac)
    ref = torch.zeros((2, shape[0] * shape[1] * shape[2], shape[3]),
                      dtype=torch.float64, device=p.device)
    for r, w in zip(interp._corner_rows(shape, i0, i1), weights):
        c = (w[:, None] * cot).double()
        ref[0].index_add_(0, r, c)
        ref[1].index_add_(0, r, c.abs())
    return (float((dg.double().reshape(ref[0].shape) - ref[0]).abs().max()),
            32 * torch.finfo(torch.float32).eps * float(ref[1].max()))


@pytest.mark.parametrize("shapes,shared", [
    ([(11, 8, 7, 32)], [True]),
    ([(37, 28, 21, 32), (74, 56, 43, 32), (74, 56, 43, 32)], [False] * 3),
    ([(11, 8, 7, 32), (20, 18, 16, 32)], [True, False]),
    ([(6, 9, 7, 8), (40, 40, 40, 8)], [True, False]),  # C = 8: 2 teams a warp
], ids=["coarse_shared", "color_stage", "mixed", "c8"])
def test_multi_grid_k2_k3_match_plain_on_ray_samples(dev, shapes, shared):
    """Below the shared-memory threshold K2 privatizes per block; above it
    it flushes register runs straight to the global gradient."""
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    assert shared == [4 * s[0] * s[1] * s[2] * s[3] <= limit for s in shapes]
    p = _ray_samples(1000).to(dev)
    gen = torch.Generator().manual_seed(1)
    grids = [torch.randn(s, generator=gen).to(dev) for s in shapes]
    cots = [torch.randn((p.shape[0], s[3]), generator=gen).to(dev) for s in shapes]
    interp.reset_launch_counts()
    dgs = interp.trilinear_bwd_dgrid_multi(p, cots, shapes)
    dp = interp.trilinear_bwd_dp_multi(grids, p, cots)
    torch.cuda.synchronize()
    assert interp.launch_counts == {"trilinear_fwd": 0, "trilinear_bwd_dgrid": 1,
                                    "trilinear_bwd_dp": 1}
    for dg, cot, s in zip(dgs, cots, shapes):
        err, tol = _dgrid_err_tol(dg, p, cot, s)
        assert err <= tol, (s, err, tol)
    ref = interp.trilinear_bwd_dp_multi_plain(grids, p, cots)
    assert float((dp - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def _k1_held(grids, p):
    """One multi-K1 launch against its plain version at K1's 1e-5."""
    interp.reset_launch_counts()
    feats = interp.trilinear_fwd_multi(grids, p)
    torch.cuda.synchronize()
    assert interp.launch_counts["trilinear_fwd"] == (1 if p.shape[0] else 0)
    ref = interp.trilinear_fwd_multi_plain(grids, p)
    assert len(feats) == len(ref) == len(grids)
    for f, r in zip(feats, ref):
        assert f.shape == r.shape == (p.shape[0], grids[0].shape[3])
        torch.testing.assert_close(f, r, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shapes", [
    [(74, 56, 43, 32)],
    [(37, 28, 21, 32), (74, 56, 43, 32)],
    [(37, 28, 21, 32), (74, 56, 43, 32), (74, 56, 43, 32)],  # color stage
    [(11, 8, 7, 32), (20, 18, 16, 32), (11, 8, 7, 32)],      # 3rd shaped like the 1st
    [(6, 9, 7, 8), (40, 40, 40, 8)],                         # C = 8: 16 points a warp
    [(9, 8, 7, 128)],                                        # C = 128: 1 point a warp
], ids=["fine", "middle_fine", "color_stage", "aba", "c8", "c128"])
@pytest.mark.parametrize("n_rays", [200, 1000], ids=["track", "map"])
def test_multi_k1_matches_plain_on_ray_samples(dev, shapes, n_rays):
    """Ray-ordered samples (consecutive points share cells) at the
    tracking and mapping sizes."""
    gen = torch.Generator().manual_seed(4)
    grids = [torch.randn(s, generator=gen).to(dev) for s in shapes]
    _k1_held(grids, _ray_samples(n_rays, seed=5).to(dev))


@pytest.mark.parametrize("n", [1, 31, 33, 65, 257, 9601, 48001])
def test_k1_runs_crossing_warp_boundaries(dev, n):
    """Every point in one cell of the coarse grid (a run of one cell that
    every warp and block boundary cuts), or in a few cells in stretches of
    20 points; n not a multiple of a warp's or a block's points."""
    gen = torch.Generator().manual_seed(n)
    grids = [torch.randn((11, 8, 7, 32), generator=gen).to(dev),
             torch.randn((74, 56, 43, 32), generator=gen).to(dev)]
    one_cell = 0.05 + 0.01 * torch.rand((n, 3), generator=gen)
    _k1_held(grids, one_cell.to(dev))
    stretches = torch.repeat_interleave(torch.rand((n // 20 + 1, 3), generator=gen) * 2 - 1,
                                        20, dim=0)[:n]
    _k1_held(grids, stretches.contiguous().to(dev))


def test_k1_points_alternating_between_cells(dev):
    """A, B, A, B, ...: every point changes cell, including into the
    border-clamped corner cells and exact ties on grid nodes."""
    gen = torch.Generator().manual_seed(6)
    grids = [torch.randn(s, generator=gen).to(dev)
             for s in ((37, 28, 21, 32), (74, 56, 43, 32), (74, 56, 43, 32))]
    cells = torch.tensor([[0.1, -0.2, 0.3], [1.0, 1.0, 1.0], [-0.7, 0.4, 0.05],
                          [-1.0, -1.0, -1.0], [2.0, -3.0, 1.5], [0.0, 0.0, 0.0]])
    for a in range(len(cells)):
        for b in range(a + 1, len(cells)):
            p = cells[[a, b]].repeat(777, 1)
            _k1_held(grids, p.contiguous().to(dev))


def test_k1_no_points(dev):
    grids = [torch.randn((5, 6, 7, 32), device=dev), torch.randn((8, 8, 8, 32), device=dev)]
    _k1_held(grids, torch.zeros((0, 3), device=dev))


def test_k1_wrapper_rejects_too_many_grids_or_mixed_channels(dev):
    p = torch.rand((10, 3), device=dev)
    grid = torch.randn((5, 5, 5, 32), device=dev)
    with pytest.raises(ValueError):
        interp.trilinear_fwd_multi([grid] * (interp.MAX_GRIDS + 1), p)
    with pytest.raises(ValueError):
        interp.trilinear_fwd_multi([grid, torch.randn((5, 5, 5, 16), device=dev)], p)
    with pytest.raises(ValueError):
        interp.trilinear_fwd_multi([grid, grid.cpu()], p)


K1_SHAPES = {
    "one": [(11, 8, 7, 32)],
    "two": [(37, 28, 21, 32), (74, 56, 43, 32)],
    "color_stage": [(37, 28, 21, 32), (74, 56, 43, 32), (74, 56, 43, 32)],
    "c8_three": [(6, 9, 7, 8), (40, 40, 40, 8), (5, 5, 5, 8)],
    "c128_two": [(9, 8, 7, 128), (4, 4, 4, 128)],
}


def _k1_n(dev, shapes, size):
    """A point count for K1's card-sized launch (``interp.k1_geometry``):
    one point, fewer than a warp, exactly the items of one round of
    resident CTAs, past it with a ragged tail, several rounds' worth, or
    enough that each CTA walks its own chunk (past K1_CHUNK_FROM items a
    thread, with a ragged last chunk)."""
    count, C = len(shapes), shapes[0][3]
    if size == "one_point":
        return 1
    if size == "below_warp":
        return 3
    slots = interp.k1_launch_geometry(1, count, C, dev).slots
    round_n = slots * interp.K1_THREADS // (count * (C // 4))
    return {"one_round": round_n, "ragged": round_n + 7, "past_round": 3 * round_n + 101,
            "chunked": 20 * round_n + 13}[size]


def _k1_points(n, pattern, gen):
    """n points: ray samples, runs of 20 in one cell, or pairs of cells in
    turn (into the border-clamped corners and onto exact nodes)."""
    if pattern == "rays":
        return _ray_samples(n // 48 + 1)[:n].contiguous()
    if pattern == "runs":
        cells = torch.rand((n // 20 + 1, 3), generator=gen) * 2.4 - 1.2
        return torch.repeat_interleave(cells, 20, dim=0)[:n].contiguous()
    cells = torch.tensor([[0.1, -0.2, 0.3], [1.0, 1.0, 1.0], [-1.0, -1.0, -1.0],
                          [2.0, -3.0, 1.5], [0.0, 0.0, 0.0]])
    return cells[torch.arange(n) % len(cells)].contiguous()


@pytest.mark.parametrize("pattern", ["rays", "runs", "alternating"])
@pytest.mark.parametrize("size", ["one_point", "below_warp", "one_round", "ragged",
                                  "past_round", "chunked"])
@pytest.mark.parametrize("shapes", list(K1_SHAPES.values()), ids=list(K1_SHAPES))
def test_k1_grid_stride_matches_plain(dev, shapes, size, pattern):
    """K1's launch is one round of resident CTAs whose threads walk the
    rest with a grid stride, or each CTA its own chunk: held against its
    plain version at 1e-5 where a thread takes one item, exactly one
    round's, a round's and a ragged tail, several, and a chunk walk with a
    ragged last chunk; 1-3 grids of mixed shapes; C = 8, 32, 128."""
    n = _k1_n(dev, shapes, size)
    geom = interp.k1_launch_geometry(n, len(shapes), shapes[0][3], dev)
    assert geom.rounds == 1 and geom.ctas <= geom.items
    assert (geom.per_thread > 1) == (size in ("ragged", "past_round", "chunked"))
    assert (geom.chunk > 0) == (size == "chunked")
    gen = torch.Generator().manual_seed(n)
    grids = [torch.randn(s, generator=gen).to(dev) for s in shapes]
    _k1_held(grids, _k1_points(n, pattern, gen).to(dev))


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("size", ["one_point", "below_warp", "past_round", "chunked"])
@pytest.mark.parametrize("shapes", [K1_SHAPES["color_stage"], K1_SHAPES["one"]],
                         ids=["color_stage", "coarse"])
def test_k1_slabs_sum_to_dense_k1_bit_for_bit(dev, shapes, size, D):
    """K1 over the D slabs of each grid (one launch per slab), each against
    its plain version at 1e-5, summed to the dense K1 bit for bit, from
    one point to several rounds of resident CTAs and a chunk walk."""
    from nice_slam_torch.parallel import grid_sharding as gs

    n = _k1_n(dev, shapes, size)
    geom = interp.k1_launch_geometry(n, len(shapes), shapes[0][3], dev)
    assert (geom.chunk > 0) == (size == "chunked")
    gen = torch.Generator().manual_seed(D * n)
    grids = [torch.randn(s, generator=gen).to(dev) for s in shapes]
    p = _k1_points(n, "rays", gen).to(dev)
    sharded = [gs.shard_grid(g, [dev] * D) for g in grids]
    feats = None
    for d in range(D):
        slabs = [sg.slabs[d] for sg in sharded]
        ws = [sg.window(d) for sg in sharded]
        f = interp.trilinear_fwd_multi(slabs, p, ws)
        for a, b in zip(f, interp.trilinear_fwd_multi_plain(slabs, p, ws)):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
        feats = f if feats is None else [a + b for a, b in zip(feats, f)]
    for a, b in zip(feats, interp.trilinear_fwd_multi(grids, p)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("C", [4, 8, 16, 32, 64, 128])
def test_k1_resources(dev, C):
    """K1 uses no local memory, and its resident CTAs fit the SM's
    registers (trilinear_fwd_info)."""
    info = interp.k1_kernel_info(C, dev)
    assert info["local_bytes"] == 0, info
    assert info["threads"] == interp.K1_THREADS and info["ctas_per_sm"] >= 1, info
    assert info["registers"] * info["threads"] * info["ctas_per_sm"] <= 65536, info


def test_multi_function_on_cuda_matches_cpu(dev):
    shapes = [(11, 8, 7, 16), (13, 9, 30, 16), (7, 7, 7, 16)]
    gen = torch.Generator().manual_seed(2)
    grids = [torch.randn(s, generator=gen) for s in shapes]
    p = _ray_samples(40, seed=3)
    cots = [torch.randn((p.shape[0], 16), generator=gen) for _ in shapes]
    out = {}
    for where in ("cpu", dev):
        gl = [g.to(where).detach().requires_grad_(True) for g in grids]
        pl = p.to(where).detach().requires_grad_(True)
        feats = interp.trilinear_interp_multi(gl, pl)
        sum((f * c.to(where)).sum() for f, c in zip(feats, cots)).backward()
        out[str(where)] = ([f.detach().cpu() for f in feats],
                           [g.grad.cpu() for g in gl], pl.grad.cpu())
    (fc, gc, pc), (fd, gd, pd) = out["cpu"], out[str(dev)]
    for a, b in zip(fd, fc):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    for a, b, cot, s in zip(gd, gc, cots, shapes):
        err, tol = _dgrid_err_tol(a, p, cot, s)
        assert err <= tol, (s, err, tol)
        torch.testing.assert_close(a, b, atol=2 * tol, rtol=0)
    torch.testing.assert_close(pd, pc, atol=1e-4, rtol=1e-4)


def test_tracking_iteration_launches_k3_once(dev):
    from nice_slam_torch.config import load_config
    from nice_slam_torch.models.pretrain import load_pretrain
    from nice_slam_torch.models.scene import build_scene
    from nice_slam_torch.ops.geometry import tensor_from_pose
    from nice_slam_torch.ops.render import RenderConfig
    from nice_slam_torch.slam import tracker
    from nice_slam_torch.utils.datasets import Synthetic

    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "nice_slam.yaml"))
    for k in ("coarse", "middle_fine"):
        cfg["pretrained_decoders"][k] = os.path.join(
            ROOT, cfg["pretrained_decoders"][k])
    spec, state = build_scene(cfg, device=dev)
    state = load_pretrain(cfg, spec, state, verbose=False)
    tcfg = tracker.TrackerConfig.from_cfg(cfg, cfg["cam"], True)
    _, color, depth, c2w = Synthetic(cfg)[1]
    pix = [torch.tensor(a[0], device=dev) for a in
           tracker.presample_pixels(0, 1, tcfg, color, depth)]
    cam = tensor_from_pose(torch.tensor(c2w, device=dev)).requires_grad_(True)
    interp.reset_launch_counts()
    loss = tracker.tracking_loss_sampled(spec, state, cam, *pix, tcfg,
                                         RenderConfig.from_cfg(cfg))
    torch.autograd.grad(loss, cam)
    torch.cuda.synchronize()
    # one lookup of the stage's three grids: one K1, and one K3 back
    assert interp.launch_counts == {"trilinear_fwd": 1, "trilinear_bwd_dgrid": 0,
                                    "trilinear_bwd_dp": 1}


def test_autograd_function_on_cuda(dev):
    grid, p, cot = _case(dev, (9, 8, 7, 16), 500)
    gl = grid.clone().requires_grad_(True)
    pl = p.clone().requires_grad_(True)
    (interp.trilinear_interp(gl, pl) * cot).sum().backward()
    gc = grid.cpu().requires_grad_(True)
    pc = p.cpu().requires_grad_(True)
    (interp.trilinear_interp(gc, pc) * cot.cpu()).sum().backward()
    torch.testing.assert_close(gl.grad.cpu(), gc.grad, atol=1e-5, rtol=0)
    torch.testing.assert_close(pl.grad.cpu(), pc.grad, atol=1e-4, rtol=1e-4)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    grid, p, cot = _case(dev, (5, 5, 5, 8), 10)
    with pytest.raises(TypeError):
        interp.trilinear_fwd(grid.double(), p.double())
    with pytest.raises(ValueError):
        interp.trilinear_fwd(grid, p.cpu())
    with pytest.raises(ValueError):
        interp.trilinear_fwd(grid, p.t().contiguous().t())
    with pytest.raises(ValueError):
        interp.trilinear_fwd(torch.zeros((5, 5, 5, 6), device=dev), p)
    with pytest.raises(ValueError):
        interp.trilinear_bwd_dgrid(p, cot[:5], (5, 5, 5, 8))


def test_tiny_strict_loop_launches_every_kernel(dev, tmp_path):
    from nice_slam_torch.config import load_config
    from nice_slam_torch.slam.slam import NiceSLAM

    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "nice_slam.yaml"))
    cfg.update(coarse=True, verbose=False)
    for k in ("coarse", "middle_fine"):
        cfg["pretrained_decoders"][k] = os.path.join(
            ROOT, cfg["pretrained_decoders"][k])
    cfg["data"].update({"n_frames": 6, "output": str(tmp_path)})
    cfg["mapping"].update({"iters_first": 30, "iters": 10})
    slam = NiceSLAM(cfg, argparse.Namespace(nice=True, output=None), "cuda")
    from nice_slam_torch.ops import decoder_stage as DS

    interp.reset_launch_counts()
    DS.reset_launch_counts()
    slam.run()
    assert all(v > 0 for v in interp.launch_counts.values()), interp.launch_counts
    assert all(v > 0 for v in DS.launch_counts.values()), DS.launch_counts
    # one decoder-stage call per lookup Function
    assert DS.launch_counts["decoder_fwd"] == interp.launch_counts["trilinear_fwd"]
    assert torch.isfinite(slam.estimate_c2w_list).all()


def test_kernels_follow_the_current_stream(dev):
    """Each kernel launched on a side stream right after that stream writes
    its inputs gives its plain version's result.  The side stream first
    spins (``torch.cuda._sleep``), so a kernel launched on any other stream
    would read its inputs before they are written."""
    shape, n = (74, 56, 43, 32), 48000
    host = [t.pin_memory() for t in _case(torch.device("cpu"), shape, n)]
    side = torch.cuda.Stream()
    interp.reset_launch_counts()
    with torch.cuda.stream(side):
        grid, p, cot = (torch.empty_like(t, device=dev) for t in host)
        torch.cuda._sleep(100_000_000)
        for dst, src in zip((grid, p, cot), host):
            dst.copy_(src, non_blocking=True)
        out = interp.trilinear_fwd(grid, p)
        dp = interp.trilinear_bwd_dp(grid, p, cot)
        dg = interp.trilinear_bwd_dgrid(p, cot, shape)
    side.synchronize()
    assert interp.launches_by_stream == {(k, side.cuda_stream): 1
                                         for k in interp.launch_counts}
    torch.testing.assert_close(out, interp.trilinear_fwd_plain(grid, p),
                               atol=1e-5, rtol=0)
    ref = interp.trilinear_bwd_dp_plain(grid, p, cot)
    assert float((dp - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    ref = interp.trilinear_bwd_dgrid_plain(p, cot, shape)
    scale = interp.trilinear_bwd_dgrid_plain(p, cot.abs(), shape)
    tol = 32 * torch.finfo(torch.float32).eps * float(scale.max())
    assert float((dg - ref).abs().max()) <= tol


SPIN_CYCLES = 200_000_000  # ~0.1 s of device time: longer than any host step here


def test_handoff_access_orders_a_read_after_a_write(dev):
    """A write made on stream A inside ``Handoff.access`` is what stream B
    reads inside its own later access, although A's write is still queued
    behind a spin when B's read is issued."""
    from nice_slam_torch.slam.handoff import Handoff

    h = Handoff(dev)
    a, b = torch.cuda.Stream(), torch.cuda.Stream()
    x = torch.zeros(1 << 20, device=dev)
    torch.cuda.synchronize()
    with torch.cuda.stream(a), h.access():
        torch.cuda._sleep(SPIN_CYCLES)
        x.fill_(1.0)
    with torch.cuda.stream(b), h.access():
        seen = x.clone()
    torch.cuda.synchronize()
    assert bool((seen == 1.0).all())


def test_handoff_hold_keeps_a_read_block_from_reuse(dev):
    """A tensor made on stream A and read on stream B after ``hold`` keeps
    its memory until B's read has run: A drops it and allocates the same
    size again at once, writes there, and B still reads the first values."""
    from nice_slam_torch.slam.handoff import Handoff, hold

    h = Handoff(dev)
    a, b = torch.cuda.Stream(), torch.cuda.Stream()
    n = 1 << 20
    torch.cuda.synchronize()
    with torch.cuda.stream(a), h.access():
        state = torch.full((n,), 1.0, device=dev)
    ptr = state.data_ptr()
    with torch.cuda.stream(b), h.access():
        hold([state])
        torch.cuda._sleep(SPIN_CYCLES)
        seen = state.clone()
    with torch.cuda.stream(a):  # the producer's next allocation, no hand-off
        del state
        reused = torch.empty(n, device=dev)
        reused.fill_(2.0)
    torch.cuda.synchronize()
    assert reused.data_ptr() != ptr
    assert bool((seen == 1.0).all())


@pytest.fixture(params=["one_card", "two_cards"])
def card_pair(request, dev):
    """Two entries of a device list: cuda:0 twice, or cuda:0 and cuda:1."""
    if request.param == "one_card":
        return [torch.device("cuda", 0)] * 2
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


def _thread_streams(cards):
    """A thread's streams as the threaded schedules make them: one per
    distinct card."""
    return {c: torch.cuda.Stream(c) for c in set(cards)}


@contextlib.contextmanager
def _on(streams, home):
    """``streams`` current on their cards, ``home``'s card current."""
    with contextlib.ExitStack() as stack:
        for c in sorted(streams, key=lambda c: c == home):
            stack.enter_context(torch.cuda.stream(streams[c]))
        yield


def test_handoff_orders_a_read_after_a_write_across_cards(card_pair):
    """A thread at home on the first card writes there (behind a spin)
    inside ``Handoff.access``; a thread at home on the second card reads
    the value on the first card inside its own later access and copies it
    home.  The read runs on the reader's stream of the first card, which
    the access must order after the writer's event: an access that waited
    on its current card only would read zeros."""
    from nice_slam_torch.slam.handoff import Handoff

    c0, c1 = card_pair
    h = Handoff(card_pair)
    writer, reader = _thread_streams(card_pair), _thread_streams(card_pair)
    x = torch.zeros(1 << 20, device=c0)
    torch.cuda.synchronize(c0)
    with _on(writer, c0), h.access():
        torch.cuda._sleep(SPIN_CYCLES)
        x.fill_(1.0)
    with _on(reader, c1), h.access():
        seen = x.clone().to(c1)
    for c in set(card_pair):
        torch.cuda.synchronize(c)
    assert bool((seen == 1.0).all())


def test_handoff_hold_keeps_a_block_read_from_another_card(card_pair):
    """A block made on the second card by a thread at home there, read by a
    thread at home on the first card after ``hold``, keeps its memory until
    that read has run on the reader's stream of the second card: the
    producer drops it and allocates the same size again at once.  A
    ``hold`` that recorded the reader's current card's stream would free
    the block while the read still waits behind its spin."""
    from nice_slam_torch.slam.handoff import Handoff, hold

    c0, c1 = card_pair
    h = Handoff(card_pair)
    producer, reader = _thread_streams(card_pair), _thread_streams(card_pair)
    n = 1 << 20
    for c in set(card_pair):
        torch.cuda.synchronize(c)
    with _on(producer, c1), h.access():
        state = torch.full((n,), 1.0, device=c1)
    ptr = state.data_ptr()
    with _on(reader, c0), h.access():
        hold([state])
        with torch.cuda.device(c1):
            torch.cuda._sleep(SPIN_CYCLES)
        seen = state.clone()
    time.sleep(0.01)  # a wrongly recorded stream's event has completed by now
    with _on(producer, c1):  # the producer's next allocation, no hand-off
        del state
        reused = torch.empty(n, device=c1)
        reused.fill_(2.0)
    for c in set(card_pair):
        torch.cuda.synchronize(c)
    assert reused.data_ptr() != ptr
    assert bool((seen == 1.0).all())


def test_tiny_loose_loop_launches_on_the_threads_streams(dev, tmp_path):
    """The loose schedule on the card: the warm-up launches on the default
    stream, then K3 only on the tracker's stream and K2 only on the
    mappers' streams."""
    from nice_slam_torch.config import load_config
    from nice_slam_torch.slam.slam import NiceSLAM

    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "nice_slam.yaml"))
    cfg.update(coarse=True, verbose=False, sync_method="loose", meshing=None)
    for k in ("coarse", "middle_fine"):
        cfg["pretrained_decoders"][k] = os.path.join(
            ROOT, cfg["pretrained_decoders"][k])
    cfg["data"].update({"n_frames": 8, "output": str(tmp_path)})
    cfg["mapping"].update({"iters_first": 30, "iters": 10})
    card = torch.device("cuda", 0)
    slam = NiceSLAM(cfg, argparse.Namespace(nice=True, output=None), card)
    interp.reset_launch_counts()
    slam.run()
    assert torch.isfinite(slam.estimate_c2w_list).all()
    assert slam.mapping_idx == 7 and slam.timings["tracked_frames"] == 7
    by = dict(interp.launches_by_stream)
    ids = {name: s[card].cuda_stream for name, s in slam.streams.items()}
    assert sorted(ids) == ["coarse_mapper", "mapper", "tracker"]
    default = torch.cuda.default_stream().cuda_stream
    assert len({*ids.values(), default}) == 4
    assert by[("trilinear_bwd_dp", ids["tracker"])] == 5 * slam.tcfg.iters
    assert by[("trilinear_bwd_dp", default)] == 2 * slam.tcfg.iters
    for name in ("mapper", "coarse_mapper"):
        assert by[("trilinear_bwd_dgrid", ids[name])] > 0
        assert ("trilinear_bwd_dp", ids[name]) not in by
    assert ("trilinear_bwd_dgrid", ids["tracker"]) not in by


@pytest.mark.parametrize("spatial", ["1", "0"], ids=["sharded", "ray_dp"])
def test_tiny_loose_loop_over_a_card_pair(card_pair, spatial, tmp_path, monkeypatch):
    """loose over a card pair, the grids sharded or with ray data
    parallelism and the coarse mapper pinned to the second entry: every
    frame tracked, the last mapped; each thread has a stream on every card
    and launches only there (the warm-up on the default streams); K3 only
    on the tracker's and the warm-up's streams, K2 only on the mappers'
    and the warm-up's; sharded, the tracker launches K3 on every card;
    pinned, the coarse mapper launches K2 on the second card only."""
    from nice_slam_torch.config import load_config
    from nice_slam_torch.slam.slam import NiceSLAM

    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "nice_slam.yaml"))
    cfg.update(coarse=True, verbose=False, sync_method="loose", meshing=None)
    for k in ("coarse", "middle_fine"):
        cfg["pretrained_decoders"][k] = os.path.join(
            ROOT, cfg["pretrained_decoders"][k])
    cfg["data"].update({"n_frames": 8, "output": str(tmp_path)})
    cfg["mapping"].update({"iters_first": 30, "iters": 10})
    monkeypatch.setenv("NICE_SLAM_TORCH_SPATIAL", spatial)
    monkeypatch.setenv("NICE_SLAM_TORCH_COARSE_DEVICE", "1")
    slam = NiceSLAM(cfg, argparse.Namespace(nice=True, output=None), devices=card_pair)
    assert (slam.spatial_devices is not None) == (spatial == "1")
    interp.reset_launch_counts()
    slam.run()
    assert torch.isfinite(slam.estimate_c2w_list).all()
    assert slam.mapping_idx == 7 and slam.timings["tracked_frames"] == 7
    cards = set(card_pair)
    owner = {}  # (device index, stream handle) -> thread
    for c in cards:
        owner[(c.index, torch.cuda.default_stream(c).cuda_stream)] = "MainThread"
    for name, streams in slam.streams.items():
        assert set(streams) == cards, name
        for c, st in streams.items():
            owner[(c.index, st.cuda_stream)] = name
    assert len(owner) == 4 * len(cards)  # no stream shared
    by = {}
    for (k, i, sid), v in interp.launches_by_device.items():
        th = owner[(i, sid)]  # a launch on a stream of no thread fails here
        by[(k, i, th)] = by.get((k, i, th), 0) + v
    assert all(th in ("tracker", "MainThread") for k, _, th in by if k == "trilinear_bwd_dp")
    assert all(th != "tracker" for k, _, th in by if k == "trilinear_bwd_dgrid")
    c0, c1 = card_pair
    if spatial == "1":
        for c in cards:
            assert by[("trilinear_bwd_dp", c.index, "tracker")] > 0
    else:
        assert slam.coarse_mapper.device == c1
        coarse = {i for k, i, th in by if th == "coarse_mapper" and k == "trilinear_bwd_dgrid"}
        assert coarse == {c1.index}


def _lattice_points(res, n):
    """The first ``n`` points of a res^3 mesher lattice over [-1.05, 1.05]^3
    (x slowest, z fastest), normalized like the grid lookup's."""
    g = torch.linspace(-1.05, 1.05, res)
    X, Y, Z = torch.meshgrid(g, g, g, indexing="ij")
    return torch.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)], -1)[:n].contiguous()


@pytest.mark.parametrize("what", ["mesh_lattice", "render_rays"])
def test_k1_matches_plain_at_mesher_and_render_sizes(dev, what):
    """K1 at the new paths' sizes: 500k lattice points over the middle and
    fine grids, and 2M ray samples over the middle, fine and color grids
    (int32 offsets reach 2M x 32 per grid)."""
    g = torch.Generator().manual_seed(11)
    if what == "mesh_lattice":
        shapes = [(37, 28, 21, 32), (74, 56, 43, 32)]
        p = _lattice_points(256, 500_000).to(dev)
    else:
        shapes = [(37, 28, 21, 32), (74, 56, 43, 32), (74, 56, 43, 32)]
        p = _ray_samples(2_000_000 // 48).to(dev)
    grids = [torch.randn(s, generator=g).to(dev) for s in shapes]
    before = interp.launch_counts["trilinear_fwd"]
    out = interp.trilinear_fwd_multi(grids, p)
    assert interp.launch_counts["trilinear_fwd"] == before + 1
    for o, r in zip(out, interp.trilinear_fwd_multi_plain(grids, p)):
        torch.testing.assert_close(o, r, atol=1e-5, rtol=0)


def test_get_mesh_on_cuda_matches_cpu(dev, tmp_path, monkeypatch):
    """One get_mesh at resolution 64 on the card: its occupancy field (the
    marching-cubes input) matches the CPU port's on the same scene at
    1e-4, and the mesh has faces."""
    import numpy as np

    from nice_slam_torch.config import load_config
    from nice_slam_torch.convert import scene_from_jax, scene_to_numpy
    from nice_slam_torch.models.pretrain import load_pretrain
    from nice_slam_torch.models.scene import build_scene
    from nice_slam_torch.slam.keyframes import KeyframeStore
    from nice_slam_torch.utils import mesher as M
    from nice_slam_torch.utils.datasets import Synthetic

    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "nice_slam.yaml"))
    for k in ("coarse", "middle_fine"):
        cfg["pretrained_decoders"][k] = os.path.join(ROOT, cfg["pretrained_decoders"][k])
    cfg["verbose"] = False
    cfg["cam"].update({"H": 48, "W": 64, "fx": 48.0, "fy": 48.0, "cx": 31.5, "cy": 23.5})
    cfg["data"]["n_frames"] = 6
    cfg["meshing"]["resolution"] = 64
    spec, state = build_scene(cfg, device="cpu")
    state = load_pretrain(cfg, spec, state, verbose=False)
    gen = torch.Generator().manual_seed(2)
    state = state._replace(grids={k: 0.3 * torch.randn(v.shape, generator=gen)
                                  for k, v in state.grids.items()})
    ds = Synthetic(cfg)
    est = torch.tensor(np.stack([ds[i][3] for i in range(len(ds))]))
    fields = {}
    real_mc = M.meshlib.marching_cubes

    def keep_field(field, *a, **k):
        fields[len(fields)] = np.array(field)
        return real_mc(field, *a, **k)

    monkeypatch.setattr(M.meshlib, "marching_cubes", keep_field)
    faces = []
    for d in ("cpu", dev):
        st = scene_from_jax(scene_to_numpy(state), d)
        kf = KeyframeStore(4, 48, 64, d)
        for i in (0, 5):
            _, color, depth, c2w = ds[i]
            kf.add(i, color, depth, c2w, c2w)
        mesher = M.Mesher(cfg, dict(cfg["cam"]), spec)
        mesher.get_mesh(str(tmp_path / f"{d}.ply"), st, kf, est.to(d), 5)
        faces.append(mesher.last["faces"])
    assert fields[0].shape == (64, 64, 64)
    np.testing.assert_allclose(fields[1], fields[0], atol=1e-4, rtol=0)
    assert faces[1] > 0


def _imap_scene(H, W, n_frames):
    """An iMAP* scene (random MLP from seed 3) on the CPU, its config at an
    HxW camera, and the box frames at the config's scale."""
    from nice_slam_torch.config import load_config
    from nice_slam_torch.models.scene import build_scene
    from nice_slam_torch.utils.datasets import Synthetic

    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "imap.yaml"))
    cfg["verbose"] = False
    cfg["cam"].update({"H": H, "W": W, "fx": float(H), "fy": float(H),
                       "cx": (W - 1) / 2, "cy": (H - 1) / 2})
    cfg["data"]["n_frames"] = n_frames
    spec, state = build_scene(cfg, nice=False, seed=3, device="cpu")
    ds = Synthetic(cfg, scale=cfg["scale"])
    return cfg, spec, state, [ds[i] for i in range(len(ds))]


def test_imap_render_on_cuda_matches_cpu(dev):
    """The iMAP* render (32 + 12 importance samples, density mode) of 4096
    rays on the card against the CPU port on the same MLP and rays: depth,
    uncertainty and colour within 1e-3 (float32 GEMMs in another order,
    and an importance sample may move by a bin where the CDF ties)."""
    from nice_slam_torch.convert import scene_from_jax, scene_to_numpy
    from nice_slam_torch.ops.geometry import rays_from_uv
    from nice_slam_torch.ops.render import RenderConfig, render_batch_ray

    cfg, spec, state, frames = _imap_scene(48, 64, 4)
    _, _, depth, c2w = frames[2]
    g = torch.Generator().manual_seed(4)
    i = torch.randint(0, 64, (4096,), generator=g).float()
    j = torch.randint(0, 48, (4096,), generator=g).float()
    ro, rd = rays_from_uv(i, j, torch.tensor(c2w), 48.0, 48.0, 31.5, 23.5)
    gt = torch.tensor(depth)[j.long(), i.long()]
    rcfg = RenderConfig.from_cfg(cfg)
    assert rcfg.N_importance == 12 and not rcfg.occupancy
    ref = render_batch_ray(spec, state, ro, rd, "color", gt_depth=gt, rcfg=rcfg)
    on_dev = scene_from_jax(scene_to_numpy(state), dev)
    got = render_batch_ray(spec, on_dev, ro.to(dev), rd.to(dev), "color",
                           gt_depth=gt.to(dev), rcfg=rcfg)
    for a, b in zip(ref, got):
        torch.testing.assert_close(b.cpu(), a, atol=1e-3, rtol=0)


def test_imap_get_mesh_on_cuda_matches_cpu(dev, tmp_path, monkeypatch):
    """One iMAP* get_mesh at resolution 64 on the card against the CPU
    port: the density field (the marching-cubes input) at 1e-4, and the
    vertex colours rendered along the normals within 2 uint8 levels at
    matching vertices.  The random MLP's density lies in about [-1.4, 2.2]
    inside the box, so the level set is 0.3 (the configs' 10 needs a
    trained map)."""
    import numpy as np
    from scipy.spatial import cKDTree

    from nice_slam_torch.convert import scene_from_jax, scene_to_numpy
    from nice_slam_torch.slam.keyframes import KeyframeStore
    from nice_slam_torch.utils import mesher as M

    cfg, spec, state, frames = _imap_scene(48, 64, 6)
    cfg["meshing"].update(resolution=64, level_set=0.3)
    est = torch.tensor(np.stack([f[3] for f in frames]))
    fields = []
    real_mc = M.meshlib.marching_cubes

    def keep_field(field, *a, **k):
        fields.append(np.array(field))
        return real_mc(field, *a, **k)

    monkeypatch.setattr(M.meshlib, "marching_cubes", keep_field)
    meshes = []
    for d in ("cpu", dev):
        st = scene_from_jax(scene_to_numpy(state), d)
        kf = KeyframeStore(4, 48, 64, d)
        for i in (0, 5):
            _, color, depth, c2w = frames[i]
            kf.add(i, color, depth, c2w, c2w)
        path = str(tmp_path / f"{d}.ply")
        M.Mesher(cfg, dict(cfg["cam"]), spec).get_mesh(path, st, kf, est.to(d), 5)
        meshes.append(M.meshlib.read_ply(path))
    assert fields[0].shape == (64, 64, 64)
    np.testing.assert_allclose(fields[1], fields[0], atol=1e-4, rtol=0)
    (cv, cf, cc), (gv, gf, gc) = meshes
    assert len(gf) > 0 and abs(len(gf) - len(cf)) <= 0.01 * len(cf)
    dist, nearest = cKDTree(cv).query(gv)
    b = np.asarray(cfg["mapping"]["marching_cubes_bound"])
    assert dist.max() <= 0.5 * float(np.max(b[:, 1] - b[:, 0] + 1.0)) / 63
    assert np.abs(gc.astype(int) - cc[nearest].astype(int)).max() <= 2


def test_imap_mapping_iterations_on_cuda_match_cpu(dev):
    """Five iMAP* mapping iterations (StepLR, regulariser, importance
    pass) on the card against the CPU port from the same MLP on the same
    pixel and regulariser draws: losses within 1e-4 relative; after the
    Adam steps at least 99.9 % of each decoder leaf's entries within 1e-4
    and every entry within the call's step budget 2 x 5 x lr (Adam moves
    an entry by about lr per step whatever its gradient's size, so an
    entry whose gradient is ~0 on both devices can step either way on
    rounding alone: 2 of 23808 did on an H100)."""
    import numpy as np

    from nice_slam_torch.convert import scene_from_jax, scene_to_numpy
    from nice_slam_torch.ops.geometry import tensor_from_pose
    from nice_slam_torch.ops.render import RenderConfig
    from nice_slam_torch.slam import mapper as M
    from nice_slam_torch.slam.optim import tree_leaves

    cfg, spec, state, frames = _imap_scene(48, 64, 6)
    sel = [frames[i] for i in (0, 2, 4)]
    colors = torch.tensor(np.stack([f[1] for f in sel]))
    depths = torch.tensor(np.stack([f[2] for f in sel]))
    c2w = torch.tensor(np.stack([f[3] for f in sel]))
    mcfg = M.MapperConfig.from_cfg(cfg, cfg["cam"], False)
    rcfg = RenderConfig.from_cfg(cfg)
    F, n, iters = 3, 200, 5
    g = torch.Generator().manual_seed(6)
    pix = torch.randint(0, 48 * 64, (iters, F, n), generator=g)
    reg_t = torch.rand((iters, F * n, rcfg.N_samples), generator=g)
    out = []
    for d in ("cpu", dev):
        st = scene_from_jax(scene_to_numpy(state), d)
        args = [x.to(d) for x in (colors, depths, c2w, tensor_from_pose(c2w),
                                  torch.zeros(F), torch.ones(F, dtype=torch.bool))]
        new, _, losses = M.optimize_map_core(
            spec, st, *args, 1.0, mcfg, rcfg, (("color", iters),), False, n,
            pix_idx=pix.to(d), reg_t=reg_t.to(d))
        out.append((losses.cpu(), [x.cpu() for x in tree_leaves(new.decoders)]))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=1e-4, atol=0)
    budget = 2 * iters * mcfg.imap_decoders_lr
    for a, b in zip(out[0][1], out[1][1]):
        d = (b - a).abs()
        assert float((d <= 1e-4).float().mean()) >= 0.999
        assert float(d.max()) <= budget


@pytest.mark.parametrize("stage", ["coarse", "middle", "fine"])
def test_pretrain_fit_step_on_the_card_matches_the_cpu(dev, stage):
    """The decoder pretrainer's Adam step at the recipe's widths on the
    card against the same step on the CPU (the kernels' plain versions):
    one K1 and one K2 launch per step, no K3; losses within 1e-4
    relative, >= 99.9 % of the parameters within 1e-4 after 3 steps."""
    import numpy as np

    from nice_slam_torch.models import decoders as D
    from nice_slam_torch.models import grids as G
    from nice_slam_torch.slam.optim import GroupAdam, tree_leaves
    from nice_slam_torch.tools import pretrain_decoders as P

    sub = D.NICESpec(c_dim=32, hidden_size=32, coarse=True).sub_specs()[stage]
    rng = np.random.default_rng(0)
    half, boxes, spheres = P.random_scene(rng)
    pts = rng.uniform(-3, 3, size=(3, 4096, 3)).astype(np.float32)
    occ = np.stack([P.occupancy_of(x, half, boxes, spheres) for x in pts])
    runs = {}
    for where in ("cpu", dev):
        dec = P.init_decoders(0, device=where)[stage]
        gen = G.make_generator(1, torch.device("cpu"))
        grids = {k: v.to(where) for k, v in
                 G.init_grids(gen, P.GRID_SHAPES, 32, "cpu").items()}
        grid = grids["grid_" + stage].requires_grad_(True)
        for leaf in tree_leaves(dec):
            leaf.requires_grad_(True)
        opt = GroupAdam({"dec": dec, "grid": grid})
        bound = torch.as_tensor(P.BOUND, device=where)
        interp.reset_launch_counts()
        losses = [float(P.fit_step(dec, grid, grids["grid_middle"], opt,
                                   torch.as_tensor(pts[i], device=where),
                                   torch.as_tensor(occ[i], device=where), bound, sub,
                                   stage == "fine"))
                  for i in range(3)]
        runs[str(where)] = (losses, dict(interp.launch_counts),
                            torch.cat([x.detach().reshape(-1).cpu()
                                       for x in tree_leaves(dec) + [grid]]))
    (l_cpu, n_cpu, p_cpu), (l_dev, n_dev, p_dev) = runs["cpu"], runs[str(dev)]
    assert n_cpu == {"trilinear_fwd": 0, "trilinear_bwd_dgrid": 0, "trilinear_bwd_dp": 0}
    assert n_dev == {"trilinear_fwd": 3, "trilinear_bwd_dgrid": 3, "trilinear_bwd_dp": 0}
    np.testing.assert_allclose(l_dev, l_cpu, rtol=1e-4)
    assert float(((p_dev - p_cpu).abs() <= 1e-4).float().mean()) >= 0.999


def _slab_err_tol(dg, p, cot, shape, window):
    """``_dgrid_err_tol`` for a slab: the plain version with the slab
    window, summed in float64, and 32 ulps of its largest sum of |w_k g|,
    at least the smallest normal float: float atomics flush subnormal
    results to zero (PTX atom.add.f32), and a slab that owns a few points
    may get nothing but subnormal contributions."""
    i0, i1, frac, _, own = interp._slab_corners(shape, window, p)
    weights, _ = interp._corner_weights(frac)
    if own is not None:
        cot = cot * own[:, None]
    ref = torch.zeros((2, shape[0] * shape[1] * shape[2], shape[3]),
                      dtype=torch.float64, device=p.device)
    for r, w in zip(interp._corner_rows(shape, i0, i1), weights):
        c = (w[:, None] * cot).double()
        ref[0].index_add_(0, r, c)
        ref[1].index_add_(0, r, c.abs())
    f32 = torch.finfo(torch.float32)
    return (float((dg.double().reshape(ref[0].shape) - ref[0]).abs().max()),
            max(32 * f32.eps * float(ref[1].max()), f32.tiny))


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("shapes", [
    [(74, 56, 43, 32)],
    [(37, 28, 21, 32), (74, 56, 43, 32), (74, 56, 43, 32)],
    [(11, 8, 7, 32)],  # at D = 4: slabs of 3 owned planes (+ the halo)
], ids=["fine", "color_stage", "coarse"])
def test_slab_window_kernels_match_plain(dev, shapes, D):
    """K1-K3 with slab windows (each grid cut into D slabs, one launch per
    slab over the stage's grids) against their plain versions, and summed
    over the slabs against the dense launches: K1 bit for bit, K2 after
    the halo fold and unshard_grid_grad within its gate, K3 within 1e-4
    of max |dp|."""
    from nice_slam_torch.parallel import grid_sharding as gs

    p = _ray_samples(1000).to(dev)
    gen = torch.Generator().manual_seed(2)
    grids = [torch.randn(s, generator=gen).to(dev) for s in shapes]
    cots = [torch.randn((p.shape[0], s[3]), generator=gen).to(dev) for s in shapes]
    sharded = [gs.shard_grid(g, [dev] * D) for g in grids]
    feats = dps = None
    slab_grads = [[] for _ in grids]
    for d in range(D):
        slabs = [sg.slabs[d] for sg in sharded]
        ws = [sg.window(d) for sg in sharded]
        interp.reset_launch_counts()
        f = interp.trilinear_fwd_multi(slabs, p, ws)
        dg = interp.trilinear_bwd_dgrid_multi(p, cots, [tuple(s.shape) for s in slabs], ws)
        dp = interp.trilinear_bwd_dp_multi(slabs, p, cots, ws)
        torch.cuda.synchronize()
        assert interp.launch_counts == {k: 1 for k in interp.launch_counts}
        for a, b in zip(f, interp.trilinear_fwd_multi_plain(slabs, p, ws)):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
        for g, cot, s, w in zip(dg, cots, slabs, ws):
            err, tol = _slab_err_tol(g, p, cot, tuple(s.shape), w)
            assert err <= tol, (d, tuple(s.shape), err, tol)
        ref = interp.trilinear_bwd_dp_multi_plain(slabs, p, cots, ws)
        assert float((dp - ref).abs().max()) <= 1e-4 * max(float(ref.abs().max()), 1e-30)
        feats = f if feats is None else [a + b for a, b in zip(feats, f)]
        dps = dp if dps is None else dps + dp
        for i, g in enumerate(dg):
            slab_grads[i].append(g)
    for a, b in zip(feats, interp.trilinear_fwd_multi(grids, p)):
        assert torch.equal(a, b)
    for i, (sg, cot, s) in enumerate(zip(sharded, cots, shapes)):
        dense = gs.unshard_grid_grad(slab_grads[i], s, sg.planes)
        err, tol = _dgrid_err_tol(dense, p, cot, s)
        assert err <= tol, (s, err, tol)
        # the fold writes each shared plane's total into both copies, so
        # the slabs then read back as the dense gradient
        folded = gs.fold_halo_grads(slab_grads[i])
        for lo, hi in zip(folded[:-1], folded[1:]):
            assert torch.equal(lo[-1], hi[0])
        torch.testing.assert_close(gs.unshard_grid(sg._replace(folded)), dense,
                                   atol=0, rtol=0)
    ref = interp.trilinear_bwd_dp_multi(grids, p, cots)
    assert float((dps - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def test_slab_launches_on_its_own_device(dev):
    """A slab on the last visible card, launched while card 0 is current,
    runs on its own card and stream (a launch on the current card would
    read foreign pointers) and is counted there."""
    from nice_slam_torch.parallel import grid_sharding as gs

    last = torch.device("cuda", torch.cuda.device_count() - 1)
    gen = torch.Generator().manual_seed(3)
    grid = torch.randn((11, 8, 7, 32), generator=gen)
    p_cpu = _ray_samples(200)
    cot_cpu = torch.randn((p_cpu.shape[0], 32), generator=gen)
    sharded = gs.shard_grid(grid.to(last), [last, last])
    p, cot = p_cpu.to(last), cot_cpu.to(last)
    interp.reset_launch_counts()
    with torch.cuda.device(0):
        f = interp.trilinear_fwd_multi([sharded.slabs[1]], p, [sharded.window(1)])
        dg = interp.trilinear_bwd_dgrid_multi(p, [cot], [tuple(sharded.slabs[1].shape)],
                                              [sharded.window(1)])
        dp = interp.trilinear_bwd_dp_multi([sharded.slabs[1]], p, [cot], [sharded.window(1)])
    torch.cuda.synchronize(last)
    stream = torch.cuda.current_stream(last).cuda_stream
    assert interp.launches_by_device == {(k, last.index, stream): 1
                                         for k in interp.launch_counts}
    slab_cpu = sharded.slabs[1].cpu()
    w = sharded.window(1)
    torch.testing.assert_close(f[0].cpu(), interp.trilinear_fwd_plain(slab_cpu, p_cpu, w),
                               atol=1e-5, rtol=0)
    err, tol = _slab_err_tol(dg[0].cpu(), p_cpu, cot_cpu, tuple(slab_cpu.shape), w)
    assert err <= tol
    ref = interp.trilinear_bwd_dp_plain(slab_cpu, p_cpu, cot_cpu, w)
    assert float((dp.cpu() - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def test_coarse_pin_issues_without_host_sync(dev, tmp_path):
    """The coarse mapper pinned to the last device (here over two entries
    of the device list): when the coarse call is entered, work queued on
    the card after the main mapper's call is still running, so nothing on
    the host between the two calls waited for the card.  The spy queues a
    ~0.5 s spin after the main call and an event after it; a host sync
    before the coarse call would find that event complete."""
    from nice_slam_torch.config import load_config
    from nice_slam_torch.slam.slam import NiceSLAM

    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "nice_slam.yaml"))
    big = 10 ** 6
    cfg["coarse"] = True
    cfg["verbose"] = False
    cfg["meshing"] = None
    cfg["data"].update({"n_frames": 7, "output": str(tmp_path)})
    cfg["tracking"].update({"gt_camera": True, "vis_freq": big, "vis_inside_freq": big})
    cfg["mapping"].update({"iters_first": 30, "iters": 10, "color_refine": False,
                           "mesh_freq": big, "ckpt_freq": big, "vis_freq": big,
                           "vis_inside_freq": big})
    for k in ("coarse", "middle_fine"):
        cfg["pretrained_decoders"][k] = os.path.join(ROOT, cfg["pretrained_decoders"][k])
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    slam = NiceSLAM(cfg, argparse.Namespace(nice=True, output=None),
                    devices=[dev, last])
    assert slam.coarse_mapper.device == last
    events, pending = [], []
    real_main, real_coarse = slam.mapper.optimize_map, slam.coarse_mapper.optimize_map

    def spy_main(*a, **k):
        out = real_main(*a, **k)
        torch.cuda._sleep(1_000_000_000)
        ev = torch.cuda.Event()
        ev.record()
        events.append(ev)
        return out

    def spy_coarse(*a, **k):
        pending.append(not events[-1].query())
        return real_coarse(*a, **k)

    slam.mapper.optimize_map = spy_main
    slam.coarse_mapper.optimize_map = spy_coarse
    slam.run()
    assert pending == [True, True], pending  # frames 0 and 5
    assert torch.isfinite(slam.estimate_c2w_list).all() and slam.mapping_idx == 6


# ---------------------------------------------------------------------------
# The decoder stage: K4 decoder_fwd, K5 decoder_bwd, K6 decoder_wgrad_sum
# ---------------------------------------------------------------------------

# (label, call, points, gradients wanted): the rows of the main path's
# calls (tools/workloads.py's Replica-scale room) and the pretrainer's; then
# K5's ragged tiles: one point, a tile (16 points where nothing trains, 64
# where a decoder does) less one, exactly, plus one, and (points -1) a
# training call whose CTAs walk unequal numbers of tiles; K4's persistent
# CTAs walk tiles of 8 points a warp, several each from 17k points up
STAGE_ROWS = (("track", "color_stage", 9600, "fp"),
              ("map_middle", "middle", 48000, "f"),
              ("map_fine", "fine_stage", 48000, "f"),
              ("map_color", "color_stage", 48000, "fw"),
              ("map_color_ba", "color_stage", 48000, "fpw"),
              ("map_coarse", "coarse", 48000, "f"),
              ("mesh_chunk", "color_stage", 500000, ""),
              ("pretrain_fine", "fine", 4096, "fW"),
              ("pretrain_coarse", "coarse", 4096, "fW"),
              ("one_point", "color_stage", 1, "fp"),
              ("tile_less_one", "color_stage", 15, "fp"),
              ("tile", "fine_stage", 16, "f"),
              ("tile_plus_one", "color_stage", 17, "fp"),
              ("one_point_train", "color_stage", 1, "fw"),
              ("train_tile_less_one", "color_stage", 63, "fpw"),
              ("train_tile", "fine", 64, "fW"),
              ("train_tile_plus_one", "color_stage", 65, "fw"),
              ("train_uneven", "color_stage", -1, "fw"),
              ("one_decoder_ragged", "coarse", 33, "f"))


def _uneven_points(dev) -> int:
    """A training call whose persistent CTAs (one per SM) walk 2 or 1
    tiles of 64 points, the last one ragged."""
    return (torch.cuda.get_device_properties(dev).multi_processor_count + 3) * 64 + 5


def _stage_case(dev, call, n, coherent, seed=0):
    """The port's initial decoders packed for ``call``, features and a
    cotangent on ``n`` points: ray samples (48 sorted per ray, as the
    renderer's) or uniform in the box."""
    from nice_slam_torch.models import decoders as D
    from nice_slam_torch.ops import decoder_stage as DS

    gen = torch.Generator().manual_seed(seed)
    spec = D.NICESpec(c_dim=32, hidden_size=32, coarse=True)
    params = D.init_nice(gen, spec, "cpu")
    subs = spec.sub_specs()
    if call in ("fine_stage", "color_stage"):
        names = ["middle", "fine"] + (["color"] if call == "color_stage" else [])
        decs = [DS.decoder_of(subs["middle"], 0), DS.decoder_of(subs["fine"], 1, 0)]
        if call == "color_stage":
            decs.append(DS.decoder_of(subs["color"], 2, occ3=False))
        n_feats = len(names)
    else:
        names = [call]
        decs = [DS.decoder_of(subs[call], 0, 1 if call == "fine" else -1)]
        n_feats = 2 if call == "fine" else 1
    if coherent:
        rays = -(-n // 48)
        o = (torch.rand((rays, 1, 3), generator=gen) - 0.5) * 2.0
        d = torch.nn.functional.normalize(torch.randn((rays, 1, 3), generator=gen), dim=-1)
        t = torch.sort(torch.rand((rays, 48, 1), generator=gen) * 2.5, dim=1).values
        p = (o + d * t).reshape(-1, 3)[:n]
    else:
        p = torch.rand((n, 3), generator=gen) * 5.2 - 2.6
    feats = [0.3 * torch.randn((n, 32), generator=gen) for _ in range(n_feats)]
    g = torch.randn((n, 4), generator=gen)
    weights = [DS.pack(params[k], dd, 32) for k, dd in zip(names, decs)]
    return (decs, p.contiguous().to(dev), [f.to(dev) for f in feats],
            [w.to(dev) for w in weights], g.to(dev))


def _assert_rel(got, ref, rtol, what):
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    assert err <= rtol * scale, f"{what}: {err} > {rtol} x {scale}"


def _assert_per_point(got, ref, rtol, what):
    """A per-point gradient: every point within rtol x the plain gradient's
    largest entry but for at most 0.1 % of them, and the whole within
    rtol in L2.  A pre-activation within rounding of relu's kink may take
    the other branch in one of two float32 evaluations and move its
    point's gradient by one unit's term; at random weights and 48k points
    about a dozen units do."""
    tol = rtol * float(ref.abs().max())
    off = int(((got - ref).abs().amax(dim=1) > tol).sum())
    assert off <= max(1, got.shape[0] // 1000), f"{what}: {off} points off by > {tol}"
    l2 = float((got - ref).norm() / ref.norm())
    assert l2 <= rtol, f"{what}: L2 error {l2} > {rtol}"


@pytest.mark.parametrize("coherent", [True, False], ids=["rays", "uniform"])
@pytest.mark.parametrize("label,call,n,want", STAGE_ROWS, ids=[r[0] for r in STAGE_ROWS])
def test_decoder_kernels_match_plain(dev, label, call, n, want, coherent):
    """K4, K5 and K6 against their plain versions on the same card: the
    output within 1e-2 absolute, the feature and weight gradients within
    1e-3 of the plain gradient's largest entry, dp within 1e-2; one K4,
    one K5 and one K6 per decoder that trains."""
    from nice_slam_torch.ops import decoder_stage as DS

    n = _uneven_points(dev) if n < 0 else n
    decs, p, feats, weights, g = _stage_case(dev, call, n, coherent)
    DS.reset_launch_counts()
    out = DS.decoder_fwd(p, feats, weights, decs)
    ref = DS.decoder_fwd_plain(p, feats, weights, decs)
    assert float((out - ref).abs().max()) <= 1e-2
    assert DS.launch_counts["decoder_fwd"] == 1
    if not want:
        return
    D = len(decs)
    need_p = "p" in want
    need_w = [True] * D if "W" in want else ([False] * (D - 1) + ["w" in want])
    need_f = [True] * len(feats)
    got = DS.decoder_bwd(p, feats, weights, decs, g, need_p, need_f, need_w)
    exp = DS.decoder_bwd_plain(p, feats, weights, decs, g, need_p, need_f, need_w)
    torch.cuda.synchronize()
    assert DS.launch_counts["decoder_bwd"] == 1
    assert DS.launch_counts["decoder_wgrad_sum"] == sum(need_w)
    if need_p:
        _assert_per_point(got[0], exp[0], 1e-2, "dp")
    for i, (a, b) in enumerate(zip(got[1], exp[1])):
        assert (a is None) == (b is None)
        if a is not None:
            _assert_per_point(a, b, 1e-3, f"dfeat {i}")
    for i, (a, b) in enumerate(zip(got[2], exp[2])):
        assert (a is None) == (b is None)
        if a is not None:
            for name, x in DS.unpack(a, decs[i], 32).items():
                y = DS.unpack(b, decs[i], 32)[name]
                tol = 1e-2 if name == "B" else 1e-3
                _assert_rel(x, y, tol, f"decoder {i} {name}")


def test_decoder_weight_gradient_is_deterministic(dev):
    """Three K5 + K6 runs on the same inputs, and one on a second stream,
    give bit-equal weight gradients (each CTA sums its tiles in a fixed
    order, K6 the per-CTA partials in a fixed order)."""
    from nice_slam_torch.ops import decoder_stage as DS

    decs, p, feats, weights, g = _stage_case(dev, "color_stage", 48000, True)
    side = torch.cuda.Stream(dev)
    for need_p, need_w in ((False, [False, False, True]), (True, [True] * 3)):
        runs = [DS.decoder_bwd(p, feats, weights, decs, g, need_p, [True] * 3, need_w)
                for _ in range(3)]
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            runs.append(DS.decoder_bwd(p, feats, weights, decs, g, need_p, [True] * 3, need_w))
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize()
        for run in runs[1:]:
            assert all(torch.equal(a, b) for a, b, w in zip(runs[0][2], run[2], need_w) if w)


def _head_f32(bo, h, wo):
    """b_o + sum_j h_j W_o[j] as K4's head sums it: one float32 FMA at a
    time in order of j (each product exact in float64, the sum rounded once
    to float64 and once to float32: a double rounding that can differ from
    the FMA only when the float64 sum falls on a float32 midpoint, about
    one case in 2^29)."""
    s = np.float32(bo)
    for j in range(h.shape[0]):
        s = np.float32(np.float64(h[j]) * np.float64(wo[j]) + np.float64(s))
    return s


@pytest.mark.parametrize("call", ["color_stage", "middle", "coarse"])
def test_decoder_fwd_is_k5s_recomputed_forward_bit_for_bit(dev, call):
    """K4's output is, bit for bit, the composed heads of the block-4
    outputs that K5 recomputes.  With a one-hot cotangent on point m (1 at
    rgb's first column and at occupancy) and every decoder training, K5's
    dWo column 0 of each decoder is point m's block-4 output as K5
    recomputed it (every other point adds h x 0); its head summed in K4's
    order and the heads composed in decoder order must equal K4's output at
    m.  K4 taking its sines from sinf instead of sincos_emb fails this."""
    from nice_slam_torch.ops import decoder_stage as DS

    decs, p, feats, weights, _ = _stage_case(dev, call, 3000, True)
    n, D = p.shape[0], len(decs)
    out = DS.decoder_fwd(p, feats, weights, decs).cpu().numpy()
    for m in (0, 1, 1499, n - 1):
        g1 = torch.zeros((n, 4), device=dev)
        g1[m, 0] = g1[m, 3] = 1.0
        _, _, dws = DS.decoder_bwd(p, feats, weights, decs, g1, False, [False] * len(feats),
                                   [True] * D)
        res = np.zeros(4, np.float32)
        for d, w, dw in zip(decs, weights, dws):
            W = DS.unpack(w.cpu(), d, 32)
            h = DS.unpack(dw.cpu(), d, 32)["Wo"][:, 0].numpy()
            o = [_head_f32(W["bo"][q].item(), h, W["Wo"][:, q].numpy()) for q in range(d.out)]
            if d.out == 1:
                res[3] = np.float32(res[3] + o[0])
            else:
                res[:3] = o[:3]
                if d.occ3:
                    res[3] = np.float32(res[3] + o[3])
        assert np.array_equal(out[m], res), (call, m, out[m] - res)


def test_decoder_fwd_is_bit_identical_across_runs_and_streams(dev):
    """Three K4 runs on the same inputs, and one on a second stream, give
    bit-equal outputs (each CTA composes its tile's heads in decoder order)."""
    from nice_slam_torch.ops import decoder_stage as DS

    for call in ("color_stage", "fine_stage", "middle"):
        decs, p, feats, weights, _ = _stage_case(dev, call, 48000, True)
        runs = [DS.decoder_fwd(p, feats, weights, decs) for _ in range(3)]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            runs.append(DS.decoder_fwd(p, feats, weights, decs))
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize()
        assert all(torch.equal(runs[0], r) for r in runs[1:]), call


def test_decoder_bwd_compiles_without_local_memory(dev):
    """K4, K5 in both launch shapes and K6 use no local memory (no spills),
    and at tracking's 9,600 points K4's and K5's geometries keep at least 8
    warps resident on every SM."""
    from nice_slam_torch.models import decoders as D
    from nice_slam_torch.ops import decoder_stage as DS

    subs = D.NICESpec(c_dim=32, hidden_size=32, coarse=True).sub_specs()
    decs = [DS.decoder_of(subs["middle"], 0), DS.decoder_of(subs["fine"], 1, 0),
            DS.decoder_of(subs["color"], 2, occ3=False)]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for which, need_w in (("decoder_bwd", [False] * 3), ("decoder_bwd_train", [False, False, True])):
        info = DS.kernel_info(which, DS.bwd_smem(decs, 32, need_w, dev), dev)
        assert info["local_bytes"] == 0, (which, info)
        assert info["ctas_per_sm"] >= 1, (which, info)
    assert DS.kernel_info("decoder_wgrad_sum", 0, dev)["local_bytes"] == 0
    geom = DS.bwd_geometry(9600, sms, False, 3)
    info = DS.kernel_info("decoder_bwd", DS.bwd_smem(decs, 32, [False] * 3, dev), dev)
    per_sm = min(info["ctas_per_sm"], geom.ctas // sms)
    assert per_sm * geom.threads // 32 >= 8, (geom, info)
    fgeom = DS.fwd_geometry(9600, sms)
    info = DS.kernel_info("decoder_fwd", DS.fwd_smem(decs, 32, fgeom.warps, dev), dev,
                          fgeom.threads)
    assert info["local_bytes"] == 0 and info["ctas_per_sm"] >= 1, info
    assert fgeom.warps >= 8 and fgeom.grid >= 0.9 * sms, (fgeom, info)


def test_decoder_function_on_cuda_matches_cpu(dev):
    """The autograd Function on the card (K4-K6) against the CPU (the plain
    versions), every gradient wanted."""
    from nice_slam_torch.ops import decoder_stage as DS

    decs, p, feats, weights, g = _stage_case(dev, "color_stage", 3000, True)
    res = {}
    for where in ("cuda", "cpu"):
        leaves = [x.detach().to(where).requires_grad_(True) for x in [p, *feats, *weights]]
        out = DS.decoder_stage(leaves[0], decs, leaves[1:4], leaves[4:])
        grads = torch.autograd.grad(out, leaves, g.to(where), allow_unused=True)
        res[where] = (out.detach().cpu(), [None if x is None else x.cpu() for x in grads])
    assert float((res["cuda"][0] - res["cpu"][0]).abs().max()) <= 1e-2
    for i, (a, b) in enumerate(zip(res["cuda"][1], res["cpu"][1])):
        assert (a is None) == (b is None), i
        if a is not None and a.dim() == 2 and a.shape[0] == p.shape[0]:
            _assert_per_point(a, b, 1e-2 if i == 0 else 2e-3, f"input {i}")
        elif a is not None:
            _assert_rel(a, b, 2e-3, f"input {i}")


def test_decoder_wrappers_reject_what_the_kernels_do_not_take(dev):
    from nice_slam_torch.ops import decoder_stage as DS

    decs, p, feats, weights, g = _stage_case(dev, "middle", 100, False)
    with pytest.raises(ValueError):
        DS.decoder_fwd(p, feats, [weights[0].cpu()], decs)
    with pytest.raises(ValueError):
        DS.decoder_fwd(p, feats, [weights[0][:-1]], decs)
    with pytest.raises(TypeError):
        DS.decoder_fwd(p, [feats[0].double()], weights, decs)
    with pytest.raises(ValueError):
        DS.decoder_bwd(p, feats, weights, decs, g[:50], False, [True], [False])


# ---------------------------------------------------------------------------
# K7 integrate_fwd and K8 integrate_bwd (ops/integrator.py)
# ---------------------------------------------------------------------------

# the main path's integrator calls: (rays, samples, occupancy) of a
# tracking iteration, a mapping iteration, a coarse-mapping iteration, a
# render chunk and an iMAP* iteration (32 + 12 samples, density); then
# sample counts that are no multiple of anything, and each side of a
# block of 16 lanes and of a tile of 16 x 4 at 1500 rays (which fill the
# card at 16 lanes a ray; 65 samples take 32), the tiled path (300), one
# ray, and 203 rays, whose last CTA (4 rays of 32 lanes) holds 3
INTEGRATOR_CASES = {"track": (200, 48, True), "map": (1000, 48, True),
                    "coarse": (1000, 32, True), "render": (100_000, 48, True),
                    "imap": (5000, 44, False), "one_sample": (37, 1, True),
                    "odd_density": (333, 97, False),
                    "s15": (1500, 15, True), "s16": (1500, 16, False),
                    "s17": (1500, 17, True), "s31": (1500, 31, False),
                    "s32": (1500, 32, True), "s33": (1500, 33, False),
                    "s64": (1500, 64, True), "s65": (1500, 65, False),
                    "tiled": (64, 300, True), "tiled_density": (64, 300, False),
                    "one_ray": (1, 48, True), "ragged_cta": (203, 44, False)}
# the sample counts each side of a block of 32 lanes, at 100 rays (too few
# to fill the card at 16 lanes a ray)
NARROW_SAMPLES = (15, 16, 17, 31, 32, 33, 64, 65, 128, 129)


def _integrator_inputs(dev, n, s, occupancy, seed=0, across=False):
    """Rays with saturated alpha and (density) relu at 0; ``across``: the
    second half of the rays saturated from sample s // 5 + 1 to 3 s // 4,
    a run that starts and ends inside blocks of every lane count (and
    crosses tiles at S = 300)."""
    g = torch.Generator().manual_seed(seed)
    raw = torch.randn((n, s, 4), generator=g)
    if occupancy:
        raw[: n // 4, s // 3:, 3] = 3.0 + 3.0 * torch.rand((n // 4, s - s // 3), generator=g)
    else:
        raw[..., 3] = raw[..., 3].abs() * 3.0
        raw[: n // 4, ::3, 3] = 0.0
        raw[n // 4: n // 2, s // 2:, 3] = 40.0
    if across:
        raw[n // 2:, s // 5 + 1: 3 * s // 4 + 1, 3] = 3.0 if occupancy else 40.0
    z = torch.sort(0.1 + 3.9 * torch.rand((n, s), generator=g), dim=-1).values
    rays_d = torch.randn((n, 3), generator=g)
    cot = torch.randn((n, 5), generator=g)
    return [t.to(dev) for t in (raw, z, rays_d, cot)]


def _check_integrator(dev, n, s, occ, lanes, across=False):
    """K7 within 1e-5 of the plain output's largest entry, K8 within 1e-4
    of the plain gradient's largest entry (the kernels sum and scan in a
    tree order over a ray's lanes, the plain versions in sequence), one
    launch each, at the ``lanes`` ``integrate_geometry`` chooses."""
    from nice_slam_torch.ops import integrator as I

    assert I.launch_geometry(n, s, dev).lanes == lanes
    raw, z, rays_d, cot = _integrator_inputs(dev, n, s, occ, across=across)
    I.reset_launch_counts()
    got = I.integrate_fwd(raw, z, rays_d, occ)
    ref = I.integrate_fwd_plain(raw, z, rays_d, occ)
    for a, b in zip(got, ref):
        assert float((a - b).abs().max()) <= 1e-5 * max(float(b.abs().max()), 1.0)
    gD, gV, gC = cot[:, 0].contiguous(), cot[:, 1].contiguous(), cot[:, 2:].contiguous()
    g_raw, g_rays = I.integrate_bwd(raw, z, rays_d, got[0], gD, gV, gC, occ)
    r_raw, r_rays = I.integrate_bwd_plain(raw, z, rays_d, got[0], gD, gV, gC, occ)
    assert torch.isfinite(g_raw).all()
    assert float((g_raw - r_raw).abs().max()) <= 1e-4 * float(r_raw.abs().max())
    if occ:
        assert g_rays is None
    else:
        assert float((g_rays - r_rays).abs().max()) <= 1e-4 * float(r_rays.abs().max())
    assert I.launch_counts == {"integrate_fwd": 1, "integrate_bwd": 1}


def _lanes(n, s):
    """The lanes per ray ``integrate_geometry`` gives an H100 (132 SMs)."""
    return 16 if s <= 64 and -(-n // 8) >= 132 else 32


@pytest.mark.parametrize("case", list(INTEGRATOR_CASES))
def test_integrator_kernels_match_plain(dev, case):
    n, s, occ = INTEGRATOR_CASES[case]
    _check_integrator(dev, n, s, occ, _lanes(n, s))


@pytest.mark.parametrize("s", NARROW_SAMPLES)
def test_integrator_kernels_match_plain_at_32_lanes(dev, s):
    """Each side of a block of 32 lanes, density mode (occupancy in the
    odd sample counts), one tile up to 128 samples, then two."""
    _check_integrator(dev, 100, s, bool(s % 2), 32)


@pytest.mark.parametrize("n", [96, 1500], ids=["32_lanes", "16_lanes"])
@pytest.mark.parametrize("s", [48, 300])
@pytest.mark.parametrize("occupancy", [True, False], ids=["occupancy", "density"])
def test_integrator_saturated_run_across_lanes_and_tiles(dev, occupancy, s, n):
    """A saturated run (f = 1e-10) that starts inside one block and ends
    inside another, across tiles at S = 300: the scans' carries hold it
    without dividing by f, so K8's gradient stays finite and in its gate."""
    _check_integrator(dev, n, s, occupancy, _lanes(n, s), across=True)


@pytest.mark.parametrize("occupancy", [True, False], ids=["occupancy", "density"])
def test_integrator_function_on_cuda_matches_cpu(dev, occupancy):
    from nice_slam_torch.ops import integrator as I

    raw, z, rays_d, cot = _integrator_inputs(torch.device("cpu"), 300, 48, occupancy, 4)
    out = {}
    for where in ("cpu", dev):
        r = raw.to(where).requires_grad_(True)
        d = rays_d.to(where).requires_grad_(True)
        depth, var, rgb, _ = I.raw2outputs_nerf_color(r, z.to(where), d, occupancy)
        c = cot.to(where)
        loss = (depth * c[:, 0]).sum() + (var * c[:, 1]).sum() + (rgb * c[:, 2:]).sum()
        grads = torch.autograd.grad(loss, (r, d), allow_unused=True)
        out[str(where)] = [x.detach().cpu() for x in (depth, var, rgb)] + \
            [None if x is None else x.cpu() for x in grads]
    for a, b in zip(out[str(dev)], out["cpu"]):
        if b is None:
            assert a is None
        else:
            assert float((a - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1.0)


def test_integrator_wrappers_reject_what_the_kernels_do_not_take(dev):
    from nice_slam_torch.ops import integrator as I

    raw, z, rays_d, _ = _integrator_inputs(dev, 8, 6, True)
    with pytest.raises(TypeError):
        I.integrate_fwd(raw.double(), z.double(), rays_d.double(), True)
    with pytest.raises(ValueError):
        I.integrate_fwd(raw, z[:, :5], rays_d, True)
    with pytest.raises(ValueError):
        I.integrate_fwd(raw, z, rays_d.cpu(), True)
    with pytest.raises(ValueError):
        I.raw2outputs_nerf_color(raw, z.clone().requires_grad_(True), rays_d, True)


def test_integrator_kernels_use_no_local_memory(dev):
    """Every template instance: K7 and K8, both modes, each lane count."""
    from nice_slam_torch.ops import integrator as I

    for bwd in (False, True):
        for occ in (False, True):
            for lanes in I.INTEGRATE_LANES:
                info = I.integrate_kernel_info(bwd, occ, dev, lanes)
                assert info["local_bytes"] == 0, (bwd, occ, lanes, info)
                assert info["ctas_per_sm"] >= 1 and info["run"] == I.INTEGRATE_RUN


# ---------------------------------------------------------------------------
# K9 group_adam (slam/optim.py)
# ---------------------------------------------------------------------------

def _rounded_adam(p, g, m, v, mask, bc1, bc2, lr):
    """K9's arithmetic, each operation rounded to float32 on its own (in
    float64, which rounds a float32 sum, product, quotient or square root
    exactly once), so K9 must equal it bit for bit."""
    f = torch.float32

    def r(x):
        return x.to(f).double()

    b1, b2 = r(torch.tensor(0.9)), r(torch.tensor(0.999))
    c1, c2 = r(torch.tensor(1.0 - 0.9)), r(torch.tensor(1.0 - 0.999))
    g = torch.zeros_like(p.double()) if g is None else g.double()
    if mask is not None:
        g = r(g * mask.double())
    m = r(r(m.double() * b1) + r(c1 * g))
    v = r(r(v.double() * b2) + r(c2 * r(g * g)))
    denom = r(r(torch.sqrt(r(v / float(np.float32(bc2))))) + r(torch.tensor(1e-8)))
    u = r(r(m / float(np.float32(bc1))) / denom)
    lr = lr.double() if isinstance(lr, torch.Tensor) else r(torch.tensor(lr))
    return r(p.double() - r(lr * u)).to(f), m.to(f), v.to(f)


def _adam_case(dev, seed=0):
    """A color-stage-like step: three masked grids, a decoder's leaves
    (one of them without a gradient, one of odd length) and the tracker's
    pose with its per-entry lr vector."""
    gen = torch.Generator().manual_seed(seed)
    shapes = [(37, 28, 21, 32), (74, 56, 43, 32), (74, 56, 43, 32), (32, 35), (32,), (3,),
              (7,)]
    ps = [torch.randn(s, generator=gen).to(dev) for s in shapes]
    gs = [torch.randn(s, generator=gen).to(dev) for s in shapes]
    gs[4] = None
    masks = [(torch.rand(s[:3] + (1,), generator=gen) < 0.5).float().to(dev)
             for s in shapes[:3]] + [None] * 4
    lrs = [0.1, 0.005, 0.005, 1e-3, 1e-3, 0.0,
           torch.tensor([0.2] * 4 + [1.0] * 3, device=dev) * 1e-3]
    return ps, gs, masks, lrs


def test_group_adam_is_its_rounded_arithmetic_bit_for_bit(dev):
    """K9 over 60 steps, each against its own arithmetic rounded op by op
    (``_rounded_adam``) from the same state: equal bit for bit."""
    from nice_slam_torch.slam import optim as O

    ps, gs, masks, lrs = _adam_case(dev)
    ms = [torch.zeros_like(p) for p in ps]
    vs = [torch.zeros_like(p) for p in ps]
    gen = torch.Generator(device=dev).manual_seed(1)
    for step in range(1, 61):
        bc1 = float(np.float32(1) - np.float32(0.9) ** np.float32(step))
        bc2 = float(np.float32(1) - np.float32(0.999) ** np.float32(step))
        want = [_rounded_adam(p, g, m, v, k, bc1, bc2, lr)
                for p, g, m, v, k, lr in zip(ps, gs, ms, vs, masks, lrs)]
        O.group_adam([(p, g, m, v, k, bc1, bc2, lr)
                      for p, g, m, v, k, lr in zip(ps, gs, ms, vs, masks, lrs)])
        for (wp, wm, wv), p, m, v in zip(want, ps, ms, vs):
            assert torch.equal(p, wp) and torch.equal(m, wm) and torch.equal(v, wv), step
        gs = [None if g is None else torch.randn(g.shape, generator=gen, device=dev)
              for g in gs]


def _ulps_of(a, b, scale):
    """|a - b| in float32 epsilons of ``scale``."""
    return float(((a - b).abs() / (scale * torch.finfo(torch.float32).eps)
                  .clamp_min(torch.finfo(torch.float32).tiny)).max())


def test_group_adam_matches_the_plain_step_on_the_card(dev):
    """K9 against ``_adam_update`` (torch._foreach, whose adds PyTorch's
    CUDA build may contract into fused multiply-adds) over 60 steps, each
    from the same state: m and v within 2 epsilons of their terms'
    magnitudes, p within 2 epsilons of |p| + lr (|u| + the update's
    sensitivity to m's rounding); prints how many elements differ at all."""
    from nice_slam_torch.slam import optim as O

    ps, gs, masks, lrs = _adam_case(dev, seed=1)
    ms = [torch.zeros_like(p) for p in ps]
    vs = [torch.zeros_like(p) for p in ps]
    gen = torch.Generator(device=dev).manual_seed(2)
    differ = total = 0
    worst = 0.0
    for step in range(1, 61):
        bc1 = float(np.float32(1) - np.float32(0.9) ** np.float32(step))
        bc2 = float(np.float32(1) - np.float32(0.999) ** np.float32(step))
        mine = [[t.clone() for t in (p, m, v)] for p, m, v in zip(ps, ms, vs)]
        O.group_adam([(p, g, m, v, k, bc1, bc2, lr) for (p, m, v), g, k, lr
                      in zip(mine, gs, masks, lrs)])
        for i, (g, k, lr) in enumerate(zip(gs, masks, lrs)):
            g = torch.zeros_like(ps[i]) if g is None else g
            g = g if k is None else g * k
            p0, m0, v0 = ps[i].clone(), ms[i].clone(), vs[i].clone()
            O._adam_update([ps[i]], [g], [ms[i]], [vs[i]], bc1, bc2, lr)
            sm = (0.9 * m0).abs() + (0.1 * g).abs()
            sv = (0.999 * v0).abs() + (0.001 * g * g).abs()
            denom = torch.sqrt(vs[i] / bc2) + 1e-8
            u = (ms[i] / bc1) / denom
            lr_t = lr if isinstance(lr, torch.Tensor) else torch.tensor(lr, device=dev)
            sp = p0.abs() + lr_t.abs() * (u.abs() + sm / (bc1 * denom))
            for got, want, scale in zip(mine[i], (ps[i], ms[i], vs[i]), (sp, sm, sv)):
                worst = max(worst, _ulps_of(got, want, scale))
                differ += int((got != want).sum())
                total += got.numel()
        # the next step starts from the plain state, with new gradients
        gs = [None if g is None else torch.randn(g.shape, generator=gen, device=dev)
              for g in gs]
    print(f"K9 vs _adam_update: {differ} of {total} values differ, "
          f"worst {worst:.3f} eps of the scale")
    assert worst <= 2.0


def test_group_adam_one_launch_per_device_and_step(dev):
    """GroupAdam.step over several groups, one inactive, one with lr 0:
    one K9 launch on the current stream, and the result of the plain
    step on the CPU."""
    from nice_slam_torch.slam import optim as O

    gen = torch.Generator().manual_seed(3)
    init = {"a": torch.randn((4, 5, 6, 8), generator=gen),
            "b": [torch.randn(10, generator=gen), torch.randn((3, 3), generator=gen)],
            "c": torch.randn(7, generator=gen), "off": torch.randn(5, generator=gen)}
    mask = (torch.rand((4, 5, 6, 1), generator=gen) < 0.5).float()
    on = {k: O.tree_map(lambda t: t.clone().to(dev), v) for k, v in init.items()}
    cpu = {k: O.tree_map(lambda t: t.clone(), v) for k, v in init.items()}
    opt_d, opt_c = O.GroupAdam(on), O.GroupAdam(cpu)
    lrs = {"a": 0.01, "b": 0.0, "c": torch.tensor([0.2] * 4 + [1.0] * 3) * 0.01,
           "off": 0.5}
    active = {"a": True, "b": True, "c": True, "off": False}
    O.reset_launch_counts()
    for step in range(5):
        grads = {k: [torch.randn(t.shape, generator=gen) for t in O.tree_leaves(v)]
                 for k, v in init.items()}
        grads["b"][0] = None
        for opt, where in ((opt_d, dev), (opt_c, "cpu")):
            opt.step({k: [None if g is None else g.to(where) for g in v]
                      for k, v in grads.items()},
                     {k: v.to(where) if isinstance(v, torch.Tensor) else v
                      for k, v in lrs.items()},
                     active, {"a": [mask.to(where)]})
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream().cuda_stream
    assert O.launch_counts == {"group_adam": 5}
    assert O.launches_by_stream == {("group_adam", stream): 5}
    for k in init:
        for a, b in zip(O.tree_leaves(on[k]), O.tree_leaves(cpu[k])):
            torch.testing.assert_close(a.cpu(), b, atol=1e-6, rtol=1e-5)
    assert torch.equal(on["off"].cpu(), init["off"])
    assert opt_d.steps == opt_c.steps == {"a": 5, "b": 5, "c": 5, "off": 0}


def test_group_adam_uses_no_local_memory(dev):
    from nice_slam_torch.slam import optim as O

    assert O.group_adam_kernel_info(dev)["local_bytes"] == 0


# ---------------------------------------------------------------------------
# K10 frustum_mask (ops/frustum.py): one cooperative launch a call
# ---------------------------------------------------------------------------

def _mask_f64(points, c2w, depth, max_depth, H, W, fx, fy, cx, cy):
    """The plain mask's tests in float64 at given world points, with the
    grid's largest lookup ``max_depth``."""
    from nice_slam_torch.ops.interp import bilinear_sample_2d

    w2c = torch.linalg.inv(c2w.double())
    cam = points @ w2c[:3, :3].T + w2c[:3, 3]
    zc = cam[:, 2] + 1e-5
    u = (fx * (-cam[:, 0]) + cx * cam[:, 2]) / zc
    v = (fy * cam[:, 1] + cy * cam[:, 2]) / zc
    d = bilinear_sample_2d(depth.double(), u, v)
    d = torch.where(d == 0.0, torch.full_like(d, max_depth), d)
    seen = (u < W) & (u > 0) & (v < H) & (v > 0) & (-zc >= 0) & (-zc <= d + 0.5)
    return seen | (torch.sum((points - c2w[:3, 3].double()) ** 2, dim=-1) < 0.25)


# the Replica room's bound and grids (tools/workloads.replica_synthetic_cfg),
# and Apartment's (configs/Apartment/apartment.yaml's bound rounded as the
# port rounds it, the default grid_len): its ~0.51M distinct nodes take
# more than one round of threads
K10_SCENES = {"room": ([[-2.9, 8.94], [-3.2, 5.76], [-3.5, 3.54]],
                       [(37, 28, 21), (74, 56, 43), (74, 56, 43)]),
              "apartment": ([[-5.8, 11.48], [-4.0, 4.64], [-7.9, 5.22]],
                            [(53, 26, 40), (107, 53, 81), (107, 53, 81)])}


def _room_camera(dev, seed=0, zeros=0.05, scene="room"):
    """A scene's three grids and a 680x1200 camera looking into it with a
    smooth depth image, ``zeros`` of its pixels zero (no sensor return)."""
    from nice_slam_torch.ops.geometry import c2w44

    gen = torch.Generator().manual_seed(seed)
    bound = torch.tensor(K10_SCENES[scene][0])
    shapes = list(K10_SCENES[scene][1])
    H, W, fx, fy, cx, cy = 680, 1200, 600.0, 600.0, 599.5, 339.5
    ang = 0.4
    R = torch.tensor([[np.cos(ang), 0.0, np.sin(ang)], [0.0, 1.0, 0.0],
                      [-np.sin(ang), 0.0, np.cos(ang)]], dtype=torch.float32)
    c2w = c2w44(torch.cat([R, torch.tensor([[2.0], [0.5], [0.3]])], dim=1))
    yy, xx = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    depth = 2.0 + 1.5 * torch.sin(xx / 97.0) * torch.cos(yy / 61.0) \
        + 0.1 * torch.rand((H, W), generator=gen)
    depth[torch.rand((H, W), generator=gen) < zeros] = 0.0
    return (c2w.to(dev), depth.to(dev), bound.to(dev), shapes, H, W, fx, fy, cx, cy)


def _plain_top(c2w, depth, bound, shape, H, W, fx, fy, cx, cy):
    """A grid's largest depth lookup, as the plain version takes it."""
    from nice_slam_torch.ops.geometry import linspace
    from nice_slam_torch.ops.interp import bilinear_sample_2d

    axes = [linspace(bound[a, 0], bound[a, 1], n) for a, n in enumerate(shape)]
    nodes = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, 3)
    w2c = torch.linalg.inv(c2w)
    cam = nodes @ w2c[:3, :3].T + w2c[:3, 3]
    zc = cam[:, 2] + 1e-5
    return float(bilinear_sample_2d(depth, (fx * (-cam[:, 0]) + cx * cam[:, 2]) / zc,
                                    (fy * cam[:, 1] + cy * cam[:, 2]) / zc).max())


@pytest.mark.parametrize("scene,zeros", [("room", 0.05), ("room", 0.0), ("room", 1.0),
                                         ("apartment", 0.05), ("apartment", 1.0)])
def test_frustum_kernel_matches_plain(dev, scene, zeros):
    """K10's masks against the plain version's at a scene's three grids
    and a 680x1200 frame with no zero depth, 5 % zeros, or every pixel
    zero (every node in the image then waits for the largest lookup, 0):
    equal, except nodes within 1e-5 m of a test boundary (the plain mask
    in float64 flips when the node moves 1e-5 m along an axis), at most
    1e-4 of the nodes; each grid's largest lookup (K10's own output)
    within 1e-5 of the depth's largest; fine's and color's masks one
    tensor; one launch."""
    from nice_slam_torch.ops import frustum as Fm
    from nice_slam_torch.ops.geometry import linspace

    c2w, depth, bound, shapes, H, W, fx, fy, cx, cy = _room_camera(dev, zeros=zeros,
                                                                    scene=scene)
    Fm.reset_launch_counts()
    got = Fm.frustum_masks(c2w, depth, bound, shapes, H, W, fx, fy, cx, cy)
    assert Fm.launch_counts == {"frustum_mask": 1}
    assert got[1] is got[2] and got[0] is not got[1]
    tops = Fm.frustum_depth_max(c2w, depth, bound, shapes, H, W, fx, fy, cx, cy).cpu()
    assert Fm.launch_counts == {"frustum_mask": 2} and tops.shape == (3,)
    for shape, m, t in zip(shapes, got, tops):
        assert m.shape == (*shape, 1)
        top = _plain_top(c2w, depth, bound, shape, H, W, fx, fy, cx, cy)
        assert abs(float(t) - top) <= 1e-5 * max(float(depth.max()), 1.0), (shape, t, top)
        ref = Fm.frustum_mask_plain(c2w, depth, bound, shape, H, W, fx, fy, cx, cy)
        assert 0 < int(ref.sum()) < ref.numel()
        bad = torch.nonzero((m[..., 0] > 0) != ref).cpu()
        assert len(bad) <= 1e-4 * ref.numel(), (shape, len(bad))
        if not len(bad):
            continue
        axes = [linspace(bound[a, 0], bound[a, 1], n).double().cpu()
                for a, n in enumerate(shape)]
        pts = torch.stack([axes[a][bad[:, a]] for a in range(3)], dim=-1)
        args = (c2w.cpu(), depth.cpu(), top, H, W, fx, fy, cx, cy)
        base = _mask_f64(pts, *args)
        flips = torch.zeros_like(base)
        for a in range(3):
            for sgn in (-1.0, 1.0):
                moved = pts.clone()
                moved[:, a] += sgn * 1e-5
                flips |= _mask_f64(moved, *args) != base
        assert bool(flips.all()), (shape, pts[~flips][:5])


def test_frustum_mask_dispatcher_on_the_card(dev):
    """The mapper's ``frustum_mask`` on the card is K10's mask as booleans."""
    from nice_slam_torch.ops import frustum as Fm
    from nice_slam_torch.slam import mapper as M

    c2w, depth, bound, shapes, H, W, fx, fy, cx, cy = _room_camera(dev, seed=1)
    Fm.reset_launch_counts()
    got = M.frustum_mask(c2w, depth, bound, shapes[0], H, W, fx, fy, cx, cy)
    assert got.dtype == torch.bool and tuple(got.shape) == shapes[0]
    assert Fm.launch_counts == {"frustum_mask": 1}
    ref = Fm.frustum_masks(c2w, depth, bound, shapes[:1], H, W, fx, fy, cx, cy)[0]
    assert torch.equal(got, ref[..., 0] > 0)


def test_frustum_kernels_use_no_local_memory(dev):
    from nice_slam_torch.ops import frustum as Fm

    info = Fm.frustum_kernel_info(dev)
    assert info["local_bytes"] == 0 and info["ctas_per_sm"] >= 1


def test_frustum_slab_layout_on_the_card(dev):
    """K10 writing the slab layout (rows > nx) gives the dense mask with
    its last plane repeated, bit for bit, and ``mask_to_slabs`` cuts it
    into views on the camera's card."""
    from nice_slam_torch.ops import frustum as Fm
    from nice_slam_torch.parallel import grid_sharding as gs

    c2w, depth, bound, shapes, H, W, fx, fy, cx, cy = _room_camera(dev)
    dense = Fm.frustum_masks(c2w, depth, bound, shapes, H, W, fx, fy, cx, cy)
    rows = [gs._planes(s[0], 4) * 4 + 1 for s in shapes]
    assert rows[1] > shapes[1][0]  # fine's 74 planes into 4 slabs of 19 (middle's 37 fit 4 x 9)
    padded = Fm.frustum_masks(c2w, depth, bound, shapes, H, W, fx, fy, cx, cy, rows)
    assert padded[1] is padded[2]
    for m, d, r, s in zip(padded, dense, rows, shapes):
        assert torch.equal(m, gs._edge_pad(d, r))
        slabs = gs.mask_to_slabs(m, gs._planes(s[0], 4), 4, [dev] * 4)
        assert all(x.data_ptr() >= m.data_ptr() and x.is_cuda for x in slabs)
        assert sum(x.shape[0] for x in slabs) == r + 3


def test_frustum_kernel_beside_a_busy_stream(dev):
    """K10's cooperative launch on one stream while another stream keeps
    every SM busy (large matrix products after a spin): the launch waits
    for room to hold all its CTAs at once, completes, and gives the
    masks of a launch on an idle card (the co-residency the threaded
    schedules need, where the tracker's kernels run on their own stream).
    The Apartment grids take every resident-CTA slot."""
    from nice_slam_torch.ops import frustum as Fm

    for scene in ("room", "apartment"):
        cam = _room_camera(dev, scene=scene)
        ref = Fm.frustum_masks(*cam)
        a = torch.randn((4096, 4096), device=dev)
        torch.cuda.synchronize()
        busy, side = torch.cuda.Stream(), torch.cuda.Stream()
        with torch.cuda.stream(busy):
            torch.cuda._sleep(50_000_000)
            for _ in range(8):
                a = a @ a / 64.0
        with torch.cuda.stream(side):
            got = Fm.frustum_masks(*cam)
        side.synchronize()
        busy.synchronize()
        for x, y in zip(got, ref):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# K7-K10 on the main path: a tiny strict loop must launch each of them
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_loop_counts(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    from nice_slam_torch.config import load_config
    from nice_slam_torch.ops import frustum as Fm
    from nice_slam_torch.ops import integrator as I
    from nice_slam_torch.slam import mapper as M
    from nice_slam_torch.slam import optim as O
    from nice_slam_torch.slam.slam import NiceSLAM

    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "nice_slam.yaml"))
    cfg.update(coarse=True, verbose=False, meshing=None)
    for k in ("coarse", "middle_fine"):
        cfg["pretrained_decoders"][k] = os.path.join(
            ROOT, cfg["pretrained_decoders"][k])
    cfg["data"].update({"n_frames": 6, "output": str(tmp_path_factory.mktemp("k7k10"))})
    cfg["mapping"].update({"iters_first": 30, "iters": 10})
    slam = NiceSLAM(cfg, argparse.Namespace(nice=True, output=None), "cuda")
    for mod in (I, O, Fm):
        mod.reset_launch_counts()
    inner, calls = M.optimize_map_core, []

    def core(spec, state, colors, depths, fixed_c2w, cam_tensors, opt_cam_mask,
             frame_valid, lr_factor, mcfg, *a, **k):
        calls.append(bool(mcfg.frustum_feature_selection and not mcfg.coarse_mapper))
        return inner(spec, state, colors, depths, fixed_c2w, cam_tensors, opt_cam_mask,
                     frame_valid, lr_factor, mcfg, *a, **k)

    M.optimize_map_core = core
    try:
        slam.run()
    finally:
        M.optimize_map_core = inner
    torch.cuda.synchronize()
    return {**I.launch_counts, **O.launch_counts, **Fm.launch_counts,
            "frustum_calls": sum(calls)}, slam


@pytest.mark.parametrize("kernel", ["integrate_fwd", "integrate_bwd", "group_adam",
                                    "frustum_mask"])
def test_tiny_loop_goes_through_k7_to_k10(tiny_loop_counts, kernel):
    """Each of K7-K10 launched on the slice's loop (0 if the path bypassed
    it): the integrator and the Adam step once per iteration, the frustum
    mask's one launch once per frustum-selecting main-mapper call."""
    counts, slam = tiny_loop_counts
    assert counts[kernel] > 0, counts
    iters = counts["integrate_bwd"]
    assert counts["integrate_fwd"] == iters and counts["group_adam"] == iters
    assert counts["frustum_mask"] == counts["frustum_calls"]
    assert torch.isfinite(slam.estimate_c2w_list).all()


def test_k7_to_k10_follow_the_current_stream(dev):
    """K7-K10 launched on a side stream right after it writes their inputs
    (after a spin) give the results of the default stream's launches."""
    from nice_slam_torch.ops import frustum as Fm
    from nice_slam_torch.ops import integrator as I
    from nice_slam_torch.slam import optim as O

    raw, z, rays_d, cot = _integrator_inputs(dev, 1000, 48, True)
    cam = _room_camera(dev)
    p0 = torch.randn((74, 56, 43, 32), device=dev)
    g0 = torch.randn_like(p0)
    ref_fwd = I.integrate_fwd(raw, z, rays_d, True)
    ref_bwd = I.integrate_bwd(raw, z, rays_d, ref_fwd[0], cot[:, 0].contiguous(),
                              cot[:, 1].contiguous(), cot[:, 2:].contiguous(), True)[0]
    ref_mask = Fm.frustum_masks(*cam)
    ref_p, m, v = p0.clone(), torch.zeros_like(p0), torch.zeros_like(p0)
    O.group_adam([(ref_p, g0, m, v, ref_mask[1], 0.1, 0.001, 0.01)])
    host = [t.cpu().pin_memory() for t in (raw, z, rays_d, cot, p0, g0)]
    side = torch.cuda.Stream()
    for mod in (I, O, Fm):
        mod.reset_launch_counts()
    with torch.cuda.stream(side):
        raw2, z2, d2, cot2, p2, g2 = (torch.empty_like(t, device=dev) for t in host)
        torch.cuda._sleep(100_000_000)
        for dst, src in zip((raw2, z2, d2, cot2, p2, g2), host):
            dst.copy_(src, non_blocking=True)
        fwd = I.integrate_fwd(raw2, z2, d2, True)
        bwd = I.integrate_bwd(raw2, z2, d2, fwd[0], cot2[:, 0].contiguous(),
                              cot2[:, 1].contiguous(), cot2[:, 2:].contiguous(), True)[0]
        masks = Fm.frustum_masks(*cam)
        O.group_adam([(p2, g2, torch.zeros_like(p2), torch.zeros_like(p2), masks[1],
                       0.1, 0.001, 0.01)])
    side.synchronize()
    sid = side.cuda_stream
    assert I.launches_by_stream == {("integrate_fwd", sid): 1, ("integrate_bwd", sid): 1}
    assert O.launches_by_stream == {("group_adam", sid): 1}
    assert Fm.launches_by_stream == {("frustum_mask", sid): 1}
    for a, b in zip(fwd, ref_fwd):
        assert torch.equal(a, b)
    assert torch.equal(bwd, ref_bwd)
    for a, b in zip(masks, ref_mask):
        assert torch.equal(a, b)
    assert torch.equal(p2, ref_p)


# ---------------------------------------------------------------------------
# Bundle adjustment (BA): K3 at mapping shapes, K9's camera leaf, one call
# ---------------------------------------------------------------------------

# the Replica-scale room's grids looked up by a BA mapping iteration's
# stages: middle (1 grid), fine (middle and fine), color (all three)
BA_STAGE_GRIDS = {"map_middle_ba": [(37, 28, 21, 32)],
                  "map_fine_ba": [(37, 28, 21, 32), (74, 56, 43, 32)],
                  "map_color_ba": [(37, 28, 21, 32), (74, 56, 43, 32), (74, 56, 43, 32)]}


@pytest.mark.parametrize("case", list(BA_STAGE_GRIDS))
def test_k3_at_ba_mapping_shapes_matches_plain(dev, case):
    """K3 over a BA mapping iteration's grids at its 48k points (1000 rays
    x 48 samples, a window of five frames over the room): one launch,
    within 1e-4 of the plain gradient's largest entry."""
    gen = torch.Generator().manual_seed(7)
    grids = [torch.randn(s, generator=gen).to(dev) for s in BA_STAGE_GRIDS[case]]
    p = _ray_samples(1000, seed=3).to(dev)
    gs = [torch.randn((p.shape[0], 32), generator=gen).to(dev) for _ in grids]
    interp.reset_launch_counts()
    dp = interp.trilinear_bwd_dp_multi(grids, p, gs)
    torch.cuda.synchronize()
    assert interp.launch_counts["trilinear_bwd_dp"] == 1
    ref = sum(interp.trilinear_bwd_dp_plain(g, p, c) for g, c in zip(grids, gs))
    assert float((dp - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize("stage,cam_lr", [("middle", 0.0), ("color", 1e-3)],
                         ids=["lr0", "ba_cam_lr"])
def test_group_adam_camera_leaf_matches_the_plain_step(dev, stage, cam_lr):
    """K9 with BA's camera leaf (5 window poses x 7) beside a masked grid
    (and, in the color stage, a decoder's leaves) over 20 steps, each from
    the plain state: K9's existing gate against the ``_adam_update`` chain
    (2 epsilons of each value's terms).  At lr 0 the poses stay bit for
    bit and the camera moments still advance, as the color stage's first
    camera step needs them."""
    from nice_slam_torch.slam import optim as O

    gen = torch.Generator().manual_seed(5)
    shapes = [(37, 28, 21, 32), (5, 7)] + ([(32, 35), (4,)] if stage == "color" else [])
    ps = [torch.randn(s, generator=gen).to(dev) for s in shapes]
    masks = [(torch.rand((37, 28, 21, 1), generator=gen) < 0.5).float().to(dev)]
    masks += [None] * (len(shapes) - 1)
    lrs = [0.1, cam_lr] + [1e-3] * (len(shapes) - 2)
    ms = [torch.zeros_like(p) for p in ps]
    vs = [torch.zeros_like(p) for p in ps]
    cams0 = ps[1].clone()
    worst = 0.0
    for step in range(1, 21):
        gs = [torch.randn(s, generator=gen).to(dev) for s in shapes]
        bc1 = float(np.float32(1) - np.float32(0.9) ** np.float32(step))
        bc2 = float(np.float32(1) - np.float32(0.999) ** np.float32(step))
        mine = [[t.clone() for t in (p, m, v)] for p, m, v in zip(ps, ms, vs)]
        O.group_adam([(p, g, m, v, k, bc1, bc2, lr) for (p, m, v), g, k, lr
                      in zip(mine, gs, masks, lrs)])
        for i, (g, k, lr) in enumerate(zip(gs, masks, lrs)):
            g = g if k is None else g * k
            p0, m0, v0 = ps[i].clone(), ms[i].clone(), vs[i].clone()
            O._adam_update([ps[i]], [g], [ms[i]], [vs[i]], bc1, bc2, lr)
            sm = (0.9 * m0).abs() + (0.1 * g).abs()
            sv = (0.999 * v0).abs() + (0.001 * g * g).abs()
            denom = torch.sqrt(vs[i] / bc2) + 1e-8
            u = (ms[i] / bc1) / denom
            sp = p0.abs() + abs(lr) * (u.abs() + sm / (bc1 * denom))
            for got, want, scale in zip(mine[i], (ps[i], ms[i], vs[i]), (sp, sm, sv)):
                worst = max(worst, _ulps_of(got, want, scale))
        if cam_lr == 0.0:
            assert torch.equal(mine[1][0], cams0)
    assert worst <= 2.0
    assert float(ms[1].abs().min()) > 0.0


def test_ba_mapping_call_on_cuda_matches_cpu(dev):
    """One BA optimize_map call (middle 2, fine 2, color 3 iterations over a
    3-frame window, the oldest pose fixed) on the card against the same
    call on the CPU port with the same pixels: losses within 1e-4
    relative, the window poses within 1e-5, the oldest equal.  Grids:
    K2 sums with atomics, and Adam moves an entry by about lr per step
    whatever its gradient's size, so an entry whose gradient is ~0 on both
    devices can step either way on rounding alone: at least 99.9 % of
    each grid's entries within 1e-4 and every entry within the call's
    step budget, as tests/test_torch_mapper.py holds the port against
    JAX."""
    from nice_slam_torch.config import load_config
    from nice_slam_torch.convert import scene_from_jax, scene_to_numpy
    from nice_slam_torch.models.pretrain import load_pretrain
    from nice_slam_torch.models.scene import build_scene
    from nice_slam_torch.ops.geometry import tensor_from_pose
    from nice_slam_torch.ops.render import RenderConfig
    from nice_slam_torch.slam import mapper as M
    from nice_slam_torch.utils.datasets import Synthetic

    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "nice_slam.yaml"))
    cfg["verbose"] = False
    cfg["cam"].update({"H": 60, "W": 80, "fx": 60.0, "fy": 60.0, "cx": 39.5, "cy": 29.5})
    cfg["rendering"].update({"N_samples": 12, "N_surface": 6})
    cfg["data"]["n_frames"] = 10
    for k in ("coarse", "middle_fine"):
        cfg["pretrained_decoders"][k] = os.path.join(ROOT, cfg["pretrained_decoders"][k])
    spec, state = build_scene(cfg, nice=True, seed=1, device="cpu")
    state = load_pretrain(cfg, spec, state, verbose=False)
    ds = Synthetic(cfg)
    frames = [ds[i] for i in (0, 2, 4)]
    colors = torch.tensor(np.stack([f[1] for f in frames]))
    depths = torch.tensor(np.stack([f[2] for f in frames]))
    c2w = torch.tensor(np.stack([f[3] for f in frames]))
    c2w[1:, :3, 3] += torch.tensor([[0.02, -0.01, 0.015], [-0.015, 0.02, 0.01]])
    mcfg = M.MapperConfig.from_cfg(cfg, cfg["cam"], True)
    rcfg = RenderConfig.from_cfg(cfg)
    plan = (("middle", 2), ("fine", 2), ("color", 3))
    F, n, iters = 3, 60, 7
    pix = torch.randint(0, 60 * 80, (iters, F, n), generator=torch.Generator().manual_seed(8))
    out = []
    for d in ("cpu", dev):
        st = scene_from_jax(scene_to_numpy(state), d)
        args = [x.to(d) for x in (colors, depths, c2w, tensor_from_pose(c2w),
                                  torch.tensor([0.0, 1.0, 1.0]),
                                  torch.ones(F, dtype=torch.bool))]
        new, cams, losses = M.optimize_map_core(
            spec, st, *args, 1.0, mcfg, rcfg, plan, True, n, pix_idx=pix.to(d))
        out.append((losses.cpu(), cams.cpu(), {k: v.cpu() for k, v in new.grids.items()}))
    (l_c, c_c, g_c), (l_d, c_d, g_d) = out
    torch.testing.assert_close(l_d, l_c, rtol=1e-4, atol=0)
    assert torch.equal(c_d[0], c_c[0])
    assert float((c_c[1:] - tensor_from_pose(c2w)[1:]).abs().max()) > 1e-4
    torch.testing.assert_close(c_d, c_c, atol=1e-5, rtol=0)
    # the step budget: the sum of a grid's lr over the call's iterations
    budgets = {name: sum(mcfg.stage_lr[M.STAGE_INDEX[s]][M.LR_KEYS.index(name[5:] + "_lr")]
                         * m for s, m in plan)
               for name in ("grid_middle", "grid_fine", "grid_color")}
    for name, budget in budgets.items():
        diff = (g_d[name] - g_c[name]).abs()
        assert float((diff <= 1e-4).float().mean()) >= 0.999, name
        assert float(diff.max()) <= 2 * budget, name

