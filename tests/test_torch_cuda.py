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
import os

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
    assert interp.launch_counts == {"trilinear_fwd": 3, "trilinear_bwd_dgrid": 0,
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
    interp.reset_launch_counts()
    slam.run()
    assert all(v > 0 for v in interp.launch_counts.values()), interp.launch_counts
    assert torch.isfinite(slam.estimate_c2w_list).all()
