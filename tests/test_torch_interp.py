"""The port's trilinear lookup (K1 forward, K2 grid gradient, K3 point
gradient) against the JAX package's custom VJP, on the CPU where the port
runs each kernel's plain version.  The multi-grid lookup
(``trilinear_interp_multi``, one autograd Function per decoder stage) is
held to the separate one-grid lookups and, grid by grid, to JAX.

The JAX side runs with the exact-f32 grid-gradient buffer
(``_DGRAD_BF16=False``), so both of its dgrid strategies are held to
atol 1e-5: the one-hot matmul for grids of at most ``_MATMUL_V_MAX``
cells and the cell-block scatter above that.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nice_slam_tpu.ops import interp as jinterp
from nice_slam_torch.ops import interp as tinterp

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

ATOL = 1e-5


def _points(rng, n, shape):
    """Random points past every face plus exact ties: the box corners
    (raw == 0 and raw == S-1) and points on interior grid nodes."""
    p = rng.uniform(-1.6, 1.6, (n, 3)).astype(np.float32)
    nodes = []
    for k in range(1, 3):
        nodes.append([2.0 * k / (s - 1) - 1.0 for s in shape[:3]])
    special = np.array([[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0], [2.0, 0.0, 0.0],
                        [0.0, -3.0, 1.0], [1.0, 0.3, -0.2], [-1.0, 0.5, 1.0]]
                       + nodes, np.float32)
    return np.concatenate([p, special])


@pytest.mark.parametrize("shape", [(17, 16, 18, 8), (6, 9, 7, 8)],
                         ids=["scatter_gt4096", "matmul_le4096"])
def test_trilinear_fwd_and_grads_match_jax(monkeypatch, shape):
    monkeypatch.setattr(jinterp, "_DGRAD_BF16", False)
    V = shape[0] * shape[1] * shape[2]
    assert (V > jinterp._MATMUL_V_MAX) == (shape[0] == 17)
    rng = np.random.default_rng(0)
    grid = rng.standard_normal(shape).astype(np.float32)
    p = _points(rng, 300, shape)
    cot = rng.standard_normal((p.shape[0], shape[3])).astype(np.float32)

    fj = jinterp.trilinear_interp(jnp.asarray(grid), jnp.asarray(p))
    gj = jax.grad(lambda g, pp: jnp.sum(
        jinterp.trilinear_interp_explicit_vjp(g, pp) * cot),
        argnums=(0, 1))(jnp.asarray(grid), jnp.asarray(p))

    gt = torch.tensor(grid, requires_grad=True)
    pt = torch.tensor(p, requires_grad=True)
    ft = tinterp.trilinear_interp(gt, pt)
    (ft * torch.tensor(cot)).sum().backward()

    np.testing.assert_allclose(ft.detach().numpy(), np.asarray(fj), atol=ATOL)
    np.testing.assert_allclose(gt.grad.numpy(), np.asarray(gj[0]), atol=ATOL)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(gj[1]), atol=ATOL)


def test_clamped_corner_adds_nothing_to_neighbours():
    """A point on the +x face: its clamped +1 corners have weight 0, so the
    grid gradient lands only on the face's own cells."""
    shape = (4, 5, 6, 4)
    p = torch.tensor([[1.0, 0.0, 0.0]])
    g = torch.ones(1, 4)
    d = tinterp.trilinear_bwd_dgrid_plain(p, g, shape)
    assert float(d[:-1].abs().sum()) == 0.0
    np.testing.assert_allclose(float(d.sum()), 4.0, atol=1e-6)


def test_backward_runs_only_the_needed_gradient(monkeypatch):
    """Frozen grid (tracking): K3 only.  Frozen points: K2 only."""
    rng = np.random.default_rng(1)
    grid = torch.tensor(rng.standard_normal((5, 5, 5, 4)), dtype=torch.float32)
    p = torch.tensor(rng.uniform(-1, 1, (20, 3)), dtype=torch.float32)

    def boom(*a, **k):
        raise AssertionError("gradient kernel ran although not needed")

    pg = p.clone().requires_grad_(True)
    with monkeypatch.context() as m:
        m.setattr(tinterp, "trilinear_bwd_dgrid_multi", boom)
        tinterp.trilinear_interp(grid, pg).sum().backward()
    assert pg.grad is not None
    gg = grid.clone().requires_grad_(True)
    with monkeypatch.context() as m:
        m.setattr(tinterp, "trilinear_bwd_dp_multi", boom)
        tinterp.trilinear_interp(gg, p).sum().backward()
    assert gg.grad is not None


def test_cpu_tensors_take_the_plain_path_without_counting():
    tinterp.reset_launch_counts()
    grid = torch.randn(4, 4, 4, 4, requires_grad=True)
    p = torch.rand(10, 3, requires_grad=True)
    tinterp.trilinear_interp(grid, p).sum().backward()
    assert all(v == 0 for v in tinterp.launch_counts.values())


def test_sample_grid_feature_matches_jax():
    rng = np.random.default_rng(2)
    grid = rng.standard_normal((8, 7, 9, 4)).astype(np.float32)
    bound = np.array([[-2.0, 2.0], [0.0, 4.0], [-1.0, 3.0]], np.float32)
    pw = rng.uniform(-3, 5, (64, 3)).astype(np.float32)
    ref = jinterp.sample_grid_feature(jnp.asarray(grid), jnp.asarray(pw),
                                      jnp.asarray(bound))
    got = tinterp.sample_grid_feature(torch.tensor(grid), torch.tensor(pw),
                                      torch.tensor(bound))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_bilinear_sample_2d_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 5, (12, 17)).astype(np.float32)
    u = rng.uniform(-3, 20, 200).astype(np.float32)
    v = rng.uniform(-3, 15, 200).astype(np.float32)
    ref = jinterp.bilinear_sample_2d(jnp.asarray(img), jnp.asarray(u),
                                     jnp.asarray(v))
    got = tinterp.bilinear_sample_2d(torch.tensor(img), torch.tensor(u),
                                     torch.tensor(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


MULTI_SHAPES = [(17, 16, 18, 8), (6, 9, 7, 8), (5, 4, 6, 8)]


@pytest.mark.parametrize("n_grids", [1, 2, 3])
def test_multi_lookup_equals_separate_lookups(n_grids):
    """Features, each grid's gradient and the dp summed over the grids."""
    rng = np.random.default_rng(6)
    shapes = MULTI_SHAPES[:n_grids]
    grids = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    p = _points(rng, 200, shapes[0])
    cots = [rng.standard_normal((p.shape[0], s[3])).astype(np.float32)
            for s in shapes]

    gm = [torch.tensor(g, requires_grad=True) for g in grids]
    pm = torch.tensor(p, requires_grad=True)
    feats = tinterp.trilinear_interp_multi(gm, pm)
    sum((f * torch.tensor(c)).sum() for f, c in zip(feats, cots)).backward()

    gs = [torch.tensor(g, requires_grad=True) for g in grids]
    ps = torch.tensor(p, requires_grad=True)
    sep = [tinterp.trilinear_interp(g, ps) for g in gs]
    sum((f * torch.tensor(c)).sum() for f, c in zip(sep, cots)).backward()

    for a, b in zip(feats, sep):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    for a, b in zip(gm, gs):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-6, rtol=0)
    torch.testing.assert_close(pm.grad, ps.grad, atol=1e-5, rtol=1e-6)


def test_multi_lookup_matches_jax_per_grid(monkeypatch):
    """Grids above and below 4096 cells in one lookup, points past every
    face and on exact ties: each feature and grid gradient against JAX's
    trilinear_interp at exact f32, and dp against the gradient of the sum."""
    monkeypatch.setattr(jinterp, "_DGRAD_BF16", False)
    shapes = MULTI_SHAPES[:2]
    assert [s[0] * s[1] * s[2] > jinterp._MATMUL_V_MAX for s in shapes] == [True, False]
    rng = np.random.default_rng(7)
    grids = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    p = np.concatenate([_points(rng, 150, s) for s in shapes])
    cots = [rng.standard_normal((p.shape[0], s[3])).astype(np.float32)
            for s in shapes]

    def loss(gl, pp):
        return sum(jnp.sum(jinterp.trilinear_interp_explicit_vjp(g, pp) * c)
                   for g, c in zip(gl, cots))

    jg = [jnp.asarray(g) for g in grids]
    dgj, dpj = jax.grad(loss, argnums=(0, 1))(jg, jnp.asarray(p))

    gt = [torch.tensor(g, requires_grad=True) for g in grids]
    pt = torch.tensor(p, requires_grad=True)
    feats = tinterp.trilinear_interp_multi(gt, pt)
    sum((f * torch.tensor(c)).sum() for f, c in zip(feats, cots)).backward()

    for f, g, d, gj, dj in zip(feats, grids, gt, jg, dgj):
        ref = jinterp.trilinear_interp(gj, jnp.asarray(p))
        np.testing.assert_allclose(f.detach().numpy(), np.asarray(ref), atol=ATOL)
        np.testing.assert_allclose(d.grad.numpy(), np.asarray(dj), atol=ATOL)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(dpj), atol=ATOL)


def test_multi_lookup_skips_grids_without_a_cotangent():
    """A detached feature (the middle feature fed to the fine decoder)
    gives its grid no gradient and adds nothing to dp."""
    rng = np.random.default_rng(8)
    a = torch.tensor(rng.standard_normal((5, 6, 7, 4)), dtype=torch.float32,
                     requires_grad=True)
    b = torch.tensor(rng.standard_normal((4, 4, 4, 4)), dtype=torch.float32,
                     requires_grad=True)
    p = torch.tensor(rng.uniform(-1, 1, (30, 3)), dtype=torch.float32,
                     requires_grad=True)
    fa, fb = tinterp.trilinear_interp_multi([a, b], p)
    (fa.sum() + 0.0 * fb.detach().sum()).backward()
    assert b.grad is None
    pa = p.detach().clone().requires_grad_(True)
    tinterp.trilinear_interp(a.detach(), pa).sum().backward()
    torch.testing.assert_close(p.grad, pa.grad, atol=0, rtol=0)


def test_tracking_never_runs_k2_and_runs_k3_once_per_iteration(monkeypatch):
    """One tracking iteration (pose gradient, frozen grids) on the port's
    own box scene: no grid-gradient call, one point-gradient call over the
    stage's three grids."""
    from nice_slam_torch.config import load_config
    from nice_slam_torch.models.pretrain import load_pretrain
    from nice_slam_torch.models.scene import build_scene
    from nice_slam_torch.ops.geometry import tensor_from_pose
    from nice_slam_torch.ops.render import RenderConfig
    from nice_slam_torch.slam import tracker
    from nice_slam_torch.utils.datasets import Synthetic

    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "nice_slam.yaml"))
    cfg["cam"].update({"H": 24, "W": 32, "fx": 24.0, "fy": 24.0, "cx": 15.5,
                       "cy": 11.5})
    cfg["tracking"].update({"pixels": 32, "iters": 1, "ignore_edge_W": 2,
                            "ignore_edge_H": 2})
    cfg["rendering"].update({"N_samples": 8, "N_surface": 4})
    cfg["data"]["n_frames"] = 3
    for k in ("coarse", "middle_fine"):
        cfg["pretrained_decoders"][k] = os.path.join(
            ROOT, cfg["pretrained_decoders"][k])
    spec, state = build_scene(cfg, device="cpu")
    state = load_pretrain(cfg, spec, state, verbose=False)
    tcfg = tracker.TrackerConfig.from_cfg(cfg, cfg["cam"], True)
    _, color, depth, c2w = Synthetic(cfg)[1]
    pix = [torch.tensor(a[0]) for a in
           tracker.presample_pixels(0, 1, tcfg, color, depth)]

    calls = []
    dp_multi = tinterp.trilinear_bwd_dp_multi

    def counted(grids, p, gs):
        calls.append(len(grids))
        return dp_multi(grids, p, gs)

    def boom(*a, **k):
        raise AssertionError("grid gradient computed during tracking")

    monkeypatch.setattr(tinterp, "trilinear_bwd_dp_multi", counted)
    monkeypatch.setattr(tinterp, "trilinear_bwd_dgrid_multi", boom)
    cam = tensor_from_pose(torch.tensor(c2w)).requires_grad_(True)
    loss = tracker.tracking_loss_sampled(spec, state, cam, *pix, tcfg,
                                         RenderConfig.from_cfg(cfg))
    (g,) = torch.autograd.grad(loss, cam)
    assert calls == [3]
    assert torch.isfinite(g).all() and float(g.abs().sum()) > 0

