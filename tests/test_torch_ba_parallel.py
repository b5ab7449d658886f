"""Bundle adjustment (BA) on the parallel paths and on iMAP*, in the port
against the JAX package, on the CPU (the port's kernels in their plain
versions, the JAX package on the conftest's virtual CPU devices).

Every case feeds both packages the JAX call's own pixel draws: the JAX
mapper draws them from its key inside ``optimize_map_jit``, and the port's
``optimize_map_core`` is handed them (``pix_idx``), as
``tests/test_torch_ba.py`` does.  The window holds two keyframes and the
current frame, the second keyframe and the current frame off their true
poses, so BA has a pose to move beside the oldest one, which stays fixed.

(1) One BA ``Mapper.optimize_map`` call (middle 3, fine 1, color 2
    iterations, frustum masks on) with the grids sharded over 3 CPU slabs
    against the dense call: losses rtol 1e-4, grids and decoders atol 5e-4
    (the tolerances of ``test_torch_grid_sharding.py``'s BA-off case),
    the written-back keyframe pose and the refined current pose within
    1e-6, the halo planes bitwise equal, the oldest keyframe's pose bit for
    bit; and the slabs' point gradients (K3) summed in device order on the
    points' device, each slab's zero on the points it does not own.
(2) The port's sharded call against the JAX package's sharded call
    (``nice_slam_tpu.parallel.grid_sharding`` over a 3-device mesh):
    losses rtol 1e-4, poses within 1e-5.
(3) The dense call with its rays split over ``["cpu"] * 2`` (ray data
    parallelism) against the one-device call: losses rtol 1e-4, poses
    within 1e-6; ``over_blocks`` ran in every iteration.
(4) One iMAP* ``optimize_map_core`` call with BA (4 color iterations,
    given ``pix_idx`` and ``reg_t``) against the JAX call: losses rtol 1e-5
    (the BA-off case of ``test_torch_imap.py``), the refined poses within
    1e-6 and the MLP's output layer within 1e-5 absolute; the camera
    learning rate is BA_cam_lr in every iteration.
"""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nice_slam_tpu.config import load_config
from nice_slam_tpu.models import scene as jscene
from nice_slam_tpu.ops.render import RenderConfig as JRender
from nice_slam_tpu.parallel import grid_sharding as jgs
from nice_slam_tpu.parallel.sharding import make_mesh
from nice_slam_tpu.slam import mapper as jm
from nice_slam_tpu.slam.keyframes import KeyframeStore as JKeyframes
from nice_slam_tpu.utils.datasets import Synthetic
from nice_slam_torch.convert import scene_from_jax, scene_to_numpy
from nice_slam_torch.models import scene as tscene
from nice_slam_torch.ops import interp as tinterp
from nice_slam_torch.ops.render import RenderConfig as TRender
from nice_slam_torch.parallel import grid_sharding as tgs
from nice_slam_torch.slam import mapper as tm
from nice_slam_torch.slam.keyframes import KeyframeStore as TKeyframes
from nice_slam_torch.slam.optim import tree_leaves

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CPU = torch.device("cpu")
H, W = 24, 32
SLABS = 3
ITERS = 6  # middle 3, fine 1, color 2 at the ratios below
# the second keyframe's and the current frame's offsets from their true
# positions (m): the camera gradients are then large
OFFSETS = np.array([[0.03, -0.02, 0.02], [-0.02, 0.03, 0.01]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several test workers share few cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pixel_draws(key, n_iters, F, n):
    """The flat pixel indices optimize_map_jit draws: per global iteration
    i, fold_in(key, i) -> split -> split(F) -> randint over H*W."""
    out = []
    for i in range(n_iters):
        k_frames, _ = jax.random.split(jax.random.fold_in(key, i))
        fk = jax.random.split(k_frames, F)
        out.append(np.stack([np.asarray(jax.random.randint(fk[f], (n,), 0, H * W))
                             for f in range(F)]))
    return np.stack(out)


def _nice_cfg():
    cam = {"H": H, "W": W, "fx": 24.0, "fy": 24.0, "cx": 15.5, "cy": 11.5}
    return {
        "dataset": "synthetic", "scale": 1, "occupancy": True, "coarse": False,
        "grid_len": {"coarse": 1.2, "middle": 0.6, "fine": 0.3, "color": 0.3,
                     "bound_divisible": 0.6},
        "model": {"c_dim": 8, "coarse_bound_enlarge": 2,
                  "pos_embedding_method": "fourier"},
        "data": {"dim": 3, "n_frames": 4, "room": [[-1.8, 1.8]] * 3},
        "mapping": {
            "bound": [[-1.8, 1.8]] * 3,
            "pixels": 96, "iters": ITERS, "iters_first": ITERS, "every_frame": 1,
            "keyframe_every": 1, "mapping_window_size": 4,
            "middle_iter_ratio": 0.4, "fine_iter_ratio": 0.6,
            "w_color_loss": 0.2, "BA": True, "BA_cam_lr": 0.001,
            "fix_fine": False, "fix_color": False,
            "frustum_feature_selection": True,
            "keyframe_selection_method": "global",
            "lr_first_factor": 5, "lr_factor": 1, "color_refine": False,
            "stage": {s: {"decoders_lr": 0.001, "coarse_lr": 0.001, "middle_lr": 0.1,
                          "fine_lr": 0.01, "color_lr": 0.01}
                      for s in ("coarse", "middle", "fine", "color")},
        },
        "cam": dict(cam, png_depth_scale=1.0, crop_edge=0),
        "rendering": {"N_samples": 8, "N_surface": 4, "N_importance": 0,
                      "lindisp": False, "perturb": 0.0},
    }


def _frames(cfg):
    """Frames 0, 1 and 2 of the synthetic scene as (color, depth, true c2w,
    estimated c2w): frames 1 and 2 estimated off the truth."""
    ds = Synthetic(cfg)
    out = []
    for i in (0, 1, 2):
        _, c, d, p = ds[i]
        est = np.array(p, np.float32)
        if i:
            est[:3, 3] += OFFSETS[i - 1]
        out.append((np.asarray(c, np.float32), np.asarray(d, np.float32),
                    np.asarray(p, np.float32), est))
    return out


def _port_call(tspec, state, mcfg, rcfg, frames, pix, devices=None):
    """The port's Mapper.optimize_map on a store of frames 0 and 1 for
    frame 2, with every iteration's pixels given.  Returns (new state,
    refined current pose, losses, the store's poses after the call,
    over_blocks calls)."""
    store = TKeyframes(4, H, W, "cpu")
    for i, (c, d, p, est) in enumerate(frames[:2]):
        store.add(i, torch.tensor(c), torch.tensor(d), torch.tensor(est), torch.tensor(p))
    mapper = tm.Mapper(tspec, mcfg, rcfg, "cpu", seed=11)
    mapper.devices = devices
    inner_core, inner_blocks = tm.optimize_map_core, tm.over_blocks
    blocks = []

    def core(*a, **k):
        k["pix_idx"] = torch.tensor(pix)
        return inner_core(*a, **k)

    def over_blocks(devs, *a):
        blocks.append(len(devs))
        return inner_blocks(devs, *a)

    c, d, _, est = frames[2]
    tm.optimize_map_core, tm.over_blocks = core, over_blocks
    try:
        new_state, cur, losses = mapper.optimize_map(
            state, ITERS, 1.0, torch.tensor(c), torch.tensor(d), store,
            torch.tensor(est), BA=True)
    finally:
        tm.optimize_map_core, tm.over_blocks = inner_core, inner_blocks
    return new_state, cur.numpy(), losses.numpy(), store.arrays.est_c2w[:2].numpy(), blocks


@pytest.fixture(scope="module")
def nice():
    """The JAX package's sharded BA call (its pixel draws recorded), then
    the port's dense and sharded calls on those draws."""
    cfg = _nice_cfg()
    cam = {k: cfg["cam"][k] for k in ("H", "W", "fx", "fy", "cx", "cy")}
    jspec, jstate = jscene.build_scene(cfg, nice=True, seed=5)
    tspec, _ = tscene.build_scene(cfg, nice=True, device="cpu")
    tstate = scene_from_jax(jax.tree.map(np.asarray, jstate), CPU)
    frames = _frames(cfg)

    draws = []
    inner = jm.optimize_map_jit
    sig = inspect.signature(inner)

    def recorded(*a, **k):
        b = sig.bind(*a, **k).arguments
        n_iters = sum(n for _, n in b["stage_plan"])
        draws.append(_pixel_draws(b["key"], n_iters, b["colors"].shape[0],
                                  b["pixs_per_image"]))
        return inner(*a, **k)

    jstore = JKeyframes(4, H, W)
    for i, (c, d, p, est) in enumerate(frames[:2]):
        jstore.add(i, c, d, est, p)
    mesh = make_mesh(SLABS)
    jsharded = jstate._replace(grids=jgs.shard_scene_grids(jstate.grids, mesh))
    jmapper = jm.Mapper(jspec, jm.MapperConfig.from_cfg(cfg, cam, nice=True),
                        JRender.from_cfg(cfg), seed=11)
    c, d, p, est = frames[2]
    jm.optimize_map_jit = recorded
    try:
        _, jcur, jl = jmapper.optimize_map(jsharded, ITERS, 1.0, 2, c, d, p, jstore, est,
                                           BA=True)
    finally:
        jm.optimize_map_jit = inner
    assert len(draws) == 1
    jax_out = (np.asarray(jcur), np.asarray(jl), np.asarray(jstore.arrays.est_c2w)[:2])

    mcfg = tm.MapperConfig.from_cfg(cfg, cam, nice=True)
    rcfg = TRender.from_cfg(cfg)
    dense = _port_call(tspec, tstate, mcfg, rcfg, frames, draws[0])
    sharded_in = tstate._replace(grids=tgs.shard_scene_grids(tstate.grids, [CPU] * SLABS))
    sharded = _port_call(tspec, sharded_in, mcfg, rcfg, frames, draws[0])
    return dict(cfg=cfg, tspec=tspec, tstate=tstate, mcfg=mcfg, rcfg=rcfg, frames=frames,
                pix=draws[0], jax=jax_out, dense=dense, sharded=sharded)


def test_ba_over_slabs_matches_the_dense_call(nice):
    """(1) The sharded BA call against the dense one."""
    d_state, d_cur, d_l, d_kf, _ = nice["dense"]
    s_state, s_cur, s_l, s_kf, _ = nice["sharded"]
    frames = nice["frames"]
    assert np.all(np.isfinite(s_l)) and s_l.shape == (ITERS,)
    np.testing.assert_allclose(s_l, d_l, rtol=1e-4)
    for k, sg in s_state.grids.items():
        assert isinstance(sg, tgs.ShardedGrid) and sg.D == SLABS, k
        for lo, hi in zip(sg.slabs[:-1], sg.slabs[1:]):
            assert torch.equal(lo[-1], hi[0]), f"{k}: halo planes diverged"
        np.testing.assert_allclose(tgs.unshard_grid(sg).numpy(), d_state.grids[k].numpy(),
                                   atol=5e-4, err_msg=k)
    for dec in ("fine", "color"):
        for a, b in zip(tree_leaves(s_state.decoders[dec]),
                        tree_leaves(d_state.decoders[dec])):
            a, b = a.numpy(), b.numpy()
            np.testing.assert_allclose(a, b, atol=5e-4, err_msg=dec)
    # the oldest keyframe's pose untouched, the second written back, the
    # current frame refined: each as in the dense call
    for kf in (s_kf, d_kf):
        np.testing.assert_array_equal(kf[0], frames[0][3])
        assert np.abs(kf[1] - frames[1][3]).max() > 1e-5
    assert np.abs(s_cur - frames[2][3]).max() > 1e-5
    np.testing.assert_allclose(s_kf, d_kf, atol=1e-6, rtol=0)
    np.testing.assert_allclose(s_cur, d_cur, atol=1e-6, rtol=0)


def test_ba_over_slabs_matches_the_jax_sharded_call(nice):
    """(2) The port's sharded BA call against the JAX package's."""
    jcur, jl, jkf = nice["jax"]
    _, s_cur, s_l, s_kf, _ = nice["sharded"]
    np.testing.assert_allclose(s_l, jl, rtol=1e-4)
    np.testing.assert_array_equal(jkf[0], nice["frames"][0][3])
    np.testing.assert_allclose(s_kf, jkf, atol=1e-5, rtol=0)
    np.testing.assert_allclose(s_cur, jcur, atol=1e-5, rtol=0)


def test_ba_point_gradient_sums_over_slabs_in_device_order(nice):
    """The sharded lookup's point gradient at a BA mapping shape (the color
    stage's three grids, cut at different planes): each slab's K3 (plain
    version) is zero on the points it does not own in a grid, every point
    has one owner per grid, and autograd hands back the slabs' gradients
    summed in device order on the points' device, bit for bit, within
    1e-6 of the dense gradient's largest entry."""
    rng = np.random.default_rng(3)
    names = ("grid_middle", "grid_fine", "grid_color")
    grids = [nice["tstate"].grids[k] for k in names]
    n = 4000
    p = torch.tensor(rng.uniform(-1.05, 1.05, (n, 3)).astype(np.float32))
    gs = [torch.tensor(rng.normal(size=(n, g.shape[3])).astype(np.float32))
          for g in grids]
    dense = tinterp.trilinear_bwd_dp_multi(grids, p, gs)
    sharded = [tgs.shard_grid(g, [CPU] * SLABS) for g in grids]
    parts = []
    for sg, g in zip(sharded, gs):
        owners = torch.zeros(n, dtype=torch.int64)
        for d in range(SLABS):
            w = sg.window(d)
            part = tinterp.trilinear_bwd_dp(sg.slabs[d], p, g, w)
            own = tinterp._slab_corners(sg.slabs[d].shape, w, p)[4]
            assert torch.equal(part[~own], torch.zeros_like(part[~own]))
            owners += own.to(torch.int64)
        assert torch.equal(owners, torch.ones_like(owners))
    for d in range(SLABS):
        parts.append(tinterp.trilinear_bwd_dp_multi(
            [sg.slabs[d] for sg in sharded], p, gs, [sg.window(d) for sg in sharded]))
    in_order = parts[0] + parts[1] + parts[2]
    q = p.clone().requires_grad_(True)
    feats = tgs.sharded_trilinear_interp_multi(sharded, q)
    got, = torch.autograd.grad(sum(torch.sum(f * g) for f, g in zip(feats, gs)), [q])
    assert torch.equal(got, in_order)
    assert float((got - dense).abs().max()) <= 1e-6 * float(dense.abs().max())


def test_ba_under_ray_data_parallelism_matches_one_device(nice):
    """(3) The dense BA call with its rays split over two CPU replicas
    against the one-device call on the same pixels."""
    _, cur, losses, kf, blocks = _port_call(
        nice["tspec"], nice["tstate"], nice["mcfg"], nice["rcfg"], nice["frames"],
        nice["pix"], devices=[CPU, CPU])
    _, d_cur, d_l, d_kf, d_blocks = nice["dense"]
    assert blocks == [2] * ITERS and d_blocks == []  # the split happened
    np.testing.assert_allclose(losses, d_l, rtol=1e-4)
    np.testing.assert_array_equal(kf[0], nice["frames"][0][3])
    np.testing.assert_allclose(kf, d_kf, atol=1e-6, rtol=0)
    np.testing.assert_allclose(cur, d_cur, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# (4) iMAP* with BA
# ---------------------------------------------------------------------------

def _imap_reg_draws(key, F, n, N):
    """The regulariser's jitter one JAX mapping_loss call draws from its key."""
    _, k_reg = jax.random.split(key)
    return np.asarray(jax.random.uniform(k_reg, (F * n, N)))


def test_imap_ba_call_matches_jax(monkeypatch):
    """(4) iMAP*'s camera gradient through the MLP, the importance pass, the
    swapped-argument regulariser and the density-mode integrator: four
    iterations of a BA call against the JAX call on its own draws."""
    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "imap.yaml"))
    cfg["verbose"] = False
    cfg["cam"].update({"H": H, "W": W, "fx": 24.0, "fy": 24.0, "cx": 15.5, "cy": 11.5})
    cfg["rendering"].update({"N_samples": 8, "N_importance": 4})
    cfg["data"]["n_frames"] = 6
    cam = cfg["cam"]
    jspec, jstate = jscene.build_scene(cfg, nice=False, seed=3)
    tspec, _ = tscene.build_scene(cfg, nice=False, seed=9, device="cpu")
    tstate = scene_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    ds = Synthetic(cfg, scale=cfg["scale"])
    fr = [ds[i] for i in (0, 2, 4)]
    colors = np.stack([f[1] for f in fr])
    depths = np.stack([f[2] for f in fr])
    c2w = np.stack([f[3] for f in fr]).astype(np.float32)
    # at the configs' 0.1 scale: offsets of a few mm
    c2w[1:, :3, 3] += 0.1 * OFFSETS
    F, n, N, iters = 3, 16, cfg["rendering"]["N_samples"], 4
    key = jax.random.PRNGKey(8)
    cams = np.asarray(jax.vmap(jm.tensor_from_pose)(jnp.asarray(c2w)))
    opt, valid = np.array([0, 1, 1], np.float32), np.ones(F, bool)
    plan = (("color", iters),)
    jmc = jm.MapperConfig.from_cfg(cfg, cam, False)
    js, jc, jl, _ = jm.optimize_map_jit(
        jspec, jstate, jnp.asarray(colors), jnp.asarray(depths), jnp.asarray(c2w),
        jnp.asarray(cams), jnp.asarray(opt), jnp.asarray(valid), None,
        jnp.asarray(1.0, jnp.float32), key, None, jmc, JRender.from_cfg(cfg), plan, True, n)
    pix = _pixel_draws(key, iters, F, n)
    reg_t = np.stack([_imap_reg_draws(jax.random.fold_in(key, i), F, n, N)
                      for i in range(iters)])

    cam_lrs = []

    class Recorded(tm.GroupAdam):
        def step(self, grads, lrs, active, masks=None):
            assert active["cams"] and active["dec"]
            cam_lrs.append(lrs["cams"])
            return super().step(grads, lrs, active, masks)

    monkeypatch.setattr(tm, "GroupAdam", Recorded)
    tmc = tm.MapperConfig.from_cfg(cfg, cam, False)
    ts, tc, tl = tm.optimize_map_core(
        tspec, tstate, torch.tensor(colors), torch.tensor(depths), torch.tensor(c2w),
        torch.tensor(cams), torch.tensor(opt), torch.tensor(valid), 1.0, tmc,
        TRender.from_cfg(cfg), plan, True, n, pix_idx=torch.tensor(pix),
        reg_t=torch.tensor(reg_t))
    assert cam_lrs == [cfg["mapping"]["BA_cam_lr"]] * iters and cam_lrs[0] > 0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    tc, jc = tc.numpy(), np.asarray(jc)
    np.testing.assert_array_equal(tc[0], cams[0])  # the oldest stays fixed
    assert np.abs(tc[1:] - cams[1:]).max() > 1e-5  # the camera moved
    np.testing.assert_allclose(tc, jc, atol=1e-6, rtol=0)
    out = scene_to_numpy(ts)["decoders"]["output_linear"]
    ref = jax.tree.map(np.asarray, js.decoders)["output_linear"]
    for k in ("w", "b"):
        np.testing.assert_allclose(out[k], ref[k], atol=1e-5, err_msg=k)
