"""The port's spatially sharded grid store (``nice_slam_torch/parallel/
grid_sharding.py``) against the JAX package's, case for case with
``tests/test_grid_sharding.py``: the JAX side on the conftest's virtual
CPU devices, the port over ``devices=[cpu] * D``, both fed the same numpy
inputs.

D runs over 2, 3 and 8 slabs and nx over 29 and 5 planes (not divisible
by D, and fewer planes than slabs).  The JAX per-device function
(``_local_interp``, with its psum) runs under ``jax.vmap(axis_name=...)``,
which is the same body on one device; the JAX ``shard_map`` itself runs
once (D = 8, nx = 29), because each shard_map compile costs ~9 s here.

Tolerances: the sharded lookup equals the port's dense lookup bit for
bit (each point is answered by its owner slab alone, the others add
exact zeros) and JAX's within 1e-6; gradients within 1e-5 (the two
copies of a shared plane sum partial gradients in another order); the
map step and optimize_map with the JAX tests' own tolerances.  After the
mapping calls the duplicated halo planes are bitwise equal.  The 6-frame
sharded box loop is in ``tests/test_torch_sharded_slice.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nice_slam_tpu.ops import interp as jinterp
from nice_slam_tpu.parallel import grid_sharding as jgs
from nice_slam_tpu.parallel.sharding import make_mesh
from nice_slam_torch.convert import scene_from_jax
from nice_slam_torch.ops import interp as tinterp
from nice_slam_torch.parallel import grid_sharding as tgs

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several workers share few cores in the tier-1 run: one torch
    thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_local_sum(grid, p, D):
    """JAX's per-device lookup body and its psum, under vmap."""
    sharded = jgs.shard_grid(jnp.asarray(grid), make_mesh(D))
    body = jax.vmap(lambda s, q: jgs._local_interp(s[None], q, sharded.shape,
                                                   sharded.planes, D),
                    in_axes=(0, None), axis_name=jgs.AXIS)
    return body, jnp.asarray(np.asarray(sharded.slabs)), sharded


def _halo_equal(sg):
    for lo, hi in zip(sg.slabs[:-1], sg.slabs[1:]):
        assert torch.equal(lo[-1], hi[0]), "halo planes diverged"


def _scene_cfg(coarse=True, **extra):
    cfg = {
        "dataset": "synthetic", "scale": 1, "occupancy": True, "coarse": coarse,
        "grid_len": {"coarse": 1.2, "middle": 0.6, "fine": 0.3, "color": 0.3,
                     "bound_divisible": 0.6},
        "model": {"c_dim": 8, "coarse_bound_enlarge": 2,
                  "pos_embedding_method": "fourier"},
        "data": {"dim": 3},
        "mapping": {"bound": [[-1.8, 1.8]] * 3},
        "cam": {},
        "rendering": {"N_samples": 8, "N_surface": 4, "N_importance": 0,
                      "lindisp": False, "perturb": 0.0},
    }
    cfg.update(extra)
    return cfg


def _scenes(cfg, seed):
    from nice_slam_tpu.models.scene import build_scene as jbuild
    from nice_slam_torch.models.scene import build_scene as tbuild

    jspec, jstate = jbuild(cfg, nice=True, seed=seed)
    tspec, _ = tbuild(cfg, nice=True, device="cpu")
    return jspec, jstate, tspec, scene_from_jax(jax.tree.map(np.asarray, jstate), CPU)


@pytest.mark.parametrize("D", [2, 3, 8])
def test_sharded_interp_matches_dense(D):
    rng = np.random.default_rng(D)
    for nx in (29, 5):
        grid = rng.normal(size=(nx, 7, 6, 8)).astype(np.float32)
        p = rng.uniform(-1.4, 1.4, (257, 3)).astype(np.float32)
        # points on plane boundaries and the box faces
        p[:4] = [[-1.0, 0.0, 0.0], [1.0, 0.5, -1.0], [0.0, 1.0, 1.0], [1.4, -1.4, 0.2]]
        t_grid, t_p = torch.tensor(grid), torch.tensor(p)
        sharded = tgs.shard_grid(t_grid, [CPU] * D)
        assert sharded.planes == max(1, -(-(nx - 1) // D)) and sharded.D == D
        got = tgs.sharded_trilinear_interp(sharded, t_p)
        assert torch.equal(got, tinterp.trilinear_interp(t_grid, t_p))
        body, slabs, _ = _jax_local_sum(grid, p, D)
        np.testing.assert_allclose(got.numpy(), np.asarray(body(slabs, jnp.asarray(p)))[0],
                                   atol=1e-6)
        if D == 8 and nx == 29:  # the JAX shard_map itself, once
            mesh = make_mesh(8)
            ref = jgs.sharded_trilinear_interp(jgs.shard_grid(jnp.asarray(grid), mesh),
                                               jnp.asarray(p), mesh)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_sharded_eval_points_matches_dense():
    """The whole decoder stack with every lookup answered by the sharded
    store, every stage: bit for bit the dense port, within the JAX test's
    5e-5 of the JAX package's dense eval_points (itself held there against
    the JAX sharded path)."""
    from nice_slam_tpu.models.scene import eval_points as jeval
    from nice_slam_torch.models.scene import eval_points as teval

    jspec, jstate, tspec, tstate = _scenes(_scene_cfg(), seed=3)
    sharded = tgs.shard_scene_grids(tstate.grids, [CPU] * 3)
    pts = np.random.default_rng(7).uniform(-2.0, 2.0, (256, 3)).astype(np.float32)
    for stage in ("coarse", "middle", "fine", "color"):
        dense = teval(tspec, tstate, torch.tensor(pts), stage)
        dist = tgs.sharded_eval_points(tspec, tstate, sharded, torch.tensor(pts), stage)
        assert torch.equal(dist, dense), stage
        np.testing.assert_allclose(dist.numpy(),
                                   np.asarray(jeval(jspec, jstate, jnp.asarray(pts), stage)),
                                   atol=5e-5, err_msg=f"stage {stage}")


@pytest.mark.parametrize("D", [2, 3, 8])
def test_sharded_store_memory_scales_down(D):
    """Each device holds ~1/D of the features (+ one halo plane), as many
    bytes as a JAX slab, each slab on its own device of the list."""
    grid = torch.zeros((65, 32, 32, 16))
    devices = [torch.device("cpu")] * D
    sharded = tgs.shard_grid(grid, devices)
    dense_bytes = grid.numel() * 4
    per_dev = tgs.per_device_bytes({"g": sharded})
    plane = 32 * 32 * 16 * 4
    assert per_dev <= -(-dense_bytes // D) + 2 * plane
    assert per_dev == jgs.per_device_bytes(
        {"g": jgs.shard_grid(jnp.zeros((65, 32, 32, 16)), make_mesh(D))})
    assert sharded.devices == devices and len(sharded.slabs) == D
    assert tgs.unshard_grid(sharded).shape == grid.shape


@pytest.mark.parametrize("D", [3, 8])
def test_sharded_store_is_differentiable(D, monkeypatch):
    """Autodiff through the sharded lookup: the slab gradients (K2 with a
    slab window's plain version) against JAX's per-device autodiff, and
    reassembled by unshard_grid_grad against the dense gradient of both
    packages (the JAX one in plain float32 autodiff)."""
    monkeypatch.setattr(jinterp, "_DGRAD_BF16", False)
    rng = np.random.default_rng(4)
    grid = rng.normal(size=(21, 6, 5, 8)).astype(np.float32)
    p = rng.uniform(-1.3, 1.3, (128, 3)).astype(np.float32)
    cot = rng.normal(size=(128, 8)).astype(np.float32)
    sharded = tgs.shard_grid(torch.tensor(grid), [CPU] * D)
    slabs = [s.clone().requires_grad_(True) for s in sharded.slabs]
    t_p = torch.tensor(p, requires_grad=True)
    loss = torch.sum(tgs.sharded_trilinear_interp(sharded._replace(slabs), t_p)
                     * torch.tensor(cot))
    slab_grads = torch.autograd.grad(loss, slabs + [t_p])
    dp = slab_grads[-1]
    slab_grads = list(slab_grads[:-1])

    body, jslabs, jsh = _jax_local_sum(grid, p, D)
    jgrads = jax.grad(lambda s: jnp.sum(body(s, jnp.asarray(p))[0] * cot))(jslabs)
    for d in range(D):
        np.testing.assert_allclose(slab_grads[d].numpy(), np.asarray(jgrads[d]), atol=1e-5)

    dense_t = tgs.unshard_grid_grad(slab_grads, sharded.shape, sharded.planes)
    np.testing.assert_array_equal(
        dense_t.numpy(), np.asarray(jgs.unshard_grid_grad(
            jnp.asarray(np.stack([g.numpy() for g in slab_grads])), jsh.shape, jsh.planes)))
    t_grid = torch.tensor(grid, requires_grad=True)
    t_p2 = torch.tensor(p, requires_grad=True)
    ref, ref_dp = torch.autograd.grad(
        torch.sum(tinterp.trilinear_interp(t_grid, t_p2) * torch.tensor(cot)), [t_grid, t_p2])
    torch.testing.assert_close(dense_t, ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(dp, ref_dp, atol=1e-4 * float(ref_dp.abs().max()), rtol=0)
    jdense = jax.grad(lambda g: jnp.sum(jinterp._trilinear_impl(g, jnp.asarray(p)) * cot))(
        jnp.asarray(grid))
    np.testing.assert_allclose(dense_t.numpy(), np.asarray(jdense), atol=1e-5)


def _small_camera(seed=0):
    """A 24x32 camera looking down -z into a box's grids, its depth image
    with a tenth of the pixels 0 (no return)."""
    gen = torch.Generator().manual_seed(seed)
    c2w = torch.eye(4)
    c2w[:3, 3] = torch.tensor([0.1, 0.2, 2.2])
    depth = 1.5 + 2.0 * torch.rand((24, 32), generator=gen)
    depth[torch.rand((24, 32), generator=gen) < 0.1] = 0.0
    bound = torch.tensor([[-1.8, 1.8]] * 3)
    return c2w, depth, bound, 24, 32, 18.0, 18.0, 15.5, 11.5


@pytest.mark.parametrize("D", [2, 3, 4])
def test_frustum_masks_in_the_slab_layout(D):
    """K10's mask asked for in the slab layout (rows = planes x D + 1 >
    nx; here its plain version) is the dense mask edge-padded as
    ``shard_grid`` pads a grid, and ``mask_to_slabs`` cuts it into the
    slabs it cut from the dense mask before, as views of that one tensor
    (copied only to another device)."""
    from nice_slam_torch.ops.frustum import frustum_masks

    c2w, depth, bound, H, W, fx, fy, cx, cy = _small_camera()
    shapes = [(8, 9, 9), (18, 17, 17), (18, 17, 17)]  # nx - 1 a multiple of no D
    dense = frustum_masks(c2w, depth, bound, shapes, H, W, fx, fy, cx, cy)
    planes = [tgs._planes(s[0], D) for s in shapes]
    rows = [p * D + 1 for p in planes]
    assert all(r > s[0] for r, s in zip(rows, shapes))
    padded = frustum_masks(c2w, depth, bound, shapes, H, W, fx, fy, cx, cy, rows)
    assert padded[1] is padded[2]
    for m, p, d, r in zip(padded, planes, dense, rows):
        assert 0 < float(d.sum()) < d.numel()
        assert torch.equal(m, tgs._edge_pad(d, r))
        slabs = tgs.mask_to_slabs(m, p, D, [CPU] * D)
        before = [tgs._edge_pad(d, r)[i * p:i * p + p + 1] for i in range(D)]
        for i, (a, b) in enumerate(zip(slabs, before)):
            assert torch.equal(a, b)
            assert a._base is m or a._base is m._base
            assert a.data_ptr() == m.data_ptr() + i * p * a[0].numel() * 4
    with pytest.raises(ValueError):
        tgs.mask_to_slabs(dense[1], planes[1], D)


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return (np.zeros((n, 3), np.float32), dirs, np.full((n,), 1.2, np.float32),
            np.full((n, 3), 0.4, np.float32))


def test_sharded_map_step_matches_dense(monkeypatch):
    """One mapping train step (render -> grad -> halo fold -> Adam) on the
    sharded scene against the same step on dense grids, in the port and
    in the JAX package (plain float32 autodiff there, as its test pins):
    loss rtol 1e-5, grids atol 2e-5, halo planes bitwise equal."""
    from nice_slam_tpu.ops.render import RenderConfig as JRender
    from nice_slam_tpu.ops.render import render_batch_ray as jrender
    from nice_slam_tpu.slam.optim import group_adam_update, init_group_adam
    from nice_slam_torch.ops.render import RenderConfig as TRender
    from nice_slam_torch.ops.render import render_batch_ray as trender
    from nice_slam_torch.slam.optim import GroupAdam

    monkeypatch.setattr(jinterp, "_SEGSUM_MODE", "0")
    cfg = _scene_cfg(coarse=False)
    jspec, jstate, tspec, tstate = _scenes(cfg, seed=5)
    rcfg = TRender.from_cfg(cfg)
    rays = _rays(64)
    t_rays = [torch.tensor(a) for a in rays]

    step, shard_grids, init_adam = tgs.make_grid_sharded_map_step(
        [CPU] * 8, tspec, "color", rcfg, w_color=0.2, lr=0.05)
    sharded = shard_grids(tstate.grids)
    new_sharded, _, loss_s = step(sharded, tstate, init_adam(sharded), *t_rays)

    # the port's dense step
    grids = {k: v.clone().requires_grad_(True) for k, v in tstate.grids.items()}
    depth, _, color = trender(tspec, tstate._replace(grids=grids), t_rays[0], t_rays[1],
                              "color", gt_depth=t_rays[2], rcfg=rcfg)
    loss_d = (torch.sum(torch.abs(t_rays[2] - depth))
              + 0.2 * torch.sum(torch.abs(t_rays[3] - color)))
    names = sorted(grids)
    gr = torch.autograd.grad(loss_d, [grids[k] for k in names])
    adam = GroupAdam({"grids": grids})
    adam.step({"grids": list(gr)}, {"grids": 0.05}, {"grids": True})
    np.testing.assert_allclose(float(loss_s), float(loss_d.detach()), rtol=1e-5)

    # the JAX package's dense step
    jr = [jnp.asarray(a) for a in rays]

    def jloss(g):
        d, _, c = jrender(jspec, jstate._replace(grids=g), jr[0], jr[1], "color",
                          gt_depth=jr[2], rcfg=JRender.from_cfg(cfg))
        return (jnp.sum(jnp.where(jr[2] > 0, jnp.abs(jr[2] - d), 0.0))
                + 0.2 * jnp.sum(jnp.abs(jr[3] - c)))

    jl, jg = jax.value_and_grad(jloss)(jstate.grids)
    jnew, _ = group_adam_update({"grids": jstate.grids}, {"grids": jg},
                                init_group_adam({"grids": jstate.grids}),
                                {"grids": jnp.asarray(0.05, jnp.float32)}, {"grids": True})
    np.testing.assert_allclose(float(loss_s), float(jl), rtol=1e-5)
    for k, sg in new_sharded.items():
        _halo_equal(sg)
        got = tgs.unshard_grid(sg).numpy()
        np.testing.assert_allclose(got, grids[k].detach().numpy(), atol=2e-5, err_msg=k)
        np.testing.assert_allclose(got, np.asarray(jnew["grids"][k]), atol=2e-5, err_msg=k)


def test_sharded_optimize_map_matches_dense():
    """The real ``Mapper.optimize_map`` (staged LRs, frustum masks, the
    decoder groups, group-masked Adam) on a scene sharded over 3 slabs
    against the dense call, from the JAX package's scene: losses rtol
    1e-4, grids and decoders atol 5e-4 (the JAX test's), the sharded
    representation kept, and after its 6 Adam steps under frustum masks
    the duplicated halo planes bitwise equal."""
    from nice_slam_tpu.utils.datasets import Synthetic
    from nice_slam_torch.ops.render import RenderConfig as TRender
    from nice_slam_torch.slam.keyframes import KeyframeStore
    from nice_slam_torch.slam.mapper import Mapper, MapperConfig

    H, W = 24, 32
    cam = {"H": H, "W": W, "fx": 24.0, "fy": 24.0, "cx": 15.5, "cy": 11.5}
    cfg = _scene_cfg(coarse=False, cam=dict(cam, png_depth_scale=1.0, crop_edge=0))
    cfg["data"] = {"dim": 3, "n_frames": 4, "room": [[-1.8, 1.8]] * 3}
    cfg["mapping"] = {
        "bound": [[-1.8, 1.8]] * 3,
        "pixels": 96, "iters": 6, "iters_first": 6, "every_frame": 1,
        "keyframe_every": 1, "mapping_window_size": 3,
        "middle_iter_ratio": 0.4, "fine_iter_ratio": 0.6,
        "w_color_loss": 0.2, "BA": False, "BA_cam_lr": 0.001,
        "fix_fine": False, "fix_color": False,
        "frustum_feature_selection": True,
        "keyframe_selection_method": "global",
        "lr_first_factor": 5, "lr_factor": 1, "color_refine": False,
        "stage": {s: {"decoders_lr": 0.001, "coarse_lr": 0.001, "middle_lr": 0.1,
                      "fine_lr": 0.01, "color_lr": 0.01}
                  for s in ("coarse", "middle", "fine", "color")},
    }
    _, _, tspec, tstate = _scenes(cfg, seed=5)
    rcfg = TRender.from_cfg(cfg)
    mcfg = MapperConfig.from_cfg(cfg, cam, nice=True)
    ds = Synthetic(cfg)
    frames = [[torch.as_tensor(np.asarray(x), dtype=torch.float32) for x in ds[i][1:]]
              for i in (0, 1)]
    (c0, d0, p0), (c1, d1, p1) = frames

    results = {}
    for kind in ("dense", "sharded"):
        st = tstate
        if kind == "sharded":
            st = tstate._replace(grids=tgs.shard_scene_grids(tstate.grids, [CPU] * 3))
        mapper = Mapper(tspec, mcfg, rcfg, "cpu", seed=11)
        store = KeyframeStore(3, H, W, "cpu")
        store.add(0, c0, d0, p0, p0)
        new_state, _, losses = mapper.optimize_map(st, 6, 1.0, c1, d1, store, p1,
                                                   BA=False)
        results[kind] = (new_state, losses.numpy())

    dense_state, dense_losses = results["dense"]
    shard_state, shard_losses = results["sharded"]
    np.testing.assert_allclose(shard_losses, dense_losses, rtol=1e-4)
    for k, sg in shard_state.grids.items():
        assert isinstance(sg, tgs.ShardedGrid), f"{k} lost its sharded representation"
        _halo_equal(sg)
        want = dense_state.grids[k].numpy()
        assert not np.array_equal(want, tstate.grids[k].numpy()), f"{k} never trained"
        np.testing.assert_allclose(tgs.unshard_grid(sg).numpy(), want, atol=5e-4, err_msg=k)
    for dec in ("fine", "color"):
        np.testing.assert_allclose(
            shard_state.decoders[dec]["output_linear"]["w"].numpy(),
            dense_state.decoders[dec]["output_linear"]["w"].numpy(), atol=5e-4, err_msg=dec)
