"""The port's iMAP* model family against the JAX package, module by module,
on the CPU, from the same converted weights (``scene_from_jax``) and, where
the JAX side draws random numbers, on the JAX draws.

Tolerances:
  * ``sample_pdf``: 1e-5 absolute on z-values of ~0.1-0.2.  The zero-
    weight bins of the guard case sit inside the rows: with a zero-weight
    tail the quantile u = 1 meets the CDF's last value, which torch's CPU
    cumsum (a double accumulator) rounds to 1.0 and XLA's to 1.0000002,
    so that one sample lands on either of the last two bin edges;
  * the MLP, ``eval_points``: 1e-4 on raw outputs of O(1) (f32 GEMM
    summation order; the Fourier arguments stay under ~15 rad at this
    scene's 0.1 scale, far from the 0.05 the JAX package allows at O(100)
    rad); the out-of-bound sentinel exactly;
  * ``render_batch_ray`` with ``N_importance`` > 0: 1e-4 on depth,
    uncertainty and color;
  * ``regulation`` on the JAX jitter draws: 1e-4 on the densities;
  * ``mapping_loss``: 1e-5 relative on the loss, each decoder leaf's
    gradient within 1e-4 of that leaf's largest |g| (measured ~5e-6);
  * the StepLR rate: 1e-7 relative (both float32);
  * checkpoints: exact;
  * the mesher's vertex colours: every port vertex within half a voxel of
    a JAX vertex, and its uint8 colour within 2 levels of that vertex's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from nice_slam_tpu.config import load_config
from nice_slam_tpu.models import decoders as jdec
from nice_slam_tpu.models import scene as jscene
from nice_slam_tpu.ops import geometry as jgeo
from nice_slam_tpu.ops import render as jrender
from nice_slam_tpu.slam import mapper as jm
from nice_slam_tpu.slam.keyframes import KeyframeStore as JKeyframes
from nice_slam_tpu.utils import logger as jlog
from nice_slam_tpu.utils import mesher as jmesher
from nice_slam_tpu.utils import meshlib as jml
from nice_slam_tpu.utils.datasets import Synthetic
from nice_slam_torch.convert import scene_from_jax, scene_to_numpy
from nice_slam_torch.models import decoders as tdec
from nice_slam_torch.models import scene as tscene
from nice_slam_torch.ops import geometry as tgeo
from nice_slam_torch.ops import render as trender
from nice_slam_torch.slam import mapper as tm
from nice_slam_torch.slam.keyframes import KeyframeStore as TKeyframes
from nice_slam_torch.slam.optim import tree_leaves, tree_map
from nice_slam_torch.utils import logger as tlog
from nice_slam_torch.utils import mesher as tmesher
from nice_slam_torch.utils import meshlib as tml

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
H, W = 24, 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tier-1 run puts several workers on few cores, and torch's
    thread pool in each would oversubscribe them (tiny loop runs took
    ~10x longer that way), so this module's runs use one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def imap_cfg():
    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "imap.yaml"))
    cfg["verbose"] = False
    cfg["cam"].update({"H": H, "W": W, "fx": 24.0, "fy": 24.0, "cx": 15.5,
                       "cy": 11.5})
    cfg["rendering"].update({"N_samples": 8, "N_importance": 4})
    cfg["data"]["n_frames"] = 6
    return cfg


@pytest.fixture(scope="module")
def setup():
    cfg = imap_cfg()
    jspec, jstate = jscene.build_scene(cfg, nice=False, seed=3)
    tspec, ttemplate = tscene.build_scene(cfg, nice=False, seed=9, device="cpu")
    tstate = scene_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    ds = Synthetic(cfg, scale=cfg["scale"])
    frames = [ds[i] for i in range(len(ds))]
    return dict(cfg=cfg, jspec=jspec, jstate=jstate, tspec=tspec,
                ttemplate=ttemplate, tstate=tstate, frames=frames)


def _points(setup, n, seed, margin=0.05):
    b = np.asarray(setup["jstate"].bound)
    rng = np.random.default_rng(seed)
    return rng.uniform(b[:, 0] - margin, b[:, 1] + margin, (n, 3)).astype(np.float32)


def _rays(setup, n, seed):
    """n rays from frame 2's camera through random pixels, with their
    sensor depth (some pixels see nothing: depth 0)."""
    _, _, depth, c2w = setup["frames"][2]
    rng = np.random.default_rng(seed)
    i = rng.integers(0, W, n).astype(np.float32)
    j = rng.integers(0, H, n).astype(np.float32)
    cam = setup["cfg"]["cam"]
    ro, rd = tgeo.rays_from_uv(torch.tensor(i), torch.tensor(j), torch.tensor(c2w),
                               cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    gt = depth[j.astype(int), i.astype(int)].copy()
    gt[:3] = 0.0
    return ro.numpy(), rd.numpy(), gt.astype(np.float32)


# ---------------------------------------------------------------------------
# sample_pdf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("det", [True, False])
def test_sample_pdf_matches_jax(det):
    rng = np.random.default_rng(0)
    B, M, N = 64, 11, 12
    bins = np.sort(rng.uniform(0.05, 0.2, (B, M)), axis=-1).astype(np.float32)
    weights = rng.uniform(0.0, 1.0, (B, M - 1)).astype(np.float32)
    weights[:4] = 0.0  # all-zero weights: the floor makes them uniform
    weights[4:8, 3:7] = 0.0  # zero-weight bins: the denom guard
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jgeo.sample_pdf(key, jnp.asarray(bins), jnp.asarray(weights),
                                     N, det=det))
    u = None if det else torch.tensor(np.asarray(jax.random.uniform(key, (B, N))))
    got = tgeo.sample_pdf(torch.tensor(bins), torch.tensor(weights), N, det=det,
                          u=u).numpy()
    assert got.shape == (B, N)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert (got >= bins[:, :1] - 1e-6).all() and (got <= bins[:, -1:] + 1e-6).all()


def test_sample_pdf_draws_from_generator():
    bins = torch.linspace(0.0, 1.0, 9).expand(5, 9).contiguous()
    w = torch.ones(5, 7)
    a = tgeo.sample_pdf(bins, w, 6, gen=torch.Generator().manual_seed(1))
    b = tgeo.sample_pdf(bins, w, 6, gen=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and a.shape == (5, 6)


# ---------------------------------------------------------------------------
# the MLP and the scene
# ---------------------------------------------------------------------------

def test_imap_spec_and_init_match_jax(setup):
    js, ts = setup["jspec"], setup["tspec"]
    assert not ts.nice and ts.grid_shapes == () and not ts.coarse
    assert setup["tstate"].grids == {}
    for f in ("dim", "c_dim", "hidden_size", "n_blocks", "skips", "color",
              "pos_embedding_method", "concat_feature", "no_xyz"):
        assert getattr(ts.decoder, f) == getattr(js.decoder, f), f
    # the port's own init has the JAX tree's leaves, in the same order
    jshapes = [np.asarray(x).shape for x in jax.tree.leaves(setup["jstate"].decoders)]
    tshapes = [tuple(x.shape) for x in tree_leaves(setup["ttemplate"].decoders)]
    assert tshapes == jshapes and (93, 256) in tshapes and (256, 4) in tshapes
    np.testing.assert_array_equal(setup["tstate"].bound.numpy(),
                                  np.asarray(setup["jstate"].bound))


def test_apply_imap_matches_jax(setup):
    p = _points(setup, 400, seed=1, margin=0.0)
    ref = np.asarray(jdec.apply_imap(setup["jstate"].decoders, setup["jspec"].decoder,
                                     jnp.asarray(p)))
    got = tdec.apply_imap(setup["tstate"].decoders, setup["tspec"].decoder,
                          torch.tensor(p)).numpy()
    assert got.shape == (400, 4)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_eval_points_sentinel_matches_jax(setup):
    p = _points(setup, 500, seed=2, margin=0.1)
    ref = np.asarray(jscene.eval_points(setup["jspec"], setup["jstate"],
                                        jnp.asarray(p)))
    got = tscene.eval_points(setup["tspec"], setup["tstate"], torch.tensor(p)).numpy()
    outside = ref[:, 3] == 100.0
    assert 0 < outside.sum() < len(p)
    np.testing.assert_array_equal(got[:, 3] == 100.0, outside)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def test_render_batch_ray_importance_matches_jax(setup):
    ro, rd, gt = _rays(setup, 200, seed=3)
    rc = jrender.RenderConfig.from_cfg(setup["cfg"])
    rt = trender.RenderConfig.from_cfg(setup["cfg"])
    assert rt == trender.RenderConfig(**vars(rc)) and rt.N_importance == 4
    assert not rt.occupancy  # density mode
    ref = jrender.render_batch_ray(setup["jspec"], setup["jstate"], jnp.asarray(ro),
                                   jnp.asarray(rd), "color",
                                   gt_depth=jnp.asarray(gt), rcfg=rc)
    got = trender.render_batch_ray(setup["tspec"], setup["tstate"], torch.tensor(ro),
                                   torch.tensor(rd), "color",
                                   gt_depth=torch.tensor(gt), rcfg=rt)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4, rtol=0)


def test_render_importance_pass_keeps_no_graph(setup):
    """Only the second pass carries a gradient: the decoder gradient of a
    render equals that of rendering the merged samples directly."""
    ro, rd, gt = _rays(setup, 40, seed=4)
    rt = trender.RenderConfig.from_cfg(setup["cfg"])
    dec = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                   setup["tstate"].decoders)
    state = setup["tstate"]._replace(decoders=dec)
    d, _, c = trender.render_batch_ray(setup["tspec"], state, torch.tensor(ro),
                                       torch.tensor(rd), "color",
                                       gt_depth=torch.tensor(gt), rcfg=rt)
    assert d.grad_fn is not None
    grads = torch.autograd.grad(d.sum() + c.sum(), tree_leaves(dec))
    assert all(torch.isfinite(g).all() for g in grads)
    assert sum(float(g.abs().sum()) for g in grads) > 0


def test_regulation_matches_jax_in_the_mappers_argument_order(setup):
    """The JAX mapper calls regulation(spec, state, rays_d, rays_o, ...)
    against its (rays_o, rays_d) parameters; the port's mapper does the
    same, so both sample at rays_d + rays_o * z."""
    ro, rd, gt = _rays(setup, 50, seed=5)
    key = jax.random.PRNGKey(11)
    N = setup["cfg"]["rendering"]["N_samples"]
    ref = np.asarray(jrender.regulation(setup["jspec"], setup["jstate"],
                                        jnp.asarray(rd), jnp.asarray(ro),
                                        jnp.asarray(gt), key, N))
    t_rand = torch.tensor(np.asarray(jax.random.uniform(key, (50, N))))
    got = trender.regulation(setup["tspec"], setup["tstate"], torch.tensor(rd),
                             torch.tensor(ro), torch.tensor(gt), N,
                             t_rand=t_rand).numpy()
    assert got.shape == (50 * N,)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# the mapper
# ---------------------------------------------------------------------------

def _window(setup):
    fr = [setup["frames"][i] for i in (0, 2, 4)]
    return (np.stack([f[1] for f in fr]), np.stack([f[2] for f in fr]),
            np.stack([f[3] for f in fr]))


def _jax_draws(key, F, n, N):
    """The pixel indices and regulariser jitter one JAX mapping_loss call
    draws from its key."""
    k_frames, k_reg = jax.random.split(key)
    fk = jax.random.split(k_frames, F)
    pix = np.stack([np.asarray(jax.random.randint(fk[f], (n,), 0, H * W))
                    for f in range(F)])
    return pix, np.asarray(jax.random.uniform(k_reg, (F * n, N)))


def _losses(setup, swap_back=False, monkeypatch=None):
    cfg, cam = setup["cfg"], setup["cfg"]["cam"]
    colors, depths, c2w = _window(setup)
    F, n, N = 3, 20, cfg["rendering"]["N_samples"]
    key = jax.random.PRNGKey(5)
    opt, valid = np.zeros(F, np.float32), np.ones(F, bool)
    jmc = jm.MapperConfig.from_cfg(cfg, cam, False)
    tmc = tm.MapperConfig.from_cfg(cfg, cam, False)

    def jloss(g):
        return jm.mapping_loss(setup["jspec"], g, setup["jstate"], jnp.asarray(colors),
                               jnp.asarray(depths), jnp.asarray(c2w), jnp.asarray(opt),
                               jnp.asarray(valid), key, "color", jmc,
                               jrender.RenderConfig.from_cfg(cfg), n)

    jl, jg = jax.jit(jax.value_and_grad(jloss))({"dec": setup["jstate"].decoders})
    pix, reg_t = _jax_draws(key, F, n, N)
    groups = {"dec": tree_map(lambda t: t.detach().clone().requires_grad_(True),
                              setup["tstate"].decoders)}
    tl = tm.mapping_loss(setup["tspec"], groups, setup["tstate"], torch.tensor(colors),
                         torch.tensor(depths), torch.tensor(c2w), torch.tensor(opt),
                         torch.tensor(valid), "color", tmc,
                         trender.RenderConfig.from_cfg(cfg), n,
                         pix_idx=torch.tensor(pix), reg_t=torch.tensor(reg_t))
    tg = torch.autograd.grad(tl, tree_leaves(groups["dec"]))
    return float(jl), jax.tree.leaves(jg["dec"]), float(tl.detach()), tg


def test_mapping_loss_and_gradient_match_jax(setup):
    jl, jg, tl, tg = _losses(setup)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert len(jg) == len(tg) == 11  # embedder_B, head (w, b), 4 x (w, b)
    for a, b in zip(jg, tg):
        a = np.asarray(a)
        assert b.shape == a.shape
        assert np.abs(b.numpy() - a).max() <= 1e-4 * np.abs(a).max()


def test_mapping_loss_pins_the_regulariser_argument_order(setup, monkeypatch):
    """With the regulariser's rays in the upstream order the port's loss
    would leave the JAX package's by far more than the 1e-5 the parity
    test allows."""
    jl, _, tl, _ = _losses(setup)
    inner = tm.regulation
    monkeypatch.setattr(tm, "regulation",
                        lambda spec, state, a, b, *r, **k: inner(spec, state, b, a, *r, **k))
    _, _, swapped, _ = _losses(setup)
    assert abs(tl - jl) <= 1e-5 * abs(jl) < abs(swapped - jl)


@pytest.mark.parametrize("it", [0, 199, 200, 400])
def test_steplr_matches_jax(setup, it):
    cfg, cam = setup["cfg"], setup["cfg"]["cam"]
    jmc = jm.MapperConfig.from_cfg(cfg, cam, False)
    tmc = tm.MapperConfig.from_cfg(cfg, cam, False)
    groups = {"dec": None, "cams": None}
    ref = jm._stage_lrs(jmc, "color", 5.0, groups, jnp.asarray(it, jnp.int32))
    np.testing.assert_allclose(tm.imap_lr(tmc, it), float(ref["dec"]), rtol=1e-7)
    assert tm.imap_lr(tmc, it) == pytest.approx(2e-4 * 0.8 ** (it // 200), rel=1e-6)
    # the camera rate is on at every stage under iMAP* BA
    assert tm._stage_lrs(tmc, "color", 5.0, groups)["cams"] == float(ref["cams"]) \
        == cfg["mapping"]["BA_cam_lr"]


def test_stage_plan_groups_and_selection_match_jax(setup):
    cfg, cam = setup["cfg"], setup["cfg"]["cam"]
    jmc = jm.MapperConfig.from_cfg(cfg, cam, False)
    tmc = tm.MapperConfig.from_cfg(cfg, cam, False)
    assert tm.stage_plan_for(tmc, 100) == jm.stage_plan_for(jmc, 100) == (("color", 100),)
    assert tmc.keyframe_selection_method == jmc.keyframe_selection_method == "global"
    groups = tm._opt_param_groups(setup["tspec"], setup["tstate"], tmc,
                                  torch.zeros(3, 7), True)
    assert sorted(groups) == ["cams", "dec"]
    assert tm._active_groups("color", groups) == {"dec": True, "cams": True}


def test_optimize_map_core_runs_the_steplr(setup):
    """Three iterations of a call against the JAX call on the same draws:
    losses and every decoder leaf after the Adam steps."""
    cfg, cam = setup["cfg"], setup["cfg"]["cam"]
    colors, depths, c2w = _window(setup)
    F, n, N, iters = 3, 16, cfg["rendering"]["N_samples"], 3
    key = jax.random.PRNGKey(8)
    cams = np.asarray(jax.vmap(jm.tensor_from_pose)(jnp.asarray(c2w)))
    opt, valid = np.zeros(F, np.float32), np.ones(F, bool)
    plan = (("color", iters),)
    js, _, jl, _ = jm.optimize_map_jit(
        setup["jspec"], setup["jstate"], jnp.asarray(colors), jnp.asarray(depths),
        jnp.asarray(c2w), jnp.asarray(cams), jnp.asarray(opt), jnp.asarray(valid),
        None, jnp.asarray(1.0, jnp.float32), key, None,
        jm.MapperConfig.from_cfg(cfg, cam, False), jrender.RenderConfig.from_cfg(cfg),
        plan, False, n)
    draws = [_jax_draws(jax.random.fold_in(key, i), F, n, N) for i in range(iters)]
    ts, _, tl = tm.optimize_map_core(
        setup["tspec"], setup["tstate"], torch.tensor(colors), torch.tensor(depths),
        torch.tensor(c2w), torch.tensor(cams), torch.tensor(opt), torch.tensor(valid),
        1.0, tm.MapperConfig.from_cfg(cfg, cam, False),
        trender.RenderConfig.from_cfg(cfg), plan, False, n,
        pix_idx=torch.tensor(np.stack([d[0] for d in draws])),
        reg_t=torch.tensor(np.stack([d[1] for d in draws])))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(scene_to_numpy(ts)["decoders"]),
                    jax.tree.leaves(jax.tree.map(np.asarray, js.decoders))):
        np.testing.assert_allclose(a, b, atol=1e-5)
    assert ts.grids == {}


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _assert_tree_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_checkpoints_load_across_packages(setup, tmp_path):
    jspec, jstate = setup["jspec"], setup["jstate"]
    tspec, ttemplate, tstate = setup["tspec"], setup["ttemplate"], setup["tstate"]
    poses = np.random.default_rng(6).standard_normal((6, 4, 4)).astype(np.float32)
    tsd = tlog.decoders_to_state_dict(tspec, tstate.decoders)
    jsd = jlog.decoders_to_state_dict(jspec, jstate.decoders)
    assert sorted(tsd) == sorted(jsd) and "pts_linears.0.weight" in tsd
    assert all(torch.equal(tsd[k], jsd[k]) for k in jsd)
    # JAX -> port
    path = jlog.Logger(str(tmp_path / "j"), jspec, verbose=False).log(
        5, jstate, poses, poses[::-1].copy(), [0, 5])
    state, est, gt, kfs, idx = tlog.load_checkpoint(path, tspec, ttemplate)
    _assert_tree_equal(scene_to_numpy(state)["decoders"],
                       jax.tree.map(np.asarray, jstate.decoders))
    assert state.grids == {} and (kfs, idx) == ([0, 5], 5)
    np.testing.assert_array_equal(est, poses)
    # port -> JAX
    path = tlog.Logger(str(tmp_path / "t"), tspec, verbose=False).log(
        3, tstate, torch.tensor(poses), poses[::-1].copy(), [0])
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    assert ckpt["c"] == {}
    state, est, gt, kfs, idx = jlog.load_checkpoint(path, jspec, jstate)
    _assert_tree_equal(state.decoders, jstate.decoders)
    np.testing.assert_array_equal(gt, poses[::-1])
    assert (kfs, idx) == ([0], 3)


# ---------------------------------------------------------------------------
# the mesher
# ---------------------------------------------------------------------------

def test_mesher_vertex_colours_match_jax(setup, tmp_path):
    """get_mesh through the iMAP* density field at resolution 24, coloured
    by rendering along the vertex normals, in both packages.  The random
    weights' density lies in about [-1.4, 2.2] inside the box, so the
    level set is moved from the config's 10 to 0.3 to cut a surface."""
    cfg = dict(setup["cfg"])
    cfg["meshing"] = dict(cfg["meshing"], resolution=24, level_set=0.3)
    assert cfg["meshing"]["color_mesh_extraction_method"] == "render_ray_along_normal"
    cam = dict(cfg["cam"])
    est = np.stack([f[3] for f in setup["frames"]])
    jkf, tkf = JKeyframes(4, H, W), TKeyframes(4, H, W, "cpu")
    for i in (0, 5):
        _, color, depth, c2w = setup["frames"][i]
        jkf.add(i, color, depth, c2w, c2w)
        tkf.add(i, color, depth, c2w, c2w)
    jpath, tpath = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    jmesher.Mesher(cfg, cam, setup["jspec"], str(tmp_path)).get_mesh(
        jpath, setup["jstate"], jkf, est, 5)
    mesher = tmesher.Mesher(cfg, cam, setup["tspec"])
    mesher.get_mesh(tpath, setup["tstate"], tkf, torch.tensor(est), 5)
    jv, jf, jc = jml.read_ply(jpath)
    tv, tf, tc = tml.read_ply(tpath)
    assert len(jf) > 50 and abs(len(tf) - len(jf)) <= 0.01 * len(jf)
    assert mesher.last["color_chunks"] == 1
    b = np.asarray(cfg["mapping"]["marching_cubes_bound"]) * cfg["scale"]
    voxel = float(np.max(b[:, 1] - b[:, 0] + 0.1)) / 23 / cfg["scale"]
    dist, nearest = cKDTree(jv).query(tv)
    assert dist.max() <= 0.5 * voxel
    assert tc is not None and len(np.unique(tc, axis=0)) > 10
    diff = np.abs(tc.astype(int) - jc[nearest].astype(int))
    assert diff.max() <= 2


def test_vertex_normals_match_jax():
    field = np.linspace(-1, 1, 12, dtype=np.float32)
    X, Y, Z = np.meshgrid(field, field, field, indexing="ij")
    v, f = tml.marching_cubes((X ** 2 + Y ** 2 + Z ** 2 - 0.5).astype(np.float32),
                              0.0, (-1.0,) * 3, (2 / 11,) * 3)
    n = tmesher.vertex_normals(v, f)
    np.testing.assert_array_equal(n, jmesher._vertex_normals(v, f))
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-5)
