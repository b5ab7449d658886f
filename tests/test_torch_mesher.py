"""The port's mesher and host mesh library against the JAX package's.

  * meshlib: the port builds its own copy of the native mesh kernels, so
    marching cubes and tetrahedra, components, the PLY bytes, the PLY
    reader, the BVH raycaster and surface sampling are held to exact
    equality on the same inputs;
  * ``_frame_masks``: the visibility masks of random points in both
    ``depth_test`` modes and the all-frames zero-depth variant, exactly
    (the same f32 ops; no point of these seeds lies within rounding of a
    frustum or depth boundary), plus the cases of test_mesher_masks.py;
  * ``chunked_eval``: occupancies on a ``scene_from_jax``-converted scene
    with the pretrained decoders at atol 0.05 (raw logits through the
    Fourier embedding, the JAX package's own numerics tolerance);
  * ``get_mesh`` at resolution 40 from the same scene, keyframes and
    poses: face counts within 1 % and every port vertex within half a
    voxel of the JAX mesh (the two fields differ by f32 rounding only, so
    the surfaces nearly coincide); the iMAP* colouring (rendering along
    the vertex normals) on the same mesh within 2 uint8 levels.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from nice_slam_tpu.config import load_config as jload_config
from nice_slam_tpu.models import pretrain as jpre
from nice_slam_tpu.models import scene as jscene
from nice_slam_tpu.slam.keyframes import KeyframeStore as JKeyframes
from nice_slam_tpu.utils import mesher as jmesher
from nice_slam_tpu.utils import meshlib as jml
from nice_slam_tpu.utils.datasets import Synthetic
from nice_slam_torch.convert import scene_from_jax
from nice_slam_torch.models import scene as tscene
from nice_slam_torch.slam.keyframes import KeyframeStore as TKeyframes
from nice_slam_torch.utils import mesher as tmesher
from nice_slam_torch.utils import meshlib as tml

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
H, W, F = 24, 32, 24.0
LOGIT_ATOL = 0.05


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tier-1 run puts several workers on few cores, and torch's
    thread pool in each would oversubscribe them (tiny loop runs took
    ~10x longer that way), so this module's runs use one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# meshlib
# ---------------------------------------------------------------------------

def _field(n=28, seed=0):
    """A box SDF (walls at +-1) with a sphere carved out and mild noise."""
    rng = np.random.default_rng(seed)
    g = np.linspace(-1.4, 1.4, n).astype(np.float32)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    box = 1.0 - np.maximum.reduce([np.abs(X), np.abs(Y), np.abs(Z)])
    ball = np.sqrt((X - 0.3) ** 2 + Y ** 2 + (Z + 0.2) ** 2) - 0.35
    f = np.minimum(box, ball) + 0.02 * rng.standard_normal(X.shape)
    return f.astype(np.float32), (-1.4,) * 3, (2.8 / (n - 1),) * 3


@pytest.mark.parametrize("method", ["mc", "tets"])
def test_marching_cubes_and_components_equal_jax(method):
    field, origin, spacing = _field()
    jv, jt = jml.marching_cubes(field, 0.0, origin, spacing, method=method)
    tv, tt = tml.marching_cubes(field, 0.0, origin, spacing, method=method)
    assert len(tt) > 100
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tt, jt)
    jc, ja = jml.components(jv, jt)
    tc, ta = tml.components(tv, tt)
    assert len(ta) >= 2  # the walls and the ball's shell
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ta, ja)


def test_ply_bytes_reader_raycaster_and_sampling_equal_jax(tmp_path):
    field, origin, spacing = _field(seed=1)
    v, t = tml.marching_cubes(field, 0.0, origin, spacing)
    colors = np.random.default_rng(2).integers(0, 256, (len(v), 3), dtype=np.uint8)
    for c in (colors, None):
        jp, tp = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
        jml.write_ply(jp, v, t, c)
        tml.write_ply(tp, v, t, c)
        with open(jp, "rb") as a, open(tp, "rb") as b:
            assert a.read() == b.read()
        for x, y in zip(jml.read_ply(jp), tml.read_ply(jp)):
            if x is None:
                assert y is None
            else:
                np.testing.assert_array_equal(y, x)
    c2w = np.eye(4, dtype=np.float32)
    jd = jml.MeshRaycaster(v, t).render_depth(c2w, 30, 40, 30.0, 30.0, 19.5, 14.5)
    td = tml.MeshRaycaster(v, t).render_depth(c2w, 30, 40, 30.0, 30.0, 19.5, 14.5)
    assert (td > 0).any()
    np.testing.assert_array_equal(td, jd)
    rng = np.random.default_rng(3)
    o = rng.uniform(-0.2, 0.2, (64, 3)).astype(np.float32)
    d = rng.standard_normal((64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    np.testing.assert_array_equal(tml.MeshRaycaster(v, t).cast_rays(o, d),
                                  jml.MeshRaycaster(v, t).cast_rays(o, d))
    np.testing.assert_array_equal(tml.sample_surface(v, t, 500, seed=4),
                                  jml.sample_surface(v, t, 500, seed=4))


def test_library_builds_into_build_dir():
    from nice_slam_torch.ops import kernels

    tml.marching_cubes(*_field(n=6)[:1], 0.0)
    assert "mesh_kernels" in kernels.sources()
    path = kernels.build(["mesh_kernels"])["mesh_kernels"]
    assert os.path.dirname(path) == kernels.BUILD_DIR
    assert os.path.basename(path).startswith("libmesh_kernels-")


def test_a_failed_host_build_raises(tmp_path, monkeypatch):
    """No fallback: a source that does not compile, or no g++, raises."""
    from nice_slam_torch.ops import kernels

    (tmp_path / "broken.cpp").write_text("extern \"C\" int f( { return 0; }\n")
    monkeypatch.setattr(kernels, "CSRC", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="build failed for broken.cpp"):
        kernels.build(["broken"])
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        kernels.build(["broken"])


# ---------------------------------------------------------------------------
# visibility masks
# ---------------------------------------------------------------------------

def _masks_both(pts, c2w, depth, depth_test):
    js, jf = jmesher._frame_masks(jnp.asarray(pts), jnp.asarray(c2w), jnp.asarray(depth),
                                  H, W, F, F, 15.5, 11.5, depth_test)
    ts, tf = tmesher._frame_masks(torch.tensor(pts), torch.tensor(c2w), torch.tensor(depth),
                                  H, W, F, F, 15.5, 11.5, depth_test)
    return (np.asarray(js), np.asarray(jf)), (ts.numpy(), tf.numpy())


@pytest.mark.parametrize("variant", ["depth_test", "depth_bound", "all_frames_zero_depth"])
def test_frame_masks_equal_jax(variant):
    rng = np.random.default_rng(7)
    pts = rng.uniform(-4.0, 4.0, (4000, 3)).astype(np.float32)
    pose = Synthetic({"dataset": "synthetic", "cam": {
        "H": H, "W": W, "fx": F, "fy": F, "cx": 15.5, "cy": 11.5,
        "png_depth_scale": 1.0, "crop_edge": 0}, "data": {"n_frames": 8}})
    _, _, depth, c2w = pose[3]
    if variant == "all_frames_zero_depth":
        depth = np.zeros_like(depth)
    (js, jf), (ts, tf) = _masks_both(pts, c2w, depth, variant == "depth_test")
    assert 0 < js.sum() < len(pts) and jf.sum() > js.sum()
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tf, jf)


def test_frame_masks_reference_cases():
    """test_mesher_masks.py's cases on the port: no depth bound for an
    all-zero image, the 1.1 x max depth bound, the +-2.4 depth window."""
    eye = np.eye(4, dtype=np.float32)
    zero = np.zeros((H, W), np.float32)
    pts = np.array([[0, 0, -1.0], [0, 0, -5.0], [0, 0, 2.0]], np.float32)
    s, _ = tmesher._frame_masks(torch.tensor(pts), torch.tensor(eye), torch.tensor(zero),
                                H, W, F, F, 15.5, 11.5, False)
    assert s.tolist() == [True, True, False]
    pts = np.array([[0, 0, -1.0], [0, 0, -3.0]], np.float32)
    s, _ = tmesher._frame_masks(torch.tensor(pts), torch.tensor(eye),
                                torch.full((H, W), 2.0), H, W, F, F, 15.5, 11.5, False)
    assert s.tolist() == [True, False]
    pts = np.array([[0, 0, -2.0], [0, 0, -0.3]], np.float32)
    s, _ = tmesher._frame_masks(torch.tensor(pts), torch.tensor(eye),
                                torch.full((H, W), 3.0), H, W, F, F, 15.5, 11.5, True)
    assert s.tolist() == [True, False]


# ---------------------------------------------------------------------------
# occupancy and whole meshes on one scene
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    cfg = jload_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                       os.path.join(ROOT, "configs", "nice_slam.yaml"))
    cfg["coarse"] = True
    cfg["verbose"] = False
    for k in ("coarse", "middle_fine"):
        cfg["pretrained_decoders"][k] = os.path.join(ROOT, cfg["pretrained_decoders"][k])
    cfg["cam"].update({"H": H, "W": W, "fx": F, "fy": F, "cx": 15.5, "cy": 11.5})
    cfg["data"]["n_frames"] = 6
    cfg["meshing"]["resolution"] = 40
    jspec, jstate = jscene.build_scene(cfg, nice=True, seed=3)
    jstate = jpre.load_pretrain(cfg, jspec, jstate, verbose=False)
    rng = np.random.default_rng(4)
    jstate = jstate._replace(grids={
        k: jnp.asarray(0.3 * rng.standard_normal(v.shape), jnp.float32)
        for k, v in jstate.grids.items()})
    tspec, _ = tscene.build_scene(cfg, nice=True, device="cpu")
    tstate = scene_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    ds = Synthetic(cfg)
    est = np.stack([ds[i][3] for i in range(len(ds))])
    jkf = JKeyframes(4, H, W)
    tkf = TKeyframes(4, H, W, "cpu")
    for i in (0, 5):
        _, color, depth, c2w = ds[i]
        jkf.add(i, color, depth, c2w, c2w)
        tkf.add(i, color, depth, c2w, c2w)
    return cfg, (jspec, jstate, jkf), (tspec, tstate, tkf), est


def test_chunked_eval_and_color_match_jax(scene):
    _, (jspec, jstate, _), (tspec, tstate, _), _ = scene
    pts = np.random.default_rng(5).uniform(-2.4, 2.4, (2500, 3)).astype(np.float32)
    j = jmesher.chunked_eval(jspec, jstate, pts, "fine", 1000)
    t = tmesher.chunked_eval(tspec, tstate, pts, "fine", 1000)
    assert t.shape == j.shape == (2500,)
    np.testing.assert_allclose(t, j, atol=LOGIT_ATOL, rtol=0)
    j = jmesher.chunked_color(jspec, jstate, pts, 1000)
    t = tmesher.chunked_color(tspec, tstate, pts, 1000)
    np.testing.assert_allclose(t, j, atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("eval_rec", [False, True])
def test_get_mesh_matches_jax(scene, tmp_path, eval_rec):
    cfg, (jspec, jstate, jkf), (tspec, tstate, tkf), est = scene
    cam = dict(cfg["cam"])
    jpath, tpath = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    jmesher.Mesher(cfg, cam, jspec, str(tmp_path)).get_mesh(
        jpath, jstate, jkf, est, 5, get_mask_use_all_frames=eval_rec)
    tm = tmesher.Mesher(cfg, cam, tspec)
    tm.get_mesh(tpath, tstate, tkf, torch.tensor(est), 5,
                get_mask_use_all_frames=eval_rec)
    jv, jf, jc = jml.read_ply(jpath)
    tv, tf, tc = tml.read_ply(tpath)
    assert len(jf) > 100
    assert abs(len(tf) - len(jf)) <= 0.01 * len(jf)
    assert tm.last["faces"] == len(tf) and tm.last["vertices"] == len(tv)
    assert tm.last["lattice_chunks"] == 1 and tm.last["color_chunks"] == 1
    b = np.asarray(cfg["mapping"]["marching_cubes_bound"])
    voxel = float(np.max(b[:, 1] - b[:, 0] + 0.1)) / (tm.resolution - 1)
    assert cKDTree(jv).query(tv)[0].max() <= 0.5 * voxel
    assert tc is not None and tc.shape == tv.shape


def test_imap_colouring_not_ported(scene, tmp_path):
    """The iMAP* colouring (rendering along the vertex normals) is ported
    now: on this scene's mesh its vertex colours match the JAX package's
    (uint8, within 2 levels at the nearest JAX vertex)."""
    cfg, (jspec, jstate, jkf), (tspec, tstate, tkf), est = scene
    cfg = dict(cfg, meshing=dict(cfg["meshing"], color_mesh_extraction_method="render_ray_along_normal"))
    jpath, tpath = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    jmesher.Mesher(cfg, dict(cfg["cam"]), jspec, str(tmp_path)).get_mesh(
        jpath, jstate, jkf, est, 5)
    tm = tmesher.Mesher(cfg, dict(cfg["cam"]), tspec)
    tm.get_mesh(tpath, tstate, tkf, torch.tensor(est), 5)
    jv, _, jc = jml.read_ply(jpath)
    tv, _, tc = tml.read_ply(tpath)
    dist, nearest = cKDTree(jv).query(tv)
    b = np.asarray(cfg["mapping"]["marching_cubes_bound"])
    assert dist.max() <= 0.5 * float(np.max(b[:, 1] - b[:, 0] + 0.1)) / (tm.resolution - 1)
    assert tc is not None and np.abs(tc.astype(int) - jc[nearest].astype(int)).max() <= 2
