"""The port's evaluation tools (``nice_slam_torch/tools/eval_ate.py``,
``eval_recon.py``, ``cull_mesh.py`` and ``selfcheck.gt_room_mesh``)
against the JAX package's, on the same inputs made from a seed with
numpy, and the cases of ``tests/test_eval_tools.py`` for the port.

Both packages run the same float64 numpy and scipy code over their own
copies of the host mesh library, so most results are equal; the pose
quaternions go through each framework's float32 rotation-to-quaternion
(atol 1e-6), and the 2D metric's depth L1 through the same raycaster
(rtol 1e-6)."""

import os

import numpy as np
import pytest

from nice_slam_tpu.tools import cull_mesh as jcull
from nice_slam_tpu.tools import eval_ate as jate
from nice_slam_tpu.tools import eval_recon as jrec
from nice_slam_tpu.tools import selfcheck as jself
from nice_slam_tpu.utils import datasets as jds
from nice_slam_tpu.utils import meshlib as jmesh
from nice_slam_torch.tools import cull_mesh as tcull
from nice_slam_torch.tools import eval_ate as tate
from nice_slam_torch.tools import eval_recon as trec
from nice_slam_torch.tools import selfcheck as tself
from nice_slam_torch.utils import datasets as tds
from nice_slam_torch.utils import meshlib as tmesh


def _random_rot(seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return Q


def _poses(n, seed):
    rng = np.random.default_rng(seed)
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        out[i, :3, :3] = _random_rot(seed + i)
        out[i, :3, 3] = rng.normal(size=3)
    return out.astype(np.float32)


# the cases of tests/test_eval_tools.py, for the port

def test_align_recovers_rigid_transform():
    rng = np.random.default_rng(0)
    traj = rng.normal(size=(3, 50))
    R = _random_rot(1)
    rot, _, err = tate.align(R @ traj + np.array([[1.0], [-2.0], [0.5]]), traj)
    np.testing.assert_allclose(err, 0.0, atol=1e-9)
    np.testing.assert_allclose(rot @ R, np.eye(3), atol=1e-9)


def test_evaluate_ate_known_error():
    rng = np.random.default_rng(2)
    gt = {i: rng.normal(size=3) for i in range(20)}
    res = tate.evaluate_ate(gt, {i: gt[i].copy() for i in range(20)})
    assert res["absolute_translational_error.rmse"] < 1e-9
    assert res["compared_pose_pairs"] == 20


def test_associate_greedy_nearest():
    first = {0.0: [0], 1.0: [1], 2.0: [2]}
    second = {0.004: [0], 1.01: [1], 5.0: [2]}
    assert tate.associate(first, second, max_difference=0.02) == [(0.0, 0.004), (1.0, 1.01)]


def test_icp_recovers_small_offset():
    pts = np.random.default_rng(3).uniform(-1, 1, (2000, 3))
    offset = np.array([0.03, -0.02, 0.01])
    T = trec.icp_p2p(pts + offset, pts, threshold=0.2)
    np.testing.assert_allclose(T[:3, 3], -offset, atol=5e-3)


def test_recon_metrics_identical_points():
    pts = np.random.default_rng(4).uniform(-1, 1, (5000, 3))
    assert trec.accuracy(pts, pts) < 1e-9
    assert trec.completion(pts, pts) < 1e-9
    assert trec.completion_ratio(pts, pts) == 1.0


def test_recon_metrics_known_offset():
    gt = np.random.default_rng(5).uniform(-1, 1, (3000, 3))
    rec = gt + np.array([0.02, 0.0, 0.0])
    assert 0.018 < trec.accuracy(gt, rec) <= 0.02 + 1e-9
    assert trec.completion_ratio(gt, rec, dist_th=0.05) == 1.0
    assert trec.completion_ratio(gt, rec, dist_th=0.01) < 0.01


def test_cull_mesh_drops_behind_camera():
    verts = np.array([[0, 0, -2], [0.1, 0, -2], [0, 0.1, -2],
                      [0, 0, 2], [0.1, 0, 2], [0, 0.1, 2]], np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5]], np.int64)
    kept = tcull.cull_mesh(verts, faces, [np.eye(4, dtype=np.float32)], H=60, W=80,
                           fx=60.0, fy=60.0, cx=39.5, cy=29.5)
    assert len(kept) == 1 and (kept[0] == [0, 1, 2]).all()


def test_raycast_depth_l1_between_meshes():
    def sphere(r, n=36):
        g = np.linspace(-1.5, 1.5, n).astype(np.float32)
        X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
        sp = 3.0 / (n - 1)
        return tmesh.marching_cubes(r - np.sqrt(X ** 2 + Y ** 2 + Z ** 2), 0.0,
                                    origin=(-1.5,) * 3, spacing=(sp,) * 3)

    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = -3.0
    d1 = tmesh.MeshRaycaster(*sphere(1.0)).render_depth(c2w, 50, 50, 100.0, 100.0, 24.5, 24.5)
    d2 = tmesh.MeshRaycaster(*sphere(0.9)).render_depth(c2w, 50, 50, 100.0, 100.0, 24.5, 24.5)
    hit = (d1 > 0) & (d2 > 0)
    assert hit.mean() > 0.5
    assert 0.08 < np.mean(np.abs(d1 - d2)[hit]) < 0.3


# parity with the JAX package's functions

def test_associate_matches_jax():
    rng = np.random.default_rng(6)
    first = {float(t): rng.normal(size=7) for t in np.cumsum(rng.uniform(0.01, 0.05, 60))}
    second = {float(t): rng.normal(size=7) for t in np.cumsum(rng.uniform(0.01, 0.05, 60))}
    for offset, maxd in ((0.0, 0.02), (0.01, 0.03)):
        assert tate.associate(first, second, offset, maxd) == \
            jate.associate(first, second, offset, maxd)


def test_evaluate_ate_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    gt = {i: rng.normal(size=7) for i in range(40)}
    R, t = _random_rot(8), rng.normal(size=3)
    est = {i: np.concatenate([R @ gt[i][:3] + t + rng.normal(0, 0.01, 3), gt[i][3:]])
           for i in range(40)}
    plot = str(tmp_path / "plot.jpg")
    got = tate.evaluate_ate(gt, est, plot=plot, scale=1.1)
    ref = jate.evaluate_ate(gt, est, scale=1.1)
    assert got == ref
    from nice_slam_torch.utils.imageio import imread_color

    img = imread_color(plot)  # the aligned trajectories, drawn with the port's writer
    assert img.shape == (480, 640, 3) and (img < 128).any()


def test_convert_poses_matches_jax():
    c2w = _poses(12, 9)
    c2w[4, 0, 0] = np.nan  # masked out of the ground truth
    c2w[7, 1, 3] = np.inf
    for gt in (True, False):
        if not gt:
            c2w = np.nan_to_num(c2w, nan=0.0, posinf=0.0)
        tp, tm = tate.convert_poses(c2w, 10, 2.0, gt=gt)
        jp, jm = jate.convert_poses(c2w, 10, 2.0, gt=gt)
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(tp[:, :3], jp[:, :3])  # translations
        # quaternions up to sign
        sign = np.sign(np.sum(tp[:, 3:] * jp[:, 3:], axis=1, keepdims=True))
        np.testing.assert_allclose(tp[:, 3:] * sign, jp[:, 3:], atol=1e-6)


def test_icp_matches_jax():
    rng = np.random.default_rng(10)
    dst = rng.uniform(-1, 1, (3000, 3))
    R = _random_rot(11)
    src = (dst @ (np.eye(3) + 0.02 * (R - np.eye(3))).T + np.array([0.02, -0.01, 0.03]))
    np.testing.assert_array_equal(trec.icp_p2p(src, dst), jrec.icp_p2p(src, dst))


def test_get_cam_position_check_proj_viewmatrix_match_jax(tmp_path):
    v, t = _sphere_mesh(1.3)
    path = str(tmp_path / "m.ply")
    tmesh.write_ply(path, v, t)
    for a, b in zip(trec.get_cam_position(path), jrec.get_cam_position(path)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(12)
    pts = rng.uniform(-2, 2, (500, 3))
    up = np.array([0.0, 0.0, -1.0])
    for k in range(20):
        z, pos = rng.normal(size=3), rng.normal(size=3)
        c2w = np.eye(4)
        c2w[:3, :] = trec.viewmatrix(z, up, pos)
        np.testing.assert_array_equal(c2w[:3, :], jrec.viewmatrix(z, up, pos))
        assert trec.check_proj(pts[:5 * (k + 1)], 500, 500, 300.0, 300.0, 249.5, 249.5, c2w) \
            == jrec.check_proj(pts[:5 * (k + 1)], 500, 500, 300.0, 300.0, 249.5, 249.5, c2w)


def _sphere_mesh(r, n=40, shift=(0.0, 0.0, 0.0)):
    g = np.linspace(-2, 2, n).astype(np.float32)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    f = r - np.sqrt((X - shift[0]) ** 2 + (Y - shift[1]) ** 2 + (Z - shift[2]) ** 2)
    return tmesh.marching_cubes(f, 0.0, origin=(-2.0,) * 3, spacing=(4.0 / (n - 1),) * 3)


@pytest.fixture(scope="module")
def mesh_pair(tmp_path_factory):
    """A room-like ground truth (a box's walls, with the +x wall as its
    unseen cloud, so that the 2D metric rejects views of it) and a
    perturbed reconstruction of it."""
    d = tmp_path_factory.mktemp("meshes")
    g = np.linspace(-2.2, 2.2, 40).astype(np.float32)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    walls = np.minimum.reduce([X + 2, 2 - X, Y + 2, 2 - Y, Z + 2, 2 - Z])
    v, t = tmesh.marching_cubes(walls, 0.0, origin=(-2.2,) * 3, spacing=(4.4 / 39,) * 3)
    gt = str(d / "gt.ply")
    tmesh.write_ply(gt, v, t)
    np.save(gt.replace(".ply", "_pc_unseen.npy"), v[v[:, 0] > 1.9])
    rng = np.random.default_rng(13)
    rec = str(d / "rec.ply")
    tmesh.write_ply(rec, v + rng.normal(0, 0.01, v.shape).astype(np.float32)
                    + np.array([0.02, 0.0, -0.01], np.float32), t)
    cam = {"H": 60, "W": 80, "fx": 60.0, "fy": 60.0, "cx": 39.5, "cy": 29.5}
    cfg = {"dataset": "synthetic", "cam": dict(cam, png_depth_scale=1.0, crop_edge=0),
           "data": {"n_frames": 8, "orbit_radians": 1.5}}
    return gt, rec, tds.Synthetic(cfg).poses, cam


def test_calc_3d_metric_matches_jax(mesh_pair):
    gt, rec = mesh_pair[:2]
    for align in (True, False):
        assert trec.calc_3d_metric(rec, gt, align=align) == \
            jrec.calc_3d_metric(rec, gt, align=align)


def test_calc_2d_metric_same_views_as_jax(mesh_pair):
    """One seed gives both packages the same views: the same depth L1."""
    gt, rec = mesh_pair[:2]
    got = trec.calc_2d_metric(rec, gt, n_imgs=6, seed=3)["depth_l1_cm"]
    ref = jrec.calc_2d_metric(rec, gt, n_imgs=6, seed=3)["depth_l1_cm"]
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    other = trec.calc_2d_metric(rec, gt, n_imgs=6, seed=4)["depth_l1_cm"]
    assert other != got  # the seed does choose the views


def test_cull_mesh_matches_jax(mesh_pair):
    _, _, poses, cam = mesh_pair
    v, t = _sphere_mesh(1.5)
    args = (v, t, poses[:3], cam["H"], cam["W"], cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    kept = tcull.cull_mesh(*args)
    assert 0 < len(kept) < len(t)
    np.testing.assert_array_equal(kept, jcull.cull_mesh(*args))


def test_load_poses_matches_jax(tmp_path):
    path = str(tmp_path / "traj.txt")
    np.savetxt(path, _poses(5, 14).reshape(5, 16))
    for a, b in zip(tcull.load_poses(path), jcull.load_poses(path)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scene", ["box", "furnished"])
def test_gt_room_mesh_matches_jax(tmp_path, scene):
    cam = {"H": 60, "W": 80, "fx": 60.0, "fy": 60.0, "cx": 39.5, "cy": 29.5}
    cfg = {"dataset": "synthetic", "cam": dict(cam, png_depth_scale=1.0, crop_edge=0),
           "data": {"n_frames": 6, "orbit_radians": 1.0, "scene": scene}}
    jsyn, tsyn = jds.Synthetic(cfg), tds.Synthetic(cfg)
    grid = np.random.default_rng(15).uniform(-2.2, 2.2, (1000, 3)).astype(np.float32)
    np.testing.assert_array_equal(tsyn.scene_sdf(grid), jsyn.scene_sdf(grid))
    tp, jp = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    tself.gt_room_mesh(tsyn.room, tp, tsyn.poses, cam, resolution=36, sdf=tsyn.scene_sdf)
    jself.gt_room_mesh(jsyn.room, jp, jsyn.poses, cam, resolution=36, sdf=jsyn.scene_sdf)
    for a, b in zip(tmesh.read_ply(tp), jmesh.read_ply(jp)):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.load(tp.replace(".ply", "_pc_unseen.npy")),
                                  np.load(jp.replace(".ply", "_pc_unseen.npy")))
    assert os.path.getsize(tp) > 1000
