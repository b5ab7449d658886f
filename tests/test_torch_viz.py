"""The port's viewers against the JAX package's and OpenCV: the mesh
renderer, the trajectory overlay, the Motion-JPEG video, the web
frontend's responses, the frontend factory, the plasma colour map and
the visualizer CLI on a checkpoint the port wrote.

Tolerances: depth 1e-5 absolute and colour within one 8-bit level of the
JAX renderer (the same raycaster and colour rule, float32 summation
order); every decoded video frame at >= 30 dB PSNR against its rendered
frame (Motion-JPEG at quality 90).
"""

import json
import os
import socket
import subprocess
import sys
import time
import types
import urllib.request

import cv2
import numpy as np
import pytest
import torch
import yaml

from nice_slam_torch.tools import viz as tviz
from nice_slam_torch.utils import meshlib as tmesh
from nice_slam_tpu.tools import viz as jviz

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CAM = (60, 80, 60.0, 60.0, 39.5, 29.5)  # H, W, fx, fy, cx, cy


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several tier-1 workers share few cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _room_mesh(path, coloured=True):
    """tests/test_viz.py's box room (a closed box surface of half-size 1 m),
    with vertex colours varying over it."""
    n = 24
    g = np.linspace(-1.5, 1.5, n).astype(np.float32)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    f = 1.0 - np.maximum.reduce([np.abs(X), np.abs(Y), np.abs(Z)])
    sp = 3.0 / (n - 1)
    v, t = tmesh.marching_cubes(f, 0.0, origin=(-1.5,) * 3, spacing=(sp,) * 3)
    colors = None
    if coloured:
        colors = np.clip((v + 1.0) * 120 + 10, 0, 255).astype(np.uint8)
    tmesh.write_ply(path, v, t, colors)
    return path


def _poses(n):
    out = []
    for i in range(n):
        a = 0.3 * i
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                                [-np.sin(a), 0, np.cos(a)]], np.float32)
        c2w[0, 3] = 0.1 * i
        out.append(c2w)
    return out


@pytest.mark.parametrize("coloured", [True, False])
def test_mesh_renderer_matches_jax(tmp_path, coloured):
    path = _room_mesh(str(tmp_path / "room.ply"), coloured)
    v, t, c = tmesh.read_ply(path)
    a = jviz.MeshRenderer(v, t, c)
    b = tviz.MeshRenderer(v, t, c)
    for c2w in _poses(3):
        ia, da = a.render(c2w, *CAM)
        ib, db = b.render(c2w, *CAM)
        np.testing.assert_allclose(db, da, atol=1e-5)
        assert np.abs(ib.astype(int) - ia.astype(int)).max() <= 1
        assert (db > 0).mean() > 0.9  # inside the box, every ray hits a wall
    np.testing.assert_allclose(b.face_normals, a.face_normals, atol=1e-6)


def test_traj_overlay_matches_cv2_line():
    rng = np.random.default_rng(0)
    H, W = 60, 80
    for trial in range(60):
        lo = -40 if trial % 2 else 0  # half the polylines leave the image
        pts = [tuple(int(x) for x in rng.integers(lo, [W - lo, H - lo]))
               for _ in range(8)]
        if trial % 3 == 0:
            pts[3] = None
        ref = np.zeros((H, W, 3), np.uint8)
        for a, b in zip(pts[:-1], pts[1:]):
            if a is not None and b is not None:
                cv2.line(ref, a, b, (255, 0, 0), 1)
        got = tviz.draw_traj_overlay(np.zeros((H, W, 3), np.uint8), pts)
        np.testing.assert_array_equal(got, ref)
    # steep, shallow, reversed, single-point and fully clipped segments
    for a, b in (((5, 1), (9, 50)), ((70, 3), (2, 10)), ((4, 4), (4, 4)),
                 ((-10, -10), (-1, 30)), ((79, 59), (0, 0)), ((-30, 70), (100, -20))):
        ref = np.zeros((H, W, 3), np.uint8)
        cv2.line(ref, a, b, (255, 0, 0), 1)
        got = tviz.draw_traj_overlay(np.zeros((H, W, 3), np.uint8), [a, b])
        np.testing.assert_array_equal(got, ref)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


def test_frontend_video_reads_back_in_opencv(tmp_path):
    from nice_slam_torch.utils.imageio import imread_color
    from nice_slam_torch.utils.mjpeg_mp4 import read_mp4_jpegs

    path = _room_mesh(str(tmp_path / "room.ply"))
    fe = tviz.SLAMFrontend(str(tmp_path), init_pose=np.eye(4), save_rendering=True,
                           near=1)
    assert fe.update_pose(0, np.eye(4, dtype=np.float32)) is None  # no mesh yet
    fe.update_mesh(path)
    rendered = []
    for i, c2w in enumerate(_poses(5)):
        img = fe.update_pose(i, c2w)
        if i < 1:
            assert img is None  # before `near`
            continue
        rendered.append(img)
        jpg = imread_color(str(tmp_path / "tmp_rendering" / f"{i:05d}.jpg"))
        assert _psnr(jpg, img) >= 30.0
    video = fe.finalize_video(str(tmp_path / "vis.mp4"), fps=5)
    assert len(read_mp4_jpegs(video)) == len(rendered)
    cap = cv2.VideoCapture(video)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == len(rendered)
    assert (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))) == (640, 480)
    frames = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        frames.append(bgr[..., ::-1])
    cap.release()
    assert len(frames) == len(rendered)
    for got, want in zip(frames, rendered):
        assert _psnr(got, want) >= 30.0
    assert tviz.SLAMFrontend(str(tmp_path), None).finalize_video("x.mp4") is None


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read()


def test_web_frontend_responses_equal_jax(tmp_path):
    path = _room_mesh(str(tmp_path / "room.ply"))
    gt = np.stack(_poses(4))
    bodies = {}
    for name, make in (("jax", jviz.make_frontend), ("port", tviz.make_frontend)):
        fe = make(str(tmp_path), init_pose=np.eye(4), frontend="web", port=0,
                  gt_c2w_list=gt, near=1)
        try:
            assert fe._server.server_address[0] == "127.0.0.1"
            base = f"http://127.0.0.1:{fe.port}"
            empty = _get(base + "/mesh.bin")
            fe.update_mesh(path)
            for i, c2w in enumerate(_poses(4)):
                fe.update_pose(i, c2w)
            fe.finalize_video("")
            bodies[name] = {"page": _get(base + "/").decode(), "empty": empty,
                            "state": json.loads(_get(base + "/state")),
                            "mesh": _get(base + "/mesh.bin")}
            with pytest.raises(urllib.error.HTTPError):
                _get(base + "/nothing")
        finally:
            fe.close()
    j, t = bodies["jax"], bodies["port"]
    assert t["page"] == j["page"].replace("nice_slam_tpu viewer", "nice_slam_torch viewer")
    assert t["state"] == j["state"] and t["state"]["done"] and t["state"]["idx"] == 3
    assert len(t["state"]["est"]) == 3 and len(t["state"]["frustum"]) == 16
    assert t["mesh"] == j["mesh"] and t["empty"] == j["empty"] == b"\0" * 8
    v, tris, c = tmesh.read_ply(path)
    assert t["mesh"] == (np.array([len(v), len(tris)], "<u4").tobytes()
                         + v.astype("<f4").tobytes() + c.tobytes()
                         + b"\0" * ((-len(v) * 3) % 4) + tris.astype("<u4").tobytes())


def test_web_frontend_warns_on_save_rendering(tmp_path):
    with pytest.warns(UserWarning, match="save_rendering"):
        fe = tviz.make_frontend(str(tmp_path), init_pose=np.eye(4), frontend="web",
                                port=0, save_rendering=True)
    fe.close()


def _stub_open3d(window_ok):
    o3d = types.ModuleType("open3d")

    class Visualizer:
        def create_window(self, **kw):
            return window_ok

    o3d.visualization = types.SimpleNamespace(Visualizer=Visualizer)
    o3d.geometry = types.SimpleNamespace(LineSet=lambda *a, **k: object())
    return o3d


def test_make_frontend_choice(tmp_path, monkeypatch):
    # open3d absent: the offline replay; an explicit request raises
    monkeypatch.setitem(sys.modules, "open3d", None)
    assert type(tviz.make_frontend(str(tmp_path), init_pose=np.eye(4))) is tviz.SLAMFrontend
    with pytest.raises(ImportError):
        tviz.make_frontend(str(tmp_path), init_pose=np.eye(4), online=True)
    with pytest.raises(ImportError):
        tviz.make_frontend(str(tmp_path), init_pose=np.eye(4), frontend="open3d")
    assert type(tviz.make_frontend(str(tmp_path), init_pose=np.eye(4),
                                   frontend="offline")) is tviz.SLAMFrontend
    # open3d importable: its window, unless the window cannot open
    monkeypatch.setitem(sys.modules, "open3d", _stub_open3d(True))
    assert type(tviz.make_frontend(str(tmp_path), init_pose=np.eye(4))) is tviz.O3DFrontend
    assert type(tviz.make_frontend(str(tmp_path), init_pose=np.eye(4),
                                   online=False)) is tviz.SLAMFrontend
    monkeypatch.setitem(sys.modules, "open3d", _stub_open3d(False))
    assert type(tviz.make_frontend(str(tmp_path), init_pose=np.eye(4))) is tviz.SLAMFrontend
    with pytest.raises(RuntimeError, match="window"):
        tviz.make_frontend(str(tmp_path), init_pose=np.eye(4), online=True)


def test_plasma_table_equals_cv2():
    from nice_slam_torch.utils.colormap import PLASMA_RGB, apply_plasma

    x = np.arange(256, dtype=np.uint8)
    ref = cv2.applyColorMap(x[None], cv2.COLORMAP_PLASMA)[0][:, ::-1]
    np.testing.assert_array_equal(PLASMA_RGB, ref)
    img = np.random.default_rng(0).integers(0, 256, (7, 9)).astype(np.uint8)
    np.testing.assert_array_equal(apply_plasma(img),
                                  cv2.applyColorMap(img, cv2.COLORMAP_PLASMA)[..., ::-1])


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A checkpoint the port's Logger wrote for frames 0-3 of the box
    scene, and a mesh at frame 2, behind a config file."""
    from nice_slam_torch.config import load_config
    from nice_slam_torch.models.scene import build_scene
    from nice_slam_torch.utils.datasets import Synthetic
    from nice_slam_torch.utils.logger import Logger

    tmp = tmp_path_factory.mktemp("run")
    out = str(tmp / "out")
    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "nice_slam.yaml"))
    cfg["data"].update(n_frames=6, output=out)
    cfg_path = str(tmp / "box.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"inherit_from": os.path.join(ROOT, "configs", "Synthetic",
                                                     "box.yaml"),
                        "data": {"n_frames": 6, "output": out}}, f)
    spec, state = build_scene(cfg, device="cpu")
    reader = Synthetic(cfg)
    gt = np.stack([reader[i][3] for i in range(6)]).astype(np.float32)
    est = gt.copy()
    est[:, 0, 3] += 0.01
    Logger(out, spec, verbose=False).log(3, state, torch.tensor(est), gt, [0, 3])
    os.makedirs(os.path.join(out, "mesh"), exist_ok=True)
    _room_mesh(os.path.join(out, "mesh", "00002_mesh.ply"))
    return dict(cfg_path=cfg_path, out=out, est=est, gt=gt, reader=reader)


def test_visualizer_cli_offline(tiny_run):
    from nice_slam_torch import visualizer
    from nice_slam_torch.utils.imageio import imread_color
    from nice_slam_torch.utils.mjpeg_mp4 import read_mp4_jpegs

    out = tiny_run["out"]
    fe = visualizer.main([tiny_run["cfg_path"], "--save_rendering", "--vis_input_frame",
                          "--frontend", "offline"])
    assert type(fe) is tviz.SLAMFrontend and len(fe.frames) == 4  # frames 0-3
    assert len(read_mp4_jpegs(os.path.join(out, "vis.mp4"))) == 4
    assert sorted(os.listdir(os.path.join(out, "tmp_rendering"))) == [
        f"{i:05d}.jpg" for i in range(4)]
    # the input panels: colour beside plasma depth, as the root viewer's
    for i in range(4):
        panel = imread_color(os.path.join(out, "inputs", f"{i:05d}.jpg"))
        _, color, depth, _ = tiny_run["reader"][i]
        want = visualizer.input_panel(color, depth)
        assert panel.shape == want.shape
        assert _psnr(panel, want) >= 30.0


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_visualizer_cli_web(tiny_run):
    """``--frontend web`` in its own process: it serves the page, the
    run's mesh and its poses, and stays up after the replay."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "nice_slam_torch.visualizer", tiny_run["cfg_path"],
         "--frontend", "web", "--port", str(port)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        base = f"http://127.0.0.1:{port}"
        state = None
        for _ in range(600):
            try:
                state = json.loads(_get(base + "/state"))
                if state["done"]:
                    break
            except OSError:
                pass
            assert proc.poll() is None, proc.stdout.read().decode()
            time.sleep(0.1)
        assert state is not None and state["done"] and state["idx"] == 3
        np.testing.assert_allclose(state["est"], tiny_run["est"][:4, :3, 3],
                                   atol=1e-6)
        np.testing.assert_allclose(state["gt"], tiny_run["gt"][:4, :3, 3], atol=1e-6)
        assert b"webgl" in _get(base + "/")
        v, t, c = tmesh.read_ply(os.path.join(tiny_run["out"], "mesh", "00002_mesh.ply"))
        from nice_slam_torch.tools.webviz import mesh_blob

        assert _get(base + "/mesh.bin") == mesh_blob(v, t, c)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
