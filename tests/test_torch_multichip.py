"""The port's ray and lattice data parallelism (``nice_slam_torch/parallel/
sharding.py``, the mapper, the mesher) against the JAX package's, case for
case with ``tests/test_multichip.py``: the JAX side on the conftest's 8
virtual CPU devices (``make_mesh(8)``), the port over ``devices=[cpu] *
8``, both fed the same numpy inputs (and, for the mapping call, the JAX
call's own pixel draws).

Tolerances: the JAX tests' own (a data-parallel loss sums per-block
partial sums, so it differs from the one-batch sum by float32 rounding:
losses rtol 2e-4, grids atol 5e-5 after a call; lattice queries 1e-5).
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nice_slam_tpu.config import load_config
from nice_slam_tpu.ops import interp as jinterp
from nice_slam_tpu.parallel.sharding import make_mesh
from nice_slam_torch.convert import scene_from_jax, scene_to_numpy

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CPU = torch.device("cpu")
DEVICES = [CPU] * 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several workers share few cores in the tier-1 run: one torch
    thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_cfg():
    return {
        "scale": 1, "coarse": False, "occupancy": True,
        "grid_len": {"coarse": 2, "middle": 1.1, "fine": 0.55, "color": 0.55,
                     "bound_divisible": 1.1},
        "model": {"c_dim": 8, "coarse_bound_enlarge": 2,
                  "pos_embedding_method": "fourier"},
        "data": {"dim": 3},
        "mapping": {"bound": [[-2.2, 2.2]] * 3},
        "rendering": {"N_samples": 8, "N_surface": 4, "N_importance": 0,
                      "lindisp": False, "perturb": 0.0},
    }


def _tiny_scene():
    from nice_slam_tpu.models.scene import build_scene as jbuild
    from nice_slam_tpu.ops.render import RenderConfig as JRender
    from nice_slam_torch.models.scene import build_scene as tbuild
    from nice_slam_torch.ops.render import RenderConfig as TRender

    cfg = _tiny_cfg()
    jspec, jstate = jbuild(cfg, nice=True, seed=0)
    tspec, _ = tbuild(cfg, nice=True, device="cpu")
    tstate = scene_from_jax(jax.tree.map(np.asarray, jstate), CPU)
    return jspec, jstate, JRender.from_cfg(cfg), tspec, tstate, TRender.from_cfg(cfg)


def test_sharded_map_step_runs_and_is_finite(monkeypatch):
    """One data-parallel mapping step over 8 devices: finite, the grids
    moved, and equal to the JAX package's step over its 8-device mesh and
    to the port's one-device step."""
    from nice_slam_tpu.parallel.sharding import make_sharded_map_step as jstep_fn
    from nice_slam_torch.parallel.sharding import make_sharded_map_step

    monkeypatch.setattr(jinterp, "_DGRAD_BF16", False)
    monkeypatch.setattr(jinterp, "_SEGSUM_MODE", "0")
    jspec, jstate, jrcfg, tspec, tstate, trcfg = _tiny_scene()
    rng = np.random.default_rng(0)
    n = 64
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    batch = (np.zeros((n, 3), np.float32), dirs, np.full((n,), 1.5, np.float32),
             np.full((n, 3), 0.5, np.float32))

    out = {}
    for name, devices in (("dp", DEVICES), ("one", [CPU])):
        step, shard_batch, replicate, init_adam = make_sharded_map_step(
            devices, tspec, "color", trcfg)
        state_r = replicate(tstate)
        new_state, _, loss = step(state_r, init_adam(state_r), *shard_batch(*batch))
        out[name] = (float(loss), new_state.grids["grid_color"].numpy())
    loss, grid = out["dp"]
    assert np.isfinite(loss)
    assert float(np.abs(grid - tstate.grids["grid_color"].numpy()).max()) > 0
    np.testing.assert_allclose(loss, out["one"][0], rtol=1e-5)
    np.testing.assert_allclose(grid, out["one"][1], atol=2e-5)

    mesh = make_mesh(8)
    jstep, jshard, jrep, jinit = jstep_fn(mesh, jspec, "color", jrcfg)
    js = jrep(jstate)
    jnew, _, jloss = jstep(js, jrep(jinit(js)), *jshard(*batch))
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    np.testing.assert_allclose(grid, np.asarray(jnew.grids["grid_color"]), atol=2e-5)


def _box_cfg(out):
    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "nice_slam.yaml"))
    cfg["coarse"] = False
    cfg["verbose"] = False
    cfg["data"]["n_frames"] = 6
    cfg["data"]["output"] = str(out)
    cfg["cam"].update({"H": 60, "W": 80, "fx": 60.0, "fy": 60.0,
                       "cx": 39.5, "cy": 29.5})
    cfg["tracking"].update({"pixels": 100, "iters": 4, "gt_camera": True})
    cfg["mapping"].update({"pixels": 320, "iters_first": 20, "iters": 10,
                           "every_frame": 5, "keyframe_every": 5,
                           "mesh_freq": 10 ** 6, "ckpt_freq": 10 ** 6})
    cfg["rendering"].update({"N_samples": 8, "N_surface": 4})
    cfg["meshing"]["resolution"] = 32  # the final mesh, through the lattice split
    for k in ("coarse", "middle_fine"):
        cfg["pretrained_decoders"][k] = os.path.join(ROOT, cfg["pretrained_decoders"][k])
    return cfg


def test_mapper_engages_mesh_in_slam(tmp_path):
    """A system over 8 devices splits its mapping rays and its mesher's
    lattice over them; its run (6 frames, ground-truth cameras) maps as the
    one-device run does: every mapping call's losses within rtol 1e-3 (the
    rounding of the split sums grows over the 20 + 10 + 10 iterations)."""
    from nice_slam_torch.slam.slam import NiceSLAM

    args = argparse.Namespace(nice=True, input_folder=None, output=None)
    runs = {}
    for name, devices in (("dp", DEVICES), ("one", [CPU])):
        slam = NiceSLAM(_box_cfg(tmp_path / name), args, devices=devices)
        if name == "dp":
            assert slam.mapper.devices == DEVICES and slam.mesher.devices == DEVICES
            assert slam.spatial_devices is None
        losses = []
        inner = slam.mapper.optimize_map

        def spy(*a, _inner=inner, _sink=losses, **k):
            out = _inner(*a, **k)
            _sink.append(out[2].numpy())
            return out

        slam.mapper.optimize_map = spy
        slam.run()
        assert slam.mapping_idx == 5
        assert os.path.exists(os.path.join(slam.output, "mesh", "final_mesh.ply"))
        runs[name] = losses
    assert [len(x) for x in runs["dp"]] == [len(x) for x in runs["one"]]
    for a, b in zip(runs["dp"], runs["one"]):
        np.testing.assert_allclose(a, b, rtol=1e-3)


def test_sharded_lattice_eval_matches_single_device():
    """Mesher occupancy queries split over 8 devices equal the one-device
    queries (1e-5) and the JAX package's over its 8-device mesh (5e-5)."""
    from nice_slam_tpu.utils.mesher import _eval_chunk as jeval_chunk
    from nice_slam_torch.utils.mesher import _eval_chunk, _query_devices

    jspec, jstate, _, tspec, tstate, _ = _tiny_scene()
    pts = np.random.default_rng(3).uniform(-2.4, 2.4, (4096, 3)).astype(np.float32)
    assert _query_devices(tstate, DEVICES) == DEVICES
    assert _query_devices(tstate, [CPU]) is None
    single = _eval_chunk(tspec, tstate, torch.tensor(pts), "fine", None).numpy()
    split = _eval_chunk(tspec, tstate, torch.tensor(pts), "fine", DEVICES).numpy()
    np.testing.assert_allclose(split, single, atol=1e-5)
    ref = np.asarray(jeval_chunk(jspec, jstate, jnp.asarray(pts), "fine", make_mesh(8)))
    np.testing.assert_allclose(split, ref, atol=5e-5)


def _jax_pixel_draws(key, n_iters, F, n, H, W):
    """The flat pixel indices optimize_map_jit draws: per global iteration
    i, fold_in(key, i) -> split -> split(F) -> randint over H*W."""
    out = []
    for i in range(n_iters):
        k_frames, _ = jax.random.split(jax.random.fold_in(key, i))
        fk = jax.random.split(k_frames, F)
        out.append(np.stack([np.asarray(jax.random.randint(fk[f], (n,), 0, H * W))
                             for f in range(F)]))
    return np.stack(out)


def test_sharded_map_call_matches_unsharded(monkeypatch):
    """The whole optimize_map call with each iteration's rays split over 8
    devices against the one-device call (the same pixels), and against the
    JAX call over its 8-device mesh fed to the port as its own pixel
    draws: losses rtol 2e-4, grids atol 5e-5 (the JAX test pins the f32
    grid-gradient buffer for the same reason)."""
    from nice_slam_tpu.slam.mapper import MapperConfig as JMC
    from nice_slam_tpu.slam.mapper import optimize_map_jit
    from nice_slam_torch.slam.mapper import MapperConfig, optimize_map_core

    monkeypatch.setattr(jinterp, "_DGRAD_BF16", False)
    jspec, jstate, jrcfg, tspec, tstate, trcfg = _tiny_scene()
    H, W = 48, 64
    cam = {"H": H, "W": W, "fx": 48.0, "fy": 48.0, "cx": 31.5, "cy": 23.5}
    cfg_m = {
        "pixels": 256, "iters": 3, "iters_first": 3, "every_frame": 1,
        "keyframe_every": 1, "mapping_window_size": 2,
        "middle_iter_ratio": 0.4, "fine_iter_ratio": 0.7,
        "w_color_loss": 0.2, "BA": False, "BA_cam_lr": 0.001,
        "fix_fine": True, "fix_color": False,
        "frustum_feature_selection": False,
        "keyframe_selection_method": "global", "lr_first_factor": 5,
        "lr_factor": 1, "color_refine": False,
        "stage": {s: {"decoders_lr": 0.001, "coarse_lr": 0.001,
                      "middle_lr": 0.01, "fine_lr": 0.01, "color_lr": 0.01}
                  for s in ("coarse", "middle", "fine", "color")},
    }
    jmcfg = JMC.from_cfg({"mapping": cfg_m, "occupancy": True}, cam, nice=True)
    tmcfg = MapperConfig.from_cfg({"mapping": cfg_m, "occupancy": True}, cam, nice=True)
    rng = np.random.default_rng(0)
    F = 2
    colors = rng.random((F, H, W, 3)).astype(np.float32)
    depths = (1.0 + rng.random((F, H, W))).astype(np.float32)
    c2w = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    cams = np.zeros((F, 7), np.float32)
    cams[:, 0] = 1.0
    key = jax.random.PRNGKey(7)
    plan = (("middle", 1), ("fine", 1), ("color", 1))

    js, _, jl, _ = optimize_map_jit(
        jspec, jstate, jnp.asarray(colors), jnp.asarray(depths), jnp.asarray(c2w),
        jnp.asarray(cams), jnp.zeros((F,), jnp.float32), jnp.ones((F,), bool), None,
        jnp.asarray(1.0, jnp.float32), key, None, jmcfg, jrcfg, plan, False, 128,
        make_mesh(8))
    pix = torch.tensor(_jax_pixel_draws(key, 3, F, 128, H, W))
    outs = {}
    for name, devices in (("dp", DEVICES), ("one", None)):
        st, _, losses = optimize_map_core(
            tspec, tstate, torch.tensor(colors), torch.tensor(depths), torch.tensor(c2w),
            torch.tensor(cams), torch.zeros(F), torch.ones(F, dtype=torch.bool), 1.0,
            tmcfg, trcfg, plan, False, 128, pix_idx=pix, devices=devices)
        outs[name] = (losses.numpy(), scene_to_numpy(st)["grids"])
    for ref_l, ref_g in (outs["one"], (np.asarray(jl), jax.tree.map(np.asarray, js.grids))):
        np.testing.assert_allclose(outs["dp"][0], ref_l, rtol=2e-4)
        for k in ref_g:
            np.testing.assert_allclose(outs["dp"][1][k], ref_g[k], atol=5e-5, err_msg=k)
