"""iMAP* on the parallel paths and the threaded schedules, in the port
against its one-device run and against the JAX package, on the CPU (the
port's kernels in their plain versions, the JAX package on the
conftest's virtual CPU devices).

Every call-level case feeds both packages the JAX call's own pixel and
regulariser draws: the JAX mapper draws them from its key inside
``optimize_map_jit``, and the port's ``optimize_map_core`` is handed them
(``pix_idx``, ``reg_t``), as ``tests/test_torch_ba_parallel.py`` does.
The window holds frames 0, 2 and 4 of the box, the last two off their
true poses by a few mm, so that BA has poses to move.

(1) One iMAP* ``optimize_map_core`` call (4 iterations) with its rays split
    over ``["cpu"] * 2`` (ray data parallelism) against the one-device
    call: losses rtol 1e-4, the MLP leaves atol 1e-5, ``over_blocks``
    split every iteration's rays.
(2) The same call against the JAX call over the conftest's 2-device mesh
    (``nice_slam_tpu/slam/mapper.py:514-521`` shards its rays): losses
    rtol 1e-4.
(3) (1) and (2) with BA: the refined poses within 1e-6 of the one-device
    call's.
(4) A 6-frame strict iMAP* ``NiceSLAM`` over ``["cpu"] * 2`` (ground-truth
    cameras, as ``tests/test_torch_multichip.py`` runs NICE): the mapper
    and the mesher over the list, every call's losses within rtol 1e-3
    of the one-device run's, the final mesh written.  The final colour
    refinement is off here: its calls, each from a fresh Adam, amplify
    float32 rounding past 1e-3 at this size (a 1e-7 relative change of
    the initial weights, on one device, moves its fifth call's losses by
    9.2e-3); (1)-(3) hold the call it runs.
(5) iMAP* under ``free`` completes, and a loose iMAP* run with BA and a
    keyframe per mapping event engages BA and ends at every pose the
    mapper refined.

And the lattice split of the iMAP* MLP (the mesher's occupancy queries
over the devices) against one device and the JAX package's, and the
ray-DP blocks drawing nothing: they get no generator, so a draw raises.
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nice_slam_tpu.config import load_config
from nice_slam_tpu.models import scene as jscene
from nice_slam_tpu.ops.render import RenderConfig as JRender
from nice_slam_tpu.parallel.sharding import make_mesh
from nice_slam_tpu.slam import mapper as jm
from nice_slam_tpu.utils.datasets import Synthetic
from nice_slam_torch.convert import scene_from_jax
from nice_slam_torch.models import scene as tscene
from nice_slam_torch.ops.render import RenderConfig as TRender
from nice_slam_torch.slam import mapper as tm
from nice_slam_torch.slam.optim import tree_leaves
from test_torch_sync import run_bounded, small_cfg

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CPU = torch.device("cpu")
TWO = [CPU, CPU]
ARGS = argparse.Namespace(nice=False, input_folder=None, output=None)
H, W = 24, 32
F, N, ITERS = 3, 16, 4  # window frames, rays per frame, iterations
# the window's second and third frames off their true positions (m, at
# the iMAP configs' 0.1 scale)
OFFSETS = 0.1 * np.array([[0.03, -0.02, 0.02], [-0.02, 0.03, 0.01]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several test workers share few cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pixel_draws(key, n_iters):
    """The flat pixel indices optimize_map_jit draws: per iteration i,
    fold_in(key, i) -> split -> split(F) -> randint over H*W."""
    out = []
    for i in range(n_iters):
        k_frames, _ = jax.random.split(jax.random.fold_in(key, i))
        fk = jax.random.split(k_frames, F)
        out.append(np.stack([np.asarray(jax.random.randint(fk[f], (N,), 0, H * W))
                             for f in range(F)]))
    return np.stack(out)


def _reg_draws(key, n_iters, n_samples):
    """The regulariser's jitter each iteration's JAX mapping_loss draws."""
    return np.stack([np.asarray(jax.random.uniform(
        jax.random.split(jax.random.fold_in(key, i))[1], (F * N, n_samples)))
        for i in range(n_iters)])


def _call_cfg():
    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "imap.yaml"))
    cfg["verbose"] = False
    cfg["cam"].update({"H": H, "W": W, "fx": 24.0, "fy": 24.0, "cx": 15.5, "cy": 11.5})
    cfg["rendering"].update({"N_samples": 8, "N_importance": 4})
    cfg["data"]["n_frames"] = 6
    return cfg


@pytest.fixture(scope="module")
def window():
    """The scene in both packages, the window's frames, the JAX key and its
    draws."""
    cfg = _call_cfg()
    jspec, jstate = jscene.build_scene(cfg, nice=False, seed=3)
    tspec, _ = tscene.build_scene(cfg, nice=False, seed=9, device="cpu")
    tstate = scene_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    ds = Synthetic(cfg, scale=cfg["scale"])
    fr = [ds[i] for i in (0, 2, 4)]
    c2w = np.stack([f[3] for f in fr]).astype(np.float32)
    c2w[1:, :3, 3] += OFFSETS
    key = jax.random.PRNGKey(8)
    return dict(cfg=cfg, jspec=jspec, jstate=jstate, tspec=tspec, tstate=tstate,
                colors=np.stack([f[1] for f in fr]), depths=np.stack([f[2] for f in fr]),
                c2w=c2w, cams=np.asarray(jax.vmap(jm.tensor_from_pose)(jnp.asarray(c2w))),
                key=key, pix=_pixel_draws(key, ITERS),
                reg_t=_reg_draws(key, ITERS, cfg["rendering"]["N_samples"]))


def _port_call(w, ba, devices):
    """The port's optimize_map_core on the window with the JAX draws; with
    ``devices`` the over_blocks splits are recorded.  Returns (state,
    cams, losses, splits)."""
    splits = []
    inner = tm.over_blocks

    def over_blocks(devs, *a):
        splits.append(len(devs))
        return inner(devs, *a)

    tm.over_blocks = over_blocks
    try:
        cfg = w["cfg"]
        opt = np.array([0, 1, 1] if ba else [0, 0, 0], np.float32)
        state, cams, losses = tm.optimize_map_core(
            w["tspec"], w["tstate"], torch.tensor(w["colors"]), torch.tensor(w["depths"]),
            torch.tensor(w["c2w"]), torch.tensor(w["cams"]), torch.tensor(opt),
            torch.ones(F, dtype=torch.bool), 1.0,
            tm.MapperConfig.from_cfg(cfg, cfg["cam"], False), TRender.from_cfg(cfg),
            (("color", ITERS),), ba, N, pix_idx=torch.tensor(w["pix"]),
            reg_t=torch.tensor(w["reg_t"]), devices=devices)
    finally:
        tm.over_blocks = inner
    return state, cams.numpy(), losses.numpy(), splits


@pytest.fixture(scope="module", params=[False, True], ids=["ba_off", "ba_on"])
def calls(request, window):
    """One call with BA off or on: the port on one device and over two,
    and the JAX package over its 2-device mesh."""
    ba, w = request.param, window
    cfg = w["cfg"]
    opt = np.array([0, 1, 1] if ba else [0, 0, 0], np.float32)
    _, jcams, jlosses, _ = jm.optimize_map_jit(
        w["jspec"], w["jstate"], jnp.asarray(w["colors"]), jnp.asarray(w["depths"]),
        jnp.asarray(w["c2w"]), jnp.asarray(w["cams"]), jnp.asarray(opt),
        jnp.ones(F, bool), None, jnp.asarray(1.0, jnp.float32), w["key"], None,
        jm.MapperConfig.from_cfg(cfg, cfg["cam"], False), JRender.from_cfg(cfg),
        (("color", ITERS),), ba, N, mesh=make_mesh(2))
    return dict(ba=ba, one=_port_call(w, ba, None), dp=_port_call(w, ba, TWO),
                jax=(np.asarray(jcams), np.asarray(jlosses)))


def test_imap_ray_dp_call_matches_one_device(calls):
    """(1), and (3) with BA: the call with its rays over two devices
    against one device on the same draws."""
    s1, c1, l1, split1 = calls["one"]
    s2, c2, l2, split2 = calls["dp"]
    assert split1 == [] and split2 == [2] * ITERS  # the split happened
    assert np.all(np.isfinite(l2)) and l2.shape == (ITERS,)
    np.testing.assert_allclose(l2, l1, rtol=1e-4)
    for a, b in zip(tree_leaves(s2.decoders), tree_leaves(s1.decoders)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)
    if calls["ba"]:
        np.testing.assert_array_equal(c2[0], c1[0])  # the oldest stays fixed
        np.testing.assert_allclose(c2, c1, atol=1e-6, rtol=0)
    else:
        np.testing.assert_array_equal(c2, c1)


def test_imap_ray_dp_call_matches_jax_mesh(calls, window):
    """(2), and (3) with BA: the port's ray-DP call against the JAX call
    over its 2-device mesh, on the JAX call's draws."""
    _, cams, losses, _ = calls["dp"]
    jcams, jlosses = calls["jax"]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    if calls["ba"]:
        assert np.abs(cams[1:] - window["cams"][1:]).max() > 1e-5  # the camera moved
        np.testing.assert_allclose(cams, jcams, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the system: strict over two devices, free, loose with BA
# ---------------------------------------------------------------------------

def _slam_cfg(out, n_frames, sync_method):
    """The threaded tests' slow-orbit box at 30x40 on imap.yaml, a mapping
    event every 2nd frame."""
    cfg = small_cfg(out, n_frames, sync_method, coarse=False, base="imap.yaml")
    cfg["rendering"].update({"N_samples": 8, "N_importance": 4})
    cfg["mapping"].update({"pixels": 64, "iters_first": 30, "iters": 6, "every_frame": 2})
    return cfg


def test_imap_system_over_two_devices_maps_as_one(tmp_path):
    """(4) A 6-frame strict iMAP* system over two devices splits its mapping
    rays and its lattice queries over them and maps as the one-device
    system does (ground-truth cameras, colour refinement off: see the
    module's docstring)."""
    from nice_slam_torch.slam.slam import NiceSLAM

    runs = {}
    for name, devices in (("dp", TWO), ("one", [CPU])):
        cfg = _slam_cfg(tmp_path / name, 6, "strict")
        cfg["tracking"]["gt_camera"] = True
        cfg["mapping"]["color_refine"] = False
        cfg["meshing"] = dict(load_config(os.path.join(ROOT, "configs", "imap.yaml"))
                              ["meshing"], resolution=16, eval_rec=False)
        slam = NiceSLAM(cfg, ARGS, devices=devices)
        if name == "dp":
            assert slam.mapper.devices == TWO and slam.mesher.devices == TWO
            assert slam.spatial_devices is None and slam.coarse_mapper is None
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
    # the first call 30 iterations, then 3 calls of 2 at frames 2, 4, 5
    assert [len(x) for x in runs["dp"]] == [len(x) for x in runs["one"]] == [30] + [2] * 9
    for a, b in zip(runs["dp"], runs["one"]):
        np.testing.assert_allclose(a, b, rtol=1e-3)


def test_imap_free_completes(tmp_path):
    """(5) iMAP* under free: the tracker and the mapper as threads with no
    gates; every frame tracked and the last one mapped."""
    from nice_slam_torch.slam.slam import NiceSLAM

    n = 6
    slam = run_bounded(NiceSLAM(_slam_cfg(tmp_path, n, "free"), ARGS, device="cpu"))
    assert slam.coarse_mapper is None and set(slam.streams) == {"tracker", "mapper"}
    assert slam.mapping_idx == n - 1 and slam.timings["tracked_frames"] == n - 1
    assert torch.isfinite(slam.estimate_c2w_list).all()


def test_imap_loose_ba_keeps_every_refined_pose(tmp_path):
    """(5) Loose iMAP* with BA and a keyframe at every mapping event (the
    loose mapper maps the latest tracked frame, so a keyframe every 2nd
    frame may never fill the store): BA engages, and every pose the
    mapper refines is the one the run ends with, though the tracker
    writes the pose list concurrently."""
    from nice_slam_torch.slam.slam import NiceSLAM

    n = 12
    cfg = _slam_cfg(tmp_path, n, "loose")
    cfg["mapping"].update({"BA": True, "keyframe_every": 1})
    slam = NiceSLAM(cfg, ARGS, device="cpu")
    refined = {}
    inner = slam.mapper.optimize_map

    def recorded(*a, **k):
        out = inner(*a, **k)
        if out[1] is not None:
            refined[k["idx"]] = out[1].clone()
        return out

    slam.mapper.optimize_map = recorded
    run_bounded(slam)
    # refined while the tracker ran on: before the last frame's refinement
    assert len([i for i in refined if i < n - 1]) >= 2, sorted(refined)
    for idx, pose in refined.items():
        assert torch.equal(slam.estimate_c2w_list[idx], pose), idx
    assert slam.mapping_idx == n - 1
    assert torch.isfinite(slam.estimate_c2w_list).all()


# ---------------------------------------------------------------------------
# the lattice split and the draws of the ray-DP blocks
# ---------------------------------------------------------------------------

def test_imap_lattice_split_matches_one_device_and_jax(window):
    """The mesher's occupancy queries of the iMAP* MLP split over two
    devices equal the one-device queries (1e-5) and the JAX package's
    over its 2-device mesh (5e-5, the NICE case's bound)."""
    from nice_slam_tpu.utils.mesher import _eval_chunk as jeval_chunk
    from nice_slam_torch.utils.mesher import _eval_chunk, _query_devices

    w = window
    pts = np.random.default_rng(3).uniform(-0.25, 0.25, (2048, 3)).astype(np.float32)
    assert _query_devices(w["tstate"], TWO) == TWO
    one = _eval_chunk(w["tspec"], w["tstate"], torch.tensor(pts), "color", None).numpy()
    split = _eval_chunk(w["tspec"], w["tstate"], torch.tensor(pts), "color", TWO).numpy()
    np.testing.assert_allclose(split, one, atol=1e-5, rtol=0)
    ref = np.asarray(jeval_chunk(w["jspec"], w["jstate"], jnp.asarray(pts), "color",
                                 make_mesh(2)))
    np.testing.assert_allclose(split, ref, atol=5e-5, rtol=0)


def test_ray_dp_blocks_get_no_generator(window, monkeypatch):
    """The ray-DP blocks of a mapping loss render and regularise with no
    generator: the regulariser's jitter is drawn before the split, and a
    draw inside a block (here forced by a perturbed render) raises rather
    than taking draws in block order or from another device's
    generator."""
    import dataclasses

    from nice_slam_torch.ops import render as R

    w = window
    cfg = w["cfg"]
    seen = []
    inner_render, inner_reg = R.render_batch_ray, R.regulation

    def render(*a, **k):
        seen.append(("render", k.get("gen")))
        return inner_render(*a, **k)

    def regulation(*a, **k):
        seen.append(("regulation", k.get("gen")))
        return inner_reg(*a, **k)

    monkeypatch.setattr(tm, "render_batch_ray", render)
    monkeypatch.setattr(tm, "regulation", regulation)
    state = tm._opt_param_groups(w["tspec"], w["tstate"],
                                 tm.MapperConfig.from_cfg(cfg, cfg["cam"], False), None, False)
    args = (w["tspec"], state, w["tstate"], torch.tensor(w["colors"]),
            torch.tensor(w["depths"]), torch.tensor(w["c2w"]), torch.zeros(F),
            torch.ones(F, dtype=torch.bool), "color",
            tm.MapperConfig.from_cfg(cfg, cfg["cam"], False))
    gen = torch.Generator().manual_seed(0)
    loss = tm.mapping_loss(*args, TRender.from_cfg(cfg), N, gen=gen, devices=TWO)
    assert torch.isfinite(loss)
    assert seen == [("render", None), ("regulation", None)] * 2
    perturbed = dataclasses.replace(TRender.from_cfg(cfg), perturb=1.0)
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        tm.mapping_loss(*args, perturbed, N, gen=gen, devices=TWO)
