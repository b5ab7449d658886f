"""The port's mapper against the JAX package: stage plans, frustum masks,
and a whole ``optimize_map`` call (middle -> fine -> color with BA) fed
the pixel draws the JAX call makes with ``jax.random``.

Tolerances of the optimize_map comparison: losses 1e-4 relative, BA poses
1e-5, decoder weights 1e-4.  Grids: Adam moves an entry by about lr per
step whatever its gradient's size, so an entry whose gradient is ~0 in
both runs can step in opposite directions on rounding noise alone; at
least 99.9 % of grid entries agree to 1e-4, and every entry to within
the step budget sum(lr) of the call.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nice_slam_tpu.config import load_config
from nice_slam_tpu.models import pretrain as jpre
from nice_slam_tpu.models import scene as jscene
from nice_slam_tpu.ops.render import RenderConfig as JRender
from nice_slam_tpu.slam import mapper as jm
from nice_slam_tpu.utils.datasets import Synthetic
from nice_slam_torch.convert import scene_from_jax, scene_to_numpy
from nice_slam_torch.models import scene as tscene
from nice_slam_torch.ops.render import RenderConfig as TRender
from nice_slam_torch.slam import mapper as tm
from nice_slam_torch.slam.keyframes import KeyframeStore

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tier-1 run puts several workers on few cores, and torch's
    thread pool in each would oversubscribe them (tiny loop runs took
    ~10x longer that way), so this module's runs use one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
H, W = 30, 40


def small_cfg():
    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "nice_slam.yaml"))
    cfg["coarse"] = False
    cfg["cam"].update({"H": H, "W": W, "fx": 30.0, "fy": 30.0, "cx": 19.5,
                       "cy": 14.5})
    cfg["rendering"].update({"N_samples": 12, "N_surface": 6})
    cfg["data"]["n_frames"] = 10
    for k in ("coarse", "middle_fine"):
        cfg["pretrained_decoders"][k] = os.path.join(
            ROOT, cfg["pretrained_decoders"][k])
    return cfg


@pytest.fixture(scope="module")
def setup():
    cfg = small_cfg()
    jspec, jstate = jscene.build_scene(cfg, nice=True, seed=1)
    jstate = jpre.load_pretrain(cfg, jspec, jstate, verbose=False)
    tspec, _ = tscene.build_scene(cfg, nice=True, device="cpu")
    tstate = scene_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    ds = Synthetic(cfg)
    frames = [ds[i] for i in (0, 2, 4)]
    return dict(cfg=cfg, jspec=jspec, jstate=jstate, tspec=tspec, tstate=tstate,
                colors=np.stack([f[1] for f in frames]),
                depths=np.stack([f[2] for f in frames]),
                c2w=np.stack([f[3] for f in frames]))


@pytest.mark.parametrize("n,coarse,ratios", [(60, False, None), (1500, False, None),
                                             (100, False, (0.0, 0.0)),
                                             (30, True, None), (7, False, None)])
def test_stage_plan_matches_jax(setup, n, coarse, ratios):
    cam = setup["cfg"]["cam"]
    jmc = jm.MapperConfig.from_cfg(setup["cfg"], cam, True, coarse)
    tmc = tm.MapperConfig.from_cfg(setup["cfg"], cam, True, coarse)
    kw = {} if ratios is None else dict(middle_iter_ratio=ratios[0],
                                        fine_iter_ratio=ratios[1])
    assert tm.stage_plan_for(tmc, n, **kw) == jm.stage_plan_for(jmc, n, **kw)
    assert tmc.keyframe_selection_method == jmc.keyframe_selection_method


def test_frustum_mask_matches_jax(setup):
    s = setup
    bound = np.asarray(s["jstate"].bound)
    cam = s["cfg"]["cam"]
    for f in range(3):
        for name, shape in s["jspec"].grid_shapes:
            ref = np.asarray(jm.frustum_mask(
                jnp.asarray(s["c2w"][f]), jnp.asarray(s["depths"][f]),
                jnp.asarray(bound), shape, H, W, cam["fx"], cam["fy"],
                cam["cx"], cam["cy"]))
            got = tm.frustum_mask(
                torch.tensor(s["c2w"][f]), torch.tensor(s["depths"][f]),
                torch.tensor(bound), shape, H, W, cam["fx"], cam["fy"],
                cam["cx"], cam["cy"]).numpy()
            assert got.shape == ref.shape and 0 < ref.sum() < ref.size
            # lattice coordinates agree to an ulp, so a node lying exactly
            # on a test boundary may flip; none did at these shapes
            np.testing.assert_array_equal(got, ref)


def test_frustum_masks_dispatcher_matches_jax(setup):
    """The mapper's entry (``frustum_masks``: every grid of a call at once,
    K10 on the card, its plain version on the CPU) gives the float masks
    the Adam step reads: the JAX masks as (nx, ny, nz, 1) floats."""
    s = setup
    bound = np.asarray(s["jstate"].bound)
    cam = s["cfg"]["cam"]
    shapes = [shape for name, shape in s["jspec"].grid_shapes if name != "grid_coarse"]
    for f in range(3):
        got = tm.frustum_masks(torch.tensor(s["c2w"][f]), torch.tensor(s["depths"][f]),
                               torch.tensor(bound), shapes, H, W, cam["fx"], cam["fy"],
                               cam["cx"], cam["cy"])
        assert len(got) == len(shapes)
        # grids of one shape share the camera and the bound: one mask, one tensor
        for i, j in [(i, j) for i in range(len(shapes)) for j in range(i)]:
            assert (got[i] is got[j]) == (shapes[i] == shapes[j])
        for shape, m in zip(shapes, got):
            ref = np.asarray(jm.frustum_mask(
                jnp.asarray(s["c2w"][f]), jnp.asarray(s["depths"][f]),
                jnp.asarray(bound), shape, H, W, cam["fx"], cam["fy"],
                cam["cx"], cam["cy"]))
            assert m.dtype == torch.float32 and tuple(m.shape) == (*shape, 1)
            np.testing.assert_array_equal(m[..., 0].numpy(), ref.astype(np.float32))


def test_frustum_masks_fine_and_color_are_one_tensor(setup):
    """The mapper's middle, fine and color grids (fine and color of one
    shape, as every config of the repo has them): fine's and color's masks
    are one tensor object, and each still equals the JAX mask."""
    s = setup
    bound = np.asarray(s["jstate"].bound)
    cam = s["cfg"]["cam"]
    shapes = dict(s["jspec"].grid_shapes)
    names = ("grid_middle", "grid_fine", "grid_color")
    assert shapes["grid_fine"] == shapes["grid_color"] != shapes["grid_middle"]
    got = tm.frustum_masks(torch.tensor(s["c2w"][1]), torch.tensor(s["depths"][1]),
                           torch.tensor(bound), [shapes[k] for k in names], H, W,
                           cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    assert got[1] is got[2] and got[0] is not got[1]
    for name, m in zip(names, got):
        ref = np.asarray(jm.frustum_mask(
            jnp.asarray(s["c2w"][1]), jnp.asarray(s["depths"][1]), jnp.asarray(bound),
            shapes[name], H, W, cam["fx"], cam["fy"], cam["cx"], cam["cy"]))
        np.testing.assert_array_equal(m[..., 0].numpy(), ref.astype(np.float32))


# K10's launch geometry: the room's grids, Apartment's (configs/Apartment/
# apartment.yaml's bound at the default grid_len: more than one round of
# threads at 132 SMs), shapes off every multiple, and slab layouts (rows > nx)
FRUSTUM_GRID_SETS = {
    "room": [((37, 28, 21), 37), ((74, 56, 43), 74)],
    "apartment": [((53, 26, 40), 53), ((107, 53, 81), 107)],
    "odd": [((3, 5, 7), 3), ((1, 1, 1), 1), ((13, 17, 19), 13), ((2, 3, 251), 2)],
    "slabs": [((37, 28, 21), 37), ((74, 56, 43), 77)],
    "one": [((1, 1, 1), 1)],
}


def _frustum_walk(g, grids):
    """How often K10's threads reach each node of each grid under
    geometry ``g``, as frustum.cu walks them: thread x takes items x, x +
    S, ...; item k belongs to the grid whose items (rows x ny x nz, grid
    after grid) hold it, and its element j to node plane min(j // (ny nz),
    nx - 1).  Returns per grid (node visits, element visits)."""
    from nice_slam_torch.ops import frustum as Fm

    sizes = [r * s[1] * s[2] for s, r in grids]
    first = np.concatenate([[0], np.cumsum(sizes)])
    stride = g.ctas * g.threads
    x = np.arange(stride)
    items = np.concatenate([x + i * stride for i in range(g.per_thread)])
    items = items[items < first[-1]]
    grid = np.searchsorted(first, items, side="right") - 1
    out = []
    for gi, ((nx, ny, nz), rows) in enumerate(grids):
        j = items[grid == gi] - first[gi]
        plane = np.minimum(j // (ny * nz), nx - 1)
        node = plane * ny * nz + j % (ny * nz)
        out.append((np.bincount(node, minlength=nx * ny * nz),
                    np.bincount(j, minlength=rows * ny * nz)))
    assert Fm.FRUSTUM_THREADS == g.threads
    return out


@pytest.mark.parametrize("ctas_per_sm", [6, 3])  # 6: K10's on an H100 (38 registers)
@pytest.mark.parametrize("sms", [132, 16])
@pytest.mark.parametrize("case", sorted(FRUSTUM_GRID_SETS))
def test_frustum_geometry_covers_every_node_once(case, sms, ctas_per_sm):
    """At an H100's 132 SMs and at 16: one round of resident CTAs (the
    cooperative launch's grid barrier needs them all resident), every
    element of every distinct grid's mask written once, every node once
    (more only where a slab layout repeats the last plane)."""
    from nice_slam_torch.ops import frustum as Fm

    grids = FRUSTUM_GRID_SETS[case]
    sizes = [r * s[1] * s[2] for s, r in grids]
    g = Fm.frustum_geometry(sizes, sms, ctas_per_sm)
    assert g.items == sum(sizes) and 1 <= g.ctas <= sms * ctas_per_sm
    assert g.ctas * g.threads * g.per_thread >= g.items
    assert g.ctas * g.threads * (g.per_thread - 1) < g.items
    for ((nx, ny, nz), rows), (nodes, elems) in zip(grids, _frustum_walk(g, grids)):
        assert (elems == 1).all()
        want = np.ones((nx, ny * nz), np.int64)
        want[-1] += rows - nx
        np.testing.assert_array_equal(nodes.reshape(nx, -1), want)
    if case == "room" and sms == 132 and ctas_per_sm == 6:
        assert (g.ctas, g.per_thread) == (782, 1)
    if case == "apartment" and sms == 132 and ctas_per_sm == 6:
        assert (g.ctas, g.per_thread) == (792, 3)


def _jax_pixel_draws(key, n_iters, F, n):
    """The flat pixel indices optimize_map_jit draws: per global iteration
    i, fold_in(key, i) -> split -> split(F) -> randint over H*W."""
    out = []
    for i in range(n_iters):
        k_frames, _ = jax.random.split(jax.random.fold_in(key, i))
        fk = jax.random.split(k_frames, F)
        out.append(np.stack([np.asarray(jax.random.randint(fk[f], (n,), 0, H * W))
                             for f in range(F)]))
    return np.stack(out)


def test_optimize_map_matches_jax(setup):
    s = setup
    cfg, cam = s["cfg"], s["cfg"]["cam"]
    jmc = jm.MapperConfig.from_cfg(cfg, cam, True)
    tmc = tm.MapperConfig.from_cfg(cfg, cam, True)
    cams = np.asarray(jax.vmap(jm.tensor_from_pose)(jnp.asarray(s["c2w"])))
    opt_mask = np.array([0, 1, 1], np.float32)
    valid = np.ones(3, bool)
    plan = (("middle", 2), ("fine", 2), ("color", 3))
    n_iters, F, n = 7, 3, 20
    key = jax.random.PRNGKey(5)

    js, jc, jl, _ = jm.optimize_map_jit(
        s["jspec"], s["jstate"], jnp.asarray(s["colors"]),
        jnp.asarray(s["depths"]), jnp.asarray(s["c2w"]), jnp.asarray(cams),
        jnp.asarray(opt_mask), jnp.asarray(valid), None,
        jnp.asarray(1.0, jnp.float32), key, None, jmc, JRender.from_cfg(cfg),
        plan, True, n)
    pix = torch.tensor(_jax_pixel_draws(key, n_iters, F, n))
    ts, tc, tl = tm.optimize_map_core(
        s["tspec"], s["tstate"], torch.tensor(s["colors"]),
        torch.tensor(s["depths"]), torch.tensor(s["c2w"]), torch.tensor(cams),
        torch.tensor(opt_mask), torch.tensor(valid), 1.0, tmc,
        TRender.from_cfg(cfg), plan, True, n, pix_idx=pix)

    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    # the oldest window pose stays fixed
    np.testing.assert_array_equal(tc.numpy()[0], cams[0])
    out = scene_to_numpy(ts)
    for a, b in zip(jax.tree.leaves(out["decoders"]),
                    jax.tree.leaves(jax.tree.map(np.asarray, js.decoders))):
        np.testing.assert_allclose(a, b, atol=1e-4)
    budget = {"grid_middle": 2 * 0.1 + 5 * 0.005, "grid_fine": 5 * 0.005,
              "grid_color": 3 * 0.005}
    for name, step_budget in budget.items():
        a, b = out["grids"][name], np.asarray(js.grids[name])
        d = np.abs(a - b)
        assert (d <= 1e-4).mean() >= 0.999, name
        assert d.max() <= 2 * step_budget, name
        # the frozen region outside the frustum is untouched in both
        before = np.asarray(s["jstate"].grids[name])
        np.testing.assert_array_equal(a == before, b == before)


def test_mapper_window_and_ba_write_back(setup):
    """A full Mapper.optimize_map over a keyframe store: overlap window of
    k + 2 slots, and BA writes refined poses back for every window
    keyframe except the oldest."""
    s = setup
    # overlap scoring keeps a 20 px margin: use a 60 x 80 camera
    cam = {"H": 60, "W": 80, "fx": 60.0, "fy": 60.0, "cx": 39.5, "cy": 29.5}
    cfg = dict(s["cfg"], mapping=dict(s["cfg"]["mapping"], pixels=60),
               cam=dict(s["cfg"]["cam"], **cam))
    tmc = tm.MapperConfig.from_cfg(cfg, cfg["cam"], True)
    mapper = tm.Mapper(s["tspec"], tmc, TRender.from_cfg(cfg), "cpu")
    store = KeyframeStore(2, 60, 80, "cpu")
    ds = Synthetic(cfg)
    for i in range(6):
        _, c, d, p = ds[i]
        store.add(i, c, d, p, p)
    assert store.capacity == 8 and len(store) == 6
    before = store.arrays.est_c2w.clone()
    _, c, d, p = ds[6]
    new_state, cur, losses = mapper.optimize_map(
        s["tstate"], 4, 1.0, torch.tensor(c), torch.tensor(d), store,
        torch.tensor(p), BA=True)
    assert losses.shape == (4,) and torch.isfinite(losses).all()
    assert cur.shape == (4, 4)
    changed = (store.arrays.est_c2w != before).flatten(1).any(1)
    # the last keyframe (position 5) is always in the window; position 0
    # is never refined when it is the window's oldest
    assert 0 < int(changed.sum()) <= tmc.mapping_window_size - 2
    # the input state is left as it was
    np.testing.assert_array_equal(
        s["tstate"].grids["grid_fine"].numpy(),
        np.asarray(s["jstate"].grids["grid_fine"]))
