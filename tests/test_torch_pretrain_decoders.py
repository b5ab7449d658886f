"""The port's decoder pretrainer against the JAX package's
``tools/pretrain_decoders.py``: the procedural scenes, one Adam step of
each stage from identical (converted) parameters, the export, and a tiny
training run.

The JAX grid gradient runs in exact float32 (``_DGRAD_BF16`` off), as in
the port.  Tolerances of the step comparison (three steps per stage, 512 points at
the recipe's grid shapes): losses 1e-5 relative; at least 99.9 % of the
decoder and grid entries within 1e-5 after the third step.  Adam moves
an entry by about lr whatever its gradient's size, so an entry whose
gradient is ~0 in both runs may step apart on rounding noise alone (the
mapper's test has the same rule).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nice_slam_tpu.models import decoders as JD
from nice_slam_tpu.models import grids as JG
from nice_slam_tpu.slam.optim import init_group_adam
from nice_slam_tpu.tools import pretrain_decoders as jpd
from nice_slam_torch.convert import decoders_from_jax, decoders_to_numpy
from nice_slam_torch.models import decoders as TD
from nice_slam_torch.models.pretrain import surgery_coarse, surgery_middle_fine
from nice_slam_torch.slam.optim import GroupAdam, tree_leaves
from nice_slam_torch.tools import pretrain_decoders as tpd

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
N_POINTS = 512
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several tier-1 workers share few cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_random_scene_and_occupancy_equal_jax(seed):
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        ja, ta = jpd.random_scene(ra), tpd.random_scene(rb)
        np.testing.assert_array_equal(ja[0], ta[0])
        assert len(ja[1]) == len(ta[1]) and len(ja[2]) == len(ta[2])
        for (c1, e1), (c2, e2) in zip(ja[1], ta[1]):
            np.testing.assert_array_equal(c1, c2)
            np.testing.assert_array_equal(e1, e2)
        for (c1, r1), (c2, r2) in zip(ja[2], ta[2]):
            np.testing.assert_array_equal(c1, c2)
            assert r1 == r2
        pts = ra.uniform(-3, 3, size=(4096, 3)).astype(np.float32)
        rb.uniform(-3, 3, size=(4096, 3))  # keep the two streams in step
        occ_j = jpd.occupancy_of(pts, *ja)
        occ_t = tpd.occupancy_of(pts, *ta)
        assert occ_t.dtype == np.float32
        np.testing.assert_array_equal(occ_j, occ_t)
        assert 0 < occ_t.mean() < 1


def _jax_setup(seed):
    spec = JD.NICESpec(c_dim=32, hidden_size=32, coarse=True)
    key = jax.random.PRNGKey(seed)
    dec = JD.init_nice(key, spec)
    grids = JG.init_grids(jax.random.fold_in(key, 1), tpd.GRID_SHAPES, 32)
    # the middle grid as a trained one looks: larger than its 0.01 init
    grids["grid_middle"] = 30.0 * grids["grid_middle"]
    return spec, dec, grids


@pytest.mark.parametrize("stage", ["coarse", "middle", "fine"])
def test_fit_step_matches_jax(stage, monkeypatch):
    from nice_slam_tpu.ops import interp as jinterp

    # the JAX grid gradient in exact f32 (its default rounds contributions
    # to bf16); the port's K2 and its plain version sum in f32
    monkeypatch.setattr(jinterp, "_DGRAD_BF16", False)
    spec, jdec, jgrids = _jax_setup(3)
    sub = spec.sub_specs()[stage]
    tsub = TD.NICESpec(c_dim=32, hidden_size=32, coarse=True).sub_specs()[stage]
    rng = np.random.default_rng(5)
    half, boxes, spheres = tpd.random_scene(rng)
    pts = rng.uniform(tpd.BOUND[:, 0], tpd.BOUND[:, 1],
                      size=(STEPS, N_POINTS, 3)).astype(np.float32)
    occ = np.stack([tpd.occupancy_of(p, half, boxes, spheres) for p in pts])
    bound = jnp.asarray(tpd.BOUND)
    concat = stage == "fine"

    # the port's copies, converted from the JAX parameters
    tdec = decoders_from_jax(_np_tree(jdec[stage]), "cpu")
    tgrid = torch.tensor(np.asarray(jgrids["grid_" + stage]))
    tmid = torch.tensor(np.asarray(jgrids["grid_middle"]))
    for leaf in tree_leaves(tdec):
        leaf.requires_grad_(True)
    tgrid.requires_grad_(True)
    opt = GroupAdam({"dec": tdec, "grid": tgrid})

    d, g = jdec[stage], jgrids["grid_" + stage]
    adam = init_group_adam({"dec": d, "grid": g})
    for i in range(STEPS):
        d, g, adam, jloss = jpd._fit_step(
            d, g, jgrids["grid_middle"], jdec["middle"], adam,
            jnp.asarray(pts[i]), jnp.asarray(occ[i]), bound, sub, concat,
            5e-4, 5e-2)
        tloss = tpd.fit_step(tdec, tgrid, tmid, opt, torch.tensor(pts[i]),
                             torch.tensor(occ[i]), torch.tensor(tpd.BOUND), tsub,
                             concat)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)

    for name, a, b in (("decoder", decoders_to_numpy(tdec), _np_tree(d)),
                       ("grid", tgrid.detach().numpy(), np.asarray(g))):
        fa = np.concatenate([np.ravel(x) for x in jax.tree.leaves(a)])
        fb = np.concatenate([np.ravel(x) for x in jax.tree.leaves(b)])
        close = np.abs(fa - fb) <= 1e-5
        assert close.mean() >= 0.999, (
            f"{stage} {name}: {close.mean():.5f} of entries within 1e-5")
    # the step moved the parameters at all
    assert not np.allclose(tgrid.detach().numpy(),
                           np.asarray(jgrids["grid_" + stage]))


def test_fit_step_fine_stage_leaves_the_middle_grid(monkeypatch):
    """The fine stage reads the middle grid in its lookup, but the middle
    feature is detached: its backward computes the fine grid's gradient
    only, and the middle grid is unchanged."""
    from nice_slam_torch.ops import interp

    _, jdec, jgrids = _jax_setup(4)
    tsub = TD.NICESpec(c_dim=32, hidden_size=32, coarse=True).sub_specs()["fine"]
    tdec = decoders_from_jax(_np_tree(jdec["fine"]), "cpu")
    tgrid = torch.tensor(np.asarray(jgrids["grid_fine"])).requires_grad_(True)
    tmid = torch.tensor(np.asarray(jgrids["grid_middle"]))
    mid_before = tmid.clone()
    for leaf in tree_leaves(tdec):
        leaf.requires_grad_(True)
    opt = GroupAdam({"dec": tdec, "grid": tgrid})
    calls = {"fwd": [], "dgrid": []}
    fwd, dgrid = interp.trilinear_fwd_multi, interp.trilinear_bwd_dgrid_multi
    monkeypatch.setattr(interp, "trilinear_fwd_multi",
                        lambda grids, p: calls["fwd"].append(len(grids)) or fwd(grids, p))
    monkeypatch.setattr(interp, "trilinear_bwd_dgrid_multi",
                        lambda p, gs, shapes: calls["dgrid"].append(list(shapes))
                        or dgrid(p, gs, shapes))
    pts = torch.rand((256, 3)) * 6 - 3
    tpd.fit_step(tdec, tgrid, tmid, opt, pts, (pts[:, 0] > 0).float(),
                 torch.tensor(tpd.BOUND), tsub, True)
    assert calls["fwd"] == [2]
    assert calls["dgrid"] == [[tuple(tgrid.shape)]]
    assert torch.equal(tmid, mid_before)


def test_export_matches_jax_and_loads_back(tmp_path):
    spec, jdec, _ = _jax_setup(2)
    jdec = {k: jdec[k] for k in ("coarse", "middle", "fine")}
    jpd.export_torch(jdec, str(tmp_path / "jax"))
    tdec = decoders_from_jax(_np_tree(jdec), "cpu")
    tpd.export_torch(tdec, str(tmp_path / "port"))
    for fname in ("coarse.pt", "middle_fine.pt"):
        a = torch.load(tmp_path / "jax" / fname, weights_only=False)["model"]
        b = torch.load(tmp_path / "port" / fname, weights_only=False)["model"]
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        ref = torch.load(os.path.join(ROOT, "pretrained", fname),
                         weights_only=False)["model"]
        assert {k: tuple(v.shape) for k, v in b.items()} == \
            {k: tuple(v.shape) for k, v in ref.items()}
    # the port's loader reads the export back into the same tensors
    from nice_slam_torch.config import load_config
    from nice_slam_torch.models.pretrain import load_pretrain
    from nice_slam_torch.models.scene import build_scene

    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "nice_slam.yaml"))
    cfg["coarse"] = True
    cfg["pretrained_decoders"] = {"coarse": str(tmp_path / "port" / "coarse.pt"),
                                  "middle_fine": str(tmp_path / "port" / "middle_fine.pt")}
    tspec, state = build_scene(cfg, device="cpu")
    state = load_pretrain(cfg, tspec, state, verbose=False)
    for name in ("coarse", "middle", "fine"):
        got, want = tree_leaves(state.decoders[name]), tree_leaves(tdec[name])
        assert len(got) == len(want)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), name
    mf = torch.load(tmp_path / "port" / "middle_fine.pt", weights_only=False)["model"]
    middle_sd, fine_sd = surgery_middle_fine(mf)
    assert middle_sd and fine_sd
    assert surgery_coarse(torch.load(tmp_path / "port" / "coarse.pt",
                                     weights_only=False)["model"])


def test_decoder_dict_round_trip():
    _, jdec, _ = _jax_setup(9)
    ref = _np_tree({k: jdec[k] for k in ("coarse", "middle", "fine")})
    back = decoders_to_numpy(decoders_from_jax(ref, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.dtype == np.float32 and np.array_equal(a, b)


def test_tiny_pretrain_loss_falls(tmp_path):
    dec, losses = tpd.pretrain(1, 20, 512, seed=0, verbose=False, device="cpu")
    assert losses.shape == (1, 3, 20) and np.isfinite(losses).all()
    for k in range(3):
        assert losses[0, k, -5:].mean() < losses[0, k, :5].mean(), tpd.STAGES[k]
    tpd.export_torch(dec, str(tmp_path))
    assert os.path.exists(tmp_path / "coarse.pt")
    assert os.path.exists(tmp_path / "middle_fine.pt")
