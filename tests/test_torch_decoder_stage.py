"""The decoder stage (``nice_slam_torch/ops/decoder_stage.py``) on the CPU,
where it runs its plain versions: the forward against the JAX decoders
(``apply_mlp_no_xyz``, ``apply_mlp``, ``apply_nice_stage_batched``), the
Function's gradients against ``jax.vjp`` of the same functions, and
``decoder_bwd_plain`` (the kernels' gradient math, written out) against
``torch.autograd`` of the plain forward.  The grid lookups are left out:
both sides take the same features, so the JAX functions get a
``sample_fn`` that returns them.

Tolerances.  Outputs: atol 0.05 on raw logits (CLAUDE.md; the Fourier
embedding takes sin at O(100) rad, where one ulp of p @ B moves its output
by ~1e-5 and the decoders amplify that).  Gradients against JAX: 2e-3 of
the largest entry of each array (the same noise through cos(p @ B) B; the
point gradient, which carries the factor B ~ 25-75 a second time, at
1e-2).  The plain backward against autograd on the same side: 1e-5 of
each array's largest entry (f32 summation order only).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nice_slam_tpu.config import load_config as jload_config
from nice_slam_tpu.models import decoders as jdec
from nice_slam_tpu.models import pretrain as jpre
from nice_slam_tpu.models import scene as jscene
from nice_slam_torch.convert import decoders_from_jax
from nice_slam_torch.models import decoders as tdec
from nice_slam_torch.ops import decoder_stage as DS

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
LOGIT_ATOL = 0.05
GRAD_RTOL = 2e-3
DP_RTOL = 1e-2
PLAIN_RTOL = 1e-5
N = 300
KINDS = ("coarse", "middle", "fine", "color", "fine_stage", "color_stage")
# per kind: the decoders of the call and the grids whose features it reads
CALLS = {"coarse": (["coarse"], ["coarse"]), "middle": (["middle"], ["middle"]),
         "fine": (["fine"], ["fine", "middle"]), "color": (["color"], ["color"]),
         "fine_stage": (["middle", "fine"], ["middle", "fine"]),
         "color_stage": (["middle", "fine", "color"], ["middle", "fine", "color"])}


@pytest.fixture(scope="module")
def decoders():
    """The pretrained NICE decoders (box config, coarse on) in both
    packages' trees, and both specs."""
    cfg = jload_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                       os.path.join(ROOT, "configs", "nice_slam.yaml"))
    cfg["coarse"] = True
    for k in ("coarse", "middle_fine"):
        cfg["pretrained_decoders"][k] = os.path.join(ROOT, cfg["pretrained_decoders"][k])
    jspec, jstate = jscene.build_scene(cfg, nice=True, seed=3)
    jstate = jpre.load_pretrain(cfg, jspec, jstate, verbose=False)
    jparams = jax.tree.map(np.asarray, jstate.decoders)
    tparams = decoders_from_jax(jparams, "cpu")
    tspec = tdec.NICESpec(c_dim=32, hidden_size=32, coarse=True)
    return jspec.decoder, jparams, tspec, tparams


def _inputs(kind, seed=0, n=N):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-2.4, 2.4, (n, 3)).astype(np.float32)
    feats = [(0.3 * rng.standard_normal((n, 32))).astype(np.float32)
             for _ in CALLS[kind][1]]
    g = rng.standard_normal((n, 4)).astype(np.float32)
    return p, feats, g


def _jax_call(kind, jspec, params, p, feats):
    """The JAX function of ``kind`` on given features -> (N, 4) or (N,)."""
    grids = {"grid_" + k: f for k, f in zip(CALLS[kind][1], feats)}

    def ident(f, _p, _b):
        return f

    subs = jspec.sub_specs()
    if kind == "coarse":
        return jdec.apply_mlp_no_xyz(params["coarse"], subs["coarse"], p, grids, None,
                                     sample_fn=ident)
    if kind in ("middle", "fine", "color"):
        return jdec.apply_mlp(params[kind], subs[kind], p, grids, None, sample_fn=ident)
    return jdec.apply_nice_stage_batched(params, jspec, p, grids, None,
                                         kind.split("_")[0], sample_fn=ident)


def _decs(kind, tspec):
    subs = tspec.sub_specs()
    if kind in ("fine_stage", "color_stage"):
        decs = [DS.decoder_of(subs["middle"], 0), DS.decoder_of(subs["fine"], 1, 0)]
        if kind == "color_stage":
            decs.append(DS.decoder_of(subs["color"], 2, occ3=False))
        return decs
    return [DS.decoder_of(subs[kind], 0, 1 if kind == "fine" else -1)]


def _torch_call(kind, tspec, params, p, feats):
    """The port's call of ``kind`` -> the JAX function's shape."""
    decs = _decs(kind, tspec)
    names = CALLS[kind][0]
    weights = [DS.pack(params[n], d, 32) for n, d in zip(names, decs)]
    out = DS.decoder_stage(p, decs, feats, weights)
    return out if kind in ("color", "fine_stage", "color_stage") else out[:, 3]


def _close(got, ref, rtol, what):
    got = np.asarray(got)
    ref = np.zeros_like(got) if ref is None else np.asarray(ref)  # unused: zero
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(got - ref).max())
    assert err <= rtol * scale, f"{what}: max abs err {err} > {rtol} x {scale}"


@pytest.mark.parametrize("kind", KINDS)
def test_forward_matches_jax(decoders, kind):
    jspec, jparams, tspec, tparams = decoders
    p, feats, _ = _inputs(kind)
    ref = _jax_call(kind, jspec, jparams, jnp.asarray(p), [jnp.asarray(f) for f in feats])
    got = _torch_call(kind, tspec, tparams, torch.tensor(p), [torch.tensor(f) for f in feats])
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=LOGIT_ATOL)


@pytest.mark.parametrize("kind", KINDS)
def test_vjp_matches_jax(decoders, kind):
    """The Function's backward (decoder_bwd_plain on the CPU) against
    jax.vjp: the points, every feature (the fine decoder's middle half
    detached on both sides: zero) and every weight of the call's decoders,
    the embedding's B included."""
    jspec, jparams, tspec, tparams = decoders
    p, feats, g = _inputs(kind, seed=1)
    names = CALLS[kind][0]
    cot = g if kind in ("color", "fine_stage", "color_stage") else g[:, 3]

    def jf(sub, pp, ff):
        return _jax_call(kind, jspec, {**jparams, **sub}, pp, ff)

    sub = {n: jparams[n] for n in names}
    _, vjp = jax.vjp(jf, sub, jnp.asarray(p), [jnp.asarray(f) for f in feats])
    jd_sub, jd_p, jd_f = vjp(jnp.asarray(cot))

    leaves = {n: jax.tree.map(lambda x: torch.tensor(x, requires_grad=True), jparams[n])
              for n in names}
    tp = torch.tensor(p, requires_grad=True)
    tf = [torch.tensor(f, requires_grad=True) for f in feats]
    out = _torch_call(kind, tspec, {**tparams, **leaves}, tp, tf)
    flat = jax.tree.leaves(leaves)
    grads = torch.autograd.grad(out, [tp, *tf, *flat], torch.tensor(cot),
                                allow_unused=True)
    _close(grads[0], jd_p, DP_RTOL, "dp")
    for i, (a, b) in enumerate(zip(grads[1:1 + len(tf)], jd_f)):
        a = np.zeros_like(np.asarray(b)) if a is None else a.numpy()
        if not np.abs(np.asarray(b)).max():
            assert not np.abs(a).max(), f"feature {i} has a gradient JAX does not"
        else:
            _close(a, b, GRAD_RTOL, f"feature {i}")
    jflat = jax.tree.leaves(jd_sub)
    assert len(jflat) == len(flat)
    for (path, _), a, b in zip(jax.tree_util.tree_flatten_with_path(jd_sub)[0],
                               grads[1 + len(tf):], jflat):
        _close(a.numpy(), b, GRAD_RTOL, jax.tree_util.keystr(path))


@pytest.mark.parametrize("kind", KINDS)
def test_plain_backward_matches_autograd(decoders, kind):
    """decoder_bwd_plain, the gradients as K5 and K6 form them, against
    torch.autograd of the plain forward, for every set of wanted
    gradients a path asks for: all (the pretrainer), features and
    points (tracking), features and one decoder's weights (mapping's
    color stage), features only (mapping's other stages)."""
    _, _, tspec, tparams = decoders
    decs = _decs(kind, tspec)
    p_np, f_np, g_np = _inputs(kind, seed=2)
    p = torch.tensor(p_np, requires_grad=True)
    feats = [torch.tensor(f, requires_grad=True) for f in f_np]
    g = torch.tensor(g_np)
    weights = [DS.pack(tparams[n], d, 32).detach().requires_grad_(True)
               for n, d in zip(CALLS[kind][0], decs)]
    out = DS.decoder_fwd_plain(p, feats, weights, decs)
    ref = torch.autograd.grad(out, [p, *feats, *weights], g, allow_unused=True)
    D = len(decs)
    for need_p, need_w in ((True, [True] * D), (True, [False] * D),
                           (False, [False] * (D - 1) + [True]), (False, [False] * D)):
        dp, dfeats, dws = DS.decoder_bwd_plain(p.detach(), [f.detach() for f in feats],
                                               [w.detach() for w in weights], decs, g,
                                               need_p, [True] * len(feats), need_w)
        assert (dp is not None) == need_p
        if need_p:
            _close(dp, ref[0], PLAIN_RTOL, "dp")
        for i, (a, b) in enumerate(zip(dfeats, ref[1:1 + len(feats)])):
            if b is None or not b.abs().max():
                assert a is None, f"feature {i} (detached) got a gradient"
            else:
                _close(a, b, PLAIN_RTOL, f"feature {i}")
        for i, (a, b, want) in enumerate(zip(dws, ref[1 + len(feats):], need_w)):
            assert (a is not None) == want
            if want:
                for name, x in DS.unpack(a, decs[i], 32).items():
                    _close(x, DS.unpack(b, decs[i], 32)[name], PLAIN_RTOL,
                           f"decoder {i} {name}")


def test_pack_layout_round_trips(decoders):
    """pack places every leaf where unpack (and decoder_stage.cu's layout)
    reads it, and the buffer has the kernels' size."""
    _, _, tspec, tparams = decoders
    for kind in ("coarse", "middle", "fine", "color"):
        (dec,) = _decs(kind, tspec)
        w = DS.pack(tparams[kind], dec, 32)
        assert w.shape == (DS.size(dec, 32),)
        m = DS.unpack(w, dec, 32)
        leaves = tparams[kind]
        assert torch.equal(m["W3"], leaves["pts_linears"][3]["w"])
        assert torch.equal(m["Wo"], leaves["output_linear"]["w"])
        if dec.emb:
            assert torch.equal(m["B"], leaves["embedder_B"])
            assert torch.equal(m["Wc4"], leaves["fc_c"][4]["w"])
        # every W row starts 16-byte aligned (the kernels' float4 loads)
        offs, o = {}, 0
        for name, shape in DS.layout(dec, 32):
            offs[name] = o
            o += int(np.prod(shape))
        assert all(offs[k] % 4 == 0 for k in offs if k.startswith("W"))


def _spy(monkeypatch):
    calls = []
    inner = DS.decoder_bwd

    def spy(p, feats, weights, decs, g, need_p, need_f, need_w):
        calls.append((bool(need_p), tuple(need_f), tuple(need_w)))
        return inner(p, feats, weights, decs, g, need_p, need_f, need_w)

    monkeypatch.setattr(DS, "decoder_bwd", spy)
    return calls


def _scene():
    from nice_slam_torch.config import load_config
    from nice_slam_torch.models.scene import build_scene

    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "nice_slam.yaml"))
    cfg["coarse"] = True
    return build_scene(cfg, nice=True, seed=0, device="cpu")


def test_tracking_computes_no_weight_gradient(monkeypatch):
    """A tracking iteration's color stage: the points and the features
    need gradients, no decoder trains (so no K6), and the CPU counts no
    launch."""
    from nice_slam_torch.models.scene import eval_points

    spec, state = _scene()
    calls = _spy(monkeypatch)
    DS.reset_launch_counts()
    p = (torch.rand((200, 3)) * 2 - 1).requires_grad_(True)
    eval_points(spec, state, p, "color").sum().backward()
    assert calls == [(True, (True, True, True), (False, False, False))]
    assert p.grad is not None and torch.isfinite(p.grad).all()
    assert all(v == 0 for v in DS.launch_counts.values()), DS.launch_counts


def test_mapping_color_stage_trains_only_the_color_decoder(monkeypatch):
    """The mapper's color stage with fix_fine (configs/nice_slam.yaml):
    the grids and the color decoder train, the middle and fine decoders
    get no gradient work, and the points none (BA off)."""
    from nice_slam_torch.models.scene import eval_points
    from nice_slam_torch.slam.mapper import tree_map

    spec, state = _scene()
    grids = {k: v.clone().requires_grad_(True) for k, v in state.grids.items()}
    dec = dict(state.decoders)
    dec["color"] = tree_map(lambda t: t.clone().requires_grad_(True), dec["color"])
    calls = _spy(monkeypatch)
    p = torch.rand((200, 3)) * 2 - 1
    out = eval_points(spec, state._replace(grids=grids, decoders=dec), p, "color")
    out.sum().backward()
    assert calls == [(False, (True, True, True), (False, False, True))]
    assert dec["color"]["pts_linears"][0]["w"].grad is not None
    assert state.decoders["fine"]["pts_linears"][0]["w"].grad is None
    assert grids["grid_middle"].grad is not None


def test_imap_is_not_routed(monkeypatch):
    """iMAP*'s 256-wide MLP without grids stays on its matmul chain."""
    from nice_slam_torch.config import load_config
    from nice_slam_torch.models.scene import build_scene, eval_points

    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic", "box.yaml"),
                      os.path.join(ROOT, "configs", "imap.yaml"))
    spec, state = build_scene(cfg, nice=False, seed=0, device="cpu")
    called = []
    monkeypatch.setattr(DS, "decoder_stage", lambda *a: called.append(a))
    out = eval_points(spec, state, torch.rand((50, 3)), "color")
    assert out.shape == (50, 4) and not called
    assert not DS.supported(spec.decoder)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors every wrapper runs its plain version and counts no
    launch; K6's plain sum is the sum over rows."""
    DS.reset_launch_counts()
    part = torch.randn((5, 7))
    assert torch.equal(DS.decoder_wgrad_sum(part), part.sum(0))
    dec = DS.Dec(emb=False, feat=0, feat2=-1, fc=False, out=1, occ3=True)
    w = torch.randn(DS.size(dec, 8))
    p, f = torch.rand((10, 3)), torch.randn((10, 8))
    assert torch.equal(DS.decoder_fwd(p, [f], [w], [dec]),
                       DS.decoder_fwd_plain(p, [f], [w], [dec]))
    assert all(v == 0 for v in DS.launch_counts.values())
    with pytest.raises(ValueError):
        DS.decoder_stage(p, [dec, dec], [f], [w, w])  # one primary feature, two readers


# (points, SMs, a decoder trains): tracking's and mapping's calls on an
# H100, one point, ragged tiles, fewer tiles than SMs, unequal tiles per CTA
GEOMETRY_CASES = ((9600, 132, False), (48000, 132, True), (48000, 132, False), (1, 132, False),
                  (1, 132, True), (15, 132, False), (17, 132, False), (63, 132, True),
                  (65, 132, True), (135 * 64 + 5, 132, True), (4096, 78, True))


@pytest.mark.parametrize("n,sms,train", GEOMETRY_CASES)
def test_bwd_geometry(n, sms, train):
    """K5's launch as a function of (n, SMs, train, decoders): 16-point
    tiles of 2 warps, one CTA per tile and decoder, where nothing trains;
    where a decoder trains, 64-point tiles of 8 warps over at most one CTA
    per SM running every decoder, a row of partials per CTA; each partial
    buffer (CTAs, packed size)."""
    for decoders in (1, 3):
        geom = DS.bwd_geometry(n, sms, train, decoders)
        tile = 64 if train else 16
        assert geom.tile == tile and geom.threads == 32 * tile // 8
        assert geom.tiles == -(-n // tile) and (geom.tiles - 1) * tile < n <= geom.tiles * tile
        assert geom.grid == ((min(geom.tiles, sms), 1) if train else (geom.tiles, decoders))
        assert geom.ctas == geom.grid[0] * geom.grid[1]
        assert geom.rows == (geom.grid[0] if train else 0)
    dec = DS.Dec(emb=True, feat=0, feat2=1, fc=True, out=1, occ3=True)
    need = [False, train]
    shapes = DS.partial_shapes([DS.Dec(True, 2, -1, True, 4, False), dec], 32, need, geom)
    assert shapes == [None, (geom.grid[0], DS.size(dec, 32)) if train else None]
    assert DS.size(dec, 32) == 20920  # the fine decoder: 10,048 + 160 + 10,240 + 160 + 33 + 279


# (points, SMs): tracking's call on an H100, mapping's stages, the coarse
# mapper, one point, fewer points than an SM's warp, a render chunk, and a
# card with fewer SMs
FWD_GEOMETRY_CASES = ((9600, 132), (48000, 132), (32000, 132), (1, 132), (7, 132),
                      (500_000, 132), (4_800_000, 132), (4096, 78))


@pytest.mark.parametrize("n,sms", FWD_GEOMETRY_CASES)
def test_fwd_geometry(n, sms):
    """K4's launch as a function of (n, SMs): at most one CTA per SM, of
    1-16 warps of 8 points; the tiles cover the points once; the warps are
    the fewest that cover the points in as many rounds as 16 warps would,
    so tracking's 9,600 points on 132 SMs take 120 CTAs of 10 warps, one
    tile each, and a large call 16 warps an SM."""
    geom = DS.fwd_geometry(n, sms)
    assert 1 <= geom.warps <= DS.FWD_MAX_WARPS and geom.threads == 32 * geom.warps
    assert geom.tile == DS.WARP_POINTS * geom.warps
    assert (geom.tiles - 1) * geom.tile < n <= geom.tiles * geom.tile
    assert geom.grid == min(geom.tiles, sms)
    rounds = -(-geom.tiles // geom.grid)
    assert rounds == -(-n // (sms * 16 * 8))  # 16-warp CTAs would take as many
    if geom.warps > 1:  # one warp fewer would take another round
        assert -(-n // (8 * (geom.warps - 1))) > rounds * sms
    if (n, sms) == (9600, 132):
        assert (geom.grid, geom.warps, geom.tiles) == (120, 10, 120)
    if n >= 16 * 8 * sms:
        assert geom.warps >= 15 and geom.grid == sms


@pytest.mark.parametrize("rows", (1, 78, 132))
def test_plain_wgrad_sum_at_the_new_row_count(rows):
    """K6's plain version over one row of partials per SM (132 on an H100,
    the color decoder's 15,899 columns) against a float64 sum, within
    sqrt(rows) x eps of the largest sum of |partials|: the gate the card's
    K6 is held to."""
    gen = torch.Generator().manual_seed(rows)
    part = torch.randn((rows, 15899), generator=gen) * torch.rand((rows, 1), generator=gen)
    got = DS.decoder_wgrad_sum(part)
    ref = part.double().sum(0)
    tol = rows ** 0.5 * torch.finfo(torch.float32).eps * float(part.abs().double().sum(0).max())
    assert float((got.double() - ref).abs().max()) <= tol


def test_profile_flag_writes_a_trace(tmp_path):
    """``nice_slam_torch.run --profile`` on a few box frames on the CPU
    writes a readable torch.profiler trace under <output>/torch_trace/
    that holds the decoder stage's host activity."""
    import glob
    import json

    from nice_slam_torch.run import main

    yaml = tmp_path / "box.yaml"
    yaml.write_text(f"""inherit_from: {ROOT}/configs/Synthetic/box.yaml
verbose: false
meshing: null
cam: {{H: 30, W: 40, fx: 30.0, fy: 30.0, cx: 19.5, cy: 14.5}}
tracking: {{pixels: 32, iters: 2, ignore_edge_W: 2, ignore_edge_H: 2}}
mapping: {{pixels: 32, iters_first: 6, iters: 2, every_frame: 2,
          keyframe_every: 2, mesh_freq: 1000000, ckpt_freq: 1000000}}
rendering: {{N_samples: 4, N_surface: 2}}
data: {{n_frames: 3, orbit_radians: 0.05, output: {tmp_path}/out}}
""")
    cwd = os.getcwd()
    os.chdir(ROOT)  # box.yaml names its pretrained decoders from the root
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        main([str(yaml), "--device", "cpu", "--profile"])
    finally:
        os.chdir(cwd)
        torch.set_num_threads(threads)
    traces = glob.glob(str(tmp_path / "out" / "torch_trace" / "*.json"))
    assert len(traces) == 1, traces
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("_DecoderStage" in n for n in names), sorted(names)[:20]
