"""The NICE decoder stage: counterpart of the JAX package's
``models/decoders.py`` ``apply_nice_stage_batched`` (the fine and color
stages), ``apply_mlp`` (the middle stage; the fine and color decoders one
at a time) and ``apply_mlp_no_xyz`` (the coarse decoder).

A call runs D = 1-3 decoders over the same (N, 3) points and composes
their heads into one (N, 4) raw rgb + occupancy: an occupancy decoder's
one output adds into column 3 (occ = middle + fine residual); a color
decoder writes rgb and, called alone, its own occupancy.  Per decoder:

  * the lead input: the Fourier embedding sin(p @ B), B (3, 93), or, for
    the coarse decoder, its grid feature;
  * five 32-wide blocks relu(x W_k + b_k), each followed (with a grid
    feature ``feat``) by + feat Wc_k + bc_k; ``feat`` is the decoder's own
    feature, or for the fine decoder [fine, middle] whose middle half is
    detached; after block 2 the next input is [lead, h];
  * a head 32 -> 1 or 4.

Each decoder's weights travel as one packed float32 buffer (``pack``:
W_0..W_4, b_0..b_4, Wc_0..Wc_4, bc_0..bc_4, W_o, b_o, B), so the call's
``needs_input_grad`` says which decoders train; the packing is a ``cat``
of the parameter leaves, and autograd hands each leaf its slice.

The call is one ``torch.autograd.Function`` on three hand-written CUDA
kernels (``nice_slam_torch/csrc/decoder_stage.cu``), each with a plain
PyTorch version beside it:

  K4 ``decoder_fwd``        the stage's forward (plain: the JAX
                            functions' matmul chains, dense for one
                            decoder, batched on 128-wide zero-padded
                            inputs for a stage); its launch geometry is
                            ``fwd_geometry``, and its forward is K5's
                            recomputed one bit for bit;
  K5 ``decoder_bwd``        the backward from the output's cotangent: the
                            features' gradients, the points' (through
                            cos(p @ B) B), and per-CTA partial sums of
                            the weight gradients of the decoders that
                            train (plain: ``decoder_bwd_plain``, the same
                            gradients written out, not autograd); its
                            launch geometry is ``bwd_geometry``;
  K6 ``decoder_wgrad_sum``  the sum of those partials in a fixed order,
                            so the weight gradient is deterministic.

A wrapper takes the plain version only for tensors on the CPU; a CUDA
tensor launches the kernel or raises.  Launches are counted as
``ops/interp.py`` counts K1-K3, on the points' device and its current
stream.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from nice_slam_torch.ops import kernels

HIDDEN = 32       # hidden width of every NICE decoder
N_BLOCKS = 5
SKIP = 2          # after block SKIP the next input is [lead, h]
EMBED = 93        # Fourier embedding width
IN_WIDTH = 128    # the plain chain's zero-padded layer input (93 + 32 -> 128)
MAX_DECODERS = 3  # decoders per launch (kMaxDec in decoder_stage.cu)
WARP_POINTS = 8   # K4 and K5: points per warp (WPTS in decoder_stage.cu)
FWD_MAX_WARPS = 16   # K4: warps per CTA at most (K4_MAX_WARPS)
BWD_WARPS = {False: 2, True: 8}  # K5: warps per CTA, without / with a decoder that trains

_launches = kernels.LaunchCounter(("decoder_fwd", "decoder_bwd",
                                   "decoder_wgrad_sum"))
launch_counts = _launches.counts
launches_by_stream = _launches.by_stream
launches_by_device = _launches.by_device
reset_launch_counts = _launches.reset


class Dec(NamedTuple):
    """One decoder of a call: ``emb``: its lead is the Fourier embedding
    (else its primary feature); ``feat``: the index of its primary feature
    in the call's features; ``feat2``: that of the detached secondary
    feature concatenated after it (the fine decoder's middle), or -1;
    ``fc``: it adds feature injections (not the coarse decoder); ``out``: 1
    (occupancy) or 4 (rgb + occ); ``occ3``: a 4-wide head's occupancy adds
    into the output's column 3 (a color decoder called alone)."""

    emb: bool
    feat: int
    feat2: int
    fc: bool
    out: int
    occ3: bool


def fw(dec: Dec, c: int) -> int:
    """Width of a decoder's feature injection input."""
    return 0 if not dec.fc else c * (2 if dec.feat2 >= 0 else 1)


def lead_width(dec: Dec, c: int) -> int:
    return EMBED if dec.emb else c


def in_rows(dec: Dec, c: int, k: int) -> int:
    """Rows of block k's weight: the lead, then [lead, h] after SKIP."""
    lead = lead_width(dec, c)
    return lead if k == 0 else (lead + HIDDEN if k == SKIP + 1 else HIDDEN)


def layout(dec: Dec, c: int) -> List[Tuple[str, Tuple[int, ...]]]:
    """The packed buffer's pieces in order, (name, shape), as
    ``decoder_stage.cu``'s ``layout`` places them."""
    H, f = HIDDEN, fw(dec, c)
    parts = [(f"W{k}", (in_rows(dec, c, k), H)) for k in range(N_BLOCKS)]
    parts += [(f"b{k}", (H,)) for k in range(N_BLOCKS)]
    if f:
        parts += [(f"Wc{k}", (f, H)) for k in range(N_BLOCKS)]
        parts += [(f"bc{k}", (H,)) for k in range(N_BLOCKS)]
    parts += [("Wo", (H, dec.out)), ("bo", (dec.out,))]
    if dec.emb:
        parts.append(("B", (3, EMBED)))
    return parts


def size(dec: Dec, c: int) -> int:
    return sum(math.prod(s) for _, s in layout(dec, c))


def unpack(w: torch.Tensor, dec: Dec, c: int) -> Dict[str, torch.Tensor]:
    """Views of a packed buffer's pieces."""
    out, o = {}, 0
    for name, shape in layout(dec, c):
        n = math.prod(shape)
        out[name] = w[o:o + n].view(shape)
        o += n
    return out


def pack_tensors(pieces: Dict[str, torch.Tensor], dec: Dec, c: int) -> torch.Tensor:
    return torch.cat([pieces[name].reshape(-1) for name, _ in layout(dec, c)])


def pack(params, dec: Dec, c: int) -> torch.Tensor:
    """One decoder's parameter tree (the JAX package's layout) -> its
    packed buffer, differentiable in every leaf."""
    pieces = {"Wo": params["output_linear"]["w"], "bo": params["output_linear"]["b"]}
    for k, layer in enumerate(params["pts_linears"]):
        pieces[f"W{k}"], pieces[f"b{k}"] = layer["w"], layer["b"]
    if dec.fc:
        for k, layer in enumerate(params["fc_c"]):
            pieces[f"Wc{k}"], pieces[f"bc{k}"] = layer["w"], layer["b"]
    if dec.emb:
        pieces["B"] = params["embedder_B"]
    return pack_tensors(pieces, dec, c)


def supported(spec) -> bool:
    """Whether an MLPSpec is a NICE decoder this stage runs (iMAP*'s
    256-wide MLP without grids is not)."""
    return (spec.hidden_size == HIDDEN and spec.n_blocks == N_BLOCKS
            and tuple(spec.skips) == (SKIP,) and spec.dim == 3 and spec.c_dim > 0
            and (spec.no_xyz or spec.pos_embedding_method == "fourier"))


def decoder_of(spec, feat: int, feat2: int = -1, occ3: bool = True) -> Dec:
    """The ``Dec`` of an MLPSpec whose primary feature is ``feat``."""
    return Dec(emb=not spec.no_xyz, feat=feat, feat2=feat2, fc=not spec.no_xyz,
               out=spec.out_dim, occ3=occ3)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the reference the kernels are
# held against on the card)
# ---------------------------------------------------------------------------

def _compose(outs: Sequence[torch.Tensor], decs: Sequence[Dec], n: int,
             like: torch.Tensor) -> torch.Tensor:
    """The decoders' heads -> (N, 4): rgb from a color head (else 0), occ =
    the sum of the occupancy heads (and a lone color head's own)."""
    rgb = torch.zeros((n, 3), dtype=like.dtype, device=like.device)
    occ = None
    for o, d in zip(outs, decs):
        if d.out == 4:
            rgb = o[:, :3]
            if not d.occ3:
                continue
        o = o[:, 3] if d.out == 4 else o[:, 0]
        occ = o if occ is None else occ + o
    if occ is None:
        occ = torch.zeros((n,), dtype=like.dtype, device=like.device)
    return torch.cat([rgb, occ[:, None]], dim=-1)


def _feature(dec: Dec, feats: Sequence[torch.Tensor]) -> torch.Tensor:
    """A decoder's injected feature: its own, or [own, secondary.detach()]."""
    f = feats[dec.feat]
    return f if dec.feat2 < 0 else torch.cat([f, feats[dec.feat2].detach()], dim=-1)


def _dense_chain(m: Dict[str, torch.Tensor], dec: Dec, lead: torch.Tensor,
                 feat: Optional[torch.Tensor]):
    """One decoder as a chain of dense matmuls at its true widths."""
    xs, zs, h = [], [], lead
    for k in range(N_BLOCKS):
        xs.append(h)
        zs.append(h @ m[f"W{k}"] + m[f"b{k}"])
        h = torch.relu(zs[-1])
        if dec.fc:
            h = h + (feat @ m[f"Wc{k}"] + m[f"bc{k}"])
        if k == SKIP:
            h = torch.cat([lead, h], dim=-1)
    return xs, zs, h, h @ m["Wo"] + m["bo"]


def _batched_chain(mats: Sequence[Dict[str, torch.Tensor]], decs: Sequence[Dec],
                   leads: Sequence[torch.Tensor], feats: Sequence[torch.Tensor]):
    """A stage's decoders (each with the embedding and feature injection)
    as one batched chain, (D, N, 128) @ (D, 128, 32) per block on
    zero-padded inputs and weights, heads padded to 4 wide."""
    fwm = max(f.shape[1] for f in feats)

    def stacked(key, rows):
        return torch.stack([F.pad(m[key], (0, 0, 0, rows - m[key].shape[0])) for m in mats])

    def bias(key):
        return torch.stack([m[key] for m in mats])[:, None, :]

    feat = torch.stack([F.pad(f, (0, fwm - f.shape[1])) for f in feats])
    x = F.pad(torch.stack(leads), (0, IN_WIDTH - EMBED))
    xs, zs = [], []
    for k in range(N_BLOCKS):
        xs.append(x)
        zs.append(torch.bmm(x, stacked(f"W{k}", IN_WIDTH)) + bias(f"b{k}"))
        h = torch.relu(zs[-1])
        h = h + torch.bmm(feat, stacked(f"Wc{k}", fwm)) + bias(f"bc{k}")
        if k == SKIP:
            x = F.pad(torch.cat([torch.stack(leads), h], dim=-1),
                      (0, IN_WIDTH - EMBED - HIDDEN))
        else:
            x = F.pad(h, (0, IN_WIDTH - HIDDEN))
    wo = torch.stack([F.pad(m["Wo"], (0, 4 - m["Wo"].shape[1])) for m in mats])
    bo = torch.stack([F.pad(m["bo"], (0, 4 - m["bo"].shape[0])) for m in mats])
    out = torch.bmm(h, wo) + bo[:, None, :]
    return xs, zs, h, [out[i, :, :d.out] for i, d in enumerate(decs)]


def _plain_chain(p: torch.Tensor, feats: Sequence[torch.Tensor],
                 weights: Sequence[torch.Tensor], decs: Sequence[Dec]):
    """The decoders' forward, as the JAX package's functions lay it out:
    one decoder (``apply_mlp``, ``apply_mlp_no_xyz``) as dense matmuls,
    a stage of 2-3 (``apply_nice_stage_batched``) as the batched chain.
    Returns each decoder's head and, per decoder, what the backward
    reads: its unpacked weights, theta = p @ B (or None), lead, injected
    feature, and per block its input x and pre-activation z (N, 32)."""
    c = feats[0].shape[1]
    mats = [unpack(w, d, c) for w, d in zip(weights, decs)]
    injected = [_feature(d, feats) if d.fc else None for d in decs]
    if len(decs) == 1:
        m, d = mats[0], decs[0]
        thetas = [p @ m["B"] if d.emb else None]
        leads = [torch.sin(thetas[0]) if d.emb else feats[d.feat]]
        xs, zs, h, out = _dense_chain(m, d, leads[0], injected[0])
        xs, zs, hs, outs = [xs], [zs], [h], [out]
    else:
        if not all(d.emb and d.fc for d in decs):
            raise ValueError("a stage of several decoders takes the NICE point decoders")
        theta = torch.einsum("np,dpe->dne", p, torch.stack([m["B"] for m in mats]))
        thetas = list(theta)
        leads = list(torch.sin(theta))
        xs, zs, h, outs = _batched_chain(mats, decs, leads, injected)
        xs = [[x[i, :, :in_rows(d, c, k)] for k, x in enumerate(xs)]
              for i, d in enumerate(decs)]
        zs, hs = [[z[i] for z in zs] for i in range(len(decs))], list(h)
    cache = {"mats": mats, "thetas": thetas, "leads": leads, "injected": injected,
             "xs": xs, "zs": zs, "h": hs}
    return outs, cache


def decoder_fwd_plain(p: torch.Tensor, feats: Sequence[torch.Tensor],
                      weights: Sequence[torch.Tensor], decs: Sequence[Dec]
                      ) -> torch.Tensor:
    """K4's plain version: the matmul chains of ``_plain_chain`` and the
    composed (N, 4) output.  Differentiable."""
    outs, _ = _plain_chain(p, feats, weights, decs)
    return _compose(outs, decs, p.shape[0], p)


def decoder_bwd_plain(p: torch.Tensor, feats: Sequence[torch.Tensor],
                      weights: Sequence[torch.Tensor], decs: Sequence[Dec],
                      g: torch.Tensor, need_p: bool, need_feats: Sequence[bool],
                      need_w: Sequence[bool]):
    """K5 + K6's plain version: the gradients of the call from the (N, 4)
    cotangent ``g``, written out as the kernels compute them (the forward
    recomputed, then each decoder's blocks in reverse), at the plain
    forward's own activations: dp (N, 3) or None, one (N, C) gradient per
    feature (None unless some decoder reads it as its primary feature and
    it is wanted), one packed weight gradient per decoder (None unless
    wanted)."""
    c = feats[0].shape[1]
    dp = torch.zeros_like(p) if need_p else None
    dfeats: List[Optional[torch.Tensor]] = [None] * len(feats)
    dws: List[Optional[torch.Tensor]] = [None] * len(decs)
    _, cache = _plain_chain(p, feats, weights, decs)
    for i, d in enumerate(decs):
        train = need_w[i]
        want_f = need_feats[d.feat]
        if not (train or want_f or (need_p and d.emb)):
            continue
        m, theta, lead = cache["mats"][i], cache["thetas"][i], cache["leads"][i]
        feat, xs, zs, h = (cache[k][i] for k in ("injected", "xs", "zs", "h"))
        if d.out == 1:
            dout = g[:, 3:4]
        else:
            dout = torch.cat([g[:, :3], g[:, 3:4] if d.occ3 else torch.zeros_like(g[:, 3:4])],
                             dim=-1)
        gw = {"Wo": h.t() @ dout, "bo": dout.sum(0)}
        dh = dout @ m["Wo"].t()
        dfeat = torch.zeros_like(feat) if d.fc else None
        dlead = torch.zeros_like(lead)
        for k in reversed(range(N_BLOCKS)):
            if d.fc:
                dfeat = dfeat + dh @ m[f"Wc{k}"].t()
                gw[f"Wc{k}"], gw[f"bc{k}"] = feat.t() @ dh, dh.sum(0)
            dz = dh * (zs[k] > 0).to(dh.dtype)
            gw[f"W{k}"], gw[f"b{k}"] = xs[k].t() @ dz, dz.sum(0)
            dx = dz @ m[f"W{k}"].t()
            lw = lead.shape[1]
            if k == 0:
                dlead = dlead + dx
            elif k == SKIP + 1:
                dlead, dh = dlead + dx[:, :lw], dx[:, lw:]
            else:
                dh = dx
        if d.emb:
            da = dlead * torch.cos(theta)
            gw["B"] = p.t() @ da
            if need_p:
                dp = dp + da @ m["B"].t()
        if want_f:
            df = (dfeat[:, :c] if d.fc else 0) + (0 if d.emb else dlead)
            dfeats[d.feat] = df if dfeats[d.feat] is None else dfeats[d.feat] + df
        if train:
            dws[i] = pack_tensors(gw, d, c)
    return dp, dfeats, dws


def decoder_wgrad_sum_plain(part: torch.Tensor) -> torch.Tensor:
    """K6's plain version: the (rows, W) per-CTA partials summed over rows."""
    return part.sum(0)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...],
           device: torch.device, align: int = 4) -> None:
    """A kernel argument's device, type, shape and layout (``align``: 16
    where the kernel reads it in 16-byte loads, the weights)."""
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must lie on the points' CUDA device {device}, "
                         f"not {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name} must be contiguous and {align}-byte aligned")


def _check_call(p: torch.Tensor, feats: Sequence[torch.Tensor],
                weights: Sequence[torch.Tensor], decs: Sequence[Dec]) -> int:
    """Checks shared by K4 and K5.  Returns the feature width C."""
    if not 1 <= len(decs) <= MAX_DECODERS or len(weights) != len(decs):
        raise ValueError(f"one launch takes 1..{MAX_DECODERS} decoders with one "
                         f"weight buffer each, got {len(decs)} and {len(weights)}")
    n = p.shape[0]
    if n >= 2 ** 31 // 4:
        raise ValueError("too many points for 32-bit launch indices")
    _check("points", p, (n, 3), p.device)
    c = feats[0].shape[1]
    if not 1 <= c <= 32:
        raise ValueError(f"feature width {c} must be 1..32")
    for f in feats:
        _check("feature", f, (n, c), p.device)
    for w, d in zip(weights, decs):
        _check("weights", w, (size(d, c),), p.device, 16)
        if not (0 <= d.feat < len(feats) and d.feat2 < len(feats) and d.out in (1, 4)):
            raise ValueError(f"bad decoder {d} for {len(feats)} features")
    return c


def _desc(decs: Sequence[Dec], feats: Sequence[torch.Tensor],
          weights: Sequence[torch.Tensor], parts: Sequence[Optional[torch.Tensor]],
          dfeats: Sequence[Optional[torch.Tensor]], c: int) -> ctypes.Array:
    """The launch's descriptor table: per decoder its weights, weight-
    gradient partials (0: none), primary and secondary features, primary
    feature's gradient (0: none), and emb, fw, out, occ3."""
    def ptr(t):
        return 0 if t is None else t.data_ptr()

    table = []
    for d, w, part in zip(decs, weights, parts):
        table += [w.data_ptr(), ptr(part), feats[d.feat].data_ptr(),
                  feats[d.feat2].data_ptr() if d.feat2 >= 0 else 0,
                  ptr(dfeats[d.feat]), int(d.emb), fw(d, c), d.out, int(d.occ3)]
    return (ctypes.c_longlong * len(table))(*table)


def _launch(name: str, device: torch.device, *args) -> None:
    """Launch ``name`` on ``device`` and its current stream, and count it."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(kernels.library("decoder_stage"), name)(*args, stream)
        kernels.check(rc, name)
    _launches.count(name, stream, device.index)


class FwdGeometry(NamedTuple):
    """K4's launch: ``grid`` persistent CTAs of ``threads`` threads
    (``warps`` warps of 8 points), CTA b walking tiles b, b + grid, ...
    of the ``tiles`` tiles of ``tile`` points, each decoder of the call in
    turn."""

    grid: int
    threads: int
    warps: int
    tile: int
    tiles: int


def fwd_geometry(n: int, sms: int) -> FwdGeometry:
    """K4's launch geometry, a function of (n, SM count) alone: the rounds
    of tiles a CTA walks at 16 warps, then the fewest warps that cover the
    points in that many rounds over the SMs, at most one CTA per SM (the
    CTA holds a decoder's weights, up to ~84 KB, and its rows).  A small
    call spreads over every SM (tracking's 9,600 points on 132 SMs: 120
    CTAs of 10 warps, one tile each), a large one runs 16 warps an SM.
    The decoders run in turn in every CTA, so their number does not enter."""
    rounds = max(1, -(-n // (sms * FWD_MAX_WARPS * WARP_POINTS)))
    warps = -(-n // (rounds * sms * WARP_POINTS))
    tile = WARP_POINTS * warps
    tiles = -(-n // tile)
    return FwdGeometry(grid=min(tiles, sms), threads=32 * warps, warps=warps, tile=tile,
                       tiles=tiles)


def decoder_fwd(p: torch.Tensor, feats: Sequence[torch.Tensor],
                weights: Sequence[torch.Tensor], decs: Sequence[Dec]
                ) -> torch.Tensor:
    """K4: the stage's composed (N, 4) output."""
    if not p.is_cuda:
        return decoder_fwd_plain(p, feats, weights, decs)
    c = _check_call(p, feats, weights, decs)
    n = p.shape[0]
    out = torch.empty((n, 4), dtype=torch.float32, device=p.device)
    if n:
        desc = _desc(decs, feats, weights, [None] * len(decs), [None] * len(feats), c)
        geom = fwd_geometry(n, kernels.sm_count(p.device.index))
        _launch("decoder_fwd", p.device, desc, len(decs), c, p.data_ptr(),
                out.data_ptr(), geom.warps, geom.grid, n)
    return out


class BwdGeometry(NamedTuple):
    """K5's launch: a ``grid`` of (x, y) CTAs, ``ctas`` in all, of
    ``threads`` threads; ``tiles`` tiles of ``tile`` points (8 a warp), CTA
    (b, y) walking tiles b, b + x, ... in order (y: the decoder, where each
    has CTAs of its own); ``rows``: the rows of each training decoder's
    partials (0 where none trains)."""

    grid: Tuple[int, int]
    ctas: int
    threads: int
    tile: int
    tiles: int
    rows: int


def bwd_geometry(n: int, sms: int, train: bool, decoders: int = 1) -> BwdGeometry:
    """K5's launch geometry, a function of (n, SM count, train, decoders)
    alone.  Where no decoder trains, one CTA of 2 warps per tile of 16
    points and decoder (at tracking's 9,600 points and 3 decoders 1,800
    CTAs; an SM holds 8 of them, 16 warps); where one trains, one persistent CTA
    of 8 warps per SM (tiles of 64 points) runs every decoder, so each CTA
    writes one row of partials and the weight gradient's summation order
    depends on nothing else."""
    warps = BWD_WARPS[bool(train)]
    tile = WARP_POINTS * warps
    tiles = -(-n // tile)
    grid = (min(tiles, sms), 1) if train else (tiles, decoders)
    return BwdGeometry(grid=grid, ctas=grid[0] * grid[1], threads=32 * warps, tile=tile,
                       tiles=tiles, rows=grid[0] if train else 0)


def partial_shapes(decs: Sequence[Dec], c: int, need_w: Sequence[bool],
                   geom: BwdGeometry) -> List[Optional[Tuple[int, int]]]:
    """The shape of each decoder's weight-gradient partials (K5 writes a
    row per CTA, K6 sums them), None for a decoder that does not train."""
    return [(geom.rows, size(d, c)) if w else None for d, w in zip(decs, need_w)]


def decoder_wgrad_sum(part: torch.Tensor) -> torch.Tensor:
    """K6: the (rows, W) per-CTA weight-gradient partials summed over the
    rows in a fixed order -> (W,)."""
    if not part.is_cuda:
        return decoder_wgrad_sum_plain(part)
    rows, cols = part.shape
    _check("partials", part, (rows, cols), part.device)
    out = torch.empty((cols,), dtype=torch.float32, device=part.device)
    _launch("decoder_wgrad_sum", part.device, part.data_ptr(), rows, cols,
            out.data_ptr())
    return out


def decoder_bwd(p: torch.Tensor, feats: Sequence[torch.Tensor],
                weights: Sequence[torch.Tensor], decs: Sequence[Dec],
                g: torch.Tensor, need_p: bool, need_feats: Sequence[bool],
                need_w: Sequence[bool]):
    """K5, then K6 once per decoder whose weights need a gradient: dp,
    the features' gradients and the packed weight gradients, as
    ``decoder_bwd_plain`` returns them."""
    if not p.is_cuda:
        return decoder_bwd_plain(p, feats, weights, decs, g, need_p, need_feats, need_w)
    c = _check_call(p, feats, weights, decs)
    n = p.shape[0]
    _check("grad_output", g, (n, 4), p.device)
    dev = p.device
    prim = {d.feat for d in decs}
    dfeats = [torch.empty_like(f) if need_feats[i] and i in prim else None
              for i, f in enumerate(feats)]
    train = any(need_w)
    # several decoders in CTAs of their own meet in dp through their shares
    split = need_p and not train and len(decs) > 1 and n > 0
    dp = (torch.empty if split else torch.zeros)((n, 3), dtype=torch.float32,
                                                  device=dev) if need_p else None
    if not n:
        for df in dfeats:
            if df is not None:
                df.zero_()
        return dp, dfeats, [torch.zeros(size(d, c), device=dev) if need_w[i] else None
                            for i, d in enumerate(decs)]
    geom = bwd_geometry(n, kernels.sm_count(dev.index),
                        train, len(decs))
    dpart = torch.empty((len(decs), n, 3), dtype=torch.float32, device=dev) if split else None
    counter = torch.zeros((geom.tiles,), dtype=torch.int32, device=dev) if split else None
    parts = [None if shape is None else torch.empty(shape, dtype=torch.float32, device=dev)
             for shape in partial_shapes(decs, c, need_w, geom)]
    desc = _desc(decs, feats, weights, parts, dfeats, c)
    _launch("decoder_bwd", dev, desc, len(decs), c, p.data_ptr(), g.data_ptr(),
            *(0 if t is None else t.data_ptr() for t in (dp, dpart, counter)),
            geom.grid[0], n)
    return dp, dfeats, [None if part is None else decoder_wgrad_sum(part) for part in parts]


def bwd_smem(decs: Sequence[Dec], c: int, need_w: Sequence[bool],
             device: torch.device) -> int:
    """K5's dynamic shared memory for a launch (the CUDA source's row
    layout): the tile's rows, plus the weight-gradient sums of the largest
    decoder that trains."""
    counts = [size(d, c) for d, w in zip(decs, need_w) if w]
    with torch.cuda.device(device):
        return kernels.library("decoder_stage").decoder_bwd_smem(
            int(bool(counts)), max(counts, default=0))


def fwd_smem(decs: Sequence[Dec], c: int, warps: int, device: torch.device) -> int:
    """K4's dynamic shared memory for a call (the CUDA source's layout): the
    largest packed buffer of its decoders, then a row per point of the
    CTA's ``warps`` warps."""
    with torch.cuda.device(device):
        return kernels.library("decoder_stage").decoder_fwd_smem(
            max(size(d, c) for d in decs), warps)


KERNEL_IDS = {"decoder_fwd": 0, "decoder_bwd": 1, "decoder_bwd_train": 2,
              "decoder_wgrad_sum": 3}


def kernel_info(which: str, smem: int, device: torch.device,
                threads: int = 0) -> Dict[str, int]:
    """A kernel's compiled resources, read with cudaFuncGetAttributes, and
    its resident CTAs per SM at ``smem`` bytes of dynamic shared memory
    and ``threads`` threads per CTA (0: the kernel's own; K4's depends on
    the call, ``fwd_geometry``) (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
    ``which``: a key of KERNEL_IDS (``decoder_bwd_train``: K5 where a
    decoder trains)."""
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        rc = kernels.library("decoder_stage").decoder_kernel_info(
            KERNEL_IDS[which], smem, threads, out)
    kernels.check(rc, f"decoder_kernel_info({which})")
    return dict(zip(("registers", "local_bytes", "static_shared_bytes", "threads",
                     "ctas_per_sm"), out))


class _DecoderStage(torch.autograd.Function):
    """D decoders over the same points: forward one K4; backward one K5
    (the feature and point gradients, and the weight-gradient partials of
    the decoders that train) and one K6 per decoder that trains."""

    @staticmethod
    def forward(ctx, p, decs, n_feats, *tensors):
        p = p.contiguous()
        tensors = tuple(t.contiguous() for t in tensors)
        ctx.save_for_backward(p, *tensors)
        ctx.decs, ctx.n_feats = decs, n_feats
        return decoder_fwd(p, tensors[:n_feats], tensors[n_feats:], decs)

    @staticmethod
    def backward(ctx, g):
        p, *tensors = ctx.saved_tensors
        nf = ctx.n_feats
        need = ctx.needs_input_grad
        need_p, need_f, need_w = need[0], need[3:3 + nf], need[3 + nf:]
        if not (need_p or any(need_f) or any(need_w)):
            return (None,) * len(need)
        dp, dfeats, dws = decoder_bwd(p, tensors[:nf], tensors[nf:], ctx.decs,
                                      g.contiguous(), need_p, need_f, need_w)
        return (dp, None, None, *dfeats, *dws)


def decoder_stage(p: torch.Tensor, decs: Sequence[Dec],
                  feats: Sequence[torch.Tensor],
                  weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """Run the decoders ``decs`` (packed ``weights``) over (N, 3) points
    with the call's (N, C) grid features -> the composed (N, 4) raw rgb +
    occ, differentiable in the points, the features and the weights."""
    if len({d.feat for d in decs}) != len(decs):
        raise ValueError("each feature is the primary feature of one decoder at most")
    return _DecoderStage.apply(p, tuple(decs), len(feats), *feats, *weights)
