"""NICE decoder stack: counterpart of the JAX package's ``models/decoders.py``.

Parameters are plain nested dicts of tensors with the JAX package's
layout (a dense layer is ``{"w": (in, out), "b": (out,)}``), so a
parameter tree converts leaf for leaf.  Only the NICE model family is
ported here; the iMAP single MLP comes with a later slice.

  * ``apply_mlp``        grid-conditioned point decoder: Fourier embedding,
                         n_blocks layers with post-relu feature injection
                         ``h += fc_c[i](feat)`` and a skip concat;
  * ``apply_mlp_no_xyz`` the coarse decoder (the grid feature is the input);
  * ``apply_nice``       stage dispatch: coarse -> coarse occ, middle ->
                         middle occ, fine -> fine + middle occ, color -> rgb
                         of the color head + fine + middle occ;
  * ``apply_nice_stage_batched``  the fine/color stages' 2-3 decoders as one
                         batched matmul chain on 128-wide zero-padded inputs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from nice_slam_torch.ops.interp import sample_grid_feature, sample_grid_features

Params = Dict[str, Any]

FOURIER_EMBED_SIZE = 93
FOURIER_SCALE = 25.0
_BATCH_IN_WIDTH = 128  # padded layer-input width (93 embed + 32 hidden -> 128)


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    """Static architecture description of one decoder MLP."""

    name: str = ""
    dim: int = 3
    c_dim: int = 32
    hidden_size: int = 32
    n_blocks: int = 5
    skips: Tuple[int, ...] = (2,)
    color: bool = False
    concat_feature: bool = False  # fine decoder: concat the middle feature
    pos_embedding_method: str = "fourier"
    no_xyz: bool = False  # coarse decoder variant

    @property
    def embedding_size(self) -> int:
        if self.no_xyz:
            return 0
        if self.pos_embedding_method == "fourier":
            return FOURIER_EMBED_SIZE
        raise ValueError(f"pos_embedding_method {self.pos_embedding_method!r} "
                         "is not ported; only 'fourier'")

    @property
    def feat_dim(self) -> int:
        return self.c_dim * (2 if self.concat_feature else 1)

    @property
    def out_dim(self) -> int:
        return 4 if self.color else 1


@dataclasses.dataclass(frozen=True)
class NICESpec:
    """Static description of the NICE 4-level decoder stack."""

    dim: int = 3
    c_dim: int = 32
    hidden_size: int = 32
    coarse: bool = False
    pos_embedding_method: str = "fourier"

    def sub_specs(self) -> Dict[str, MLPSpec]:
        common = dict(dim=self.dim, c_dim=self.c_dim,
                      hidden_size=self.hidden_size)
        specs = {}
        if self.coarse:
            specs["coarse"] = MLPSpec(name="coarse", no_xyz=True, **common)
        pe = self.pos_embedding_method
        specs["middle"] = MLPSpec(name="middle", pos_embedding_method=pe, **common)
        specs["fine"] = MLPSpec(name="fine", concat_feature=True,
                                pos_embedding_method=pe, **common)
        specs["color"] = MLPSpec(name="color", color=True,
                                 pos_embedding_method=pe, **common)
        return specs


# ---------------------------------------------------------------------------
# Initialization (the same distributions as the JAX package)
# ---------------------------------------------------------------------------

def _uniform(gen, shape, bound, device):
    u = torch.rand(shape, generator=gen, device=device)
    return (2.0 * u - 1.0) * bound


def init_mlp(gen: torch.Generator, spec: MLPSpec, device) -> Params:
    """One decoder's parameters: xavier-uniform (relu gain) hidden layers
    with zero bias, torch-Linear-default fc_c, xavier-uniform head."""
    params: Params = {}
    emb = spec.embedding_size
    if not spec.no_xyz:
        params["embedder_B"] = torch.randn(
            (spec.dim, FOURIER_EMBED_SIZE), generator=gen, device=device
        ) * FOURIER_SCALE
    pts = []
    for i in range(spec.n_blocks):
        first = spec.c_dim if spec.no_xyz else emb
        in_dim = first if i == 0 else spec.hidden_size
        if i - 1 in spec.skips:
            in_dim = spec.hidden_size + first
        bound = math.sqrt(2.0) * math.sqrt(6.0 / (in_dim + spec.hidden_size))
        pts.append({"w": _uniform(gen, (in_dim, spec.hidden_size), bound, device),
                    "b": torch.zeros(spec.hidden_size, device=device)})
    params["pts_linears"] = pts
    if spec.c_dim != 0 and not spec.no_xyz:
        wb = 1.0 / math.sqrt(spec.feat_dim)
        params["fc_c"] = [
            {"w": _uniform(gen, (spec.feat_dim, spec.hidden_size), wb, device),
             "b": _uniform(gen, (spec.hidden_size,), wb, device)}
            for _ in range(spec.n_blocks)]
    bound = math.sqrt(6.0 / (spec.hidden_size + spec.out_dim))
    params["output_linear"] = {
        "w": _uniform(gen, (spec.hidden_size, spec.out_dim), bound, device),
        "b": torch.zeros(spec.out_dim, device=device)}
    return params


def init_nice(gen: torch.Generator, spec: NICESpec, device) -> Dict[str, Params]:
    return {name: init_mlp(gen, s, device) for name, s in spec.sub_specs().items()}


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def embed_points(params: Params, spec: MLPSpec, p: torch.Tensor) -> torch.Tensor:
    """Gaussian Fourier embedding sin(p @ B)."""
    if spec.pos_embedding_method != "fourier":
        raise ValueError(f"pos_embedding_method {spec.pos_embedding_method!r} "
                         "is not ported; only 'fourier'")
    return torch.sin(p @ params["embedder_B"])


def _dense(layer: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ layer["w"] + layer["b"]


def apply_mlp(params: Params, spec: MLPSpec, p: torch.Tensor,
              grids: Dict[str, torch.Tensor], bound: torch.Tensor) -> torch.Tensor:
    """One grid-conditioned decoder on (N, 3) world points -> (N,) occupancy
    or (N, 4) rgb+occ."""
    names = ["grid_" + spec.name] + (["grid_middle"] if spec.concat_feature else [])
    feats = sample_grid_features([grids[k] for k in names], p, bound)
    feat = feats[0]
    if spec.concat_feature:
        # the fine decoder sees the middle feature without a gradient path
        feat = torch.cat([feat, feats[1].detach()], dim=-1)
    embedded = embed_points(params, spec, p)
    h = embedded
    for i, layer in enumerate(params["pts_linears"]):
        h = torch.relu(_dense(layer, h)) + _dense(params["fc_c"][i], feat)
        if i in spec.skips:
            h = torch.cat([embedded, h], dim=-1)
    out = _dense(params["output_linear"], h)
    return out if spec.color else out[..., 0]


def apply_mlp_no_xyz(params: Params, spec: MLPSpec, p: torch.Tensor,
                     grids: Dict[str, torch.Tensor],
                     bound: torch.Tensor) -> torch.Tensor:
    """Coarse decoder: the grid feature (over the enlarged coarse bound) is
    the whole input."""
    feat = sample_grid_feature(grids["grid_" + spec.name], p, bound)
    h = feat
    for i, layer in enumerate(params["pts_linears"]):
        h = torch.relu(_dense(layer, h))
        if i in spec.skips:
            h = torch.cat([feat, h], dim=-1)
    out = _dense(params["output_linear"], h)
    return out if spec.color else out[..., 0]


def _pad_rows(w: torch.Tensor, rows: int) -> torch.Tensor:
    return F.pad(w, (0, 0, 0, rows - w.shape[0]))


def apply_nice_stage_batched(params: Dict[str, Params], spec: NICESpec,
                             p: torch.Tensor, grids: Dict[str, torch.Tensor],
                             bound: torch.Tensor, stage: str) -> torch.Tensor:
    """The fine/color stage as one batched chain over D = 2 or 3 decoders:
    (D, N, 128) @ (D, 128, 32) per block, inputs and weights zero-padded so
    the math equals ``apply_nice`` up to f32 summation order."""
    if stage not in ("fine", "color"):
        raise ValueError(f"batched stage must be fine or color, got {stage!r}")
    subs = spec.sub_specs()
    names = ["middle", "fine"] + (["color"] if stage == "color" else [])
    plist = [params[n] for n in names]
    hidden = spec.hidden_size
    fw = 2 * spec.c_dim  # widest feature (the fine concat)

    # one lookup Function for the stage's grids: one K2 and/or one K3 in
    # its backward; the middle feature fed to the fine decoder is detached,
    # so its cotangent reaches the points only through the middle decoder
    looked = sample_grid_features([grids["grid_" + n] for n in names], p, bound)
    mid_feat = looked[0]
    fine_feat = torch.cat([looked[1], mid_feat.detach()], dim=-1)
    feats = [F.pad(mid_feat, (0, fw - spec.c_dim)), fine_feat]
    if stage == "color":
        feats.append(F.pad(looked[2], (0, fw - spec.c_dim)))
    feat = torch.stack(feats)  # (D, N, fw)

    B = torch.stack([pp["embedder_B"] for pp in plist])  # (D, 3, 93)
    emb = torch.sin(torch.einsum("np,dpe->dne", p, B))  # (D, N, 93)

    n_blocks = len(plist[0]["pts_linears"])
    Ws = [torch.stack([_pad_rows(pp["pts_linears"][k]["w"], _BATCH_IN_WIDTH)
                       for pp in plist]) for k in range(n_blocks)]
    bs = [torch.stack([pp["pts_linears"][k]["b"] for pp in plist])
          for k in range(n_blocks)]
    Wc = [torch.stack([_pad_rows(pp["fc_c"][k]["w"], fw) for pp in plist])
          for k in range(n_blocks)]
    bc = [torch.stack([pp["fc_c"][k]["b"] for pp in plist])
          for k in range(n_blocks)]
    Wo = torch.stack([F.pad(pp["output_linear"]["w"],
                            (0, 4 - pp["output_linear"]["w"].shape[1]))
                      for pp in plist])
    bo = torch.stack([F.pad(pp["output_linear"]["b"],
                            (0, 4 - pp["output_linear"]["b"].shape[0]))
                      for pp in plist])

    emb_w = emb.shape[-1]
    x = F.pad(emb, (0, _BATCH_IN_WIDTH - emb_w))
    h = None
    for k in range(n_blocks):
        h = torch.relu(torch.bmm(x, Ws[k]) + bs[k][:, None, :])
        h = h + torch.bmm(feat, Wc[k]) + bc[k][:, None, :]
        if k in subs["middle"].skips:
            x = F.pad(torch.cat([emb, h], dim=-1),
                      (0, _BATCH_IN_WIDTH - emb_w - hidden))
        else:
            x = F.pad(h, (0, _BATCH_IN_WIDTH - hidden))
    out = torch.bmm(h, Wo) + bo[:, None, :]  # (D, N, 4)

    occ = out[0, :, 0] + out[1, :, 0]  # middle + fine residual
    if stage == "color":
        rgb = out[2, :, :3]
    else:
        rgb = torch.zeros((p.shape[0], 3), dtype=p.dtype, device=p.device)
    return torch.cat([rgb, occ[:, None]], dim=-1)


def apply_nice(params: Dict[str, Params], spec: NICESpec, p: torch.Tensor,
               grids: Dict[str, torch.Tensor], bound: torch.Tensor,
               coarse_bound: torch.Tensor, stage: str) -> torch.Tensor:
    """Stage-dispatched forward of the NICE stack -> (N, 4) raw rgb+occ."""
    subs = spec.sub_specs()
    zeros = torch.zeros((p.shape[0], 3), dtype=p.dtype, device=p.device)
    if stage == "coarse":
        occ = apply_mlp_no_xyz(params["coarse"], subs["coarse"], p, grids,
                               coarse_bound)
        return torch.cat([zeros, occ[:, None]], dim=-1)
    middle_occ = apply_mlp(params["middle"], subs["middle"], p, grids, bound)
    if stage == "middle":
        return torch.cat([zeros, middle_occ[:, None]], dim=-1)
    fine_occ = apply_mlp(params["fine"], subs["fine"], p, grids, bound)
    occ = fine_occ + middle_occ
    if stage == "fine":
        return torch.cat([zeros, occ[:, None]], dim=-1)
    if stage == "color":
        raw = apply_mlp(params["color"], subs["color"], p, grids, bound)
        return torch.cat([raw[:, :3], occ[:, None]], dim=-1)
    raise ValueError(f"unknown stage {stage}")
