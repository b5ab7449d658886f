"""NICE-SLAM's scene model (Zhu et al., CVPR 2022): hierarchical feature
grids read trilinearly, each level decoded by a 32-wide, 5-block MLP with
Gaussian Fourier features and feature injection after every block (the
coarse decoder reads its feature alone); occupancy is the middle level's
plus the fine level's residual, colour comes from the colour level.

Parameters are one flat dict: grids by name (``grid_middle``, ...), each
decoder's tensors under ``dec_<level>/`` in the layout of
``weights.flatten``.  The middle, fine and coarse decoders are the
published pretrained ones, read from the checkpoint files by ``load``.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from slambench.reference.core import lookup, mlp, outside_occupied

N_BLOCKS = 5


def _linear_layers(sd: Dict[str, torch.Tensor], prefix: str, out_prefix: str):
    """A torch state dict's decoder (``Linear.weight`` is (out, in)) as the
    flat (in, out) layout."""
    flat = {}
    for key, val in sd.items():
        if not key.startswith(prefix):
            continue
        name = key[len(prefix):]
        if name == "embedder._B":
            flat[out_prefix + "embedder_B"] = val
            continue
        parts = name.split(".")  # pts_linears.0.weight / output_linear.bias
        leaf = "w" if parts[-1] == "weight" else "b"
        val = val.t() if leaf == "w" else val
        flat[out_prefix + "/".join(parts[:-1] + [leaf])] = val
    return flat


def load(cfg: Dict, root: str, device) -> Dict[str, torch.Tensor]:
    """The pretrained middle, fine and coarse decoders named by the
    configuration, from their checkpoint files (``decoder.coarse_*`` of
    middle_fine.pt is the middle level, ``decoder.fine_*`` the fine)."""
    paths = cfg["config"]["pretrained_decoders"]
    out: Dict[str, torch.Tensor] = {}
    mf = torch.load(os.path.join(root, paths["middle_fine"]), map_location="cpu",
                    weights_only=False)["model"]
    out.update(_linear_layers(mf, "decoder.coarse_", "dec_middle/"))
    out.update(_linear_layers(mf, "decoder.fine_", "dec_fine/"))
    if cfg["config"]["coarse"]:
        co = torch.load(os.path.join(root, paths["coarse"]), map_location="cpu",
                        weights_only=False)["model"]
        out.update(_linear_layers(co, "decoder.", "dec_coarse/"))
    return {k: v.to(device=device, dtype=torch.float32).contiguous() for k, v in out.items()}


def raw(P: Dict[str, torch.Tensor], p: torch.Tensor, stage: str, bound: torch.Tensor,
        coarse_bound: torch.Tensor) -> torch.Tensor:
    """(N, 4) rgb + occupancy at world points for a decoder stage."""
    zeros = torch.zeros((p.shape[0], 3), dtype=p.dtype, device=p.device)
    if stage == "coarse":
        f = lookup(P["grid_coarse"], p, coarse_bound)
        occ = mlp(P, "dec_coarse/", p, None, N_BLOCKS, lead=f)[:, 0]
        return outside_occupied(torch.cat([zeros, occ[:, None]], -1), p, bound)
    fm = lookup(P["grid_middle"], p, bound)
    occ = mlp(P, "dec_middle/", p, fm, N_BLOCKS)[:, 0]
    rgb = zeros
    if stage in ("fine", "color"):
        ff = lookup(P["grid_fine"], p, bound)
        # the fine decoder reads the middle feature without a gradient
        occ = occ + mlp(P, "dec_fine/", p, torch.cat([ff, fm.detach()], -1), N_BLOCKS)[:, 0]
    if stage == "color":
        fc = lookup(P["grid_color"], p, bound)
        rgb = mlp(P, "dec_color/", p, fc, N_BLOCKS)[:, :3]
    return outside_occupied(torch.cat([rgb, occ[:, None]], -1), p, bound)
