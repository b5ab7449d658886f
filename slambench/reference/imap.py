"""iMAP* (NICE-SLAM's re-implementation of iMAP, Sucar et al., ICCV 2021):
one MLP of 4 blocks of 256 on 93 Gaussian Fourier features, no grids,
rgb + volume density out.  Parameters are a flat dict under ``dec/`` in
the layout of ``weights.flatten``."""

from __future__ import annotations

from typing import Dict

import torch

from slambench.reference.core import mlp, outside_occupied

N_BLOCKS = 4


def load(cfg: Dict, root: str, device) -> Dict[str, torch.Tensor]:
    """No pretrained part: the whole MLP is drawn from the seed."""
    return {}


def raw(P: Dict[str, torch.Tensor], p: torch.Tensor, stage: str, bound: torch.Tensor,
        coarse_bound: torch.Tensor) -> torch.Tensor:
    return outside_occupied(mlp(P, "dec/", p, None, N_BLOCKS, skips=()), p, bound)
