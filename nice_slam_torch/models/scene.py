"""Scene representation: counterpart of the JAX package's ``models/scene.py``.

``SceneState`` holds the decoder parameter tree, the feature grids and the
bounds as tensors on one device.  The mapper returns a new state whose
trained tensors are fresh copies, so a state another caller still holds
(the tracker's snapshot of the map) is never changed under it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Union

import numpy as np
import torch

from nice_slam_torch.models import decoders as D
from nice_slam_torch.models import grids as G


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    """Static description of the scene representation."""

    nice: bool
    decoder: Union[D.NICESpec, D.MLPSpec]  # the MLPSpec is iMAP*'s
    grid_shapes: tuple  # ((name, (nx, ny, nz)), ...); empty for iMAP*
    c_dim: int
    occupancy: bool
    coarse: bool
    coarse_bound_enlarge: float


class SceneState(NamedTuple):
    decoders: Any                   # nested dict of decoder tensors
    grids: Dict[str, torch.Tensor]  # channels-last feature volumes (none: iMAP*)
    bound: torch.Tensor             # (3, 2)
    coarse_bound: torch.Tensor      # (3, 2) = bound * coarse_bound_enlarge


def build_scene(cfg: Dict[str, Any], nice: bool = True, seed: int = 0,
                device="cuda"):
    """(SceneSpec, SceneState) from a parsed config, on ``device``: the NICE
    grids and decoder stack, or (``nice=False``) the iMAP* single MLP with
    no grids.  The iMAP* MLP is drawn on the CPU from ``seed`` and then
    moved, so one seed gives one MLP on every device: the draw decides
    whether the map trains at all (an MLP whose initial density is
    negative almost everywhere never does, its ReLU passing no depth
    gradient), and the CPU tests hold the MLP the card runs."""
    device = torch.device(device)
    bound = G.round_bound(np.asarray(cfg["mapping"]["bound"]),
                          cfg["grid_len"]["bound_divisible"], cfg["scale"])
    enlarge = cfg["model"]["coarse_bound_enlarge"]
    coarse = bool(cfg["coarse"]) and nice
    c_dim = cfg["model"]["c_dim"]
    pe = cfg["model"]["pos_embedding_method"]
    if nice:
        dec_spec = D.NICESpec(dim=cfg["data"]["dim"], c_dim=c_dim,
                              hidden_size=32, coarse=coarse,
                              pos_embedding_method=pe)
        gen = G.make_generator(seed, device)
        dec_params = D.init_nice(gen, dec_spec, device)
        shapes = G.grid_shapes(bound, cfg["grid_len"], coarse, enlarge)
        grids = G.init_grids(gen, shapes, c_dim, device)
    else:
        dec_spec = D.imap_spec(cfg["data"]["dim"], pe)
        gen = G.make_generator(seed, torch.device("cpu"))
        dec_params = _to_device(D.init_mlp(gen, dec_spec, "cpu"), device)
        shapes, grids = {}, {}
    spec = SceneSpec(nice=nice, decoder=dec_spec,
                     grid_shapes=tuple(sorted(shapes.items())), c_dim=c_dim,
                     occupancy=bool(cfg["occupancy"]), coarse=coarse,
                     coarse_bound_enlarge=enlarge)
    state = SceneState(
        decoders=dec_params, grids=grids,
        bound=torch.as_tensor(bound, dtype=torch.float32, device=device),
        coarse_bound=torch.as_tensor(bound * enlarge, dtype=torch.float32,
                                     device=device))
    return spec, state


def _to_device(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def eval_points(spec: SceneSpec, state: SceneState, p: torch.Tensor,
                stage: str = "color", batched: bool = True) -> torch.Tensor:
    """Decode (N, 3) world points -> (N, 4) raw rgb+occ (rgb+density for
    iMAP*, whatever the stage).  Points outside the scene bound get
    occupancy 100, an occupied sentinel that ends rays at the box."""
    if not spec.nice:
        raw = D.apply_imap(state.decoders, spec.decoder, p)
    elif batched and stage in ("fine", "color"):
        raw = D.apply_nice_stage_batched(state.decoders, spec.decoder, p,
                                         state.grids, state.bound, stage)
    else:
        raw = D.apply_nice(state.decoders, spec.decoder, p, state.grids,
                           state.bound, state.coarse_bound, stage)
    lo, hi = state.bound[:, 0], state.bound[:, 1]
    inside = torch.all((p > lo) & (p < hi), dim=-1)
    occ = torch.where(inside, raw[:, 3], torch.full_like(raw[:, 3], 100.0))
    return torch.cat([raw[:, :3], occ[:, None]], dim=-1)
