"""Checkpoints: counterpart of the JAX package's ``utils/logger.py``.

``Logger.log`` writes ``{output}/ckpts/{idx:05d}.tar`` with ``torch.save``
and the reference's keys (``c``, ``decoder_state_dict``, ``gt_c2w_list``,
``estimate_c2w_list``, ``keyframe_list``, ``selected_keyframes``,
``idx``) plus ``bound``, every tensor on the CPU: grids in the
reference's ``[1, C, Z, Y, X]`` layout, decoder parameters under torch
state-dict names with weights as (out, in) (``{name}_decoder.`` prefixes
for the NICE stack; the iMAP* MLP's names have no prefix and it has no
grids).  The port's parameter tree is
the JAX package's (dense layers ``{"w": (in, out), "b"}``, channels-last
grids), so a checkpoint from either package loads in the other.
``load_checkpoint`` restores a runnable ``SceneState`` on the caller's
device.  A spatially sharded state is written dense (each grid's slabs
joined once at this boundary), so its checkpoint is the same file.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from nice_slam_torch.models.scene import SceneSpec, SceneState
from nice_slam_torch.parallel.grid_sharding import dense_grids


def grid_to_torch_layout(grid: torch.Tensor) -> torch.Tensor:
    """(Nx, Ny, Nz, C) -> a CPU [1, C, Nz, Ny, Nx] tensor."""
    return grid.detach().cpu().permute(3, 2, 1, 0).contiguous()[None]


def grid_from_torch_layout(t) -> torch.Tensor:
    """[1, C, Nz, Ny, Nx] (or [C, Nz, Ny, Nx]) -> (Nx, Ny, Nz, C)."""
    t = torch.as_tensor(t)
    if t.dim() == 5:
        t = t[0]
    return t.permute(3, 2, 1, 0).contiguous()


def _cpu(x) -> torch.Tensor:
    return x.detach().cpu().clone()


def _mlp_to_state_dict(params: Dict[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    """MLP parameters -> torch state-dict entries (weights (out, in))."""
    sd: Dict[str, torch.Tensor] = {}
    if "embedder_B" in params:
        sd[prefix + "embedder._B"] = _cpu(params["embedder_B"])
    if "embedder_w" in params:
        sd[prefix + "embedder.weight"] = _cpu(params["embedder_w"]).T
        sd[prefix + "embedder.bias"] = _cpu(params["embedder_b"])
    for key in ("pts_linears", "fc_c"):
        for i, layer in enumerate(params.get(key, [])):
            sd[f"{prefix}{key}.{i}.weight"] = _cpu(layer["w"]).T.contiguous()
            sd[f"{prefix}{key}.{i}.bias"] = _cpu(layer["b"])
    sd[prefix + "output_linear.weight"] = _cpu(params["output_linear"]["w"]).T.contiguous()
    sd[prefix + "output_linear.bias"] = _cpu(params["output_linear"]["b"])
    return sd


def _mlp_from_state_dict(sd: Dict[str, Any], prefix: str,
                         template: Dict[str, Any], device) -> Dict[str, Any]:
    """Torch state-dict entries -> MLP parameters shaped like ``template``."""
    out = dict(template)

    def g(name):
        return torch.as_tensor(sd[prefix + name], dtype=torch.float32).to(device)

    if "embedder_B" in template:
        out["embedder_B"] = g("embedder._B")
    if "embedder_w" in template:
        out["embedder_w"] = g("embedder.weight").T.contiguous()
        out["embedder_b"] = g("embedder.bias")
    for key in ("pts_linears", "fc_c"):
        if key in template:
            out[key] = [{"w": g(f"{key}.{i}.weight").T.contiguous(),
                         "b": g(f"{key}.{i}.bias")}
                        for i in range(len(template[key]))]
    out["output_linear"] = {"w": g("output_linear.weight").T.contiguous(),
                            "b": g("output_linear.bias")}
    return out


def decoders_to_state_dict(spec: SceneSpec, decoders) -> Dict[str, torch.Tensor]:
    """The decoders' parameters as one torch state dict (NICE:
    ``{name}_decoder.`` prefixes; iMAP*: the one MLP, no prefix)."""
    if not spec.nice:
        return _mlp_to_state_dict(decoders, "")
    sd: Dict[str, torch.Tensor] = {}
    for name, params in decoders.items():
        sd.update(_mlp_to_state_dict(params, f"{name}_decoder."))
    return sd


def decoders_from_state_dict(spec: SceneSpec, sd, template, device="cpu"):
    """Decoder parameters from a state dict, shaped like ``template``."""
    if not spec.nice:
        return _mlp_from_state_dict(sd, "", template, device)
    return {name: _mlp_from_state_dict(sd, f"{name}_decoder.", params, device)
            for name, params in template.items()}


class Logger:
    """Writes reference-compatible checkpoint ``.tar`` files."""

    def __init__(self, output: str, spec: SceneSpec, verbose: bool = True):
        self.ckptsdir = os.path.join(output, "ckpts")
        os.makedirs(self.ckptsdir, exist_ok=True)
        self.spec = spec
        self.verbose = verbose

    def log(self, idx: int, state: SceneState, estimate_c2w_list,
            gt_c2w_list, keyframe_list, selected_keyframes=None) -> str:
        path = os.path.join(self.ckptsdir, f"{idx:05d}.tar")
        payload = {
            "c": {name: grid_to_torch_layout(g)
                  for name, g in dense_grids(state.grids).items()},
            "decoder_state_dict": decoders_to_state_dict(self.spec, state.decoders),
            "gt_c2w_list": _as_cpu(gt_c2w_list),
            "estimate_c2w_list": _as_cpu(estimate_c2w_list),
            "keyframe_list": list(keyframe_list),
            "selected_keyframes": selected_keyframes,
            "idx": idx,
            "bound": _as_cpu(state.bound),
        }
        torch.save(payload, path)
        if self.verbose:
            print(f"Saved checkpoints at {path}")
        return path


def _as_cpu(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return _cpu(x)
    return torch.from_numpy(np.array(x, dtype=np.float32))


def load_checkpoint(path: str, spec: SceneSpec, template_state: SceneState,
                    device=None) -> Tuple[SceneState, np.ndarray, np.ndarray, list, int]:
    """(SceneState on ``device`` (default: the template's), estimate_c2w_list,
    gt_c2w_list, keyframe_list, idx) from a checkpoint of either package."""
    if device is None:
        device = template_state.bound.device
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    grids = {name: grid_from_torch_layout(t).to(device=device, dtype=torch.float32)
             for name, t in ckpt["c"].items()}
    decoders = decoders_from_state_dict(spec, ckpt["decoder_state_dict"],
                                        template_state.decoders, device)
    state = template_state._replace(
        decoders=decoders, grids=grids,
        bound=template_state.bound.to(device),
        coarse_bound=template_state.coarse_bound.to(device))
    est = np.asarray(ckpt["estimate_c2w_list"], dtype=np.float32)
    gt = np.asarray(ckpt["gt_c2w_list"], dtype=np.float32)
    return state, est, gt, list(ckpt["keyframe_list"]), int(ckpt["idx"])
