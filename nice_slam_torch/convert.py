"""Move a scene state between the JAX package's layout and the port's.

Both packages keep the same parameter tree (dense layers as ``{"w": (in,
out), "b": (out,)}``) and channels-last grids, so a conversion copies leaf
for leaf: the NICE stack with its grids, or the iMAP* single MLP (a flat
tree) with an empty grid dict; or a decoder tree alone, such as the JAX
pretrainer's ``{coarse, middle, fine}`` dict (``decoders_from_jax``).  The JAX side is handed over as numpy: any
object with ``decoders``, ``grids``, ``bound`` and ``coarse_bound`` (a
``SceneState`` whose leaves are numpy arrays, or a dict with those keys).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from nice_slam_torch.models.scene import SceneState


def _get(tree: Any, name: str):
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def _to_torch(x: Any, device) -> Any:
    if isinstance(x, dict):
        return {k: _to_torch(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_torch(v, device) for v in x]
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


def _to_numpy(x: Any) -> Any:
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_numpy(v) for v in x]
    return x.detach().cpu().numpy()


def scene_from_jax(numpy_tree: Any, device="cuda") -> SceneState:
    """The port's ``SceneState`` holding the same values as a JAX scene
    state given as numpy leaves."""
    device = torch.device(device)
    return SceneState(
        decoders=_to_torch(_get(numpy_tree, "decoders"), device),
        grids=_to_torch(dict(_get(numpy_tree, "grids")), device),
        bound=_to_torch(_get(numpy_tree, "bound"), device),
        coarse_bound=_to_torch(_get(numpy_tree, "coarse_bound"), device))


def scene_to_numpy(state: SceneState) -> dict:
    """The port's state as a dict of numpy leaves (the JAX tree's layout)."""
    return {"decoders": _to_numpy(state.decoders),
            "grids": _to_numpy(state.grids),
            "bound": _to_numpy(state.bound),
            "coarse_bound": _to_numpy(state.coarse_bound)}


def decoders_from_jax(numpy_tree: Any, device="cuda") -> Any:
    """A decoder tree given as numpy leaves (the JAX pretrainer's
    ``{coarse, middle, fine}`` dict, or any one MLP) as the port's tensors."""
    return _to_torch(numpy_tree, torch.device(device))


def decoders_to_numpy(tree: Any) -> Any:
    """The port's decoder tree as numpy leaves (the JAX tree's layout)."""
    return _to_numpy(tree)
