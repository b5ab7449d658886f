"""The weights a run makes from its seed, and the parameter-tree layout
both sides read.

A decoder is a tree: ``{"embedder_B": (3, 93), "pts_linears": [{"w": (in,
out), "b": (out,)}, ...], "fc_c": [...], "output_linear": {...}}``;
``flatten`` names its leaves by path (``pts_linears/0/w``), in the order
of sorted dict keys and list positions.

Drawn on the device from one ``torch.Generator`` seeded by the run's seed,
in the configuration's distributions (``init`` in its file): each grid
N(0, std), in sorted name order; an MLP's hidden layers Xavier-uniform
with the ReLU gain and zero bias, its feature injections uniform in
+-1/sqrt(fan_in), its head Xavier-uniform with zero bias, its Fourier
matrix N(0, 1) x 25.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

FOURIER = (93, 25.0)  # embedding width, scale


def flatten(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) pairs of a nested dict/list tree."""
    if isinstance(tree, torch.Tensor):
        return [(prefix.rstrip("/"), tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in flatten(v, f"{prefix}{i}/")]
    raise TypeError(f"unexpected leaf {type(tree)}")


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _uniform(gen, shape, bound, device):
    return (2.0 * torch.rand(shape, generator=gen, device=device) - 1.0) * bound


def mlp_tree(gen, hidden: int, n_blocks: int, skips, c_dim: int, out: int, device
             ) -> Dict[str, Any]:
    """One point decoder's tree (Fourier lead; ``c_dim`` 0: no feature)."""
    emb = FOURIER[0]
    tree: Dict[str, Any] = {
        "embedder_B": torch.randn((3, emb), generator=gen, device=device) * FOURIER[1]}
    pts = []
    for i in range(n_blocks):
        fan_in = emb if i == 0 else hidden + (emb if i - 1 in skips else 0)
        bound = math.sqrt(2.0) * math.sqrt(6.0 / (fan_in + hidden))
        pts.append({"w": _uniform(gen, (fan_in, hidden), bound, device),
                    "b": torch.zeros(hidden, device=device)})
    tree["pts_linears"] = pts
    if c_dim:
        wb = 1.0 / math.sqrt(c_dim)
        tree["fc_c"] = [{"w": _uniform(gen, (c_dim, hidden), wb, device),
                         "b": _uniform(gen, (hidden,), wb, device)} for _ in range(n_blocks)]
    bound = math.sqrt(6.0 / (hidden + out))
    tree["output_linear"] = {"w": _uniform(gen, (hidden, out), bound, device),
                             "b": torch.zeros(out, device=device)}
    return tree


def make(conf: Dict, shapes: Dict[str, Tuple[int, int, int]], seed: int, device
         ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """(grids, decoder trees drawn from the seed) for a configuration
    file ``conf``: the grids of ``shapes`` and the decoders its ``init``
    names (NICE: the colour decoder; iMAP*: the whole MLP)."""
    init = conf["init"]
    gen = generator(seed, device)
    c = conf["config"]["model"]["c_dim"]
    grids = {name: torch.randn((*shp, c), generator=gen, device=device) * init["grid_std"][name]
             for name, shp in sorted(shapes.items())}
    decs = {name: mlp_tree(gen, d["hidden"], d["n_blocks"], tuple(d["skips"]), d["c_dim"],
                           d["out"], device)
            for name, d in sorted(init["decoders"].items())}
    return grids, decs
