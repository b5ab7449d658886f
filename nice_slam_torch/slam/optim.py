"""Group Adam with torch param-group semantics: counterpart of
the JAX package's ``slam/optim.py``.

Named groups, each a tree of tensors, each with its own step count.  A
group takes a step only when it is active in the stage, so inactive
groups keep their values, moments and counts; an active group with lr 0
still advances its moments and count, as torch does.  The mapper makes a
fresh optimizer for every ``optimize_map`` call.  Updates are in place,
with ``torch._foreach`` ops over a group's leaves, one call per device
the leaves lie on (a spatially sharded grid's slabs may lie on several;
the bias correction is still the group's own).  A ``ShardedGrid`` is a
tree whose leaves are its slabs.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from nice_slam_torch.parallel.grid_sharding import ShardedGrid

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves of a nested dict/list tree, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, ShardedGrid):
        return list(tree.slabs)
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    raise TypeError(f"unexpected leaf type {type(tree)}")


def tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, ShardedGrid):
        return tree._replace([fn(s) for s in tree.slabs])
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    raise TypeError(f"unexpected leaf type {type(tree)}")


class GroupAdam:
    """Adam over named parameter groups (trees of leaf tensors)."""

    def __init__(self, groups: Dict[str, Any]):
        self.params = {k: tree_leaves(v) for k, v in groups.items()}
        self.mu = {k: [torch.zeros_like(p) for p in v]
                   for k, v in self.params.items()}
        self.nu = {k: [torch.zeros_like(p) for p in v]
                   for k, v in self.params.items()}
        self.steps = {k: 0 for k in groups}

    @torch.no_grad()
    def step(self, grads: Dict[str, List[Optional[torch.Tensor]]],
             lrs: Dict[str, Any], active: Dict[str, bool]) -> None:
        """One update of every active group.  ``grads[name]`` lists the
        leaves' gradients (None = no gradient = zero); ``lrs[name]`` is a
        float, or a tensor broadcast against each leaf."""
        for name, ps in self.params.items():
            if not active.get(name, False):
                continue
            gs = [torch.zeros_like(p) if g is None else g
                  for p, g in zip(ps, grads[name])]
            self.steps[name] += 1
            t = self.steps[name]
            # bias corrections in float32, as the JAX package computes them
            bc1 = float(np.float32(1) - np.float32(ADAM_B1) ** np.float32(t))
            bc2 = float(np.float32(1) - np.float32(ADAM_B2) ** np.float32(t))
            by_device: Dict[torch.device, List[int]] = {}
            for i, p in enumerate(ps):
                by_device.setdefault(p.device, []).append(i)
            for idx in by_device.values():
                pick = lambda xs: [xs[i] for i in idx]  # noqa: E731
                _adam_update(pick(ps), pick(gs), pick(self.mu[name]),
                             pick(self.nu[name]), bc1, bc2, lrs[name])


def _adam_update(ps, gs, m, v, bc1: float, bc2: float, lr) -> None:
    """One Adam update of leaves that lie on one device."""
    torch._foreach_mul_(m, ADAM_B1)
    torch._foreach_add_(m, gs, alpha=1.0 - ADAM_B1)
    torch._foreach_mul_(v, ADAM_B2)
    torch._foreach_addcmul_(v, gs, gs, value=1.0 - ADAM_B2)
    denom = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, ADAM_EPS)
    upd = torch._foreach_div(m, bc1)
    torch._foreach_div_(upd, denom)
    if isinstance(lr, torch.Tensor):
        for p, u in zip(ps, upd):
            p.sub_(u * lr.to(p.device))
    else:
        torch._foreach_add_(ps, upd, alpha=-float(lr))
