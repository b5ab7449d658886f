"""Group Adam with torch param-group semantics: counterpart of
the JAX package's ``slam/optim.py``.

Named groups, each a tree of tensors, each with its own step count.  A
group takes a step only when it is active in the stage, so inactive
groups keep their values, moments and counts; an active group with lr 0
still advances its moments and count, as torch does.  The mapper makes a
fresh optimizer for every ``optimize_map`` call.  Updates are in place.
On the card a step is one launch of K9 ``group_adam`` (``csrc/adam.cu``)
per device the leaves lie on, over every active group's leaves there (a
spatially sharded grid's slabs may lie on several devices; the bias
correction is still the group's own), with the mapper's frustum masks
applied to the grid gradients inside it.  Its plain version, the CPU
path, is ``_adam_update``: ``torch._foreach`` ops per group and device.
A ``ShardedGrid`` is a tree whose leaves are its slabs.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from nice_slam_torch.ops import kernels
from nice_slam_torch.parallel.grid_sharding import ShardedGrid

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8

# launches per kernel (see ``kernels.LaunchCounter``)
_launches = kernels.LaunchCounter(("group_adam",))
launch_counts = _launches.counts
launches_by_stream = _launches.by_stream
launches_by_device = _launches.by_device
reset_launch_counts = _launches.reset


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
             lrs: Dict[str, Any], active: Dict[str, bool],
             masks: Optional[Dict[str, List[Optional[torch.Tensor]]]] = None
             ) -> None:
        """One update of every active group.  ``grads[name]`` lists the
        leaves' gradients (None = no gradient = zero); ``lrs[name]`` is a
        float, or a tensor over each leaf's last dimension (or of one
        element); ``masks[name]``, where given, lists a gradient mask per
        leaf (None: none), one float per node of a grid (nx, ny, nz, 1),
        broadcast over its channels.  On the card one K9 launch per device
        updates every active leaf on it."""
        masks = masks or {}
        by_device: Dict[torch.device, List] = {}
        for name, ps in self.params.items():
            if not active.get(name, False):
                continue
            self.steps[name] += 1
            t = self.steps[name]
            # bias corrections in float32, as the JAX package computes them
            bc1 = float(np.float32(1) - np.float32(ADAM_B1) ** np.float32(t))
            bc2 = float(np.float32(1) - np.float32(ADAM_B2) ** np.float32(t))
            ms = masks.get(name) or [None] * len(ps)
            for leaf in zip(ps, grads[name], self.mu[name], self.nu[name], ms):
                by_device.setdefault(leaf[0].device, []).append(
                    (*leaf, bc1, bc2, lrs[name]))
        for dev, leaves in by_device.items():
            (group_adam if dev.type == "cuda" else group_adam_plain)(leaves)


def group_adam_plain(leaves) -> None:
    """K9's plain version, on the leaves K9 takes ((p, g, m, v, mask, bc1,
    bc2, lr), one device): each mask multiplied into its gradient, then one
    ``_adam_update`` per run of leaves that share their bias corrections
    and lr (a group's leaves)."""
    runs: List[List] = []
    for leaf in leaves:
        if runs and runs[-1][-1][5:7] == leaf[5:7] and runs[-1][-1][7] is leaf[7]:
            runs[-1].append(leaf)
        else:
            runs.append([leaf])
    for run in runs:
        gs = []
        for p, g, _, _, mask, *_ in run:
            g = torch.zeros_like(p) if g is None else g
            gs.append(g if mask is None else g * mask)
        _adam_update([x[0] for x in run], gs, [x[2] for x in run], [x[3] for x in run],
                     *run[0][5:])


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


# ---------------------------------------------------------------------------
# K9 (nice_slam_torch/csrc/adam.cu)
# ---------------------------------------------------------------------------

DESC = 12  # int64 values per leaf (kDesc in adam.cu)


def _bits(x: float) -> int:
    return int(np.float32(x).view(np.int32))


def _check_leaf(name: str, t: torch.Tensor, dev: torch.device) -> None:
    if t.device != dev:
        raise ValueError(f"{name} must lie on {dev}, not {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def group_adam(leaves) -> None:
    """K9: one Adam step of (p, g, m, v, mask, bc1, bc2, lr) leaves, all on
    one CUDA device, in one launch on its current stream; p, m and v are
    updated in place.  A None gradient reads as zero; a mask holds one
    float per ``p.numel() // mask.numel()`` consecutive elements; lr is a
    float, or a tensor of one element or of p's last dimension."""
    dev = leaves[0][0].device
    lib = kernels.library("adam")
    if len(leaves) > lib.group_adam_capacity():
        raise ValueError(f"one K9 launch takes at most {lib.group_adam_capacity()} "
                         f"leaves, got {len(leaves)}")
    desc: List[int] = []
    keep = []  # the lr vectors moved to this device, alive past the launch
    for p, g, m, v, mask, bc1, bc2, lr in leaves:
        n = p.numel()
        for what, t in (("param", p), ("exp_avg", m), ("exp_avg_sq", v)):
            _check_leaf(what, t, dev)
            if t.shape != p.shape:
                raise ValueError(f"{what} must be {tuple(p.shape)}, got {tuple(t.shape)}")
        if g is not None:
            _check_leaf("grad", g, dev)
            if g.shape != p.shape:
                raise ValueError(f"grad must be {tuple(p.shape)}, got {tuple(g.shape)}")
        inner = 1
        if mask is not None:
            _check_leaf("mask", mask, dev)
            if not mask.numel() or n % mask.numel():
                raise ValueError(f"a mask of {mask.numel()} for {n} elements")
            inner = n // mask.numel()
        lr_ptr, lr_len, lr_val = 0, 1, 0.0
        if isinstance(lr, torch.Tensor):
            lr = lr.to(dev, torch.float32).contiguous()
            if lr.numel() not in (1, p.shape[-1] if p.dim() else 1):
                raise ValueError(f"an lr of {lr.numel()} for a leaf {tuple(p.shape)}")
            keep.append(lr)
            lr_ptr, lr_len = lr.data_ptr(), lr.numel()
        else:
            lr_val = float(lr)
        if not n:
            continue
        desc += [p.data_ptr(), 0 if g is None else g.data_ptr(), m.data_ptr(),
                 v.data_ptr(), 0 if mask is None else mask.data_ptr(), lr_ptr, n,
                 inner, lr_len, _bits(bc1), _bits(bc2), _bits(lr_val)]
    if not desc:
        return
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.group_adam((ctypes.c_longlong * len(desc))(*desc), len(desc) // DESC,
                            stream)
        kernels.check(rc, "group_adam")
    _launches.count("group_adam", stream, dev.index)


def group_adam_kernel_info(device: torch.device) -> Dict[str, int]:
    """K9's compiled resources: registers, local (spill) bytes, threads."""
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        rc = kernels.library("adam").group_adam_info(out)
    kernels.check(rc, "group_adam_info")
    return dict(zip(("registers", "local_bytes", "threads"), out))
