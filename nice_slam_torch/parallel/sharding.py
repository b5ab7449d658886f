"""Ray-batch and lattice data parallelism over a list of devices:
counterpart of the JAX package's ``parallel/sharding.py``.

The JAX package shards the ray batch over a 1-D ``dp`` mesh and keeps the
scene replicated; XLA inserts the gradient ``psum``.  The port drives the
same split from one process: the batch is cut into D contiguous blocks,
as ``P("dp")`` cuts it, each block renders on its device against a
replica of the scene made with differentiable ``.to(device)`` copies, and
the D partial losses are summed on the first device.  One ``backward``
then reaches every device (autograd runs each device's share on that
device) and sums the replicas' gradients into the one set of leaves: the
psum.  Quantities the whole batch shares (the largest sensor depth, which
bounds every ray's far plane) are computed before the split, so each ray
renders as in the whole batch.

A device list may repeat one device: ``.to(device)`` then returns the
tensor itself, the replicas are one, and their gradients accumulate in
place, which is the same sum.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch

from nice_slam_torch.models.scene import SceneSpec, SceneState
from nice_slam_torch.ops.geometry import ray_aabb_far
from nice_slam_torch.ops.render import RenderConfig, render_batch_ray

Devices = Sequence[torch.device]


def make_mesh(devices: Optional[Sequence] = None) -> List[torch.device]:
    """The 1-D data-parallel device list: ``devices`` as torch devices, by
    default every visible CUDA device."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("no CUDA device is visible: pass the devices")
        devices = [torch.device("cuda", i) for i in range(n)]
    return [torch.device(d) for d in devices]


def _to(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def replicate_state(state: SceneState, device) -> SceneState:
    """The scene on ``device`` through differentiable copies (the tensors
    themselves where they already live there)."""
    return state._replace(decoders=_to(state.decoders, device),
                          grids=_to(state.grids, device),
                          bound=state.bound.to(device),
                          coarse_bound=state.coarse_bound.to(device))


def data_parallel(devices: Devices, n: int) -> bool:
    """Whether a batch of ``n`` rows splits over ``devices``: two or more of
    them and ``n`` a multiple of their count (as the JAX mapper's
    ``rays.shape[0] % mesh.size == 0``)."""
    return devices is not None and len(devices) > 1 and n % len(devices) == 0


def over_blocks(devices: Devices, fn: Callable, state: SceneState,
                *arrays: torch.Tensor) -> List:
    """``fn(replica, *blocks)`` on each device: the arrays cut into
    len(devices) contiguous row blocks, block d on device d with a replica
    of ``state`` there.  Returns the D results, in device order, where
    ``fn`` left them."""
    D = len(devices)
    b = arrays[0].shape[0] // D
    return [fn(replicate_state(state, dev), *(a[d * b:(d + 1) * b].to(dev)
                                              for a in arrays))
            for d, dev in enumerate(devices)]


def sum_on(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The parts summed on ``device``, in order."""
    out = parts[0].to(device)
    for x in parts[1:]:
        out = out + x.to(device)
    return out


def sharded_ray_loss(spec: SceneSpec, state: SceneState, rays_o: torch.Tensor,
                     rays_d: torch.Tensor, gt_depth: torch.Tensor,
                     gt_color: torch.Tensor, stage: str, rcfg: RenderConfig,
                     w_color_loss: float,
                     devices: Optional[Devices] = None) -> torch.Tensor:
    """The mapping loss (masked depth L1, plus the weighted color L1 at the
    color stage) over a ray batch, the rays split over ``devices`` when
    they divide evenly, summed on the first device."""
    t_exit = ray_aabb_far(rays_o, rays_d, state.bound).detach()
    inside = t_exit >= gt_depth
    depth_max = torch.max(gt_depth)

    def block_loss(st, ro, rd, gd, gc, ins):
        depth, _, color = render_batch_ray(spec, st, ro, rd, stage, gt_depth=gd,
                                           rcfg=rcfg, depth_max=depth_max.to(ro.device))
        ddiff = torch.abs(gd - depth)
        loss = torch.sum(torch.where((gd > 0) & ins, ddiff, torch.zeros_like(ddiff)))
        if stage == "color":
            cdiff = torch.abs(gc - color)
            loss = loss + w_color_loss * torch.sum(
                torch.where(ins[:, None], cdiff, torch.zeros_like(cdiff)))
        return loss

    arrays = (rays_o, rays_d, gt_depth, gt_color, inside)
    if not data_parallel(devices, rays_o.shape[0]):
        return block_loss(state, *arrays)
    return sum_on(over_blocks(devices, block_loss, state, *arrays), devices[0])


def make_sharded_map_step(devices: Devices, spec: SceneSpec, stage: str,
                          rcfg: RenderConfig, lr: float = 0.01,
                          w_color_loss: float = 0.2):
    """A data-parallel mapping train step: rays split over ``devices``, the
    scene and the optimizer on the first device.  Returns (step_fn,
    shard_batch_fn, replicate_fn, init_adam):

        step_fn(state, adam, rays_o, rays_d, gt_d, gt_c) -> (state, adam, loss)
        shard_batch_fn(*arrays) -> the arrays as float32 tensors on the
            first device (the loss splits them)
        replicate_fn(state) -> the state on the first device
        init_adam(state) -> a group Adam that owns trainable copies of the
            trained groups and updates them in place at every step
    """
    from nice_slam_torch.slam.optim import GroupAdam, tree_leaves, tree_map

    devices = make_mesh(devices)
    main = devices[0]

    def trainable(state: SceneState):
        if spec.nice:
            return {"grid_middle": state.grids["grid_middle"],
                    "grid_fine": state.grids["grid_fine"],
                    "grid_color": state.grids["grid_color"],
                    "dec_color": state.decoders["color"]}
        return {"dec": state.decoders}

    def merge(state: SceneState, groups) -> SceneState:
        if not spec.nice:
            return state._replace(decoders=groups["dec"])
        grids = dict(state.grids)
        for k in ("grid_middle", "grid_fine", "grid_color"):
            grids[k] = groups[k]
        return state._replace(grids=grids,
                              decoders=dict(state.decoders, color=groups["dec_color"]))

    def init_adam(state: SceneState) -> GroupAdam:
        groups = {k: tree_map(lambda t: t.detach().clone().requires_grad_(True), v)
                  for k, v in trainable(state).items()}
        adam = GroupAdam(groups)
        adam.trees = groups
        return adam

    def step(state, adam, rays_o, rays_d, gt_d, gt_c):
        groups = adam.trees
        loss = sharded_ray_loss(spec, merge(state, groups), rays_o, rays_d, gt_d,
                                gt_c, stage, rcfg, w_color_loss, devices)
        names = sorted(groups)
        leaves = [x for k in names for x in tree_leaves(groups[k])]
        flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads, pos = {}, 0
        for k in names:
            n = len(adam.params[k])
            grads[k] = list(flat[pos:pos + n])
            pos += n
        adam.step(grads, {k: lr for k in groups}, {k: True for k in groups})
        detached = {k: tree_map(lambda t: t.detach(), v) for k, v in groups.items()}
        return merge(state, detached), adam, loss.detach()

    def shard_batch(*arrays):
        return tuple(torch.as_tensor(a, dtype=torch.float32, device=main)
                     for a in arrays)

    def replicate(state: SceneState) -> SceneState:
        return replicate_state(state, main)

    return step, shard_batch, replicate, init_adam
