"""Spatially sharded feature-grid store: counterpart of the JAX package's
``parallel/grid_sharding.py``, for scenes whose grids outgrow one card.

Each grid is cut into x-axis SLABS, one per device of a list, with a
one-plane halo, so

  * every device stores ``1/D`` of each grid (+ one x-plane),
  * any world-space query is answered by exactly ONE device (the owner of
    its cell's base x-plane; the +1 corner lives in the halo), and
  * the D answers, summed on the first device, are the full (N, C)
    feature batch (the JAX package's ``psum``); the decoders then run
    there on that small activation.

One process drives every device, as one JAX controller does: a lookup
sends the points to each slab's device and launches one kernel there
(``ops/interp.py``: K1-K3 with a slab ``Window``), and autograd carries
the backward to each device through the differentiable ``.to(device)``
copies.  A device list may repeat one device (``[cuda:0] * D`` runs every
slab path on one card; ``[cpu] * D`` runs it on the CPU).

Exactness: a slab computes the corners and weights on the full grid and
shifts only the integer x indices, each point's 8-corner sum is computed
entirely on its owner, and every other slab answers exactly 0, so the
sharded lookup equals the dense one bit for bit.

The duplicated planes: global x-plane ``d * planes`` is slab d's plane 0
and slab d-1's halo.  ``fold_halo_grads`` writes the total of the two
partial gradients into both copies, and the frustum masks slice the same
way (``mask_to_slabs``), so an elementwise optimizer keeps the two copies
bitwise equal and no halo refresh is ever needed.

The knobs (``spatial_sharding_mesh``): ``NICE_SLAM_TORCH_SPATIAL`` =
``auto`` (default: engage when two or more devices are in use and the
dense grids exceed ``NICE_SLAM_TORCH_HBM_BUDGET_GB``, default 4.0), ``1``
(force on; fewer than two devices then raises) or ``0`` (off).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from nice_slam_torch.ops.interp import Window, trilinear_interp_multi

Devices = Sequence[torch.device]


class ShardedGrid:
    """One grid as x-slabs: ``slabs[d]`` (on its own device) holds global
    x-planes ``[d * planes, d * planes + planes]`` (inclusive halo),
    edge-padded past ``nx - 1``.  ``shape`` is the dense (nx, ny, nz, C)."""

    def __init__(self, slabs: Sequence[torch.Tensor],
                 shape: Tuple[int, int, int, int], planes: int):
        self.slabs = list(slabs)        # D x (planes + 1, ny, nz, C)
        self.shape = tuple(shape)       # the dense (nx, ny, nz, C)
        self.planes = int(planes)       # owned x-planes per device

    @property
    def D(self) -> int:
        return len(self.slabs)

    @property
    def devices(self) -> List[torch.device]:
        return [s.device for s in self.slabs]

    def window(self, d: int) -> Window:
        """Slab d's window for the kernels."""
        return Window(self.shape[0], d * self.planes, self.planes, self.D)

    def _replace(self, slabs: Sequence[torch.Tensor]) -> "ShardedGrid":
        return ShardedGrid(slabs, self.shape, self.planes)

    def __repr__(self) -> str:
        return (f"ShardedGrid(shape={self.shape}, planes={self.planes}, "
                f"devices={[str(d) for d in self.devices]})")


def _planes(nx: int, D: int) -> int:
    return max(1, -(-(nx - 1) // D))  # ceil; >= 1 plane per device


def _edge_pad(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t`` with its last x-plane repeated up to ``rows`` x-planes."""
    pad = rows - t.shape[0]
    if pad <= 0:
        return t
    return torch.cat([t, t[-1:].expand(pad, *t.shape[1:])], dim=0)


def shard_grid(grid: torch.Tensor, devices: Devices) -> ShardedGrid:
    """Slice a dense (nx, ny, nz, C) grid into one x-slab per device (each
    slab its own copy, also where devices repeat)."""
    nx = grid.shape[0]
    D = len(devices)
    planes = _planes(nx, D)
    padded = _edge_pad(grid.detach(), planes * D + 1)
    slabs = [padded[d * planes:d * planes + planes + 1].to(dev, copy=True)
             for d, dev in enumerate(devices)]
    return ShardedGrid(slabs, tuple(grid.shape), planes)


def shard_scene_grids(grids: Dict[str, torch.Tensor],
                      devices: Devices) -> Dict[str, ShardedGrid]:
    return {name: shard_grid(g, devices) for name, g in grids.items()}


class _ToSlabs(torch.autograd.Function):
    """The points sent to each slab's device, every slab getting all of
    them (a view where the device is the points' own).  Backward: the
    slabs' point gradients summed on the points' device in device order.

    A slab's K3 answers only the points it owns in each grid, but the
    grids of one lookup are cut at different planes, so one point's
    gradient may come from up to one slab per grid.  Autograd would add
    the D gradients in the order they arrive, which over several cards
    varies from run to run; here the order is fixed."""

    @staticmethod
    def forward(ctx, p, devices):
        ctx.device = p.device
        ctx.set_materialize_grads(False)  # a slab's unused output: None, no zeros
        return tuple(p.view_as(p) if dev == p.device else p.to(dev)
                     for dev in devices)

    @staticmethod
    def backward(ctx, *dps):
        total = None
        for dp in dps:
            if dp is None:
                continue
            dp = dp.to(ctx.device)
            total = dp if total is None else total + dp
        return total, None


def sharded_trilinear_interp_multi(grids: Sequence[ShardedGrid],
                                   p_nor: torch.Tensor) -> List[torch.Tensor]:
    """Distributed ``ops.interp.trilinear_interp_multi``: per device one
    lookup Function (one K1 launch) over that device's slabs of every
    grid, all the points copied there; the D answers summed on the
    points' device, in device order, and in the backward the D point
    gradients too (``_ToSlabs``)."""
    grids = list(grids)
    if not all(isinstance(g, ShardedGrid) for g in grids):
        raise ValueError("a lookup mixes sharded and dense grids")
    devices = grids[0].devices
    if any(g.devices != devices for g in grids):
        raise ValueError("the grids of one lookup must be sharded over the same "
                         f"devices, got {grids}")
    out: Optional[List[torch.Tensor]] = None
    points = _ToSlabs.apply(p_nor, devices)
    for d, p_d in enumerate(points):
        part = trilinear_interp_multi([g.slabs[d] for g in grids], p_d,
                                      [g.window(d) for g in grids])
        part = [f.to(p_nor.device) for f in part]
        out = part if out is None else [a + b for a, b in zip(out, part)]
    return out


def sharded_trilinear_interp(sharded: ShardedGrid,
                             p_nor: torch.Tensor) -> torch.Tensor:
    """Distributed equivalent of ``ops.interp.trilinear_interp``."""
    return sharded_trilinear_interp_multi([sharded], p_nor)[0]


def sharded_sample_grid_feature(sharded: ShardedGrid, p_world: torch.Tensor,
                                bound: torch.Tensor) -> torch.Tensor:
    """Distributed equivalent of ``ops.interp.sample_grid_feature``."""
    from nice_slam_torch.ops.geometry import normalize_3d_coordinate

    return sharded_trilinear_interp(sharded,
                                    normalize_3d_coordinate(p_world, bound))


def sharded_eval_points(spec, state, sharded_grids: Dict[str, ShardedGrid],
                        p: torch.Tensor, stage: str) -> torch.Tensor:
    """``models.scene.eval_points`` with every grid lookup answered by the
    sharded store (the lookups dispatch on the grid type)."""
    from nice_slam_torch.models.scene import eval_points

    return eval_points(spec, state._replace(grids=dict(sharded_grids)), p, stage)


def unshard_grid_grad(slab_grads: Sequence[torch.Tensor],
                      shape: Tuple[int, int, int, int],
                      planes: int) -> torch.Tensor:
    """A dense (nx, ny, nz, C) gradient, on the first slab's device, from
    the per-slab gradients: the two copies of a shared plane each hold a
    disjoint part of its corner contributions, so they ACCUMULATE; the
    edge-padding planes past nx - 1 are never read with a nonzero weight
    and fold (as zeros) onto the edge plane."""
    D = len(slab_grads)
    nx, ny, nz, C = shape
    dev = slab_grads[0].device
    padded = torch.zeros((planes * D + 1, ny, nz, C), dtype=slab_grads[0].dtype,
                         device=dev)
    for d, g in enumerate(slab_grads):
        padded[d * planes:d * planes + planes + 1] += g.to(dev)
    dense = padded[:nx].clone()
    if planes * D + 1 > nx:
        dense[nx - 1] += padded[nx:].sum(dim=0)
    return dense


def fold_halo_grads(slab_grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """Make both stored copies of each shared x-plane hold its TOTAL
    gradient: total = slab d's plane 0 + slab d-1's halo, written into
    both (in place: the gradients are fresh from the backward).  Identical
    gradients and identical moments give identical updates under any
    elementwise optimizer.  Across devices each total is one plane copied
    each way; the copies are ordered on both devices' current streams."""
    for d in range(1, len(slab_grads)):
        lo, hi = slab_grads[d - 1], slab_grads[d]
        total = hi[0] + lo[-1].to(hi.device)
        hi[0].copy_(total)
        lo[-1].copy_(total.to(lo.device))
    return slab_grads


def fold_slab_grads(grads: Sequence[Optional[torch.Tensor]],
                    slabs: Sequence[torch.Tensor]) -> List:
    """A sharded grid's slab gradients (None: no gradient) with the halo
    planes folded: both copies of a shared plane get the same gradient.
    The frustum masks, cut into slabs by ``mask_to_slabs``, are applied
    after this (the JAX mapper's order) by the Adam step, which gives both
    copies the same mask value."""
    if all(g is None for g in grads):
        return list(grads)
    return fold_halo_grads([torch.zeros_like(s) if g is None else g
                            for g, s in zip(grads, slabs)])


def mask_to_slabs(mask: torch.Tensor, planes: int, D: int,
                  devices: Optional[Devices] = None) -> List[torch.Tensor]:
    """Cut a per-node mask already laid out for the slabs (planes x D + 1
    x-planes, the grid's last plane repeated past nx, as K10 writes it:
    ``ops/frustum.py`` ``frustum_masks`` with ``rows``) into one (planes +
    1, ny, nz, ...) view per slab, as ``shard_grid`` slices the grid; each
    is copied to ``devices[d]`` where given and elsewhere.  The shared
    planes are one plane of ``mask``, so both copies hold its values."""
    if mask.shape[0] != planes * D + 1:
        raise ValueError(f"a mask of {mask.shape[0]} x-planes for {D} slabs of "
                         f"{planes} planes (want {planes * D + 1})")
    out = [mask[d * planes:d * planes + planes + 1] for d in range(D)]
    if devices is not None:
        out = [m.to(dev) for m, dev in zip(out, devices)]
    return out


def make_grid_sharded_map_step(devices: Devices, spec, stage: str, rcfg,
                               w_color: float = 0.2, lr: float = 0.01):
    """A full mapping train step on a SPATIALLY SHARDED scene: every grid
    lookup answered by the sharded store, per-slab gradients, the halo
    fold, then one group-Adam step over the slabs, each on its device.

    Returns (step, shard_grids, init_adam):
        step(sharded_grids, state, adam, rays_o, rays_d, gt_d, gt_c)
            -> (new_sharded_grids, adam, loss)
        shard_grids(dense_grids) -> {name: ShardedGrid}
        init_adam(sharded_grids) -> adam, which owns trainable copies of
            the slabs and updates them in place at every step
    """
    from nice_slam_torch.ops.render import render_batch_ray
    from nice_slam_torch.slam.optim import GroupAdam

    def shard_grids(grids: Dict[str, torch.Tensor]) -> Dict[str, ShardedGrid]:
        return shard_scene_grids(grids, devices)

    def init_adam(sharded_grids: Dict[str, ShardedGrid]) -> GroupAdam:
        return GroupAdam({"grids": {
            k: sg._replace([s.detach().clone().requires_grad_(True)
                            for s in sg.slabs])
            for k, sg in sharded_grids.items()}})

    def step(sharded_grids, state, adam, rays_o, rays_d, gt_d, gt_c):
        names = sorted(sharded_grids)
        slabs = adam.params["grids"]  # the leaves, in tree_leaves order
        grids, pos = {}, 0
        for k in names:
            sg = sharded_grids[k]
            grids[k] = sg._replace(slabs[pos:pos + sg.D])
            pos += sg.D
        depth, _, color = render_batch_ray(
            spec, state._replace(grids=grids), rays_o, rays_d, stage,
            gt_depth=gt_d, rcfg=rcfg)
        loss = torch.sum(torch.where(gt_d > 0, torch.abs(gt_d - depth),
                                     torch.zeros_like(depth)))
        if stage == "color":
            loss = loss + w_color * torch.sum(torch.abs(gt_c - color))
        flat = list(torch.autograd.grad(loss, slabs, allow_unused=True))
        pos = 0
        for k in names:
            D = grids[k].D
            flat[pos:pos + D] = fold_slab_grads(flat[pos:pos + D], slabs[pos:pos + D])
            pos += D
        adam.step({"grids": flat}, {"grids": lr}, {"grids": True})
        new = {k: g._replace([s.detach() for s in g.slabs]) for k, g in grids.items()}
        return new, adam, loss.detach()

    return step, shard_grids, init_adam


def dense_grids(grids: Dict) -> Dict:
    """Any ShardedGrid values as dense grids (the checkpoint and export
    boundary; the compute path stays sharded)."""
    return {k: unshard_grid(g) if isinstance(g, ShardedGrid) else g
            for k, g in grids.items()}


def spatial_sharding_mesh(grids: Dict, devices: Optional[Devices] = None
                          ) -> Optional[List[torch.device]]:
    """The engage knob: the devices to shard the scene grids over, or None.

    ``NICE_SLAM_TORCH_SPATIAL`` = '1' force on | '0' force off | 'auto'
    (default): engage when two or more devices are in use (``devices``,
    default every visible CUDA device) AND the dense grids exceed
    ``NICE_SLAM_TORCH_HBM_BUDGET_GB`` (default 4.0), i.e. when a scene is
    outgrowing one card.  Forced on with fewer than two devices raises:
    it never falls back to dense silently."""
    mode = os.environ.get("NICE_SLAM_TORCH_SPATIAL", "auto")
    if mode == "0":
        return None
    if devices is None:
        from nice_slam_torch.parallel.sharding import make_mesh

        devices = make_mesh() if torch.cuda.is_available() else []
    devs = list(devices)
    if len(devs) < 2:
        if mode == "1":
            raise RuntimeError("NICE_SLAM_TORCH_SPATIAL=1 shards the grids over two "
                               f"or more devices, but {len(devs)} are in use")
        return None
    if mode != "1":  # auto
        budget = float(os.environ.get("NICE_SLAM_TORCH_HBM_BUDGET_GB", "4.0"))
        total = sum(g.numel() * g.element_size() for g in grids.values())
        if total <= budget * (1 << 30):
            return None
    return devs


def maybe_shard_state(state, devices: Optional[Devices] = None,
                      verbose: bool = False):
    """Engage spatial grid sharding on a SceneState per the knob; returns
    (state', devices-or-None)."""
    devs = spatial_sharding_mesh(state.grids, devices) if state.grids else None
    if devs is None:
        return state, None
    sharded = shard_scene_grids(state.grids, devs)
    if verbose:
        print(f"INFO: spatial grid sharding engaged over {len(devs)} devices "
              f"({per_device_bytes(sharded) / 2 ** 20:.0f} MiB grid features "
              f"per device)")
    return state._replace(grids=sharded), devs


def unshard_grid(sharded: ShardedGrid) -> torch.Tensor:
    """The dense (nx, ny, nz, C) grid, on the first slab's device, from a
    consistent sharded store: the slabs' owned planes in order, then the
    last slab's halo, the padding dropped."""
    dev = sharded.slabs[0].device
    parts = [s[:-1].to(dev) for s in sharded.slabs] + [sharded.slabs[-1][-1:].to(dev)]
    return torch.cat(parts, dim=0)[:sharded.shape[0]]


def per_device_bytes(sharded_grids: Dict[str, ShardedGrid]) -> int:
    """Feature bytes RESIDENT per device (the memory-scaling claim)."""
    return sum(sg.slabs[0].numel() * sg.slabs[0].element_size()
               for sg in sharded_grids.values())
