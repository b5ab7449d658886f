"""Mapper: counterpart of the JAX package's ``slam/mapper.py``.

Joint optimization of the grids, the fine/color decoders and (with BA)
the window poses over a keyframe window:

  * window = overlap-ranked keyframes chosen at random among those that
    see the current frame (or, for the coarse mapper, drawn from all
    keyframes) + the last keyframe + the current frame;
  * frustum feature selection as gradient masks: only grid nodes the
    current camera sees (projective depth test, plus a 0.5 m ball around
    the camera) are updated, which under a fresh Adam equals optimizing
    the compacted subset;
  * stages middle -> fine -> color split by iteration ratios, each with
    its 5-group learning rates; the coarse mapper runs stage 'coarse' with
    depth-free rendering;
  * BA over the window poses except the oldest, its LR live only at the
    color stage;
  * loss = masked depth L1 (+ weighted color L1 at the color stage),
    summed.

For the iMAP* model (``nice`` false) the whole decoder tree is one group
``dec`` on a StepLR schedule (``imap_decoders_lr * 0.8 ** (it // 200)``
over a call's iterations), every iteration is a color-stage iteration
with every ray kept, the camera learning rate is always on under BA, and
the loss adds the free-space regulariser ``5e-4 * sum |sigma|`` whenever
the model renders volume density (``occupancy`` false).

Over several devices (``parallel/``): with ``Mapper.devices`` set, the
ray batch of each iteration is split over them when it divides evenly
(ray data parallelism: the scene replicated, the partial losses summed on
the first device); a spatially sharded scene (``ShardedGrid`` grids)
turns that off, and its slab gradients get the halo fold and the
frustum masks sliced into slabs.  ``Mapper.pin(device)`` runs the whole
call on one device of its own (the coarse mapper's card), its inputs
copied there.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from nice_slam_torch.models.grids import make_generator
from nice_slam_torch.models.scene import SceneSpec, SceneState
from nice_slam_torch.ops.geometry import (
    c2w44,
    get_samples,
    invert,
    linspace,
    pose_from_tensor,
    ray_aabb_far,
    tensor_from_pose,
)
from nice_slam_torch.ops.frustum import frustum_mask_plain, frustum_masks
from nice_slam_torch.ops.render import RenderConfig, regulation, render_batch_ray
from nice_slam_torch.parallel.grid_sharding import ShardedGrid, fold_slab_grads, mask_to_slabs
from nice_slam_torch.parallel.sharding import (
    data_parallel,
    over_blocks,
    replicate_state,
    sum_on,
)
from nice_slam_torch.slam.optim import GroupAdam, tree_leaves, tree_map

STAGE_INDEX = {"coarse": 0, "middle": 1, "fine": 2, "color": 3}
LR_KEYS = ("decoders_lr", "coarse_lr", "middle_lr", "fine_lr", "color_lr")
GRID_NAMES = ("grid_coarse", "grid_middle", "grid_fine", "grid_color")


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    """Static mapping configuration (cfg['mapping'] + camera + mode)."""

    H: int
    W: int
    fx: float
    fy: float
    cx: float
    cy: float
    pixels: int
    iters: int
    iters_first: int
    every_frame: int
    keyframe_every: int
    mapping_window_size: int
    middle_iter_ratio: float
    fine_iter_ratio: float
    w_color_loss: float
    BA: bool
    BA_cam_lr: float
    fix_fine: bool
    fix_color: bool
    frustum_feature_selection: bool
    keyframe_selection_method: str
    lr_first_factor: float
    lr_factor: float
    color_refine: bool
    nice: bool
    coarse_mapper: bool
    occupancy: bool
    imap_decoders_lr: float
    # ((decoders_lr, coarse_lr, middle_lr, fine_lr, color_lr) per stage)
    stage_lr: Tuple[Tuple[float, float, float, float, float], ...]

    @staticmethod
    def from_cfg(cfg, cam, nice: bool, coarse_mapper: bool = False
                 ) -> "MapperConfig":
        m = cfg["mapping"]
        stage_lr = tuple(tuple(float(m["stage"][s][k]) for k in LR_KEYS)
                         for s in ("coarse", "middle", "fine", "color"))
        ksel = "global" if (nice and coarse_mapper) \
            else m["keyframe_selection_method"]
        return MapperConfig(
            H=cam["H"], W=cam["W"], fx=cam["fx"], fy=cam["fy"],
            cx=cam["cx"], cy=cam["cy"],
            pixels=m["pixels"], iters=m["iters"], iters_first=m["iters_first"],
            every_frame=m["every_frame"], keyframe_every=m["keyframe_every"],
            mapping_window_size=m["mapping_window_size"],
            middle_iter_ratio=m["middle_iter_ratio"],
            fine_iter_ratio=m["fine_iter_ratio"], w_color_loss=m["w_color_loss"],
            BA=m["BA"], BA_cam_lr=m["BA_cam_lr"], fix_fine=m["fix_fine"],
            fix_color=m["fix_color"],
            frustum_feature_selection=m["frustum_feature_selection"],
            keyframe_selection_method=ksel,
            lr_first_factor=m["lr_first_factor"], lr_factor=m["lr_factor"],
            color_refine=m["color_refine"], nice=nice,
            coarse_mapper=coarse_mapper, occupancy=bool(cfg["occupancy"]),
            imap_decoders_lr=float(m.get("imap_decoders_lr", 0.0)),
            stage_lr=stage_lr,
        )


# ---------------------------------------------------------------------------
# Keyframe selection
# ---------------------------------------------------------------------------

def _batched_rays(pix_idx: torch.Tensor, c2ws: torch.Tensor, W: int,
                  fx, fy, cx, cy):
    """Rays of flat pixel indices (F, n) through per-frame (F, 3|4, 4) poses
    -> rows, cols, rays_o (F, n, 3), rays_d (F, n, 3)."""
    r = pix_idx // W
    c = pix_idx % W
    i, j = c.to(torch.float32), r.to(torch.float32)
    dirs = torch.stack([(i - cx) / fx, -(j - cy) / fy, -torch.ones_like(i)], -1)
    rays_d = torch.einsum("fnk,fjk->fnj", dirs, c2ws[:, :3, :3])
    rays_o = c2ws[:, None, :3, 3].expand(rays_d.shape)
    return r, c, rays_o, rays_d


def overlap_scores(gen: torch.Generator, gt_color: torch.Tensor,
                   gt_depth: torch.Tensor, c2w: torch.Tensor,
                   kf_c2ws: torch.Tensor, H: int, W: int, fx, fy, cx, cy,
                   pixels: int = 100, N_samples: int = 16) -> torch.Tensor:
    """Fraction of the current frame's surface samples (``pixels`` pixels x
    ``N_samples`` depths in [0.8 d, d + 0.5]) that project inside each
    keyframe (20 px margin, in front of the camera)."""
    rays_o, rays_d, d, _ = get_samples(gen, 0, H, 0, W, pixels, fx, fy, cx, cy,
                                       c2w, gt_depth, gt_color)
    d = d[:, None]
    t = linspace(0.0, 1.0, N_samples, device=d.device)
    z = 0.8 * d * (1.0 - t) + (d + 0.5) * t
    pts = (rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]).reshape(-1, 3)
    w2c = invert(kf_c2ws)                                    # (K, 4, 4)
    cam = torch.einsum("nk,bjk->bnj", pts, w2c[:, :3, :3]) + w2c[:, None, :3, 3]
    zc = cam[..., 2] + 1e-5
    u = (fx * (-cam[..., 0]) + cx * cam[..., 2]) / zc
    v = (fy * cam[..., 1] + cy * cam[..., 2]) / zc
    edge = 20
    mask = (u < W - edge) & (u > edge) & (v < H - edge) & (v > edge) & (zc < 0)
    return mask.to(torch.float32).mean(dim=1)


def device_select_positions(scores: torch.Tensor, n_kf: int,
                            gen: torch.Generator, k: int):
    """Random ranking of the positive-overlap keyframes (excluding the last)
    on the device; returns (positions (k,), valid (k,)).  Surplus slots are
    invalid and point at position 0."""
    K = scores.shape[0]
    pos = torch.arange(K, device=scores.device)
    eligible = (scores > 0.0) & (pos < n_kf - 1)
    u = torch.rand(K, generator=gen, device=scores.device)
    order = torch.argsort(torch.where(eligible, u, torch.full_like(u, float("inf"))))
    sel = order[:k]
    valid = eligible[sel]
    return torch.where(valid, sel, torch.zeros_like(sel)), valid


def prepare_window(scores, n_kf: int, gen: torch.Generator, kf_colors,
                   kf_depths, kf_est, cur_color, cur_depth, cur_c2w, k: int,
                   BA: bool):
    """The mapping window from device-side overlap selection: k selected
    slots + the last keyframe + the current frame.  Returns (colors,
    depths, fixed_c2w, cam_tensors, opt_mask, frame_valid, positions)."""
    F = k + 2
    dev = scores.device
    sel, valid = device_select_positions(scores, n_kf, gen, k)
    last = torch.full((1,), n_kf - 1, dtype=sel.dtype, device=dev)
    positions = torch.cat([sel, last])
    frame_valid = torch.cat([valid, torch.ones(2, dtype=torch.bool, device=dev)])
    colors = torch.cat([kf_colors[positions], cur_color[None]])
    depths = torch.cat([kf_depths[positions], cur_depth[None]])
    fixed_c2w = torch.cat([kf_est[positions], cur_c2w[None]])
    cam_tensors = tensor_from_pose(fixed_c2w)
    if BA:
        # the oldest valid window pose stays fixed
        cand = torch.cat([torch.where(valid, sel, torch.full_like(sel, n_kf)),
                          last])
        oldest = torch.argmin(cand)
        opt_mask = frame_valid.to(torch.float32) * (
            1.0 - torch.nn.functional.one_hot(oldest, F).to(torch.float32))
    else:
        opt_mask = torch.zeros(F, device=dev)
    return (colors, depths, fixed_c2w, cam_tensors, opt_mask, frame_valid,
            positions)


def select_keyframes(rng: np.random.Generator, mcfg: MapperConfig,
                     n_keyframes: int) -> List[int]:
    """Host-side 'global' selection: random positions among 0..n-2."""
    if n_keyframes - 1 <= 0:
        return []
    k = mcfg.mapping_window_size - 2
    perm = rng.permutation(n_keyframes - 1)
    return [int(x) for x in perm[: min(n_keyframes - 1, k)]]


# ---------------------------------------------------------------------------
# Frustum feature selection
# ---------------------------------------------------------------------------

def frustum_mask(c2w: torch.Tensor, depth_img: torch.Tensor,
                 bound: torch.Tensor, shape: Tuple[int, int, int], H: int,
                 W: int, fx, fy, cx, cy) -> torch.Tensor:
    """Boolean (nx, ny, nz) mask of grid nodes the camera sees: inside the
    image, 0 <= camera depth <= sensor depth + 0.5 (zero depth lookups
    replaced by the largest lookup), or within 0.5 m of the camera.  K10
    on the card (``ops/frustum.py``), its plain version on the CPU."""
    if not c2w.is_cuda:
        return frustum_mask_plain(c2w, depth_img, bound, shape, H, W, fx, fy, cx, cy)
    return frustum_masks(c2w, depth_img, bound, [shape], H, W, fx, fy, cx, cy
                         )[0][..., 0] > 0


# ---------------------------------------------------------------------------
# Parameter groups, stages and the loss
# ---------------------------------------------------------------------------

def _opt_param_groups(spec: SceneSpec, state: SceneState, mcfg: MapperConfig,
                      cam_tensors: torch.Tensor, BA: bool) -> Dict[str, Any]:
    """Trainable copies (leaf tensors) of the groups this mapper trains."""
    src: Dict[str, Any] = {}
    if not spec.nice:
        src["dec"] = state.decoders
    elif mcfg.coarse_mapper:
        src["grid_coarse"] = state.grids["grid_coarse"]
    else:
        for name in ("grid_middle", "grid_fine", "grid_color"):
            src[name] = state.grids[name]
        if not mcfg.fix_fine:
            src["dec_fine"] = state.decoders["fine"]
        if not mcfg.fix_color:
            src["dec_color"] = state.decoders["color"]
    if BA:
        src["cams"] = cam_tensors
    return {k: tree_map(lambda t: t.detach().clone().requires_grad_(True), v)
            for k, v in src.items()}


def _merge_scene(state: SceneState, groups: Dict[str, Any]) -> SceneState:
    if "dec" in groups:  # iMAP*: the decoder tree is the group
        return state._replace(decoders=groups["dec"])
    grids = dict(state.grids)
    for k in GRID_NAMES:
        if k in groups:
            grids[k] = groups[k]
    decoders = dict(state.decoders)
    if "dec_fine" in groups:
        decoders["fine"] = groups["dec_fine"]
    if "dec_color" in groups:
        decoders["color"] = groups["dec_color"]
    return state._replace(decoders=decoders, grids=grids)


def _active_groups(stage: str, groups: Dict[str, Any]) -> Dict[str, bool]:
    """Which groups take a step at this stage (those in its forward graph;
    all of them for iMAP*)."""
    if "dec" in groups:
        return {k: True for k in groups}
    active = {"coarse": {"grid_coarse"},
              "middle": {"grid_middle"},
              "fine": {"grid_middle", "grid_fine", "dec_fine"},
              "color": {"grid_middle", "grid_fine", "grid_color", "dec_fine",
                        "dec_color"}}[stage] | {"cams"}
    return {k: (k in active) for k in groups}


def _stage_lrs(mcfg: MapperConfig, stage: str, lr_factor: float,
               groups: Dict[str, Any]) -> Dict[str, float]:
    dec_lr, coarse_lr, mid_lr, fine_lr, color_lr = \
        mcfg.stage_lr[STAGE_INDEX[stage]]
    table = {"grid_coarse": coarse_lr, "grid_middle": mid_lr,
             "grid_fine": fine_lr, "grid_color": color_lr,
             "dec_fine": dec_lr, "dec_color": dec_lr}
    lrs = {k: table[k] * lr_factor for k in groups if k in table}
    if "cams" in groups:
        lrs["cams"] = mcfg.BA_cam_lr if (not mcfg.nice or stage == "color") else 0.0
    return lrs


def imap_lr(mcfg: MapperConfig, it: int) -> float:
    """iMAP*'s decoder learning rate at iteration ``it`` of a call: StepLR
    with step 200 and gamma 0.8, in float32 as the JAX package computes it;
    the call's lr_factor does not apply."""
    return float(np.float32(mcfg.imap_decoders_lr)
                 * np.float32(0.8) ** np.float32(it // 200))


def mapping_loss(spec: SceneSpec, groups: Dict[str, Any],
                 base_state: SceneState, colors: torch.Tensor,
                 depths: torch.Tensor, fixed_c2w: torch.Tensor,
                 opt_cam_mask: torch.Tensor, frame_valid: torch.Tensor,
                 stage: str, mcfg: MapperConfig, rcfg: RenderConfig,
                 pixs_per_image: int, pix_idx: Optional[torch.Tensor] = None,
                 gen: Optional[torch.Generator] = None,
                 reg_t: Optional[torch.Tensor] = None,
                 devices=None) -> torch.Tensor:
    """One mapping iteration's loss over the window.  ``pix_idx`` (F, n)
    gives the flat pixel indices per window frame and ``reg_t`` (F * n,
    N_samples) the regulariser's stratum jitter; when None they are drawn
    from ``gen``.  Over ``devices`` the rays are split when they divide
    evenly (the grids then must be dense)."""
    state = _merge_scene(base_state, groups)
    F = colors.shape[0]
    if "cams" in groups:
        m = opt_cam_mask[:, None, None]
        c2ws = m * pose_from_tensor(groups["cams"]) + (1.0 - m) * fixed_c2w[:, :3, :]
    else:
        c2ws = fixed_c2w[:, :3, :]
    if pix_idx is None:
        pix_idx = torch.randint(0, mcfg.H * mcfg.W, (F, pixs_per_image),
                                generator=gen, device=colors.device)
    r, c, rays_o, rays_d = _batched_rays(pix_idx, c2ws, mcfg.W, mcfg.fx,
                                         mcfg.fy, mcfg.cx, mcfg.cy)
    fidx = torch.arange(F, device=colors.device)[:, None]
    gt_d = depths[fidx, r, c].reshape(-1)
    gt_c = colors[fidx, r, c].reshape(-1, 3)
    rays_o = rays_o.reshape(-1, 3)
    rays_d = rays_d.reshape(-1, 3)

    if spec.nice:
        inside = ray_aabb_far(rays_o, rays_d, state.bound).detach() >= gt_d
    else:
        inside = torch.ones_like(gt_d, dtype=torch.bool)
    inside = inside & torch.repeat_interleave(frame_valid, pixs_per_image)

    def ray_loss(st, ro, rd, gd, gc, ins, rt=None, depth_max=None, reg_gen=None):
        # no generator: the mapping renders draw nothing (perturb 0 and a
        # deterministic importance pass; the JAX mapper renders with
        # key=None), and a draw without one raises
        depth, _, color = render_batch_ray(
            spec, st, ro, rd, stage, gt_depth=None if mcfg.coarse_mapper else gd,
            rcfg=rcfg, depth_max=depth_max)
        ddiff = torch.abs(gd - depth)
        loss = torch.sum(torch.where((gd > 0) & ins, ddiff, torch.zeros_like(ddiff)))
        if not spec.nice or stage == "color":
            cdiff = torch.abs(gc - color)
            loss = loss + mcfg.w_color_loss * torch.sum(
                torch.where(ins[:, None], cdiff, torch.zeros_like(cdiff)))
        if not mcfg.occupancy:
            # the free-space regulariser, with rays_d and rays_o in the order
            # the JAX mapper passes them (nice_slam_tpu/slam/mapper.py:553-554:
            # its samples lie at rays_d + rays_o * z; ROADMAP C)
            sigma = regulation(spec, st, rd, ro, gd, rcfg.N_samples, stage,
                               gen=reg_gen, t_rand=rt)
            loss = loss + 0.0005 * torch.sum(torch.abs(sigma))
        return loss

    if not data_parallel(devices, rays_o.shape[0]):
        return ray_loss(state, rays_o, rays_d, gt_d, gt_c, inside, reg_t, reg_gen=gen)
    # ray data parallelism: what the whole batch shares is drawn or
    # reduced before the split (the regulariser's jitter, drawn as
    # ``regulation`` would draw it; the largest depth), and the blocks get
    # no generator: a draw in a block would take a device's draws in block
    # order, or another device's generator, so it raises
    if not mcfg.occupancy and reg_t is None:
        reg_t = torch.rand((rays_o.shape[0], rcfg.N_samples), generator=gen,
                           device=rays_o.device)
    arrays = [rays_o, rays_d, gt_d, gt_c, inside]
    if reg_t is not None:
        arrays.append(reg_t)
    depth_max = torch.max(gt_d)

    def block(st, *xs):
        return ray_loss(st, *xs[:5], xs[5] if len(xs) > 5 else None,
                        depth_max.to(xs[0].device))
    return sum_on(over_blocks(devices, block, state, *arrays), rays_o.device)


def optimize_map_core(spec: SceneSpec, state: SceneState, colors, depths,
                      fixed_c2w, cam_tensors, opt_cam_mask, frame_valid,
                      lr_factor: float, mcfg: MapperConfig, rcfg: RenderConfig,
                      stage_plan: Tuple[Tuple[str, int], ...], BA: bool,
                      pixs_per_image: int, gen: Optional[torch.Generator] = None,
                      pix_idx: Optional[torch.Tensor] = None, vis_hook=None,
                      vis_every: int = 0, reg_t: Optional[torch.Tensor] = None,
                      devices=None):
    """One optimize_map call: a fresh group Adam, then the stages in order.
    ``pix_idx`` (num_iters, F, n) fixes every iteration's pixels and
    ``reg_t`` (num_iters, F * n, N_samples) the regulariser's jitter;
    otherwise they are drawn from ``gen``.  ``vis_hook(it, state)``, when given, is
    called with the pre-iteration scene state at every ``vis_every``-th
    iteration.  ``devices``: split each iteration's rays over them (dense
    grids only).  The frustum masks go to the Adam step as the grid
    gradients' masks; a spatially sharded grid's slab gradients are folded
    (``fold_slab_grads``) and masked with the frustum mask cut into slabs,
    so its duplicated planes stay bitwise equal.  Returns (new
    state, new cam tensors, losses (num_iters,)), all on the device."""
    masks: Dict[str, List[torch.Tensor]] = {}  # group -> a mask per leaf
    if mcfg.frustum_feature_selection and not mcfg.coarse_mapper:
        shapes = dict(spec.grid_shapes)
        names = [k for k in ("grid_middle", "grid_fine", "grid_color") if k in shapes]
        if names:
            # K10 on the card: every distinct grid's mask in one launch, a
            # sharded grid's already in the slab layout
            grids = [state.grids[k] for k in names]
            rows = [g.planes * g.D + 1 if isinstance(g, ShardedGrid) else shapes[k][0]
                    for k, g in zip(names, grids)]
            got = frustum_masks(fixed_c2w[-1], depths[-1], state.bound,
                                [shapes[k] for k in names], mcfg.H, mcfg.W,
                                mcfg.fx, mcfg.fy, mcfg.cx, mcfg.cy, rows)
            for name, grid, m in zip(names, grids, got):
                masks[name] = (mask_to_slabs(m, grid.planes, grid.D, grid.devices)
                               if isinstance(grid, ShardedGrid) else [m])
    groups = _opt_param_groups(spec, state, mcfg, cam_tensors, BA)
    adam = GroupAdam(groups)
    losses = []
    it = 0
    for stage, n_iters in stage_plan:
        active = _active_groups(stage, groups)
        names = [k for k in groups if active[k]]
        leaves = [x for k in names for x in tree_leaves(groups[k])]
        lrs = _stage_lrs(mcfg, stage, lr_factor, groups)
        for _ in range(n_iters):
            if vis_hook is not None and vis_every > 0 and it % vis_every == 0:
                vis_hook(it, _merge_scene(state, {
                    k: tree_map(lambda t: t.detach(), v) for k, v in groups.items()}))
            loss = mapping_loss(
                spec, groups, state, colors, depths, fixed_c2w, opt_cam_mask,
                frame_valid, stage, mcfg, rcfg, pixs_per_image,
                None if pix_idx is None else pix_idx[it], gen,
                None if reg_t is None else reg_t[it], devices)
            flat = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads, pos = {}, 0
            for k in names:
                n = len(adam.params[k])
                grads[k] = list(flat[pos:pos + n])
                pos += n
                if isinstance(groups[k], ShardedGrid):
                    grads[k] = fold_slab_grads(grads[k], adam.params[k])
            if "dec" in groups:
                lrs["dec"] = imap_lr(mcfg, it)
            # the frustum masks are applied to the grid gradients in the step
            adam.step(grads, lrs, active, masks)
            losses.append(loss.detach())
            # drop the iteration's graph and gradients before the next
            # forward, not when the next iteration replaces them
            del loss, flat, grads
            it += 1
    trained = {k: tree_map(lambda t: t.detach(), v) for k, v in groups.items()}
    new_state = _merge_scene(state, trained)
    new_cams = trained.get("cams", cam_tensors)
    return new_state, new_cams, torch.stack(losses)


def stage_plan_for(mcfg: MapperConfig, num_joint_iters: int,
                   middle_iter_ratio: Optional[float] = None,
                   fine_iter_ratio: Optional[float] = None,
                   ) -> Tuple[Tuple[str, int], ...]:
    """Split a call's iterations into stages: iteration t is middle while
    t <= int(n * middle_ratio), fine while t <= int(n * fine_ratio), color
    after; the coarse mapper is all-coarse, iMAP* all-color."""
    if mcfg.coarse_mapper:
        return (("coarse", num_joint_iters),)
    if not mcfg.nice:
        return (("color", num_joint_iters),)
    mr = mcfg.middle_iter_ratio if middle_iter_ratio is None else middle_iter_ratio
    fr = mcfg.fine_iter_ratio if fine_iter_ratio is None else fine_iter_ratio
    n_mid = min(num_joint_iters, int(num_joint_iters * mr) + 1)
    n_fine = min(num_joint_iters, int(num_joint_iters * fr) + 1) - n_mid
    n_color = num_joint_iters - n_mid - n_fine
    return (("middle", n_mid), ("fine", max(n_fine, 0)),
            ("color", max(n_color, 0)))


class Mapper:
    """Host-side mapping driver: window selection, the optimize call and
    the BA pose write-back."""

    def __init__(self, spec: SceneSpec, mcfg: MapperConfig, rcfg: RenderConfig,
                 device, seed: int = 1, save_selected_keyframes_info: bool = False):
        self.spec = spec
        self.mcfg = mcfg
        self.rcfg = rcfg
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.gen = make_generator(seed + 1000, torch.device(device))
        # ray data parallelism over these devices (None: one device); a
        # spatially sharded scene turns it off
        self.devices = None
        # when set (``pin``), the whole optimize call runs on this device
        self.device = None
        # runtime-adjustable copies (the final color refinement rewrites them)
        self.mapping_window_size = mcfg.mapping_window_size
        self.middle_iter_ratio = mcfg.middle_iter_ratio
        self.fine_iter_ratio = mcfg.fine_iter_ratio
        self.fix_color = mcfg.fix_color
        self.frustum_feature_selection = mcfg.frustum_feature_selection
        # frame index -> the window of its last mapping call: [{idx, gt_c2w,
        # est_c2w} per window keyframe, then the current frame], host arrays
        # taken before the call (a host sync per call, so only on request)
        self.selected_keyframes = {} if save_selected_keyframes_info else None

    def pin(self, device) -> None:
        """Run every later optimize call on ``device`` alone (no ray data
        parallelism): the coarse mapper on its own card, so the strict
        loop's main and coarse calls run concurrently.  The generator is
        made again on that device from the same seed (a CUDA generator's
        draws do not depend on its device), so call this before the first
        call.  The window is then selected on the host ('global'), as the
        coarse mapper's is, and its inputs are copied to ``device``."""
        if self.mcfg.keyframe_selection_method == "overlap":
            raise ValueError("a pinned mapper selects its window on the host "
                             "('global'); 'overlap' draws on the main device")
        self.device = torch.device(device)
        self.devices = None
        self.gen = make_generator(self.seed + 1000, self.device)

    def optimize_map(self, state: SceneState, num_joint_iters: int,
                     lr_factor: float, cur_color: torch.Tensor,
                     cur_depth: torch.Tensor, keyframes,
                     cur_c2w: torch.Tensor, BA: bool, vis_hook=None,
                     vis_every: int = 0, idx: int = 0, gt_cur_c2w=None):
        """One mapping call on frame ``idx`` (device tensors; cur_c2w is
        4x4, ``gt_cur_c2w`` its true pose for the selected-keyframe record),
        with ``vis_hook`` as in ``optimize_map_core``.  Returns (new state,
        updated current pose or None, losses)."""
        mcfg = dataclasses.replace(
            self.mcfg, mapping_window_size=self.mapping_window_size,
            middle_iter_ratio=self.middle_iter_ratio,
            fine_iter_ratio=self.fine_iter_ratio, fix_color=self.fix_color,
            frustum_feature_selection=self.frustum_feature_selection)
        n_kf = len(keyframes)
        a = keyframes.arrays
        if mcfg.keyframe_selection_method == "overlap" and n_kf >= 2:
            scores = overlap_scores(self.gen, cur_color, cur_depth, cur_c2w,
                                    a.est_c2w, mcfg.H, mcfg.W, mcfg.fx, mcfg.fy,
                                    mcfg.cx, mcfg.cy)
            k = min(mcfg.mapping_window_size - 2, n_kf - 1)
            (colors, depths, fixed_c2w, cam_tensors, opt_mask, frame_valid,
             positions) = prepare_window(
                scores, n_kf, self.gen, a.colors, a.depths, a.est_c2w,
                cur_color, cur_depth, cur_c2w, k, BA)
        else:
            if mcfg.keyframe_selection_method == "global":
                positions = select_keyframes(self.rng, mcfg, n_kf)
            else:
                positions = []
            if n_kf > 0:
                positions.append(n_kf - 1)
            oldest = positions.index(min(positions)) if positions else None
            pos_t = torch.as_tensor(positions, dtype=torch.int64)
            if cur_depth.is_cuda:
                # from pinned memory: an upload from pageable memory would
                # wait for the device's queued work (the main mapper's,
                # when this is the coarse mapper on its own card)
                pos_t = pos_t.pin_memory().to(cur_depth.device, non_blocking=True)
            colors = torch.cat([a.colors[pos_t], cur_color[None]])
            depths = torch.cat([a.depths[pos_t], cur_depth[None]])
            fixed_c2w = torch.cat([a.est_c2w[pos_t], cur_c2w[None]])
            cam_tensors = tensor_from_pose(fixed_c2w)
            F = len(positions) + 1
            opt_mask = torch.zeros(F, device=cur_depth.device)
            if BA:
                opt_mask[:] = 1.0
                if oldest is not None:
                    opt_mask[oldest] = 0.0
            frame_valid = torch.ones(F, dtype=torch.bool, device=cur_depth.device)
            positions = pos_t
        if self.selected_keyframes is not None:
            valid = frame_valid[:-1].tolist()
            infos = [{"idx": keyframes.frame_ids[p],
                      "gt_c2w": a.gt_c2w[p].cpu().numpy(),
                      "est_c2w": a.est_c2w[p].cpu().numpy()}
                     for p, v in zip(positions.tolist(), valid) if v]
            infos.append({"idx": idx, "gt_c2w": np.asarray(gt_cur_c2w, np.float32),
                          "est_c2w": cur_c2w.cpu().numpy()})
            self.selected_keyframes[idx] = infos
        F = colors.shape[0]
        plan = stage_plan_for(mcfg, num_joint_iters)
        devices = self.devices
        if any(isinstance(g, ShardedGrid) for g in state.grids.values()):
            devices = None  # the grids own the devices themselves
        if self.device is not None:
            # the whole call on the pinned device: device-to-device copies
            # that do not wait for the host
            dev = self.device
            state = replicate_state(state, dev)
            colors, depths, fixed_c2w, cam_tensors, opt_mask, frame_valid = (
                x.to(dev, non_blocking=True) for x in (
                    colors, depths, fixed_c2w, cam_tensors, opt_mask, frame_valid))
        new_state, new_cams, losses = optimize_map_core(
            self.spec, state, colors, depths, fixed_c2w, cam_tensors, opt_mask,
            frame_valid, lr_factor, mcfg, self.rcfg, plan, BA, mcfg.pixels // F,
            gen=self.gen, vis_hook=vis_hook, vis_every=vis_every, devices=devices)
        cur_out = None
        if BA:
            # write the refined window poses back (host bookkeeping: syncs)
            poses = c2w44(pose_from_tensor(new_cams))
            keep = (opt_mask[:-1] > 0).tolist()
            for slot, pos in enumerate(positions.tolist()):
                if keep[slot]:
                    keyframes.set_est_c2w(pos, poses[slot])
            cur_out = poses[-1]
        return new_state, cur_out, losses
