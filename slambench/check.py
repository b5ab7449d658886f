"""The comparison that decides ``correct``.

Each kept block (``capture.py``: one iteration) is followed by the plain
reference (``reference/``) from the same starting point:
the system's state at the block's first iteration (the map, the trained
leaves, the optimiser's moments and step counts, the window and the
pixels it drew), except for the first mapping call of the run, which the
reference starts from its own state (the weights made from the seed, the
pretrained decoders read from their files, frame 0 at its true pose).
The frustum masks, the stage of each iteration, the learning rates and
every loss, gradient and update are the reference's own.

Four numbers, each the largest over the blocks:

  * ``loss_gap``: |L_sys - L_ref| / |L_ref| of the iteration's loss;
  * ``grad_gap``: the worst leaf's |‖g_sys‖ - ‖g_ref‖| over the larger of
    ‖g_ref‖ and the median leaf's, for the gradient as the optimiser
    receives it;
  * ``step_gap``: the same of the leaves' change in the step, leaving out
    leaves whose reference gradient is below a thousandth of the median
    leaf's (they move by rounding alone under Adam);
  * ``step_dir``: over the same leaves, the worst leaf's 1 - cos of the
    angle between the system's change and the reference's (1 where one
    side does not move): the norms above cannot see a step taken the
    wrong way.

One iteration, not a chain: the tracker's Adam steps at lr 0.01 amplify
rounding, so a chain of three read a loss gap of 1e-3 at its third
iteration where its first read 3e-6.

``control`` puts the reference computed in TF32 in the system's place.
"""

from __future__ import annotations

import math
import statistics
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from slambench.reference import core as R
from slambench.weights import flatten

NUMBERS = ("loss_gap", "grad_gap", "step_gap", "step_dir")
STAGE_LR = {"grid_coarse": "coarse_lr", "grid_middle": "middle_lr", "grid_fine": "fine_lr",
            "grid_color": "color_lr", "dec_fine": "decoders_lr", "dec_color": "decoders_lr"}
ACTIVE = {"coarse": {"grid_coarse"}, "middle": {"grid_middle", "cams"},
          "fine": {"grid_middle", "grid_fine", "dec_fine", "cams"},
          "color": {"grid_middle", "grid_fine", "grid_color", "dec_fine", "dec_color", "cams"}}


def rounded_bound(cfg: Dict) -> np.ndarray:
    """The scene box: the configured bound times ``scale``, its extent
    rounded up to a multiple of ``bound_divisible`` past the next one."""
    b = np.asarray(cfg["mapping"]["bound"], dtype=np.float64) * cfg["scale"]
    div = cfg["grid_len"]["bound_divisible"]
    b[:, 1] = (np.floor((b[:, 1] - b[:, 0]) / div) + 1) * div + b[:, 0]
    return b.astype(np.float32)


def grid_shapes(cfg: Dict, nice: bool) -> Dict[str, tuple]:
    """Nodes per axis of each grid: extent / voxel length, truncated (the
    coarse grid over the enlarged box)."""
    if not nice:
        return {}
    b = rounded_bound(cfg).astype(np.float64)
    ext = b[:, 1] - b[:, 0]
    out = {}
    if cfg["coarse"]:
        out["grid_coarse"] = tuple(int(v) for v in (ext * cfg["model"]["coarse_bound_enlarge"]
                                                     / cfg["grid_len"]["coarse"]))
    for n in ("middle", "fine", "color"):
        out["grid_" + n] = tuple(int(v) for v in ext / cfg["grid_len"][n])
    return out


def stage_plan(cfg: Dict, n: int, nice: bool, coarse: bool) -> List[str]:
    """The stage of each of a call's ``n`` iterations: middle while
    t <= n x middle_iter_ratio, fine while t <= n x fine_iter_ratio, color
    after; all coarse for the coarse mapper, all color for iMAP*."""
    if coarse:
        return ["coarse"] * n
    if not nice:
        return ["color"] * n
    m = cfg["mapping"]
    out = []
    for t in range(n):
        out.append("middle" if t <= int(n * m["middle_iter_ratio"]) else
                   "fine" if t <= int(n * m["fine_iter_ratio"]) else "color")
    return out


def _group(name: str) -> str:
    return name.split("/")[0]


class Context:
    """What the reference needs besides a block: the configuration (the
    port config plus ``model``, ``camera``), the model module, its fixed
    parameters and the run's own starting state."""

    def __init__(self, conf: Dict, cam: Dict, model_mod, fixed: Dict, own: Dict,
                 frame0: Dict, device):
        cfg = dict(conf["config"])
        cfg["model"] = conf["model"]
        cfg["camera"] = cam
        cfg["occupancy"] = bool(conf["config"]["occupancy"])
        self.cfg, self.mod, self.fixed, self.own, self.frame0 = cfg, model_mod, fixed, own, frame0
        self.nice = conf["model"] == "nice"
        self.conf = conf
        b = torch.as_tensor(rounded_bound(conf["config"]), device=device)
        self.bound = b
        self.coarse_bound = b * conf["config"]["model"]["coarse_bound_enlarge"]
        self.shapes = grid_shapes(conf["config"], self.nice)

    def raw_fn(self, P):
        return lambda p, stage: self.mod.raw(P, p, stage, self.bound, self.coarse_bound)

    def map_params(self, state) -> Dict[str, torch.Tensor]:
        """The map of a system state as the reference's flat parameters
        (its own pretrained decoders beside it)."""
        P = dict(self.fixed)
        for name, g in state.grids.items():
            P[name] = g
        if self.nice:
            P.update({f"dec_color/{n}": t for n, t in flatten(state.decoders["color"])})
        else:
            P.update({f"dec/{n}": t for n, t in flatten(state.decoders)})
        return P


def _lr(ctx: Context, group: str, stage: str, lr_factor: float, it: int):
    m = ctx.cfg["mapping"]
    if group == "cams":
        return m["BA_cam_lr"] if (not ctx.nice or stage == "color") else 0.0
    if group == "dec":
        return float(np.float32(m["imap_decoders_lr"]) * np.float32(0.8) ** np.float32(it // 200))
    return m["stage"][stage][STAGE_LR[group]] * lr_factor


def follow_map(ctx: Context, blk: Dict, start: Dict[str, torch.Tensor], win: Dict,
               adam: Optional[Dict], steps: Optional[Dict], stages: List[str]) -> Dict:
    """The reference's mapping iterations from ``start``."""
    cfg = ctx.cfg
    base = ctx.map_params(blk["state"]) if blk["state"] is not None else dict(ctx.fixed)
    leaves = {n: t.detach().clone().requires_grad_(True) for n, t in start.items()}
    mom = {n: ((adam[n][0].clone(), adam[n][1].clone()) if adam else
               (torch.zeros_like(t), torch.zeros_like(t))) for n, t in leaves.items()}
    counts = {g: (steps.get(g, 0) if steps else 0) for g in {_group(n) for n in leaves}}
    masks = {}
    if ctx.nice and not blk["coarse"] and cfg["mapping"]["frustum_feature_selection"]:
        for g in ("grid_middle", "grid_fine", "grid_color"):
            masks[g] = R.frustum_mask(win["fixed_c2w"][-1], win["depths"][-1], ctx.bound,
                                      ctx.shapes[g], cfg["camera"])
    losses, grads0 = [], {}
    for i in range(len(stages)):
        stage = stages[i]
        active = ({_group(n) for n in leaves} if not ctx.nice else
                  {g for g in {_group(n) for n in leaves} if g in ACTIVE[stage]})
        P = dict(base)
        P.update({n: t for n, t in leaves.items() if n != "cams"})
        cams = leaves.get("cams")
        loss = R.mapping_loss(ctx.raw_fn(P), cams, win, stage, blk["pix"][i],
                              blk["reg_t"][i], cfg, ctx.bound, blk["coarse"])
        names = [n for n in leaves if _group(n) in active]
        gs = torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)
        losses.append(float(loss.detach()))
        if i == 0:
            grads0 = {n: g for n, g in zip(names, gs)}
        for g in active:
            counts[g] += 1
        for n, g in zip(names, gs):
            grp = _group(n)
            R.adam_step(leaves[n], g, *mom[n], counts[grp],
                        _lr(ctx, grp, stage, blk["lr_factor"], blk["k"] + i), masks.get(grp))
    return {"losses": losses, "grads0": grads0,
            "after": {n: t.detach() for n, t in leaves.items()}}


def follow_track(ctx: Context, blk: Dict, start: torch.Tensor, adam, steps) -> Dict:
    cfg = ctx.cfg
    t = cfg["tracking"]
    P = ctx.map_params(blk["state"])
    cam = start.detach().clone().requires_grad_(True)
    m, v = (adam["cam"][0].clone(), adam["cam"][1].clone()) if adam else (
        torch.zeros_like(cam), torch.zeros_like(cam))
    count = steps.get("p", 0) if steps else 0
    lr = t["lr"]
    if t["seperate_LR"]:
        lr = torch.tensor([0.2] * 4 + [1.0] * 3, device=cam.device) * t["lr"]
    losses, g0 = [], None
    pi, pj, pd, pc = blk["pix"]
    for i in range(pi.shape[0]):
        loss = R.tracking_loss(ctx.raw_fn(P), cam, pi[i], pj[i], pd[i], pc[i], cfg, ctx.bound)
        (g,) = torch.autograd.grad(loss, [cam])
        losses.append(float(loss.detach()))
        if i == 0:
            g0 = g
        count += 1
        R.adam_step(cam, g, m, v, count, lr)
    return {"losses": losses, "grads0": {"cam": g0}, "after": {"cam": cam.detach()}}


def follow(ctx: Context, blk: Dict) -> Dict:
    """The reference's reading of a block (``blk["own"]``: from its own
    start, the run's first mapping call)."""
    if blk["kind"] == "track":
        return follow_track(ctx, blk, blk["start"]["cam"], blk["adam"], blk["adam_steps"])
    if blk.get("own"):
        n = ctx.cfg["mapping"]["iters_first"]
        stages = stage_plan(ctx.cfg, n, ctx.nice, False)[:len(blk["pix"])]
        own = dict(blk, state=None, lr_factor=ctx.cfg["mapping"]["lr_first_factor"])
        return follow_map(ctx, own, ctx.own, ctx.frame0, None, None, stages)
    start = {n: t for v in blk["groups"].values() for n, t in v}
    stages = list(blk["stages"])
    return follow_map(ctx, blk, start, blk["win"], blk["adam"], blk["adam_steps"], stages)


def _norm(t: Optional[torch.Tensor]) -> float:
    return 0.0 if t is None else float(t.detach().double().norm())


def _median(xs: List[float]) -> float:
    return statistics.median(xs) if xs else 0.0


def _one_less_cos(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double().flatten(), b.detach().double().flatten()
    na, nb = float(a.norm()), float(b.norm())
    if na == 0.0 or nb == 0.0:
        return 0.0 if na == nb else 1.0
    return 1.0 - float(a @ b) / (na * nb)


def gaps(sys_r: Dict, ref_r: Dict, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The numbers of one block: the system's reading ``sys_r`` (or the
    control's) against the reference's ``ref_r``."""
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(sys_r["losses"], ref_r["losses"]))
    gref = {n: _norm(g) for n, g in ref_r["grads0"].items()}
    gmed = _median(list(gref.values()))
    grad = max((abs(_norm(sys_r["grads0"].get(n)) - r) / max(r, gmed, 1e-30)
                for n, r in gref.items()), default=0.0)
    dref = {n: _norm(ref_r["after"][n] - start[n]) for n in gref
            if gref[n] >= 1e-3 * gmed}
    dmed = _median(list(dref.values()))
    step = max((abs(_norm(sys_r["after"][n] - start[n]) - r) / max(r, dmed, 1e-30)
                for n, r in dref.items()), default=0.0)
    turn = max((_one_less_cos(sys_r["after"][n] - start[n], ref_r["after"][n] - start[n])
                for n in dref), default=0.0)
    return {"loss_gap": loss, "grad_gap": grad, "step_gap": step, "step_dir": turn}


def block_start(ctx: Context, blk: Dict) -> Dict[str, torch.Tensor]:
    if blk["kind"] == "track":
        return {"cam": blk["start"]["cam"]}
    if blk.get("own"):
        return ctx.own
    return {n: t for v in blk["groups"].values() for n, t in v}


def system_reading(blk: Dict) -> Dict:
    return {"losses": [float(x) for x in blk["losses"]], "grads0": blk["grads"],
            "after": blk["after"]}


def judge(ctx: Context, blocks: List[Dict], limits: Dict[str, float], control: bool = False
          ) -> Dict[str, Any]:
    """Every block's numbers and the run's: the largest of each, beside
    its limit.  ``control``: the TF32 reference in the system's place."""
    per_block = []
    worst = {k: 0.0 for k in NUMBERS}
    sound = {k: 0.0 for k in NUMBERS}
    for blk in blocks:
        with R.precision(False):
            ref = follow(ctx, blk)
        sys_r = system_reading(blk)
        if control:
            g0 = gaps(sys_r, ref, block_start(ctx, blk))
            for k in NUMBERS:
                sound[k] = max(sound[k], g0[k] if math.isfinite(g0[k]) else float("inf"))
            with R.precision(True):
                sys_r = follow(ctx, blk)
        g = gaps(sys_r, ref, block_start(ctx, blk))
        per_block.append({"kind": blk["kind"] + ("_coarse" if blk.get("coarse") else "")
                          + ("_start" if blk.get("own") else ""), "k": blk["k"], **g,
                          "loss_sys": sys_r["losses"], "loss_ref": ref["losses"]})
        for k in NUMBERS:
            if not math.isfinite(g[k]):
                g[k] = float("inf")
            worst[k] = max(worst[k], g[k])
    kinds = {b["kind"] for b in per_block}
    complete = any(k.startswith("track") for k in kinds) and any(
        k == "map" for k in kinds) and any(k.endswith("_start") for k in kinds)
    # a number without a limit is reported, not compared (see the configuration's file)
    ok = complete and all(worst[k] <= limits[k] for k in NUMBERS if k in limits)
    out = {"correct": ok, "complete": complete, "numbers": worst, "blocks": per_block}
    if control:
        out["system_numbers"] = sound
    return out
