"""What the timed path produced, kept for the comparison: single tracking
or mapping iterations ("blocks"), each with the state it started from.

Wrappers around the system's own functions (installed from here; the
system is not edited):

  * ``slam.slam.track_frame_sampled``: a tracked frame's inputs (the map it
    reads, its pixels) and, from its results, each iteration's loss and
    post-step camera;
  * ``slam.mapper.optimize_map_core``: a mapping call's window and, from
    its results, each iteration's loss;
  * ``slam.mapper.mapping_loss``: within a block, the pixel indices (and a
    density model's free-space jitter) drawn exactly as the function draws
    them, from the same generator in the same order, then handed to it;
    the trained leaves at the block's start;
  * ``slam.optim.GroupAdam.step``: the optimiser's moments and step counts
    before the block's first step, the gradients that step receives, the
    parameters after the block's last.

Whether a call is kept is asked of ``want(kind, info)`` (the harness,
from the seed), for every call: ``info`` holds the call's iterations and
its rays per iteration (and, for a mapping call, whether it is the
coarse mapper's and the model's family), which the harness also counts
work from.  It returns the block's first iteration, or a dict of ``k``
and tags for the block, or None.  All
copies stay on the device and nothing waits for it.
"""

from __future__ import annotations

import inspect
import threading
from typing import Any, Callable, Dict, List, Optional

import torch

from slambench.weights import flatten

BLOCK = 1  # iterations a block follows


def _clone_named(groups: Dict[str, Any]) -> Dict[str, List]:
    """group -> [(name, clone)] in the optimiser's leaf order."""
    return {g: [(f"{g}/{n}" if n else g, t.detach().clone()) for n, t in flatten(tree)]
            for g, tree in groups.items()}


def _asked(answer):
    if isinstance(answer, dict):
        return answer["k"], {k: v for k, v in answer.items() if k != "k"}
    return answer, {}


class Recorder:
    def __init__(self, want: Callable[[str, Dict], Optional[int]]):
        self.want = want
        self.blocks: List[Dict[str, Any]] = []
        self.local = threading.local()
        self._saved = []

    # -- installation ------------------------------------------------------
    def install(self) -> None:
        import nice_slam_torch.slam.mapper as M
        import nice_slam_torch.slam.optim as O
        import nice_slam_torch.slam.slam as S

        self._saved = [(S, "track_frame_sampled", S.track_frame_sampled),
                       (M, "optimize_map_core", M.optimize_map_core),
                       (M, "mapping_loss", M.mapping_loss),
                       (O.GroupAdam, "step", O.GroupAdam.step)]
        S.track_frame_sampled = self._track(S.track_frame_sampled)
        core_sig = inspect.signature(M.optimize_map_core)
        M.optimize_map_core = self._core(M.optimize_map_core, core_sig)
        M.mapping_loss = self._loss(M.mapping_loss)
        O.GroupAdam.step = self._step(O.GroupAdam.step)

    def uninstall(self) -> None:
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved = []

    # -- tracking ------------------------------------------------------------
    def _track(self, orig):
        def track_frame_sampled(spec, state, init_tensor, pi, pj, pd, pc, tcfg, rcfg):
            k, tags = _asked(self.want("track", {"iters": tcfg.iters, "rays": int(pi.shape[-1])}))
            if k is None:
                return orig(spec, state, init_tensor, pi, pj, pd, pc, tcfg, rcfg)
            blk = {**tags, "kind": "track", "k": k, "state": state, "steps_seen": 0,
                   "pix": tuple(a[k:k + BLOCK] for a in (pi, pj, pd, pc)),
                   "init": init_tensor.detach().clone()}
            self.local.ctx = blk
            try:
                out = orig(spec, state, init_tensor, pi, pj, pd, pc, tcfg, rcfg)
            finally:
                self.local.ctx = None
            cand, losses, cams, _ = out
            blk["losses"] = losses[k:k + BLOCK].clone()
            blk["start"] = {"cam": (blk["init"] if k == 0 else cams[k - 1]).clone()}
            blk["after"] = {"cam": cams[k + BLOCK - 1].clone()}
            if "adam" in blk:
                self.blocks.append(blk)
            return out
        return track_frame_sampled

    # -- mapping -------------------------------------------------------------
    def _core(self, orig, sig):
        def optimize_map_core(*args, **kwargs):
            a = sig.bind(*args, **kwargs)
            a.apply_defaults()
            a = a.arguments
            mcfg = a["mcfg"]
            n_iters = sum(n for _, n in a["stage_plan"])
            info = {"iters": n_iters, "coarse": mcfg.coarse_mapper, "nice": mcfg.nice,
                    "rays": int(a["colors"].shape[0]) * int(a["pixs_per_image"])}
            k, tags = _asked(self.want("map", info))
            if k is None or a["pix_idx"] is not None or a["devices"]:
                return orig(*args, **kwargs)
            blk = {**tags, "kind": "map", "k": k, "coarse": mcfg.coarse_mapper, "steps_seen": 0,
                   "loss_seen": 0, "state": a["state"], "lr_factor": float(a["lr_factor"]),
                   "pix": [], "reg_t": [],
                   "win": {"colors": a["colors"], "depths": a["depths"],
                           "fixed_c2w": a["fixed_c2w"], "opt_mask": a["opt_cam_mask"],
                           "frame_valid": a["frame_valid"]}}
            self.local.ctx = blk
            try:
                out = orig(*args, **kwargs)
            finally:
                self.local.ctx = None
            blk["losses"] = out[2][k:k + BLOCK].clone()
            if "adam" in blk and "after" in blk:
                self.blocks.append(blk)
            return out
        return optimize_map_core

    def _loss(self, orig):
        def mapping_loss(spec, groups, base_state, colors, depths, fixed_c2w, opt_cam_mask,
                         frame_valid, stage, mcfg, rcfg, pixs_per_image, pix_idx=None,
                         gen=None, reg_t=None, devices=None):
            blk = getattr(self.local, "ctx", None)
            if blk is not None and blk["kind"] == "map":
                i = blk["loss_seen"]
                blk["loss_seen"] += 1
                if blk["k"] <= i < blk["k"] + BLOCK:
                    if pix_idx is None:  # as mapping_loss draws them
                        pix_idx = torch.randint(0, mcfg.H * mcfg.W,
                                                (colors.shape[0], pixs_per_image),
                                                generator=gen, device=colors.device)
                    if not mcfg.occupancy and reg_t is None:  # as regulation draws it
                        reg_t = torch.rand((colors.shape[0] * pixs_per_image, rcfg.N_samples),
                                           generator=gen, device=colors.device)
                    blk["pix"].append(pix_idx)
                    blk["reg_t"].append(reg_t)
                    blk["stages"] = blk.get("stages", ()) + (stage,)
                    if i == blk["k"]:
                        blk["groups"] = _clone_named(groups)
            return orig(spec, groups, base_state, colors, depths, fixed_c2w, opt_cam_mask,
                        frame_valid, stage, mcfg, rcfg, pixs_per_image, pix_idx, gen, reg_t,
                        devices)
        return mapping_loss

    # -- the optimiser -----------------------------------------------------------
    def _step(self, orig):
        rec = self

        def step(self, grads, lrs, active, masks=None):
            blk = getattr(rec.local, "ctx", None)
            if blk is None:
                return orig(self, grads, lrs, active, masks)
            i = blk["steps_seen"]
            blk["steps_seen"] += 1
            k = blk["k"]
            if i == k:
                names = ({"p": ["cam"]} if blk["kind"] == "track" else
                         {g: [n for n, _ in v] for g, v in blk["groups"].items()})
                blk["names"] = names
                blk["adam"] = {n: (m.clone(), v.clone())
                               for g in self.params for n, m, v in
                               zip(names[g], self.mu[g], self.nu[g])}
                blk["adam_steps"] = dict(self.steps)
                blk["grads"] = {n: (None if x is None else x.clone())
                                for g in grads for n, x in zip(names[g], grads[g])}
            out = orig(self, grads, lrs, active, masks)
            if i == k + BLOCK - 1 and "names" in blk:
                names = blk["names"]
                blk["after_params"] = {n: p.detach().clone() for g in self.params
                                       for n, p in zip(names[g], self.params[g])}
                blk["after"] = blk["after_params"]
            return out
        return step
