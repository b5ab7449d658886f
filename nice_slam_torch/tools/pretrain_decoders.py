"""Self-pretraining recipe for the hierarchical decoders; the port's
counterpart of the JAX package's ``tools/pretrain_decoders.py``.

The reference consumes ConvONet decoder checkpoints (pretrained/coarse.pt,
pretrained/middle_fine.pt; reference src/NICE_SLAM.py:159-190).  This
tool reproduces them from scratch: it meta-trains the coarse, middle and
fine decoders into a geometric occupancy prior over procedurally
generated rooms, then exports them with the key scheme the loader
expects (the middle decoder under 'decoder.coarse_*', the fine one under
'decoder.fine_*': the reference's historical naming).

Protocol (episodic): per scene, fresh feature grids (fast weights) and
the shared decoders are fit jointly to analytic occupancy samples of a
random room (walls plus random boxes and spheres), one stage after the
other; only the decoders carry over to the next scene.

Each Adam step is one lookup Function: one K1 forward and one K2
backward (the points take no gradient, so no K3).  The fine stage reads
the fine and the middle grid in that one K1 launch; the middle feature
is detached, so K2 writes the fine grid's gradient only.  A scene's
points and occupancy are drawn with numpy on the host (the JAX tool's
draws, bit for bit) and copied to the device once per scene.

CLI: python -m nice_slam_torch.tools.pretrain_decoders --out pretrained
     [--scenes 40] [--steps 300] [--samples 4096] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Tuple

import numpy as np
import torch

from nice_slam_torch.models import decoders as D
from nice_slam_torch.models import grids as G
from nice_slam_torch.slam.optim import GroupAdam, tree_leaves, tree_map
from nice_slam_torch.utils.logger import _mlp_to_state_dict

STAGES = ("coarse", "middle", "fine")
SPEC = D.NICESpec(c_dim=32, hidden_size=32, coarse=True)
GRID_SHAPES = {"grid_coarse": (6, 6, 6), "grid_middle": (19, 19, 19),
               "grid_fine": (38, 38, 38)}
BOUND = np.array([[-3.0, 3.0]] * 3, np.float32)
LR_DEC = 5e-4
LR_GRID = 5e-2


# ---------------------------------------------------------------------------
# Procedural occupancy worlds (numpy, in the JAX tool's draw order)
# ---------------------------------------------------------------------------

def random_scene(rng: np.random.Generator):
    """A room with random inner boxes and spheres; returns the parameters
    of the analytic occupancy function."""
    half = rng.uniform(1.5, 2.5, size=3)
    n_obj = rng.integers(2, 6)
    boxes = []
    spheres = []
    for _ in range(n_obj):
        c = rng.uniform(-0.6, 0.6, size=3) * half
        if rng.random() < 0.5:
            e = rng.uniform(0.2, 0.7, size=3)
            boxes.append((c, e))
        else:
            r = rng.uniform(0.2, 0.6)
            spheres.append((c, r))
    return half, boxes, spheres


def occupancy_of(points: np.ndarray, half, boxes, spheres) -> np.ndarray:
    """1 where occupied (outside the room's walls or inside an object)."""
    occ = np.any(np.abs(points) > half, axis=-1)
    for c, e in boxes:
        occ |= np.all(np.abs(points - c) < e, axis=-1)
    for c, r in spheres:
        occ |= np.linalg.norm(points - c, axis=-1) < r
    return occ.astype(np.float32)


# ---------------------------------------------------------------------------
# Episodic training
# ---------------------------------------------------------------------------

def fit_step(dec_params, grid: torch.Tensor, middle_grid, opt: GroupAdam,
             pts: torch.Tensor, occ_gt: torch.Tensor, bound: torch.Tensor,
             sub: D.MLPSpec, concat_middle: bool) -> torch.Tensor:
    """One joint decoder + grid Adam step on occupancy supervision, in
    place on the leaves of ``opt`` (groups 'dec' and 'grid', which must
    require grad).  Returns the step's loss (pre-update), on the device."""
    grids = {"grid_" + sub.name: grid}
    if concat_middle:
        grids["grid_middle"] = middle_grid.detach()
    if sub.no_xyz:
        logit = D.apply_mlp_no_xyz(dec_params, sub, pts, grids, bound)
    else:
        logit = D.apply_mlp(dec_params, sub, pts, grids, bound)
    prob = torch.sigmoid(10.0 * logit)
    loss = torch.mean((prob - occ_gt) ** 2)
    n_dec = len(opt.params["dec"])
    grads = torch.autograd.grad(loss, opt.params["dec"] + opt.params["grid"],
                                allow_unused=True)
    opt.step({"dec": list(grads[:n_dec]), "grid": list(grads[n_dec:])},
             {"dec": LR_DEC, "grid": LR_GRID}, {"dec": True, "grid": True})
    return loss.detach()


def init_decoders(seed: int, device="cuda") -> Dict[str, dict]:
    """The coarse, middle and fine decoders, drawn on the CPU from
    ``seed`` and moved to ``device`` (one seed gives one init on every
    device)."""
    gen = G.make_generator(seed, torch.device("cpu"))
    dec = D.init_nice(gen, SPEC, "cpu")
    return {k: tree_map(lambda x: x.to(device), dec[k]) for k in STAGES}


def pretrain(scenes: int, steps: int, samples: int, seed: int = 0,
             verbose: bool = True, device="cuda") -> Tuple[Dict[str, dict], np.ndarray]:
    """Train the decoders over ``scenes`` random rooms, ``steps`` Adam
    steps of ``samples`` points per stage.  Returns ({coarse, middle,
    fine} decoder parameters, the losses of every step as (scenes, 3,
    steps) float32)."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    subs = SPEC.sub_specs()
    dec = init_decoders(seed, device)
    grid_gen = G.make_generator(seed + 1, torch.device("cpu"))
    bound = torch.as_tensor(BOUND, device=device)
    losses = np.zeros((scenes, len(STAGES), steps), np.float32)

    for s in range(scenes):
        t0 = time.perf_counter()
        half, boxes, spheres = random_scene(rng)
        grids = {k: v.to(device)
                 for k, v in G.init_grids(grid_gen, GRID_SHAPES, SPEC.c_dim, "cpu").items()}
        pts_np = rng.uniform(BOUND[:, 0], BOUND[:, 1],
                             size=(steps, samples, 3)).astype(np.float32)
        occ_np = np.stack([occupancy_of(pts_np[i], half, boxes, spheres)
                           for i in range(steps)])
        pts_all = torch.as_tensor(pts_np, device=device)
        occ_all = torch.as_tensor(occ_np, device=device)

        for k, name in enumerate(STAGES):
            grid = grids["grid_" + name].requires_grad_(True)
            d_params = dec[name]
            for leaf in tree_leaves(d_params):
                leaf.requires_grad_(True)
            opt = GroupAdam({"dec": d_params, "grid": grid})
            stage_losses = []
            for i in range(steps):
                stage_losses.append(fit_step(
                    d_params, grid, grids["grid_middle"], opt, pts_all[i],
                    occ_all[i], bound, subs[name], name == "fine"))
            losses[s, k] = torch.stack(stage_losses).cpu().numpy()
            grid.requires_grad_(False)
            for leaf in tree_leaves(d_params):
                leaf.requires_grad_(False)
        if verbose:
            print(f"scene {s + 1}/{scenes} losses "
                  + " ".join(f"{n}={losses[s, k, -1]:.4f}" for k, n in enumerate(STAGES))
                  + f" ({time.perf_counter() - t0:.2f} s)", flush=True)
    return dec, losses


def export_torch(dec, out_dir: str) -> None:
    """Write coarse.pt / middle_fine.pt with the reference's key scheme."""
    os.makedirs(out_dir, exist_ok=True)
    coarse_sd = {"decoder." + k: v
                 for k, v in _mlp_to_state_dict(dec["coarse"], "").items()}
    torch.save({"model": coarse_sd}, os.path.join(out_dir, "coarse.pt"))

    mf_sd = {}
    for k, v in _mlp_to_state_dict(dec["middle"], "").items():
        mf_sd["decoder.coarse_" + k] = v  # historical ConvONet naming
    for k, v in _mlp_to_state_dict(dec["fine"], "").items():
        mf_sd["decoder.fine_" + k] = v
    torch.save({"model": mf_sd}, os.path.join(out_dir, "middle_fine.pt"))
    print(f"wrote {out_dir}/coarse.pt and {out_dir}/middle_fine.pt")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Self-pretrain the hierarchical occupancy decoders.")
    p.add_argument("--out", type=str, default="pretrained")
    p.add_argument("--scenes", type=int, default=40)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--samples", type=int, default=4096)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    t0 = time.perf_counter()
    dec, _ = pretrain(args.scenes, args.steps, args.samples, args.seed,
                      device=args.device)
    seconds = time.perf_counter() - t0
    steps = args.scenes * len(STAGES) * args.steps
    print(f"{steps} steps in {seconds:.1f} s ({steps / seconds:.1f} steps/s)")
    export_torch(dec, args.out)


if __name__ == "__main__":
    main()
