"""Operations and bytes of the models' work, from the shapes the
configuration fixes, and the peaks they are set against (``peaks.json``).

``dec_work``: multiply-adds per point of a NICE decoder call's forward and
backward at true widths (the 93-wide Fourier lead, 93 + 32 after the
skip, 32- or 64-wide injected features; no padding); the backward counts
the forward it recomputes, every hidden input's gradient, the lead's
where the points or the Fourier matrix need it, the primary feature's
through the injections, and each weight's gradient once for a decoder
that trains.  ``imap_ray_flops``: floating-point operations per ray of
an iMAP* iteration: the importance pass forward only, the merged samples
forward and backward (twice the forward with weight gradients, the
mapper's; once without, the tracker's), the mapper's free-space samples
forward and backward.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Sequence

HERE = os.path.dirname(os.path.abspath(__file__))


def peaks() -> Dict[str, float]:
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)


def dec_work(w: Dict, c: int, decs: Sequence, need_p: bool, need_f: Sequence[bool],
             need_w: Sequence[bool]):
    """(forward, backward) multiply-adds per point; ``decs`` carry ``emb``,
    ``feat``, ``feat2``, ``fc``, ``out`` as the decoder call names them,
    ``w`` the widths (hidden, embed)."""
    H, E = w["hidden"], w["embed"]
    fwd = bwd = 0
    for i, d in enumerate(decs):
        L = E if d.emb else c
        f = 0 if not d.fc else c * (2 if d.feat2 >= 0 else 1)
        emb = 3 * E if d.emb else 0
        one = L * H + 3 * H * H + (L + H) * H + 5 * f * H + H * d.out + emb
        fwd += one
        lead = (need_p or need_w[i]) if d.emb else need_f[d.feat]
        feat = d.fc and need_f[d.feat]
        if need_w[i] or lead or feat:
            bwd += (one + H * d.out + 4 * H * H + (2 * L * H + emb if lead else 0)
                    + (5 * c * H if feat else 0) + (one if need_w[i] else 0))
    return fwd, bwd


def dec_bytes(c: int, decs: Sequence, n_feats: int, need_p: bool, need_f: Sequence[bool],
              backward: bool) -> int:
    """Bytes per point a decoder call must move: points, features and the
    (N, 4) output forward; backward the points, features and the output's
    gradient in, the points' and the features' gradients out."""
    fwd = 12 + 4 * c * n_feats + 16
    if not backward:
        return fwd
    return fwd + 12 + 4 * c * n_feats + 16 + (12 if need_p else 0) + 4 * c * sum(need_f)


def imap_point_flops(w: Dict) -> int:
    """Forward operations of the iMAP* MLP on one point."""
    H, E, B = w["hidden"], w["embed"], w["n_blocks"]
    return 2 * (3 * E + E * H + (B - 1) * H * H + H * w["out"])


def imap_ray_flops(w: Dict, samples: int, importance: int, reg_samples: int,
                   mapping: bool) -> int:
    bwd = 2 if mapping else 1
    per_ray = samples + (1 + bwd) * (samples + importance)
    if mapping:
        per_ray += 3 * reg_samples
    return per_ray * imap_point_flops(w)


def imap_flops(conf: Dict, calls: Sequence) -> float:
    """The iMAP* MLP's operations over ``calls`` ((kind, info) as the
    harness keeps them): iterations x rays x the operations of a ray; 0
    for another model."""
    if conf["model"] != "imap":
        return 0.0
    w, rc = conf["widths"], conf["config"]["rendering"]
    total = 0.0
    for kind, info in calls:
        mapping = kind == "map"
        total += info["iters"] * info["rays"] * imap_ray_flops(
            w, rc["N_samples"], rc["N_importance"], rc["N_samples"] if mapping else 0, mapping)
    return total
