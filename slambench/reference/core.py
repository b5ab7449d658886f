"""Plain PyTorch reference of one tracking or mapping iteration of the
system under test, written from the published method (NICE-SLAM, Zhu et
al., CVPR 2022; its iMAP* variant) and the configuration's own keys.

Float32 throughout; ``precision`` switches the matrix products between
float32 and TF32 (the control).  Nothing here imports the program: grid
lookups are ``torch.nn.functional.grid_sample`` (trilinear, border
padding, corners aligned), the decoders are chains of dense products, the
integrator is the cumulative product of NeRF, the pixel depth test of the
frustum selection is a bilinear ``grid_sample`` with zero padding, and
Adam is written out.  A model module (``nice.py``, ``imap.py``) gives
``raw(params, p, stage, bound, coarse_bound)`` -> (N, 4) rgb + occupancy
(or density).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products in float32 (``tf32`` false) or TF32, restored after."""
    keep = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = keep


# ---------------------------------------------------------------------------
# Cameras and rays
# ---------------------------------------------------------------------------

def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion (w, x, y, z), not necessarily of unit length ->
    (..., 3, 3) rotation, scaled by 2 / |q|^2 as the method's pose tensor
    is optimised without renormalising."""
    w, x, y, z = q.unbind(-1)
    s = 2.0 / (q * q).sum(-1)
    rows = [[1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)],
            [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)],
            [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def pose(t: torch.Tensor) -> torch.Tensor:
    """(..., 7) [quaternion, translation] -> (..., 3, 4) camera-to-world."""
    return torch.cat([quat_to_rot(t[..., :4]), t[..., 4:, None]], -1)


def camera_dirs(i: torch.Tensor, j: torch.Tensor, cam: Dict[str, float]) -> torch.Tensor:
    """Directions in the camera frame of pixel columns ``i`` and rows
    ``j`` (the camera looks along -z with y up)."""
    return torch.stack([(i - cam["cx"]) / cam["fx"], -(j - cam["cy"]) / cam["fy"],
                        -torch.ones_like(i)], -1)


def box_exit(o: torch.Tensor, d: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """Distance along each ray to where it leaves the (3, 2) box."""
    t = (bound[None] - o[:, :, None]) / d[:, :, None]
    return t.amax(-1).amin(-1)


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

def lookup(grid: torch.Tensor, p: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """Trilinear features (N, C) of a channels-last (X, Y, Z, C) grid
    spanning ``bound`` at world points (N, 3): border padding, the corner
    nodes on the box's faces."""
    pn = (p - bound[:, 0]) / (bound[:, 1] - bound[:, 0]) * 2.0 - 1.0
    g = grid.permute(3, 2, 1, 0)[None]
    out = F.grid_sample(g, pn[None, :, None, None, :], mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out[0, :, :, 0, 0].t()


def mlp(P: Dict[str, torch.Tensor], prefix: str, p: torch.Tensor,
        feat: Optional[torch.Tensor], n_blocks: int, skips=(2,),
        lead: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A point decoder: Gaussian Fourier features sin(p B) (or ``lead``),
    blocks relu(h W + b) each followed by + feat Wc + bc where there is a
    feature, [lead, h] after each block in ``skips``, a linear head."""
    emb = torch.sin(p @ P[prefix + "embedder_B"]) if lead is None else lead
    h = emb
    for k in range(n_blocks):
        h = torch.relu(h @ P[f"{prefix}pts_linears/{k}/w"] + P[f"{prefix}pts_linears/{k}/b"])
        if feat is not None:
            h = h + (feat @ P[f"{prefix}fc_c/{k}/w"] + P[f"{prefix}fc_c/{k}/b"])
        if k in skips:
            h = torch.cat([emb, h], -1)
    return h @ P[prefix + "output_linear/w"] + P[prefix + "output_linear/b"]


def outside_occupied(raw: torch.Tensor, p: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """Column 3 set to 100 (occupied) at points not strictly inside the box."""
    inside = ((p > bound[:, 0]) & (p < bound[:, 1])).all(-1)
    occ = torch.where(inside, raw[:, 3], torch.full_like(raw[:, 3], 100.0))
    return torch.cat([raw[:, :3], occ[:, None]], -1)


def integrate(raw: torch.Tensor, z: torch.Tensor, d: torch.Tensor, occupancy: bool):
    """NeRF's integrator along (N, S) samples: (depth, depth variance, rgb,
    weights).  Occupancy: alpha = sigmoid(10 o); density: alpha = 1 -
    exp(-relu(sigma) dz |d|) with a 1e10 last interval."""
    if occupancy:
        alpha = torch.sigmoid(10.0 * raw[..., 3])
    else:
        dz = z[..., 1:] - z[..., :-1]
        dz = torch.cat([dz, torch.full_like(dz[..., :1], 1e10)], -1)
        alpha = 1.0 - torch.exp(-torch.relu(raw[..., 3]) * dz * d.norm(dim=-1, keepdim=True))
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]),
                                     1.0 - alpha + 1e-10], -1), -1)[..., :-1]
    w = alpha * trans
    depth = (w * z).sum(-1)
    var = (w * (z - depth[..., None]) ** 2).sum(-1)
    rgb = (w[..., None] * raw[..., :3]).sum(-2)
    return depth, var, rgb, w


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n: int) -> torch.Tensor:
    """Deterministic inverse-CDF samples (quantiles evenly spaced in
    [0, 1]) of bin edges (B, M) weighted (B, M - 1), weights floored by
    1e-5, a near-empty bin's denominator taken as 1."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], -1)
    u = torch.linspace(0.0, 1.0, n, device=bins.device).expand(cdf.shape[0], n).contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (inds - 1).clamp(min=0)
    above = inds.clamp(max=cdf.shape[-1] - 1)
    cb, ca = cdf.gather(-1, below), cdf.gather(-1, above)
    last = bins.shape[-1] - 1
    bb, ba = bins.gather(-1, below.clamp(max=last)), bins.gather(-1, above.clamp(max=last))
    denom = torch.where(ca - cb < 1e-5, torch.ones_like(ca), ca - cb)
    return bb + (u - cb) / denom * (ba - bb)


def render(raw_fn: Callable, o: torch.Tensor, d: torch.Tensor, stage: str,
           gd: Optional[torch.Tensor], rcfg: Dict, bound: torch.Tensor,
           occupancy: bool):
    """(depth, depth variance, rgb) of rays (o, d): N_samples evenly spaced
    in [near, far] (far: the box exit + 0.01, with sensor depth clamped to
    1.2 x the batch's largest), N_surface more in [0.95, 1.05] x depth,
    and with N_importance the second pass of inverse-CDF samples placed
    by a first, gradient-free pass.  No depth at the coarse stage."""
    if float(rcfg["perturb"]) != 0.0:
        raise ValueError("the reference renders with perturb 0, as configured")
    Ns, Nsurf, Nimp = rcfg["N_samples"], rcfg["N_surface"], rcfg["N_importance"]
    if stage == "coarse":
        gd = None
    dev = o.device
    far = box_exit(o.detach(), d.detach(), bound)[:, None] + 0.01
    if gd is None:
        Nsurf = 0
        near = 0.01
    else:
        gd = gd[:, None]
        near = 0.01 * gd
        dmax = gd.max()
        far = torch.minimum(far.clamp(min=0.0), dmax * 1.2)
    t = torch.linspace(0.0, 1.0, Ns, device=dev)
    z = near * (1.0 - t) + far * t
    if Nsurf > 0:
        ts = torch.linspace(0.0, 1.0, Nsurf, device=dev)
        zs = torch.where(gd > 0.0, 0.95 * gd * (1.0 - ts) + 1.05 * gd * ts,
                         0.001 * (1.0 - ts) + dmax * ts)
        z = torch.sort(torch.cat([z, zs], -1), -1).values
    z = z.detach()

    def integ(z):
        pts = o[:, None, :] + d[:, None, :] * z[..., None]
        raw = raw_fn(pts.reshape(-1, 3), stage).reshape(z.shape[0], z.shape[1], 4)
        return integrate(raw, z, d, occupancy)

    if Nimp > 0:
        with torch.no_grad():
            w = integ(z)[3]
            zi = sample_pdf(0.5 * (z[:, 1:] + z[:, :-1]), w[:, 1:-1], Nimp)
        z = torch.sort(torch.cat([z, zi], -1), -1).values
    return integ(z)[:3]


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def tracking_loss(raw_fn, cam_t, i, j, dgt, cgt, cfg, bound) -> torch.Tensor:
    """One tracking iteration's loss at camera tensor ``cam_t`` (7,) on
    pixels (column i, row j) with sensor depth and colour: depth L1 over
    sqrt(variance), colour L1 weighted, over rays with depth that end
    inside the box (NICE) and, with ``handle_dynamic``, whose term is below
    10 x the lower median of those rays'."""
    t, cam = cfg["tracking"], cfg["camera"]
    c2w = pose(cam_t)
    d = camera_dirs(i, j, cam) @ c2w[:3, :3].t()
    o = c2w[:3, 3].expand(d.shape)
    if cfg["model"] == "nice":
        inside = box_exit(o, d, bound).detach() >= dgt
    else:
        inside = torch.ones_like(dgt, dtype=torch.bool)
    depth, var, color = render(raw_fn, o, d, "color", dgt, cfg["rendering"], bound,
                               cfg["occupancy"])
    tmp = (dgt - depth).abs() / torch.sqrt(var.detach() + 1e-10)
    mask = dgt > 0
    if t["handle_dynamic"]:
        vals = torch.sort(tmp.detach()[inside]).values
        med = vals[max((vals.numel() - 1) // 2, 0)] if vals.numel() else torch.tensor(
            float("inf"), device=dgt.device)
        mask = mask & (tmp.detach() < 10.0 * med)
    mask = mask & inside
    loss = torch.where(mask, tmp, torch.zeros_like(tmp)).sum()
    if t["use_color_in_tracking"]:
        cd = (cgt - color).abs()
        loss = loss + t["w_color_loss"] * torch.where(mask[:, None], cd, torch.zeros_like(cd)).sum()
    return loss


def mapping_loss(raw_fn, cams: Optional[torch.Tensor], win: Dict, stage: str,
                 pix_idx: torch.Tensor, reg_t: Optional[torch.Tensor], cfg,
                 bound: torch.Tensor, coarse: bool) -> torch.Tensor:
    """One mapping iteration's loss over the window ``win`` (colors (F, H,
    W, 3), depths (F, H, W), fixed_c2w (F, 4, 4), opt_mask (F,),
    frame_valid (F,)) at flat pixel indices (F, n): depth L1 over rays with
    depth inside the box, colour L1 at the colour stage (always for
    iMAP*), and for a density model 5e-4 x sum |sigma| at free-space
    samples jittered by ``reg_t``."""
    cam, m = cfg["camera"], cfg["mapping"]
    fixed = win["fixed_c2w"][:, :3, :]
    if cams is not None:
        mk = win["opt_mask"][:, None, None]
        c2ws = mk * pose(cams) + (1.0 - mk) * fixed
    else:
        c2ws = fixed
    Fn, n = pix_idx.shape
    r, c = pix_idx // cam["W"], pix_idx % cam["W"]
    dirs = camera_dirs(c.to(torch.float32), r.to(torch.float32), cam)
    d = torch.einsum("fnk,fjk->fnj", dirs, c2ws[:, :3, :3]).reshape(-1, 3)
    o = c2ws[:, None, :3, 3].expand(Fn, n, 3).reshape(-1, 3)
    f = torch.arange(Fn, device=pix_idx.device)[:, None]
    gd = win["depths"][f, r, c].reshape(-1)
    gc = win["colors"][f, r, c].reshape(-1, 3)
    nice = cfg["model"] == "nice"
    if nice:
        inside = box_exit(o, d, bound).detach() >= gd
    else:
        inside = torch.ones_like(gd, dtype=torch.bool)
    inside = inside & win["frame_valid"].repeat_interleave(n)
    depth, _, color = render(raw_fn, o, d, stage, None if coarse else gd,
                             cfg["rendering"], bound, cfg["occupancy"])
    dd = (gd - depth).abs()
    loss = torch.where((gd > 0) & inside, dd, torch.zeros_like(dd)).sum()
    if not nice or stage == "color":
        cd = (gc - color).abs()
        loss = loss + m["w_color_loss"] * torch.where(inside[:, None], cd, torch.zeros_like(cd)).sum()
    if not cfg["occupancy"]:
        # the free-space samples lie at d + o z, z in [0, 0.85 depth]: the
        # system passes the ray's direction and origin to its regulariser
        # in that order (its docs say so)
        Ns = cfg["rendering"]["N_samples"]
        tv = torch.linspace(0.0, 1.0, Ns, device=gd.device)
        zr = (0.85 * gd[:, None]) * tv
        mids = 0.5 * (zr[:, 1:] + zr[:, :-1])
        upper = torch.cat([mids, zr[:, -1:]], -1)
        lower = torch.cat([zr[:, :1], mids], -1)
        zr = lower + (upper - lower) * reg_t
        pts = d[:, None, :] + o[:, None, :] * zr[..., None]
        sigma = raw_fn(pts.reshape(-1, 3), stage)[:, 3]
        loss = loss + 0.0005 * sigma.abs().sum()
    return loss


# ---------------------------------------------------------------------------
# Optimiser and frustum selection
# ---------------------------------------------------------------------------

def adam_step(p: torch.Tensor, g: Optional[torch.Tensor], m: torch.Tensor,
              v: torch.Tensor, t: int, lr, mask: Optional[torch.Tensor] = None) -> None:
    """Adam's update of ``p`` in place at step ``t`` (1-based), the gradient
    multiplied by ``mask`` (one value per grid node) first."""
    b1, b2 = ADAM_BETAS
    g = torch.zeros_like(p) if g is None else g
    if mask is not None:
        g = g * mask
    m.mul_(b1).add_(g, alpha=1.0 - b1)
    v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
    bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    with torch.no_grad():
        p.sub_(lr * (m / bc1) / ((v / bc2).sqrt() + ADAM_EPS))


def frustum_mask(c2w: torch.Tensor, depth: torch.Tensor, bound: torch.Tensor, shape,
                 cam: Dict) -> torch.Tensor:
    """(X, Y, Z, 1) float mask of the grid nodes the camera sees: in the
    image with 0 <= camera depth <= sensor depth + 0.5 (sensor depth
    bilinear, 0 outside the image, a 0 replaced by the grid's largest), or
    within 0.5 m of the camera."""
    H, W = depth.shape
    axes = [torch.linspace(float(bound[a, 0]), float(bound[a, 1]), n, device=depth.device)
            for a, n in enumerate(shape)]
    pts = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    w2c = torch.linalg.inv(c2w)
    pc = pts @ w2c[:3, :3].t() + w2c[:3, 3]
    zc = pc[:, 2] + 1e-5
    u = (cam["fx"] * (-pc[:, 0]) + cam["cx"] * pc[:, 2]) / zc
    v = (cam["fy"] * pc[:, 1] + cam["cy"] * pc[:, 2]) / zc
    grid = torch.stack([2.0 * u / (W - 1) - 1.0, 2.0 * v / (H - 1) - 1.0], -1)
    dz = F.grid_sample(depth[None, None], grid[None, None], mode="bilinear",
                       padding_mode="zeros", align_corners=True)[0, 0, 0]
    dz = torch.where(dz == 0.0, dz.max(), dz)
    in_img = (u < W) & (u > 0) & (v < H) & (v > 0)
    seen = in_img & (-zc >= 0.0) & (-zc <= dz + 0.5)
    near = ((pts - c2w[:3, 3]) ** 2).sum(-1) < 0.25
    return (seen | near).reshape(*shape, 1).to(torch.float32)
