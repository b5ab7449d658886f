"""Geometry/math core: PyTorch counterpart of the JAX package's
``ops/geometry.py``.

Camera rays, quaternion <-> matrix pose conversion (unnormalized-quaternion
tolerant), inverse-CDF importance sampling (``sample_pdf``), and
scene-bound coordinate normalization.  The volume-rendering integrator
is ``ops/integrator.py``.  Random draws take an explicit
``torch.Generator`` on the tensors' device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Intrinsics
# ---------------------------------------------------------------------------

def as_intrinsics_matrix(intrinsics) -> np.ndarray:
    """3x3 pinhole K from (fx, fy, cx, cy)."""
    fx, fy, cx, cy = intrinsics
    K = np.eye(3)
    K[0, 0] = fx
    K[1, 1] = fy
    K[0, 2] = cx
    K[1, 2] = cy
    return K


# ---------------------------------------------------------------------------
# Quaternion / pose conversions
# ---------------------------------------------------------------------------

def quat_to_rotation(quad: torch.Tensor) -> torch.Tensor:
    """Batched quaternion (w, x, y, z) -> rotation matrix (B, 3, 3).

    Tolerates unnormalized quaternions via the 2/|q|^2 scaling: the
    tracker descends the raw 4-vector without renormalizing."""
    qr, qi, qj, qk = quad[:, 0], quad[:, 1], quad[:, 2], quad[:, 3]
    two_s = 2.0 / torch.sum(quad * quad, dim=-1)
    r00 = 1 - two_s * (qj**2 + qk**2)
    r01 = two_s * (qi * qj - qk * qr)
    r02 = two_s * (qi * qk + qj * qr)
    r10 = two_s * (qi * qj + qk * qr)
    r11 = 1 - two_s * (qi**2 + qk**2)
    r12 = two_s * (qj * qk - qi * qr)
    r20 = two_s * (qi * qk - qj * qr)
    r21 = two_s * (qj * qk + qi * qr)
    r22 = 1 - two_s * (qi**2 + qj**2)
    return torch.stack([
        torch.stack([r00, r01, r02], dim=-1),
        torch.stack([r10, r11, r12], dim=-1),
        torch.stack([r20, r21, r22], dim=-1),
    ], dim=-2)


def pose_from_tensor(inputs: torch.Tensor) -> torch.Tensor:
    """[quat(4), trans(3)] -> 3x4 camera-to-world; (7,) or (B, 7)."""
    single = inputs.dim() == 1
    if single:
        inputs = inputs[None]
    quad, t = inputs[:, :4], inputs[:, 4:]
    RT = torch.cat([quat_to_rotation(quad), t[:, :, None]], dim=-1)
    return RT[0] if single else RT


def rotation_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> quaternion (w, x, y, z), w >= 0.

    Shepperd-style: all four candidate extractions are computed and the
    one with the largest pivot is kept (a gather, so no host sync)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp(x, min=1e-12)) * 2.0

    s = root(tr + 1.0)
    cw = torch.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s], -1)
    s = root(1.0 + m00 - m11 - m22)
    cx = torch.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s], -1)
    s = root(1.0 + m11 - m00 - m22)
    cy = torch.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s], -1)
    s = root(1.0 + m22 - m00 - m11)
    cz = torch.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s], -1)

    cands = torch.stack([cw, cx, cy, cz], dim=-2)              # (..., 4, 4)
    idx = torch.argmax(torch.stack([tr, m00, m11, m22], -1), dim=-1)
    q = torch.gather(cands, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def tensor_from_pose(RT: torch.Tensor) -> torch.Tensor:
    """(..., 3|4, 4) camera matrix -> [quat(4), trans(3)]."""
    return torch.cat([rotation_to_quat(RT[..., :3, :3]), RT[..., :3, 3]], dim=-1)


def c2w44(c2w34: torch.Tensor) -> torch.Tensor:
    """Append the homogeneous bottom row to (..., 3, 4) poses."""
    bottom = torch.zeros(c2w34.shape[:-2] + (1, 4), dtype=c2w34.dtype,
                         device=c2w34.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([c2w34, bottom], dim=-2)


def invert(m: torch.Tensor) -> torch.Tensor:
    """Matrix inverse that never waits for the device (no error check)."""
    return torch.linalg.inv_ex(m)[0]


def linspace(start, stop, num: int, device=None) -> torch.Tensor:
    """``num`` evenly spaced f32 values from ``start`` to ``stop`` (floats
    or 0-dim tensors, read without a host sync), computed as jnp.linspace
    does: start*(1-t) + stop*t with t = i * (1/(num-1)), the last value
    exactly ``stop``.  Bitwise equal to it on [0, 1]; elsewhere within an
    ulp (XLA may fuse the blend differently)."""
    if isinstance(start, torch.Tensor):
        device = start.device
    div = num - 1
    recip = torch.tensor(1.0 / max(div, 1), dtype=torch.float32, device=device)
    t = torch.arange(div, dtype=torch.float32, device=device) * recip
    stop_t = torch.as_tensor(stop, dtype=torch.float32, device=device).reshape(1)
    return torch.cat([start * (1 - t) + stop * t, stop_t])


# ---------------------------------------------------------------------------
# Rays
# ---------------------------------------------------------------------------

def rays_from_uv(i, j, c2w, fx, fy, cx, cy) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel world rays for pixel columns ``i`` / rows ``j`` (the camera
    looks along -Z with +Y up).  c2w: (3|4, 4).  Returns (N, 3) x2."""
    dirs = torch.stack([(i - cx) / fx, -(j - cy) / fy, -torch.ones_like(i)], dim=-1)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def sample_pixels(
    gen: Optional[torch.Generator], H0: int, H1: int, W0: int, W1: int, n: int,
    depth: torch.Tensor, color: torch.Tensor,
):
    """Uniformly sample ``n`` pixels from the crop [H0:H1, W0:W1]
    (duplicates allowed), drawn from ``gen``.  Returns (i=column, j=row,
    depth, color)."""
    ws = W1 - W0
    idx = torch.randint(0, (H1 - H0) * ws, (n,), generator=gen,
                        device=depth.device)
    r = idx // ws + H0
    c = idx % ws + W0
    return c.to(torch.float32), r.to(torch.float32), depth[r, c], color[r, c]


def get_samples(gen, H0, H1, W0, W1, n, fx, fy, cx, cy, c2w, depth, color):
    """Sample n rays + their GT depth/color from an image crop.
    Returns (rays_o, rays_d, depth, color)."""
    i, j, d, c = sample_pixels(gen, H0, H1, W0, W1, n, depth, color)
    rays_o, rays_d = rays_from_uv(i, j, c2w, fx, fy, cx, cy)
    return rays_o, rays_d, d, c


def ray_aabb_far(rays_o: torch.Tensor, rays_d: torch.Tensor,
                 bound: torch.Tensor) -> torch.Tensor:
    """Per-ray scene-box exit distance: min over axes of max(t_lo, t_hi)."""
    t = (bound[None, :, :] - rays_o[:, :, None]) / rays_d[:, :, None]
    return torch.amin(torch.amax(t, dim=2), dim=1)


# ---------------------------------------------------------------------------
# Hierarchical importance sampling
# ---------------------------------------------------------------------------

def uniform(shape, gen: Optional[torch.Generator], device) -> torch.Tensor:
    """Uniform [0, 1) draws of ``shape`` from ``gen``.  A draw without a
    generator raises instead of falling back on PyTorch's global one, as a
    draw without a key fails in the JAX package: a caller that must not
    draw (a ray data-parallel block, whose draws are made before the
    split) passes none."""
    if gen is None:
        raise ValueError("a random draw needs a torch.Generator; none was given")
    return torch.rand(shape, generator=gen, device=device)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, N_samples: int,
               det: bool = False, u: Optional[torch.Tensor] = None,
               gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverse-CDF sampling of ``N_samples`` z-values per ray from bin edges
    ``bins`` (B, M) weighted by ``weights`` (B, M-1), with the 1e-5 weight
    floor and the ``denom < 1e-5`` guard.  The quantiles are
    ``linspace(0, 1)`` with ``det``, else ``u`` (B, N_samples) when given,
    else uniform draws from ``gen``."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (B, M)
    shape = cdf.shape[:-1] + (N_samples,)
    if det:
        u = linspace(0.0, 1.0, N_samples, device=cdf.device).expand(shape)
    elif u is None:
        u = uniform(shape, gen, cdf.device)
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    last = bins.shape[-1] - 1
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, torch.clamp(below, max=last))
    bins_above = torch.gather(bins, -1, torch.clamp(above, max=last))
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


# ---------------------------------------------------------------------------
# Coordinate normalization
# ---------------------------------------------------------------------------

def normalize_3d_coordinate(p: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """World coords (..., 3) -> [-1, 1]^3 w.r.t. the (3, 2) scene AABB."""
    lo = bound[:, 0]
    hi = bound[:, 1]
    return (p - lo) / (hi - lo) * 2.0 - 1.0
