"""The camera stream: the procedural box room, rendered on the device.

A camera circles the room's centre at a quarter of its smallest extent
(height wobbling by a tenth of that radius at twice the rate), looking
outward; depth is the analytic distance to where the ray leaves the box,
colour a wall gradient plus a 0.5 m checker, as the system's own
synthetic reader draws them.  A run renders a ring of ``ring`` frames
``step`` radians apart from a start angle drawn from the seed, keeps
them in host memory, and replays the ring forward and then back, so the
stream never runs dry and the motion stays continuous.  Depth and the
camera's translation are multiplied by the configuration's ``scale``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch


def orbit_pose(room: np.ndarray, ang: float) -> np.ndarray:
    """(4, 4) float32 camera-to-world at orbit angle ``ang`` (radians)."""
    center = room.mean(axis=1)
    radius = 0.25 * float(np.min(room[:, 1] - room[:, 0]))
    eye = center + radius * np.array([np.cos(ang), 0.1 * np.sin(2 * ang), np.sin(ang)],
                                     dtype=np.float32)
    view = (eye - center) / np.linalg.norm(eye - center)
    up = np.array([0.0, 1.0, 0.0], dtype=np.float32)
    zaxis = -view
    xaxis = np.cross(up, zaxis)
    xaxis /= np.linalg.norm(xaxis)
    yaxis = np.cross(zaxis, xaxis)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = xaxis, yaxis, zaxis, eye
    return c2w


def render_frame(room: torch.Tensor, c2w: torch.Tensor, cam: Dict
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(color (H, W, 3), depth (H, W)) of the bare box room seen from c2w."""
    H, W = cam["H"], cam["W"]
    dev = room.device
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    dirs = torch.stack([(i - cam["cx"]) / cam["fx"], -(j - cam["cy"]) / cam["fy"],
                        -torch.ones_like(i)], -1)
    R = c2w[:3, :3]
    d = dirs[..., 0:1] * R[:, 0] + dirs[..., 1:2] * R[:, 1] + dirs[..., 2:3] * R[:, 2]
    o = c2w[:3, 3]
    t = (room[None, None] - o[None, None, :, None]) / d[..., None]
    depth = t.amax(-1).amin(-1)
    hit = o + d * depth[..., None]
    rel = (hit - room[:, 0]) / (room[:, 1] - room[:, 0])
    checker = torch.remainder(torch.floor(hit * 2.0).sum(-1), 2.0)
    color = torch.stack([0.2 + 0.6 * rel[..., 0], 0.2 + 0.6 * rel[..., 1],
                         0.3 + 0.4 * checker], -1).clamp(0.0, 1.0)
    return color, depth


class RingReader:
    """The system's frame reader over the ring: frame ``idx`` of a stream
    of ``n`` is ring frame ``idx`` mod 2(ring - 1), walked back past the
    ring's end.  Items are (idx, color, depth, c2w) host float32 arrays."""

    def __init__(self, colors, depths, poses, n: int):
        self.colors, self.depths, self.poses = colors, depths, poses
        self.n = n

    def ring_index(self, idx: int) -> int:
        r = len(self.poses)
        if r == 1:
            return 0
        k = idx % (2 * (r - 1))
        return k if k < r else 2 * (r - 1) - k

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int):
        k = self.ring_index(idx)
        return idx, self.colors[k], self.depths[k], self.poses[k].copy()


def make_reader(room, cam: Dict, scale: float, traffic: Dict, n: int, seed: int,
                device) -> RingReader:
    """Render the ring on ``device`` and keep it in host memory."""
    room_np = np.asarray(room, dtype=np.float32)
    rng = np.random.Generator(np.random.Philox(key=[int(seed) % (1 << 64), 0x51A3]))
    start = float(rng.uniform(0.0, 2.0 * math.pi))
    room_t = torch.as_tensor(room_np, device=device)
    colors, depths, poses = [], [], []
    for k in range(int(traffic["ring"])):
        c2w = orbit_pose(room_np, start + float(traffic["step"]) * k)
        color, depth = render_frame(room_t, torch.as_tensor(c2w, device=device), cam)
        pose = c2w.copy()
        pose[:3, 3] *= scale
        colors.append(color.cpu().numpy())
        depths.append((depth * scale).cpu().numpy())
        poses.append(pose)
    return RingReader(colors, depths, poses, n)
