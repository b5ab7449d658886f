"""Keyframe store on the device: counterpart of
the JAX package's ``slam/keyframes.py``.

Keyframes live in fixed-capacity device tensors, doubled when full, so
window gathers are device indexing and never touch the host.  The logical
count and the source frame indices are kept on the host.

The main mapper writes the store and the coarse mapper, on another thread
and stream in the loose and free schedules, reads it.  Writes and
``snapshot`` go through the store's ``Handoff``, so a reader gets a count
with the arrays it belongs to and after the writes before it.  A slot a
snapshot covers is never written in place again: ``set_est_c2w`` replaces
the pose array, and ``add`` writes only past the count.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from nice_slam_torch.slam.handoff import Handoff, hold


class KeyframeArrays(NamedTuple):
    colors: torch.Tensor   # (K, H, W, 3) f32
    depths: torch.Tensor   # (K, H, W) f32
    est_c2w: torch.Tensor  # (K, 4, 4) f32
    gt_c2w: torch.Tensor   # (K, 4, 4) f32


def _empty(capacity: int, H: int, W: int, device) -> KeyframeArrays:
    eye = torch.eye(4, device=device).repeat(capacity, 1, 1)
    return KeyframeArrays(
        colors=torch.zeros((capacity, H, W, 3), device=device),
        depths=torch.zeros((capacity, H, W), device=device),
        est_c2w=eye, gt_c2w=eye.clone())


class KeyframeStore:
    """A growable store of device-resident keyframes."""

    def __init__(self, capacity: int, H: int, W: int, device):
        self.capacity = capacity
        self.H, self.W = H, W
        self.device = torch.device(device)
        self.arrays = _empty(capacity, H, W, self.device)
        self.frame_ids: List[int] = []  # keyframe position -> frame index
        self.handoff = Handoff(self.device)

    def __len__(self) -> int:
        return len(self.frame_ids)

    def _grow(self) -> None:
        more = _empty(self.capacity, self.H, self.W, self.device)
        hold(self.arrays)  # this stream's queued work may still read them
        self.arrays = KeyframeArrays(*(torch.cat([a, b]) for a, b
                                       in zip(self.arrays, more)))
        self.capacity *= 2

    def add(self, frame_idx: int, color, depth, est_c2w, gt_c2w) -> None:
        srcs = [torch.as_tensor(x, dtype=torch.float32, device=self.device)
                for x in (color, depth, est_c2w, gt_c2w)]
        with self.handoff.access():
            i = len(self.frame_ids)
            if i >= self.capacity:
                self._grow()
            for dst, src in zip(self.arrays, srcs):
                dst[i] = src
            self.frame_ids.append(frame_idx)

    def set_est_c2w(self, pos: int, c2w) -> None:
        c2w = torch.as_tensor(c2w, dtype=torch.float32, device=self.device)
        with self.handoff.access():
            hold([self.arrays.est_c2w])
            est = self.arrays.est_c2w.clone()
            est[pos] = c2w
            self.arrays = self.arrays._replace(est_c2w=est)

    def snapshot(self) -> "KeyframeSnapshot":
        """The keyframes as they stand, for a reader on another thread."""
        with self.handoff.access():
            snap = KeyframeSnapshot(self.arrays, list(self.frame_ids))
        hold(snap.arrays)
        return snap


class KeyframeSnapshot:
    """A read-only view of the store: its arrays and keyframe ids."""

    def __init__(self, arrays: KeyframeArrays, frame_ids: List[int]):
        self.arrays = arrays
        self.frame_ids = frame_ids

    def __len__(self) -> int:
        return len(self.frame_ids)
