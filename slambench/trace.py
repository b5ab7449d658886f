"""Reading a traced window: the device's operations and the benchmark's
own ranges out of a ``torch.profiler`` run.

Device operations are the kernels, copies and memsets the profiler
records on the card.  The benchmark's ranges (``record_function``
around the system's calls, named ``slambench.*``) appear twice: on the
host, where the call ran, and on the device, where they span the
operations of that call's stream; a device operation belongs to a range
when it runs on the range's stream inside the range's interval.  Busy
time is the union of the operations' intervals.  A window whose
operations stop well before its end while ranges go on has lost profiler
records: ``lost`` says so, and nothing is scaled to cover it.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

PREFIX = "slambench."

Span = Tuple[int, int]


def union_ns(spans: List[Span]) -> int:
    """Length of the union of [start, end) intervals."""
    busy, cur_s, cur_e = 0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def merged(spans: List[Span]) -> List[Span]:
    out: List[List[int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Trace:
    """The device operations (name, start ns, end ns, stream) and the
    benchmark's ranges on host (name, start, end, thread) and device
    (name, start, end, stream) of one profiler run, cut to the window
    range ``slambench.window``."""

    def __init__(self, ops, host, dev_ranges):
        self.ops = ops
        self.host = host
        self.dev_ranges = dev_ranges
        win = [r for r in host if r[0] == PREFIX + "window"]
        self.window: Optional[Span] = (win[0][1], win[0][2]) if win else None
        if self.window:
            s, e = self.window
            self.ops = [o for o in ops if o[1] >= s and o[2] <= e]

    @classmethod
    def from_profile(cls, prof) -> "Trace":
        from torch.autograd import DeviceType

        ops, host, dev_ranges = [], [], []
        for ev in prof.profiler.kineto_results.events():
            name = ev.name()
            s = ev.start_ns()
            e = s + ev.duration_ns()
            if ev.device_type() == DeviceType.CPU:
                if name.startswith(PREFIX):
                    host.append((name, s, e, ev.start_thread_id()))
                continue
            if ev.device_type() != DeviceType.CUDA:
                continue
            kind = str(ev.activity_type()).lower() if hasattr(ev, "activity_type") else ""
            if name.startswith(PREFIX) or "annotation" in kind:
                if name.startswith(PREFIX):
                    dev_ranges.append((name, s, e, ev.device_resource_id()))
                continue
            ops.append((name, s, e, ev.device_resource_id()))
        return cls(ops, host, dev_ranges)

    # -- the whole window -------------------------------------------------------
    def window_ns(self) -> int:
        return 0 if self.window is None else self.window[1] - self.window[0]

    def busy_ns(self) -> int:
        return union_ns([(o[1], o[2]) for o in self.ops])

    def lost(self) -> bool:
        """Whether the records stop: the last operation ends more than a
        tenth of the window before the last range of a system call does."""
        calls = [r for r in self.host if r[0] != PREFIX + "window"]
        if not self.ops or not calls or self.window is None:
            return not self.ops
        last_op = max(o[2] for o in self.ops)
        last_call = max(r[2] for r in calls)
        return last_call - last_op > 0.1 * self.window_ns()

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, int] = defaultdict(int)
        for name, s, e, _ in self.ops:
            by[name] += e - s
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_activity(self, n: int = 10) -> List[List]:
        """Idle device time in the window, summed by the benchmark's host
        range that was open at each gap's middle (``host`` if none)."""
        if self.window is None:
            return []
        busy = merged([(o[1], o[2]) for o in self.ops])
        gaps, prev = [], self.window[0]
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.window[1] > prev:
            gaps.append((prev, self.window[1]))
        calls = sorted((r[1], r[2], r[0][len(PREFIX):]) for r in self.host
                       if r[0] != PREFIX + "window")
        by: Dict[str, int] = defaultdict(int)
        j, active = 0, []
        for s, e in gaps:
            mid = (s + e) // 2
            while j < len(calls) and calls[j][0] <= mid:
                active.append(calls[j])
                j += 1
            active = [c for c in active if c[1] >= mid]
            by[active[-1][2] if active else "host"] += e - s
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    # -- a range's own operations ---------------------------------------------------
    def range_ops(self, name: str) -> List[List[tuple]]:
        """Per range ``name``: the operations on its stream inside it (on
        any stream, where the profiler kept no device-side copy of the
        range: right only where nothing else runs meanwhile)."""
        ranges = sorted(r for r in self.dev_ranges if r[0] == PREFIX + name)
        if not ranges:
            ranges = sorted((r[0], r[1], r[2], None) for r in self.host
                            if r[0] == PREFIX + name)
        if self.window is not None:  # whole ranges only
            ranges = [r for r in ranges if self.window[0] <= r[1] and r[2] <= self.window[1]]
        by_stream: Dict[int, List[tuple]] = defaultdict(list)
        for o in self.ops:
            by_stream[o[3]].append(o)
        starts = {}
        for k, v in by_stream.items():
            v.sort(key=lambda o: o[1])
            starts[k] = [o[1] for o in v]
        out = []
        for _, s, e, stream in ranges:
            if stream is None:
                out.append([o for o in self.ops if s <= o[1] < e])
                continue
            ops = by_stream.get(stream, [])
            i = bisect.bisect_left(starts.get(stream, []), s)
            j = bisect.bisect_left(starts.get(stream, []), e)
            out.append(ops[i:j])
        return out

    def kernel_ns(self, needles) -> int:
        return sum(e - s for name, s, e, _ in self.ops
                   if any(k in name for k in needles))
