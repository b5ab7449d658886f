"""Device busy time (the union of the operations' intervals) on the
tracker's stream inside the benchmark's range around each tracked frame,
in ms per frame."""

from slambench.trace import union_ns

UNIT, LAYER, SOURCE, MOVES = "ms", "tracker", "device_trace", "track_ms"


def read(r):
    frames = r.trace.range_ops("track_one")
    if not frames or not any(frames):
        return None
    return sum(union_ns([(o[1], o[2]) for o in ops]) for ops in frames) / 1e6 / len(frames)
