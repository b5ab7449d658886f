"""Device operations (kernels, copies, memsets) on the tracker's stream
inside the benchmark's range around each tracked frame, per tracking
iteration: what the host issues an iteration."""

UNIT, LAYER, SOURCE, MOVES = "ops/iter", "lookup Function and host issue", "device_trace", "track_ms"


def read(r):
    frames = r.trace.range_ops("track_one")
    if not frames or not any(frames):
        return None
    return sum(len(ops) for ops in frames) / (len(frames) * r.counts["iters_per_frame"])
