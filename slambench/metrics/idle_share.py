"""Share of the traced window in which no operation ran on the card."""

UNIT, LAYER, SOURCE, MOVES = "%", "device", "device_trace", "fps"


def read(r):
    w = r.trace.window_ns()
    if w <= 0 or not r.trace.ops:
        return None
    return 100.0 * (1.0 - r.trace.busy_ns() / w)
