"""Seconds of the system's main and coarse mapping calls (its own stage
clock, ending in a synchronize) over the untraced window's mapping
events, in ms per event."""

UNIT, LAYER, SOURCE, MOVES = "ms", "mapper", "program_span", "fps"


def read(r):
    w = r.window
    if not w or w["map_events"] <= 0:
        return None
    return 1e3 * w["map_s"] / w["map_events"]
