"""The whole step's share of the card's float32 peak: the model's
operations in the traced window (NICE: its decoder MLPs', from
``flops.dec_work``; iMAP*: its MLP's, ``flops.imap_flops`` over the
window's calls) over the window's length x the float32 peak."""

from slambench import flops

UNIT, LAYER, SOURCE, MOVES = "%", "device", "device_trace", "fps"


def read(r):
    w = r.trace.window_ns()
    f = r.counts.get("dec_flops", 0.0) + flops.imap_flops(r.conf, r.calls)
    if w <= 0 or f <= 0:
        return None
    return 100.0 * f / r.peaks["f32_flops_per_s"] / (w / 1e9)
