"""Share of the float32 peak of the iMAP* MLP's GEMMs: the traced
window's MLP operations (``flops.imap_flops`` over the window's tracking
and mapping calls) over the float32 peak, over the device time of the
kernels named as GEMMs."""

from slambench import flops

UNIT, LAYER, SOURCE, MOVES = "%", "iMAP* MLP", "device_trace", "fps"


def read(r):
    t = sum(e - s for name, s, e, _ in r.trace.ops if "gemm" in name.lower())
    f = flops.imap_flops(r.conf, r.calls)
    if t <= 0 or f <= 0:
        return None
    return 100.0 * f / r.peaks["f32_flops_per_s"] / (t / 1e9)
