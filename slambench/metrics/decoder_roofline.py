"""Share of the roofline of the NICE decoder kernels K4-K6: the least
time the card could take for the traced window's decoder work (per call
the larger of its float32 operations over the float32 peak and its bytes
over the HBM peak, from ``flops.dec_work`` at the configuration's
widths) over the device time of these kernels."""

UNIT, LAYER, SOURCE, MOVES = "%", "kernels K4-K6", "device_trace", "fps"
KERNELS = ("decoder_fwd_kernel", "decoder_bwd_kernel", "decoder_wgrad_sum_kernel")


def read(r):
    t = r.trace.kernel_ns(KERNELS)
    least = r.counts.get("dec_least_s", 0.0)
    if t <= 0 or least <= 0:
        return None
    return 100.0 * least / (t / 1e9)
