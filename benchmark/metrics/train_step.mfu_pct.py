"""The whole step's share of one H100's dense bf16 peak (989 TFLOP/s, 700 W
data sheet): FLOPs per sample of forward and backward without recompute
(``FlopCounterMode`` on the plain forward of the configuration's family at
the cell's shapes) times the samples per second per card of the window's uncaptured
steps."""

PEAK_FLOPS = 989e12


def read(ctx):
    rate, flops = ctx["samples_per_s_per_gpu"], ctx["flops_per_sample"]
    if not rate or not flops:
        return None
    return 100.0 * flops * rate / PEAK_FLOPS
