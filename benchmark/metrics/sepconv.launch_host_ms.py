"""Mean host milliseconds per step in the fused separable units' kernel
calls, forward and backward: checks, plan, allocations, tensor-map encoding
and the ctypes launch (the program's spans ``sepconv.fwd`` and
``sepconv.bwd`` in ``ops/fused_sepconv.py``), over the window's uncaptured
steps.  Layer: the fused sepconv."""

from benchmark.metrics._span_record import mean_ms


def read(ctx):
    return mean_ms(ctx, ("sepconv.fwd.ns", "sepconv.bwd.ns"))
