"""Mean host milliseconds per step in train-mode BatchNorm's glue calls,
forward and backward: checks, the one allocation and the ctypes launch of
each kernel (the program's spans ``bn.fwd`` and ``bn.bwd`` in
``ops/bn_glue.py``), over the window's uncaptured steps.  Layer: the model
and its layers.  A program without the glue's spans reads nothing."""

from benchmark.metrics._span_record import mean_ms


def read(ctx):
    return mean_ms(ctx, ("bn.fwd.ns", "bn.bwd.ns"))
