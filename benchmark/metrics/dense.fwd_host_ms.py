"""Mean host milliseconds per step in the dense blocks' and the transitions'
forwards (the program's spans ``dense.block`` and ``dense.transition`` in
``models/tiramisu.py``), over the window's uncaptured steps.  Layer: the
dense blocks.  A program without those spans reads nothing."""

from benchmark.metrics._span_record import mean_ms


def read(ctx):
    return mean_ms(ctx, ("dense.block.ns", "dense.transition.ns"))
