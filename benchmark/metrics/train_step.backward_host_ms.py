"""Mean host milliseconds per step in the train step's backward: clearing
the gradients and ``loss.backward()``, with DDP's overlapped all-reduce
under a group (the program's span ``step.backward``), over the window's
uncaptured steps.  Layer: the train step."""

from benchmark.metrics._span_record import mean_ms


def read(ctx):
    return mean_ms(ctx, ("step.backward.ns",))
