"""Mean host milliseconds per step in ``optimizer.step()`` (the program's
span ``step.optimizer``), over the window's uncaptured steps.  Layer: the
train step."""

from benchmark.metrics._span_record import mean_ms


def read(ctx):
    return mean_ms(ctx, ("step.optimizer.ns",))
