"""Mean host milliseconds per step in the train step's forward: the model
call and the loss (the program's span ``step.forward``), over the window's
uncaptured steps.  Layer: the train step."""

from benchmark.metrics._span_record import mean_ms


def read(ctx):
    return mean_ms(ctx, ("step.forward.ns",))
