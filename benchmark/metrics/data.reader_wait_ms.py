"""Mean host milliseconds per step that the loop's consumer blocked on the
reader threads (the program's span ``data.wait`` in ``DataLoader``), over
the window's uncaptured steps.  Layer: the data pipeline."""

from benchmark.metrics._span_record import mean_ms


def read(ctx):
    return mean_ms(ctx, ("data.wait.ns",))
