"""Mean host milliseconds per step that the reader threads spent in
``dataset.__getitem__`` (read, normalise, cast: the program's span
``data.read``), summed over the threads, over the window's uncaptured
steps.  Layer: the data pipeline."""

from benchmark.metrics._span_record import mean_ms


def read(ctx):
    return mean_ms(ctx, ("data.read.ns",))
