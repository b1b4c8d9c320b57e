"""Mean host milliseconds per step spent assembling batches into pinned host
memory and queuing their copies to the card (the program's span
``data.stage`` in ``DataLoader`` and ``prefetch_to_device``), over the
window's uncaptured steps.  Layer: the data pipeline."""

from benchmark.metrics._span_record import mean_ms


def read(ctx):
    return mean_ms(ctx, ("data.stage.ns",))
