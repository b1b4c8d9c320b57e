"""Mean host milliseconds per step blocked in ``next()`` on the loop's
``prefetch_to_device``: the benchmark's own span, over the window's
uncaptured steps.  Layer: the data pipeline.  Only the loop entry has a
pipeline to wait on."""


def read(ctx):
    waits = ctx["data_wait_s"]
    if ctx["entry"] != "loop" or not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
