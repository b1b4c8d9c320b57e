"""The device's idle share of the captured steps: 100 x (1 - the union of
its kernel and memory-copy intervals over the capture's wall span, which
runs from the first captured step's start to the synchronize that closes
it)."""

from benchmark.trace import busy


def read(ctx):
    if not ctx["rows"]:
        return None
    lo, hi = ctx["window"]
    busy_us = sum(e - s for s, e in busy(ctx["rows"], ctx["window"]))
    return 100.0 * (1.0 - busy_us / (hi - lo))
