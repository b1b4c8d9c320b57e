"""The 90th percentile of a traced run's uncaptured step times, each the
interval between CUDA events on this rank's compute stream at consecutive
step boundaries: the loop cells' step time, read per layer for the reason
``samples_per_s_per_gpu.loop`` gives (the end-to-end ``step_ms_p90`` is the
untraced window's, and the slowest rank's at each step)."""

import statistics


def read(ctx):
    ms = ctx["step_ms"]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=10)[-1]
