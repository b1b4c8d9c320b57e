"""Samples per second per card over a traced run's uncaptured steps: the
loop cells' rate, read per layer.  Their host enqueues each step, and the
host's pace drifts between runs by more than any bound can hold, so these
cells carry no end-to-end rate (the end-to-end ``samples_per_s_per_gpu``
is the untraced window's)."""


def read(ctx):
    return ctx["samples_per_s_per_gpu"] or None
