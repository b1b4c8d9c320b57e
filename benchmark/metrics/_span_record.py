"""The program's own span record (``deepcam_tpu_torch/profiling/spans.py``),
read for the per-layer metrics of the window's uncaptured steps: the same
steps that ``train_step.host_ms`` reads, free of the profiler's host cost.
A checkout whose program has no span record reads nothing."""


def window(ctx):
    """The record's entries of the window's uncaptured steps, oldest first,
    or None: when the program has no record, when the record is shorter
    than the window, or when any entry's root span ``step`` lasted over 1
    ms longer than the benchmark's own span around the same call (the
    inside span must sit inside the outside one)."""
    try:
        from deepcam_tpu_torch.profiling import spans
    except ImportError:
        return None
    hosts, k = ctx["step_host_s"], ctx["capture_steps"]
    record = spans.steps()
    n = len(hosts)
    if n == 0 or len(record) < n + k:
        return None
    entries = record[len(record) - n - k:len(record) - k]
    for e, host_s in zip(entries, hosts):
        if "step.ns" not in e or e["step.ns"] > host_s * 1e9 + 1e6:
            return None
    return entries


def mean_ms(ctx, keys):
    """Mean host ms per uncaptured step of the entries' ``keys`` summed
    (nanoseconds), or None where ``window`` is None or no entry has any of
    them."""
    entries = window(ctx)
    if entries is None or not any(k in e for e in entries for k in keys):
        return None
    return 1e-6 * sum(e.get(k, 0) for e in entries for k in keys) / len(entries)
