"""Mean host milliseconds per step inside the ``step_fn`` call: the
benchmark's own span, over the window's uncaptured steps.  Layer: the train
step.  Near the step time, the host's enqueue sets the pace."""


def read(ctx):
    hosts = ctx["step_host_s"]
    if not hosts:
        return None
    return 1e3 * sum(hosts) / len(hosts)
