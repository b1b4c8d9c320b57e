"""The fused separable units' share of their roofline: the least time of
the forward and backward of every stride-1 separable unit of the cell
(the frozen ``unit_counts``/``unit_bounds`` on the units the configuration's
family gives, ``families/<family>.py:units``), over the device time of the
captured steps that the frozen module scopes place in those units.  Scoped
by module, not by kernel name, so it reads the same work whatever
implements it."""

from benchmark.frozen.roofline import unit_bounds


def read(ctx):
    scopes = {u[0] for u in ctx["units"]}
    spent_us = sum(r["dur"] for r in ctx["rows"] if r["scope"] in scopes)
    if spent_us <= 0:
        return None
    least_s = sum(sum(unit_bounds(form, p, c, f)) for _, p, c, f, _, form in ctx["units"])
    return 100.0 * least_s * ctx["capture_steps"] / (spent_us * 1e-6)
