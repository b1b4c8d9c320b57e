"""The dense layers' share of their roofline: the least time of the forward
and backward of every dense layer's 3x3 convolution (bytes over 3.35 TB/s
against FLOPs over 989 TFLOP/s, ``families/fcdensenet.py:dense_layer_bounds``,
carried on each layer's entry of the family's ``units``), over the device
time of the captured steps that the frozen module scopes place in the dense
layers: their BN, ReLU, conv, dropout and concatenation, forward and
backward.  Scoped by module, not by kernel name, so it reads the same work
whatever implements it.  A cell whose family gives no dense layers reads
nothing."""


def read(ctx):
    # a dense layer's entry is (path, least seconds); a separable unit's has six fields
    layers = [u for u in ctx["units"] if len(u) == 2]
    scopes = {path for path, _ in layers}
    spent_us = sum(r["dur"] for r in ctx["rows"] if r["scope"] in scopes)
    if spent_us <= 0:
        return None
    least_s = sum(least for _, least in layers)
    return 100.0 * least_s * ctx["capture_steps"] / (spent_us * 1e-6)
