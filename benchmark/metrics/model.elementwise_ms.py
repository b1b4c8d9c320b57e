"""Device milliseconds per captured step of elementwise-family kernels
(the frozen ``kernel_family``) outside the fused separable units' scopes:
the BN, ReLU and cast glue of the model and its layers."""


def read(ctx):
    scopes = {u[0] for u in ctx["units"]}
    rows = [r for r in ctx["rows"] if r["scope"] not in scopes]
    if not rows:
        return None
    us = sum(r["dur"] for r in rows if r["category"] == "elementwise")
    return us * 1e-3 / ctx["capture_steps"]
