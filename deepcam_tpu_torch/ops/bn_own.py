"""Train-mode BatchNorm (+ReLU) over its own input on the card: the
BatchNorms whose statistics no producing kernel emits, as one autograd
function over the CUDA kernels of ``csrc/bn_own.cu`` (built by
``ops/build.py`` at first use) that keeps no fp32 copy of x.

``bn_own(x, weight, bias, running_mean, running_var, relu=, momentum=,
eps=, update=, dtype=)`` returns ``relu?(x*a + b)`` in bf16, with ``(a, b)``
from x's batch statistics through the glue of ``ops/bn_glue.py`` (which
also moves the running statistics when ``update``).  Its passes:

1. ``stats``: each channel's Σx and Σx² in fp32, handed to the glue with
   ``div`` = N·H·W, as the fused units' statistics are;
2. the glue's forward: ``(a, b)`` and the running statistics;
3. ``apply``: ``y = relu?(x*a + b)``, the product and the sum each rounded
   to bf16 where the composed bf16 operations round them;

and backward, from y's cotangent dy (g = dy where y > 0 with ReLU, else dy):

4. ``grad_stats``: Σg and Σg·x per channel, the cotangents of b and a;
5. the glue's backward: those of the weight, the bias and the moments;
6. ``dx``: bf16(g·a + d(Σx) + 2·x·d(Σx²)), formed in fp32 and rounded once.

It keeps x (which the apply needs anyway), y with ReLU (the consumer's
saved input, typically), the bf16 ``a`` and the glue's (4, C) rows.

``bn_own`` takes a bf16 (N, C, H, W) tensor whose C is a multiple of 8 up
to ``MAX_CHANNELS`` and raises on any other; an input not channels_last or
not 16-byte aligned is copied to one that is, as a cotangent is.  The
functions ``stats``, ``apply``, ``grad_stats`` and ``dx`` launch one kernel
entry each and check nothing: ``bn_own`` checks x once.

The glue's own spans (``bn.fwd``, ``bn.bwd``) time it alone; the host time
of the rest of this function goes to ``bn.own.fwd`` and ``bn.own.bwd``.
"""

from __future__ import annotations

import ctypes
import time

import torch

from ..profiling import spans
from .bn_glue import _Call as _GlueCall
from .bn_glue import glue_bwd, glue_fwd
from .build import launch, library

# Launches of each kernel entry since the last reset, counted where it
# launches.  The two reductions' entries launch a second, small kernel
# that sums their per-block partials.
LAUNCHES = {"bn_own_stats": 0, "bn_own_apply": 0, "bn_own_grad_stats": 0, "bn_own_dx": 0}
# the widest C the kernels take (their reductions' shared memory)
MAX_CHANNELS = 4096


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def serves(x) -> bool:
    """Whether ``models/layers.py:BatchNorm2d`` hands train mode over its own
    input ``x`` to ``bn_own``: every tensor on the card (``bn_own`` refuses
    one its kernels cannot take); on the CPU the layer composes PyTorch
    operations."""
    return x.device.type == "cuda"


def _aligned(t) -> bool:
    return t.is_contiguous(memory_format=torch.channels_last) and t.data_ptr() % 16 == 0


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_ARGTYPES = {
    "bn_own_plan": [_L, _I, _I, _P],
    "bn_own_stats": [_P, _P, _L, _I, _I, _P],
    "bn_own_apply": [_P] * 4 + [_L, _I, _I, _I, _P],
    "bn_own_grad_stats": [_P] * 4 + [_L, _I, _I, _I, _P],
    "bn_own_dx": [_P] * 7 + [_L, _I, _I, _I, _P],
}
_FN = {}
_PLANS = {}


def _fn(name):
    fn = _FN.get(name)
    if fn is None:
        fn = getattr(library("bn_own"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _I
        _FN[name] = fn
    return fn


def plan(device, rows: int, c: int, relu: bool):
    """The kernels' launch plan for ``rows`` rows of ``c`` channels on
    ``device``, from what the card reports (``csrc/bn_own.cu:bn_own_plan``):
    ``(lanes, gthreads, stats blocks, apply blocks, grad stats blocks, dx
    blocks)``; worked out once per shape."""
    index = torch.cuda.current_device() if device.index is None else device.index
    key = (index, rows, c, bool(relu))
    p = _PLANS.get(key)
    if p is None:
        out = (ctypes.c_int * 6)()
        with torch.cuda.device(index):
            rc = _fn("bn_own_plan")(rows, c, int(relu), out)
        if rc:
            raise RuntimeError(f"bn_own_plan failed: CUDA error {rc}")
        p = _PLANS[key] = tuple(out)
    return p


def _dims(x):
    c = x.shape[1]
    return x.numel() // c, c


def stats(x, p):
    """``(2, C)`` fp32: each channel's Σx and Σx² (rows ``[0]`` and
    ``[1]``), by the plan ``p`` of ``plan``."""
    rows, c = _dims(x)
    scratch = torch.empty((p[2] + 1) * 2 * c, dtype=torch.float32, device=x.device)
    launch("bn_own_stats", _fn("bn_own_stats"), x.device, x.data_ptr(), scratch.data_ptr(),
           rows, c, p[2])
    LAUNCHES["bn_own_stats"] += 1
    return scratch[p[2] * 2 * c:].view(2, c)


def apply(x, a, b, relu: bool, p):
    """``relu?(x*a + b)``, bf16 channels_last, with the product and the sum
    each rounded to bf16."""
    rows, c = _dims(x)
    y = torch.empty_like(x)
    launch("bn_own_apply", _fn("bn_own_apply"), x.device, x.data_ptr(), a.data_ptr(),
           b.data_ptr(), y.data_ptr(), rows, c, int(relu), p[3])
    LAUNCHES["bn_own_apply"] += 1
    return y


def grad_stats(dy, y, x, relu: bool, p):
    """``(2, C)`` fp32: each channel's Σg and Σg·x, g = dy where y > 0 with
    ``relu`` (y unread without)."""
    rows, c = _dims(x)
    scratch = torch.empty((p[4] + 1) * 2 * c, dtype=torch.float32, device=x.device)
    launch("bn_own_grad_stats", _fn("bn_own_grad_stats"), x.device, dy.data_ptr(),
           y.data_ptr() if relu else None, x.data_ptr(), scratch.data_ptr(), rows, c,
           int(relu), p[4])
    LAUNCHES["bn_own_grad_stats"] += 1
    return scratch[p[4] * 2 * c:].view(2, c)


def dx(dy, y, x, a, d1, d2, relu: bool, p):
    """``bf16(g·a + d1 + 2·x·d2)``, channels_last, from fp32 ``d1`` = d(Σx)
    and ``d2`` = d(Σx²) per channel."""
    rows, c = _dims(x)
    out = torch.empty_like(x)
    launch("bn_own_dx", _fn("bn_own_dx"), x.device, dy.data_ptr(),
           y.data_ptr() if relu else None, x.data_ptr(), a.data_ptr(), d1.data_ptr(),
           d2.data_ptr(), out.data_ptr(), rows, c, int(relu), p[5])
    LAUNCHES["bn_own_dx"] += 1
    return out


# ---------------------------------------------------------------------------
# autograd entry point
# ---------------------------------------------------------------------------

class _Call:
    """What a call takes besides the tensors autograd follows: the glue's
    arguments, the ReLU and the kernels' plan."""

    __slots__ = ("glue", "relu", "plan")

    def __init__(self, glue, relu, plan):
        self.glue, self.relu, self.plan = glue, relu, plan


class _BnOwn(torch.autograd.Function):
    """Output y; the backward receives its cotangent and returns those of
    (x, weight, bias)."""

    @staticmethod
    def forward(ctx, x, weight, bias, call):
        t0 = time.perf_counter_ns()
        m1, m2 = stats(x, call.plan)
        t1 = time.perf_counter_ns()
        a, b, saved = glue_fwd(m1, m2, weight, bias, call.glue)
        t2 = time.perf_counter_ns()
        y = apply(x, a, b, call.relu, call.plan)
        ctx.save_for_backward(x, y if call.relu else None, a, saved, weight)
        ctx.call = call
        spans.add("bn.own.fwd", t1 - t0 + time.perf_counter_ns() - t2)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y, a, saved, weight = ctx.saved_tensors
        call = ctx.call
        t0 = time.perf_counter_ns()
        if not _aligned(dy):
            dy = dy.clone(memory_format=torch.channels_last)
        gb, ga = grad_stats(dy, y, x, call.relu, call.plan)
        t1 = time.perf_counter_ns()
        gw, gbias, gm1, gm2 = glue_bwd(ga, gb, saved, weight, call.glue.div)
        t2 = time.perf_counter_ns()
        gx = dx(dy, y, x, a, gm1, gm2, call.relu, call.plan) if ctx.needs_input_grad[0] else None
        spans.add("bn.own.bwd", t1 - t0 + time.perf_counter_ns() - t2)
        return gx, gw, gbias, None


def bn_own(x, weight, bias, running_mean, running_var, *, relu: bool, momentum: float,
           eps: float, update: bool, dtype):
    """Train-mode ``relu?(BatchNorm(x))`` in bf16 from x's own batch
    statistics; the running statistics move in place by ``momentum`` when
    ``update`` (the variance unbiased over N·H·W values).  Differentiable in
    x, weight and bias.  Raises ValueError unless x and ``dtype`` are bf16
    and x is (N, C, H, W) with C a multiple of 8 up to ``MAX_CHANNELS``."""
    c = x.shape[1] if x.dim() == 4 else 0
    if (x.dtype != torch.bfloat16 or dtype != torch.bfloat16 or c % 8
            or not 0 < c <= MAX_CHANNELS or x.numel() == 0):
        raise ValueError(f"bn_own's kernels take a bf16 (N, C, H, W) input with C a multiple "
                         f"of 8 up to {MAX_CHANNELS} and a bf16 compute type, got {x.dtype} "
                         f"{tuple(x.shape)} in {dtype}")
    if not _aligned(x):
        x = x.clone(memory_format=torch.channels_last)
    rows = x.numel() // c
    glue = _GlueCall(running_mean, running_var, rows, rows, float(momentum), float(eps),
                     bool(update), dtype)
    return _BnOwn.apply(x, weight, bias, _Call(glue, bool(relu), plan(x.device, rows, c, relu)))
