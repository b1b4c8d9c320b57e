"""Train-mode BatchNorm's per-channel glue: from one call's batch moments to
the apply's coefficients ``(a, b)``, with the running statistics updated in
place, as one autograd function whose forward and backward are one launch
each on the card.

``bn_glue(m1, m2, weight, bias, running_mean, running_var, div=, count=,
momentum=, eps=, update=, dtype=)`` takes each channel's first and second
moments, either sums over ``div`` values (the fused units' Σy, Σy²) or
means (``div=1``: moments reduced by PyTorch, or averaged over a
statistics group), and returns ``a = γ·rsqrt(var + eps)`` and
``b = β − mean·a`` in ``dtype``.  With ``update`` the running mean and the
running variance (unbiased over ``count`` values) move by ``momentum``; a
rematerialized replay passes ``update=False``.  Its backward returns the
cotangents of the moments, the weight and the bias.

Two versions of each direction live here, with the same arithmetic (the
note in ``csrc/bn_glue.cu`` writes it out):

* the CUDA kernels of ``csrc/bn_glue.cu`` (built by ``ops/build.py`` at
  first use), which run for tensors on the card;
* a plain PyTorch version, which runs for tensors on the CPU (the tests)
  and is what the card's tests and ``chip_smoke.py`` hold the kernels to.
  Its forward is the operations ``models/layers.py:BatchNorm2d`` composed
  before the kernels existed, in their order; its backward is the
  operations autograd ran through them, in autograd's order.

The kernels replace no TPU kernel: XLA fuses this arithmetic on the TPU,
where eager PyTorch dispatched ~42 launches a call on at most 2048 floats.
Launch latency bounds it, so the wrappers keep the host path short: no
plan, the outputs' allocations, one ctypes call.
"""

from __future__ import annotations

import ctypes
import time

import torch

from ..profiling import spans
from .build import launch, library

# Launches of each kernel since the last reset, counted where it launches.
LAUNCHES = {"bn_glue_fwd": 0, "bn_glue_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def bn_glue_fwd_plain(m1, m2, weight, bias, running_mean, running_var, div: int,
                      count: int, momentum: float, eps: float, update: bool, dtype):
    """``(a, b, saved)``: the coefficients in ``dtype`` and the (4, C) fp32
    rows the backward reads (mean, inv = γ·rsqrt(var + eps), the rsqrt, and
    E[x²] − mean² before its clamp).  Updates the running statistics in
    place when ``update``."""
    mean, ex2 = (m1, m2) if div == 1 else (m1 / div, m2 / div)
    dv = ex2 - mean * mean
    var = torch.clamp_min(dv, 0.0)
    if update:
        unbiased = var * (count / max(count - 1, 1))
        running_mean.copy_((1.0 - momentum) * running_mean + momentum * mean)
        running_var.copy_((1.0 - momentum) * running_var + momentum * unbiased)
    r = torch.rsqrt(var + eps)
    inv = r * weight
    a = inv.to(dtype)
    b = (bias - mean * inv).to(dtype)
    return a, b, torch.stack([mean, inv, r, dv])


def bn_glue_bwd_plain(ga, gb, saved, weight, div: int):
    """``(d weight, d bias, d m1, d m2)`` in fp32 from the cotangents of a
    and b, as autograd computes them through the plain forward."""
    mean, inv, r, dv = saved.unbind(0)
    gb32 = gb.float()
    gmi = -gb32
    ginv = gmi * mean + ga.float()
    gvar = ginv * weight * -0.5 * (r * r * r)
    gdv = torch.where(dv >= 0, gvar, 0.0)
    gmm = -gdv
    gmean = gmi * inv + gmm * mean + gmm * mean
    if div != 1:
        gmean, gdv = gmean / div, gdv / div
    return ginv * r, gb32, gmean, gdv


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_F = ctypes.c_float
_FN = {}


def _fn(name):
    fn = _FN.get(name)
    if fn is None:
        fn = getattr(library("bn_glue"), name)
        fn.argtypes = ([_P] * 9 + [_I, _L] + [_F] * 4 + [_I, _I, _P] if name == "bn_glue_fwd"
                       else [_P] * 5 + [_I, _L, _I, _P])
        fn.restype = _I
        _FN[name] = fn
    return fn


_OUT_TYPES = (torch.bfloat16, torch.float32)


def _check(name, t, c, dev, dtype=torch.float32):
    if t.device != dev or t.dtype != dtype or t.shape != (c,) or not t.is_contiguous():
        raise ValueError(f"bn_glue: {name} must be a contiguous {dtype} (C,) = ({c},) tensor "
                         f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def bn_glue_fwd(m1, m2, weight, bias, running_mean, running_var, div: int, count: int,
                momentum: float, eps: float, update: bool, dtype):
    """The forward kernel on CUDA fp32 (C,) tensors: ``(a, b, saved)`` as
    ``bn_glue_fwd_plain`` returns them, with ``dtype`` bf16 or fp32."""
    dev, c = m1.device, m1.shape[0]
    if dev.type != "cuda":
        raise ValueError(f"bn_glue_fwd runs on CUDA tensors, got {dev}")
    if dtype not in _OUT_TYPES:
        raise ValueError(f"bn_glue_fwd: compute type {dtype} is not bf16 or fp32")
    for name, t in (("m1", m1), ("m2", m2), ("weight", weight), ("bias", bias),
                    ("running_mean", running_mean), ("running_var", running_var)):
        _check(name, t, c, dev)
    a, b = torch.empty(c, dtype=dtype, device=dev), torch.empty(c, dtype=dtype, device=dev)
    saved = torch.empty((4, c), dtype=torch.float32, device=dev)
    launch("bn_glue_fwd", _fn("bn_glue_fwd"), dev, m1.data_ptr(), m2.data_ptr(),
           weight.data_ptr(), bias.data_ptr(), running_mean.data_ptr(),
           running_var.data_ptr(), a.data_ptr(), b.data_ptr(), saved.data_ptr(), c, div,
           count / max(count - 1, 1), 1.0 - momentum, momentum, eps, int(update),
           int(dtype == torch.bfloat16))
    LAUNCHES["bn_glue_fwd"] += 1
    return a, b, saved


def bn_glue_bwd(ga, gb, saved, weight, div: int):
    """The backward kernel: ``(d weight, d bias, d m1, d m2)`` as
    ``bn_glue_bwd_plain`` returns them, from CUDA (C,) cotangents in the
    compute type."""
    dev, c = saved.device, saved.shape[1]
    if dev.type != "cuda" or ga.dtype not in _OUT_TYPES:
        raise ValueError(f"bn_glue_bwd runs on bf16 or fp32 CUDA cotangents, got {ga.dtype} "
                         f"on {ga.device}")
    _check("ga", ga, c, dev, ga.dtype)
    _check("gb", gb, c, dev, ga.dtype)
    out = torch.empty((4, c), dtype=torch.float32, device=dev)
    launch("bn_glue_bwd", _fn("bn_glue_bwd"), dev, ga.data_ptr(), gb.data_ptr(),
           saved.data_ptr(), weight.data_ptr(), out.data_ptr(), c, div,
           int(ga.dtype == torch.bfloat16))
    LAUNCHES["bn_glue_bwd"] += 1
    return out.unbind(0)


# ---------------------------------------------------------------------------
# autograd entry point
# ---------------------------------------------------------------------------

def _on_card(t) -> bool:
    kind = t.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"bn_glue runs on cuda or cpu, got {t.device}")
    return kind == "cuda"


class _Call:
    """What a glue call takes besides the tensors autograd follows: one
    argument, since ``Function.apply``'s host cost grows with their count."""

    __slots__ = ("running_mean", "running_var", "div", "count", "momentum", "eps", "update",
                 "dtype")

    def __init__(self, running_mean, running_var, div, count, momentum, eps, update, dtype):
        self.running_mean, self.running_var, self.div, self.count = (
            running_mean, running_var, div, count)
        self.momentum, self.eps, self.update, self.dtype = momentum, eps, update, dtype


def glue_fwd(m1, m2, weight, bias, call):
    """``(a, b, saved)``: the kernel for tensors on the card, the plain
    version on the CPU, its host time added to the span ``bn.fwd``."""
    args = (m1, m2, weight, bias, call.running_mean, call.running_var, call.div, call.count,
            call.momentum, call.eps, call.update, call.dtype)
    t0 = time.perf_counter_ns()
    out = bn_glue_fwd(*args) if _on_card(m1) else bn_glue_fwd_plain(*args)
    spans.add("bn.fwd", time.perf_counter_ns() - t0)
    return out


def glue_bwd(ga, gb, saved, weight, div: int):
    """``(d weight, d bias, d m1, d m2)`` as ``glue_fwd`` dispatches, into
    the span ``bn.bwd``."""
    t0 = time.perf_counter_ns()
    if _on_card(saved):
        out = bn_glue_bwd(ga.contiguous(), gb.contiguous(), saved, weight, div)
    else:
        out = bn_glue_bwd_plain(ga, gb, saved, weight, div)
    spans.add("bn.bwd", time.perf_counter_ns() - t0)
    return out


class _BnGlue(torch.autograd.Function):
    """Outputs (a, b); the backward receives their cotangents and returns
    those of (m1, m2, weight, bias)."""

    @staticmethod
    def forward(ctx, m1, m2, weight, bias, call):
        a, b, saved = glue_fwd(m1, m2, weight, bias, call)
        ctx.save_for_backward(saved, weight)
        ctx.div = call.div
        return a, b

    @staticmethod
    def backward(ctx, ga, gb):
        saved, weight = ctx.saved_tensors
        gw, gbias, gm1, gm2 = glue_bwd(ga, gb, saved, weight, ctx.div)
        return gm1, gm2, gw, gbias, None


def bn_glue(m1, m2, weight, bias, running_mean, running_var, *, div: int, count: int,
            momentum: float, eps: float, update: bool, dtype):
    """Train-mode BatchNorm's ``(a, b)`` in ``dtype`` from the moments
    ``m1``, ``m2`` ((C,) fp32: sums over ``div`` values, or means with
    ``div=1``); the running statistics move in place by ``momentum`` when
    ``update``, the variance unbiased over ``count`` values.
    Differentiable in m1, m2, weight and bias."""
    call = _Call(running_mean, running_var, int(div), int(count), float(momentum), float(eps),
                 bool(update), dtype)
    return _BnGlue.apply(m1.contiguous(), m2.contiguous(), weight, bias, call)
