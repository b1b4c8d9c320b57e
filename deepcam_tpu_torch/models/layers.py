"""Core layers of the port (counterpart of ``deepcam_tpu/models/layers.py``).

Activations are NCHW tensors held in ``torch.channels_last`` memory, so
``x.permute(0, 2, 3, 1)`` is a contiguous NHWC view for the fused sepconv
kernel and cuDNN gets its preferred layout for the other convs.  Weights
are torch-layout (OIHW; ConvTranspose2d (I, O, kh, kw)) and named after the
JAX parameter tree, so ``tools/weights.py`` only transposes.

Mixed precision follows the JAX ``dtype=`` convention: parameters and BN
statistics are fp32, every op casts its parameters to ``dtype`` at use, and
the BN apply is ``x*a + b`` in ``dtype`` with a and b computed in fp32.
``torch.autocast`` is not used: it would run BN and some reductions in other
types than the JAX model does.

Initializers take an explicit ``torch.Generator`` and reproduce the
reference's init semantics (see the JAX module's docstring): kaiming-normal
for the Xception and ASPP convs, PyTorch's default uniform for the decoder
and the projections.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ..ops import bn_own
from ..ops.bn_glue import bn_glue
from ..ops.fused_sepconv import (
    fused_sepconv,
    fused_sepconv_affine,
    fused_sepconv_affine_stats,
    fused_sepconv_boundary,
    fused_sepconv_boundary_stats,
    fused_sepconv_stats,
)
from ..parallel import spatial


# ---------------------------------------------------------------------------
# Initializers (torch fan-in: weight.shape[1] * kh * kw, which is in/groups
# for a conv and out/groups for a transposed conv, as torch computes it)
# ---------------------------------------------------------------------------

def _fan_in(w: torch.Tensor) -> int:
    return w.shape[1] * w.shape[2] * w.shape[3]


def kaiming_normal_torch(w: torch.Tensor, gen: torch.Generator) -> None:
    """torch.nn.init.kaiming_normal_ defaults (fan_in, gain sqrt(2))."""
    with torch.no_grad():
        w.normal_(0.0, math.sqrt(2.0 / _fan_in(w)), generator=gen)


def torch_default_conv_kernel_init(w: torch.Tensor, gen: torch.Generator) -> None:
    """PyTorch's default Conv2d/ConvTranspose2d init: U(±1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(_fan_in(w))
    with torch.no_grad():
        w.uniform_(-bound, bound, generator=gen)


def torch_default_bias_init(b: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        b.uniform_(-bound, bound, generator=gen)


# ---------------------------------------------------------------------------
# Convolutions
# ---------------------------------------------------------------------------

class Conv2d(nn.Module):
    """Plain conv with torch-Conv2d semantics; weight (O, I/groups, kh, kw).
    The bias, where there is one, is added after the conv in ``dtype``, as
    the JAX module adds it."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3, *,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, use_bias: bool = False,
                 kernel_init: Callable = kaiming_normal_torch,
                 dtype: torch.dtype = torch.float32,
                 gen: torch.Generator):
        super().__init__()
        self.stride, self.padding, self.dilation, self.groups = (
            stride, padding, dilation, groups)
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(features, in_ch // groups, kernel_size, kernel_size))
        kernel_init(self.weight, gen)
        if use_bias:
            self.bias = nn.Parameter(torch.empty(features))
            torch_default_bias_init(self.bias, _fan_in(self.weight), gen)
        else:
            self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        y = F.conv2d(x, w, stride=self.stride, padding=self.padding,
                     dilation=self.dilation, groups=self.groups)
        if (spatial.spatial_active() and w.shape[2:] == (3, 3) and self.groups == 1
                and self.padding == self.dilation):
            y = spatial.conv3x3_strip_fix(y, x, w, self.stride, self.dilation)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[:, None, None]
        return y


class ConvTranspose2d(nn.Module):
    """Transposed conv matching torch ConvTranspose2d(k3, s2, p1,
    output_padding 1): an exact ×2 upsample.  Weight (I, O, 3, 3), no bias
    (the decoder's deconvs have none)."""

    def __init__(self, in_ch: int, features: int, *,
                 dtype: torch.dtype = torch.float32, gen: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(in_ch, features, 3, 3))
        torch_default_conv_kernel_init(self.weight, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        y = F.conv_transpose2d(x, w, stride=2, padding=1, output_padding=1)
        if spatial.spatial_active():
            y = spatial.deconv_k3s2_strip_fix(y, x, w)
        return y


# ---------------------------------------------------------------------------
# Configuration of the stride-1 units (the JAX module's switches and defaults)
# ---------------------------------------------------------------------------

# Fold each rep-unit BatchNorm's APPLY into the next sepconv unit's kernel
# (BatchNorm2d(fold=True) → SeparableConv2dSame(bn_fold=...)): the same bf16
# FMA, without a separate pass.
_BN_FOLD = True
# Emit the following BatchNorm's (Σy, Σy²) from the sepconv kernel in train
# mode (BatchNorm2d(stats=...)).
_FUSED_STATS = True


def set_bn_fold(on: bool) -> None:
    global _BN_FOLD
    _BN_FOLD = bool(on)


def bn_fold_active() -> bool:
    return _BN_FOLD


def boundary_fold_active() -> bool:
    """Middle-flow block-boundary fold: the chain-final BN apply, the
    residual add and the next block's leading ReLU run inside the next
    block's unit-0 kernel, which also emits the residual stream.  Active
    exactly when the BN-apply fold is."""
    return bn_fold_active()


def set_fused_stats(on: bool) -> None:
    global _FUSED_STATS
    _FUSED_STATS = bool(on)


def fused_stats_active() -> bool:
    return _FUSED_STATS


def fixed_padding(kernel_size: int, rate: int):
    """Reference 'same' padding: effective kernel k + (k-1)(rate-1), split
    floor/ceil.  Returns (pad_beg, pad_end)."""
    k_eff = kernel_size + (kernel_size - 1) * (rate - 1)
    pad_total = k_eff - 1
    pad_beg = pad_total // 2
    return pad_beg, pad_total - pad_beg


class SeparableConv2dSame(nn.Module):
    """[ReLU →] depthwise 3×3 → pointwise 1×1, both bias-free, with the
    reference's 'same' padding.  Stride-1 units run as one fused kernel on
    the card (``ops/fused_sepconv.py``), in the form their arguments ask
    for; the stride-2 tail sepconvs stay two cuDNN convs, as the JAX package
    leaves them to XLA."""

    def __init__(self, in_ch: int, features: int, *, stride: int = 1,
                 dilation: int = 1, pre_relu: bool = False,
                 dtype: torch.dtype = torch.float32, gen: torch.Generator):
        super().__init__()
        self.stride, self.dilation, self.pre_relu = stride, dilation, pre_relu
        self.dtype = dtype
        self.depthwise = Conv2d(in_ch, in_ch, 3, groups=in_ch, dtype=dtype, gen=gen)
        self.pointwise = Conv2d(in_ch, features, 1, dtype=dtype, gen=gen)

    def forward(self, x: torch.Tensor, bn_fold=None, emit_stats: bool = False,
                boundary=None):
        """``bn_fold=(a, b)``, from the preceding ``BatchNorm2d(fold=True)``:
        the unit consumes ``x*a + b`` (inside the kernel for stride 1).

        ``emit_stats=True`` returns ``(y, (Σy, Σy²))`` for the following
        ``BatchNorm2d(stats=...)``; the stride-2 form returns ``(y, None)``
        (the BN then reduces y itself).

        ``boundary=((a, b), skip)``: ``x`` is the previous block's raw
        chain-final pointwise output, and the unit consumes
        ``r = relu(x*a + b + skip)``, formed inside the kernel.  Returns
        ``(y, stats or None, r)``; r is the residual stream of the enclosing
        block's skip path."""
        dw = self.depthwise.weight.to(self.dtype)  # (C, 1, 3, 3)
        pw = self.pointwise.weight.to(self.dtype)  # (F, C, 1, 1)
        dwk, pwk = dw[:, 0].permute(1, 2, 0), pw[:, :, 0, 0].t()
        sharded, d = spatial.spatial_active(), self.dilation

        def nhwc(t):
            return t.to(self.dtype).permute(0, 2, 3, 1)

        def nchw(t):
            return t.permute(0, 3, 1, 2)

        if self.stride != 1:
            if boundary is not None:
                raise ValueError("the boundary form is stride-1 only")
            x = x.to(self.dtype)
            if bn_fold is not None:
                a, b = bn_fold
                x = x * a.to(self.dtype)[:, None, None] + b.to(self.dtype)[:, None, None]
            if self.pre_relu:
                x = torch.relu(x)
            pad, _ = fixed_padding(3, d)  # symmetric for k=3
            y = F.conv2d(F.conv2d(x, dw, stride=self.stride, padding=pad, dilation=d,
                                  groups=x.shape[1]), pw)
            if sharded:
                if self.stride != 2 or d != 1:
                    raise ValueError("spatial mode takes stride-2 tails at dilation 1")
                spatial.check_shard(x.shape[2], stride=2, where="stride-2 sepconv")
                y = nchw(spatial.dw_s2_strip_fix(nhwc(y), nhwc(x[:, :, -1:]), dwk, pwk))
            return (y, None) if emit_stats else y

        if boundary is not None:
            if self.pre_relu or bn_fold is not None:
                raise ValueError("the boundary form applies its own ReLU and affine")
            (ba, bb), skip = boundary
            args = (nhwc(x), ba.to(self.dtype), bb.to(self.dtype), nhwc(skip), dwk, pwk, d)
            stats = None
            if emit_stats:
                y, r, s1, s2 = fused_sepconv_boundary_stats(*args)
                stats = (s1, s2)
            else:
                y, r = fused_sepconv_boundary(*args)
            if sharded:  # the strips read the emitted residual stream's edge rows
                y, stats = spatial.sepconv_strip_fix(y, r[:, :d], r[:, -d:], dwk, pwk, d, stats)
            return nchw(y), stats, nchw(r)
        xh = nhwc(x)
        if bn_fold is not None:
            a, b = bn_fold
            a, b = a.to(self.dtype), b.to(self.dtype)
            fn = fused_sepconv_affine_stats if emit_stats else fused_sepconv_affine
            out = fn(xh, a, b, dwk, pwk, self.pre_relu, d)
        else:
            fn = fused_sepconv_stats if emit_stats else fused_sepconv
            out = fn(xh, dwk, pwk, self.pre_relu, d)
        y, stats = (out[0], tuple(out[1:])) if emit_stats else (out, None)
        if sharded:
            def pre(t):  # the unit's prologue on edge rows, rounded as the kernel's
                if bn_fold is not None:
                    t = t * a + b
                return torch.relu(t) if self.pre_relu else t

            y, stats = spatial.sepconv_strip_fix(y, pre(xh[:, :d]), pre(xh[:, -d:]), dwk, pwk,
                                                 d, stats)
        return (nchw(y), stats) if emit_stats else nchw(y)


# ---------------------------------------------------------------------------
# Rematerialization (the JAX steps' ``remat=True``)
# ---------------------------------------------------------------------------

# Set in the thread that replays a rematerialized forward, for the replay.
_REPLAY = threading.local()


def recomputing() -> bool:
    """True while ``rematerialized`` replays a forward in this thread."""
    return getattr(_REPLAY, "on", False)


@contextlib.contextmanager
def _replaying():
    prev = recomputing()
    _REPLAY.on = True
    try:
        yield
    finally:
        _REPLAY.on = prev


def rematerialized(fn, *args):
    """``fn(*args)`` keeping only its inputs for the backward, which runs
    ``fn`` again to rebuild what it needs: ``torch.utils.checkpoint``,
    non-reentrant, without a selective policy.  It keeps what JAX's
    ``jax.checkpoint(policy=dots_with_no_batch_dims_saveable)`` keeps of
    the model's apply: that policy saves only dot products without batch
    dimensions, and the model has none (its convs, the fused units'
    custom calls and the BN reductions are not dots), so JAX's residuals
    are the apply's inputs alone.  A policy could not name the fused units
    anyway: their kernels are ctypes calls, invisible to dispatch.

    The replay runs under ``recomputing()``, in the thread that replays
    it, so that BatchNorm updates its running statistics once per step.
    The model draws no random numbers, so no RNG state is stashed."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), _replaying()))


# ---------------------------------------------------------------------------
# BatchNorm with torch semantics
# ---------------------------------------------------------------------------

class BatchNorm2d(nn.Module):
    """BatchNorm over N, H, W with the JAX module's numerics.

    * Train mode: fp32 batch statistics in one pass, var = max(E[x²] −
      E[x]², 0): from ``stats=(Σx, Σx²)`` when the producing kernel emitted
      them (no pass over x), else reduced here.  Under spatial mode (E[x],
      E[x²]) are averaged over the statistics group the mode names
      (``parallel/spatial.py:stats_group``) and the count multiplied by
      its factor.  The running statistics are updated IN PLACE (momentum
      0.1, torch convention, unbiased running variance), except in the
      replay of a rematerialized forward, so once per step — the JAX module
      returns them as a new ``batch_stats`` tree instead.  Everything from
      the moments to ``(a, b)`` and the running statistics is one autograd
      function, ``ops/bn_glue.py``: one kernel launch forward and one
      backward on the card.
    * Train mode over its own input on the card (no ``stats``, no
      ``fold``, no statistics group): the statistics, the glue, the apply
      and ReLU are one autograd function, ``ops/bn_own.py``, over kernels
      that keep no fp32 copy of x (bf16 only: it raises on another type).
      On the CPU the layer composes the operations below.
    * Eval mode: the running statistics, through PyTorch operations: the
      glue's kernels serve train mode, whose every step pays its launches.
    * The apply is ``x*a + b`` in ``dtype`` with a = γ/σ and b = β − μ·a
      computed in fp32 — written out, because ``F.batch_norm`` rounds at
      other places.  ``relu=True`` fuses the following ReLU; ``fold=True``
      returns the per-channel ``(a, b)`` in ``dtype`` instead of applying
      them, for the consuming unit's kernel.
    """

    def __init__(self, features: int, *, dtype: torch.dtype = torch.float32,
                 momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.dtype, self.momentum, self.eps = dtype, momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, relu: bool = False, fold: bool = False,
                stats=None):
        if (self.training and stats is None and not fold and spatial.stats_group() is None
                and bn_own.serves(x)):
            return bn_own.bn_own(x, self.weight, self.bias, self.running_mean,
                                 self.running_var, relu=relu, momentum=self.momentum,
                                 eps=self.eps, update=not recomputing(), dtype=self.dtype)
        if self.training:
            n = x.shape[0] * x.shape[2] * x.shape[3]
            if stats is not None:  # sums over the n values of each channel
                m1, m2 = stats
                div = n
            else:
                x32 = x.float()
                m1 = x32.mean(dim=(0, 2, 3))
                m2 = (x32 * x32).mean(dim=(0, 2, 3))
                div = 1
            sync = spatial.stats_group()
            if sync is not None:  # the statistics of the ranks that share the batch
                if div != 1:
                    m1, m2 = m1 / div, m2 / div
                m1, m2 = sync.mean(torch.stack([m1, m2])).unbind(0)
                div, n = 1, n * sync.count
            a, b = bn_glue(m1, m2, self.weight, self.bias, self.running_mean,
                           self.running_var, div=div, count=n, momentum=self.momentum,
                           eps=self.eps, update=not recomputing(), dtype=self.dtype)
        else:
            inv = torch.rsqrt(self.running_var + self.eps) * self.weight
            a = inv.to(self.dtype)
            b = (self.bias - self.running_mean * inv).to(self.dtype)
        if fold:
            return a, b
        y = x.to(self.dtype) * a[:, None, None] + b[:, None, None]
        return torch.relu(y) if relu else y
