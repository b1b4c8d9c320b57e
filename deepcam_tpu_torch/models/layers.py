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

import math
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fused_sepconv import fused_sepconv


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
        y = F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                     stride=self.stride, padding=self.padding,
                     dilation=self.dilation, groups=self.groups)
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
        return F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype),
                                  stride=2, padding=1, output_padding=1)


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
    the card (``ops/fused_sepconv.py``); the stride-2 tail sepconvs stay two
    cuDNN convs, as the JAX package leaves them to XLA."""

    def __init__(self, in_ch: int, features: int, *, stride: int = 1,
                 dilation: int = 1, pre_relu: bool = False,
                 dtype: torch.dtype = torch.float32, gen: torch.Generator):
        super().__init__()
        self.stride, self.dilation, self.pre_relu = stride, dilation, pre_relu
        self.dtype = dtype
        self.depthwise = Conv2d(in_ch, in_ch, 3, groups=in_ch, dtype=dtype, gen=gen)
        self.pointwise = Conv2d(in_ch, features, 1, dtype=dtype, gen=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dw = self.depthwise.weight.to(self.dtype)  # (C, 1, 3, 3)
        pw = self.pointwise.weight.to(self.dtype)  # (F, C, 1, 1)
        if self.stride == 1:
            y = fused_sepconv(x.to(self.dtype).permute(0, 2, 3, 1),
                              dw[:, 0].permute(1, 2, 0), pw[:, :, 0, 0].t(),
                              self.pre_relu, self.dilation)
            return y.permute(0, 3, 1, 2)
        x = x.to(self.dtype)
        if self.pre_relu:
            x = torch.relu(x)
        pad, _ = fixed_padding(3, self.dilation)  # symmetric for k=3
        x = F.conv2d(x, dw, stride=self.stride, padding=pad,
                     dilation=self.dilation, groups=x.shape[1])
        return F.conv2d(x, pw)


# ---------------------------------------------------------------------------
# BatchNorm with torch semantics
# ---------------------------------------------------------------------------

class BatchNorm2d(nn.Module):
    """BatchNorm over N, H, W with the JAX module's numerics.

    * Train mode: fp32 batch statistics in one pass, var = max(E[x²] −
      E[x]², 0).  The running statistics are updated IN PLACE (momentum 0.1,
      torch convention, unbiased running variance) — the JAX module returns
      them as a new ``batch_stats`` tree instead.
    * Eval mode: the running statistics.
    * The apply is ``x*a + b`` in ``dtype`` with a = γ/σ and b = β − μ·a
      computed in fp32 — written out, because ``F.batch_norm`` rounds at
      other places.  ``relu=True`` fuses the following ReLU.
    """

    def __init__(self, features: int, *, dtype: torch.dtype = torch.float32,
                 momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.dtype, self.momentum, self.eps = dtype, momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        if self.training:
            n = x.shape[0] * x.shape[2] * x.shape[3]
            x32 = x.float()
            mean = x32.mean(dim=(0, 2, 3))
            ex2 = (x32 * x32).mean(dim=(0, 2, 3))
            var = torch.clamp_min(ex2 - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                unbiased = var * (n / max(n - 1, 1))
                self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1.0 - m) * self.running_var + m * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        a = inv.to(self.dtype)[:, None, None]
        b = (self.bias - mean * inv).to(self.dtype)[:, None, None]
        y = x.to(self.dtype) * a + b
        return torch.relu(y) if relu else y
