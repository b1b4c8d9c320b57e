"""Modified aligned Xception backbone (counterpart of
``deepcam_tpu/models/xception.py``), output stride 16 or 8.

Entry flow (2 convs + 3 down-sampling blocks), 16 identical 728-channel
middle blocks, exit flow (block20 + three dilated separable convs to 2048
channels).  Every stride-1 separable conv (60 per forward at output stride
16, 61 at 8, where block3's tail runs at stride 1) runs through the fused
sepconv kernel.  By default this is the JAX model's default path: each
rep BatchNorm whose only consumer is the next sepconv hands its apply to that
unit's kernel (BN-apply fold), train-mode units emit the following BN's
statistics, and the middle-flow blocks pass their chain-final (raw output,
BN coefficients, residual stream) to the next block's unit 0, which forms
the boundary inside its kernel.  ``layers.set_bn_fold(False)`` and
``layers.set_fused_stats(False)`` give the same math with each BN applied as
its own op (the JAX configuration ``DEEPCAM_BN_FOLD=0 DEEPCAM_FUSED_STATS=0``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import (
    BatchNorm2d,
    Conv2d,
    SeparableConv2dSame,
    bn_fold_active,
    boundary_fold_active,
    fused_stats_active,
)


class XceptionBlock(nn.Module):
    """Xception residual block: a chain of [ReLU, sepconv, BN] units, an
    optional bare stride-2 (or, with ``is_last``, stride-1) sepconv, and a
    1×1-conv+BN skip when channels or stride change.

    The reference's inplace-ReLU aliasing is reproduced: with
    ``start_with_relu`` the leading ReLU is applied once to the input before
    the residual split, so the skip path sees relu(inp).  Each later unit
    declares its ReLU on the sepconv (``pre_relu``) so the kernel applies it.
    """

    def __init__(self, in_ch: int, out_ch: int, reps: int, *, stride: int = 1,
                 dilation: int = 1, start_with_relu: bool = True,
                 grow_first: bool = True, is_last: bool = False,
                 dtype: torch.dtype = torch.float32, gen: torch.Generator):
        super().__init__()
        self.start_with_relu = start_with_relu
        units = []
        filters = out_ch if grow_first else in_ch
        if grow_first:
            units.append(out_ch)
        units += [filters] * (reps - 1)
        if not grow_first:
            units.append(out_ch)
        self.n_units = len(units)
        cin = in_ch
        for i, feat in enumerate(units):
            setattr(self, f"sepconv{i}", SeparableConv2dSame(
                cin, feat, dilation=dilation, pre_relu=i > 0, dtype=dtype, gen=gen))
            setattr(self, f"bn{i}", BatchNorm2d(feat, dtype=dtype))
            cin = feat
        self.tail = None  # name of the bare trailing sepconv, if any
        if stride != 1:
            self.tail = "sepconv_stride"
            self.sepconv_stride = SeparableConv2dSame(
                cin, out_ch, stride=2, dtype=dtype, gen=gen)
        elif is_last:
            self.tail = "sepconv_last"
            self.sepconv_last = SeparableConv2dSame(cin, out_ch, dtype=dtype, gen=gen)
        self.skip_conv = self.skip_bn = None
        if out_ch != in_ch or stride != 1:
            self.skip_conv = Conv2d(in_ch, out_ch, 1, stride=stride, dtype=dtype, gen=gen)
            self.skip_bn = BatchNorm2d(out_ch, dtype=dtype)

    def forward(self, x: torch.Tensor, boundary_in=None, emit_boundary: bool = False):
        """``boundary_in=((a, b), skip)``: ``x`` is the previous block's raw
        chain-final pointwise output, and this block's input stream
        ``r = relu(x*a + b + skip)`` is formed inside unit 0's kernel (needs
        ``start_with_relu``).

        ``emit_boundary=True`` (stride-1 blocks without a tail and with an
        identity skip): instead of applying the chain-final BN and the
        residual add, return the pending triple ``(y_last_raw, (a, b),
        skip)`` for the next block to fold."""
        if boundary_in is not None:
            if not self.start_with_relu:
                raise ValueError("boundary_in needs start_with_relu")
            inp = None  # unit 0's r
        else:
            if self.start_with_relu:
                x = torch.relu(x)
            inp = x
        fold = bn_fold_active()
        emit = fused_stats_active() and self.training
        has_tail = self.tail is not None
        if emit_boundary and (has_tail or not fold or self.skip_conv is not None):
            raise ValueError("emit_boundary needs the BN fold, no tail and an identity skip")
        ab = None
        for i in range(self.n_units):
            sepconv, bn = getattr(self, f"sepconv{i}"), getattr(self, f"bn{i}")
            if i == 0 and boundary_in is not None:
                x, st, inp = sepconv(x, emit_stats=emit, boundary=boundary_in)
            else:
                x = sepconv(x, bn_fold=ab, emit_stats=emit)
                st = None
                if emit:
                    x, st = x
            # a BN whose only consumer is the next sepconv hands it (a, b)
            if fold and (i < self.n_units - 1 or has_tail or emit_boundary):
                ab = bn(x, fold=True, stats=st)
            else:
                x, ab = bn(x, stats=st), None
        if emit_boundary:
            return x, ab, inp
        if has_tail:
            x = getattr(self, self.tail)(x, bn_fold=ab)
        skip = inp if self.skip_conv is None else self.skip_bn(self.skip_conv(inp))
        return x + skip


class Xception(nn.Module):
    """Modified aligned Xception encoder.  Returns (features, 2048 channels
    at stride ``output_stride``; low-level features, 128 channels at stride
    4).  At output stride 8 block3 keeps the resolution (its tail is a
    stride-1 ``sepconv_last``), the middle flow runs at dilation 2 and the
    exit flow at (2, 4), as the JAX model builds it."""

    def __init__(self, in_ch: int = 16, output_stride: int = 16, *,
                 dtype: torch.dtype = torch.float32, gen: torch.Generator):
        super().__init__()
        if output_stride == 16:
            block3_stride, middle_rate, exit_rates = 2, 1, (1, 2)
        elif output_stride == 8:
            block3_stride, middle_rate, exit_rates = 1, 2, (2, 4)
        else:
            raise NotImplementedError(f"output_stride {output_stride} not supported")
        kw = dict(dtype=dtype, gen=gen)
        self.conv1 = Conv2d(in_ch, 32, 3, stride=2, padding=1, **kw)
        self.bn1 = BatchNorm2d(32, dtype=dtype)
        self.conv2 = Conv2d(32, 64, 3, padding=1, **kw)
        self.bn2 = BatchNorm2d(64, dtype=dtype)
        self.block1 = XceptionBlock(64, 128, 2, stride=2, start_with_relu=False, **kw)
        self.block2 = XceptionBlock(128, 256, 2, stride=2, **kw)
        self.block3 = XceptionBlock(256, 728, 2, stride=block3_stride, is_last=True, **kw)
        for i in range(4, 20):
            setattr(self, f"block{i}", XceptionBlock(728, 728, 3, dilation=middle_rate, **kw))
        self.block20 = XceptionBlock(728, 1024, 2, dilation=exit_rates[0], grow_first=False,
                                     is_last=True, **kw)
        rate = exit_rates[1]
        self.conv3 = SeparableConv2dSame(1024, 1536, dilation=rate, **kw)
        self.bn3 = BatchNorm2d(1536, dtype=dtype)
        self.conv4 = SeparableConv2dSame(1536, 1536, dilation=rate, pre_relu=True, **kw)
        self.bn4 = BatchNorm2d(1536, dtype=dtype)
        self.conv5 = SeparableConv2dSame(1536, 2048, dilation=rate, pre_relu=True, **kw)
        self.bn5 = BatchNorm2d(2048, dtype=dtype)

    def forward(self, x: torch.Tensor):
        x = self.bn1(self.conv1(x), relu=True)
        x = self.bn2(self.conv2(x), relu=True)
        x = self.block1(x)
        # block2's leading inplace ReLU mutates the reference's low-level
        # tap too: downstream consumers receive relu(block1_out)
        low_level = torch.relu(x)
        x = self.block3(self.block2(x))
        # middle flow: with the boundary fold each block hands its pending
        # triple to the next block's unit 0 (boundaries 4→5 … 19→20)
        pending = None
        for i in range(4, 20):
            block = getattr(self, f"block{i}")
            if not boundary_fold_active():
                x = block(x)
            elif pending is None:
                pending = block(x, emit_boundary=True)
            else:
                pending = block(pending[0], boundary_in=pending[1:], emit_boundary=True)
        if pending is not None:
            x = self.block20(pending[0], boundary_in=pending[1:])
        else:
            x = self.block20(x)

        # exit flow: bn3 and bn4 feed only the next sepconv, so their applies
        # fold into conv4 and conv5
        fold = bn_fold_active()
        emit = fused_stats_active() and self.training
        ab = None
        for conv, bn in ((self.conv3, self.bn3), (self.conv4, self.bn4)):
            x = conv(x, bn_fold=ab, emit_stats=emit)
            x, st = x if emit else (x, None)
            if fold:
                ab = bn(x, fold=True, stats=st)
            else:
                x, ab = bn(x, stats=st), None
        x = self.conv5(x, bn_fold=ab, emit_stats=emit)
        x, st = x if emit else (x, None)
        x = self.bn5(x, relu=True, stats=st)
        return x, low_level
