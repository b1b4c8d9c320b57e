"""Modified aligned Xception backbone (counterpart of
``deepcam_tpu/models/xception.py``), output stride 16.

Entry flow (2 convs + 3 down-sampling blocks), 16 identical 728-channel
middle blocks, exit flow (block20 + three dilated separable convs to 2048
channels).  Every stride-1 separable conv (60 per forward) runs through the
fused sepconv kernel.  This is the JAX model's path with the BN-apply fold,
the kernel-emitted statistics and the block-boundary fold switched off
(``DEEPCAM_BN_FOLD=0``, ``DEEPCAM_FUSED_STATS=0``): the same math, with each
BN applied as its own op.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import BatchNorm2d, Conv2d, SeparableConv2dSame


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.start_with_relu:
            x = torch.relu(x)
        inp = x
        for i in range(self.n_units):
            x = getattr(self, f"bn{i}")(getattr(self, f"sepconv{i}")(x))
        if self.tail is not None:
            x = getattr(self, self.tail)(x)
        skip = inp if self.skip_conv is None else self.skip_bn(self.skip_conv(inp))
        return x + skip


class Xception(nn.Module):
    """Modified aligned Xception encoder at output stride 16.  Returns
    (features, 2048 channels at stride 16; low-level features, 128 channels
    at stride 4)."""

    def __init__(self, in_ch: int = 16, output_stride: int = 16, *,
                 dtype: torch.dtype = torch.float32, gen: torch.Generator):
        super().__init__()
        if output_stride != 16:
            raise NotImplementedError(
                f"output_stride {output_stride}: the port runs os=16 only")
        kw = dict(dtype=dtype, gen=gen)
        self.conv1 = Conv2d(in_ch, 32, 3, stride=2, padding=1, **kw)
        self.bn1 = BatchNorm2d(32, dtype=dtype)
        self.conv2 = Conv2d(32, 64, 3, padding=1, **kw)
        self.bn2 = BatchNorm2d(64, dtype=dtype)
        self.block1 = XceptionBlock(64, 128, 2, stride=2, start_with_relu=False, **kw)
        self.block2 = XceptionBlock(128, 256, 2, stride=2, **kw)
        self.block3 = XceptionBlock(256, 728, 2, stride=2, is_last=True, **kw)
        for i in range(4, 20):
            setattr(self, f"block{i}", XceptionBlock(728, 728, 3, **kw))
        self.block20 = XceptionBlock(728, 1024, 2, grow_first=False, is_last=True, **kw)
        self.conv3 = SeparableConv2dSame(1024, 1536, dilation=2, **kw)
        self.bn3 = BatchNorm2d(1536, dtype=dtype)
        self.conv4 = SeparableConv2dSame(1536, 1536, dilation=2, pre_relu=True, **kw)
        self.bn4 = BatchNorm2d(1536, dtype=dtype)
        self.conv5 = SeparableConv2dSame(1536, 2048, dilation=2, pre_relu=True, **kw)
        self.bn5 = BatchNorm2d(2048, dtype=dtype)

    def forward(self, x: torch.Tensor):
        x = self.bn1(self.conv1(x), relu=True)
        x = self.bn2(self.conv2(x), relu=True)
        x = self.block1(x)
        # block2's leading inplace ReLU mutates the reference's low-level
        # tap too: downstream consumers receive relu(block1_out)
        low_level = torch.relu(x)
        x = self.block2(x)
        for i in range(3, 21):
            x = getattr(self, f"block{i}")(x)
        x = self.bn3(self.conv3(x))
        x = self.bn4(self.conv4(x))
        x = self.bn5(self.conv5(x), relu=True)
        return x, low_level
