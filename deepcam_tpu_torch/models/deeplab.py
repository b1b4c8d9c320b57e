"""DeepLabV3+ (counterpart of ``deepcam_tpu/models/deeplab.py``): aligned
Xception encoder at output stride 16 or 8, ASPP with a global-average-pool
branch, and the transposed-conv decoder (the reference's) or the
bilinear-interpolation decoder (the reference's dormant alternative).

Input (N, H, W, 16) NHWC → logits (N, H, W, n_classes) NHWC in fp32, as the
JAX model.  Inside, activations are NCHW in ``torch.channels_last`` memory
(see ``layers.py``), so the entry and exit permutes are views.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .. import resolve_device
from ..ops.interpolate import resize_bilinear_align_corners
from .layers import (
    BatchNorm2d,
    Conv2d,
    ConvTranspose2d,
    torch_default_conv_kernel_init,
)
from .xception import Xception


class ASPPModule(nn.Module):
    """Atrous branch: rate 1 → 1×1 conv; rate r > 1 → 3×3 conv with padding
    = dilation = r.  Conv (no bias) + BN + ReLU, kaiming-normal init."""

    def __init__(self, in_ch: int, features: int, rate: int, *,
                 dtype: torch.dtype, gen: torch.Generator):
        super().__init__()
        k, pad = (1, 0) if rate == 1 else (3, rate)
        self.atrous_conv = Conv2d(in_ch, features, k, padding=pad, dilation=rate,
                                  dtype=dtype, gen=gen)
        self.bn = BatchNorm2d(features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.atrous_conv(x), relu=True)


class DeconvUpsampler(nn.Module):
    """Transposed-conv decoder: four exact-×2 deconvs, with the 304→256
    refinement stack between deconv2 and deconv3 and no BN after the last.
    PyTorch-default init throughout.  Each BN+ReLU pair is one apply."""

    def __init__(self, in_ch: int, low_ch: int, n_classes: int, *,
                 dtype: torch.dtype, gen: torch.Generator):
        super().__init__()
        init = torch_default_conv_kernel_init
        kw = dict(dtype=dtype, gen=gen)
        self.deconv1 = ConvTranspose2d(in_ch, 256, **kw)
        self.deconv1_bn = BatchNorm2d(256, dtype=dtype)
        self.deconv2 = ConvTranspose2d(256, 256, **kw)
        self.deconv2_bn = BatchNorm2d(256, dtype=dtype)
        self.conv0 = Conv2d(256 + low_ch, 256, 3, padding=1, kernel_init=init, **kw)
        self.bn0 = BatchNorm2d(256, dtype=dtype)
        self.conv1 = Conv2d(256, 256, 3, padding=1, kernel_init=init, **kw)
        self.bn1 = BatchNorm2d(256, dtype=dtype)
        self.conv2 = Conv2d(256, 256, 1, use_bias=True, kernel_init=init, **kw)
        self.deconv3 = ConvTranspose2d(256, 256, **kw)
        self.deconv3_bn = BatchNorm2d(256, dtype=dtype)
        self.last_deconv = ConvTranspose2d(256, n_classes, **kw)

    def forward(self, x: torch.Tensor, low: torch.Tensor, size) -> torch.Tensor:
        """``size``, the input's (H, W), is what four exact x2 deconvs give."""
        x = self.deconv1_bn(self.deconv1(x), relu=True)
        x = self.deconv2_bn(self.deconv2(x), relu=True)
        x = torch.cat([x, low.to(x.dtype)], dim=1).contiguous(
            memory_format=torch.channels_last)
        x = self.bn0(self.conv0(x), relu=True)
        x = self.bn1(self.conv1(x), relu=True)
        x = self.conv2(x)
        x = self.deconv3_bn(self.deconv3(x), relu=True)
        return self.last_deconv(x)


class InterpolationUpsampler(nn.Module):
    """Bilinear-interpolation decoder: the ASPP output resized to a quarter
    of the input (ceil), the 304→256 refinement stack, a 1×1 conv with bias
    to the classes, and the logits resized to the input.  PyTorch-default
    init throughout."""

    def __init__(self, in_ch: int, low_ch: int, n_classes: int, *,
                 dtype: torch.dtype, gen: torch.Generator):
        super().__init__()
        init = torch_default_conv_kernel_init
        kw = dict(dtype=dtype, gen=gen)
        self.conv0 = Conv2d(in_ch + low_ch, 256, 3, padding=1, kernel_init=init, **kw)
        self.bn0 = BatchNorm2d(256, dtype=dtype)
        self.conv1 = Conv2d(256, 256, 3, padding=1, kernel_init=init, **kw)
        self.bn1 = BatchNorm2d(256, dtype=dtype)
        self.conv2 = Conv2d(256, n_classes, 1, use_bias=True, kernel_init=init, **kw)

    def forward(self, x: torch.Tensor, low: torch.Tensor, size) -> torch.Tensor:
        h, w = size
        x = resize_bilinear_align_corners(x, (-(-h // 4), -(-w // 4)))
        x = torch.cat([x, low.to(x.dtype)], dim=1).contiguous(
            memory_format=torch.channels_last)
        x = self.bn0(self.conv0(x), relu=True)
        x = self.bn1(self.conv1(x), relu=True)
        return resize_bilinear_align_corners(self.conv2(x), (h, w))


DECODERS = {"deconv": DeconvUpsampler, "interpolation": InterpolationUpsampler}
ASPP_RATES = {16: (1, 6, 12, 18), 8: (1, 12, 24, 36)}


class DeepLabv3plus(nn.Module):
    """DeepLabV3+ with the modified aligned Xception encoder.

    ``dtype`` is the compute type (bf16 on the card); parameters stay fp32.
    Weights are made from ``seed`` with a CPU ``torch.Generator`` and then
    moved to ``device``, so the same seed gives the same weights on any
    device.  ``train()`` / ``eval()`` select batch or running BN statistics.
    ``decoder`` is "deconv" (the reference's) or "interpolation"; output
    stride 8 needs the interpolation decoder.
    """

    def __init__(self, n_classes: int = 3, output_stride: int = 16, *,
                 decoder: str = "deconv", in_ch: int = 16,
                 dtype: torch.dtype = torch.float32, device="cuda", seed: int = 0):
        super().__init__()
        if decoder not in DECODERS:
            raise ValueError(f"unknown decoder {decoder!r}")
        if output_stride == 8 and decoder == "deconv":
            raise ValueError(
                "output_stride=8 needs decoder='interpolation': the deconv decoder's "
                "two x2 deconvs before the concat take stride-16 features to the "
                "low-level features' stride 4, and stride-8 features to stride 2")
        device = resolve_device(device)
        self.dtype, self.decoder = dtype, decoder
        gen = torch.Generator().manual_seed(seed)
        kw = dict(dtype=dtype, gen=gen)
        self.xception = Xception(in_ch, output_stride, **kw)
        self.rates = ASPP_RATES[output_stride]
        for i, r in enumerate(self.rates):
            setattr(self, f"aspp{i + 1}", ASPPModule(2048, 256, r, **kw))
        init = torch_default_conv_kernel_init
        self.gap_conv = Conv2d(2048, 256, 1, kernel_init=init, **kw)
        self.gap_bn = BatchNorm2d(256, dtype=dtype)
        self.conv1 = Conv2d(256 * 5, 256, 1, kernel_init=init, **kw)
        self.bn1 = BatchNorm2d(256, dtype=dtype)
        self.conv2 = Conv2d(128, 48, 1, kernel_init=init, **kw)
        self.bn2 = BatchNorm2d(48, dtype=dtype)
        self.upsample = DECODERS[decoder](256, 48, n_classes, **kw)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, C) NHWC → fp32 logits (N, H, W, n_classes) NHWC."""
        size = x.shape[1:3]
        x = x.permute(0, 3, 1, 2).to(self.dtype).contiguous(
            memory_format=torch.channels_last)
        feats, low_level = self.xception(x)
        branches = [getattr(self, f"aspp{i + 1}")(feats)
                    for i in range(len(self.rates))]
        # global-average-pool branch: fp32 mean → 1×1 conv → BN → ReLU →
        # align-corners upsample from 1×1, which is a broadcast
        gap = feats.float().mean(dim=(2, 3), keepdim=True).to(self.dtype)
        gap = self.gap_bn(self.gap_conv(gap), relu=True)
        branches.append(resize_bilinear_align_corners(gap, feats.shape[2:]))
        x = torch.cat(branches, dim=1).contiguous(memory_format=torch.channels_last)
        x = self.bn1(self.conv1(x), relu=True)
        low = self.bn2(self.conv2(low_level), relu=True)
        return self.upsample(x, low, size).float().permute(0, 2, 3, 1)
