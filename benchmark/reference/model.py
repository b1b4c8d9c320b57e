"""Plain DeepLabV3+ in fp32: the benchmark's reference, written from the
published architecture (mlcommons/hpc ``deepcam``
``src/deepCam/architecture/deeplab_xception.py``; Chen et al.,
arXiv:1802.02611), with no kernel, fusion or cache.

It imports nothing of the program: plain ``torch.nn.functional`` on a dict
of tensors named as ``arch.param_specs`` names them.  Train-mode BatchNorm
(batch statistics, biased variance for the apply, unbiased for the running
update, momentum 0.1, eps 1e-5); the reference's in-place ReLU aliasing:
a block that starts with a ReLU applies it to its input before the residual
split, so its skip path sees relu(input), and block2's leading ReLU also
rectifies the low-level features that the decoder reads.

``quant`` is applied to both operands of every convolution and to the
gradients that flow back to them (``quant.py``: identity for the
reference; ``fp8_e4m3`` gives the control, the same model computed with fp8
operands; ``bf16`` the reference at the program's precision).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from . import arch
from .quant import identity


class Forward:
    """One training forward over ``params`` (fp32 tensors, ``requires_grad``
    where they are parameters).  ``batch_stats`` collects each BN's (mean,
    unbiased variance) of this forward, for the running update the caller
    applies once per step."""

    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor],
                 quant: Callable = identity):
        self.cfg, self.p, self.quant = cfg, params, quant
        self.batch_stats: Dict[str, tuple] = {}

    # -- layers ---------------------------------------------------------------

    def conv(self, name, x, stride=1, padding=0, dilation=1, groups=1):
        w = self.p[f"{name}.weight"]
        y = F.conv2d(self.quant(x), self.quant(w), stride=stride, padding=padding,
                     dilation=dilation, groups=groups)
        b = self.p.get(f"{name}.bias")
        return y if b is None else y + b[:, None, None]

    def deconv(self, name, x):
        """ConvTranspose2d(k3, s2, p1, output_padding 1): an exact x2."""
        return F.conv_transpose2d(self.quant(x), self.quant(self.p[f"{name}.weight"]),
                                  stride=2, padding=1, output_padding=1)

    def bn(self, name, x, relu=False):
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        n = x.shape[0] * x.shape[2] * x.shape[3]
        self.batch_stats[name] = (mean.detach(), var.detach() * (n / max(n - 1, 1)))
        inv = torch.rsqrt(var + 1e-5) * self.p[f"{name}.weight"]
        y = (x - mean[:, None, None]) * inv[:, None, None] + self.p[f"{name}.bias"][:, None,
                                                                                   None]
        return torch.relu(y) if relu else y

    def sepconv(self, name, x, stride=1, dilation=1):
        """Depthwise 3x3 with the reference's 'same' padding (d on each side
        at dilation d), then pointwise 1x1; both without bias."""
        x = self.conv(f"{name}.depthwise", x, stride=stride, padding=dilation,
                      dilation=dilation, groups=x.shape[1])
        return self.conv(f"{name}.pointwise", x)

    def block(self, b: arch.Block, x):
        p = f"xception.{b.name}"
        if b.start_with_relu:
            x = torch.relu(x)  # in place in the reference: the skip sees it too
        inp = x
        for i in range(len(b.units)):
            if i > 0:
                x = torch.relu(x)
            x = self.sepconv(f"{p}.sepconv{i}", x, dilation=b.dilation)
            x = self.bn(f"{p}.bn{i}", x)
        if b.tail == "sepconv_stride":
            x = self.sepconv(f"{p}.sepconv_stride", x, stride=2)
        elif b.tail == "sepconv_last":
            x = self.sepconv(f"{p}.sepconv_last", x)
        skip = self.bn(f"{p}.skip_bn", self.conv(f"{p}.skip_conv", inp, stride=b.stride)) \
            if b.skip else inp
        return x + skip

    # -- model ----------------------------------------------------------------

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, C) fp32 → logits (N, H, W, n_classes) fp32."""
        cfg = self.cfg
        h, w = x.shape[1:3]
        x = x.permute(0, 3, 1, 2)
        x = self.bn("xception.bn1", self.conv("xception.conv1", x, stride=2, padding=1), True)
        x = self.bn("xception.bn2", self.conv("xception.conv2", x, padding=1), True)
        low = None
        for b in arch.blocks(cfg["output_stride"]):
            x = self.block(b, x)
            if b.name == "block1":
                low = torch.relu(x)  # block2's in-place ReLU rectifies the tap
        d = arch.exit_rate(cfg["output_stride"])
        x = self.bn("xception.bn3", self.sepconv("xception.conv3", x, dilation=d), True)
        x = self.bn("xception.bn4", self.sepconv("xception.conv4", x, dilation=d), True)
        x = self.bn("xception.bn5", self.sepconv("xception.conv5", x, dilation=d), True)
        feats = x
        branches = []
        for i, r in enumerate(arch.ASPP_RATES[cfg["output_stride"]]):
            y = self.conv(f"aspp{i + 1}.atrous_conv", feats, padding=0 if r == 1 else r,
                          dilation=r)
            branches.append(self.bn(f"aspp{i + 1}.bn", y, True))
        gap = feats.mean(dim=(2, 3), keepdim=True)
        gap = self.bn("gap_bn", self.conv("gap_conv", gap), True)
        branches.append(gap.expand(-1, -1, feats.shape[2], feats.shape[3]))
        x = self.bn("bn1", self.conv("conv1", torch.cat(branches, 1)), True)
        low = self.bn("bn2", self.conv("conv2", low), True)
        if cfg["decoder"] == "deconv":
            x = self.bn("upsample.deconv1_bn", self.deconv("upsample.deconv1", x), True)
            x = self.bn("upsample.deconv2_bn", self.deconv("upsample.deconv2", x), True)
            x = torch.cat([x, low], 1)
            x = self.bn("upsample.bn0", self.conv("upsample.conv0", x, padding=1), True)
            x = self.bn("upsample.bn1", self.conv("upsample.conv1", x, padding=1), True)
            x = self.conv("upsample.conv2", x)
            x = self.bn("upsample.deconv3_bn", self.deconv("upsample.deconv3", x), True)
            x = self.deconv("upsample.last_deconv", x)
        else:
            x = F.interpolate(x, size=(-(-h // 4), -(-w // 4)), mode="bilinear",
                              align_corners=True)
            x = torch.cat([x, low], 1)
            x = self.bn("upsample.bn0", self.conv("upsample.conv0", x, padding=1), True)
            x = self.bn("upsample.bn1", self.conv("upsample.conv1", x, padding=1), True)
            x = self.conv("upsample.conv2", x)
            x = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True)
        return x.permute(0, 2, 3, 1)


def forward(cfg: dict, params: Dict[str, torch.Tensor], x: torch.Tensor,
            quant: Callable = identity, stats: Optional[dict] = None) -> torch.Tensor:
    """Logits of one training forward; each BN's batch (mean, unbiased
    variance) goes into ``stats`` when given."""
    fwd = Forward(cfg, params, quant)
    out = fwd(x)
    if stats is not None:
        stats.update(fwd.batch_stats)
    return out
