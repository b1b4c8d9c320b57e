"""Bilinear resize with ``align_corners=True`` (counterpart of
``deepcam_tpu/ops/interpolate.py``).

The reference resizes with ``F.interpolate(..., mode='bilinear',
align_corners=True)``.  The JAX package writes that as two dense matmuls
with constant interpolation matrices, a TPU layout device outside any
Pallas kernel; the port calls ``F.interpolate`` itself, in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear_align_corners(x: torch.Tensor, size) -> torch.Tensor:
    """Resize NCHW ``x`` (any memory format) to spatial ``size=(H, W)`` with
    align_corners=True, computed in fp32 and cast back to ``x.dtype``.  An
    unchanged size returns ``x``; a 1x1 input broadcasts (a view)."""
    out_h, out_w = size
    n, c, h, w = x.shape
    if (h, w) == (out_h, out_w):
        return x
    if (h, w) == (1, 1):
        return x.expand(n, c, out_h, out_w)
    y = F.interpolate(x.float(), size=(out_h, out_w), mode="bilinear", align_corners=True)
    return y.to(x.dtype)
