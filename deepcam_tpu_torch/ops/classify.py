"""argmax over the class axis (counterpart of ``deepcam_tpu/ops/classify.py``)."""

from __future__ import annotations

import torch


def argmax_channels(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the trailing channel axis of (N, H, W, C) logits, as int32
    (N, H, W).  Ties keep the first maximal index, as jnp.argmax does."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
