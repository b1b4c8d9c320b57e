"""Class-weighted pixel cross-entropy (counterpart of
``deepcam_tpu/train/losses.py``).

The reference's "false-positive penalty" mask terms are identically zero,
so the effective loss is ``mean(weight[label] * CE(logit, label))`` with the
mean over the pixel count, not the weight sum; ``fpw_1``/``fpw_2`` are kept
inert for interface parity.  Logits are NHWC (N, H, W, C); labels (N, H, W).
"""

from __future__ import annotations

from typing import Sequence

import torch

# Reference class pixel frequencies, raised to loss_weight_pow (default
# -0.125) to give the class weights.
CLASS_FREQUENCIES = (0.986267818390377, 0.0004578708870701058, 0.01327431072255291)
DEFAULT_LOSS_WEIGHT_POW = -0.125
FPW_1 = 2.61461122397522257612
FPW_2 = 1.71641974795896018744


def class_weights(loss_weight_pow: float = DEFAULT_LOSS_WEIGHT_POW):
    """``[f**p for f in CLASS_FREQUENCIES]``."""
    return tuple(f ** loss_weight_pow for f in CLASS_FREQUENCIES)


def weighted_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                     weight: Sequence[float], fpw_1: float = 0.0,
                     fpw_2: float = 0.0) -> torch.Tensor:
    """Mean over all pixels of ``weight[label] * cross_entropy``, in fp32."""
    del fpw_1, fpw_2  # inert, as in the reference
    logits = logits.float()
    labels = labels.long()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None])[..., 0]
    w = torch.tensor(weight, dtype=torch.float32, device=logits.device)[labels]
    return torch.mean(w * (lse - picked))
