"""IoU score (counterpart of ``deepcam_tpu/train/metrics.py``): per-class
tp/fp/fn from argmax predictions, class IoU = tp/(tp+fp+fn) with an empty
union scoring 1.0, and the unweighted mean over classes."""

from __future__ import annotations

import torch


def compute_score(predictions: torch.Tensor, labels: torch.Tensor,
                  num_classes: int = 3) -> torch.Tensor:
    """Mean IoU over classes, treating the whole (batched) input as one
    sample.  Returns an fp32 scalar tensor on the inputs' device."""
    p = predictions.long()
    t = labels.long()
    equal = p == t
    iou_sum = torch.zeros((), dtype=torch.float32, device=p.device)
    for j in range(num_classes):
        is_t = t == j
        is_p = p == j
        tp = (equal & is_t).sum().float()
        fp = (~equal & is_p).sum().float()
        fn = (~equal & is_t).sum().float()
        union = tp + fp + fn
        iou_sum = iou_sum + torch.where(union > 0, tp / union.clamp_min(1.0),
                                        torch.ones_like(union))
    return iou_sum / num_classes
