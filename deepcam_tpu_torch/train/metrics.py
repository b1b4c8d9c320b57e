"""IoU score (counterpart of ``deepcam_tpu/train/metrics.py``): per-class
tp/fp/fn from argmax predictions, class IoU = tp/(tp+fp+fn) with an empty
union scoring 1.0, and the unweighted mean over classes."""

from __future__ import annotations

import torch


def per_sample_iou(predictions: torch.Tensor, labels: torch.Tensor,
                   num_classes: int = 3) -> torch.Tensor:
    """(N,) fp32 per-sample mean IoU: each sample scored on its own, as the
    reference's batch-1 validation loop scores them."""
    p = predictions.long().flatten(1)
    t = labels.long().flatten(1)
    equal = p == t
    iou_sum = torch.zeros(p.shape[0], dtype=torch.float32, device=p.device)
    for j in range(num_classes):
        is_t = t == j
        is_p = p == j
        tp = (equal & is_t).sum(1).float()
        fp = (~equal & is_p).sum(1).float()
        fn = (~equal & is_t).sum(1).float()
        union = tp + fp + fn
        iou_sum = iou_sum + torch.where(union > 0, tp / union.clamp_min(1.0),
                                        torch.ones_like(union))
    return iou_sum / num_classes


def compute_score(predictions: torch.Tensor, labels: torch.Tensor,
                  num_classes: int = 3) -> torch.Tensor:
    """Mean IoU over classes, treating the whole (batched) input as one
    sample.  Returns an fp32 scalar tensor on the inputs' device."""
    return per_sample_iou(predictions.reshape(1, -1), labels.reshape(1, -1), num_classes)[0]
