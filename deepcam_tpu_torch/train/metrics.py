"""IoU score (counterpart of ``deepcam_tpu/train/metrics.py``): per-class
tp/fp/fn from argmax predictions, class IoU = tp/(tp+fp+fn) with an empty
union scoring 1.0, and the unweighted mean over classes."""

from __future__ import annotations

import torch


def iou_counts(predictions: torch.Tensor, labels: torch.Tensor,
               num_classes: int = 3) -> torch.Tensor:
    """(N, num_classes, 3) fp32: each sample's tp, fp and fn per class.
    Counts of H-shards add up to the full image's (``parallel/spatial.py``)."""
    p = predictions.long().flatten(1)
    t = labels.long().flatten(1)
    equal = p == t
    per_class = []
    for j in range(num_classes):
        is_t = t == j
        is_p = p == j
        per_class.append(torch.stack([(equal & is_t).sum(1), (~equal & is_p).sum(1),
                                      (~equal & is_t).sum(1)], 1))
    return torch.stack(per_class, 1).float()


def iou_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """(N,) fp32 mean IoU over classes from ``iou_counts``."""
    iou_sum = torch.zeros(counts.shape[0], dtype=torch.float32, device=counts.device)
    for j in range(counts.shape[1]):
        tp, fp, fn = counts[:, j].unbind(1)
        union = tp + fp + fn
        iou_sum = iou_sum + torch.where(union > 0, tp / union.clamp_min(1.0),
                                        torch.ones_like(union))
    return iou_sum / counts.shape[1]


def per_sample_iou(predictions: torch.Tensor, labels: torch.Tensor,
                   num_classes: int = 3) -> torch.Tensor:
    """(N,) fp32 per-sample mean IoU: each sample scored on its own, as the
    reference's batch-1 validation loop scores them."""
    return iou_from_counts(iou_counts(predictions, labels, num_classes))


def compute_score(predictions: torch.Tensor, labels: torch.Tensor,
                  num_classes: int = 3) -> torch.Tensor:
    """Mean IoU over classes, treating the whole (batched) input as one
    sample.  Returns an fp32 scalar tensor on the inputs' device."""
    return per_sample_iou(predictions.reshape(1, -1), labels.reshape(1, -1), num_classes)[0]
