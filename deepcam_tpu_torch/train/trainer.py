"""Training and eval steps (counterpart of ``deepcam_tpu/train/trainer.py``).

One device.  The JAX step is a pure function of an immutable state; here
the state holds the model and its optimizer, and a step updates both IN
PLACE: the fp32 parameters through the optimizer, the BN running statistics
during the forward (``BatchNorm2d`` in train mode).  The data-axis
``pmean``s of the JAX step are identities on one device; multi-GPU data
parallelism is a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from ..ops.classify import argmax_channels
from .losses import weighted_ce_loss
from .metrics import compute_score, per_sample_iou


@dataclass
class TrainState:
    """``step`` counts the train steps taken, which is also the
    optimizer's update count that a learning-rate schedule reads;
    ``epoch`` is the epoch in progress (0-based), as a checkpoint records
    it."""

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    epoch: int = 0


def create_train_state(model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer) -> TrainState:
    """``optimizer`` must have been built over ``model.parameters()``."""
    return TrainState(step=0, model=model, optimizer=optimizer)


def make_train_step(class_weights: Sequence[float], fpw_1: float = 0.0,
                    fpw_2: float = 0.0, with_iou: bool = True):
    """Returns ``step_fn(state, x, y) -> (state, metrics)``.

    ``x`` is the NHWC batch, ``y`` the (N, H, W) labels, both on the model's
    device.  ``metrics`` holds the fp32 scalar tensors ``loss`` and, with
    ``with_iou``, ``iou`` (argmax + ``compute_score`` on the step's logits);
    they stay on the device, so a step does not wait for the card.
    """
    weights = tuple(float(w) for w in class_weights)

    def step_fn(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        state.model.train()
        logits = state.model(x)
        loss = weighted_ce_loss(logits, y, weights, fpw_1, fpw_2)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        metrics = {"loss": loss.detach()}
        if with_iou:
            with torch.no_grad():
                metrics["iou"] = compute_score(argmax_channels(logits), y,
                                               num_classes=logits.shape[-1])
        return state, metrics

    return step_fn


def make_eval_step(class_weights: Sequence[float], fpw_1: float = 0.0,
                   fpw_2: float = 0.0):
    """Returns ``eval_fn(state, x, y, valid) -> (count, loss_sum, iou_sum)``.

    One entry per sample, as the reference's batch-1 validation: each
    sample's pixel-mean weighted CE and its own mean IoU, summed over the
    samples whose ``valid`` entry is 1 (a {0, 1} mask of shape (N,), so a
    padded batch counts each real sample once); ``count`` is the number of
    valid samples.  The model runs in eval mode on full-resolution logits,
    without gradients.  All three are fp32 scalar tensors on the device.
    """
    weights = tuple(float(w) for w in class_weights)

    def eval_fn(state: TrainState, x: torch.Tensor, y: torch.Tensor,
                valid: torch.Tensor):
        state.model.eval()
        with torch.no_grad():
            logits = state.model(x)
            losses = torch.stack([weighted_ce_loss(lg, lb, weights, fpw_1, fpw_2)
                                  for lg, lb in zip(logits, y)])
            ious = per_sample_iou(argmax_channels(logits), y, logits.shape[-1])
            v = valid.float()
            return v.sum(), (losses * v).sum(), (ious * v).sum()

    return eval_fn
