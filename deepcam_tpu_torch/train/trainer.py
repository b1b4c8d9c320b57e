"""Training and eval steps (counterpart of ``deepcam_tpu/train/trainer.py``).

The JAX step is a pure function of an immutable state; here the state holds
the model and its optimizer, and a step updates both IN PLACE: the fp32
parameters through the optimizer, the BN running statistics during the
forward (``BatchNorm2d`` in train mode).

Data parallelism is one process per device in a ``torch.distributed``
group (``core/mesh.py``).  Under a group the train step does what the JAX
step does over its mesh's data axis (``trainer.py:162-200``):

* BN batch statistics stay per rank, as each reference DDP rank computes
  them: the model runs under ``DistributedDataParallel`` with
  ``broadcast_buffers=False``;
* DDP's all-reduce averages the gradients during the backward (JAX's
  ``pmean(grads)``), so the optimizer, LAMB's global-norm clip included,
  sees the averaged gradients;
* after the update the BN running statistics are averaged over ranks in
  one collective (JAX's ``pmean(new_bs)``; DDP by default would broadcast
  rank 0's instead);
* loss and IoU are averaged over ranks, on the device.

The eval step returns this rank's (count, loss_sum, iou_sum); the CLI's
validation (``cli/train.py:validate``) sums a whole validation's partials
over ranks in one collective (JAX's ``psum``, which runs per call).
Without a group both steps are the one-device steps.

The train step is the root span ``step`` of ``profiling/spans.py``, which
closes the step's entry of the span record, with the phases
``step.forward`` (the model and the loss), ``step.backward`` (clearing the
gradients and the backward, with DDP's overlapped all-reduce) and
``step.optimizer`` inside it; IoU and the means over ranks are the root's
own time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch
from torch.nn.parallel import DistributedDataParallel

from ..core.mesh import initialized_dist
from ..ops.classify import argmax_channels
from ..parallel.collectives import allreduce_mean_
from ..profiling.spans import span
from .losses import weighted_ce_loss
from .metrics import compute_score, per_sample_iou


@dataclass
class TrainState:
    """``step`` counts the train steps taken, which is also the
    optimizer's update count that a learning-rate schedule reads;
    ``epoch`` is the epoch in progress (0-based), as a checkpoint records
    it.  ``replica`` is the model's ``DistributedDataParallel`` wrapper,
    built by the first train step under a process group; ``model`` stays
    the module itself (checkpoints, eval and the weight bridge read it)."""

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    epoch: int = 0
    replica: Optional[DistributedDataParallel] = field(default=None, repr=False)


def create_train_state(model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer) -> TrainState:
    """``optimizer`` must have been built over ``model.parameters()``."""
    return TrainState(step=0, model=model, optimizer=optimizer)


def _replica(state: TrainState) -> Optional[DistributedDataParallel]:
    """The state's DDP wrapper under a process group (built once: its
    construction broadcasts rank 0's parameters and buffers), else None.
    Every parameter reaches the loss on every step, so DDP needs no search
    for unused parameters."""
    if initialized_dist() is None:
        return None
    if state.replica is None:
        dev = next(state.model.parameters()).device
        state.replica = DistributedDataParallel(
            state.model, device_ids=[dev.index] if dev.type == "cuda" else None,
            broadcast_buffers=False, gradient_as_bucket_view=True)
    return state.replica


def running_stats(model: torch.nn.Module):
    """Every BN running mean and variance of ``model``, in module order."""
    return [b for name, b in model.named_buffers()
            if name.endswith(("running_mean", "running_var"))]


def average_running_stats(model: torch.nn.Module) -> None:
    """Each BN running statistic replaced by its mean over ranks, through
    one all-reduce of all of them flattened."""
    stats = running_stats(model)
    flat = allreduce_mean_(torch.cat([b.reshape(-1) for b in stats]))
    torch._foreach_copy_(stats, list(flat.split([b.numel() for b in stats])))


def average_gradients(model: torch.nn.Module) -> None:
    """Each parameter's gradient replaced by its mean over ranks, through
    one all-reduce of all of them flattened (the spatial step's, which
    runs without DDP)."""
    grads = [p.grad for p in model.parameters()]
    flat = allreduce_mean_(torch.cat([g.reshape(-1) for g in grads]))
    torch._foreach_copy_(grads, [f.view_as(g) for f, g in
                                 zip(flat.split([g.numel() for g in grads]), grads)])


def make_train_step(class_weights: Sequence[float], fpw_1: float = 0.0,
                    fpw_2: float = 0.0, with_iou: bool = True, remat: bool = False):
    """Returns ``step_fn(state, x, y) -> (state, metrics)``.

    ``x`` is the NHWC batch, ``y`` the (N, H, W) labels, both on the model's
    device.  ``metrics`` holds the fp32 scalar tensors ``loss`` and, with
    ``with_iou``, ``iou`` (argmax + ``compute_score`` on the step's logits);
    they stay on the device, so a step does not wait for the card.  Under a
    process group ``x`` and ``y`` are this rank's share of the global batch,
    the step is the data-parallel one of the module docstring, and the
    metrics are the means over ranks.

    ``remat`` (JAX's ``remat=True``) keeps only the model's input and
    parameters from the forward and runs the forward again inside the
    backward (``models/layers.py:rematerialized``): the same values, each
    forward kernel launched twice per step.  Under DDP the flag passes
    through ``DDP.forward`` to the model, so the replay never reenters
    DDP.
    """
    weights = tuple(float(w) for w in class_weights)

    def step(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        state.model.train()
        replica = _replica(state)
        with span("step.forward"):
            logits = (state.model if replica is None else replica)(x, remat=remat)
            loss = weighted_ce_loss(logits, y, weights, fpw_1, fpw_2)
        with span("step.backward"):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with span("step.optimizer"):
            state.optimizer.step()
        state.step += 1
        metrics = {"loss": loss.detach()}
        if with_iou:
            with torch.no_grad():
                metrics["iou"] = compute_score(argmax_channels(logits), y,
                                               num_classes=logits.shape[-1])
        if replica is not None:
            with torch.no_grad():
                average_running_stats(state.model)
                means = allreduce_mean_(torch.stack(list(metrics.values())))
            metrics = dict(zip(metrics, means.unbind()))
        return state, metrics

    def step_fn(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        # the root span also covers the autograd graph's teardown when
        # ``step`` returns (1-2 ms of host time a step at full width)
        with span("step"):
            return step(state, x, y)

    return step_fn


def make_eval_step(class_weights: Sequence[float], fpw_1: float = 0.0,
                   fpw_2: float = 0.0):
    """Returns ``eval_fn(state, x, y, valid) -> (count, loss_sum, iou_sum)``.

    One entry per sample, as the reference's batch-1 validation: each
    sample's pixel-mean weighted CE and its own mean IoU, summed over the
    samples whose ``valid`` entry is 1 (a {0, 1} mask of shape (N,), so a
    padded batch counts each real sample once); ``count`` is the number of
    valid samples.  The model runs in eval mode on full-resolution logits,
    without gradients.  All three are fp32 scalar tensors on the device,
    over this rank's samples only: under a process group the caller sums
    them over ranks (``cli/train.py:validate`` does, once per validation).
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
