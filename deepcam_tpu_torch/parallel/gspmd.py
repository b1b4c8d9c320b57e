"""Data × spatial training with BatchNorm synced over the world
(counterpart of ``deepcam_tpu/parallel/gspmd.py``, ``--spatial_impl
gspmd``).

The JAX module writes one step for the global batch and lets XLA's SPMD
partitioner shard N over 'data' and H over 'spatial'.  Its semantics
differ from the halo step's (``parallel/spatial.py``) in two ways, both
intended (``gspmd.py:11-17``): BN's statistics are those of the whole
global batch (sync-BN over all W ranks), and the loss and IoU are the
global batch's.  The result is the math of one device on the global
batch.

The port runs that math on the halo path of ``parallel/spatial.py``: the
same spatial groups, row shards, strips, exchanges and gathered ASPP
region, around the same CUDA kernels.  Only the statistics group changes
(``spatial_mode(world_stats=True)``): (E[x], E[x²]) averaged over the W
ranks with the count times W, and in the replicated ASPP region, whose
rows every rank of a group holds alike, over the D data groups with the
count times D.  The gradients average over the W ranks as in the halo
step; for equal shards the mean of the ranks' pixel-mean losses is the
global pixel mean, and its gradient the global batch's.  Every rank
computes its running statistics from the same all-reduced sums, so they
are identical on all ranks without an average (the tests and
``chip_smoke.py`` check the bits).

No eval step of its own: eval-mode BN reads the running statistics, and no
statistics group enters the eval, so ``spatial.make_eval_step_spatial`` is
this path's eval step as it stands (per-sample loss and IoU over the
shards, counted once per group).  ``batch_spec`` has no counterpart: the
CLI's row shards (``cli/train.py:make_datasets``) place the data.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core import mesh
from ..ops.classify import argmax_channels
from ..train.metrics import iou_counts, iou_from_counts
from ..train.trainer import TrainState
from .collectives import allreduce_sum_
from .spatial import shard_update, spatial_mode


def global_score(preds: torch.Tensor, labels: torch.Tensor, num_classes: int,
                 loss: torch.Tensor):
    """(the mean of ``loss`` over the ranks, the mean IoU of the global
    batch) from this rank's rows: every rank's class counts summed before
    the ratio, ``metrics.compute_score`` of the whole global batch.  One
    all-reduce, in float64, so that the counts stay exact past 2^24
    pixels."""
    counts = iou_counts(preds.reshape(1, -1), labels.reshape(1, -1), num_classes)
    summed = allreduce_sum_(torch.cat([loss.detach().reshape(1), counts.reshape(-1)]).double())
    iou = iou_from_counts(summed[1:].reshape(counts.shape))[0]
    return (summed[0] / mesh.get_size()).float(), iou.float()


def make_train_step_gspmd(class_weights: Sequence[float], fpw_1: float = 0.0,
                          fpw_2: float = 0.0, remat: bool = False):
    """JAX's ``make_train_step_gspmd`` for a rank of a spatial group
    (``core/mesh.py:init_spatial_groups``): ``x`` and ``y`` are this rank's
    rows of its data group's samples.  The update of
    ``spatial.shard_update`` under world statistics; ``metrics`` the loss
    averaged over the ranks and the global batch's IoU (``global_score``),
    as the JAX step always reports them.  ``remat`` recomputes the forward in the backward,
    its exchanges and statistics all-reduces included, in the same order
    on every rank."""
    weights = tuple(float(w) for w in class_weights)

    def step_fn(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        groups = mesh.spatial_groups()
        with spatial_mode(groups.group, groups.size, world_stats=True):
            logits, loss = shard_update(state, x, y, weights, fpw_1, fpw_2, remat)
        with torch.no_grad():
            loss, iou = global_score(argmax_channels(logits), y, logits.shape[-1], loss)
        return state, {"loss": loss, "iou": iou}

    return step_fn
