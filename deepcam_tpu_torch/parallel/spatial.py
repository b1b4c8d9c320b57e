"""Spatial H-sharding (counterpart of ``deepcam_tpu/parallel/spatial.py``).

``--spatial S`` splits each sample's H over the S ranks of a spatial group
(``core/mesh.py:init_spatial_groups``).  Every op of the model keeps its
unsharded code and runs on the local H-shard with its own zero padding:
the fused sepconv kernels, cuDNN's convs and deconvs.  Its only error
against the unsharded op is in the edge rows, whose taps saw zeros where
the neighbours' rows were.  Those taps are additive (each op is a sum of
taps, and the elementwise pre-ops act per row before the taps), so the fix
is

    y[edge rows] += taps(neighbour's edge rows) · kernel,

computed as small strips of plain PyTorch ops outside the kernels.  The
neighbour's rows arrive through an all-gather over the group, and the
global edges receive zeros, which the strips (linear in the received rows)
turn into the zero padding of the unsharded op.  Gradients are exact by
construction: the kernels' backward is the exact backward of the local
term, the strips are autograd-visible, and the exchange's backward sends
each row's cotangent back to the rank that sent the row.

The exchange is one form on every backend: each rank writes its rows into
its slot of a zero-filled fp32 (S, ...) buffer, and an all-reduce over the
group sums the buffers.  Gloo takes CUDA tensors for ``all_reduce`` (it
stages them through the host) on every version, where its ``all_gather``
of CUDA tensors and ``reduce_scatter`` depend on the version; one form is
what the CPU tests and the card's two-rank phase run.  The backward of the
gather is the group's sum of the cotangent (an all-reduce), of which a rank
keeps its own slot.

BatchNorm under spatial mode averages (E[x], E[x²]) over the statistics
group that the mode names (``stats_group``; ``models/layers.py``).  By
default that is the spatial group, so each group computes exactly the
statistics of one reference DDP rank, which never syncs BN across ranks.
``world_stats=True`` (the gspmd step, ``parallel/gspmd.py``) names the
world instead: the statistics of the whole global batch.  The ASPP region
runs on the gathered full-H features, replicated in the group
(``replicated_region``), and its output is sliced back to this rank's rows;
there the statistics are plain by default, and under world statistics
averaged over the data groups, each group's copy counted once.

Two faults of the JAX module are not copied: its Σy² correction drops the
cross term of the two strips when d ≤ H_shard < 2d (here it is computed
over the union of the edge rows, from all that each row received), and it
does not check that shards are even at stride 2 and at least as tall as
the dilation (here ``check_shard`` raises).

Layouts: the sepconv strips take NHWC tensors with ``dwk`` (3, 3, C) and
``pwk`` (C, F), as the kernel wrapper does; the conv and deconv strips take
the layers' NCHW tensors and torch-layout weights.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..core import mesh
from ..ops.classify import argmax_channels
from ..train.losses import weighted_ce_loss
from ..train.metrics import iou_counts, iou_from_counts
from ..train.trainer import TrainState, average_gradients, average_running_stats
from .collectives import allreduce_mean_

# ---------------------------------------------------------------------------
# context
# ---------------------------------------------------------------------------

_GROUP = None
_SIZE = 1
_INDEX = 0
_ACTIVE = False
_STATS = None       # the StatsGroup of the sharded layers' BN, or None
_REPLICATED = None  # ... of the replicated region's


@dataclass(frozen=True)
class StatsGroup:
    """The ranks whose train-mode BN statistics are one batch's:
    (E[x], E[x²]) are the sum over ``group`` (None: the world) of each
    rank's ``weight`` times its own, divided by ``ranks``, and the count
    of the unbiased variance is the local one times ``count``.  A weight
    of 0 marks a rank whose statistics another rank of its spatial group
    already adds (the replicated region's copies)."""

    group: Optional[object]
    ranks: int
    weight: float
    count: int

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` averaged over the group, differentiably."""
        return _GroupMean.apply(t, self.group, self.ranks, self.weight)


def spatial_active() -> bool:
    """True inside ``spatial_mode`` and outside ``replicated_region``: the
    layers then add their strips."""
    return _ACTIVE


def stats_group() -> Optional[StatsGroup]:
    """The group over which train-mode BN averages its batch statistics
    here, or None for this rank's own."""
    return _STATS


def _set(group, size, index, active, stats, replicated):
    global _GROUP, _SIZE, _INDEX, _ACTIVE, _STATS, _REPLICATED
    prev = (_GROUP, _SIZE, _INDEX, _ACTIVE, _STATS, _REPLICATED)
    _GROUP, _SIZE, _INDEX, _ACTIVE, _STATS, _REPLICATED = (group, size, index, active, stats,
                                                           replicated)
    return prev


@contextlib.contextmanager
def spatial_mode(group, size: int, world_stats: bool = False):
    """The model's layers run on H-shards inside the block: ``group`` is
    the spatial group's process group.  Backward passes may run after the
    block: the exchanges keep their group.  At ``size`` 1 (``group`` None)
    there is nothing to exchange and the mode changes nothing: the layers
    run their unsharded code, to the same bits.

    BN's statistics group is the spatial group, or with ``world_stats``
    all W ranks of the process group (count x W), and in the replicated
    region the D = W / S data groups (count x D: every rank of a group
    holds the same full-H rows there, and only the group's first adds
    them)."""
    if size > 1 and group is None:
        raise ValueError(f"spatial_mode of size {size} needs its process group")
    index = torch.distributed.get_rank(group) if size > 1 else 0
    if size > 1 and torch.distributed.get_world_size(group) != size:
        raise ValueError(f"spatial_mode of size {size} over a group of "
                         f"{torch.distributed.get_world_size(group)}")
    stats = replicated = None
    if world_stats:
        world = mesh.get_size()
        if world % size:
            raise ValueError(f"spatial_mode of size {size} in a world of {world}")
        if world > 1:
            stats = StatsGroup(None, world, 1.0, world)
        if world > size:
            d = world // size
            replicated = StatsGroup(None, d, float(index == 0), d)
    elif size > 1:
        stats = StatsGroup(group, size, 1.0, size)
    prev = _set(group, size, index, size > 1, stats, replicated)
    try:
        yield
    finally:
        _set(*prev)


@contextlib.contextmanager
def replicated_region():
    """Suspends the spatial behaviours for a region whose tensors hold all
    H rows, the same on every rank of the group (the gathered ASPP
    region): convs add no strip, and BN takes the region's statistics
    group (``spatial_mode``): plain statistics by default, since a sync
    over the group would only inflate the unbiased variance's count."""
    prev = _set(_GROUP, _SIZE, _INDEX, False, _REPLICATED, _REPLICATED)
    try:
        yield
    finally:
        _set(*prev)


# ---------------------------------------------------------------------------
# collectives over the spatial group
# ---------------------------------------------------------------------------

def _sum_fp32(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``, in fp32, returned in t's type."""
    buf = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    buf.copy_(t)
    torch.distributed.all_reduce(buf, group=group)
    return buf.to(t.dtype)


class _Gather(torch.autograd.Function):
    """(S, *t.shape): every member's ``t``, in group order."""

    @staticmethod
    def forward(ctx, t, group, size, index):
        ctx.group, ctx.index = group, index
        buf = torch.zeros((size,) + t.shape, dtype=torch.float32, device=t.device)
        buf[index] = t
        torch.distributed.all_reduce(buf, group=group)
        return buf.to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return _sum_fp32(g, ctx.group)[ctx.index], None, None, None


class _GroupMean(torch.autograd.Function):
    """Σ over the group of ``weight · t``, divided by ``size``; its
    backward is the same mean of the cotangent, times this rank's weight
    (each rank's loss reads the same mean)."""

    @staticmethod
    def forward(ctx, t, group, size, weight):
        ctx.group, ctx.size, ctx.weight = group, size, weight
        return _sum_fp32(t * weight, group) / size

    @staticmethod
    def backward(ctx, g):
        return _sum_fp32(g, ctx.group) / ctx.size * ctx.weight, None, None, None


def _gather(t: torch.Tensor) -> torch.Tensor:
    if _SIZE == 1:
        return t[None]
    return _Gather.apply(t, _GROUP, _SIZE, _INDEX)


def group_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the spatial group, without a gradient (the metrics'
    counts)."""
    return t if _SIZE == 1 else _sum_fp32(t, _GROUP)


# ---------------------------------------------------------------------------
# halo movement
# ---------------------------------------------------------------------------

def _neighbour(got: torch.Tensor, step: int) -> torch.Tensor:
    """Slot ``index + step`` of a gather, zeros past the group's ends.
    Every rank reads a slot (the edges' times zero), so that every rank
    builds the same graph: the autograd engine then runs the exchanges of
    the backward in the same order on every rank, as the collectives
    require."""
    j = _INDEX + step
    return got[j % _SIZE] * float(0 <= j < _SIZE)


def halo(top: torch.Tensor, bot: torch.Tensor):
    """(the previous rank's ``bot``, the next rank's ``top``), in one
    exchange: for my top edge the rows above it, for my bottom edge the
    rows below it.  The first rank receives zeros from above and the last
    from below: the global zero padding."""
    both = _gather(torch.stack([top, bot]))
    return _neighbour(both[:, 1], -1), _neighbour(both[:, 0], 1)


def recv_from_prev(rows: torch.Tensor) -> torch.Tensor:
    """The previous rank's ``rows`` (its last rows, for my top halo);
    zeros on the first rank."""
    return _neighbour(_gather(rows), -1)


def recv_from_next(rows: torch.Tensor) -> torch.Tensor:
    """The next rank's ``rows`` (its first rows, for my bottom halo);
    zeros on the last rank."""
    return _neighbour(_gather(rows), 1)


def gather_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The H-shards joined along ``dim`` into the full-H tensor, the same
    on every rank of the group."""
    return x if _SIZE == 1 else torch.cat(_gather(x).unbind(0), dim=dim)


def my_rows(x_full: torch.Tensor, hs: int, dim: int) -> torch.Tensor:
    """This rank's ``hs`` rows of a full-H tensor."""
    return x_full.narrow(dim, _INDEX * hs, hs)


def check_shard(rows: int, stride: int = 1, dilation: int = 1, where: str = "") -> None:
    """Raises where an H-shard of ``rows`` rows cannot be corrected by the
    strips: odd at a stride-2 op (its windows would straddle the shards
    unevenly), or shorter than the dilation (a halo would need a rank two
    away)."""
    if stride == 2 and rows % 2:
        raise ValueError(
            f"{where}: an H-shard of {rows} rows at a stride-2 op; every stride level "
            "needs even shards: use an input H divisible by S times the output stride")
    if rows < dilation:
        raise ValueError(
            f"{where}: an H-shard of {rows} rows is shorter than the dilation {dilation}: "
            "use fewer spatial ranks (--spatial) or a taller input")


# ---------------------------------------------------------------------------
# correction strips
# ---------------------------------------------------------------------------

def _dw_row_taps(rows: torch.Tensor, krow: torch.Tensor, dilation: int) -> torch.Tensor:
    """The depthwise taps of one kernel row over an NHWC strip, in fp32:
    out[n, r, w, c] = Σ_j rows[n, r, w + (j−1)·dilation, c] · krow[j, c],
    zero past the W edges."""
    w, d = rows.shape[2], dilation
    padded = F.pad(rows.float(), (0, 0, d, d))
    k = krow.float()
    acc = None
    for j in range(3):
        term = padded[:, :, j * d:j * d + w] * k[j]
        acc = term if acc is None else acc + term
    return acc


def _pointwise(t32: torch.Tensor, pwk: torch.Tensor, dtype) -> torch.Tensor:
    """The unit's pointwise product of a depthwise strip: rounded to
    ``dtype`` first, as the kernel rounds d, then an fp32 product rounded
    to ``dtype``."""
    return torch.matmul(t32.to(dtype).float(), pwk.float()).to(dtype)


def sepconv_strip_fix(y, h_top, h_bot, dwk, pwk, dilation: int, stats=None):
    """Adds the taps that crossed the shard edges to a stride-1 sepconv
    unit's local output ``y`` (N, Hs, W, F), NHWC.

    ``h_top``, ``h_bot``: this rank's first and last ``dilation`` rows of
    the unit's depthwise input (after its ReLU, BN apply or boundary), sent
    to the neighbours.  Rows r < d miss the taps of kernel row 0 at
    h[r − d], the previous rank's last rows; rows r ≥ Hs − d miss kernel
    row 2 at h[r + d], the next rank's first rows.

    ``stats=(Σy, Σy²)``, the kernel's sums of the local y, are returned
    with each edge row's change: Σc and Σ(2·y·c + c²) over the union of the
    edge rows, where c is all the row received, both strips' where they
    overlap (d ≤ Hs < 2d).  Returns ``(y_fixed, stats_fixed)``, the
    statistics None without them."""
    d, hs = dilation, y.shape[1]
    check_shard(hs, dilation=d, where="sepconv unit")
    prev_rows, next_rows = halo(h_top, h_bot)
    top = _pointwise(_dw_row_taps(prev_rows, dwk[0], d), pwk, y.dtype)
    bot = _pointwise(_dw_row_taps(next_rows, dwk[2], d), pwk, y.dtype)
    fixed = y.clone()
    fixed[:, :d] += top
    fixed[:, -d:] += bot
    if stats is None:
        return fixed, None
    if hs >= 2 * d:
        old = torch.cat([y[:, :d], y[:, -d:]], 1).float()
        c = torch.cat([top, bot], 1).float()
    else:  # the strips overlap: every row is an edge row
        old = y.float()
        c = (F.pad(top.float(), (0, 0, 0, 0, 0, hs - d))
             + F.pad(bot.float(), (0, 0, 0, 0, hs - d, 0)))
    s1, s2 = stats
    return fixed, (s1 + c.sum((0, 1, 2)), s2 + (c * (2.0 * old + c)).sum((0, 1, 2)))


def dw_s2_strip_fix(y, h_bot, dwk, pwk):
    """The stride-2 sepconv tail (depthwise 3×3, stride 2, padding 1, then
    pointwise), NHWC: output row 0 misses kernel row 0 at h[−1], the
    previous rank's last row; the bottom rows read only local rows when
    shards are even.  ``h_bot`` is this rank's last row of the depthwise
    input."""
    prev_row = recv_from_prev(h_bot)
    # out[0, ow] reads h[-1, 2·ow + j − 1]: the stride-1 taps at even columns
    corr = _pointwise(_dw_row_taps(prev_row, dwk[0], 1)[:, :, 0::2], pwk, y.dtype)
    fixed = y.clone()
    fixed[:, :1] += corr
    return fixed


def conv3x3_strip_fix(y, x, weight, stride: int, dilation: int = 1):
    """A dense 3×3 conv with padding = dilation (the entry convs and the
    decoder's refinement convs), NCHW: ``y`` its local output, ``x`` its
    local input, ``weight`` (F, C, 3, 3).  Stride 1 at any dilation;
    stride 2 at dilation 1, where output row 0 alone reads a row above the
    shard."""
    d = dilation
    w = weight.to(y.dtype)

    def row_conv(rows, krow):
        return F.conv2d(rows.to(y.dtype), krow, stride=(1, stride), padding=(0, d),
                        dilation=(1, d))

    fixed = y.clone()
    if stride == 1:
        check_shard(x.shape[2], dilation=d, where="3x3 conv")
        prev_rows, next_rows = halo(x[:, :, :d], x[:, :, -d:])
        fixed[:, :, :d] += row_conv(prev_rows, w[:, :, 0:1])
        fixed[:, :, -d:] += row_conv(next_rows, w[:, :, 2:3])
        return fixed
    if stride != 2 or d != 1:
        raise ValueError(f"3x3 conv strips take stride 1, or stride 2 at dilation 1; "
                         f"got stride {stride}, dilation {d}")
    check_shard(x.shape[2], stride=2, where="3x3 conv")
    fixed[:, :, :1] += row_conv(recv_from_prev(x[:, :, -1:]), w[:, :, 0:1])
    return fixed


def deconv_k3s2_strip_fix(y, x, weight):
    """The ×2 transposed conv (kernel 3, stride 2, padding 1, output
    padding 1), NCHW, ``weight`` (C, F, 3, 3).  Along H, out[2i] =
    x[i]·w[1] and out[2i+1] = x[i]·w[2] + x[i+1]·w[0], so the one term
    across the shard edge is the last local odd row reading the next
    rank's first row, through kernel row 0: a W-direction deconv of that
    row."""
    next_row = recv_from_next(x[:, :, :1])
    corr = F.conv_transpose2d(next_row.to(y.dtype), weight[:, :, 0:1].to(y.dtype),
                              stride=(1, 2), padding=(0, 1), output_padding=(0, 1))
    fixed = y.clone()
    fixed[:, :, -1:] += corr
    return fixed


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def per_sample_iou_spatial(preds, labels, num_classes: int) -> torch.Tensor:
    """(N,) per-sample mean IoUs of H-shards: each sample's tp, fp and fn
    summed over the group before the ratio."""
    return iou_from_counts(group_sum(iou_counts(preds, labels, num_classes)))


def compute_score_spatial(preds, labels, num_classes: int) -> torch.Tensor:
    """The mean IoU of the group's whole batch, from H-shards: the exact
    ``metrics.compute_score`` of the full images."""
    return per_sample_iou_spatial(preds.reshape(1, -1), labels.reshape(1, -1),
                                  num_classes)[0]


# ---------------------------------------------------------------------------
# train and eval steps
# ---------------------------------------------------------------------------

def shard_update(state: TrainState, x: torch.Tensor, y: torch.Tensor, weights, fpw_1: float,
                 fpw_2: float, remat: bool):
    """The update of a train step on this rank's rows, inside the caller's
    ``spatial_mode``: the forward (under ``torch.utils.checkpoint`` with
    ``remat``), this rank's loss (the pixel mean of its rows), the backward
    of it (whose exchanges route the cotangents across the shards), the
    gradients averaged over all W ranks in one all-reduce, as JAX's
    ``pmean(grads, ('data', 'spatial'))``, and the optimizer's update.
    The all-reduce runs after the backward rather than through DDP's
    buckets, so that the group's exchanges inside the backward never
    interleave with another communicator's.  Returns the logits and the
    loss."""
    state.model.train()
    logits = state.model(x, remat=remat)
    loss = weighted_ce_loss(logits, y, weights, fpw_1, fpw_2)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    average_gradients(state.model)
    state.optimizer.step()
    state.step += 1
    return logits, loss


def make_train_step_spatial(class_weights: Sequence[float], fpw_1: float = 0.0,
                            fpw_2: float = 0.0, with_iou: bool = True, remat: bool = False):
    """The train step of ``train/trainer.py:make_train_step`` for a rank
    of a spatial group (``core/mesh.py:init_spatial_groups``): ``x`` and
    ``y`` are this rank's rows of its group's batch.  Each group plays one
    reference DDP rank: BN statistics over the group, the update of
    ``shard_update``; the running statistics averaged as in the
    data-parallel step; the loss averaged over the ranks and the IoU of the
    group's counts averaged over the groups.  ``remat`` recomputes the
    forward in the backward (``models/layers.py:rematerialized``)."""
    weights = tuple(float(w) for w in class_weights)

    def step_fn(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        groups = mesh.spatial_groups()
        with spatial_mode(groups.group, groups.size):
            logits, loss = shard_update(state, x, y, weights, fpw_1, fpw_2, remat)
            with torch.no_grad():
                average_running_stats(state.model)
                metrics = {"loss": loss.detach()}
                if with_iou:
                    metrics["iou"] = compute_score_spatial(argmax_channels(logits), y,
                                                           logits.shape[-1])
                means = allreduce_mean_(torch.stack(list(metrics.values())))
        return state, dict(zip(metrics, means.unbind()))

    return step_fn


def make_eval_step_spatial(class_weights: Sequence[float], fpw_1: float = 0.0,
                           fpw_2: float = 0.0):
    """The eval step of ``train/trainer.py:make_eval_step`` for a rank of
    a spatial group: ``(state, x, y, valid) -> (count, loss_sum,
    iou_sum)``, each sample's loss the mean of the group's (equal) shards'
    pixel means and its IoU from the group's counts.  Only the group's
    first rank returns the sums; the others return zeros, so that
    ``cli/train.py:validate``'s sum over all ranks counts each sample
    once."""
    weights = tuple(float(w) for w in class_weights)

    def eval_fn(state: TrainState, x: torch.Tensor, y: torch.Tensor,
                valid: torch.Tensor):
        groups = mesh.spatial_groups()
        state.model.eval()
        with torch.no_grad(), spatial_mode(groups.group, groups.size):
            logits = state.model(x)
            losses = torch.stack([weighted_ce_loss(lg, lb, weights, fpw_1, fpw_2)
                                  for lg, lb in zip(logits, y)])
            counts = iou_counts(argmax_channels(logits), y, logits.shape[-1])
            # one exchange for the losses and the counts
            summed = group_sum(torch.cat([losses[:, None], counts.flatten(1)], 1))
            losses = summed[:, 0] / groups.size
            ious = iou_from_counts(summed[:, 1:].reshape(counts.shape))
            v = valid.float() * float(groups.index == 0)
            return v.sum(), (losses * v).sum(), (ious * v).sum()

    return eval_fn

