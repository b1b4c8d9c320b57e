"""DeepCAM training CLI of the port (counterpart of
``deepcam_tpu/cli/train.py``).

    python -m deepcam_tpu_torch.cli.train --data_dir_prefix <root> ...
    torchrun --nproc_per_node N -m deepcam_tpu_torch.cli.train --device cuda ...

Emits the reference's MLPerf key contract, uses its seeds and
hyperparameters, stops at the same criterion (validation mean IoU >=
``--target_iou``) and writes ``<prefix>_step_<N>.cpt`` checkpoints in the
reference's schema.  Each process drives one device (``--device``, CUDA by
default, where ``cuda`` means ``cuda:LOCAL_RANK``; the CPU runs the
kernels' plain versions).  Under torchrun the processes form one
data-parallel group (``core/mesh.py``): each reads its shard of the
datasets, the global batch is ``--local_batch_size`` times the world size,
validation counts every sample once over uneven shards, and rank 0 alone
writes the MLPerf log and the checkpoints.

``--spatial S`` (``parallel/spatial.py``) splits the world into groups of S
consecutive ranks, S dividing the ranks on each host; a group plays one
data-parallel rank.  Its ranks read the same samples (the datasets are
sharded over the W/S groups), each keeps H/S rows of every sample before
the copy to the device, and ``--local_batch_size`` is per group, as in the
JAX CLI.  BN statistics sync over the group, gradients average over all
ranks, and validation counts each sample once per group.  With
``--spatial_impl gspmd`` (``parallel/gspmd.py``) the same groups and shards
run with BN statistics synced over the whole world and the train metrics
of the global batch; at ``--spatial 1`` the flag changes nothing, as in
the JAX CLI.  ``--remat`` recomputes the forward inside the backward
(``models/layers.py:rematerialized``) in whichever train step runs; the
gradient histograms of ``--enable_wandb`` read that step's gradients.

``--model`` chooses DeepLabV3+ (the default: output stride 16, the deconv
decoder) or FC-DenseNet103 (``models/tiramisu.py``), which runs the same
train and eval steps, DDP and checkpoints, and takes neither ``--spatial``
above 1 nor ``--remat``.

``main(pargs)`` builds the HDF5 datasets and calls ``train_loop(pargs,
train_set, validation_set)``, which takes any pair of ``CamDataset``s (for
example ``MemoryCamDataset``).

Not ported: the space-to-depth host feed (a TPU layout device), the orbax
checkpoint format and ``--wireup_method jax`` (TPU settings); the last two
flags raise.

With nonzero visualization frequencies rank 0 plots one sample's eval-mode
prediction against its label into ``<output_dir>/plots`` (``obs/visualizer.py``,
which needs matplotlib), and ``--enable_wandb`` logs the scalars, the
plots and parameter and gradient histograms through ``obs/wandb_utils.py``,
inert where wandb is not installed.
"""

from __future__ import annotations

import argparse as ap
import functools
import os
import time
from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch


class StoreDictKeyPair(ap.Action):
    """``--lr_schedule type=multistep,milestones="15000 25000",decay_rate=0.1``."""

    def __call__(self, parser, namespace, values, option_string=None):
        my_dict = {}
        for kv in values.split(","):
            k, v = kv.split("=")
            my_dict[k] = v
        setattr(namespace, self.dest, my_dict)


def build_parser() -> ap.ArgumentParser:
    AP = ap.ArgumentParser(description="DeepCAM training (PyTorch/CUDA port)")
    AP.add_argument("--wireup_method", type=str, default="auto",
                    choices=["auto", "jax", "dummy"],
                    help="auto: join a process group (NCCL for a CUDA --device, "
                         "gloo for the CPU) when torchrun's variables WORLD_SIZE, "
                         "RANK, LOCAL_RANK, MASTER_ADDR and MASTER_PORT are set, "
                         "else run one process; dummy: never; jax is the TPU "
                         "wireup and raises")
    AP.add_argument("--run_tag", type=str, default="deepcam-tpu")
    AP.add_argument("--output_dir", type=str, default="./output")
    AP.add_argument("--checkpoint", type=str, default=None)
    AP.add_argument("--data_dir_prefix", type=str, default="/")
    AP.add_argument("--max_inter_threads", type=int, default=4,
                    help="Maximum number of concurrent readers")
    AP.add_argument("--max_epochs", type=int, default=30)
    AP.add_argument("--save_frequency", type=int, default=100)
    AP.add_argument("--validation_frequency", type=int, default=100)
    AP.add_argument("--max_validation_steps", type=int, default=None)
    AP.add_argument("--logging_frequency", type=int, default=100)
    AP.add_argument("--training_visualization_frequency", type=int, default=0,
                    help="plot a training sample every N steps (0: never)")
    AP.add_argument("--validation_visualization_frequency", type=int, default=0,
                    help="plot a validation sample in each validation (0: never)")
    AP.add_argument("--local_batch_size", type=int, default=1,
                    help="Samples per device per step")
    AP.add_argument("--channels", type=int, nargs="+", default=list(range(16)))
    AP.add_argument("--optimizer", type=str, default="Adam",
                    choices=["Adam", "AdamW", "LAMB"])
    AP.add_argument("--start_lr", type=float, default=1e-3)
    AP.add_argument("--adam_eps", type=float, default=1e-8)
    AP.add_argument("--weight_decay", type=float, default=1e-6)
    AP.add_argument("--loss_weight_pow", type=float, default=-0.125)
    AP.add_argument("--lr_warmup_steps", type=int, default=0)
    AP.add_argument("--lr_warmup_factor", type=float, default=1.0)
    AP.add_argument("--lr_schedule", action=StoreDictKeyPair, default=None)
    AP.add_argument("--target_iou", type=float, default=0.82)
    AP.add_argument("--model_prefix", type=str, default="model")
    AP.add_argument("--amp_opt_level", type=str, default="O1",
                    help="O0 = fp32 compute; O1/O2 = bf16 compute with fp32 parameters")
    AP.add_argument("--enable_wandb", action="store_true",
                    help="log to Weights & Biases from rank 0 (inert without wandb)")
    AP.add_argument("--wandb_certdir", type=str, default=None,
                    help="directory holding the .wandbirc credentials")
    AP.add_argument("--resume_logging", action="store_true")
    AP.add_argument("--seed", type=int, default=333)
    AP.add_argument("--remat", action="store_true",
                    help="recompute the forward inside the backward, keeping only the "
                         "model's input, as the JAX step's remat policy does: one more "
                         "forward per step; the peak memory stays, since the replay "
                         "rebuilds the whole forward before the backward uses it")
    AP.add_argument("--eval_local_batch_size", type=int, default=32,
                    help="Per-device validation batch (semantics stay per-sample "
                         "via the validity mask; the reference hardcodes 1)")
    AP.add_argument("--async_checkpoint", action="store_true",
                    help="write checkpoints from a background thread (save_stop "
                         "then logs the snapshot, not the publish)")
    AP.add_argument("--checkpoint_format", type=str, default="torch",
                    choices=["torch", "orbax"],
                    help="torch = one torch.save file in the reference's schema; "
                         "orbax is a TPU format and raises")
    AP.add_argument("--spatial", type=int, default=1,
                    help="Spatial partitioning factor: each sample's H split over "
                         "groups of this many consecutive ranks (1: pure data "
                         "parallel); it must divide the ranks on each host")
    AP.add_argument("--spatial_impl", type=str, default="shard_map",
                    choices=["shard_map", "gspmd"],
                    help="with --spatial > 1: shard_map keeps BN statistics per "
                         "spatial group (one reference DDP rank each); gspmd syncs them "
                         "over all ranks (the global batch's, count x world) and "
                         "reports the global batch's loss and IoU; both run the "
                         "halo-strip path")
    AP.add_argument("--device", type=str, default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    AP.add_argument("--model", type=str, default="deeplabv3p",
                    choices=["deeplabv3p", "fcdensenet103"],
                    help="deeplabv3p: DeepLabV3+ at output stride 16 with the deconv "
                         "decoder (the reference's); fcdensenet103: the 103-layer "
                         "Tiramisu (models/tiramisu.py), without --spatial or --remat")
    return AP


def check_supported(pargs) -> None:
    """Raises for a flag that asks for something the port does not do."""
    refused = {
        "--checkpoint_format orbax (a TPU format)": pargs.checkpoint_format == "orbax",
        "--wireup_method jax (the TPU wireup)": pargs.wireup_method == "jax",
        "--remat with --model fcdensenet103": pargs.model == "fcdensenet103" and pargs.remat,
        "--spatial > 1 with --model fcdensenet103": (pargs.model == "fcdensenet103"
                                                    and pargs.spatial > 1),
    }
    bad = [k for k, v in refused.items() if v]
    if bad:
        raise NotImplementedError("the PyTorch port does not take: " + "; ".join(bad))


@dataclass
class LoopResult:
    """``metrics``: the JAX CLI's ``final_metrics``.  ``state``: the
    train state at the end of the run.  ``timings``: host seconds of the
    train steps (epoch wall time without validation and saves; the loop
    waits for the card only on logging steps), of the data wait inside it
    (blocked on the loader, the next batch's assembly and the copy to the
    card), of validation and of checkpoint saves, with their counts; per
    step, the data wait before it (``wait_ms``); and ``span_steps``, the
    run's entries of the span record (``profiling/spans.py``, reset when
    the loop starts; the last ``spans.MAX_STEPS``), one per train step that
    has spans (``make_train_step``'s; the spatial and gspmd steps have
    none): each a dict of host nanoseconds and counts, ``step.ns`` the
    step's host enqueue, ``step.forward.ns``, ``step.backward.ns`` and
    ``step.optimizer.ns`` its phases, ``data.read``/``data.wait``/
    ``data.stage`` (``.ns``, ``.n``) the loader's work since the previous
    step (a validation's included), and ``sepconv.fwd``/``sepconv.bwd``
    (``.ns``, ``.n``) the fused units' host calls in the step."""

    metrics: dict
    state: object
    timings: Dict[str, object] = field(default_factory=dict)


def compute_dtype(amp_opt_level: str) -> torch.dtype:
    """``O0``: fp32 compute; any other level (O1, O2): bf16 compute with
    fp32 parameters, the JAX CLI's reading of the reference's AMP
    levels."""
    return torch.float32 if amp_opt_level == "O0" else torch.bfloat16


def make_datasets(pargs, dataset_cls=None):
    """(train_set, validation_set) under ``--data_dir_prefix``, as the
    CLI shards and normalizes them: this rank's data group's shard (all of
    it without a process group), and this rank's rows of each sample in a
    spatial group.  ``dataset_cls`` defaults to the HDF5 ``CamDataset``."""
    from ..core.mesh import data_index, data_size, spatial_index, spatial_size
    from ..data.dataset import CamDataset

    cls = dataset_cls or CamDataset
    root = pargs.data_dir_prefix
    statsfile = os.path.join(root, "stats.h5")
    common = dict(channels=pargs.channels, comm_size=data_size(), comm_rank=data_index(),
                  h_shard=(spatial_index(), spatial_size()),
                  bf16_out=compute_dtype(pargs.amp_opt_level) == torch.bfloat16)
    train_set = cls(os.path.join(root, "train"), statsfile,
                    allow_uneven_distribution=False, shuffle=True, **common)
    validation_set = cls(os.path.join(root, "validation"), statsfile,
                         allow_uneven_distribution=True,
                         shuffle=pargs.max_validation_steps is not None, **common)
    return train_set, validation_set


def main(pargs) -> dict:
    """Joins the process group (``--wireup_method``), splits it into the
    spatial groups, builds this rank's datasets and trains; leaves the
    group if it joined it, and forgets the spatial groups."""
    from ..core.mesh import (destroy_distributed, device_for, forget_spatial_groups,
                             init_distributed, init_spatial_groups)

    check_supported(pargs)
    created = init_distributed(pargs.wireup_method, device_for(pargs.device))
    try:
        init_spatial_groups(pargs.spatial)
        return train_loop(pargs, *make_datasets(pargs)).metrics
    finally:
        forget_spatial_groups()
        if created:
            destroy_distributed()


def validate(state, eval_step, loader, device, budget=None, on_first_batch=None):
    """One validation over this rank's shard, ``loader.dataset``, in eval
    calls of ``loader.batch_size``: ``(count, loss_sum, iou_sum)`` summed over
    the process group's ranks in float64, the same on every rank.

    ``budget`` caps the samples each rank evaluates.  Every rank issues the
    same number of calls: a shorter shard (the last rank takes the remainder
    of an uneven split) pads with ``valid=0`` batches, and a trailing partial
    batch is padded the same way, so each sample counts once.  Batches go to
    the card while the previous eval step runs, and the partials stay there
    until one sum over calls and ranks and one fetch at the end.
    ``on_first_batch(data, label, names)`` is called once, after the eval
    step of the first batch that holds a real sample (the CLI's validation
    plot)."""
    from ..data.pipeline import prefetch_to_device
    from ..parallel.collectives import allreduce_sum_

    ds, eval_batch = loader.dataset, loader.batch_size
    comm_size = max(ds.comm_size, 1)
    max_local = ds.global_size // comm_size + ds.global_size % comm_size
    n_calls = -(-max_local // eval_batch)
    if budget is not None:
        n_calls = min(n_calls, -(-budget // eval_batch))
    dtype = torch.bfloat16 if ds.bf16_out else torch.float32

    def host_batches():
        seen_local = 0
        it = iter(loader)
        try:
            for _ in range(n_calls):
                batch = next(it, None)
                if batch is None:  # a shard with fewer batches: pad-only
                    yield (torch.zeros((eval_batch,) + ds.data_shape, dtype=dtype),
                           torch.zeros((eval_batch,) + ds.label_shape, dtype=torch.int32),
                           torch.zeros((eval_batch,), dtype=torch.float32), ())
                    continue
                data, label, names = batch
                n = data.shape[0]
                valid = torch.ones((n,), dtype=torch.float32)
                if budget is not None and seen_local + n > budget:
                    valid[max(0, budget - seen_local):] = 0.0
                if n < eval_batch:  # pad the trailing partial batch
                    pad = eval_batch - n
                    data = torch.cat([data, data.new_zeros((pad,) + data.shape[1:])])
                    label = torch.cat([label, label.new_zeros((pad,) + label.shape[1:])])
                    valid = torch.cat([valid, valid.new_zeros((pad,))])
                seen_local += n
                if budget is not None:
                    seen_local = min(seen_local, budget)
                yield data, label, valid, names
        finally:
            it.close()  # a budget can stop before the loader's end

    partials = []
    for d, lb, v, names in prefetch_to_device(host_batches(), device):
        partials.append(torch.stack(eval_step(state, d, lb, v)))
        if on_first_batch is not None and names:
            on_first_batch(d, lb, names)
            on_first_batch = None
    return tuple(allreduce_sum_(torch.stack(partials).double().sum(0)).tolist())


def train_loop(pargs, train_set, validation_set) -> LoopResult:
    """The training run of ``cli/train.py:main`` over the given datasets,
    which are this rank's shards of the process group in place (if any),
    split into spatial groups of ``--spatial`` ranks
    (``core/mesh.py:init_spatial_groups``)."""
    from ..ckpt.checkpoint import (AsyncCheckpointWriter, checkpoint_path,
                                   restore_checkpoint, save_checkpoint)
    from ..core.mesh import device_for, get_rank, spatial_groups
    from ..data.pipeline import DataLoader, prefetch_to_device
    from ..models.deeplab import DeepLabv3plus
    from ..models.tiramisu import FCDenseNet103
    from ..obs.mlperf_log import MLPerfLogger
    from ..obs.wandb_utils import WandbLogger
    from ..ops.classify import argmax_channels
    from ..ops.native import as_bf16_tensor
    from ..train.losses import FPW_1, FPW_2, class_weights
    from ..train.optim import build_optimizer
    from ..train.schedule import get_lr_schedule
    from ..parallel.gspmd import make_train_step_gspmd
    from ..parallel.spatial import make_eval_step_spatial, make_train_step_spatial
    from ..profiling import spans
    from ..train.trainer import create_train_state, make_eval_step, make_train_step

    check_supported(pargs)
    device = device_for(pargs.device)
    groups, rank = spatial_groups(), get_rank()
    if groups.size != pargs.spatial:
        raise ValueError(f"--spatial {pargs.spatial} in spatial groups of {groups.size}: "
                         "call core.mesh.init_spatial_groups first")
    n_replicas = groups.data_size  # the data-parallel width: one per spatial group
    want = (n_replicas, groups.data_index, (groups.index, groups.size))
    for ds in (train_set, validation_set):
        if (ds.comm_size, ds.comm_rank, ds.h_shard) != want:
            raise ValueError(f"a dataset sharded as {ds.comm_rank} of {ds.comm_size} with rows "
                             f"{ds.h_shard}, at data group {want[1]} of {n_replicas} and "
                             f"rows {want[2]}")

    pargs.logging_frequency = max(pargs.logging_frequency, 1)
    log_file = os.path.normpath(os.path.join(pargs.output_dir, "logs", pargs.run_tag + ".log"))
    logger = MLPerfLogger(log_file, "deepcam", "deepcam_tpu")
    try:
        logger.log_start(key="init_start", sync=True)
        logger.log_event(key="cache_clear")
        seed = pargs.seed
        logger.log_event(key="seed", value=seed)
        torch.manual_seed(seed)
        visualize = (pargs.training_visualization_frequency > 0
                     or pargs.validation_visualization_frequency > 0)
        plot_dir = os.path.join(pargs.output_dir, "plots")
        if rank == 0:
            os.makedirs(pargs.output_dir, exist_ok=True)
            if visualize:
                os.makedirs(plot_dir, exist_ok=True)
        wb = WandbLogger(
            enable=pargs.enable_wandb, rank=rank, certdir=pargs.wandb_certdir,
            run_tag=pargs.run_tag, resume_logging=pargs.resume_logging,
            config={"root_dir": pargs.data_dir_prefix, "output_dir": pargs.output_dir,
                    "max_epochs": pargs.max_epochs,
                    "local_batch_size": pargs.local_batch_size, "num_workers": n_replicas,
                    "channels": pargs.channels, "optimizer": pargs.optimizer,
                    "start_lr": pargs.start_lr, "adam_eps": pargs.adam_eps,
                    "weight_decay": pargs.weight_decay, "model_prefix": pargs.model_prefix,
                    "amp_opt_level": pargs.amp_opt_level,
                    "loss_weight_pow": pargs.loss_weight_pow,
                    "lr_warmup_steps": pargs.lr_warmup_steps,
                    "lr_warmup_factor": pargs.lr_warmup_factor,
                    **{f"lr_schedule_{k}": v for k, v in (pargs.lr_schedule or {}).items()}})

        global_batch_size = pargs.local_batch_size * n_replicas
        logger.log_event(key="global_batch_size", value=global_batch_size)
        logger.log_event(key="opt_name", value=pargs.optimizer)
        logger.log_event(key="opt_base_learning_rate",
                         value=pargs.start_lr * pargs.lr_warmup_factor)
        logger.log_event(key="opt_learning_rate_warmup_steps", value=pargs.lr_warmup_steps)
        logger.log_event(key="opt_learning_rate_warmup_factor", value=pargs.lr_warmup_factor)
        logger.log_event(key="opt_epsilon", value=pargs.adam_eps)

        dtype = compute_dtype(pargs.amp_opt_level)
        if pargs.model == "fcdensenet103":
            model = FCDenseNet103(n_classes=3, in_ch=len(pargs.channels), dtype=dtype,
                                  device=device, seed=seed)
        else:
            model = DeepLabv3plus(n_classes=3, output_stride=16, in_ch=len(pargs.channels),
                                  dtype=dtype, device=device, seed=seed)
        pinned = device.type == "cuda"
        train_loader = DataLoader(
            train_set, pargs.local_batch_size, drop_last=True, pin_memory=pinned,
            num_workers=min(pargs.max_inter_threads, pargs.local_batch_size))
        eval_batch = pargs.eval_local_batch_size
        validation_loader = DataLoader(
            validation_set, eval_batch, drop_last=False, pin_memory=pinned,
            num_workers=min(pargs.max_inter_threads, eval_batch))

        logger.log_event(key="train_samples", value=train_set.global_size)
        if pargs.max_validation_steps is not None:
            # the reference bounds this with the TRAIN batch size though its
            # eval loop runs batch 1; the evaluated-sample budget below does
            # not depend on the batch size
            val_size = min(validation_set.global_size,
                           pargs.max_validation_steps * pargs.local_batch_size * n_replicas)
        else:
            val_size = validation_set.global_size
        logger.log_event(key="eval_samples", value=val_size)
        if pargs.max_validation_steps is not None:
            logger.log_event(key="invalid_submission")

        lr_sched = get_lr_schedule(pargs.start_lr, pargs.lr_schedule,
                                   warmup_steps=pargs.lr_warmup_steps,
                                   warmup_factor=pargs.lr_warmup_factor)
        opt = build_optimizer(pargs.optimizer, model.parameters(), lr_sched,
                              eps=pargs.adam_eps, weight_decay=pargs.weight_decay)
        state = create_train_state(model, opt)
        if pargs.checkpoint:
            state, _ = restore_checkpoint(pargs.checkpoint, state)

        weights = list(class_weights(pargs.loss_weight_pow))
        make_train, make_eval = make_train_step, make_eval_step
        if groups.size > 1:
            make_eval = make_eval_step_spatial  # gspmd's too: eval reads no batch statistics
            make_train = (make_train_step_gspmd if pargs.spatial_impl == "gspmd"
                          else make_train_step_spatial)
        train_step = make_train(weights, fpw_1=FPW_1, fpw_2=FPW_2, remat=pargs.remat)
        eval_step = make_eval(weights, fpw_1=FPW_1, fpw_2=FPW_2)
        ckpt_writer = AsyncCheckpointWriter() if pargs.async_checkpoint else None
        # the wandb.watch analogue: histograms at 10x the scalars' cadence
        watch_every = 10 * pargs.logging_frequency
        viz = None
        if visualize and rank == 0:
            from ..obs.visualizer import CamVisualizer

            viz = CamVisualizer()

        def visualize_sample(data, label, names, step, prefix, dataset):
            """One random real sample of the batch, predicted in eval mode at
            batch 1, plotted against its label; the plot goes to wandb as
            ``<prefix>_examples``.  In a spatial group the batch holds this
            rank's rows, so the sample is read whole from ``dataset`` and
            predicted unsharded.  The next train step sets train mode
            again."""
            idx = int(np.random.randint(0, len(names)))
            if groups.size > 1:
                d, lb = dataset.full_sample(names[idx])
                d = as_bf16_tensor(d) if d.dtype == np.uint16 else torch.from_numpy(d)
                data, label, idx = d[None].to(device), torch.from_numpy(lb)[None], 0
            state.model.eval()
            with torch.no_grad():
                pred = argmax_channels(state.model(data[idx:idx + 1]))
            outputfile = os.path.join(plot_dir, os.path.basename(names[idx]).replace(
                "data-", prefix + "-").replace(".h5", ".png"))
            viz.plot(names[idx], outputfile, data[idx, :, :, 0].float().cpu().numpy(),
                     pred[0].cpu().numpy(), label[idx].cpu().numpy())
            wb.log_image(f"{prefix}_examples", outputfile, "Prediction vs. Ground Truth",
                         step)

        step = state.step
        epoch = state.epoch
        stop_training = False
        timings = dict.fromkeys(("train_s", "data_wait_s", "validation_s", "save_s"), 0.0)
        timings.update(steps=0, validation_samples=0, saves=0, wait_ms=[])
        spans.reset()

        logger.log_end(key="init_stop", sync=True)
        logger.log_start(key="run_start", sync=True)
        run_start_time = time.time()

        def run_validation(epoch, step):
            nonlocal stop_training
            logger.log_start(key="eval_start", metadata={"epoch_num": epoch + 1})
            # the reference's batch-1 loop breaks only AFTER processing
            # sample max_validation_steps+1 (a post-increment check): a
            # per-rank sample budget, whatever the eval batch (the JAX CLI
            # multiplies it by the replicas of its process: here one); every
            # rank reads the same totals, and so takes the same stop decision
            budget = None
            if pargs.max_validation_steps is not None:
                budget = pargs.max_validation_steps + 1
            plot = None
            if viz is not None and pargs.validation_visualization_frequency > 0:
                plot = functools.partial(visualize_sample, step=step, prefix="validation",
                                         dataset=validation_set)
            count, loss_sum, iou_sum = validate(state, eval_step, validation_loader, device,
                                                budget, plot)
            loss_avg_val = loss_sum / max(count, 1.0)
            iou_avg_val = iou_sum / max(count, 1.0)
            logger.log_event(key="eval_accuracy", value=iou_avg_val,
                             metadata={"epoch_num": epoch + 1, "step_num": step})
            logger.log_event(key="eval_loss", value=loss_avg_val,
                             metadata={"epoch_num": epoch + 1, "step_num": step})
            wb.log({"eval_loss": loss_avg_val, "eval_accuracy": iou_avg_val}, step)
            if iou_avg_val >= pargs.target_iou:
                logger.log_event(key="target_accuracy_reached", value=pargs.target_iou,
                                 metadata={"epoch_num": epoch + 1, "step_num": step})
                stop_training = True
            logger.log_end(key="eval_stop", metadata={"epoch_num": epoch + 1})
            return loss_avg_val, iou_avg_val, count

        final_metrics = {"step": step, "epoch": epoch, "eval_iou": None,
                         "eval_samples_seen": None}

        while True:
            logger.log_start(key="epoch_start",
                             metadata={"epoch_num": epoch + 1, "step_num": step}, sync=True)
            t_epoch = time.perf_counter()
            t_other = 0.0
            batches = prefetch_to_device(train_loader, device)
            while True:
                t0 = time.perf_counter()
                item = next(batches, None)
                t1 = time.perf_counter()
                timings["data_wait_s"] += t1 - t0
                if item is None:
                    break
                timings["wait_ms"].append((t1 - t0) * 1e3)
                data, label, names = item
                state, metrics = train_step(state, data, label)
                step += 1
                timings["steps"] += 1
                # lr used by the update just taken: the optimizer's count
                # was step-1 inside it
                current_lr = float(lr_sched(step - 1))
                if (viz is not None and pargs.training_visualization_frequency > 0
                        and step % pargs.training_visualization_frequency == 0):
                    visualize_sample(data, label, names, step, "training", train_set)

                if step % pargs.logging_frequency == 0:
                    loss_avg = float(metrics["loss"])
                    iou_avg = float(metrics["iou"])
                    md = {"epoch_num": epoch + 1, "step_num": step}
                    logger.log_event(key="learning_rate", value=current_lr, metadata=md)
                    logger.log_event(key="train_accuracy", value=iou_avg, metadata=md)
                    logger.log_event(key="train_loss", value=loss_avg, metadata=md)
                    wb.log({"train_loss": loss_avg, "train_accuracy": iou_avg,
                            "learning_rate": current_lr}, step)
                    if step % watch_every == 0:  # gradients as the step left them
                        wb.watch(state.model, step)

                if step % pargs.validation_frequency == 0:
                    t0 = time.perf_counter()
                    _, eval_iou, eval_count = run_validation(epoch, step)
                    dt = time.perf_counter() - t0
                    timings["validation_s"] += dt
                    timings["validation_samples"] += int(eval_count)
                    t_other += dt
                    final_metrics["eval_iou"] = eval_iou
                    final_metrics["eval_samples_seen"] = eval_count

                if pargs.save_frequency > 0 and step % pargs.save_frequency == 0:
                    t0 = time.perf_counter()
                    md = {"epoch_num": epoch + 1, "step_num": step}
                    logger.log_start(key="save_start", metadata=md, sync=True)
                    cpath = checkpoint_path(pargs.output_dir, pargs.model_prefix, step)
                    if ckpt_writer is not None:
                        ckpt_writer.save(cpath, state, epoch)
                    else:
                        save_checkpoint(cpath, state, epoch)
                    logger.log_end(key="save_stop", metadata=md, sync=True)
                    dt = time.perf_counter() - t0
                    timings["save_s"] += dt
                    timings["saves"] += 1
                    t_other += dt

                if stop_training:
                    break
            batches.close()
            timings["train_s"] += time.perf_counter() - t_epoch - t_other

            logger.log_end(key="epoch_stop",
                           metadata={"epoch_num": epoch + 1, "step_num": step}, sync=True)
            epoch += 1
            state.epoch = epoch
            if epoch >= pargs.max_epochs or stop_training:
                break

        if ckpt_writer is not None:
            ckpt_writer.wait()  # publish the last checkpoint before run_stop
        logger.log_end(key="run_stop", sync=True, metadata={"status": "success"})
        final_metrics.update(step=step, epoch=epoch, wall_time=time.time() - run_start_time)
        timings["span_steps"] = spans.steps()
        return LoopResult(final_metrics, state, timings)
    finally:
        logger.close()


if __name__ == "__main__":
    main(build_parser().parse_args())
