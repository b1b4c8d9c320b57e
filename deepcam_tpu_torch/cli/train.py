"""DeepCAM training CLI of the port (counterpart of
``deepcam_tpu/cli/train.py``).

    python -m deepcam_tpu_torch.cli.train --data_dir_prefix <root> ...

Emits the reference's MLPerf key contract, uses its seeds and
hyperparameters, stops at the same criterion (validation mean IoU >=
``--target_iou``) and writes ``<prefix>_step_<N>.cpt`` checkpoints in the
reference's schema.  One process drives one device (``--device``, CUDA by
default; the CPU runs the kernels' plain versions); multi-GPU data
parallelism is a later slice.

``main(pargs)`` builds the HDF5 datasets and calls ``train_loop(pargs,
train_set, validation_set)``, which takes any pair of ``CamDataset``s (for
example ``MemoryCamDataset``).

Not ported, because they are TPU layout devices or TPU-only settings: the
space-to-depth host feed, spatial partitioning (``--spatial`` > 1,
``--spatial_impl gspmd``), rematerialization (``--remat``), the orbax
checkpoint format and ``--wireup_method jax``.  The visualizer and the
wandb shim belong to a later slice.  Each of these flags raises.
"""

from __future__ import annotations

import argparse as ap
import os
import time
from dataclasses import dataclass, field
from typing import Dict

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
                    help="Distributed wireup: one process per device here; "
                         "'jax' is the TPU wireup and raises")
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
                    help="not ported yet: a nonzero value raises")
    AP.add_argument("--validation_visualization_frequency", type=int, default=0,
                    help="not ported yet: a nonzero value raises")
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
                    help="not ported yet: raises")
    AP.add_argument("--wandb_certdir", type=str, default=None,
                    help="wandb certificates directory (wandb is not ported yet)")
    AP.add_argument("--resume_logging", action="store_true")
    AP.add_argument("--seed", type=int, default=333)
    AP.add_argument("--remat", action="store_true",
                    help="TPU-only (rematerialization of the middle flow): raises")
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
                    help="Spatial partitioning factor; only 1 (pure data "
                         "parallel) is ported, more raises")
    AP.add_argument("--spatial_impl", type=str, default="shard_map",
                    choices=["shard_map", "gspmd"],
                    help="TPU spatial implementation; gspmd raises")
    AP.add_argument("--device", type=str, default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return AP


def check_supported(pargs) -> None:
    """Raises for a flag that asks for something the port does not do."""
    refused = {
        "--spatial > 1 (spatial partitioning is a TPU device)": pargs.spatial > 1,
        "--spatial_impl gspmd (a TPU partitioner path)": pargs.spatial_impl == "gspmd",
        "--remat (a TPU memory device)": pargs.remat,
        "--checkpoint_format orbax (a TPU format)": pargs.checkpoint_format == "orbax",
        "--wireup_method jax (the TPU wireup)": pargs.wireup_method == "jax",
        "--enable_wandb (not ported yet)": pargs.enable_wandb,
        "nonzero visualization frequencies (not ported yet)":
            pargs.training_visualization_frequency > 0
            or pargs.validation_visualization_frequency > 0,
    }
    bad = [k for k, v in refused.items() if v]
    if bad:
        raise NotImplementedError("the PyTorch port does not take: " + "; ".join(bad))
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError("multi-GPU data parallelism is not ported yet")


@dataclass
class LoopResult:
    """``metrics``: the JAX CLI's ``final_metrics``.  ``state``: the
    train state at the end of the run.  ``timings``: host seconds of the
    train steps (epoch wall time without validation and saves; the loop
    waits for the card only on logging steps), of the data wait inside it
    (blocked on the loader, the next batch's assembly and the copy to the
    card), of validation and of checkpoint saves, with their counts; and
    per step, the data wait before it (``wait_ms``) and its own time up to
    its logging (``step_ms``)."""

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
    CLI shards and normalizes them.  ``dataset_cls`` defaults to the HDF5
    ``CamDataset``."""
    from ..data.dataset import CamDataset

    cls = dataset_cls or CamDataset
    root = pargs.data_dir_prefix
    statsfile = os.path.join(root, "stats.h5")
    common = dict(channels=pargs.channels, comm_size=1, comm_rank=0,
                  bf16_out=compute_dtype(pargs.amp_opt_level) == torch.bfloat16)
    train_set = cls(os.path.join(root, "train"), statsfile,
                    allow_uneven_distribution=False, shuffle=True, **common)
    validation_set = cls(os.path.join(root, "validation"), statsfile,
                         allow_uneven_distribution=True,
                         shuffle=pargs.max_validation_steps is not None, **common)
    return train_set, validation_set


def main(pargs) -> dict:
    from .. import resolve_device

    check_supported(pargs)
    resolve_device(pargs.device)
    return train_loop(pargs, *make_datasets(pargs)).metrics


def train_loop(pargs, train_set, validation_set) -> LoopResult:
    """The training run of ``cli/train.py:main`` over the given datasets."""
    from .. import resolve_device
    from ..ckpt.checkpoint import (AsyncCheckpointWriter, checkpoint_path,
                                   restore_checkpoint, save_checkpoint)
    from ..data.pipeline import DataLoader, prefetch_to_device
    from ..models.deeplab import DeepLabv3plus
    from ..obs.mlperf_log import MLPerfLogger
    from ..train.losses import FPW_1, FPW_2, class_weights
    from ..train.optim import build_optimizer
    from ..train.schedule import get_lr_schedule
    from ..train.trainer import create_train_state, make_eval_step, make_train_step

    check_supported(pargs)
    device = resolve_device(pargs.device)
    n_replicas = 1

    pargs.logging_frequency = max(pargs.logging_frequency, 1)
    log_file = os.path.normpath(os.path.join(pargs.output_dir, "logs", pargs.run_tag + ".log"))
    logger = MLPerfLogger(log_file, "deepcam", "deepcam_tpu")
    try:
        logger.log_start(key="init_start", sync=True)
        logger.log_event(key="cache_clear")
        seed = pargs.seed
        logger.log_event(key="seed", value=seed)
        torch.manual_seed(seed)
        os.makedirs(pargs.output_dir, exist_ok=True)

        global_batch_size = pargs.local_batch_size * n_replicas
        logger.log_event(key="global_batch_size", value=global_batch_size)
        logger.log_event(key="opt_name", value=pargs.optimizer)
        logger.log_event(key="opt_base_learning_rate",
                         value=pargs.start_lr * pargs.lr_warmup_factor)
        logger.log_event(key="opt_learning_rate_warmup_steps", value=pargs.lr_warmup_steps)
        logger.log_event(key="opt_learning_rate_warmup_factor", value=pargs.lr_warmup_factor)
        logger.log_event(key="opt_epsilon", value=pargs.adam_eps)

        dtype = compute_dtype(pargs.amp_opt_level)
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
        train_step = make_train_step(weights, fpw_1=FPW_1, fpw_2=FPW_2, with_iou=True)
        eval_step = make_eval_step(weights, fpw_1=FPW_1, fpw_2=FPW_2)
        ckpt_writer = AsyncCheckpointWriter() if pargs.async_checkpoint else None

        step = state.step
        epoch = state.epoch
        stop_training = False
        timings = dict.fromkeys(("train_s", "data_wait_s", "validation_s", "save_s"), 0.0)
        timings.update(steps=0, validation_samples=0, saves=0, wait_ms=[], step_ms=[])

        logger.log_end(key="init_stop", sync=True)
        logger.log_start(key="run_start", sync=True)
        run_start_time = time.time()

        def run_validation(epoch, step):
            nonlocal stop_training
            logger.log_start(key="eval_start", metadata={"epoch_num": epoch + 1})
            # the reference's batch-1 loop breaks only AFTER processing
            # sample max_validation_steps+1 (a post-increment check): a
            # per-rank sample budget, whatever the eval batch
            budget = None
            if pargs.max_validation_steps is not None:
                budget = (pargs.max_validation_steps + 1) * n_replicas
            comm_size = max(validation_set.comm_size, 1)
            base = validation_set.global_size // comm_size
            max_local = base + validation_set.global_size % comm_size
            n_calls = -(-max_local // eval_batch)
            if budget is not None:
                n_calls = min(n_calls, -(-budget // eval_batch))

            def host_batches():
                seen_local = 0
                it = iter(validation_loader)
                try:
                    for _ in range(n_calls):
                        batch = next(it, None)
                        if batch is None:  # a shard with fewer batches: pad-only
                            h, w = validation_set.data_shape[:2]
                            yield (torch.zeros((eval_batch, h, w, len(pargs.channels)),
                                               dtype=dtype),
                                   torch.zeros((eval_batch, h, w), dtype=torch.int32),
                                   torch.zeros((eval_batch,), dtype=torch.float32))
                            continue
                        data, label, _ = batch
                        n = data.shape[0]
                        valid = torch.ones((n,), dtype=torch.float32)
                        if budget is not None and seen_local + n > budget:
                            valid[max(0, budget - seen_local):] = 0.0
                        if n < eval_batch:  # pad the trailing partial batch
                            pad = eval_batch - n
                            data = torch.cat([data, data.new_zeros((pad,) + data.shape[1:])])
                            label = torch.cat([label,
                                               label.new_zeros((pad,) + label.shape[1:])])
                            valid = torch.cat([valid, valid.new_zeros((pad,))])
                        seen_local += n
                        if budget is not None:
                            seen_local = min(seen_local, budget)
                        yield data, label, valid
                finally:
                    it.close()  # a budget can stop before the loader's end

            # batches go to the card while the previous eval step runs, and
            # the (count, loss, iou) partials stay on the card until one
            # fetch at the end
            partials = [torch.stack(eval_step(state, d, lb, v))
                        for d, lb, v in prefetch_to_device(host_batches(), device)]
            count = loss_sum = iou_sum = 0.0
            for c, ls, isum in torch.stack(partials).cpu().double().tolist():
                count += c
                loss_sum += ls
                iou_sum += isum
            loss_avg_val = loss_sum / max(count, 1.0)
            iou_avg_val = iou_sum / max(count, 1.0)
            logger.log_event(key="eval_accuracy", value=iou_avg_val,
                             metadata={"epoch_num": epoch + 1, "step_num": step})
            logger.log_event(key="eval_loss", value=loss_avg_val,
                             metadata={"epoch_num": epoch + 1, "step_num": step})
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
                data, label, _ = item
                state, metrics = train_step(state, data, label)
                step += 1
                timings["steps"] += 1
                # lr used by the update just taken: the optimizer's count
                # was step-1 inside it
                current_lr = float(lr_sched(step - 1))

                if step % pargs.logging_frequency == 0:
                    loss_avg = float(metrics["loss"])
                    iou_avg = float(metrics["iou"])
                    md = {"epoch_num": epoch + 1, "step_num": step}
                    logger.log_event(key="learning_rate", value=current_lr, metadata=md)
                    logger.log_event(key="train_accuracy", value=iou_avg, metadata=md)
                    logger.log_event(key="train_loss", value=loss_avg, metadata=md)
                timings["step_ms"].append((time.perf_counter() - t1) * 1e3)

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
        return LoopResult(final_metrics, state, timings)
    finally:
        logger.close()


if __name__ == "__main__":
    main(build_parser().parse_args())
