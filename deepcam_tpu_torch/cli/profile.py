"""DeepCAM profiling entry point of the port (counterpart of
``deepcam_tpu/cli/profile.py``).

    python -m deepcam_tpu_torch.cli.profile [--profile Backward] ...

Parity target: the reference's ``profile_hdf5_ddp.py``: the trainer's setup
(train split only, no validation or wandb) run for ``--num_warmup_steps``
plus ``--num_profile_steps`` steps, with the Forward, Backward and Optimizer
phases timed separately and timestamped ``REPORT:`` lines.  ``--profile``
names the phase whose steps after warm-up are traced with
``torch.profiler`` (``profiling/profiler.py:Profile``), one Chrome trace per
step under ``<output_dir>/trace/<run_tag>``, with the model's module scopes
(``ModuleScopes``) on those steps' forward; ``profiling/op_profile.py``
reads them.  Then FLOP and byte counts of Forward and Backward, and the
roofline of the whole forward plus backward on the card.

The phases follow the reference, which is PyTorch: Forward runs the model
and the loss and builds the autograd graph, Backward is ``loss.backward()``
on that graph (after ``zero_grad``), Optimizer is ``optimizer.step()``.  So
Backward counts the backward alone; the JAX CLI's Backward is
``jax.grad``, which runs the forward again because JAX keeps no tape.  Each
phase is timed inside its region and ends in a synchronize of the card; the
profiler's start, stop and trace writing stay outside the time, its cost on
the traced launches inside.

The model is built from seed 333 and the synthetic batch from
``RandomState(0)``, as the JAX CLI makes them.  BatchNorm updates its
running statistics in place in every forward here (the JAX CLI discards
them); no reported number depends on them.
"""

from __future__ import annotations

import argparse as ap
import contextlib
import datetime as dt
import os
import statistics
import time

import numpy as np
import torch

from ..profiling.profiler import GPU_PEAKS

SEED = 333


def printr(msg, rank=0):
    """Rank-0 print (parity: profile_hdf5_ddp.py:72-74)."""
    from ..core.mesh import get_rank

    if get_rank() == rank:
        print(msg, flush=True)


def build_parser() -> ap.ArgumentParser:
    AP = ap.ArgumentParser(description="DeepCAM profiling (PyTorch/CUDA port)")
    AP.add_argument("--run_tag", type=str, default="profile")
    AP.add_argument("--output_dir", type=str, default="./profile_out")
    AP.add_argument("--data_dir_prefix", type=str, default=None,
                    help="root with train/ + stats.h5; synthetic data if unset")
    AP.add_argument("--max_inter_threads", type=int, default=4)
    AP.add_argument("--local_batch_size", type=int, default=2)
    AP.add_argument("--channels", type=int, nargs="+", default=list(range(16)))
    AP.add_argument("--optimizer", type=str, default="AdamW",
                    choices=["Adam", "AdamW", "LAMB"])
    AP.add_argument("--start_lr", type=float, default=1e-3)
    AP.add_argument("--adam_eps", type=float, default=1e-8)
    AP.add_argument("--weight_decay", type=float, default=1e-2)
    AP.add_argument("--loss_weight_pow", type=float, default=-0.125)
    AP.add_argument("--num_warmup_steps", type=int, default=1)
    AP.add_argument("--num_profile_steps", type=int, default=4)
    AP.add_argument("--profile", type=str, default=None,
                    choices=[None, "Forward", "Backward", "Optimizer"],
                    help="phase to take a torch.profiler trace of")
    AP.add_argument("--amp_opt_level", type=str, default="O1")
    AP.add_argument("--image_size", type=int, nargs=2, default=[768, 1152])
    AP.add_argument("--gpu", type=str, default="h100-sxm", choices=sorted(GPU_PEAKS),
                    help="the card whose peaks the roofline uses")
    AP.add_argument("--device", type=str, default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return AP


def setup(pargs):
    """(model, optimizer, x, y, class weights, device): the model from seed
    333 in train mode, the optimizer over its parameters, and one batch on
    the device (the first of the train split, or synthetic)."""
    from ..cli.train import compute_dtype
    from ..core.mesh import device_for, get_rank, get_size
    from ..models.deeplab import DeepLabv3plus
    from ..train.losses import class_weights
    from ..train.optim import build_optimizer

    device = device_for(pargs.device)
    h, w = pargs.image_size
    n_ch = len(pargs.channels)
    dtype = compute_dtype(pargs.amp_opt_level)
    model = DeepLabv3plus(n_classes=3, output_stride=16, in_ch=n_ch, dtype=dtype,
                          device=device, seed=SEED)
    model.train()
    opt = build_optimizer(pargs.optimizer, model.parameters(), pargs.start_lr,
                          eps=pargs.adam_eps, weight_decay=pargs.weight_decay)
    batch = pargs.local_batch_size
    if pargs.data_dir_prefix:
        from ..data.dataset import CamDataset
        from ..data.pipeline import DataLoader

        train_set = CamDataset(
            os.path.join(pargs.data_dir_prefix, "train"),
            os.path.join(pargs.data_dir_prefix, "stats.h5"), channels=pargs.channels,
            shuffle=True, comm_size=get_size(), comm_rank=get_rank())
        loader = DataLoader(train_set, batch, num_workers=pargs.max_inter_threads)
        data, label, _ = next(iter(loader))
    else:
        rng = np.random.RandomState(0)
        data = torch.from_numpy(rng.rand(batch, h, w, n_ch).astype(np.float32))
        label = torch.from_numpy(rng.randint(0, 3, size=(batch, h, w)).astype(np.int32))
    weights = list(class_weights(pargs.loss_weight_pow))
    return model, opt, data.to(device), label.to(device), weights, device


def forward_loss(model, x, y, weights) -> torch.Tensor:
    """The Forward phase: the model and the weighted cross-entropy."""
    from ..train.losses import weighted_ce_loss

    return weighted_ce_loss(model(x), y, weights)


def backward(opt, loss) -> None:
    """The Backward phase: fresh gradients of ``loss``."""
    opt.zero_grad(set_to_none=True)
    loss.backward()


def main(pargs) -> dict:
    from ..core.mesh import get_rank
    from ..profiling.profiler import ModuleScopes, Profile, cost_analysis, roofline
    from ..utils.sync import host_sync

    printr(f"{dt.datetime.now()}: start training {pargs.run_tag}", 0)
    model, opt, x, y, weights, device = setup(pargs)

    logdir = os.path.join(pargs.output_dir, "trace", pargs.run_tag)
    if get_rank() == 0:
        os.makedirs(logdir, exist_ok=True)
    scopes = ModuleScopes(model)
    phase_times = {"Forward": [], "Backward": [], "Optimizer": []}
    total = pargs.num_warmup_steps + pargs.num_profile_steps
    for step in range(total):
        kw = dict(target=pargs.profile, warmup_steps=pargs.num_warmup_steps, logdir=logdir,
                  scopes=scopes)
        traced = pargs.profile is not None and step >= pargs.num_warmup_steps
        with Profile("Forward", step, **kw):
            t0 = time.perf_counter()
            with scopes if traced else contextlib.nullcontext():
                loss = forward_loss(model, x, y, weights)
            host_sync(device)
            fwd = time.perf_counter() - t0
        with Profile("Backward", step, **kw):
            t0 = time.perf_counter()
            backward(opt, loss)
            host_sync(device)
            bwd = time.perf_counter() - t0
        with Profile("Optimizer", step, **kw):
            t0 = time.perf_counter()
            opt.step()
            host_sync(device)
            ostep = time.perf_counter() - t0
        if step >= pargs.num_warmup_steps:
            for name, t in (("Forward", fwd), ("Backward", bwd), ("Optimizer", ostep)):
                phase_times[name].append(t)
        printr(f"REPORT: step {step}: loss {float(loss.detach()):.6f} "
               f"fwd {1e3 * fwd:.1f}ms bwd {1e3 * bwd:.1f}ms opt {1e3 * ostep:.1f}ms", 0)

    def mean(name):
        return statistics.fmean(phase_times[name]) if phase_times[name] else 0.0

    # ---- cost analysis + roofline ---------------------------------------
    loss = forward_loss(model, x, y, weights)
    costs = {"Forward": cost_analysis(forward_loss, model, x, y, weights),
             "Backward": cost_analysis(backward, opt, loss)}
    report = {}
    for name, c in costs.items():
        mean_t = mean(name)
        report[name] = {"flops": c["flops"], "bytes_accessed": c["bytes_accessed"],
                        "mean_seconds": mean_t,
                        "tflops_per_sec": c["flops"] / mean_t / 1e12 if mean_t else 0.0}
        printr(f"REPORT: {name}: {report[name]}", 0)
    report["Optimizer"] = {"mean_seconds": mean("Optimizer")}

    def forward_backward():
        backward(opt, forward_loss(model, x, y, weights))

    rl = roofline(forward_backward, generation=pargs.gpu, device=device)
    printr("REPORT: " + rl.summary(), 0)
    report["roofline"] = rl.__dict__
    printr(f"{dt.datetime.now()}: done", 0)
    return report


if __name__ == "__main__":
    main(build_parser().parse_args())
