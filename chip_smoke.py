#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py

Run from the root of a checkout; needs one CUDA card, PyTorch built for
CUDA and ``nvcc`` (the kernels are built from ``deepcam_tpu_torch/ops/csrc``
into ``deepcam_tpu_torch/build/``).  Imports nothing of JAX or of the JAX
package.  The port runs its default configuration (the JAX default: BN-apply
fold, kernel-emitted BN statistics, block-boundary fold) unless a phase says
otherwise.  Phases, each printing JSON lines:

1. device  — the card's name and power limit (nvidia-smi); TF32 off for
   fp32 matmuls and convs, so the plain versions run in full fp32.
2. build   — builds the kernels (one nvcc per source, in parallel), and
   reports each kernel's registers, static shared memory and spills from
   the ``-Xptxas -v`` logs.
3. kernels — each form of the unit against its plain PyTorch version on the
   same bf16 inputs, at the shapes where the main path runs it (batch 4):
   the base form at the entry, middle-flow and exit shapes, stats at the
   entry shape, affine_stats at the middle and exit shapes, boundary and
   boundary_stats at the middle shape, affine at block20's sepconv_last;
   and the os=8 model's new ones: affine_stats, boundary_stats and boundary
   at 728→728 @ 96x144 dilation 2, affine at block3's stride-1 tail,
   affine_stats at 1536→2048 @ 96x144 dilation 4.  y,
   dx and d_skip within 2e-2 of the largest reference value (bf16 outputs);
   d_dw, da and db within 1e-3 (fp32 sums in another order), d_pw within
   1e-3 of the plain version's product summed in fp64; each
   channel's Σy and Σy² within 1e-5 of that channel's Σ|y| and Σy² against
   fp64 sums of the kernel's own y, and within 1e-3 against the plain
   version's; d and r bit-exact.  Median times of the kernel,
   the plain version and a library yardstick (elementwise ops, cuDNN
   depthwise, torch.matmul, torch.sum; timed here only), with the card's
   bound for the same work, and the forward's and backward's plans (tile,
   ring stages, blocks per SM, waves).  Then the archived probe's counterpart: the row-window
   copy driven once through its entry at the probe's shape (its launch
   counted), held bit-exact to its plain version, and timed beside
   torch.index_select.  Last, two host costs of a train step's launches:
   encoding the TMA maps, and the device guard of ``ops/build.py:launch``
   (entered only when another device is current; timed entered and not).
4. units   — one full-resolution training step in which every one of the
   60 fused units holds all its kernel outputs to the plain version on the
   same inputs, with the tolerances of phase 3: every unit shape and form
   of the train step, forward and backward; the units counted by form and
   by dilation (57 at 1, 3 at 2).
5. slice   — the full-width DeepLabv3+ (bf16, fp32 parameters) trained with
   AdamW on a synthetic (4, 768, 1152, 16) batch through ``make_train_step``,
   first in the default configuration (1 warm-up and 3 timed steps), then
   in the first slice's configuration, fold and statistics off (1 warm-up
   and 2 timed steps).  The launch counters are zeroed just before and read
   just after each: each kernel runs exactly 60 times per step, in the forms
   stats 5 / affine_stats 38 / boundary_stats 16 / affine 1 (default) or
   base 60 (first slice's configuration).
6. eval    — the full-width ``make_eval_step`` at batch 4 with one sample
   masked out (1 warm-up and 2 timed steps): 60 forward launches per step in
   the forms base 5 / affine 39 / boundary 16, and no backward launch.
7. os8     — ``DeepLabv3plus(output_stride=8, decoder="interpolation")`` at
   full width from seed 333 (bf16, fp32 parameters).  A cadene-shaped
   ImageNet Xception state_dict made from a seed is imported into the card
   model (``tools/import_torch_checkpoint.py``): 169 tensors land, each
   equal to its source, and every other tensor keeps its init.  Then, on a
   synthetic (4, 768, 1152, 16) batch with AdamW: one train step with all
   61 units held to the plain version as in phase 4 (forms stats 5 /
   affine_stats 38 / boundary_stats 16 / affine 2; dilations 8 at 1, 50 at
   2, 3 at 4); 1 warm-up and 3 timed steps (ms/step, samples/s, peak
   memory) with 61 launches per kernel per step in those forms; the eval
   step (1 warm-up and 2 timed, forms base 5 / affine 40 / boundary 16);
   and the whole model in eval mode against the CPU as in phase 9.  Phase
   3 times the kernels at this model's new shapes and dilations.
8. block   — middle-flow Xception blocks in train mode at (2, 48, 72, 728)
   on the card (bf16, kernels) and on the CPU (bf16, plain versions), from
   the same weights and input.  One block, in the default configuration
   and in the first slice's, plus one AdamW step: output, dx, every
   gradient, the running statistics and the updated parameters (BLOCK_TOL).
   Two blocks joined by the boundary fold (one after the other in the
   first slice's configuration): output and running statistics
   (BLOCK_TOL); dx and every gradient within PAIR_SPREAD times the CPU's
   own spread under a 1e-6 nudge of the BN scales.  Each norm limit on dx
   and the gradients must sit below how far bf16 alone moves them (the
   CPU's bf16 run against its fp32 run).
9. parity  — the whole model in eval mode with random running statistics
   at (2, 64, 96, 16), the same weights on the card (bf16, kernels) and on
   the CPU: against the CPU's bf16 run (plain versions) the logits, the
   weighted-CE loss and the gradient of every parameter (PARITY_TOL);
   against its fp32 run the logits and loss (FP32_TOL).  A coarse gate:
   through ~80 layers bf16 rounding alone moves the gradients by ~15%.
10. cli    — the port's training CLI (``cli/train.py:train_loop``)
   at full width: LAMB under warmup + multistep, local batch 2, bf16, over
   8 train and 4 validation samples of (768, 1152, 16) made by
   ``data/synthetic.py`` and served from memory through the port's dataset,
   native normalization, loader and pinned-memory prefetch (the card's
   machine has no h5py: the source is stated on its own line).  8 steps, 2
   validations, 2 checkpoints in the reference's schema; the last one
   restored on the card bit-exact; a resume from it that runs its epoch
   again.  It checks the MLPerf key sequence, every learning rate, the
   launches (60 per kernel per train step in the slice's forms, the eval
   forms per validation), the native library's use, the prefetched batches
   against the host loader's, and one LAMB update of the whole model
   against the CPU's.  It prints the loop's ms per step beside a bare
   batch-2 step, the data wait, validation ms per sample, checkpoint save
   ms (sync and async) and peak memory.  Before the split phase, because
   of the profiler's lasting cost.
11. ddp    — data parallelism over ``torch.distributed``, in child
   processes of this script (``--ddp-child``), which load the kernels the
   build phase built.  (a) World 1 on NCCL through the CLI: one rank with
   torchrun's variables set, so that ``init_distributed("auto")`` wires up
   NCCL and the train step runs under DDP; the cli phase's flags for 8
   LAMB steps at local batch 2 and one validation.  It checks 60 launches
   per kernel per step in the slice's forms, and prints the loop's median
   step and peak memory beside the cli phase's no-group numbers, and a
   bare batch-2 step under DDP beside the bare step without a group, in
   the same process, in three alternating rounds.  (b) Two ranks on the one card in a gloo
   group (NCCL refuses two ranks on one card): 2 AdamW steps at batch 2 of
   (768, 1152, 16) per rank.  The ranks' parameters and running statistics
   are bit-identical to each other after each step; against an emulation
   of both ranks in this process (per-rank BN, averaged gradients, one
   update, averaged running statistics) every parameter and statistic
   tensor, the loss and the IoU lie within DDP_SPREAD times the spread
   between two emulation runs, a limit below what one bf16 rounding of the
   inputs moves; the running statistics are the ranks' mean, not rank 0's
   own.  Then the CLI's validation (``cli/train.py:validate``) over 5
   samples that ``make_datasets`` shards 2 and 3: both ranks count 5 and
   read the same IoU; rank 0 alone writes a checkpoint and log
   lines.  The gloo step time is printed labelled: gloo stages the
   tensors through the host.
12. spatial — spatial H-sharding (``parallel/spatial.py``): one spatial
   group of two ranks, child processes of this script in a gloo group on
   the one card (NCCL refuses two ranks on one card), the full-width os=16
   deconv model from seed 333 (bf16, AdamW lr 1e-3, wd 1e-2, the default
   configuration) on a global batch of 2 synthetic (768, 1152, 16)
   samples, each rank holding (2, 384, 1152, 16) and its labels.  Each
   rank: one forward and backward (the probe) with all 60 units held to the
   plain version as in phase 4, at the shard shapes (forms and dilations
   as in phase 5); 2 AdamW steps of ``make_train_step_spatial`` with the
   counters zeroed just before and read just after (60 launches per kernel
   per step per rank, in the slice's forms), each step's time labelled
   ``gloo_staged`` (gloo stages the halos through the host) and the peak
   memory; the ranks' parameters and running statistics bit-identical after
   the steps; ``make_eval_step_spatial`` over 3 samples (rank 1 adds
   zeros).  The probe runs again in eval mode with random running
   statistics.  Then this process runs the same model unsharded at batch
   2: each probe's loss (the group's mean), the ranks' logits joined along
   H and every gradient against it, in eval mode with phase 9's limits
   (PARITY_TOL), in train mode the loss so and the logits and gradients
   within SPATIAL_SPREAD times the unsharded probe's own move under one
   bf16 rounding of its inputs (train mode at init is that chaotic); and
   the eval of rank 0's trained state against the spatial eval
   (SPATIAL_EVAL_TOL).  The kernels
   phase times the middle flow's shard shapes, 728→728 @ 24x72 (S=2) and
   @ 12x72 (S=4), in the affine_stats and boundary_stats forms.
13. remat  — ``make_train_step(remat=True)``: the slice's model, optimizer
   and batch, one step from the same initial state without remat, again
   without (their spread), and with remat, the counters zeroed just before
   and read just after each.  JAX's policy keeps no residual inside the
   model, so the forward kernel runs 120 times per remat step (forms stats
   10 / affine_stats 76 / boundary_stats 32 / affine 2) and the backward
   60.  The loss and every running statistic equal the step without remat
   bit for bit, or lie within the two plain steps' own spread; every
   gradient and updated parameter within REMAT_SPREAD times that spread
   (bit-equal where it is 0).  Then 1 warm-up and 3 timed steps at batch 4
   and at batch 8, each without and with remat: ms/step, samples/s and
   peak memory, each on its own line.
14. gspmd  — ``parallel/gspmd.py``: four child processes in one gloo group
   on the one card, data 2 x spatial 2, a global batch of 4 synthetic
   (768, 1152, 16) samples, each rank (2, 384, 1152, 16), the spatial
   phase's model and optimizer.  Each rank: the train-mode probe (under
   world statistics) with all 60 units held to the plain version as in
   phase 4; the eval-mode probe with random running statistics; 2 AdamW
   steps of ``make_train_step_gspmd`` with the counters zeroed just before
   and read just after (60 launches per kernel per step per rank in the
   slice's forms), each step's ``gloo_staged`` ms and the peak memory; the
   ranks' parameters and running statistics bit-identical after them.
   Then this process runs the same model unsharded at batch 4, one device
   on the global batch: the eval-mode probe within PARITY_TOL; in train
   mode the loss within PARITY_TOL, and the logits, the gradients and the
   running statistics' moves after step 1 within SPATIAL_SPREAD times the
   unsharded model's own move under one bf16 rounding of the inputs, as in
   phase 12; the step-1 train IoU (the global batch's) against the
   unsharded step's ``compute_score`` within SPATIAL_SPREAD times that
   rounding's move.  The second data group's inputs are scaled by
   GSPMD_SCALE, so that the spatial step's group-only statistics (each data group's
   own, averaged) fail the statistics check: the check sees the sync.
15. split  — at the affine_stats middle and exit shapes and the stats
   entry shape, each launch of both kernels timed on its own; and one
   default-configuration training step (batch 4, after a warm-up) with the
   card's time by kernel, read through ``profiling/op_table.py``.  Both
   with torch.profiler: once the profiler has run, launches stay traced and
   slower, so only the profile phase comes after.
16. profile — the profiling entry point (``cli/profile.py:main``) at its
   defaults, full width (768, 1152, 16), local batch 2, AdamW, bf16, 1
   warm-up and 4 profiled steps, with the counters zeroed just before and
   read just after: (A) without a trace, (B) with ``--profile Backward``.
   Each step's Forward launches the forward kernel 60 times and its
   Backward the backward kernel 60 times.  It prints the REPORT lines, the
   phase means, FLOPs and bytes, the roofline and the FLOPs per sample
   beside bench.py's 2.7 TFLOP; from (B)'s newest trace the op tables per
   step (``profiling/op_profile.py``) and the unattributed share, and it
   checks that trace: 60 of each backward kernel (the wrapper's count over
   the step), no forward kernel, a module scope on every sepconv kernel,
   device time within the region's wall time, achieved TFLOP/s between 0
   and the peak.  (B)'s means beside (A)'s are the profiler's cost.  The
   traces go to a temporary directory, removed after the phase.

Then the ``kernels`` JSON line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises: the script then
exits non-zero and prints no result.
"""

import contextlib
import datetime
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_TENSOR = 989e12
PEAK_FP32 = 67e12

# (form, shape name, N, H, W, C, F, pre_relu, dilation): each form at the
# shapes where the main path runs it
KERNEL_CASES = [
    ("base", "entry_64x128_384x576", 4, 384, 576, 64, 128, False, 1),
    ("base", "middle_728x728_48x72", 4, 48, 72, 728, 728, True, 1),
    ("base", "exit_1536x2048_48x72_d2", 4, 48, 72, 1536, 2048, True, 2),
    ("stats", "entry_64x128_384x576", 4, 384, 576, 64, 128, False, 1),
    ("affine_stats", "middle_728x728_48x72", 4, 48, 72, 728, 728, True, 1),
    ("affine_stats", "exit_1536x2048_48x72_d2", 4, 48, 72, 1536, 2048, True, 2),
    ("boundary_stats", "middle_728x728_48x72", 4, 48, 72, 728, 728, True, 1),
    ("boundary", "middle_728x728_48x72", 4, 48, 72, 728, 728, True, 1),
    ("affine", "last_1024x1024_48x72", 4, 48, 72, 1024, 1024, False, 1),
    # the shapes and dilations only the output-stride-8 model runs (os8 phase)
    ("affine_stats", "os8_middle_728x728_96x144_d2", 4, 96, 144, 728, 728, True, 2),
    ("boundary_stats", "os8_middle_728x728_96x144_d2", 4, 96, 144, 728, 728, True, 2),
    ("boundary", "os8_middle_728x728_96x144_d2", 4, 96, 144, 728, 728, True, 2),
    ("affine", "os8_block3_last_728x728_96x144", 4, 96, 144, 728, 728, False, 1),
    ("affine_stats", "os8_exit_1536x2048_96x144_d4", 4, 96, 144, 1536, 2048, True, 4),
    # the middle flow's H-shards of spatial sharding at batch 2: S=2 and S=4
    ("affine_stats", "spatial2_middle_728x728_24x72", 2, 24, 72, 728, 728, True, 1),
    ("boundary_stats", "spatial2_middle_728x728_24x72", 2, 24, 72, 728, 728, True, 1),
    ("affine_stats", "spatial4_middle_728x728_12x72", 2, 12, 72, 728, 728, True, 1),
    ("boundary_stats", "spatial4_middle_728x728_12x72", 2, 12, 72, 728, 728, True, 1),
]
# 32 of the 60 units of a train step run this form at this shape
HEADLINE = ("affine_stats", "middle_728x728_48x72")
# cases whose launches are also timed one by one (torch.profiler)
SPLIT_CASES = {HEADLINE, ("affine_stats", "exit_1536x2048_48x72_d2"),
               ("stats", "entry_64x128_384x576")}
KERNEL_NAMES = ("sepconv_fwd_kernel", "dd_kernel", "dx_ddw_kernel", "dpw_kernel",
                "reduce_kernel", "row_windows_kernel")
STEP_BATCH = 4
WARMUP_STEPS, TIMED_STEPS = 1, 3
BASE_TIMED_STEPS = 2
EVAL_STEPS = 2
# fused units per train and eval step by form, and by dilation: the os=16
# deconv model (every phase but os8) and the os=8 interpolation model, where
# block3's stride-1 tail adds an affine unit (os8 phase)
TRAIN_FORMS = {"stats": 5, "affine_stats": 38, "boundary_stats": 16, "affine": 1}
EVAL_FORMS = {"base": 5, "affine": 39, "boundary": 16}
UNIT_DILATIONS = {1: 57, 2: 3}
OS8_TRAIN_FORMS = {"stats": 5, "affine_stats": 38, "boundary_stats": 16, "affine": 2}
OS8_EVAL_FORMS = {"base": 5, "affine": 40, "boundary": 16}
OS8_UNIT_DILATIONS = {1: 8, 2: 50, 4: 3}
OS8 = {"output_stride": 8, "decoder": "interpolation"}
UNITS_PER_STEP = sum(TRAIN_FORMS.values())
BASE_FORMS = {"base": UNITS_PER_STEP}
# the cadene ImageNet Xception tensors the pretrained import lands in the
# port's backbone (as the JAX package's importer does; tests/test_torch_pretrained.py)
PRETRAINED_LANDED = 169
# cli phase: the pod script's settings (LAMB, lr 1e-3, wd 1e-2, local batch
# 2), cut to a short run.  A 2-step warmup to 2x and milestones "3 6" put
# the warmup and the first milestone (update 5) inside the 8 steps and the
# second (update 8) inside the resume; validation and a save every 4 steps,
# so 2 of each.
CLI_FLAGS = ["--optimizer", "LAMB", "--start_lr", "1e-3", "--weight_decay", "1e-2",
             "--local_batch_size", "2", "--lr_schedule",
             "type=multistep,milestones=3 6,decay_rate=0.1",
             "--lr_warmup_steps", "2", "--lr_warmup_factor", "2",
             "--eval_local_batch_size", "4", "--max_epochs", "2", "--logging_frequency", "1",
             "--validation_frequency", "4", "--save_frequency", "4", "--target_iou", "2.0",
             "--seed", "333"]
CLI_SAMPLES = {"train": 8, "validation": 4}
CLI_STEPS, CLI_EVALS = 8, 2  # 2 epochs of 4 steps; validations at steps 4 and 8
CLI_LRS = [1e-3, 1.5e-3, 2e-3, 2e-3, 2e-3, 2e-4, 2e-4, 2e-4, 2e-5, 2e-5, 2e-5, 2e-5]
# The card's machine has no h5py (checked there), so the cli phase serves
# the arrays the HDF5 writer would write from memory, through the same
# dataset, normalization and loader code.
CLI_SOURCE = "memory"
MLLOG_HEADER = ["submission_benchmark", "submission_org", "submission_division",
                "submission_status", "submission_platform"]
MLLOG_INIT = ["init_start", "cache_clear", "seed", "global_batch_size", "opt_name",
              "opt_base_learning_rate", "opt_learning_rate_warmup_steps",
              "opt_learning_rate_warmup_factor", "opt_epsilon", "train_samples",
              "eval_samples", "init_stop", "run_start"]
# profile phase: cli/profile.py at its defaults ((768, 1152, 16), local batch
# 2, AdamW, O1), 1 warm-up and 4 profiled steps; bench.py's analytic count
# of a training step's work per sample, forward plus backward
PROFILE_WARMUP, PROFILE_STEPS = 1, 4
BENCH_TFLOP_PER_SAMPLE = 2.7
# one LAMB update of the whole model, card against CPU (fp32, same gradients)
LAMB_TOL = 1e-6
# kernel against plain version: bf16 outputs relative to the largest value,
# fp32 sums relative to the largest value
UNIT_TOL = {"y": 2e-2, "dx": 2e-2, "dskip": 2e-2, "ddw": 1e-3, "dpw": 1e-3,
            "da": 1e-3, "db": 1e-3}
# d_pw is held to the plain version's product summed in fp64 (the same bf16
# operands): the plain version's fp32 matmul, one sequential sum over up to
# 55296 pixels whose terms cancel, lies up to 8.9e-4 of its largest entry
# from that sum at the os=8 exit on an H100, as far as the limit itself
# (analysis/dpw_accuracy.py).  "dpw_plain_fp64" reports that distance.
# Σy, Σy² of each channel: against fp64 sums of the kernel's own y, and
# against the plain version's y, relative to the channel's Σ|y| and Σy²
# (the plain y differs by GEMM rounding)
STATS_OWN_TOL, STATS_PLAIN_TOL = 1e-5, 1e-3
# Card (bf16, kernels) against CPU (bf16, plain versions): the same rounding
# points, fp32 sums in other orders.  Block phase, (max, norm) errors
# relative to the CPU tensor.  One block, measured on an H100 in the first
# slice's configuration (chip_smoke.py): y 7.8e-3, 2.0e-3; dx 2.9e-2,
# 5.5e-3; gradients 2.8e-2, 6.7e-3; running statistics 6.4e-4; parameters
# after AdamW on the same gradients 2.3e-7.  bf16 alone moves that block's
# dx and gradients by 8.1e-2 to 0.111 (norm), above the 2e-2 limit.
BLOCK_TOL = {"y": (2e-2, 1e-2), "dx": (1e-1, 2e-2), "grad": (1e-1, 2e-2),
             "stat": (5e-3, 5e-3), "param": (1e-6, 1e-6)}
# The boundary-joined pair's train-mode backward through six BNs is
# sensitive in bf16: nudging the BN scales by 1e-6 moves the CPU's own bf16
# dx and gradients by 2.9e-2 and 4.2e-2 (norm), so the pair's dx and
# gradients are held to PAIR_SPREAD times that nudged spread, measured in
# the same run.  Measured on an H100: the card reads 2.4x (dx) and 2.2x
# (worst gradient) of it, in either configuration; bf16 alone reads 5.0x
# and 4.0x, which the limit must stay below.
PAIR_SPREAD = 3.0
# Whole model, eval mode.  Through ~80 layers a one-ulp difference spreads
# as far as bf16 rounding itself: measured on an H100, the card's gradients
# differ from the CPU's bf16 run by 0.13 (norm, median leaf; worst 0.24),
# as the CPU's bf16 run differs from its fp32 run (0.15).  So this phase
# only catches a gross fault (a wrong backward gives ~1 on every leaf
# upstream of it); the units and block phases hold the kernels closely.
PARITY_TOL = {"logits": 0.1, "loss": 1e-2, "grad_norm_median": 0.3, "grad_norm_max": 0.6}
# against the CPU's fp32 run: bf16 alone moves the logits by 2.8e-2 of the
# largest (CPU) and the card's by 3.6e-2 (H100)
FP32_TOL = {"logits": 0.1, "loss": 1e-2}


_T0 = time.perf_counter()


def emit(obj):
    """One JSON line, with the seconds since the script started."""
    print(json.dumps({**obj, "elapsed_s": time.perf_counter() - _T0}), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps, flush):
    """Median of ``reps`` single-call CUDA-event timings; the L2 cache is
    flushed before each call (the main path finds its operands cold)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def launch_split(fn, reps, flush):
    """Device ms per call of each of the port's CUDA kernels that ``fn``
    launches, with their launches per call, from torch.profiler over
    ``reps`` calls (the L2 flushed before each); None where the profiler
    shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        for name in KERNEL_NAMES:
            if name in e.key and us:
                ms, n = split.get(name, (0.0, 0.0))
                split[name] = (ms + us / 1e3 / reps, n + e.count / reps)
    return {k: {"ms": ms, "launches": n} for k, (ms, n) in split.items()} or None


def ptxas_report(build):
    """Registers, shared memory and spills of each compiled kernel, from the
    ``-Xptxas -v`` logs that ops/build.py keeps beside each library."""
    report, name = {}, None
    for log in sorted(build.BUILD_DIR.glob("*.log")):
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
                continue
            m = re.search(r"Used (\d+) registers", line)
            if name and m:
                smem = re.search(r"(\d+) bytes smem", line)
                report.setdefault(name, {})["registers"] = int(m.group(1))
                report[name]["static_smem"] = int(smem.group(1)) if smem else 0
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if name and m:
                report.setdefault(name, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
    try:
        names = subprocess.run(["c++filt"], input="\n".join(report), capture_output=True,
                               text=True, timeout=60, check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = list(report)
    return {re.sub(r"\(.*", "", nice): v for nice, v in zip(names, report.values())}


def bound(nbytes, ops_by_peak):
    """Least time of the card for the work: the larger of the byte time
    and the operation time (each type of operation at its own peak)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = sum(n / peak for n, peak in ops_by_peak)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def form_operands(form):
    """(affine, skip, stats): the operands and outputs of a form."""
    return form not in ("base", "stats"), form.startswith("boundary"), form.endswith("stats")


def unit_bounds(form, p, c, f):
    """(forward, backward) bounds of one unit of this form on p pixels,
    C→F, from the port's count of its work (``profiling/profiler.py:
    unit_counts``: each input read once and each output written once), the
    GEMMs on the bf16 tensor cores and the rest in fp32."""
    from deepcam_tpu_torch.profiling.profiler import unit_counts

    w = unit_counts(form, p, c, f)
    return tuple(bound(w[f"{d}_bytes"], [(w[f"{d}_gemm_flops"], PEAK_BF16_TENSOR),
                                         (w[f"{d}_other_flops"], PEAK_FP32)])
                 for d in ("fwd", "bwd"))


def rel_err(a, b):
    """max |a − b| over max |b|, in fp32 on a's device."""
    a, b = a.detach().float(), b.detach().float().to(a.device)
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def norm_err(a, b):
    """‖a − b‖ over ‖b‖, in fp32 on a's device."""
    a, b = a.detach().float(), b.detach().float().to(a.device)
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def dpw_fp64(d, g, y=None, gs1=None, gs2=None, **_):
    """d_pw = Σ_p d[p, c]·g'[p, f] summed in fp64, where g' is g with the
    statistics cotangent folded in and rounded as the plain version does."""
    if y is not None:
        g = (g.float() + (gs1 + 2.0 * y.float() * gs2)).to(g.dtype)
    return torch.matmul(d.reshape(-1, d.shape[-1]).double().t(),
                        g.reshape(-1, g.shape[-1]).double())


def stats_errors(stats, y, ref_stats):
    """Errors of the kernel's (Σy, Σy²): against fp64 sums of its own y and
    against the plain version's, each channel's relative to that channel's
    Σ|y| and Σy²; the worst channel."""
    y64 = y.double()
    sq = (y64 * y64).sum((0, 1, 2))
    own, scales = (y64.sum((0, 1, 2)), sq), (y64.abs().sum((0, 1, 2)), sq)
    errs = {}
    for i, name in enumerate(("s1", "s2")):
        s, scale = stats[i].double(), scales[i].clamp_min(1e-30)
        errs[name] = ((s - own[i]).abs() / scale).max().item()
        errs[name + "_plain"] = ((s - ref_stats[i].double()).abs() / scale).max().item()
    return errs


def hold_stats(errs, where):
    for name, err in errs.items():
        tol = STATS_PLAIN_TOL if name.endswith("_plain") else STATS_OWN_TOL
        check(math.isfinite(err) and err <= tol, f"{where} {name}: {err} > {tol}")


def launch_guard_us(build, reps=20000, rounds=3):
    """Host microseconds per launch of ``build.launch`` around an entry
    that does nothing, with the tensors' device the current one (as on the
    main path, where ``device_for`` set it): ``launch`` as it runs (the
    guard skipped), the stream lookup and call with the device guard always
    entered, and the same without the guard.  The least of ``rounds``
    alternating rounds of ``reps`` calls each."""
    dev = torch.device("cuda", torch.cuda.current_device())

    def noop(*args):
        return 0

    def guarded():
        with torch.cuda.device(dev):
            noop(1, 2, torch.cuda.current_stream(dev).cuda_stream)

    def bare():
        noop(1, 2, torch.cuda.current_stream(dev).cuda_stream)

    def as_run():
        build.launch("noop", noop, dev, 1, 2)

    best = {}
    for _ in range(rounds):
        for name, fn in (("launch", as_run), ("always_guarded", guarded), ("unguarded", bare)):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            us = (time.perf_counter() - t0) / reps * 1e6
            best[name] = min(us, best.get(name, us))
    return best


def kernel_phase(fs):
    """Every form against its plain version, and times, at KERNEL_CASES."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rows = {"sepconv_fwd": [], "sepconv_bwd": []}
    splits = {}
    for form, name, n, h, w, c, f, pre_relu, dil in KERNEL_CASES:
        def rnd(*shape, scale=1.0, shift=0.0):
            return (scale * torch.randn(*shape, generator=gen, device="cuda")
                    + shift).bfloat16()

        affine, with_skip, stats = form_operands(form)
        x, g = rnd(n, h, w, c), rnd(n, h, w, f)
        dwk, pwk = rnd(3, 3, c, scale=1 / 3), rnd(c, f, scale=c ** -0.5)
        kw = {}
        if affine:
            kw.update(a=rnd(c, scale=0.2, shift=1.0), b=rnd(c, scale=0.1))
        if with_skip:
            kw["skip"] = rnd(n, h, w, c)
        out = fs.sepconv_fwd(x, dwk, pwk, pre_relu, dil, True, emit_stats=stats, **kw)
        ref = fs.sepconv_fwd_plain(x, dwk, pwk, pre_relu, dil, emit_stats=stats, **kw)
        check(torch.equal(out.d, ref.d), f"{form} {name}: kernel d differs from the plain d")
        check(not with_skip or torch.equal(out.r, ref.r),
              f"{form} {name}: kernel r differs from the plain r")
        bkw = dict(kw)
        if with_skip:
            bkw["gr"] = rnd(n, h, w, c)
        errs = {}
        if stats:
            errs.update(stats_errors(out.stats, out.y, ref.stats))
            hold_stats(errs, f"{form} {name}")
            bkw.update(y=out.y, gs1=0.3 * torch.randn(f, generator=gen, device="cuda"),
                       gs2=0.1 * torch.randn(f, generator=gen, device="cuda"))
        got = fs.sepconv_bwd(x, g, dwk, pwk, out.d, pre_relu, dil, **bkw)
        want = fs.sepconv_bwd_plain(x, g, dwk, pwk, ref.d, pre_relu, dil, **bkw)
        exact = dpw_fp64(out.d, g, **bkw)
        errs["dpw_plain_fp64"] = rel_err(want.dpw, exact)
        want = want._replace(dpw=exact)
        torch.cuda.synchronize()
        for key, tol in UNIT_TOL.items():
            a = out.y if key == "y" else getattr(got, key)
            b = ref.y if key == "y" else getattr(want, key)
            if a is None:
                continue
            err = (a.float() - b.float()).abs().max().item()
            scale = b.float().abs().max().item()
            check(math.isfinite(err) and err <= tol * scale,
                  f"{form} {name} {key}: max |err| {err} > {tol} * {scale}")
            errs[key] = err / scale
            errs[key + "_abs"] = err

        # library yardstick: elementwise prologue, cuDNN depthwise,
        # torch.matmul and torch.sum (never called by the port)
        def lib(xx, dw, pw, a=None, b=None, skip=None):
            hc = xx.permute(0, 3, 1, 2)
            if a is not None:
                hc = hc * a[:, None, None] + b[:, None, None]
            if skip is not None:
                hc = hc + skip.permute(0, 3, 1, 2)
            hc = torch.relu(hc) if pre_relu else hc
            yy = torch.matmul(F.conv2d(hc, dw, padding=dil, dilation=dil, groups=c)
                              .permute(0, 2, 3, 1), pw)
            outs = [yy] + ([hc.permute(0, 2, 3, 1)] if skip is not None else [])
            if stats:
                y32 = yy.float()
                outs += [y32.sum((0, 1, 2)), (y32 * y32).sum((0, 1, 2))]
            return outs

        dw_oihw = dwk.permute(2, 0, 1)[:, None].contiguous()
        leaf_names = ["x", "dw", "pw"] + [k for k in ("a", "b", "skip") if k in kw]
        base_leaves = [x, dw_oihw, pwk] + [kw[k] for k in leaf_names[3:]]
        grads_out = ([g] + ([bkw["gr"]] if with_skip else [])
                     + ([bkw["gs1"], bkw["gs2"]] if stats else []))

        def lib_graph():
            leaves = [t.detach().clone().requires_grad_() for t in base_leaves]
            return lib(*leaves[:3], **dict(zip(leaf_names[3:], leaves[3:]))), leaves

        reps = 15 if h * w * n > 100_000 else 30
        p = n * h * w
        t = {
            "fwd": time_ms(lambda: fs.sepconv_fwd(x, dwk, pwk, pre_relu, dil, True,
                                                  emit_stats=stats, **kw), reps, flush),
            "fwd_plain": time_ms(lambda: fs.sepconv_fwd_plain(x, dwk, pwk, pre_relu, dil,
                                                              emit_stats=stats, **kw),
                                 reps, flush),
            "fwd_lib": time_ms(lambda: lib(x, dw_oihw, pwk, **kw), reps, flush),
            "bwd": time_ms(lambda: fs.sepconv_bwd(x, g, dwk, pwk, out.d, pre_relu, dil, **bkw),
                           reps, flush),
            "bwd_plain": time_ms(lambda: fs.sepconv_bwd_plain(x, g, dwk, pwk, out.d, pre_relu,
                                                              dil, **bkw), reps, flush),
        }
        graphs = [lib_graph() for _ in range(reps + 1)]

        def lib_bwd():
            outs, leaves = graphs.pop()
            torch.autograd.grad(outs, leaves, grads_out)

        t["bwd_lib"] = time_ms(lib_bwd, reps, flush)
        fwd_b, bwd_b = unit_bounds(form, p, c, f)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        plans = {"fwd": fs.fwd_plan(n, h, w, c, f, dil, sms)._asdict(),
                 "bwd": fs.bwd_plan(n, h, w, c, f, dil, stats, sms)._asdict()}
        if (form, name) in SPLIT_CASES:  # timed launch by launch at the end
            splits[form, name] = (n, h, w, c, f, pre_relu, dil, reps)
        fwd_outs = ["y"] + (["s1", "s2"] if stats else [])
        bwd_outs = ["dx", "ddw", "dpw"] + (["da", "db"] if affine else []) + (
            ["dskip"] if with_skip else [])
        for kname, key, b, outs in (("sepconv_fwd", "fwd", fwd_b, fwd_outs),
                                    ("sepconv_bwd", "bwd", bwd_b, bwd_outs)):
            rows[kname].append({
                "form": form, "shape": name, "ms": t[key], "plain_ms": t[key + "_plain"],
                "library_ms": t[key + "_lib"], "bound_ms": b[0], "bound_by": b[1],
                "max_abs_err": max(errs.get(o + "_abs", 0.0) for o in outs),
                "max_rel_err": max(errs[o] for o in outs)})
        emit({"phase": "kernels", "form": form, "shape": name, "times_ms": t,
              "bound_ms": {"fwd": fwd_b, "bwd": bwd_b}, "plan": plans,
              "errors_rel_to_max": {k: v for k, v in errs.items() if not k.endswith("_abs")}})
        del x, g, out, ref, got, want, graphs, kw, bkw, base_leaves
        torch.cuda.empty_cache()
    return rows, splits


def step_profile(fs, step_fn, state, x, y):
    """One training step under torch.profiler: the card's busy time by
    kernel (the 25 largest, and the fused units' share: the family
    ``sepconv (hand-written)`` of the port's op table), read from the
    step's Chrome trace through ``profiling/op_table.py``."""
    from torch.profiler import ProfilerActivity, profile

    from deepcam_tpu_torch.profiling.op_table import load_device_ops, op_table
    state, _ = step_fn(state, x, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, x, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "step.pt.trace.json")
        prof.export_chrome_trace(path)
        table = op_table(load_device_ops(path))
    busy = sum(table.column("time_ms"))
    fused = sum(r["time_ms"] for r in table if r["category"] == "sepconv (hand-written)")
    return {"wall_ms_profiled": wall * 1e3, "device_busy_ms": busy,
            "fused_sepconv_ms": fused,
            "top": [[r["name"][:120], r["time_ms"], r["invocations"]] for r in table[:25]]}


def split_phase(fs, rows, splits):
    """Each launch of both kernels timed on its own (torch.profiler) at
    SPLIT_CASES, into their rows.  Run last: after the profiler has run,
    launches stay traced, which would slow the timed steps."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(4321)
    for (form, name), (n, h, w, c, f, pre_relu, dil, reps) in splits.items():
        def rnd(*shape, scale=1.0, shift=0.0):
            return (scale * torch.randn(*shape, generator=gen, device="cuda")
                    + shift).bfloat16()

        affine, with_skip, stats = form_operands(form)
        x, g = rnd(n, h, w, c), rnd(n, h, w, f)
        dwk, pwk = rnd(3, 3, c, scale=1 / 3), rnd(c, f, scale=c ** -0.5)
        kw = dict(a=rnd(c, scale=0.2, shift=1.0), b=rnd(c, scale=0.1)) if affine else {}
        if with_skip:
            kw["skip"] = rnd(n, h, w, c)
        out = fs.sepconv_fwd(x, dwk, pwk, pre_relu, dil, True, emit_stats=stats, **kw)
        bkw = dict(kw, gr=rnd(n, h, w, c)) if with_skip else dict(kw)
        if stats:
            bkw.update(y=out.y, gs1=torch.randn(f, generator=gen, device="cuda"),
                       gs2=torch.randn(f, generator=gen, device="cuda"))
        split = {
            "fwd": launch_split(lambda: fs.sepconv_fwd(x, dwk, pwk, pre_relu, dil, True,
                                                       emit_stats=stats, **kw), reps, flush),
            "bwd": launch_split(lambda: fs.sepconv_bwd(x, g, dwk, pwk, out.d, pre_relu, dil,
                                                       **bkw), reps, flush)}
        for kname, key in (("sepconv_fwd", "fwd"), ("sepconv_bwd", "bwd")):
            row = next(r for r in rows[kname] if (r["form"], r["shape"]) == (form, name))
            row["launch_split"] = split[key]
        emit({"phase": "split", "form": form, "shape": name, "launch_split_ms": split})


def probe_phase(pw):
    """The archived Mosaic probe's counterpart: its public entry once at
    the probe's shape, with the counter zeroed just before and read just
    after; the kernel against its plain version (bit-exact: a copy), and
    times beside a library yardstick (torch.index_select of the window
    rows, timed only here)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    th, d = pw.PROBE_TH, pw.PROBE_D
    xp = torch.randn(*pw.PROBE_SHAPE, generator=torch.Generator(device="cuda").manual_seed(99),
                     device="cuda")
    pw.reset_launches()
    out = pw.row_windows(xp, th, d)
    torch.cuda.synchronize()
    launches = pw.LAUNCHES["row_windows"]
    check(launches == 1, f"probe: {launches} row_windows launches, want 1")
    ref = pw.row_windows_plain(xp, th, d)
    check(torch.equal(out, ref), "probe: the kernel's windows differ from the plain version's")
    n, rows, w, c = xp.shape
    t, win = pw.window_count(rows, th, d), th + 2 * d
    idx = torch.tensor([i * th + r for i in range(t) for r in range(win)], device="cuda")

    def lib():
        return torch.index_select(xp, 1, idx).view(n, t, win, w, c)

    check(torch.equal(lib(), ref), "probe: the library yardstick differs")
    times = {"ms": time_ms(lambda: pw.row_windows_kernel(xp, th, d), 30, flush),
             "plain_ms": time_ms(lambda: pw.row_windows_plain(xp, th, d), 30, flush),
             "library_ms": time_ms(lib, 30, flush)}
    b = bound(4 * (xp.numel() + out.numel()), [])
    row = {"name": "row_windows", "route": "cuda",
           "source": "deepcam_tpu_torch/ops/csrc/row_windows.cu",
           "replaces": "analysis/archive/probe_element_window.py:29", "launches": launches,
           "max_abs_err": (out - ref).abs().max().item(), **times, "bound_ms": b[0],
           "bound_by": b[1], "shape": list(pw.PROBE_SHAPE), "th": th, "d": d,
           "path": "the probe's own call (on no training path)"}
    emit({"phase": "probe", **row})
    return row


def checked_unit_step(fs, step_fn, state, x, y, forms_wanted, dilations_wanted):
    """One training step in which each fused unit's kernel outputs are held
    to the plain version on the same inputs (the tolerances of phase 3),
    and its units counted by form and by dilation against the wanted counts
    (whose sum is the units of a step).  Returns the worst relative error
    of each output over the step's units and the units seen, by
    direction."""
    real_fwd, real_bwd = fs.sepconv_fwd, fs.sepconv_bwd
    worst = dict.fromkeys(list(UNIT_TOL) + ["s1", "s2", "s1_plain", "s2_plain",
                                            "dpw_plain_fp64"], 0.0)
    units = {"fwd": [], "bwd": []}

    def hold(outs, refs, unit):
        for key, (a, b) in zip(outs, refs):
            if a is None:
                continue
            err = rel_err(a, b)
            check(math.isfinite(err) and err <= UNIT_TOL[key], f"unit {unit} {key}: {err}")
            worst[key] = max(worst[key], err)

    def fwd(x, dwk, pwk, pre_relu, dil, emit_d, **kw):
        out = real_fwd(x, dwk, pwk, pre_relu, dil, emit_d, **kw)
        ref = fs.sepconv_fwd_plain(x, dwk, pwk, pre_relu, dil, **kw)
        form = fs.form_name(kw.get("a") is not None, kw.get("skip") is not None,
                            kw.get("emit_stats", False))
        unit = (form, *x.shape, pwk.shape[1], pre_relu, dil)
        check(out.d is None or torch.equal(out.d, ref.d), f"unit {unit}: kernel d differs")
        check(out.r is None or torch.equal(out.r, ref.r), f"unit {unit}: kernel r differs")
        hold(["y"], [(out.y, ref.y)], unit)
        if out.stats is not None:
            errs = stats_errors(out.stats, out.y, ref.stats)
            hold_stats(errs, f"unit {unit}")
            for k, v in errs.items():
                worst[k] = max(worst[k], v)
        units["fwd"].append(unit)
        return out

    def bwd(x, g, dwk, pwk, d, pre_relu, dil, **kw):
        got = real_bwd(x, g, dwk, pwk, d, pre_relu, dil, **kw)
        want = fs.sepconv_bwd_plain(x, g, dwk, pwk, d, pre_relu, dil, **kw)
        exact = dpw_fp64(d, g, **kw)
        worst["dpw_plain_fp64"] = max(worst["dpw_plain_fp64"], rel_err(want.dpw, exact))
        want = want._replace(dpw=exact)
        unit = (*x.shape, pwk.shape[1], pre_relu, dil)
        keys = ("dx", "ddw", "dpw", "da", "db", "dskip")
        hold(keys, [(getattr(got, k), getattr(want, k)) for k in keys], unit)
        units["bwd"].append(unit)
        return got

    fs.sepconv_fwd, fs.sepconv_bwd = fwd, bwd
    try:
        state, metrics = step_fn(state, x, y)
        torch.cuda.synchronize()
    finally:
        fs.sepconv_fwd, fs.sepconv_bwd = real_fwd, real_bwd
    n_units = sum(forms_wanted.values())
    check(len(units["fwd"]) == len(units["bwd"]) == n_units,
          f"{len(units['fwd'])} forward and {len(units['bwd'])} backward units in one step, "
          f"want {n_units}")
    forms = [u[0] for u in units["fwd"]]
    check({k: forms.count(k) for k in set(forms)} == forms_wanted,
          f"unit forms of one train step: {sorted(forms)}")
    for way in ("fwd", "bwd"):
        dils = [u[-1] for u in units[way]]
        check({d: dils.count(d) for d in set(dils)} == dilations_wanted,
              f"{way} unit dilations of one train step: {sorted(dils)}")
    return state, metrics, worst, units


def train_steps(fs, step_fn, state, x, y, timed):
    """1 warm-up and ``timed`` timed steps with the counters zeroed just
    before and read just after.  Returns the state, the measurements and the
    launch counts."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fs.reset_launches()
    losses = []
    for _ in range(WARMUP_STEPS):
        state, metrics = step_fn(state, x, y)
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        state, metrics = step_fn(state, x, y)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, forms = dict(fs.LAUNCHES), measured_forms(fs)
    losses.append(float(metrics["loss"]))
    check(all(math.isfinite(v) for v in losses), f"non-finite loss: {losses}")
    result = {"steps": {"warmup": WARMUP_STEPS, "timed": timed},
              "ms_per_step": dt / timed * 1e3, "samples_per_s": x.shape[0] * timed / dt,
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
              "loss_first": losses[0], "loss_last": losses[-1],
              "iou_last": float(metrics["iou"]), "launches": launches, "forms": forms}
    return state, result


def eval_steps(fs, state, x, y, where, forms_wanted):
    """``make_eval_step`` on batch 4 with its last sample masked out: 1
    warm-up and EVAL_STEPS timed calls, the counters zeroed just before and
    read just after (``forms_wanted`` forward launches per call, none
    backward), and a finite loss and an IoU in range over 3 samples."""
    from deepcam_tpu_torch.train.losses import FPW_1, FPW_2, class_weights
    from deepcam_tpu_torch.train.trainer import make_eval_step

    eval_fn = make_eval_step(list(class_weights()), fpw_1=FPW_1, fpw_2=FPW_2)
    valid = torch.tensor([1, 1, 1, 0], device="cuda")
    eval_fn(state, x, y, valid)
    torch.cuda.synchronize()
    fs.reset_launches()
    t1 = time.perf_counter()
    for _ in range(EVAL_STEPS):
        count, loss_sum, iou_sum = eval_fn(state, x, y, valid)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t1) / EVAL_STEPS * 1e3
    launches, forms = dict(fs.LAUNCHES), measured_forms(fs)
    check_counts(where, launches, forms, EVAL_STEPS, forms_wanted, {})
    count, loss_sum, iou_sum = float(count), float(loss_sum), float(iou_sum)
    check(count == 3.0 and math.isfinite(loss_sum) and loss_sum > 0
          and 0.0 <= iou_sum <= 3.0, f"{where} step: {count}, {loss_sum}, {iou_sum}")
    return {"valid": valid.tolist(), "steps": EVAL_STEPS, "ms_per_step": eval_ms,
            "count": count, "loss_mean": loss_sum / count, "iou_mean": iou_sum / count,
            "launches": launches, "forms": forms}


def measured_forms(fs):
    """Each kernel's launches by form since the last reset, without zeros."""
    return {k: {form: v for form, v in c.items() if v} for k, c in fs.FORM_LAUNCHES.items()}


def check_counts(where, launches, forms, steps, fwd_forms, bwd_forms):
    """Launches of each kernel, in all and by form, against the forms
    wanted per step."""
    for kname, want in (("sepconv_fwd", fwd_forms), ("sepconv_bwd", bwd_forms)):
        check(launches[kname] == sum(want.values()) * steps,
              f"{where}: {launches[kname]} {kname} launches in {steps} steps, "
              f"want {sum(want.values())} per step")
        check(forms[kname] == {k: v * steps for k, v in want.items()},
              f"{where}: {kname} forms {forms[kname]} in {steps} steps, want {want} per step")


class BlockPair(torch.nn.Module):
    """Two middle-flow blocks, joined by the boundary fold when
    ``boundary`` (the default configuration), else one after the other."""

    def __init__(self, XceptionBlock, c, dtype, gen, boundary=True):
        super().__init__()
        self.boundary = boundary
        self.block4 = XceptionBlock(c, c, 3, dtype=dtype, gen=gen)
        self.block5 = XceptionBlock(c, c, 3, dtype=dtype, gen=gen)

    def forward(self, x):
        if not self.boundary:
            return self.block5(self.block4(x))
        y, ab, skip = self.block4(x, emit_boundary=True)
        return self.block5(y, boundary_in=(ab, skip))


def block_run(XceptionBlock, x, ct, dev, dtype, blocks, boundary=True, nudge=0.0):
    """One middle-flow block (``blocks`` 1) or the block pair, in train
    mode from seeded weights (the BN scales multiplied by 1 + nudge·N(0, 1)
    when ``nudge``): the module, and its output, dx, every gradient and the
    running statistics, on the CPU."""
    c, gen = x.shape[1], torch.Generator().manual_seed(22)
    net = (XceptionBlock(c, c, 3, dtype=dtype, gen=gen) if blocks == 1
           else BlockPair(XceptionBlock, c, dtype, gen, boundary)).to(dev).train()
    if nudge:
        gen = torch.Generator().manual_seed(23)
        with torch.no_grad():
            for k, p in net.named_parameters():
                if "bn" in k.split(".")[-2] and k.endswith(".weight"):
                    p.mul_(1 + nudge * torch.randn(p.shape, generator=gen).to(dev))
    xd = x.to(dev, dtype).contiguous(memory_format=torch.channels_last)
    xd.requires_grad_()
    out = net(xd)
    (out.float() * ct.to(dev)).sum().backward()
    res = {"y": out.detach().cpu(), "dx": xd.grad.cpu()}
    res.update({f"grad/{k}": p.grad.cpu() for k, p in net.named_parameters()})
    res.update({f"stat/{k}": b.cpu() for k, b in net.named_buffers()})
    return net, res


def compare(a, b):
    """{tensor: (max error, norm error)} of run a relative to run b."""
    return {k: (rel_err(a[k], v), norm_err(a[k], v)) for k, v in b.items()}


def worst_norms(a, b):
    """Norm errors of a against b: dx, and the worst gradient."""
    return {"dx": norm_err(a["dx"], b["dx"]),
            "grad": max(norm_err(a[k], v) for k, v in b.items() if k.startswith("grad/"))}


def worst_by_group(errs):
    """The worst (max, norm) error of each group of tensors (y, dx, grad,
    stat, param)."""
    out = {}
    for k, (emax, enorm) in errs.items():
        m, nrm = out.get(k.split("/")[0], (0.0, 0.0))
        out[k.split("/")[0]] = (max(m, emax), max(nrm, enorm))
    return out


def block_parity(layers, XceptionBlock, build_optimizer):
    """Middle-flow blocks in train mode on the card (bf16, kernels) and on
    the CPU (bf16 and fp32, plain versions), from the same weights and
    input.  Returns the card's errors relative to the CPU's bf16 run,
    {case: {tensor: (max error, norm error)}}, for one block in each
    configuration (in the default one also after one AdamW step, all runs
    stepping on the card's gradients) and for the block pair in each; and
    yardsticks of the backward's sensitivity (norm errors of dx and the
    worst gradient): the CPU's bf16 run against its fp32 run, for the block
    and for the pair, and the CPU's bf16 pair with its BN scales nudged by
    1e-6 against itself."""
    n, h, w, c = 2, 48, 72, 728
    gen = torch.Generator().manual_seed(21)
    x = torch.randn(n, c, h, w, generator=gen) + 0.3
    ct = torch.randn(n, c, h, w, generator=gen)
    runs = (("card", "cuda", torch.bfloat16), ("cpu16", "cpu", torch.bfloat16),
            ("cpu32", "cpu", torch.float32))
    block, card_grads = {}, None
    for key, dev, dtype in runs:
        net, res = block_run(XceptionBlock, x, ct, dev, dtype, 1)
        opt = build_optimizer("AdamW", net.parameters(), 1e-3, eps=1e-8, weight_decay=1e-2)
        if card_grads is None:
            card_grads = {k: p.grad.cpu() for k, p in net.named_parameters()}
        else:  # the optimizer alone: the CPU steps on the card's gradients
            for k, p in net.named_parameters():
                p.grad = card_grads[k].clone()
        opt.step()
        res.update({f"param/{k}": p.detach().cpu() for k, p in net.named_parameters()})
        block[key] = res
    pair = {key: block_run(XceptionBlock, x, ct, dev, dtype, 2)[1] for key, dev, dtype in runs}
    nudged = block_run(XceptionBlock, x, ct, "cpu", torch.bfloat16, 2, nudge=1e-6)[1]
    layers.set_bn_fold(False)
    layers.set_fused_stats(False)
    try:
        base = {(blocks, key): block_run(XceptionBlock, x, ct, dev, dtype, blocks,
                                         boundary=False)[1]
                for blocks in (1, 2) for key, dev, dtype in runs[:2]}
    finally:
        layers.set_bn_fold(True)
        layers.set_fused_stats(True)
    errs = {"block": compare(block["card"], block["cpu16"]),
            "block_first_slice_config": compare(base[1, "card"], base[1, "cpu16"]),
            "pair": compare(pair["card"], pair["cpu16"]),
            "pair_first_slice_config": compare(base[2, "card"], base[2, "cpu16"])}
    yardsticks = {"block_cpu_bf16_vs_fp32": worst_norms(block["cpu16"], block["cpu32"]),
                  "pair_cpu_bf16_vs_fp32": worst_norms(pair["cpu16"], pair["cpu32"]),
                  "pair_cpu_bf16_nudged_1e-6": worst_norms(nudged, pair["cpu16"])}
    return errs, yardsticks


def random_running_stats(model, seed):
    """Running statistics from a seeded CPU generator (means in ±0.25,
    variances in [0.75, 1.25]), so each eval-mode BN is a non-trivial
    affine map."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            u = torch.rand(buf.shape, generator=gen).to(buf.device)
            buf.copy_(0.5 * u + (0.75 if name.endswith("running_var") else -0.25))


def model_parity(DeepLabv3plus, weighted_ce_loss, class_weights, **model_kw):
    """The whole model (``model_kw`` to its constructor) in eval mode at
    (2, 64, 96, 16) on the card (bf16) and on the CPU (bf16 and fp32):
    logits, loss and every parameter's gradient of the loss."""
    xs = torch.rand(2, 64, 96, 16, generator=torch.Generator().manual_seed(5))
    ys = torch.randint(0, 3, (2, 64, 96), generator=torch.Generator().manual_seed(6))
    runs = {}
    for key, dev, dtype in (("card", "cuda", torch.bfloat16), ("cpu16", "cpu", torch.bfloat16),
                            ("cpu32", "cpu", torch.float32)):
        m = DeepLabv3plus(n_classes=3, dtype=dtype, device=dev, seed=7, **model_kw).eval()
        random_running_stats(m, 8)
        logits = m(xs.to(dev))
        loss = weighted_ce_loss(logits, ys.to(dev), class_weights())
        loss.backward()
        runs[key] = {"logits": logits.detach().float().cpu(), "loss": loss.item(),
                     "grads": {k: p.grad.cpu() for k, p in m.named_parameters()}}
    card, cpu16, cpu32 = runs["card"], runs["cpu16"], runs["cpu32"]
    check(card["logits"].shape == (2, 64, 96, 3) and bool(torch.isfinite(card["logits"]).all()),
          "bad logits")
    grad_norm = sorted(norm_err(card["grads"][k], g) for k, g in cpu16["grads"].items())
    grad32 = sorted(norm_err(cpu16["grads"][k], g) for k, g in cpu32["grads"].items())
    return {
        "bf16": {"logits": rel_err(card["logits"], cpu16["logits"]),
                 "loss": abs(card["loss"] - cpu16["loss"]) / abs(cpu16["loss"]),
                 "grad_norm_median": grad_norm[len(grad_norm) // 2],
                 "grad_norm_max": grad_norm[-1], "n_grads": len(grad_norm)},
        "cpu_bf16_vs_fp32_grad_norm_median": grad32[len(grad32) // 2],
        "fp32": {"logits": rel_err(card["logits"], cpu32["logits"]),
                 "loss": abs(card["loss"] - cpu32["loss"]) / abs(cpu32["loss"])},
        "loss_card": card["loss"],
    }


def check_parity(par, where):
    """``model_parity``'s errors against PARITY_TOL (the CPU's bf16 run) and
    FP32_TOL (its fp32 run)."""
    for ref, tols in (("bf16", PARITY_TOL), ("fp32", FP32_TOL)):
        for k, tol in tols.items():
            check(par[ref][k] <= tol, f"{where}: card vs CPU {ref}: {k} {par[ref][k]} > {tol}")


def cadene_source(seed):
    """A state_dict in the cadene ImageNet Xception's layout, from a seeded
    CPU generator: convs kaiming-normal over their fan-in, BN scales near 1,
    small shifts and means, variances in [0.5, 1.5]."""
    from deepcam_tpu_torch.tools.import_torch_checkpoint import cadene_xception_shapes

    gen = torch.Generator().manual_seed(seed)
    src = {}
    for k, shape in cadene_xception_shapes().items():
        z = torch.randn(shape, generator=gen)
        if k.endswith("running_var"):
            z = torch.rand(shape, generator=gen) + 0.5
        elif len(shape) == 1:
            z = 0.1 * z + (1.0 if k.endswith(".weight") and not k.startswith("fc") else 0.0)
        else:
            z = z * math.sqrt(2.0 / math.prod(shape[1:]))
        src[k] = z
    return src


def os8_phase(fs, smi):
    """The output-stride-8 model with the interpolation decoder at full
    width: a cadene-shaped backbone imported on the card (landed tensors
    equal to the source, the rest at their init); one batch-4 train step
    with every one of its 61 units held to the plain version; 1 warm-up and
    3 timed AdamW steps, then the eval step, with the counters zeroed just
    before and read just after each (61 launches per kernel per step, in
    OS8_TRAIN_FORMS and OS8_EVAL_FORMS); the whole model in eval mode against
    the CPU (``model_parity``)."""
    from deepcam_tpu_torch.models.deeplab import DeepLabv3plus
    from deepcam_tpu_torch.tools import import_torch_checkpoint as imp
    from deepcam_tpu_torch.train.losses import FPW_1, FPW_2, class_weights, weighted_ce_loss
    from deepcam_tpu_torch.train.optim import build_optimizer
    from deepcam_tpu_torch.train.trainer import create_train_state, make_train_step

    t_phase = time.perf_counter()
    batch = STEP_BATCH
    model = DeepLabv3plus(n_classes=3, dtype=torch.bfloat16, device="cuda", seed=333, **OS8)

    # the pretrained import on the card
    raw = cadene_source(444)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    pairs, src = imp.pretrained_assignments(raw, model)
    landed = imp.import_pretrained_xception(raw, model)
    check(landed == len(pairs) == PRETRAINED_LANDED,
          f"os8 import: {landed} tensors landed, {len(pairs)} assigned, "
          f"want {PRETRAINED_LANDED}")
    sd = model.state_dict()
    for p_key, s_key in pairs:
        check(torch.equal(sd[p_key].cpu(), src[s_key]), f"os8 import: {p_key} != {s_key}")
    kept = [k for k in sd if k not in {p for p, _ in pairs}]
    for k in kept:
        check(torch.equal(sd[k], before[k]), f"os8 import: {k} changed")
    del before, src, raw

    opt = build_optimizer("AdamW", model.parameters(), 1e-3, eps=1e-8, weight_decay=1e-2)
    state = create_train_state(model, opt)
    step_fn = make_train_step(list(class_weights()), fpw_1=FPW_1, fpw_2=FPW_2)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.rand(batch, 768, 1152, 16, generator=gen, device="cuda").bfloat16()
    y = torch.randint(0, 3, (batch, 768, 1152), generator=gen, device="cuda")
    state, metrics, worst, units = checked_unit_step(fs, step_fn, state, x, y, OS8_TRAIN_FORMS,
                                                     OS8_UNIT_DILATIONS)
    units_out = {"units": len(units["fwd"]), "distinct_units": len(set(units["fwd"])),
                 "worst_rel": worst, "loss": float(metrics["loss"])}

    state, train = train_steps(fs, step_fn, state, x, y, TIMED_STEPS)
    check_counts("os8", train["launches"], train["forms"], WARMUP_STEPS + TIMED_STEPS,
                 OS8_TRAIN_FORMS, OS8_TRAIN_FORMS)

    ev = eval_steps(fs, state, x, y, "os8 eval", OS8_EVAL_FORMS)
    del model, opt, state, x, y, sd
    torch.cuda.empty_cache()

    par = model_parity(DeepLabv3plus, weighted_ce_loss, class_weights, **OS8)
    check_parity(par, "os8 parity")
    out = {"model": OS8, "batch": batch, "input": [batch, 768, 1152, 16],
           "pretrained": {"landed": landed, "kept": len(kept)},
           "units_step": units_out, "train": train, "eval": ev,
           "parity": par, "phase_seconds": time.perf_counter() - t_phase,
           "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    emit({"phase": "os8", **out})
    return out


def median(values):
    values = sorted(values)
    return values[len(values) // 2] if values else None


def step_host_ms_median(timings):
    """Median host ms of the CLI loop's train steps: the root span
    ``step`` of each entry in ``timings["span_steps"]``."""
    ns = median([e["step.ns"] for e in timings["span_steps"]])
    return None if ns is None else ns * 1e-6


def expected_mllog_keys(start_step, epochs, steps_per_epoch, validation, save):
    """The MLPerf key sequence of a cli run that logs every step."""
    keys = MLLOG_HEADER + MLLOG_INIT
    step = start_step
    for _ in range(epochs):
        keys.append("epoch_start")
        for _ in range(steps_per_epoch):
            step += 1
            keys += ["learning_rate", "train_accuracy", "train_loss"]
            if step % validation == 0:
                keys += ["eval_start", "eval_accuracy", "eval_loss", "eval_stop"]
            if step % save == 0:
                keys += ["save_start", "save_stop"]
        keys.append("epoch_stop")
    return keys + ["run_stop"]


def check_mllog(records, start_step, epochs, sched, where):
    """The key sequence in order, run_stop with status success, every
    learning_rate line equal to schedule(step - 1) and to CLI_LRS, and
    finite losses.  Returns the train losses."""
    keys = [r["key"] for r in records]
    want = expected_mllog_keys(start_step, epochs, 4, 4, 4)
    check(keys == want, f"{where}: MLPerf keys {keys} != {want}")
    check(records[-1]["metadata"].get("status") == "success", f"{where}: run_stop {records[-1]}")
    lrs = [(r["metadata"]["step_num"], r["value"]) for r in records if r["key"] == "learning_rate"]
    steps = list(range(start_step + 1, start_step + 4 * epochs + 1))
    check([s for s, _ in lrs] == steps, f"{where}: learning_rate steps {lrs}")
    for s, v in lrs:
        check(v == sched(s - 1) and abs(v - CLI_LRS[s - 1]) <= 1e-6 * CLI_LRS[s - 1],
              f"{where}: step {s} logged lr {v}, schedule {sched(s - 1)}, want {CLI_LRS[s - 1]}")
    losses = [r["value"] for r in records if r["key"] == "train_loss"]
    check(len(losses) == len(steps) and all(math.isfinite(v) for v in losses),
          f"{where}: train losses {losses}")
    return losses


def cli_phase(fs, shape=(768, 1152), device="cuda"):
    """The port's training CLI at full width (see the module docstring,
    phase 9).  Returns the measurements and each run's launch counts; the
    caller holds the counts to the slice's and eval's forms."""
    from deepcam_tpu_torch.ckpt.checkpoint import checkpoint_path, restore_checkpoint
    from deepcam_tpu_torch.cli.train import build_parser, make_datasets, train_loop
    from deepcam_tpu_torch.data.dataset import MemoryCamDataset
    from deepcam_tpu_torch.data.pipeline import DataLoader, prefetch_to_device
    from deepcam_tpu_torch.data.synthetic import make_arrays
    from deepcam_tpu_torch.models.deeplab import DeepLabv3plus
    from deepcam_tpu_torch.obs.mlperf_log import parse_mllog
    from deepcam_tpu_torch.ops import native
    from deepcam_tpu_torch.train.losses import FPW_1, FPW_2, class_weights
    from deepcam_tpu_torch.train.optim import build_optimizer
    from deepcam_tpu_torch.train.schedule import get_lr_schedule
    from deepcam_tpu_torch.train.trainer import create_train_state, make_train_step

    from deepcam_tpu_torch.utils.sync import host_sync

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = functools.partial(host_sync, dev)

    result = {"source": CLI_SOURCE, "input": [2, *shape, 16], "flags": CLI_FLAGS}
    with tempfile.TemporaryDirectory(prefix="deepcam_cli_") as tmp:
        root, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
        t0 = time.perf_counter()
        splits, stats = make_arrays(root, shape=shape, seed=0,
                                    n_train=CLI_SAMPLES["train"],
                                    n_validation=CLI_SAMPLES["validation"])
        files = {name: (d, lb) for samples in splits.values() for name, d, lb in samples}
        del splits
        result["make_data_s"] = time.perf_counter() - t0
        dataset_cls = functools.partial(MemoryCamDataset, files=files, stats=stats)

        def args(tag, *extra):
            return build_parser().parse_args(
                CLI_FLAGS + ["--data_dir_prefix", root, "--output_dir", out, "--run_tag", tag,
                             "--device", device, *extra])

        pargs = args("cli")
        train_set, validation_set = make_datasets(pargs, dataset_cls)
        check(train_set.bf16_out and len(train_set) == 8 and len(validation_set) == 4,
              "cli datasets")
        sched = get_lr_schedule(1e-3, pargs.lr_schedule, pargs.lr_warmup_steps,
                                pargs.lr_warmup_factor)

        # every batch the card receives through the pinned-memory prefetch
        # equals the host loader's, read on a compute stream kept busy
        host = [(d.clone(), lb.clone()) for d, lb, _ in DataLoader(train_set, 2, num_workers=2)]
        busy = torch.randn(2048, 2048, device=dev)
        seen = []
        for d, lb, _ in prefetch_to_device(DataLoader(train_set, 2, num_workers=2,
                                                      pin_memory=on_card), dev):
            for _ in range(4):
                busy = busy @ busy / busy.norm()
            seen.append((d.clone(), lb.clone()))
        sync()
        check(len(seen) == len(host) == 4 and all(
            torch.equal(d.cpu(), hd) and torch.equal(lb.cpu(), hl)
            for (d, lb), (hd, hl) in zip(seen, host)), "prefetched batches differ from the loader's")
        result["prefetch_batches_checked"] = len(seen)
        x, y = seen[0][0], seen[0][1]
        del host, seen, busy

        # the bare train step at batch 2 on batches already on the card
        model = DeepLabv3plus(n_classes=3, dtype=torch.bfloat16, device=dev, seed=333)
        state = create_train_state(model, build_optimizer(
            "LAMB", model.parameters(), sched, eps=1e-8, weight_decay=1e-2))
        step_fn = make_train_step(list(class_weights()), fpw_1=FPW_1, fpw_2=FPW_2)
        state, _ = step_fn(state, x, y)
        sync()
        t0 = time.perf_counter()
        for _ in range(3):
            state, metrics = step_fn(state, x, y)
        float(metrics["loss"])
        result["bare_step_ms"] = (time.perf_counter() - t0) / 3 * 1e3
        del model, state, step_fn, metrics, x, y
        if on_card:
            torch.cuda.empty_cache()
        initial = DeepLabv3plus(n_classes=3, dtype=torch.bfloat16, device="cpu", seed=333)
        watched = {k: v.detach().clone() for k, v in initial.named_parameters()
                   if k.endswith(("block4.sepconv1.pointwise.weight", "conv5.pointwise.weight",
                                  "last_deconv.weight", "bn5.weight"))}
        del initial

        # the run: counters zeroed just before, read just after
        runs = {}
        for tag, extra in (("cli", ()), ("resume", ("--checkpoint", checkpoint_path(
                out, "model", CLI_STEPS), "--async_checkpoint"))):
            pargs = args(tag, *extra)
            sync()
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            fs.reset_launches()
            native.reset_uses()
            t0 = time.perf_counter()
            res = train_loop(pargs, train_set, validation_set)
            sync()
            wall = time.perf_counter() - t0
            runs[tag] = {"launches": dict(fs.LAUNCHES), "forms": measured_forms(fs),
                         "native_uses": dict(native.USES)}
            check(native.lib() is not None and native.USES["native"] > 0
                  and native.USES["numpy"] == 0, f"{tag}: native library uses {native.USES}")
            t = res.timings
            start = 0 if tag == "cli" else CLI_STEPS
            epochs = 2 if tag == "cli" else 1
            losses = check_mllog(parse_mllog(os.path.join(out, "logs", f"{tag}.log")),
                                 start, epochs, sched, tag)
            check(res.metrics["step"] == start + 4 * epochs and res.metrics["epoch"] == 2
                  and t["steps"] == 4 * epochs, f"{tag}: {res.metrics}, {t}")
            check(res.metrics["eval_samples_seen"] == 4.0, f"{tag}: {res.metrics}")
            runs[tag].update({
                "metrics": res.metrics, "losses": losses, "wall_s": wall, "timings": t,
                "loop_step_ms": t["train_s"] / t["steps"] * 1e3,
                "loop_step_host_ms_median": step_host_ms_median(t),
                "data_wait_ms_per_step": t["data_wait_s"] / t["steps"] * 1e3,
                "data_wait_ms_median": median(t["wait_ms"]),
                "validation_ms_per_sample": t["validation_s"] / t["validation_samples"] * 1e3,
                "save_ms": t["save_s"] / t["saves"] * 1e3,
                "max_memory_allocated_bytes": (torch.cuda.max_memory_allocated()
                                               if on_card else None)})
            if tag == "cli":
                trained = res.state
                now = dict(trained.model.named_parameters())
                changed = {k: not torch.equal(v, now[k].detach().cpu()) for k, v in watched.items()}
                check(all(changed.values()), f"parameters not updated: {changed}")
                check(sorted(f for f in os.listdir(out) if f.endswith(".cpt")) == [
                    "model_step_4.cpt", "model_step_8.cpt"], f"checkpoints {os.listdir(out)}")
                # the last checkpoint, restored on the card, is bit-exact
                fresh = DeepLabv3plus(n_classes=3, dtype=torch.bfloat16, device=dev, seed=0)
                fresh = create_train_state(fresh, build_optimizer(
                    "LAMB", fresh.parameters(), sched, eps=1e-8, weight_decay=1e-2))
                t0 = time.perf_counter()
                fresh, epoch = restore_checkpoint(checkpoint_path(out, "model", CLI_STEPS), fresh)
                sync()
                runs[tag]["restore_ms"] = (time.perf_counter() - t0) * 1e3
                check((fresh.step, epoch) == (CLI_STEPS, 1), f"restored {fresh.step}, {epoch}")
                a, b = fresh.model.state_dict(), trained.model.state_dict()
                check(sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a),
                      "restored model differs from the saved one")
                pa, pb = dict(fresh.model.named_parameters()), dict(trained.model.named_parameters())
                for k in pa:
                    sa, sb = fresh.optimizer.state[pa[k]], trained.optimizer.state[pb[k]]
                    check(sorted(sa) == ["exp_avg", "exp_avg_sq", "step"] and all(
                        torch.equal(sa[n], sb[n]) for n in sa), f"restored optimizer state {k}")
                runs[tag]["restored_tensors_checked"] = len(a) + 3 * len(pa)
                del fresh, a, b, pa, pb, trained, now, res
                if on_card:
                    torch.cuda.empty_cache()
        check(sorted(f for f in os.listdir(out) if f.endswith(".cpt")) == [
            "model_step_12.cpt", "model_step_4.cpt", "model_step_8.cpt"],
            f"checkpoints after the resume {os.listdir(out)}")
        result["runs"] = runs

        # one LAMB update of the whole model: card against CPU, fp32, with
        # the same gradients
        base = [p.detach().cpu().clone() for p in res.state.model.parameters()]
        del res
        gen = torch.Generator().manual_seed(7)
        grads = [1e-3 * torch.randn(p.shape, generator=gen) for p in base]
        updated = {}
        for where in ("cpu", device):
            ps = [torch.nn.Parameter(p.to(where, copy=True)) for p in base]
            opt = build_optimizer("LAMB", ps, 1e-3, eps=1e-8, weight_decay=1e-2)
            for p, g in zip(ps, grads):
                p.grad = g.to(where)
            opt.step()
            updated[where] = [p.detach().cpu() for p in ps]
            del ps, opt
        worst = max(rel_err(a, b) for a, b in zip(updated[device], updated["cpu"]))
        check(worst <= LAMB_TOL, f"LAMB card vs CPU: {worst} > {LAMB_TOL}")
        result["lamb_update"] = {"tensors": len(base), "params": sum(p.numel() for p in base),
                                 "worst_rel": worst, "tolerance": LAMB_TOL}
    return result


# ---------------------------------------------------------------------------
# ddp phase: data parallelism through torch.distributed
# ---------------------------------------------------------------------------

# (a) world 1 on NCCL through the CLI: the cli phase's flags, one epoch of
# 8 steps at local batch 2 over 16 train samples, one validation of 4, no
# save
DDP_CLI_FLAGS = CLI_FLAGS + ["--max_epochs", "1", "--validation_frequency", "8",
                             "--save_frequency", "0"]
DDP_CLI_SAMPLES = {"train": 16, "validation": 4}
DDP_CLI_STEPS = 8
DDP_BARE_STEPS = 8
DDP_ROUNDS = 3
# (b) two ranks on the one card over gloo: AdamW, batch 2 of (768, 1152, 16)
# per rank, 2 steps, then validation over 5 samples in shards of 2 and 3 at
# eval batch 2
DDP_WORLD = 2
DDP_STEPS = 2
DDP_EVAL_SAMPLES, DDP_EVAL_BATCH = 5, 2
# ranks against the in-process emulation: within DDP_SPREAD times the
# spread between two emulation runs of the same call (cuDNN's weight
# gradients are not bit-reproducible); that limit must lie below what one
# bf16 rounding of the inputs moves (an emulation run whose inputs are
# scaled by 1 + 2^-8 * N(0, 1) before their rounding to bf16)
DDP_SPREAD = 3.0
DDP_CHILD_TIMEOUT_S = 600


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_children(jobs, tmp, env_of=None):
    """Runs this script once per job (``--ddp-child <json>``), all at once,
    and returns each job's JSON result.  A child that fails or hangs fails
    the phase, with the end of its log."""
    procs = []
    for i, job in enumerate(jobs):
        job = {**job, "result": os.path.join(tmp, f"child{i}.json")}
        env = {k: v for k, v in os.environ.items()
               if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        env.update(env_of(i) if env_of else {})
        log = open(os.path.join(tmp, f"child{i}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--ddp-child", json.dumps(job)],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env, stdout=log,
            stderr=subprocess.STDOUT), log, job))
    deadline = time.monotonic() + DDP_CHILD_TIMEOUT_S
    try:
        for proc, _, _ in procs:
            try:
                proc.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for proc, log, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    results = []
    for i, (proc, _, job) in enumerate(procs):
        with open(os.path.join(tmp, f"child{i}.log")) as f:
            tail = f.read()[-3000:]
        check(proc.returncode == 0, f"ddp child {i} ({job['kind']}) exited {proc.returncode}:\n{tail}")
        with open(job["result"]) as f:
            results.append(json.load(f))
    return results


def ddp_batch(step, rank):
    """Rank ``rank``'s half of the global batch of ``step`` (4 samples),
    made on the card from a seed: the same in every process."""
    gen = torch.Generator(device="cuda").manual_seed(100 + step)
    x = torch.rand(DDP_WORLD * 2, 768, 1152, 16, generator=gen, device="cuda")
    y = torch.randint(0, 3, (DDP_WORLD * 2, 768, 1152), generator=gen, device="cuda")
    return x[2 * rank:2 * rank + 2], y[2 * rank:2 * rank + 2]


def ddp_model_and_step():
    from deepcam_tpu_torch.models.deeplab import DeepLabv3plus
    from deepcam_tpu_torch.train.losses import FPW_1, FPW_2, class_weights
    from deepcam_tpu_torch.train.optim import build_optimizer
    from deepcam_tpu_torch.train.trainer import create_train_state, make_train_step

    model = DeepLabv3plus(n_classes=3, dtype=torch.bfloat16, device="cuda", seed=333)
    state = create_train_state(model, build_optimizer(
        "AdamW", model.parameters(), 1e-3, eps=1e-8, weight_decay=1e-2))
    return state, make_train_step(list(class_weights()), fpw_1=FPW_1, fpw_2=FPW_2)


def ddp_flat(model):
    """Every parameter, then every BN running statistic, as two flat fp32
    vectors on the card."""
    from deepcam_tpu_torch.train.trainer import running_stats

    return (torch.cat([p.detach().reshape(-1) for p in model.parameters()]),
            torch.cat([b.reshape(-1) for b in running_stats(model)]))


def ddp_child_cli(job):
    """(a): one rank under torchrun's variables.  First the bare LAMB step
    at batch 2, in DDP_ROUNDS rounds: without a process group, then with
    NCCL wired up by ``auto`` and a new state under DDP (each 2 warm-up
    and DDP_BARE_STEPS timed steps, with the peak memory of each part).
    Then the CLI's loop trains under DDP."""
    from deepcam_tpu_torch.cli.train import build_parser, make_datasets, train_loop
    from deepcam_tpu_torch.core import mesh
    from deepcam_tpu_torch.data.dataset import MemoryCamDataset
    from deepcam_tpu_torch.data.pipeline import DataLoader, prefetch_to_device
    from deepcam_tpu_torch.data.synthetic import make_arrays
    from deepcam_tpu_torch.models.deeplab import DeepLabv3plus
    from deepcam_tpu_torch.ops import fused_sepconv as fs
    from deepcam_tpu_torch.train.losses import FPW_1, FPW_2, class_weights
    from deepcam_tpu_torch.train.optim import build_optimizer
    from deepcam_tpu_torch.train.schedule import get_lr_schedule
    from deepcam_tpu_torch.train.trainer import create_train_state, make_train_step

    dev = mesh.device_for("cuda")
    out = {"device": str(dev)}
    with tempfile.TemporaryDirectory(prefix="deepcam_ddp_") as tmp:
        root = os.path.join(tmp, "data")
        splits, stats = make_arrays(root, shape=(768, 1152), seed=0,
                                    n_train=DDP_CLI_SAMPLES["train"],
                                    n_validation=DDP_CLI_SAMPLES["validation"])
        files = {name: (d, lb) for samples in splits.values() for name, d, lb in samples}
        del splits
        pargs = build_parser().parse_args(DDP_CLI_FLAGS + [
            "--data_dir_prefix", root, "--output_dir", os.path.join(tmp, "out"),
            "--run_tag", "ddp", "--device", "cuda"])
        dataset_cls = functools.partial(MemoryCamDataset, files=files, stats=stats)

        # the bare step on a batch already on the card, in DDP_ROUNDS
        # rounds of: without a group, then under DDP (a group wired up for
        # the round and a new DDP wrapper, then the group left)
        x, y, _ = next(prefetch_to_device(DataLoader(make_datasets(pargs, dataset_cls)[0], 2,
                                                     num_workers=2), dev))
        sched = get_lr_schedule(1e-3, pargs.lr_schedule, pargs.lr_warmup_steps,
                                pargs.lr_warmup_factor)
        step_fn = make_train_step(list(class_weights()), fpw_1=FPW_1, fpw_2=FPW_2)
        bare = {key: {"step_ms": [], "warmup_max_memory_allocated_bytes": 0,
                      "max_memory_allocated_bytes": 0} for key in ("no_group", "ddp")}
        for _ in range(DDP_ROUNDS):
            for key, side in bare.items():
                # a fresh state for each part: a DDP wrapper stays bound to
                # its group and its model, and one state at a time sets the
                # peak
                model = DeepLabv3plus(n_classes=3, dtype=torch.bfloat16, device=dev, seed=333)
                state = create_train_state(model, build_optimizer(
                    "LAMB", model.parameters(), sched, eps=1e-8, weight_decay=1e-2))
                if key == "ddp":
                    os.environ["MASTER_PORT"] = str(free_port())
                    check(mesh.init_distributed("auto", dev) is True, "auto did not wire up")
                # 2 warm-up steps (DDP sizes its buckets anew after its
                # first backward), then the steady peak and time
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                for _ in range(2):
                    state, _ = step_fn(state, x, y)
                torch.cuda.synchronize()
                side["warmup_max_memory_allocated_bytes"] = max(
                    torch.cuda.max_memory_allocated(), side["warmup_max_memory_allocated_bytes"])
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                for _ in range(DDP_BARE_STEPS):
                    state, metrics = step_fn(state, x, y)
                float(metrics["loss"])
                side["step_ms"].append((time.perf_counter() - t0) / DDP_BARE_STEPS * 1e3)
                side["max_memory_allocated_bytes"] = max(torch.cuda.max_memory_allocated(),
                                                         side["max_memory_allocated_bytes"])
                side["replica"] = type(state.replica).__name__
                del model, state, metrics
                gc.collect()  # the DDP wrapper's cycles hold its buckets
                if key == "ddp":
                    mesh.destroy_distributed()
        for side in bare.values():
            side["step_ms_median"] = median(side["step_ms"])
        bare["ddp_minus_no_group_ms_by_round"] = [
            d - n for d, n in zip(bare["ddp"]["step_ms"], bare["no_group"]["step_ms"])]
        out["bare"] = bare
        del step_fn, x, y
        torch.cuda.empty_cache()
        os.environ["MASTER_PORT"] = str(free_port())
        check(mesh.init_distributed("auto", dev) is True, "auto did not wire up")
        try:
            dist = mesh.initialized_dist()
            out.update(backend=dist.get_backend(), world_size=mesh.get_size(),
                       rank=mesh.get_rank())
            train_set, validation_set = make_datasets(pargs, dataset_cls)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fs.reset_launches()
            res = train_loop(pargs, train_set, validation_set)
            torch.cuda.synchronize()
            out["launches"] = dict(fs.LAUNCHES)
            out["forms"] = measured_forms(fs)
            out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
            t = res.timings
            out.update(metrics=res.metrics, steps=t["steps"],
                       loop_step_host_ms_median=step_host_ms_median(t),
                       loop_step_ms=t["train_s"] / t["steps"] * 1e3,
                       data_wait_ms_median=median(t["wait_ms"]),
                       replica=type(res.state.replica).__name__)
        finally:
            mesh.destroy_distributed()
    return out


def ddp_child_gloo(job):
    """(b): one of two ranks on the one card, in a gloo group that this
    process builds and the port adopts.  After the train steps, the CLI's
    own validation over this rank's shard of DDP_EVAL_SAMPLES samples, as
    ``make_datasets`` shards them (2 and 3) and served from memory."""
    from deepcam_tpu_torch.ckpt.checkpoint import save_checkpoint
    from deepcam_tpu_torch.cli.train import build_parser, make_datasets, validate
    from deepcam_tpu_torch.core import mesh
    from deepcam_tpu_torch.data.dataset import MemoryCamDataset
    from deepcam_tpu_torch.data.pipeline import DataLoader
    from deepcam_tpu_torch.data.synthetic import make_arrays
    from deepcam_tpu_torch.obs.mlperf_log import MLPerfLogger
    from deepcam_tpu_torch.parallel import collectives
    from deepcam_tpu_torch.train.losses import FPW_1, FPW_2, class_weights
    from deepcam_tpu_torch.train.trainer import make_eval_step

    rank = job["rank"]
    torch.distributed.init_process_group(
        "gloo", init_method="file://" + job["store"], rank=rank, world_size=DDP_WORLD,
        timeout=datetime.timedelta(seconds=300))
    out = {"rank": rank}
    try:
        dev = mesh.device_for("cuda:0")
        check(mesh.init_distributed("auto", dev) is False, "the group was not adopted")
        out.update(backend=torch.distributed.get_backend(), world_size=mesh.get_size(),
                   device=str(dev))
        state, step_fn = ddp_model_and_step()
        steps = []
        for step in range(DDP_STEPS):
            x, y = ddp_batch(step, rank)
            x = x.bfloat16()
            collectives.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, x, y)
            m = {k: float(v) for k, v in metrics.items()}
            ms = (time.perf_counter() - t0) * 1e3
            params, stats = ddp_flat(state.model)
            same = True
            for t in (params, stats):
                lo, hi = t.clone(), t.clone()
                torch.distributed.all_reduce(lo, op=torch.distributed.ReduceOp.MIN)
                torch.distributed.all_reduce(hi, op=torch.distributed.ReduceOp.MAX)
                same = same and torch.equal(lo, hi)
            if rank == 0:
                torch.save({"params": params.cpu(), "stats": stats.cpu()},
                           os.path.join(job["tmp"], f"rank0_step{step}.pt"))
            steps.append({"metrics": m, "bit_identical": bool(same),
                          "gloo_step_ms_host_staged": ms})
        out["steps"] = steps
        out["replica"] = type(state.replica).__name__
        root = os.path.join(job["tmp"], f"data{rank}")
        splits, stats = make_arrays(root, shape=(768, 1152), seed=1, n_train=DDP_WORLD,
                                    n_validation=DDP_EVAL_SAMPLES)
        files = {name: (d, lb) for samples in splits.values() for name, d, lb in samples}
        pargs = build_parser().parse_args(DDP_CLI_FLAGS + [
            "--data_dir_prefix", root, "--eval_local_batch_size", str(DDP_EVAL_BATCH),
            "--device", "cuda"])
        _, validation_set = make_datasets(
            pargs, functools.partial(MemoryCamDataset, files=files, stats=stats))
        out["eval_shard"] = len(validation_set)
        eval_fn = make_eval_step(list(class_weights()), fpw_1=FPW_1, fpw_2=FPW_2)
        loader = DataLoader(validation_set, DDP_EVAL_BATCH, num_workers=2, drop_last=False,
                            pin_memory=True)
        out["eval"] = list(validate(state, eval_fn, loader, dev))
        own = os.path.join(job["tmp"], f"out{rank}")  # each rank its own
        os.makedirs(own)
        save_checkpoint(os.path.join(own, "model_step_2.cpt"), state, 0)
        logger = MLPerfLogger(os.path.join(own, "logs", "ddp.log"))
        logger.log_event(key="eval_accuracy", value=out["eval"][2] / out["eval"][0], sync=True)
        logger.close()
    finally:
        mesh.destroy_distributed()
    return out


def ddp_child(job):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    child = {"cli": ddp_child_cli, "gloo": ddp_child_gloo, "spatial": spatial_child,
             "gspmd": gspmd_child}
    result = child[job["kind"]](job)
    with open(job["result"], "w") as f:
        json.dump(result, f)
    return 0


def ddp_emulate(input_scale=None):
    """The two ranks of (b) in this process: each rank's forward and
    backward with its own BN batch statistics from the same running
    statistics, the gradients averaged, one AdamW update, the running
    statistics averaged, loss and IoU averaged.  ``input_scale`` (a
    generator) scales each fp32 input by 1 + 2^-8 * N(0, 1) before its
    rounding to bf16.  Returns per step the metrics and the flat
    parameters and running statistics (on the host)."""
    from deepcam_tpu_torch.ops.classify import argmax_channels
    from deepcam_tpu_torch.train.losses import FPW_1, FPW_2, class_weights, weighted_ce_loss
    from deepcam_tpu_torch.train.metrics import compute_score
    from deepcam_tpu_torch.train.trainer import running_stats

    state, _ = ddp_model_and_step()
    model, opt = state.model, state.optimizer
    params, stats = list(model.parameters()), running_stats(model)
    weights = list(class_weights())
    model.train()
    out = []
    for step in range(DDP_STEPS):
        start = [s.clone() for s in stats]
        grads, rank_stats, losses, ious = [], [], [], []
        for rank in range(DDP_WORLD):
            torch._foreach_copy_(stats, start)
            x, y = ddp_batch(step, rank)
            if input_scale is not None:
                x = x * (1 + 2.0 ** -8 * torch.randn(x.shape, generator=input_scale,
                                                     device="cuda"))
            logits = model(x.bfloat16())
            loss = weighted_ce_loss(logits, y, weights, FPW_1, FPW_2)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            grads.append([p.grad.clone() for p in params])
            rank_stats.append([s.clone() for s in stats])
            losses.append(loss.detach())
            with torch.no_grad():
                ious.append(compute_score(argmax_channels(logits), y,
                                          num_classes=logits.shape[-1]))
            del logits, loss
        for p, *g in zip(params, *grads):
            p.grad = sum(g) / DDP_WORLD
        del grads
        opt.step()
        torch._foreach_copy_(stats, [sum(s) / DDP_WORLD for s in zip(*rank_stats)])
        flat = ddp_flat(model)
        out.append({"metrics": {"loss": float(sum(losses) / DDP_WORLD),
                                "iou": float(sum(ious) / DDP_WORLD)},
                    "params": flat[0].cpu(), "stats": flat[1].cpu(),
                    "rank0_stats": torch.cat([s.reshape(-1) for s in rank_stats[0]]).cpu()})
    del state, model, opt, params, stats
    torch.cuda.empty_cache()
    return out


def ddp_errors(got, ref, sizes):
    """Worst relative error over the tensors of a flat vector: each
    tensor's max |got - ref| over its max |ref|."""
    worst = 0.0
    for a, b in zip(got.split(sizes), ref.split(sizes)):
        worst = max(worst, ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item())
    return worst


def ddp_phase(fs, cli):
    """The data-parallel step on the card (module docstring, phase 10)."""
    from deepcam_tpu_torch.models.deeplab import DeepLabv3plus
    from deepcam_tpu_torch.train.trainer import running_stats

    torch.cuda.empty_cache()
    result = {}
    with tempfile.TemporaryDirectory(prefix="deepcam_ddp_") as tmp:
        # (a) world 1 on NCCL through the CLI
        port = free_port()
        t0 = time.perf_counter()
        (a,) = run_children([{"kind": "cli"}], tmp, lambda i: {
            "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
        a["wall_s"] = time.perf_counter() - t0
        check(a["backend"] == "nccl" and a["world_size"] == 1 and a["replica"] ==
              a["bare"]["ddp"]["replica"] == "DistributedDataParallel"
              and a["bare"]["no_group"]["replica"] == "NoneType", f"ddp (a): {a}")
        check(a["metrics"]["step"] == DDP_CLI_STEPS and a["steps"] == DDP_CLI_STEPS
              and a["metrics"]["eval_samples_seen"] == DDP_CLI_SAMPLES["validation"],
              f"ddp (a): {a['metrics']}")
        want_fwd = {k: TRAIN_FORMS.get(k, 0) * DDP_CLI_STEPS + EVAL_FORMS.get(k, 0)
                    for k in {**TRAIN_FORMS, **EVAL_FORMS}}
        want_bwd = {k: v * DDP_CLI_STEPS for k, v in TRAIN_FORMS.items()}
        for kname, want in (("sepconv_fwd", want_fwd), ("sepconv_bwd", want_bwd)):
            check(a["forms"][kname] == want and a["launches"][kname] == sum(want.values()),
                  f"ddp (a): {kname} forms {a['forms'][kname]}, want {want}")
        # beside it, the cli phase's no-group loop (parent process, same call)
        nogroup = cli["runs"]["cli"]
        result["world1_nccl_cli"] = {
            **a, "launches_per_step": {k: v / DDP_CLI_STEPS for k, v in
                                       a["forms"]["sepconv_bwd"].items()},
            "ddp_minus_no_group_bare_step_ms": (a["bare"]["ddp"]["step_ms_median"]
                                                - a["bare"]["no_group"]["step_ms_median"]),
            "cli_phase_no_group": {
                "loop_step_host_ms_median": nogroup["loop_step_host_ms_median"],
                "bare_step_ms": cli["bare_step_ms"],
                "max_memory_allocated_bytes": nogroup["max_memory_allocated_bytes"]}}

        # (b) two ranks on the one card over gloo, against the emulation
        store = os.path.join(tmp, "gloo.store")
        t0 = time.perf_counter()
        ranks = run_children([{"kind": "gloo", "rank": r, "store": store, "tmp": tmp}
                              for r in range(DDP_WORLD)], tmp)
        wall = time.perf_counter() - t0
        r0, r1 = ranks
        check(all(r["backend"] == "gloo" and r["world_size"] == DDP_WORLD
                  and r["replica"] == "DistributedDataParallel" for r in ranks), f"ddp (b): {ranks}")
        for s0, s1 in zip(r0["steps"], r1["steps"]):
            check(s0["bit_identical"] and s1["bit_identical"] and s0["metrics"] == s1["metrics"],
                  f"ddp (b): the ranks differ: {s0}, {s1}")
        check(r0["eval"] == r1["eval"] and r0["eval"][0] == DDP_EVAL_SAMPLES
              and [r["eval_shard"] for r in ranks] == [2, 3],
              f"ddp (b) eval: {r0['eval']}, {r1['eval']}, shards "
              f"{[r['eval_shard'] for r in ranks]}")
        files = {r: sorted(os.path.relpath(os.path.join(d, f), tmp)
                           for d, _, fl in os.walk(os.path.join(tmp, f"out{r}")) for f in fl)
                 for r in range(DDP_WORLD)}
        check(files == {0: ["out0/logs/ddp.log", "out0/model_step_2.cpt"], 1: []},
              f"ddp (b): only rank 0 writes: {files}")

        shapes = DeepLabv3plus(n_classes=3, dtype=torch.bfloat16, device="cpu", seed=333)
        psizes = [p.numel() for p in shapes.parameters()]
        ssizes = [b.numel() for b in running_stats(shapes)]
        del shapes

        emu = [ddp_emulate(), ddp_emulate()]
        bf16 = ddp_emulate(torch.Generator(device="cuda").manual_seed(7))
        errs = {}
        for step in range(DDP_STEPS):
            ranked = torch.load(os.path.join(tmp, f"rank0_step{step}.pt"))
            ref = emu[0][step]
            for name, sizes in (("params", psizes), ("stats", ssizes)):
                errs[f"{name}_step{step + 1}"] = {
                    "ranks": ddp_errors(ranked[name], ref[name], sizes),
                    "spread": ddp_errors(emu[1][step][name], ref[name], sizes),
                    "bf16_inputs": ddp_errors(bf16[step][name], ref[name], sizes)}
            for k in ("loss", "iou"):
                want = ref["metrics"][k]
                errs[f"{k}_step{step + 1}"] = {
                    key: abs(m - want) / max(abs(want), 1e-30) for key, m in (
                        ("ranks", r0["steps"][step]["metrics"][k]),
                        ("spread", emu[1][step]["metrics"][k]),
                        ("bf16_inputs", bf16[step]["metrics"][k]))}
            errs[f"rank0_own_stats_step{step + 1}"] = {
                "vs_mean": ddp_errors(ref["rank0_stats"], ref["stats"], ssizes)}
        for key, e in errs.items():
            if "ranks" not in e:
                continue
            limit = DDP_SPREAD * e["spread"]
            check(e["ranks"] <= limit, f"ddp (b) {key}: ranks vs emulation {e['ranks']} > "
                                       f"{DDP_SPREAD} x spread {e['spread']}")
            check(limit < e["bf16_inputs"] or e["bf16_inputs"] == 0.0 == limit,
                  f"ddp (b) {key}: limit {limit} not below bf16's own {e['bf16_inputs']}")
        # the running statistics are the ranks' mean, not rank 0's own
        for step in range(1, DDP_STEPS + 1):
            own, mean = errs[f"rank0_own_stats_step{step}"], errs[f"stats_step{step}"]
            check(own["vs_mean"] > max(DDP_SPREAD * mean["spread"], mean["ranks"]),
                  f"ddp (b) step {step}: rank 0's own statistics {own} are not told "
                  f"apart from the mean {mean}")
        result["world2_gloo_one_card"] = {
            "wall_s": wall, "ranks": ranks, "errors": errs, "spread_factor": DDP_SPREAD,
            "eval": r0["eval"], "files": files,
            "note": "gloo stages CUDA tensors through the host: its step time says "
                    "nothing about scaling"}
    return result


# spatial phase: one spatial group of SPATIAL_S ranks on the one card over
# gloo (NCCL refuses two ranks on one card), the full-width os=16 model from
# seed 333 with AdamW; a global batch of SPATIAL_BATCH samples of (768,
# 1152, 16), each rank holding 768 / SPATIAL_S rows of every sample
SPATIAL_S = 2
SPATIAL_BATCH = 2
SPATIAL_SHAPE = (768, 1152)
SPATIAL_STEPS = 2
SPATIAL_EVAL_VALID = (1.0, 1.0, 1.0)
# the spatial eval against the unsharded eval of the same state on the
# card: the per-sample loss sum relative, the IoU sum absolute over the 3
# samples (bf16 edge rows move a few argmax ties)
SPATIAL_EVAL_TOL = {"loss_sum": 1e-2, "iou_sum": 1e-2}
# The train-mode probe's logits and gradients against the unsharded ones
# measure the yardstick, not the port: on an H100 one bf16 rounding of the
# inputs (scaled by 1 + 2^-8 N(0, 1)) moved the unsharded probe's logits by
# 0.65 of the largest and its gradients by 1.35 (median, norm), where the
# spatial probe read 0.38 and 1.17.  So there the logits and gradients are
# held to SPATIAL_SPREAD times that nudged spread, measured in the same
# run, and the loss to PARITY_TOL; the eval-mode probe (random running
# statistics, no batch statistics coupling the rows) is held to
# PARITY_TOL (measured 0.033, 1.8e-5, 0.0065 and 0.014).
SPATIAL_SPREAD = 1.5


def spatial_batch(n, seed):
    """A batch of ``n`` samples of SPATIAL_SHAPE with 16 channels and its
    labels, made on the card from a seed: the same in every process."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(n, *SPATIAL_SHAPE, 16, generator=gen, device="cuda")
    return x.bfloat16(), torch.randint(0, 3, (n, *SPATIAL_SHAPE), generator=gen, device="cuda")


def spatial_probe(spatial, model, x, y, group=None, size=1, train=True, world_stats=False):
    """One forward and backward of the train step without the update, in
    train mode or (``train=False``) with the running statistics, under
    spatial mode when ``size`` > 1 (the gradients then averaged over the
    ranks, as the spatial step does), with BN statistics over the world
    with ``world_stats`` (the gspmd step's); the running statistics are
    left as they were.  Returns the logits, the loss and the gradients."""
    from deepcam_tpu_torch.parallel.collectives import allreduce_mean_
    from deepcam_tpu_torch.train.losses import FPW_1, FPW_2, class_weights, weighted_ce_loss
    from deepcam_tpu_torch.train.trainer import average_gradients, running_stats

    stats = [b.clone() for b in running_stats(model)]
    model.train(train)
    model.zero_grad(set_to_none=True)
    mode = (spatial.spatial_mode(group, size, world_stats=world_stats) if size > 1
            else contextlib.nullcontext())
    with mode:
        logits = model(x)
        loss = weighted_ce_loss(logits, y, list(class_weights()), FPW_1, FPW_2)
        loss.backward()
        # the loss of the whole images: the mean of the ranks' (equal)
        # shards', over the group, or over the world (the global batch)
        if world_stats:
            value = allreduce_mean_(loss.detach().clone()).item()
        else:
            value = spatial.group_sum(loss.detach()).item() / size
    if size > 1:
        average_gradients(model)
    torch._foreach_copy_(running_stats(model), stats)
    grads = {k: p.grad.detach().float().clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return logits.detach(), value, grads


def spatial_child(job):
    """A rank of the spatial group: the probe with every unit held to the
    plain version, SPATIAL_STEPS timed AdamW steps of the spatial step
    with the counters zeroed just before and read just after, the ranks'
    states compared, and the spatial eval step over SPATIAL_EVAL_VALID's
    samples.  Rank 0 leaves its logits rows, gradients and final state in
    the job's directory; every rank its logits rows."""
    from deepcam_tpu_torch.core import mesh
    from deepcam_tpu_torch.models.deeplab import DeepLabv3plus
    from deepcam_tpu_torch.ops import fused_sepconv as fs
    from deepcam_tpu_torch.parallel import spatial
    from deepcam_tpu_torch.train.losses import FPW_1, FPW_2, class_weights
    from deepcam_tpu_torch.train.optim import build_optimizer
    from deepcam_tpu_torch.train.trainer import create_train_state

    rank = job["rank"]
    torch.distributed.init_process_group(
        "gloo", init_method="file://" + job["store"], rank=rank, world_size=SPATIAL_S,
        timeout=datetime.timedelta(seconds=300))
    out = {"rank": rank}
    try:
        dev = mesh.device_for("cuda:0")
        groups = mesh.init_spatial_groups(SPATIAL_S)
        out.update(backend=torch.distributed.get_backend(), world_size=mesh.get_size(),
                   spatial_index=groups.index, data_size=groups.data_size, device=str(dev))
        model = DeepLabv3plus(n_classes=3, dtype=torch.bfloat16, device=dev, seed=333)
        state = create_train_state(model, build_optimizer(
            "AdamW", model.parameters(), 1e-3, eps=1e-8, weight_decay=1e-2))
        x, y = spatial_batch(SPATIAL_BATCH, 200)
        h = SPATIAL_SHAPE[0] // SPATIAL_S
        rows = slice(groups.index * h, (groups.index + 1) * h)
        x, y = x[:, rows].contiguous(), y[:, rows].contiguous()
        out["input"] = list(x.shape)

        # the probe: every unit of this rank's step held to the plain version
        probe = {}

        def probe_step(st, xx, yy):
            probe["logits"], probe["loss"], probe["grads"] = spatial_probe(
                spatial, st.model, xx, yy, groups.group, groups.size)
            return st, {"loss": torch.tensor(probe["loss"])}

        _, _, worst, units = checked_unit_step(fs, probe_step, state, x, y, TRAIN_FORMS,
                                               UNIT_DILATIONS)
        out.update(units_worst_rel=worst, units=len(units["fwd"]),
                   distinct_units=sorted({u[1:] for u in units["fwd"]}),
                   probe_loss=probe["loss"])
        torch.save(probe["logits"].cpu(), os.path.join(job["tmp"], f"logits{rank}.pt"))
        if rank == 0:
            torch.save(probe["grads"], os.path.join(job["tmp"], "grads0.pt"))
        del probe
        # the same probe in eval mode, with random running statistics (as
        # the parity phase): no batch statistics couple the rows
        frozen = DeepLabv3plus(n_classes=3, dtype=torch.bfloat16, device=dev, seed=333)
        random_running_stats(frozen, 8)
        logits, out["probe_loss_eval"], grads = spatial_probe(
            spatial, frozen, x, y, groups.group, groups.size, train=False)
        torch.save(logits.cpu(), os.path.join(job["tmp"], f"eval_logits{rank}.pt"))
        if rank == 0:
            torch.save(grads, os.path.join(job["tmp"], "eval_grads0.pt"))
        del frozen, logits, grads

        step_fn = spatial.make_train_step_spatial(list(class_weights()), fpw_1=FPW_1,
                                                  fpw_2=FPW_2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fs.reset_launches()
        steps = []
        for _ in range(SPATIAL_STEPS):
            torch.distributed.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, x, y)
            m = {k: float(v) for k, v in metrics.items()}
            steps.append({"metrics": m, "gloo_staged_step_ms": (time.perf_counter() - t0) * 1e3})
        torch.cuda.synchronize()
        out.update(steps=steps, launches=dict(fs.LAUNCHES), forms=measured_forms(fs),
                   max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
        check_counts(f"spatial rank {rank}", out["launches"], out["forms"], SPATIAL_STEPS,
                     TRAIN_FORMS, TRAIN_FORMS)
        same = True
        for t in ddp_flat(model):
            lo, hi = t.clone(), t.clone()
            torch.distributed.all_reduce(lo, op=torch.distributed.ReduceOp.MIN)
            torch.distributed.all_reduce(hi, op=torch.distributed.ReduceOp.MAX)
            same = same and torch.equal(lo, hi)
        out["bit_identical"] = bool(same)
        if rank == 0:
            torch.save(model.state_dict(), os.path.join(job["tmp"], "state0.pt"))

        xe, ye = spatial_batch(len(SPATIAL_EVAL_VALID), 201)
        eval_fn = spatial.make_eval_step_spatial(list(class_weights()), fpw_1=FPW_1,
                                                 fpw_2=FPW_2)
        valid = torch.tensor(SPATIAL_EVAL_VALID, device=dev)
        fs.reset_launches()
        sums = eval_fn(state, xe[:, rows].contiguous(), ye[:, rows].contiguous(), valid)
        out["eval"] = [float(t) for t in sums]
        out["eval_launches"], out["eval_forms"] = dict(fs.LAUNCHES), measured_forms(fs)
        check_counts(f"spatial eval rank {rank}", out["eval_launches"], out["eval_forms"], 1,
                     EVAL_FORMS, {})
    finally:
        mesh.destroy_distributed()
    return out


def spatial_phase(fs):
    """Spatial H-sharding on the card (module docstring, phase 12): the two
    ranks, then the same model's unsharded probe and eval in this process,
    after the ranks have left the card."""
    from deepcam_tpu_torch.models.deeplab import DeepLabv3plus
    from deepcam_tpu_torch.parallel import spatial
    from deepcam_tpu_torch.train.losses import FPW_1, FPW_2, class_weights
    from deepcam_tpu_torch.train.optim import build_optimizer
    from deepcam_tpu_torch.train.trainer import create_train_state, make_eval_step

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="deepcam_spatial_") as tmp:
        store = os.path.join(tmp, "gloo.store")
        t0 = time.perf_counter()
        ranks = run_children([{"kind": "spatial", "rank": r, "store": store, "tmp": tmp}
                              for r in range(SPATIAL_S)], tmp)
        wall = time.perf_counter() - t0
        check(all(r["backend"] == "gloo" and r["world_size"] == SPATIAL_S and r["data_size"] == 1
                  for r in ranks), f"spatial: {ranks}")
        check(all(r["units"] == UNITS_PER_STEP for r in ranks), "spatial: units per rank")
        for s0, s1 in zip(ranks[0]["steps"], ranks[1]["steps"]):
            check(s0["metrics"] == s1["metrics"], f"spatial: the ranks' metrics differ {s0} {s1}")
        check(all(r["bit_identical"] for r in ranks),
              "spatial: the ranks' parameters or running statistics differ after "
              f"{SPATIAL_STEPS} steps")
        check(ranks[1]["eval"] == [0.0, 0.0, 0.0],
              f"spatial eval: rank 1 must add zeros, got {ranks[1]['eval']}")
        # the same model unsharded on the card: the probes at the global
        # batch, and the eval of rank 0's trained state
        x, y = spatial_batch(SPATIAL_BATCH, 200)
        par = {}
        for mode, prefix in (("train", ""), ("eval", "eval_")):
            logits = torch.cat([torch.load(os.path.join(tmp, f"{prefix}logits{r}.pt"))
                                for r in range(SPATIAL_S)], dim=1)
            grads = torch.load(os.path.join(tmp, f"{prefix}grads0.pt"))
            model = DeepLabv3plus(n_classes=3, dtype=torch.bfloat16, device="cuda", seed=333)
            if mode == "eval":
                random_running_stats(model, 8)
            ref_logits, ref_loss, ref_grads = spatial_probe(spatial, model, x, y,
                                                            train=mode == "train")

            def errors(logits, loss, grads):
                grad_norm = sorted(norm_err(grads[k], g) for k, g in ref_grads.items())
                return {"logits": rel_err(logits, ref_logits),
                        "loss": abs(loss - ref_loss) / abs(ref_loss),
                        "grad_norm_median": grad_norm[len(grad_norm) // 2],
                        "grad_norm_max": grad_norm[-1], "n_grads": len(grad_norm)}

            spatial_loss = ranks[0]["probe_loss" if mode == "train" else "probe_loss_eval"]
            par[mode] = {**errors(logits, spatial_loss, grads), "loss_unsharded": ref_loss,
                         "loss_spatial": spatial_loss}
            del logits, grads
            # the yardstick: the unsharded probe with its inputs scaled by
            # 1 + 2^-8 * N(0, 1) before their rounding to bf16
            scale = torch.randn(x.shape, generator=torch.Generator(device="cuda").manual_seed(7),
                                device="cuda")
            nudged = spatial_probe(spatial, model, (x.float() * (1 + 2.0 ** -8 * scale))
                                   .bfloat16(), y, train=mode == "train")
            par[mode]["bf16_inputs_unsharded"] = errors(*nudged)
            del scale, nudged, ref_logits, ref_grads, model
        trained = torch.load(os.path.join(tmp, "state0.pt"))
        model = DeepLabv3plus(n_classes=3, dtype=torch.bfloat16, device="cuda", seed=333)
        model.load_state_dict(trained)
        state = create_train_state(model, build_optimizer("AdamW", model.parameters(), 1e-3))
        xe, ye = spatial_batch(len(SPATIAL_EVAL_VALID), 201)
        want = [float(t) for t in make_eval_step(list(class_weights()), fpw_1=FPW_1,
                                                 fpw_2=FPW_2)(
            state, xe, ye, torch.tensor(SPATIAL_EVAL_VALID, device="cuda"))]
        got = ranks[0]["eval"]
        eval_errs = {"loss_sum": abs(got[1] - want[1]) / abs(want[1]),
                     "iou_sum": abs(got[2] - want[2])}
        del model, state, xe, ye, trained, x, y
        torch.cuda.empty_cache()
    emit({"phase": "spatial_errors", "vs_unsharded": par, "tolerance": PARITY_TOL,
          "eval": {"spatial": got, "unsharded": want, "errors": eval_errs}})
    train = par["train"]
    for k, tol in PARITY_TOL.items():
        if k == "loss":
            limit = tol
        else:
            limit = SPATIAL_SPREAD * train["bf16_inputs_unsharded"][k]
        check(train[k] <= limit, f"spatial vs unsharded (train mode): {k} {train[k]} > {limit}")
        check(par["eval"][k] <= tol,
              f"spatial vs unsharded (eval mode): {k} {par['eval'][k]} > {tol}")
    check(got[0] == want[0] == sum(SPATIAL_EVAL_VALID), f"spatial eval count: {got}, {want}")
    for k, tol in SPATIAL_EVAL_TOL.items():
        check(eval_errs[k] <= tol, f"spatial eval vs unsharded: {k} {eval_errs[k]} > {tol}")
    return {"wall_s": wall, "ranks": ranks, "vs_unsharded": par, "tolerance": PARITY_TOL,
            "train_spread_factor": SPATIAL_SPREAD,
            "eval": {"spatial": got, "unsharded": want, "errors": eval_errs,
                     "tolerance": SPATIAL_EVAL_TOL},
            "launches_per_rank": ranks[0]["launches"],
            "note": "gloo stages CUDA tensors through the host: the step time is the "
                    "two ranks sharing one card, not a scaling number"}


# remat phase: the slice's model and optimizer from seed 333 on the slice's
# batch (4, 768, 1152, 16); one step each without remat (twice: their
# spread) and with remat from the same initial state, then 1 warm-up and
# REMAT_TIMED steps at each batch of REMAT_BATCHES, without and with remat.
# JAX's remat policy keeps no residual inside the model (no dot without
# batch dimensions; ``models/layers.py:rematerialized``), so the forward
# kernel runs twice per remat step, in the slice's forms, and the backward
# once.
REMAT_BATCHES = (4, 8)
REMAT_TIMED = 3
REMAT_FWD_FORMS = {k: 2 * v for k, v in TRAIN_FORMS.items()}
# gradients and parameters after the remat step against the step without:
# within REMAT_SPREAD times the spread between two steps without remat
# (cuDNN's weight gradients are not bit-reproducible)
REMAT_SPREAD = 3.0


def remat_runs(fs, x, y):
    """One step from the initial state without remat, again without, and
    with remat, each with the counters zeroed just before and read just
    after.  Returns, per run, the loss, the launches and forms, and copies
    of the gradients, the updated parameters and the running statistics."""
    from deepcam_tpu_torch.models.deeplab import DeepLabv3plus
    from deepcam_tpu_torch.train.losses import FPW_1, FPW_2, class_weights
    from deepcam_tpu_torch.train.optim import build_optimizer
    from deepcam_tpu_torch.train.trainer import create_train_state, make_train_step, running_stats

    runs = {}
    for tag, remat in (("plain", False), ("plain_again", False), ("remat", True)):
        model = DeepLabv3plus(n_classes=3, dtype=torch.bfloat16, device="cuda", seed=333)
        state = create_train_state(model, build_optimizer(
            "AdamW", model.parameters(), 1e-3, eps=1e-8, weight_decay=1e-2))
        step_fn = make_train_step(list(class_weights()), fpw_1=FPW_1, fpw_2=FPW_2, remat=remat)
        torch.cuda.synchronize()
        fs.reset_launches()
        state, metrics = step_fn(state, x, y)
        torch.cuda.synchronize()
        runs[tag] = {"loss": metrics["loss"].detach().clone(), "launches": dict(fs.LAUNCHES),
                     "forms": measured_forms(fs),
                     "grads": [p.grad.detach().clone() for p in model.parameters()],
                     "params": [p.detach().clone() for p in model.parameters()],
                     "stats": [b.clone() for b in running_stats(model)]}
        del model, state
    return runs


def remat_phase(fs):
    """``make_train_step(remat=True)`` on the card (module docstring,
    phase 13): the remat step against the step without, then the timed
    steps."""
    from deepcam_tpu_torch.models.deeplab import DeepLabv3plus
    from deepcam_tpu_torch.train.losses import FPW_1, FPW_2, class_weights
    from deepcam_tpu_torch.train.optim import build_optimizer
    from deepcam_tpu_torch.train.trainer import create_train_state, make_train_step

    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(STEP_BATCH, 768, 1152, 16, generator=gen, device="cuda").bfloat16()
    y = torch.randint(0, 3, (STEP_BATCH, 768, 1152), generator=gen, device="cuda")
    runs = remat_runs(fs, x, y)
    a, b, r = runs["plain"], runs["plain_again"], runs["remat"]
    check_counts("remat step", r["launches"], r["forms"], 1, REMAT_FWD_FORMS, TRAIN_FORMS)
    for tag in ("plain", "plain_again"):
        check_counts(f"remat phase, {tag} step", runs[tag]["launches"], runs[tag]["forms"], 1,
                     TRAIN_FORMS, TRAIN_FORMS)

    def max_abs(u, v):
        return (u.float() - v.float()).abs().max().item()

    # the forward's outputs: the loss and each running statistic, bit for
    # bit or within the two plain steps' own spread
    fwd = {"loss": (max_abs(r["loss"], a["loss"]), max_abs(b["loss"], a["loss"]))}
    for i, (ur, ua, ub) in enumerate(zip(r["stats"], a["stats"], b["stats"])):
        fwd[f"stat{i}"] = (max_abs(ur, ua), max_abs(ub, ua))
    fwd_bad = {k: v for k, v in fwd.items() if v[0] > v[1]}
    fwd_equal = sum(v[0] == 0.0 for v in fwd.values())

    # the backward's: every gradient and parameter, the worst relative error
    # over the tensors against the two plain steps' worst
    back = {}
    for key in ("grads", "params"):
        errs = [rel_err(ur, ua) for ur, ua in zip(r[key], a[key])]
        spread = [rel_err(ub, ua) for ub, ua in zip(b[key], a[key])]
        back[key] = {"worst": max(errs), "spread": max(spread),
                     "bit_equal_tensors": sum(e == 0.0 for e in errs), "tensors": len(errs)}
    step = {"loss_plain": a["loss"].item(), "loss_remat": r["loss"].item(),
            "forward_outputs": len(fwd), "forward_outputs_bit_equal": fwd_equal,
            "forward_outputs_beyond_spread": fwd_bad, "backward": back,
            "launches": {"plain": a["launches"], "remat": r["launches"]},
            "forms": {"plain": a["forms"], "remat": r["forms"]}}
    del runs, a, b, r
    emit({"phase": "remat_step", **step, "spread_factor": REMAT_SPREAD})
    check(not fwd_bad, f"remat: forward outputs beyond the plain steps' spread: {fwd_bad}")
    for key, v in back.items():
        limit = REMAT_SPREAD * v["spread"]
        check(v["worst"] <= limit if v["spread"] > 0 else v["worst"] == 0.0,
              f"remat: {key} {v['worst']} beyond {REMAT_SPREAD} x {v['spread']}")

    model = DeepLabv3plus(n_classes=3, dtype=torch.bfloat16, device="cuda", seed=333)
    state = create_train_state(model, build_optimizer(
        "AdamW", model.parameters(), 1e-3, eps=1e-8, weight_decay=1e-2))
    steps = {remat: make_train_step(list(class_weights()), fpw_1=FPW_1, fpw_2=FPW_2,
                                    remat=remat) for remat in (False, True)}
    timed = {}
    for batch in REMAT_BATCHES:
        if batch != STEP_BATCH:
            x = torch.rand(batch, 768, 1152, 16, generator=gen, device="cuda").bfloat16()
            y = torch.randint(0, 3, (batch, 768, 1152), generator=gen, device="cuda")
        for remat in (False, True):
            state, res = train_steps(fs, steps[remat], state, x, y, REMAT_TIMED)
            check_counts(f"remat phase, batch {batch}, remat {remat}", res["launches"],
                         res["forms"], WARMUP_STEPS + REMAT_TIMED,
                         REMAT_FWD_FORMS if remat else TRAIN_FORMS, TRAIN_FORMS)
            tag = f"batch{batch}_{'remat' if remat else 'plain'}"
            timed[tag] = res
            emit({"phase": "remat_timing", "tag": tag, "batch": batch, "remat": remat,
                  "ms_per_step": res["ms_per_step"], "samples_per_s": res["samples_per_s"],
                  "max_memory_allocated_bytes": res["max_memory_allocated_bytes"]})
    del model, state, x, y
    torch.cuda.empty_cache()
    return {"step": step, "timed": timed, "launches": step["launches"]["remat"]}


# gspmd phase: the spatial phase's model, optimizer and shard shapes, on
# GSPMD_WORLD gloo ranks in data groups of GSPMD_S (D = 2): a global batch
# of GSPMD_BATCH synthetic (768, 1152, 16) samples, data group g holding
# samples 2g and 2g+1, each rank (2, 384, 1152, 16) of them.  The second
# group's inputs are scaled by GSPMD_SCALE: with samples of one
# distribution the world's BN statistics lie as close to each group's as
# one bf16 rounding of the inputs moves them (measured on an H100: the
# group-only statistics 0.182 from the unsharded ones at the worst tensor,
# the rounding 0.127), and the check could not tell a world sync from
# none.
GSPMD_WORLD, GSPMD_S, GSPMD_BATCH = 4, 2, 4
GSPMD_STEPS = 2
GSPMD_SCALE = 2.0


def gspmd_batch():
    """The global batch of the gspmd phase and its labels, made on the
    card from a seed: the second data group's samples scaled."""
    x, y = spatial_batch(GSPMD_BATCH, 300)
    half = GSPMD_BATCH // 2
    x[half:] = (x[half:].float() * GSPMD_SCALE).bfloat16()
    return x, y


def gspmd_share(x, groups):
    """This rank's share of a global batch (or labels): its data group's
    samples, its rows of each."""
    h = x.shape[1] // groups.size
    n = x.shape[0] // groups.data_size
    return x[groups.data_index * n:(groups.data_index + 1) * n,
             groups.index * h:(groups.index + 1) * h].contiguous()


def gspmd_child(job):
    """A rank of the gspmd phase: the train-mode probe with every unit held
    to the plain version, the eval-mode probe, GSPMD_STEPS timed AdamW
    steps of ``make_train_step_gspmd`` with the counters zeroed just before
    and read just after, and the ranks' states compared.  Every rank leaves
    its logits rows; rank 0 its gradients and the running statistics after
    step 1."""
    from deepcam_tpu_torch.core import mesh
    from deepcam_tpu_torch.models.deeplab import DeepLabv3plus
    from deepcam_tpu_torch.ops import fused_sepconv as fs
    from deepcam_tpu_torch.parallel import spatial
    from deepcam_tpu_torch.parallel.gspmd import make_train_step_gspmd
    from deepcam_tpu_torch.train.losses import FPW_1, FPW_2, class_weights
    from deepcam_tpu_torch.train.optim import build_optimizer
    from deepcam_tpu_torch.train.trainer import create_train_state, running_stats

    rank = job["rank"]
    torch.distributed.init_process_group(
        "gloo", init_method="file://" + job["store"], rank=rank, world_size=GSPMD_WORLD,
        timeout=datetime.timedelta(seconds=300))
    out = {"rank": rank}
    try:
        dev = mesh.device_for("cuda:0")
        groups = mesh.init_spatial_groups(GSPMD_S)
        out.update(backend=torch.distributed.get_backend(), world_size=mesh.get_size(),
                   spatial_index=groups.index, data_index=groups.data_index,
                   data_size=groups.data_size, device=str(dev))
        model = DeepLabv3plus(n_classes=3, dtype=torch.bfloat16, device=dev, seed=333)
        state = create_train_state(model, build_optimizer(
            "AdamW", model.parameters(), 1e-3, eps=1e-8, weight_decay=1e-2))
        x, y = (gspmd_share(t, groups) for t in gspmd_batch())
        out["input"] = list(x.shape)
        probe = {}

        def probe_step(st, xx, yy):
            probe["logits"], probe["loss"], probe["grads"] = spatial_probe(
                spatial, st.model, xx, yy, groups.group, groups.size, world_stats=True)
            return st, {"loss": torch.tensor(probe["loss"])}

        _, _, worst, units = checked_unit_step(fs, probe_step, state, x, y, TRAIN_FORMS,
                                               UNIT_DILATIONS)
        out.update(units_worst_rel=worst, units=len(units["fwd"]),
                   distinct_units=sorted({u[1:] for u in units["fwd"]}),
                   probe_loss=probe["loss"])
        torch.save(probe["logits"].cpu(), os.path.join(job["tmp"], f"logits{rank}.pt"))
        if rank == 0:
            torch.save(probe["grads"], os.path.join(job["tmp"], "grads0.pt"))
        del probe
        frozen = DeepLabv3plus(n_classes=3, dtype=torch.bfloat16, device=dev, seed=333)
        random_running_stats(frozen, 8)
        logits, out["probe_loss_eval"], grads = spatial_probe(
            spatial, frozen, x, y, groups.group, groups.size, train=False, world_stats=True)
        torch.save(logits.cpu(), os.path.join(job["tmp"], f"eval_logits{rank}.pt"))
        if rank == 0:
            torch.save(grads, os.path.join(job["tmp"], "eval_grads0.pt"))
        del frozen, logits, grads

        step_fn = make_train_step_gspmd(list(class_weights()), fpw_1=FPW_1, fpw_2=FPW_2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fs.reset_launches()
        steps = []
        for i in range(GSPMD_STEPS):
            torch.distributed.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, x, y)
            m = {k: float(v) for k, v in metrics.items()}
            steps.append({"metrics": m, "gloo_staged_step_ms": (time.perf_counter() - t0) * 1e3})
            if i == 0 and rank == 0:
                torch.save([b.cpu() for b in running_stats(model)],
                           os.path.join(job["tmp"], "stats1.pt"))
        torch.cuda.synchronize()
        out.update(steps=steps, launches=dict(fs.LAUNCHES), forms=measured_forms(fs),
                   max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
        check_counts(f"gspmd rank {rank}", out["launches"], out["forms"], GSPMD_STEPS,
                     TRAIN_FORMS, TRAIN_FORMS)
        same = True
        for t in ddp_flat(model):
            lo, hi = t.clone(), t.clone()
            torch.distributed.all_reduce(lo, op=torch.distributed.ReduceOp.MIN)
            torch.distributed.all_reduce(hi, op=torch.distributed.ReduceOp.MAX)
            same = same and torch.equal(lo, hi)
        out["bit_identical"] = bool(same)
    finally:
        mesh.destroy_distributed()
    return out


def stats_moves(stats):
    """Each running statistic's move from its initial value (means 0,
    variances 1) after one step."""
    return [s.float() - (1.0 if i % 2 else 0.0) for i, s in enumerate(stats)]


def gspmd_phase(fs):
    """The gspmd step on the card (module docstring, phase 14): the four
    ranks, then the same model unsharded at the global batch in this
    process, after the ranks have left the card."""
    from deepcam_tpu_torch.models.deeplab import DeepLabv3plus
    from deepcam_tpu_torch.parallel import spatial
    from deepcam_tpu_torch.train.losses import FPW_1, FPW_2, class_weights
    from deepcam_tpu_torch.train.optim import build_optimizer
    from deepcam_tpu_torch.train.trainer import create_train_state, make_train_step, running_stats

    torch.cuda.empty_cache()
    d = GSPMD_WORLD // GSPMD_S
    with tempfile.TemporaryDirectory(prefix="deepcam_gspmd_") as tmp:
        store = os.path.join(tmp, "gloo.store")
        t0 = time.perf_counter()
        ranks = run_children([{"kind": "gspmd", "rank": r, "store": store, "tmp": tmp}
                              for r in range(GSPMD_WORLD)], tmp)
        wall = time.perf_counter() - t0
        check(all(r["backend"] == "gloo" and r["world_size"] == GSPMD_WORLD
                  and r["data_size"] == d for r in ranks), f"gspmd: {ranks}")
        check(all(r["units"] == UNITS_PER_STEP for r in ranks), "gspmd: units per rank")
        check(all(r["steps"][i]["metrics"] == ranks[0]["steps"][i]["metrics"]
                  for r in ranks for i in range(GSPMD_STEPS)), "gspmd: the ranks' metrics differ")
        check(all(r["bit_identical"] for r in ranks),
              f"gspmd: the ranks' parameters or running statistics differ after {GSPMD_STEPS} "
              "steps")
        x, y = gspmd_batch()
        scale = torch.randn(x.shape, generator=torch.Generator(device="cuda").manual_seed(7),
                            device="cuda")
        x_nudged = (x.float() * (1 + 2.0 ** -8 * scale)).bfloat16()
        del scale
        par = {}
        for mode, prefix in (("train", ""), ("eval", "eval_")):
            # the ranks' logits rows joined along H in each data group, then
            # the groups' samples
            logits = torch.cat([torch.cat([torch.load(os.path.join(tmp, f"{prefix}logits{r}.pt"))
                                           for r in range(g * GSPMD_S, (g + 1) * GSPMD_S)], dim=1)
                                for g in range(d)], dim=0)
            grads = torch.load(os.path.join(tmp, f"{prefix}grads0.pt"))
            model = DeepLabv3plus(n_classes=3, dtype=torch.bfloat16, device="cuda", seed=333)
            if mode == "eval":
                random_running_stats(model, 8)
            ref_logits, ref_loss, ref_grads = spatial_probe(spatial, model, x, y,
                                                            train=mode == "train")

            def errors(logits, loss, grads):
                grad_norm = sorted(norm_err(grads[k], g) for k, g in ref_grads.items())
                return {"logits": rel_err(logits, ref_logits),
                        "loss": abs(loss - ref_loss) / abs(ref_loss),
                        "grad_norm_median": grad_norm[len(grad_norm) // 2],
                        "grad_norm_max": grad_norm[-1], "n_grads": len(grad_norm)}

            gspmd_loss = ranks[0]["probe_loss" if mode == "train" else "probe_loss_eval"]
            par[mode] = {**errors(logits, gspmd_loss, grads), "loss_unsharded": ref_loss,
                         "loss_gspmd": gspmd_loss}
            del logits, grads
            par[mode]["bf16_inputs_unsharded"] = errors(*spatial_probe(
                spatial, model, x_nudged, y, train=mode == "train"))
            del ref_logits, ref_grads, model

        # one device on the global batch: step 1's running statistics and
        # train IoU, with and without the bf16 rounding of the inputs
        def one_step(inputs):
            model = DeepLabv3plus(n_classes=3, dtype=torch.bfloat16, device="cuda", seed=333)
            state = create_train_state(model, build_optimizer(
                "AdamW", model.parameters(), 1e-3, eps=1e-8, weight_decay=1e-2))
            _, metrics = make_train_step(list(class_weights()), fpw_1=FPW_1, fpw_2=FPW_2)(
                state, inputs, y)
            return float(metrics["iou"]), stats_moves(running_stats(model))

        iou_one, moves_one = one_step(x)
        iou_nudged, moves_nudged = one_step(x_nudged)
        # the spatial step's group-only statistics after step 1: each data group's own
        # batch statistics (one train-mode forward from the initial state),
        # averaged over the groups
        n = GSPMD_BATCH // d
        group_stats = []
        for g in range(d):
            with torch.no_grad():
                fresh = DeepLabv3plus(n_classes=3, dtype=torch.bfloat16, device="cuda", seed=333)
                fresh.train()(x[g * n:(g + 1) * n])
            group_stats.append(running_stats(fresh))
            del fresh
        moves_group = stats_moves([sum(s) / d for s in zip(*group_stats)])
        del group_stats
        moves_gspmd = stats_moves(torch.load(os.path.join(tmp, "stats1.pt")))

        def stat_errors(moves):
            errs = sorted(norm_err(m, w) for m, w in zip(moves, moves_one))
            return {"stats_norm_median": errs[len(errs) // 2], "stats_norm_max": errs[-1]}

        stats = {"gspmd": stat_errors(moves_gspmd), "bf16_inputs_unsharded":
                 stat_errors(moves_nudged), "group_only": stat_errors(moves_group)}
        iou = {"gspmd": ranks[0]["steps"][0]["metrics"]["iou"], "unsharded": iou_one,
               "bf16_inputs_unsharded": iou_nudged}
        del x, y, x_nudged, moves_one, moves_nudged, moves_group, moves_gspmd
        torch.cuda.empty_cache()
    emit({"phase": "gspmd_errors", "vs_unsharded": par, "stats_after_step1": stats,
          "train_iou_step1": iou, "tolerance": PARITY_TOL, "spread_factor": SPATIAL_SPREAD})
    train = par["train"]
    for k, tol in PARITY_TOL.items():
        limit = tol if k == "loss" else SPATIAL_SPREAD * train["bf16_inputs_unsharded"][k]
        check(train[k] <= limit, f"gspmd vs unsharded (train mode): {k} {train[k]} > {limit}")
        check(par["eval"][k] <= tol,
              f"gspmd vs unsharded (eval mode): {k} {par['eval'][k]} > {tol}")
    for k, v in stats["gspmd"].items():
        limit = SPATIAL_SPREAD * stats["bf16_inputs_unsharded"][k]
        check(v <= limit, f"gspmd running statistics after step 1: {k} {v} > {limit}")
        # the check has the power to see the sync: group-only statistics fail it
        check(stats["group_only"][k] > limit,
              f"group-only running statistics after step 1 pass the gspmd check: {k} "
              f"{stats['group_only'][k]} <= {limit}")
    iou_limit = SPATIAL_SPREAD * abs(iou_nudged - iou_one)
    check(abs(iou["gspmd"] - iou_one) <= iou_limit,
          f"gspmd train IoU {iou['gspmd']} against the unsharded {iou_one}: beyond {iou_limit}")
    return {"wall_s": wall, "ranks": ranks, "vs_unsharded": par, "stats_after_step1": stats,
            "train_iou_step1": iou, "tolerance": PARITY_TOL, "spread_factor": SPATIAL_SPREAD,
            "launches_per_rank": ranks[0]["launches"],
            "note": "gloo stages CUDA tensors through the host: the step time is four ranks "
                    "sharing one card, not a scaling number"}


def profile_run(fs, cli, out_dir, tag, extra):
    """``cli/profile.py:main`` once at full width with the counters zeroed
    just before and read just after; each Forward and Backward phase's
    launches of its kernel, from the phase functions main calls (wrapped
    here, restored after)."""
    args = cli.build_parser().parse_args(
        ["--num_warmup_steps", str(PROFILE_WARMUP), "--num_profile_steps", str(PROFILE_STEPS),
         "--output_dir", out_dir, "--run_tag", tag, "--device", "cuda", *extra])
    per_call = {"Forward": [], "Backward": []}
    orig = cli.forward_loss, cli.backward

    def counted(fn, phase, kernel):
        def call(*a):
            n0 = fs.LAUNCHES[kernel]
            out = fn(*a)
            per_call[phase].append(fs.LAUNCHES[kernel] - n0)
            return out
        return call

    cli.forward_loss = counted(orig[0], "Forward", "sepconv_fwd")
    cli.backward = counted(orig[1], "Backward", "sepconv_bwd")
    torch.cuda.synchronize()
    fs.reset_launches()
    t0 = time.perf_counter()
    try:
        report = cli.main(args)
    finally:
        cli.forward_loss, cli.backward = orig
    seconds = time.perf_counter() - t0
    launches = dict(fs.LAUNCHES)
    steps = PROFILE_WARMUP + PROFILE_STEPS
    for phase in per_call:  # the steps' calls come first, then the counts'
        check(per_call[phase][:steps] == [UNITS_PER_STEP] * steps,
              f"profile {tag}: {phase} launches per step {per_call[phase][:steps]}, "
              f"want {UNITS_PER_STEP}")
    return args, report, {"per_step": {k: v[:steps] for k, v in per_call.items()},
                          "total": launches}, seconds


def profile_phase(fs, smi, out_dir):
    """The profiling entry point (``cli/profile.py``) at full width, twice:
    (A) without a trace, (B) with ``--profile Backward``.  Prints the REPORT
    lines (main does), the phase means, FLOPs and bytes, the roofline, the
    FLOPs per sample beside bench.py's count; from (B)'s newest trace, the
    op tables per step through ``profiling/op_profile.py``, and checks the
    Backward trace: 60 launches of each backward kernel, equal to the
    wrapper's count over the step, no forward kernel, a module scope on
    every sepconv kernel, device time within the region's wall time, and
    achieved TFLOP/s between 0 and the peak.  The traces go under
    ``out_dir``."""
    from deepcam_tpu_torch.cli import profile as cli
    from deepcam_tpu_torch.profiling import op_profile
    from deepcam_tpu_torch.profiling.op_table import (
        category_table, find_trace, load_device_ops, op_table, per_step, scope_table,
        unattributed_share)
    from deepcam_tpu_torch.profiling.profiler import GPU_PEAKS

    t_phase = time.perf_counter()
    runs = {}
    for tag, extra in (("A", []), ("B", ["--profile", "Backward"])):
        args, report, launches, seconds = profile_run(fs, cli, out_dir, tag, extra)
        batch = args.local_batch_size
        per_sample = (report["Forward"]["flops"] + report["Backward"]["flops"]) / batch / 1e12
        runs[tag] = {
            "seconds": seconds, "launches": launches,
            "mean_ms": {k: report[k]["mean_seconds"] * 1e3
                        for k in ("Forward", "Backward", "Optimizer")},
            "flops": {k: report[k]["flops"] for k in ("Forward", "Backward")},
            "bytes_accessed": {k: report[k]["bytes_accessed"] for k in ("Forward", "Backward")},
            "tflops_per_sec": {k: report[k]["tflops_per_sec"] for k in ("Forward", "Backward")},
            "roofline": report["roofline"],
            "fwd_bwd_tflop_per_sample": per_sample,
            "bench_tflop_per_sample": BENCH_TFLOP_PER_SAMPLE,
            "vs_bench": per_sample / BENCH_TFLOP_PER_SAMPLE}
        emit({"phase": "profile", "run": tag, "flags": extra, "batch": batch,
              "input": [batch, *args.image_size, len(args.channels)], **runs[tag],
              "device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
        for k in ("Forward", "Backward"):
            check(report[k]["flops"] > 0 and math.isfinite(report[k]["mean_seconds"]),
                  f"profile {tag}: {k} report {report[k]}")
        torch.cuda.empty_cache()

    # (B): the newest trace, one Backward step
    logdir = os.path.join(out_dir, "trace", "B")
    ops = load_device_ops(logdir)
    n = ops.attrs["n_steps"]
    check(n == 1, f"profile B: {n} steps in the newest trace, want 1")
    traced_step_launches = runs["B"]["launches"]["per_step"]["Backward"][-1]
    counts = {k: sum(1 for r in ops if f"dsc::{k}" in r["name"])
              for k in ("sepconv_fwd_kernel", "dd_kernel", "dx_ddw_kernel", "dpw_kernel")}
    for k in ("dd_kernel", "dx_ddw_kernel", "dpw_kernel"):
        check(counts[k] == UNITS_PER_STEP * n == traced_step_launches,
              f"profile B: {counts[k]} {k} in the trace, {traced_step_launches} sepconv_bwd "
              f"launches in the step, want {UNITS_PER_STEP}")
    check(counts["sepconv_fwd_kernel"] == 0,
          f"profile B: {counts['sepconv_fwd_kernel']} forward kernels in the Backward trace")
    fused = [r for r in ops if r["category"] == "sepconv (hand-written)"]
    unscoped = sorted({r["name"][:60] for r in fused if not r["scope"]})
    check(fused and not unscoped, f"profile B: sepconv kernels without a scope: {unscoped}")
    busy = sum(ops.column("time_ms")) / n
    region = ops.attrs["region_ms"] / n
    check(0 < busy <= region, f"profile B: device {busy} ms in a {region} ms region")
    peak = GPU_PEAKS["h100-sxm"]["bf16_tflops"]
    achieved = runs["B"]["tflops_per_sec"]["Backward"]
    check(0 < achieved < peak, f"profile B: Backward at {achieved} TFLOP/s, peak {peak}")
    check(op_profile.main([logdir, "--top", "15"]) == 0, "op_profile failed on the trace")
    fams = per_step(category_table(ops), n)
    scopes = per_step(scope_table(ops), n)
    top = per_step(op_table(ops), n)
    emit({"phase": "profile", "run": "B", "trace": os.path.basename(find_trace(logdir)),
          "backward_kernel_counts": counts,
          "device_busy_ms_per_step": busy, "region_ms_per_step": region,
          "unattributed_share": unattributed_share(ops),
          "families": [[r["category"], r["time_ms"], r["invocations"]] for r in fams],
          "scopes_top": [[r["module"], r["time_ms"], r["invocations"]] for r in scopes[:15]],
          "ops_top": [[r["name"][:90], r["category"], r["time_ms"], r["invocations"]]
                      for r in top[:15]],
          "means_ms": {tag: runs[tag]["mean_ms"] for tag in runs},
          "profiler_cost_ms": {k: runs["B"]["mean_ms"][k] - runs["A"]["mean_ms"][k]
                               for k in runs["A"]["mean_ms"]},
          "phase_seconds": time.perf_counter() - t_phase,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi})


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one card",
              file=sys.stderr)
        return 2
    try:
        from deepcam_tpu_torch.analysis import probe_element_window as pw
        from deepcam_tpu_torch.models import layers
        from deepcam_tpu_torch.models.deeplab import DeepLabv3plus
        from deepcam_tpu_torch.models.xception import XceptionBlock
        from deepcam_tpu_torch.ops import build
        from deepcam_tpu_torch.ops import fused_sepconv as fs
        from deepcam_tpu_torch.train.losses import (
            FPW_1, FPW_2, class_weights, weighted_ce_loss)
        from deepcam_tpu_torch.train.optim import build_optimizer
        from deepcam_tpu_torch.train.trainer import create_train_state, make_train_step
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 2
    check(layers.bn_fold_active() and layers.fused_stats_active()
          and layers.boundary_fold_active(), "the default configuration is not active")
    if len(sys.argv) == 3 and sys.argv[1] == "--ddp-child":  # a process of the ddp phase
        return ddp_child(json.loads(sys.argv[2]))

    # 1. device
    smi = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    # 2. build
    secs = build.build()
    emit({"phase": "build", "seconds": secs, "sources": list(build.SOURCES),
          "ptxas": ptxas_report(build)})

    # 3. every form against its plain version, and the probe's counterpart
    rows, splits = kernel_phase(fs)
    probe = probe_phase(pw)
    # host cost of the kernels' TMA maps: one per forward, four per backward
    map_us = fs.map_encode_us(torch.empty(8 << 20, dtype=torch.uint8, device="cuda"))
    emit({"phase": "tensor_maps", "encode_us_per_map": map_us,
          "maps_per_train_step": UNITS_PER_STEP * 5,
          "ms_per_train_step": map_us * UNITS_PER_STEP * 5 / 1e3})
    # host cost of the device guard around each of a train step's 120 launches
    guard = launch_guard_us(build)
    emit({"phase": "launch_guard", "us_per_launch": guard,
          "launches_per_train_step": UNITS_PER_STEP * 2,
          "guard_ms_per_train_step": (guard["always_guarded"] - guard["unguarded"])
          * UNITS_PER_STEP * 2 / 1e3,
          "launch_minus_unguarded_ms_per_train_step": (guard["launch"] - guard["unguarded"])
          * UNITS_PER_STEP * 2 / 1e3})

    # 4. every fused unit of one full-resolution step against the plain version
    batch = STEP_BATCH
    model = DeepLabv3plus(n_classes=3, dtype=torch.bfloat16, device="cuda", seed=333)
    opt = build_optimizer("AdamW", model.parameters(), 1e-3, eps=1e-8, weight_decay=1e-2)
    state = create_train_state(model, opt)
    step_fn = make_train_step(list(class_weights()), fpw_1=FPW_1, fpw_2=FPW_2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(batch, 768, 1152, 16, generator=gen, device="cuda").bfloat16()
    y = torch.randint(0, 3, (batch, 768, 1152), generator=gen, device="cuda")
    state, metrics, worst, units = checked_unit_step(fs, step_fn, state, x, y, TRAIN_FORMS,
                                                     UNIT_DILATIONS)
    emit({"phase": "units", "input": [batch, 768, 1152, 16], "units": len(units["fwd"]),
          "distinct_units": len(set(units["fwd"])), "worst_rel": worst,
          "tolerance": {**UNIT_TOL, "stats_own": STATS_OWN_TOL,
                        "stats_plain": STATS_PLAIN_TOL},
          "loss": float(metrics["loss"])})

    # 5. the slice: full-width training steps through the kernels, in the
    # default configuration, then in the first slice's
    watched = {k: p.detach().clone() for k, p in model.named_parameters()
               if k.endswith(("block4.sepconv1.depthwise.weight", "block4.sepconv1.pointwise.weight",
                              "conv5.pointwise.weight", "last_deconv.weight"))}
    state, slice_default = train_steps(fs, step_fn, state, x, y, TIMED_STEPS)
    steps = WARMUP_STEPS + TIMED_STEPS
    check_counts("slice", slice_default["launches"], slice_default["forms"], steps,
                 TRAIN_FORMS, TRAIN_FORMS)
    launches = slice_default["launches"]
    changed = {k: not torch.equal(v, dict(model.named_parameters())[k].detach())
               for k, v in watched.items()}
    check(all(changed.values()), f"parameters not updated: {changed}")
    layers.set_bn_fold(False)
    layers.set_fused_stats(False)
    try:
        state, slice_base = train_steps(fs, step_fn, state, x, y, BASE_TIMED_STEPS)
    finally:
        layers.set_bn_fold(True)
        layers.set_fused_stats(True)
    check_counts("slice (fold and stats off)", slice_base["launches"], slice_base["forms"],
                 WARMUP_STEPS + BASE_TIMED_STEPS, BASE_FORMS, BASE_FORMS)
    emit({"phase": "slice", "batch": batch, "input": [batch, 768, 1152, 16],
          "default": slice_default, "fold_and_stats_off": slice_base,
          "device": kind, "nvidia_smi": smi})

    # 6. the eval step at full width
    ev = eval_steps(fs, state, x, y, "eval", EVAL_FORMS)
    emit({"phase": "eval", "batch": batch, **ev})
    eval_launches, eval_forms = ev["launches"], ev["forms"]
    del model, opt, state, x, y, watched
    torch.cuda.empty_cache()

    # 7. the output-stride-8 model with the interpolation decoder: the
    # pretrained import, every unit of a step, timed steps, eval, parity
    os8 = os8_phase(fs, smi)

    # 8. train-mode middle-flow blocks (one, and two joined by the boundary
    # fold) and an AdamW step: card (bf16) against CPU (bf16)
    errs, yardsticks = block_parity(layers, XceptionBlock, build_optimizer)
    spread = yardsticks["pair_cpu_bf16_nudged_1e-6"]
    pair_limit = {g: PAIR_SPREAD * spread[g] for g in ("dx", "grad")}
    emit({"phase": "block", "input": [2, 48, 72, 728],
          "worst_max_norm": {case: worst_by_group(e) for case, e in errs.items()},
          "yardsticks_norm": yardsticks, "tolerance": BLOCK_TOL,
          "pair_spread_factor": PAIR_SPREAD, "pair_limit_norm": pair_limit})
    for g, limit in pair_limit.items():
        for case, tol in (("block", BLOCK_TOL[g][1]), ("pair", limit)):
            bf16 = yardsticks[f"{case}_cpu_bf16_vs_fp32"][g]
            check(tol < bf16, f"{case} {g}: limit {tol} not below bf16's own {bf16}")
    for case, case_errs in errs.items():
        for k, (emax, enorm) in case_errs.items():
            group = k.split("/")[0]
            if case.startswith("pair") and group in pair_limit:
                check(enorm <= pair_limit[group],
                      f"{case} {k}: norm error {enorm} > {PAIR_SPREAD} x {spread[group]}")
            else:
                tmax, tnorm = BLOCK_TOL[group]
                check(emax <= tmax and enorm <= tnorm,
                      f"{case} {k}: {emax}, {enorm} > {tmax}, {tnorm}")

    # 9. the whole model, eval mode: card against the CPU's bf16 and fp32 runs
    par = model_parity(DeepLabv3plus, weighted_ce_loss, class_weights)
    emit({"phase": "parity", "input": [2, 64, 96, 16], "mode": "eval", **par,
          "tolerance": {"bf16": PARITY_TOL, "fp32": FP32_TOL}})
    check_parity(par, "parity")

    # 10. the training CLI at full width, with the counters zeroed just
    # before and read just after each of its two runs
    cli = cli_phase(fs)
    emit({"phase": "cli_source", "source": cli["source"]})
    for tag, steps, evals in (("cli", CLI_STEPS, CLI_EVALS), ("resume", 4, 1)):
        run = cli["runs"][tag]
        want_fwd = {k: TRAIN_FORMS.get(k, 0) * steps + EVAL_FORMS.get(k, 0) * evals
                    for k in {**TRAIN_FORMS, **EVAL_FORMS}}
        want_bwd = {k: v * steps for k, v in TRAIN_FORMS.items()}
        for kname, want in (("sepconv_fwd", want_fwd), ("sepconv_bwd", want_bwd)):
            check(run["forms"][kname] == want and run["launches"][kname] == sum(want.values()),
                  f"{tag}: {kname} forms {run['forms'][kname]} in {steps} train steps and "
                  f"{evals} validations, want {want}")
    emit({"phase": "cli", **cli, "slice_step_ms_batch4": slice_default["ms_per_step"],
          "device": kind, "nvidia_smi": smi})

    # 11. data parallelism: (a) world 1 on NCCL through the CLI, (b) two
    # gloo ranks on the one card against their emulation in this process
    ddp = ddp_phase(fs, cli)
    emit({"phase": "ddp", **ddp, "device": kind, "nvidia_smi": smi})

    # 12. spatial H-sharding: one group of two gloo ranks on the one card
    # against the same model unsharded in this process
    sp = spatial_phase(fs)
    emit({"phase": "spatial", **sp, "device": kind, "nvidia_smi": smi})

    # 13. rematerialized train steps: against the step without, then timed
    # at batch 4 and 8 with and without
    rm = remat_phase(fs)
    emit({"phase": "remat", "timed": rm["timed"], "device": kind, "nvidia_smi": smi})

    # 14. gspmd: four gloo ranks (D=2, S=2) on the one card against the same
    # model unsharded on the global batch in this process
    gs = gspmd_phase(fs)
    emit({"phase": "gspmd", **gs, "device": kind, "nvidia_smi": smi})

    # 15. each launch of both kernels on its own, at the headline shapes, and
    # one profiled training step
    split_phase(fs, rows, splits)
    del splits
    model = DeepLabv3plus(n_classes=3, dtype=torch.bfloat16, device="cuda", seed=333)
    opt = build_optimizer("AdamW", model.parameters(), 1e-3, eps=1e-8, weight_decay=1e-2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(batch, 768, 1152, 16, generator=gen, device="cuda").bfloat16()
    y = torch.randint(0, 3, (batch, 768, 1152), generator=gen, device="cuda")
    emit({"phase": "step_profile", "batch": batch,
          **step_profile(fs, step_fn, create_train_state(model, opt), x, y)})
    del model, opt, x, y
    torch.cuda.empty_cache()

    # 16. the profiling entry point at full width, last: it runs the
    # profiler too
    with tempfile.TemporaryDirectory(prefix="deepcam_profile_") as out_dir:
        profile_phase(fs, smi, out_dir)

    # launches per step by form, over all the form's shapes, as measured
    # in the slice (default configuration) and eval phases
    measured = (("train", slice_default["forms"], steps), ("eval", eval_forms, EVAL_STEPS),
                ("os8_train", os8["train"]["forms"], steps),
                ("os8_eval", os8["eval"]["forms"], EVAL_STEPS))
    kernels = []
    for kname, fname, line in (("sepconv_fwd", "sepconv_fwd.cu", 343),
                               ("sepconv_bwd", "sepconv_bwd.cu", 510)):
        head = next(r for r in rows[kname] if (r["form"], r["shape"]) == HEADLINE)
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"deepcam_tpu_torch/ops/csrc/{fname}",
            "replaces": f"deepcam_tpu/ops/pallas/fused_sepconv.py:{line}",
            "launches": launches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in rows[kname]),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "form": HEADLINE[0], "shape": HEADLINE[1], "forms": rows[kname],
            "form_launches_per_step_all_shapes": {
                step: {form: v / n for form, v in forms[kname].items()}
                for step, forms, n in measured},
            "launches_by_path": {"slice": launches[kname], "eval": eval_launches[kname],
                                 "os8": os8["train"]["launches"][kname],
                                 "os8_eval": os8["eval"]["launches"][kname],
                                 "spatial_per_rank": sp["launches_per_rank"][kname],
                                 "remat": rm["launches"][kname],
                                 "gspmd_per_rank": gs["launches_per_rank"][kname],
                                 **{tag: run["launches"][kname]
                                    for tag, run in cli["runs"].items()}}})
    kernels.append(probe)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
