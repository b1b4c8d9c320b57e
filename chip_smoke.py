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
   boundary_stats at the middle shape, affine at block20's sepconv_last.  y,
   dx and d_skip within 2e-2 of the largest reference value (bf16 outputs);
   d_dw, d_pw, da and db within 1e-3 (fp32 sums in another order); each
   channel's Σy and Σy² within 1e-5 of that channel's Σ|y| and Σy² against
   fp64 sums of the kernel's own y, and within 1e-3 against the plain
   version's; d and r bit-exact.  Median times of the kernel,
   the plain version and a library yardstick (elementwise ops, cuDNN
   depthwise, torch.matmul, torch.sum; timed here only), with the card's
   bound for the same work, and the forward's and backward's plans (tile,
   ring stages, blocks per SM, waves).  Then the archived probe's counterpart: the row-window
   copy driven once through its entry at the probe's shape (its launch
   counted), held bit-exact to its plain version, and timed beside
   torch.index_select.
4. units   — one full-resolution training step in which every one of the
   60 fused units holds all its kernel outputs to the plain version on the
   same inputs, with the tolerances of phase 3: every unit shape and form
   of the train step, forward and backward.
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
7. block   — middle-flow Xception blocks in train mode at (2, 48, 72, 728)
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
8. parity  — the whole model in eval mode with random running statistics
   at (2, 64, 96, 16), the same weights on the card (bf16, kernels) and on
   the CPU: against the CPU's bf16 run (plain versions) the logits, the
   weighted-CE loss and the gradient of every parameter (PARITY_TOL);
   against its fp32 run the logits and loss (FP32_TOL).  A coarse gate:
   through ~80 layers bf16 rounding alone moves the gradients by ~15%.
9. split   — at the affine_stats middle and exit shapes and the stats
   entry shape, each launch of both kernels timed on its own; and one
   default-configuration training step (batch 4, after a warm-up) with the
   card's time by kernel.  Both with torch.profiler, and last: once the
   profiler has run, launches stay traced and slower.

Then the ``kernels`` JSON line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises: the script then
exits non-zero and prints no result.
"""

import json
import math
import re
import subprocess
import sys
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
UNITS_PER_STEP = 60
TRAIN_FORMS = {"stats": 5, "affine_stats": 38, "boundary_stats": 16, "affine": 1}
EVAL_FORMS = {"base": 5, "affine": 39, "boundary": 16}
BASE_FORMS = {"base": 60}
# kernel against plain version: bf16 outputs relative to the largest value,
# fp32 sums relative to the largest value
UNIT_TOL = {"y": 2e-2, "dx": 2e-2, "dskip": 2e-2, "ddw": 1e-3, "dpw": 1e-3,
            "da": 1e-3, "db": 1e-3}
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
    C→F: each input read once and each output written once, the GEMMs on
    the bf16 tensor cores and the rest in fp32."""
    affine, skip, stats = form_operands(form)
    act_c, act_f = 2 * p * c, 2 * p * f  # one bf16 tensor of width C, F
    weights = 2 * (9 * c + c * f) + (4 * c if affine else 0)  # dwk, pwk[, a, b]
    # forward: x[, skip] -> y, d[, r][, Σy, Σy²]
    fwd_bytes = (act_c * (2 if skip else 1) + weights + act_f + act_c
                 + (act_c if skip else 0) + (8 * f if stats else 0))
    pro = p * c * ((2 if affine else 0) + (1 if skip else 0) + 1)  # FMA, add, relu
    fwd_ops = [(2 * p * c * f, PEAK_BF16_TENSOR),
               (2 * 9 * p * c + pro + (3 * p * f if stats else 0), PEAK_FP32)]
    # backward: x, g, d[, skip, gr][, y, gs1, gs2] -> dx, d_dw, d_pw[, da, db][, d_skip]
    bwd_bytes = (act_c * 3 + act_f + weights + (2 * act_c if skip else 0)
                 + (act_f + 8 * f if stats else 0)
                 + 4 * (9 * c + c * f) + (8 * c if affine else 0) + (act_c if skip else 0))
    bwd_ops = [(4 * p * c * f, PEAK_BF16_TENSOR),
               (4 * 9 * p * c + 2 * pro + (4 * p * f if stats else 0)
                + (4 * p * c if affine else 0), PEAK_FP32)]
    return bound(fwd_bytes, fwd_ops), bound(bwd_bytes, bwd_ops)


def rel_err(a, b):
    """max |a − b| over max |b|, in fp32 on a's device."""
    a, b = a.detach().float(), b.detach().float().to(a.device)
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def norm_err(a, b):
    """‖a − b‖ over ‖b‖, in fp32 on a's device."""
    a, b = a.detach().float(), b.detach().float().to(a.device)
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


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
    kernel (the 25 largest, and the fused units' share)."""
    from torch.profiler import ProfilerActivity, profile
    state, _ = step_fn(state, x, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, x, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        if us and str(getattr(e, "device_type", "")).endswith("CUDA"):
            by_kernel[e.key[:120]] = (us / 1e3, e.count)
    busy = sum(ms for ms, _ in by_kernel.values())
    fused = sum(ms for k, (ms, _) in by_kernel.items()
                if any(n in k for n in KERNEL_NAMES[:5]))
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:25]
    return {"wall_ms_profiled": wall * 1e3, "device_busy_ms": busy,
            "fused_sepconv_ms": fused, "top": [[k, ms, n] for k, (ms, n) in top]}


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


def checked_unit_step(fs, step_fn, state, x, y):
    """One training step in which each fused unit's kernel outputs are held
    to the plain version on the same inputs (the tolerances of phase 3).
    Returns the worst relative error of each output over the step's units
    and the units seen, by direction."""
    real_fwd, real_bwd = fs.sepconv_fwd, fs.sepconv_bwd
    worst = dict.fromkeys(list(UNIT_TOL) + ["s1", "s2", "s1_plain", "s2_plain"], 0.0)
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
    check(len(units["fwd"]) == len(units["bwd"]) == UNITS_PER_STEP,
          f"{len(units['fwd'])} forward and {len(units['bwd'])} backward units in one step")
    forms = [u[0] for u in units["fwd"]]
    check({k: forms.count(k) for k in set(forms)} == TRAIN_FORMS,
          f"unit forms of one train step: {sorted(forms)}")
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


def model_parity(DeepLabv3plus, weighted_ce_loss, class_weights):
    """The whole model in eval mode at (2, 64, 96, 16) on the card (bf16)
    and on the CPU (bf16 and fp32): logits, loss and every parameter's
    gradient of the loss."""
    xs = torch.rand(2, 64, 96, 16, generator=torch.Generator().manual_seed(5))
    ys = torch.randint(0, 3, (2, 64, 96), generator=torch.Generator().manual_seed(6))
    runs = {}
    for key, dev, dtype in (("card", "cuda", torch.bfloat16), ("cpu16", "cpu", torch.bfloat16),
                            ("cpu32", "cpu", torch.float32)):
        m = DeepLabv3plus(n_classes=3, dtype=dtype, device=dev, seed=7).eval()
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
        from deepcam_tpu_torch.train.trainer import (
            create_train_state, make_eval_step, make_train_step)
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 2
    check(layers.bn_fold_active() and layers.fused_stats_active()
          and layers.boundary_fold_active(), "the default configuration is not active")

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

    # 4. every fused unit of one full-resolution step against the plain version
    batch = STEP_BATCH
    model = DeepLabv3plus(n_classes=3, dtype=torch.bfloat16, device="cuda", seed=333)
    opt = build_optimizer("AdamW", model.parameters(), 1e-3, eps=1e-8, weight_decay=1e-2)
    state = create_train_state(model, opt)
    step_fn = make_train_step(list(class_weights()), fpw_1=FPW_1, fpw_2=FPW_2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(batch, 768, 1152, 16, generator=gen, device="cuda").bfloat16()
    y = torch.randint(0, 3, (batch, 768, 1152), generator=gen, device="cuda")
    state, metrics, worst, units = checked_unit_step(fs, step_fn, state, x, y)
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
    eval_launches = dict(fs.LAUNCHES)
    eval_forms = measured_forms(fs)
    check_counts("eval", eval_launches, eval_forms, EVAL_STEPS, EVAL_FORMS, {})
    count, loss_sum, iou_sum = float(count), float(loss_sum), float(iou_sum)
    check(count == 3.0 and math.isfinite(loss_sum) and loss_sum > 0
          and 0.0 <= iou_sum <= 3.0, f"eval step: {count}, {loss_sum}, {iou_sum}")
    emit({"phase": "eval", "batch": batch, "valid": valid.tolist(), "steps": EVAL_STEPS,
          "ms_per_step": eval_ms, "count": count, "loss_mean": loss_sum / count,
          "iou_mean": iou_sum / count, "launches": eval_launches, "forms": eval_forms})
    del model, opt, state, eval_fn, x, y, watched
    torch.cuda.empty_cache()

    # 7. train-mode middle-flow blocks (one, and two joined by the boundary
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

    # 8. the whole model, eval mode: card against the CPU's bf16 and fp32 runs
    par = model_parity(DeepLabv3plus, weighted_ce_loss, class_weights)
    emit({"phase": "parity", "input": [2, 64, 96, 16], "mode": "eval", **par,
          "tolerance": {"bf16": PARITY_TOL, "fp32": FP32_TOL}})
    for ref, tols in (("bf16", PARITY_TOL), ("fp32", FP32_TOL)):
        for k, tol in tols.items():
            check(par[ref][k] <= tol, f"card vs CPU {ref}: {k} {par[ref][k]} > {tol}")

    # 9. each launch of both kernels on its own, at the headline shapes, and
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

    # launches per step by form, over all the form's shapes, as measured
    # in the slice (default configuration) and eval phases
    measured = (("train", slice_default["forms"], steps), ("eval", eval_forms, EVAL_STEPS))
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
                for step, forms, n in measured}})
    kernels.append(probe)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
