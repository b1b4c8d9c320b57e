#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py

Run from the root of a checkout; needs one CUDA card, PyTorch built for
CUDA and ``nvcc`` (the kernels are built from ``deepcam_tpu_torch/ops/csrc``
into ``deepcam_tpu_torch/build/``).  Imports nothing of JAX or of the JAX
package.  Phases, each printing one JSON line:

1. device  — the card's name and power limit (nvidia-smi); TF32 off for
   fp32 matmuls and convs, so the plain versions run in full fp32.
2. build   — builds the kernels (one nvcc per source, in parallel).
3. kernels — each kernel against its plain PyTorch version on the same bf16
   inputs at three main-path shapes (batch 4): y and dx within 2e-2 of the
   largest reference value (bf16 outputs), d_dw and d_pw within 1e-3 (fp32
   sums in another order), d bit-exact.  Median times of the kernel, the
   plain version and a library yardstick (cuDNN depthwise + torch.matmul,
   timed here only), with the card's bound for the same work.
4. units   — one full-resolution training step in which every one of the
   60 fused units holds its kernels' outputs to the plain version on the
   same inputs, with the tolerances of phase 3: all unit shapes of the
   main path, forward and backward.
5. slice   — the full-width DeepLabv3+ (bf16, fp32 parameters) trained with
   AdamW on a synthetic (4, 768, 1152, 16) batch through ``make_train_step``:
   1 warm-up and 3 timed steps.  The launch counters are zeroed just before
   and read just after: each kernel must run exactly 60 times per step.
6. block   — one middle-flow Xception block in train mode (three fused
   units, BN batch statistics, identity residual) at (2, 48, 72, 728) and
   one AdamW step, on the card (bf16, kernels) and on the CPU (bf16, plain
   versions), from the same weights and input: output, dx, every gradient,
   the running statistics and the updated parameters (BLOCK_TOL).
7. parity  — the whole model in eval mode with random running statistics
   at (2, 64, 96, 16), the same weights on the card (bf16, kernels) and on
   the CPU: against the CPU's bf16 run (plain versions) the logits, the
   weighted-CE loss and the gradient of every parameter (PARITY_TOL);
   against its fp32 run the logits and loss (FP32_TOL).  A coarse gate:
   through ~80 layers bf16 rounding alone moves the gradients by ~15%.

Then the ``kernels`` JSON line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises: the script then
exits non-zero and prints no result.
"""

import json
import math
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_TENSOR = 989e12
PEAK_FP32 = 67e12

# (name, N, H, W, C, F, pre_relu, dilation): the main path's entry,
# middle-flow and exit shapes
SHAPES = [
    ("entry_64x128_384x576", 4, 384, 576, 64, 128, False, 1),
    ("middle_728x728_48x72", 4, 48, 72, 728, 728, True, 1),
    ("exit_1536x2048_48x72_d2", 4, 48, 72, 1536, 2048, True, 2),
]
HEADLINE = "middle_728x728_48x72"  # 48 of the 60 units run at this shape
STEP_BATCH = 4
WARMUP_STEPS, TIMED_STEPS = 1, 3
UNITS_PER_STEP = 60
# Card (bf16, kernels) against CPU (bf16, plain versions): the same rounding
# points, fp32 sums in other orders.  Block phase, (max, norm) errors
# relative to the CPU tensor; measured on an H100 (chip_smoke.py): y 7.8e-3,
# 2.0e-3; dx 2.9e-2, 5.5e-3; gradients 2.8e-2, 6.7e-3; running statistics
# 6.4e-4; parameters after AdamW on the same gradients 2.3e-7.  The phase
# also prints how far bf16 alone moves dx and the gradients (the CPU's bf16
# run against its fp32 run), which the norm tolerances must stay well
# below to tell a wrong kernel from rounding.
BLOCK_TOL = {"y": (2e-2, 1e-2), "dx": (1e-1, 2e-2), "grad": (1e-1, 2e-2),
             "stat": (5e-3, 5e-3), "param": (1e-6, 1e-6)}
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


def emit(obj):
    print(json.dumps(obj), flush=True)


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


def bound(nbytes, ops_by_peak):
    """Least time of the card for the work: the larger of the byte time
    and the operation time (each type of operation at its own peak)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = sum(n / peak for n, peak in ops_by_peak)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(fs):
    """Kernels against their plain versions, and times, at SHAPES."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rows = {"sepconv_fwd": [], "sepconv_bwd": []}
    for name, n, h, w, c, f, pre_relu, dil in SHAPES:
        def rnd(*shape, scale=1.0):
            return (scale * torch.randn(*shape, generator=gen, device="cuda")).bfloat16()

        x, g = rnd(n, h, w, c), rnd(n, h, w, f)
        dwk, pwk = rnd(3, 3, c, scale=1 / 3), rnd(c, f, scale=c ** -0.5)
        y, d = fs.sepconv_fwd(x, dwk, pwk, pre_relu, dil, True)
        y_ref, d_ref = fs.sepconv_fwd_plain(x, dwk, pwk, pre_relu, dil)
        check(torch.equal(d, d_ref), f"{name}: kernel d differs from the plain d")
        got = fs.sepconv_bwd(x, g, dwk, pwk, d, pre_relu, dil)
        want = fs.sepconv_bwd_plain(x, g, dwk, pwk, d_ref, pre_relu, dil)
        torch.cuda.synchronize()
        errs = {}
        for out, a, b, tol in zip(("y", "dx", "d_dw", "d_pw"), (y, *got),
                                  (y_ref, *want), (2e-2, 2e-2, 1e-3, 1e-3)):
            err = (a.float() - b.float()).abs().max().item()
            scale = b.float().abs().max().item()
            check(math.isfinite(err) and err <= tol * scale,
                  f"{name} {out}: max |err| {err} > {tol} * {scale}")
            errs[out] = (err, err / scale)

        # library yardstick: cuDNN depthwise + torch.matmul (never in the port)
        def lib(xx, dw, pw):
            hc = xx.permute(0, 3, 1, 2)
            hc = torch.relu(hc) if pre_relu else hc
            dd = F.conv2d(hc, dw, padding=dil, dilation=dil, groups=c)
            return torch.matmul(dd.permute(0, 2, 3, 1), pw)

        dw_oihw = dwk.permute(2, 0, 1)[:, None].contiguous()
        leaves = [t.detach().clone().requires_grad_() for t in (x, dw_oihw, pwk)]

        reps = 15 if h * w * n > 100_000 else 30
        p = n * h * w
        t = {
            "fwd": time_ms(lambda: fs.sepconv_fwd(x, dwk, pwk, pre_relu, dil, True), reps, flush),
            "fwd_plain": time_ms(lambda: fs.sepconv_fwd_plain(x, dwk, pwk, pre_relu, dil), reps, flush),
            "fwd_lib": time_ms(lambda: lib(x, dw_oihw, pwk), reps, flush),
            "bwd": time_ms(lambda: fs.sepconv_bwd(x, g, dwk, pwk, d, pre_relu, dil), reps, flush),
            "bwd_plain": time_ms(lambda: fs.sepconv_bwd_plain(x, g, dwk, pwk, d, pre_relu, dil),
                                 reps, flush),
        }
        graphs = [lib(*leaves) for _ in range(reps + 1)]
        t["bwd_lib"] = time_ms(lambda: torch.autograd.grad(graphs.pop(), leaves, g),
                               reps, flush)
        # bytes: each input read once, each output written once
        fwd_bytes = 2 * (p * c + 9 * c + c * f + p * f + p * c)          # x, dwk, pwk -> y, d
        bwd_bytes = 2 * (3 * p * c + p * f + 9 * c + c * f) + 4 * (9 * c + c * f)  # x, d, g, k -> dx; fp32 grads
        fwd_b = bound(fwd_bytes, [(2 * p * c * f, PEAK_BF16_TENSOR), (2 * 9 * p * c, PEAK_FP32)])
        bwd_b = bound(bwd_bytes, [(4 * p * c * f, PEAK_BF16_TENSOR), (4 * 9 * p * c, PEAK_FP32)])
        for kname, key, b, outs in (("sepconv_fwd", "fwd", fwd_b, ("y",)),
                                    ("sepconv_bwd", "bwd", bwd_b, ("dx", "d_dw", "d_pw"))):
            rows[kname].append({
                "shape": name, "ms": t[key], "plain_ms": t[key + "_plain"],
                "library_ms": t[key + "_lib"], "bound_ms": b[0], "bound_by": b[1],
                "max_abs_err": max(errs[o][0] for o in outs),
                "max_rel_err": max(errs[o][1] for o in outs),
            })
        emit({"phase": "kernels", "shape": name, "times_ms": t,
              "errors": {k: {"max_abs": v[0], "rel_to_max": v[1]} for k, v in errs.items()}})
        del x, g, y, d, y_ref, d_ref, got, want, graphs
    return rows


def rel_err(a, b):
    """max |a − b| over max |b|, in fp32 on a's device."""
    a, b = a.detach().float(), b.detach().float().to(a.device)
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def norm_err(a, b):
    """‖a − b‖ over ‖b‖, in fp32 on a's device."""
    a, b = a.detach().float(), b.detach().float().to(a.device)
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def checked_unit_step(fs, step_fn, state, x, y):
    """One training step in which each fused unit's kernel outputs are held
    to the plain version on the same inputs (the tolerances of phase 3).
    Returns the worst relative error of each output over the step's units
    and the unit configurations seen."""
    real_fwd, real_bwd = fs.sepconv_fwd, fs.sepconv_bwd
    worst = {"y": 0.0, "dx": 0.0, "d_dw": 0.0, "d_pw": 0.0}
    units = {"fwd": [], "bwd": []}

    def hold(outs, refs, names, tols, unit):
        for out, a, b, tol in zip(names, outs, refs, tols):
            err = rel_err(a, b)
            check(math.isfinite(err) and err <= tol, f"unit {unit} {out}: {err} > {tol}")
            worst[out] = max(worst[out], err)

    def fwd(x, dwk, pwk, pre_relu, dil, emit_d):
        y, d = real_fwd(x, dwk, pwk, pre_relu, dil, emit_d)
        y_ref, d_ref = fs.sepconv_fwd_plain(x, dwk, pwk, pre_relu, dil)
        unit = (*x.shape, pwk.shape[1], pre_relu, dil)
        check(d is None or torch.equal(d, d_ref), f"unit {unit}: kernel d differs")
        hold((y,), (y_ref,), ("y",), (2e-2,), unit)
        units["fwd"].append(unit)
        return y, d

    def bwd(x, g, dwk, pwk, d, pre_relu, dil):
        got = real_bwd(x, g, dwk, pwk, d, pre_relu, dil)
        unit = (*x.shape, pwk.shape[1], pre_relu, dil)
        hold(got, fs.sepconv_bwd_plain(x, g, dwk, pwk, d, pre_relu, dil),
             ("dx", "d_dw", "d_pw"), (2e-2, 1e-3, 1e-3), unit)
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
    return state, metrics, worst, units


def block_parity(XceptionBlock, build_optimizer):
    """One middle-flow block in train mode on the card (bf16, kernels) and
    on the CPU (bf16 and fp32, plain versions), from the same weights and
    input; then one AdamW step on each, all from the card's gradients.
    Returns {tensor: (max error, norm error)} of the card relative to the
    CPU's bf16 run, and the norm error of the CPU's bf16 run relative to
    its fp32 run for dx and the worst gradient (what bf16 alone moves)."""
    n, h, w, c = 2, 48, 72, 728
    gen = torch.Generator().manual_seed(21)
    x = torch.randn(n, c, h, w, generator=gen) + 0.3
    ct = torch.randn(n, c, h, w, generator=gen)
    runs, card_grads = {}, None
    for key, dev, dtype in (("card", "cuda", torch.bfloat16), ("cpu16", "cpu", torch.bfloat16),
                            ("cpu32", "cpu", torch.float32)):
        block = XceptionBlock(c, c, 3, dtype=dtype,
                              gen=torch.Generator().manual_seed(22)).to(dev).train()
        opt = build_optimizer("AdamW", block.parameters(), 1e-3, eps=1e-8, weight_decay=1e-2)
        xd = x.to(dev, dtype).contiguous(memory_format=torch.channels_last)
        xd.requires_grad_()
        out = block(xd)
        (out.float() * ct.to(dev)).sum().backward()
        res = {"y": out.detach().cpu(), "dx": xd.grad.cpu()}
        res.update({f"grad/{k}": p.grad.cpu() for k, p in block.named_parameters()})
        res.update({f"stat/{k}": b.cpu() for k, b in block.named_buffers()})
        if card_grads is None:
            card_grads = {k: p.grad.cpu() for k, p in block.named_parameters()}
        else:  # the optimizer alone: the CPU steps on the card's gradients
            for k, p in block.named_parameters():
                p.grad = card_grads[k].clone()
        opt.step()
        res.update({f"param/{k}": p.detach().cpu() for k, p in block.named_parameters()})
        runs[key] = res
    card, cpu16, cpu32 = runs["card"], runs["cpu16"], runs["cpu32"]
    errs = {k: (rel_err(card[k], v), norm_err(card[k], v)) for k, v in cpu16.items()}
    bf16_vs_fp32 = {"dx": norm_err(cpu16["dx"], cpu32["dx"]),
                    "grad": max(norm_err(cpu16[k], v) for k, v in cpu32.items()
                                if k.startswith("grad/"))}
    return errs, bf16_vs_fp32


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
    emit({"phase": "build", "seconds": secs, "sources": list(build.SOURCES)})

    # 3. kernels against their plain versions
    rows = kernel_phase(fs)

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
          "distinct_unit_shapes": len(set(units["fwd"])), "worst_rel_to_max": worst,
          "tolerance": {"y": 2e-2, "dx": 2e-2, "d_dw": 1e-3, "d_pw": 1e-3},
          "loss": float(metrics["loss"])})

    # 5. the slice: full-width training steps through the kernels
    watched = {k: p.detach().clone() for k, p in model.named_parameters()
               if k.endswith(("block4.sepconv1.depthwise.weight", "block4.sepconv1.pointwise.weight",
                              "conv5.pointwise.weight", "last_deconv.weight"))}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fs.reset_launches()
    losses = []
    for _ in range(WARMUP_STEPS):
        state, metrics = step_fn(state, x, y)
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        state, metrics = step_fn(state, x, y)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(fs.LAUNCHES)
    losses.append(float(metrics["loss"]))
    iou = float(metrics["iou"])
    steps = WARMUP_STEPS + TIMED_STEPS
    check(all(math.isfinite(v) for v in losses), f"non-finite loss: {losses}")
    for k, v in launches.items():
        check(v == UNITS_PER_STEP * steps,
              f"{k} launched {v} times in {steps} steps, want {UNITS_PER_STEP} per step")
    changed = {k: not torch.equal(v, dict(model.named_parameters())[k].detach())
               for k, v in watched.items()}
    check(all(changed.values()), f"parameters not updated: {changed}")
    emit({"phase": "slice", "batch": batch, "input": [batch, 768, 1152, 16],
          "steps": {"warmup": WARMUP_STEPS, "timed": TIMED_STEPS},
          "ms_per_step": dt / TIMED_STEPS * 1e3, "samples_per_s": batch * TIMED_STEPS / dt,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "loss_first": losses[0], "loss_last": losses[-1], "iou_last": iou,
          "launches": launches, "launches_per_step": {k: v / steps for k, v in launches.items()},
          "device": kind, "nvidia_smi": smi})
    del model, opt, state, step_fn, x, y, watched
    torch.cuda.empty_cache()

    # 6. one train-mode block and an AdamW step: card (bf16) against CPU (bf16)
    errs, bf16_vs_fp32 = block_parity(XceptionBlock, build_optimizer)
    emit({"phase": "block", "input": [2, 48, 72, 728], "errors_max_norm": errs,
          "tolerance": BLOCK_TOL, "cpu_bf16_vs_fp32_norm": bf16_vs_fp32})
    for k, (emax, enorm) in errs.items():
        tmax, tnorm = BLOCK_TOL[k.split("/")[0]]
        check(emax <= tmax and enorm <= tnorm, f"block {k}: {emax}, {enorm} > {tmax}, {tnorm}")

    # 7. the whole model, eval mode: card against the CPU's bf16 and fp32 runs
    par = model_parity(DeepLabv3plus, weighted_ce_loss, class_weights)
    emit({"phase": "parity", "input": [2, 64, 96, 16], "mode": "eval", **par,
          "tolerance": {"bf16": PARITY_TOL, "fp32": FP32_TOL}})
    for ref, tols in (("bf16", PARITY_TOL), ("fp32", FP32_TOL)):
        for k, tol in tols.items():
            check(par[ref][k] <= tol, f"card vs CPU {ref}: {k} {par[ref][k]} > {tol}")

    kernels = []
    for kname, fname, line in (("sepconv_fwd", "sepconv_fwd.cu", 343),
                               ("sepconv_bwd", "sepconv_bwd.cu", 510)):
        head = next(r for r in rows[kname] if r["shape"] == HEADLINE)
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"deepcam_tpu_torch/ops/csrc/{fname}",
            "replaces": f"deepcam_tpu/ops/pallas/fused_sepconv.py:{line}",
            "launches": launches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in rows[kname]),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": HEADLINE, "at_shapes": rows[kname]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
