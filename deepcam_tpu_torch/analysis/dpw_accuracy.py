"""How far the backward kernel's d_pw lies from an fp64 sum, and what the
backward costs, on the card.

d_pw = Σ_p d[p, c] · g'[p, f] sums over every pixel a unit sees, up to
4 x 96 x 144 at output stride 8.  Behind a train-mode BatchNorm, g' has
nearly zero mean over the pixels of each channel while d, after a ReLU,
does not, so the sum cancels and an accumulation error shows against the
small result.  At each shape below this builds such operands from a seed
(x and the weights as the units see them, g with each channel's mean over
the pixels taken out), runs the forward kernel for d and the backward
kernel for d_pw, and prints one JSON line per shape: the largest error of
the kernel's d_pw and of the plain version's (one fp32 matmul; TF32 off),
each against the fp64 sum of the same bf16 operands and relative to its
largest entry; the pixels per d_pw slice of the kernel's plan; and the
median time of the whole backward in the affine_stats form (the form of
most units of a train step), over single calls with the L2 cache flushed
before each.  To compare two checkouts on one card, run it in each, in
turns.

    python -m deepcam_tpu_torch.analysis.dpw_accuracy
"""

from __future__ import annotations

import json

import torch

# (N, H, W, C, F, dilation): the exit and middle units at output stride 16
# and 8, and the entry unit with the most pixels
SHAPES = [(4, 48, 72, 1536, 2048, 2), (4, 96, 144, 1536, 2048, 4),
          (4, 48, 72, 728, 728, 1), (4, 96, 144, 728, 728, 2), (4, 384, 576, 64, 128, 1)]
REPS = 50


def rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    return ((a.double() - ref).abs().max() / ref.abs().max()).item()


def median_ms(fn, flush) -> float:
    fn()
    times = []
    for _ in range(REPS):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[REPS // 2]


def measure(n, h, w, c, f, dilation, flush, seed=0) -> dict:
    from ..ops import fused_sepconv as fs

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return scale * torch.randn(*shape, generator=gen, device="cuda") + shift

    x = rnd(n, h, w, c, shift=0.5).bfloat16()
    dwk = rnd(3, 3, c, scale=1 / 3).bfloat16()
    pwk = rnd(c, f, scale=c ** -0.5).bfloat16()
    g = rnd(n, h, w, f)
    g = (g - g.mean((0, 1, 2))).bfloat16()
    d = fs.sepconv_fwd(x, dwk, pwk, True, dilation, True).d
    got = fs.sepconv_bwd(x, g, dwk, pwk, d, True, dilation).dpw
    plain = fs.sepconv_bwd_plain(x, g, dwk, pwk, d, True, dilation).dpw
    ref = torch.matmul(d.reshape(-1, c).double().t(), g.reshape(-1, f).double())
    plan = fs.bwd_plan(n, h, w, c, f, dilation, False, torch.cuda.get_device_properties(0)
                       .multi_processor_count)
    a, b = (1 + 0.2 * rnd(c)).bfloat16(), (0.1 * rnd(c)).bfloat16()
    y = fs.sepconv_fwd(x, dwk, pwk, True, dilation, False, a=a, b=b).y
    gs1, gs2 = 0.3 * rnd(f), 0.1 * rnd(f)
    bwd_ms = median_ms(lambda: fs.sepconv_bwd(x, g, dwk, pwk, d, True, dilation, a=a, b=b,
                                              y=y, gs1=gs1, gs2=gs2), flush)
    return {"shape": [n, h, w, c, f], "dilation": dilation, "pixels_per_slice": plan.chunk,
            "kernel": rel(got, ref), "plain": rel(plain, ref),
            "affine_stats_bwd_ms": bwd_ms}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("dpw_accuracy: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for shape in SHAPES:
        print(json.dumps({**measure(*shape, flush), "device": torch.cuda.get_device_name(0)}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
