"""The least time of a fused sepconv unit on an H100 (copied from
``deepcam_tpu_torch/profiling/profiler.py:unit_counts`` and
``chip_smoke.py:bound``/``unit_bounds`` at commit 2718cf8, unchanged but
for the names).

Peaks: NVIDIA's data sheet, H100 SXM, dense, at the full 700 W power
limit: 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32 outside them,
3.35 TB/s of HBM.
"""

from __future__ import annotations

from typing import Dict, Tuple

PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_TENSOR = 989e12
PEAK_FP32 = 67e12


def unit_counts(form: str, p: int, c: int, f: int) -> Dict[str, float]:
    """Analytic work of one fused sepconv unit of this form on ``p`` pixels,
    C→F, bf16 activations: per direction, the GEMM FLOPs (the pointwise;
    the backward's dd and d_pw), the other FLOPs (the depthwise; the
    backward's dx and d_dw; the prologue and the statistics) and the bytes
    (each input read once, each output written once)."""
    affine = form not in ("base", "stats")
    skip, stats = form.startswith("boundary"), form.endswith("stats")
    act_c, act_f = 2 * p * c, 2 * p * f  # one bf16 tensor of width C, F
    weights = 2 * (9 * c + c * f) + (4 * c if affine else 0)  # dwk, pwk[, a, b]
    pro = p * c * ((2 if affine else 0) + (1 if skip else 0) + 1)  # FMA, add, relu
    # forward: x[, skip] -> y, d[, r][, Σy, Σy²]
    fwd_bytes = (act_c * (2 if skip else 1) + weights + act_f + act_c
                 + (act_c if skip else 0) + (8 * f if stats else 0))
    # backward: x, g, d[, skip, gr][, y, gs1, gs2] -> dx, d_dw, d_pw[, da, db][, d_skip]
    bwd_bytes = (act_c * 3 + act_f + weights + (2 * act_c if skip else 0)
                 + (act_f + 8 * f if stats else 0)
                 + 4 * (9 * c + c * f) + (8 * c if affine else 0) + (act_c if skip else 0))
    return {
        "fwd_gemm_flops": 2 * p * c * f,
        "fwd_other_flops": 2 * 9 * p * c + pro + (3 * p * f if stats else 0),
        "fwd_bytes": fwd_bytes,
        "bwd_gemm_flops": 4 * p * c * f,
        "bwd_other_flops": (4 * 9 * p * c + 2 * pro + (4 * p * f if stats else 0)
                            + (4 * p * c if affine else 0)),
        "bwd_bytes": bwd_bytes,
    }


def bound_s(nbytes: float, ops_by_peak) -> float:
    """Least time of the card for the work, in seconds: the larger of the
    byte time and the operation time (each type at its own peak)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = sum(n / peak for n, peak in ops_by_peak)
    return max(t_bytes, t_ops)


def unit_bounds(form: str, p: int, c: int, f: int) -> Tuple[float, float]:
    """(forward, backward) least seconds of one unit: the GEMMs on the bf16
    tensor cores and the rest in fp32."""
    w = unit_counts(form, p, c, f)
    return tuple(bound_s(w[f"{d}_bytes"], [(w[f"{d}_gemm_flops"], PEAK_BF16_TENSOR),
                                           (w[f"{d}_other_flops"], PEAK_FP32)])
                 for d in ("fwd", "bwd"))
