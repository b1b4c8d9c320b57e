"""What the reference's ``quant`` hook applies to both operands of every
convolution and to the gradients that flow back to them: ``identity`` for
the reference itself, ``fp8_e4m3`` for the control (the same model computed
with fp8 operands, one step of precision below the configurations' bf16),
``bf16`` for the witness (the reference at the program's precision).  Every
family's ``forward`` takes them."""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per tensor (amax to 448)."""
    scale = FP8_MAX / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


class _Rounded(torch.autograd.Function):
    """An operand rounded to a lower precision, and the gradient that flows
    back to it rounded the same way."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """The control's rounding: fp8 e4m3, one scale per tensor, both ways."""
    return _Rounded.apply(x, _round_fp8)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """bf16 both ways: the program's precision put into the reference."""
    return _Rounded.apply(x, _round_bf16)


def identity(x: torch.Tensor) -> torch.Tensor:
    return x
