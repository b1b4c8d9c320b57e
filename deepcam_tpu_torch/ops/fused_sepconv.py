"""Fused [ReLU →] depthwise 3×3 → pointwise 1×1 unit, forward and backward.

Counterpart of ``deepcam_tpu/ops/pallas/fused_sepconv.py`` in its base form
(``fused_sepconv``: no folded BN affine, no residual operand, no emitted
statistics; the forward emits the depthwise output for the backward).  Every
stride-1 separable conv of the Xception trunk runs through it: 60 units per
training step.

Two versions of each direction live here:

* the CUDA kernels of ``csrc/sepconv_fwd.cu`` and ``csrc/sepconv_bwd.cu``
  (Hopper, ``sm_90a``, built by ``ops/build.py`` at first use), which run for
  tensors on the card;
* a plain PyTorch version with the same arithmetic, which runs for tensors on
  the CPU (the tests) and is what ``chip_smoke.py`` holds the kernels to.

The arithmetic of both: bf16 operands are upcast to fp32 before every
product; the depthwise sum is fp32 in tap order and rounded once to the
input type (d); the pointwise product accumulates in fp32 and rounds to the
input type; the backward keeps dd = g·pwᵀ in fp32 and returns d_dw and d_pw
as fp32 sums.  The ReLU mask of the backward compares x in fp32.

Layout is the JAX package's: x (N, H, W, C), dwk (3, 3, C), pwk (C, F),
y (N, H, W, F).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .build import library

# Launches of each kernel wrapper since the last reset.  A wrapper adds one
# where it launches its kernel(s), nowhere else.
LAUNCHES = {"sepconv_fwd": 0, "sepconv_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _taps(t, d):
    """The 9 zero-edged taps of ``t`` (N, H, W, C) at dilation ``d``, in
    order (i, j): tap[i, j][n, r, w] = t[n, r + (i-1)d, w + (j-1)d]."""
    h, w = t.shape[1], t.shape[2]
    tp = F.pad(t, (0, 0, d, d, d, d))
    return [[tp[:, i * d:i * d + h, j * d:j * d + w, :] for j in range(3)]
            for i in range(3)]


def _depthwise32(t32, k32, d, flip=False):
    """Σ_ij tap(t)[i, j] · k[i, j] in fp32, in tap order; ``flip`` takes
    k[2-i, 2-j] instead (the depthwise dgrad)."""
    acc = None
    taps = _taps(t32, d)
    for i in range(3):
        for j in range(3):
            term = taps[i][j] * (k32[2 - i, 2 - j] if flip else k32[i, j])
            acc = term if acc is None else acc + term
    return acc


def sepconv_fwd_plain(x, dwk, pwk, pre_relu: bool, dilation: int):
    """Returns (y, d): y (N, H, W, F) and the rounded depthwise output d
    (N, H, W, C), both in x.dtype."""
    h = torch.clamp_min(x, 0) if pre_relu else x
    d = _depthwise32(h.float(), dwk.float(), dilation).to(x.dtype)
    y = torch.matmul(d.float(), pwk.float()).to(x.dtype)
    return y, d


def sepconv_bwd_plain(x, g, dwk, pwk, d, pre_relu: bool, dilation: int):
    """Returns (dx in x.dtype, d_dw (3, 3, C) fp32, d_pw (C, F) fp32)."""
    c = x.shape[-1]
    g32 = g.float()
    dd = torch.matmul(g32, pwk.float().t())
    dh = _depthwise32(dd, dwk.float(), dilation, flip=True)
    if pre_relu:
        dh = torch.where(x.float() > 0, dh, torch.zeros((), device=dh.device))
    h32 = (torch.clamp_min(x, 0) if pre_relu else x).float()
    htaps = _taps(h32, dilation)
    ddw = torch.stack([torch.stack([(htaps[i][j] * dd).sum((0, 1, 2))
                                    for j in range(3)]) for i in range(3)])
    dpw = torch.matmul(d.reshape(-1, c).float().t(), g32.reshape(-1, g.shape[-1]))
    return dh.to(x.dtype), ddw, dpw


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _fwd_lib():
    lib = library("sepconv_fwd")
    fn = lib.sepconv_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 7 + [_P]
        fn.restype = _I
    return fn


def _bwd_lib():
    lib = library("sepconv_bwd")
    fn = lib.sepconv_bwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 11 + [_I] * 9 + [ctypes.c_long, _P]
        fn.restype = _I
    return fn


def _check(name, t, shape, dtype=torch.bfloat16):
    if t.device.type != "cuda" or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want a {dtype} CUDA tensor of shape "
                         f"{tuple(shape)}, got {t.dtype} {t.device} {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def _check_unit(x, dwk, pwk, dilation):
    n, h, w, c = x.shape
    f = pwk.shape[-1]
    if c % 8 or f % 8:
        raise ValueError(f"sepconv kernels need C and F divisible by 8, got {c}, {f}")
    if dilation < 1:
        raise ValueError(f"dilation must be >= 1, got {dilation}")
    _check("x", x, (n, h, w, c))
    _check("dwk", dwk, (3, 3, c))
    _check("pwk", pwk, (c, f))
    if x.device != dwk.device or x.device != pwk.device:
        raise ValueError("x, dwk and pwk must be on one device")
    return n, h, w, c, f


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def sepconv_fwd(x, dwk, pwk, pre_relu: bool, dilation: int, emit_d: bool):
    """The forward kernel on bf16 CUDA tensors.  Returns (y, d or None)."""
    n, h, w, c, f = _check_unit(x, dwk, pwk, dilation)
    y = torch.empty((n, h, w, f), dtype=x.dtype, device=x.device)
    d = torch.empty_like(x) if emit_d else None
    rc = _fwd_lib()(x.data_ptr(), dwk.data_ptr(), pwk.data_ptr(), y.data_ptr(),
                    d.data_ptr() if emit_d else None,
                    n, h, w, c, f, dilation, int(pre_relu), _stream(x))
    if rc:
        raise RuntimeError(f"sepconv_fwd launch failed: CUDA error {rc}")
    LAUNCHES["sepconv_fwd"] += 1
    return y, d


# blocks per SM the backward aims for when it splits a reduction
_BLOCKS_PER_SM = 4
_PARTIAL_CAP = 64 << 20


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def bwd_plan(p: int, c: int, f: int, sms: int):
    """Work split of the backward for p pixels, C→F on a card with ``sms``
    SMs: (pixels per dx/d_dw block, d_pw slices, pixels per slice).  Keeps
    the d_pw partials under 64 MB and gives the card about four blocks per
    SM where the shape allows it."""
    target = _BLOCKS_PER_SM * sms
    ctiles = -(-c // 64)
    ppb = max(256, -(-p * ctiles // target) // 32 * 32)
    tiles = ctiles * -(-f // 128)
    splits = max(1, min(-(-target // tiles), -(-p // 32),
                        _PARTIAL_CAP // (c * f * 4)))
    chunk = -(-p // splits // 32) * 32
    splits = -(-p // chunk)
    return ppb, splits, chunk


def sepconv_bwd(x, g, dwk, pwk, d, pre_relu: bool, dilation: int):
    """The backward kernels on bf16 CUDA tensors.  Returns (dx, d_dw fp32,
    d_pw fp32)."""
    n, h, w, c, f = _check_unit(x, dwk, pwk, dilation)
    _check("g", g, (n, h, w, f))
    _check("d", d, (n, h, w, c))
    p = n * h * w
    ppb, splits, chunk = bwd_plan(p, c, f, _sm_count(x.device.index))
    nblk = -(-p // ppb)
    dev = x.device
    dx = torch.empty_like(x)
    ddw = torch.empty((3, 3, c), dtype=torch.float32, device=dev)
    dpw = torch.empty((c, f), dtype=torch.float32, device=dev)
    dd = torch.empty((p, c), dtype=torch.float32, device=dev)
    ddw_part = torch.empty((nblk, 9, c), dtype=torch.float32, device=dev)
    dpw_part = torch.empty((splits, c, f), dtype=torch.float32, device=dev)
    rc = _bwd_lib()(x.data_ptr(), g.data_ptr(), dwk.data_ptr(), pwk.data_ptr(),
                    d.data_ptr(), dx.data_ptr(), ddw.data_ptr(), dpw.data_ptr(),
                    dd.data_ptr(), ddw_part.data_ptr(), dpw_part.data_ptr(),
                    n, h, w, c, f, dilation, int(pre_relu), ppb, splits, chunk,
                    _stream(x))
    if rc:
        raise RuntimeError(f"sepconv_bwd launch failed: CUDA error {rc}")
    LAUNCHES["sepconv_bwd"] += 1
    return dx, ddw, dpw


# ---------------------------------------------------------------------------
# autograd entry point
# ---------------------------------------------------------------------------

def _device_kind(x):
    kind = x.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"fused_sepconv runs on cuda or cpu, got {x.device}")
    return kind


class _FusedSepconv(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dwk, pwk, pre_relu, dilation):
        emit_d = any(ctx.needs_input_grad[:3])
        if _device_kind(x) == "cuda":
            y, d = sepconv_fwd(x, dwk, pwk, pre_relu, dilation, emit_d)
        else:
            y, d = sepconv_fwd_plain(x, dwk, pwk, pre_relu, dilation)
        ctx.pre_relu, ctx.dilation = pre_relu, dilation
        ctx.save_for_backward(x, dwk, pwk, d if emit_d else None)
        return y

    @staticmethod
    def backward(ctx, g):
        x, dwk, pwk, d = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        if _device_kind(x) == "cuda":
            dx, ddw, dpw = sepconv_bwd(x, g, dwk, pwk, d, ctx.pre_relu, ctx.dilation)
        else:
            dx, ddw, dpw = sepconv_bwd_plain(x, g, dwk, pwk, d, ctx.pre_relu,
                                             ctx.dilation)
        return dx, ddw.to(dwk.dtype), dpw.to(pwk.dtype), None, None


def fused_sepconv(x, dwk, pwk, pre_relu: bool = True, dilation: int = 1):
    """[relu →] depthwise3x3('same', dilation) → pointwise, as one kernel on
    the card.  x: (N, H, W, C); dwk: (3, 3, C); pwk: (C, F).  Returns
    (N, H, W, F) in x.dtype; differentiable in x, dwk and pwk."""
    return _FusedSepconv.apply(x.contiguous(), dwk.contiguous(), pwk.contiguous(),
                               bool(pre_relu), int(dilation))
