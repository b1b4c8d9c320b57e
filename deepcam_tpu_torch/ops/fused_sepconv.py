"""Fused [BN-apply →] [+skip →] [ReLU →] depthwise 3×3 → pointwise 1×1
unit, forward and backward.

Counterpart of ``deepcam_tpu/ops/pallas/fused_sepconv.py`` in all its forms,
under the JAX entry points' names, argument orders and outputs:

==================================  =====================================  ==============
entry point                         computes                               returns
==================================  =====================================  ==============
``fused_sepconv``                   [relu](x) → dw → pw                    y
``fused_sepconv_affine``            [relu](x·a + b) → dw → pw              y
``fused_sepconv_stats``             as ``fused_sepconv``                   y, Σy, Σy²
``fused_sepconv_affine_stats``      as ``fused_sepconv_affine``            y, Σy, Σy²
``fused_sepconv_boundary``          r = relu(x·a + b + skip) → dw → pw     y, r
``fused_sepconv_boundary_stats``    as ``fused_sepconv_boundary``          y, r, Σy, Σy²
==================================  =====================================  ==============

The affine is the folded apply of the preceding BatchNorm (a, b per-channel,
in x.dtype); the statistics are per-channel fp32 sums of the rounded y for
the following BatchNorm; the boundary form is the middle-flow block boundary
(chain-final BN apply, residual add, next block's ReLU), whose r is the next
residual stream.  Every stride-1 separable conv of the Xception trunk runs
through one of them: 60 units per training step.

Two versions of each direction live here:

* the CUDA kernels of ``csrc/sepconv_fwd.cu`` and ``csrc/sepconv_bwd.cu``
  (Hopper, ``sm_90a``, built by ``ops/build.py`` at first use), which run for
  tensors on the card, every form in one kernel pair;
* a plain PyTorch version with the same arithmetic, which runs for tensors on
  the CPU (the tests) and is what ``chip_smoke.py`` holds the kernels to.

The arithmetic of both: the affine is the bf16 product rounded, then the bf16
sum rounded (``x*a + b`` as PyTorch computes it in x.dtype), the residual add
is rounded too, and the 'same' border of the depthwise is zero after them;
bf16 operands are upcast to fp32 before every product; the depthwise sum is
fp32 in tap order and rounded once to the input type (d); the pointwise
product accumulates in fp32 and rounds to the input type; Σy and Σy² are
fp32 sums of the rounded y.  The backward folds the statistics cotangent into
g as ``bf16(g + (gs1 + 2·y·gs2))``, adds r's outside cotangent before the
ReLU mask, compares u in fp32 for the mask, keeps dd = g·pwᵀ in fp32 and
returns d_dw, d_pw, da and db as fp32 sums; the kernel accumulates d_pw on
the tensor cores in runs of 512 pixels, the runs added in fp32.

Layout is the JAX package's: x, skip, r (N, H, W, C), dwk (3, 3, C),
pwk (C, F), a, b (C,), y (N, H, W, F), Σy and Σy² (F,).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .build import launch, library

# Launches of each kernel wrapper since the last reset.  A wrapper adds one
# where it launches its kernel(s), nowhere else.
LAUNCHES = {"sepconv_fwd": 0, "sepconv_bwd": 0}
# Launches of each kernel wrapper by form (the entry point's name without
# ``fused_sepconv_``; ``base`` for ``fused_sepconv``), counted in the same
# place.
FORMS = ("base", "affine", "stats", "affine_stats", "boundary", "boundary_stats")
FORM_LAUNCHES = {k: dict.fromkeys(FORMS, 0) for k in LAUNCHES}


# Work counters (``profiling/profiler.py:cost_analysis``) while a count
# runs: each unit calls the last one's ``enter()`` before its kernel (or
# plain version) and ``exit(token, form, p, c, f, backward)`` after it.
# Empty otherwise, so a launch pays one list test.
UNIT_COUNTERS: list = []


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        FORM_LAUNCHES[k].update(dict.fromkeys(FORMS, 0))


def form_name(affine: bool, skip: bool, stats: bool) -> str:
    """The form of a unit with these operands and outputs."""
    name = "boundary" if skip else ("affine" if affine else "")
    if stats:
        name = f"{name}_stats" if name else "stats"
    return name or "base"


class FwdOut(NamedTuple):
    y: torch.Tensor
    d: Optional[torch.Tensor]      # the rounded depthwise output, when emitted
    r: Optional[torch.Tensor]      # relu(x·a + b + skip), with skip
    stats: Optional[torch.Tensor]  # (2, F) fp32: Σy, Σy²


class BwdOut(NamedTuple):
    dx: torch.Tensor
    ddw: torch.Tensor              # (3, 3, C) fp32
    dpw: torch.Tensor              # (C, F) fp32
    da: Optional[torch.Tensor]     # (C,) fp32, with the affine
    db: Optional[torch.Tensor]
    dskip: Optional[torch.Tensor]  # in x.dtype, with skip


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


def _prologue(x, a, b, skip):
    """u = x·a + b [+ skip] in x.dtype (each op rounded), or x."""
    u = x if a is None else x * a + b
    return u if skip is None else u + skip


def sepconv_fwd_plain(x, dwk, pwk, pre_relu: bool, dilation: int, *, a=None, b=None,
                      skip=None, emit_stats: bool = False) -> FwdOut:
    """All outputs of the forward kernel; d always, r with ``skip``, the
    statistics with ``emit_stats``."""
    u = _prologue(x, a, b, skip)
    h = torch.clamp_min(u, 0) if pre_relu else u
    d = _depthwise32(h.float(), dwk.float(), dilation).to(x.dtype)
    y = torch.matmul(d.float(), pwk.float()).to(x.dtype)
    stats = None
    if emit_stats:
        y32 = y.float()
        stats = torch.stack([y32.sum((0, 1, 2)), (y32 * y32).sum((0, 1, 2))])
    return FwdOut(y, d, h if skip is not None else None, stats)


def sepconv_bwd_plain(x, g, dwk, pwk, d, pre_relu: bool, dilation: int, *, a=None,
                      b=None, skip=None, gr=None, y=None, gs1=None, gs2=None) -> BwdOut:
    """All outputs of the backward kernels.  ``gr`` (with ``skip``) is the
    cotangent of r; ``y``, ``gs1`` and ``gs2`` the statistics cotangent."""
    c = x.shape[-1]
    if y is not None:  # the cotangents of Σy and Σy² folded into y's
        g = (g.float() + (gs1 + 2.0 * y.float() * gs2)).to(g.dtype)
    g32 = g.float()
    dd = torch.matmul(g32, pwk.float().t())
    dh = _depthwise32(dd, dwk.float(), dilation, flip=True)
    if gr is not None:
        dh = dh + gr.float()
    u = _prologue(x, a, b, skip)
    if pre_relu:
        dh = torch.where(u.float() > 0, dh, torch.zeros((), device=dh.device))
    dskip = dh.to(x.dtype) if skip is not None else None
    da = db = None
    if a is not None:
        da = (dh * x.float()).sum((0, 1, 2))
        db = dh.sum((0, 1, 2))
        dh = dh * a.float()
    h32 = (torch.clamp_min(u, 0) if pre_relu else u).float()
    htaps = _taps(h32, dilation)
    ddw = torch.stack([torch.stack([(htaps[i][j] * dd).sum((0, 1, 2))
                                    for j in range(3)]) for i in range(3)])
    dpw = torch.matmul(d.reshape(-1, c).float().t(), g32.reshape(-1, g.shape[-1]))
    return BwdOut(dh.to(x.dtype), ddw, dpw, da, db, dskip)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
# As in csrc/tile_mma.cuh: the 64 x 64 bf16 operand box (8 KB) in which the
# GEMM kernels tile rows and K, the 1024-byte alignment of the swizzled
# boxes, the shared memory a block may use (alone on an SM, or one of two),
# and the partials added per first reduction pass.
_BOX = 64
_BOX_BYTES = _BOX * _BOX * 2
_SMEM_ALIGN = 1024
SMEM_ONE_BLOCK = 232_448
SMEM_TWO_BLOCKS = 233_472 // 2 - 1024
_RED_CHUNK = 256
# forward: output channels per F tile, side of a staged pixel tile, ring
# stages at most, barrier bytes per stage; the statistics partials of an
# unstaged pixel tile (one per consumer warp of a warpgroup, 16 rows each;
# a staged tile adds them in shared memory and writes one)
FWD_BN = 128
FWD_TILE = 8
_FWD_MAX_STAGES = 8
_BAR_BYTES = 16
_STAT_ROWS = 4


# forward launch modes (FwdMode in csrc/sepconv_fwd.cu)
UNSTAGED, STAGED_1, STAGED_2, PRELOADED_2 = range(4)


class FwdPlan(NamedTuple):
    bm: int              # pixels per block (GEMM rows)
    bn: int              # output channels per F tile
    k_pad: int           # C rounded up to wgmma's depth (16); zeros past C
    mode: int            # UNSTAGED, or 8 x 8 pixel tiles with h staged in shared
                         # memory: STAGED_1, STAGED_2 or PRELOADED_2
    stages: int          # TMA ring stages of pw (preloaded: one per box)
    blocks_per_sm: int
    smem_bytes: int      # dynamic shared memory of a block
    tiles: int           # pixel tiles (blocks)
    waves: float         # tiles over (SMs x blocks per SM)


def fwd_halo_bytes(dilation: int) -> int:
    """The staged block's buffer, in whole KB: h of the 8 x 8 tile with its
    halo for one 64-channel chunk, later the two warpgroups' y tiles (64 x
    72 bf16 each), whichever is larger (as ``fwd_halo_bytes`` in
    csrc/sepconv_fwd.cu)."""
    hw = FWD_TILE + 2 * dilation
    return -(-max(hw * hw * 128, 2 * _BOX * (_BOX + 8) * 2) // _SMEM_ALIGN) * _SMEM_ALIGN


def fwd_smem_bytes(c: int, dilation: int, staged: bool, stages: int) -> int:
    """Shared memory of one forward block: the resident d tile (ceil(C/64)
    boxes), the halo buffer when staged, ``stages`` ring stages of two pw
    boxes with their barriers, and the alignment slack (as
    ``fwd_smem_bytes`` in csrc/sepconv_fwd.cu)."""
    return (_SMEM_ALIGN + -(-c // _BOX) * _BOX_BYTES
            + (fwd_halo_bytes(dilation) if staged else 0)
            + stages * (2 * _BOX_BYTES + _BAR_BYTES))


@functools.lru_cache(maxsize=None)
def fwd_plan(n: int, h: int, w: int, c: int, f: int, dilation: int, sms: int) -> FwdPlan:
    """Launch plan of the forward for (n, h, w) pixels, C→F on ``sms`` SMs.
    8 x 8 pixel tiles with h staged in shared memory where the d tile, the
    halo buffer and two ring stages fit one block, else 64 pixels in a row
    with the taps read from L1/L2 (C = 1536 at dilation 2).  Staged tiles
    run two blocks per SM where three ring stages still fit half an SM's
    shared memory: with every pw box loaded at the start where they all fit
    (no producer warp), else through a ring; otherwise one block per SM.  A
    ring has as many stages (at most 8) as fit, at least two."""
    per_stage = 2 * _BOX_BYTES + _BAR_BYTES
    staged = fwd_smem_bytes(c, dilation, True, 2) <= SMEM_ONE_BLOCK
    base = fwd_smem_bytes(c, dilation, staged, 0)
    boxes = -(-c // _BOX) * -(-f // FWD_BN)
    if staged and base + 3 * per_stage <= SMEM_TWO_BLOCKS:
        blocks = 2
        if boxes <= _FWD_MAX_STAGES and base + boxes * per_stage <= SMEM_TWO_BLOCKS:
            mode, stages = PRELOADED_2, boxes
        else:
            mode, stages = STAGED_2, min(_FWD_MAX_STAGES, (SMEM_TWO_BLOCKS - base) // per_stage)
    else:
        blocks, mode = 1, (STAGED_1 if staged else UNSTAGED)
        stages = min(_FWD_MAX_STAGES, (SMEM_ONE_BLOCK - base) // per_stage)
        if stages < 2:
            raise ValueError(f"sepconv forward: C = {c} leaves no room for two stages")
    tiles = (n * -(-h // FWD_TILE) * -(-w // FWD_TILE) if staged
             else -(-(n * h * w) // _BOX))
    return FwdPlan(_BOX, FWD_BN, -(-c // 16) * 16, mode, stages, blocks,
                   fwd_smem_bytes(c, dilation, staged, stages), tiles,
                   tiles / (sms * blocks))


def _fwd_lib():
    lib = library("sepconv_fwd")
    fn = lib.sepconv_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 12 + [_I] * 10 + [_P]
        fn.restype = _I
    return fn


def map_encode_us(t: torch.Tensor, reps: int = 1000) -> float:
    """Host microseconds to encode one TMA tensor map (over ``t``'s memory,
    at least 8 MB on the card), averaged over ``reps``."""
    fn = library("sepconv_fwd").box_map_encode_us
    fn.argtypes, fn.restype = [_P, _I], ctypes.c_double
    us = fn(t.data_ptr(), reps)
    if us < 0:
        raise RuntimeError("cuTensorMapEncodeTiled failed")
    return us


def _bwd_lib():
    lib = library("sepconv_bwd")
    fn = lib.sepconv_bwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 19 + [_I] * 11 + [ctypes.c_long, _P]
        fn.restype = _I
    return fn


def _check(name, t, shape, dtype=torch.bfloat16, device=None):
    if not t.is_cuda or t.dtype != dtype or t.shape != shape:
        raise ValueError(f"{name}: want a {dtype} CUDA tensor of shape "
                         f"{tuple(shape)}, got {t.dtype} {t.device} {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, want {device} (x's device)")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def _check_unit(x, dwk, pwk, dilation, pre_relu, a, b, skip):
    n, h, w, c = x.shape
    f = pwk.shape[-1]
    if c % 8 or f % 8:
        raise ValueError(f"sepconv kernels need C and F divisible by 8, got {c}, {f}")
    if dilation < 1:
        raise ValueError(f"dilation must be >= 1, got {dilation}")
    _check("x", x, (n, h, w, c))
    _check("dwk", dwk, (3, 3, c), device=x.device)
    _check("pwk", pwk, (c, f), device=x.device)
    if (a is None) != (b is None):
        raise ValueError("the affine needs both a and b")
    if a is not None:
        _check("a", a, (c,), device=x.device)
        _check("b", b, (c,), device=x.device)
    if skip is not None:
        if a is None or not pre_relu:
            raise ValueError("skip (the block boundary) needs the affine and pre_relu")
        _check("skip", skip, (n, h, w, c), device=x.device)
    return n, h, w, c, f


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _ptr(t):
    return None if t is None else t.data_ptr()


def sepconv_fwd(x, dwk, pwk, pre_relu: bool, dilation: int, emit_d: bool, *, a=None,
                b=None, skip=None, emit_stats: bool = False) -> FwdOut:
    """The forward kernel on bf16 CUDA tensors, any form: ``a``, ``b`` (C,)
    fold the preceding BN apply, ``skip`` (needs them and ``pre_relu``) makes
    the boundary form, ``emit_stats`` adds (Σy, Σy²)."""
    n, h, w, c, f = _check_unit(x, dwk, pwk, dilation, pre_relu, a, b, skip)
    dev = x.device
    y = torch.empty((n, h, w, f), dtype=x.dtype, device=dev)
    d = torch.empty_like(x) if emit_d else None
    r = torch.empty_like(x) if skip is not None else None
    plan = fwd_plan(n, h, w, c, f, dilation, _sm_count(dev.index))
    spart = sscratch = stats = None
    if emit_stats:  # the partials and their scratch in one buffer
        nparts = (_STAT_ROWS if plan.mode == UNSTAGED else 1) * plan.tiles
        nscratch = -(-nparts // _RED_CHUNK) if nparts > _RED_CHUNK else 0
        buf = torch.empty((nparts + nscratch, 2, f), dtype=torch.float32, device=dev)
        spart, sscratch = buf[:nparts], (buf[nparts:] if nscratch else None)
        stats = torch.empty((2, f), dtype=torch.float32, device=dev)
    launch("sepconv_fwd", _fwd_lib(), dev, x.data_ptr(), dwk.data_ptr(), pwk.data_ptr(),
           _ptr(a), _ptr(b), _ptr(skip), y.data_ptr(), _ptr(d), _ptr(r), _ptr(spart),
           _ptr(sscratch), _ptr(stats), n, h, w, c, f, dilation, int(pre_relu), plan.tiles,
           plan.mode, plan.stages)
    LAUNCHES["sepconv_fwd"] += 1
    FORM_LAUNCHES["sepconv_fwd"][form_name(a is not None, skip is not None, emit_stats)] += 1
    return FwdOut(y, d, r, stats)


# blocks per SM the d_pw split aims for, and the cap on its partials
_BLOCKS_PER_SM = 4
_PARTIAL_CAP = 64 << 20
# dx/d_dw: spatial tile (rows x columns), channels per block, most partials
DX_TILE = (8, 18)
_DX_CT = 32
_DX_MAX_PARTS = 256


class BwdPlan(NamedTuple):
    dx_tiles: int        # spatial tiles per dx/d_dw block
    dx_blocks: int       # dx/d_dw blocks along the pixels (the d_dw partials)
    dx_smem: int         # its dynamic shared memory
    dd_stages: int       # ring stages of the dd GEMM
    dd_smem: int
    dpw_stages: int      # ring stages of the d_pw GEMM
    dpw_smem: int
    splits: int          # d_pw pixel slices (its partials)
    chunk: int           # pixels per slice, a multiple of 64


def gemm_smem_bytes(stages: int, boxes: int) -> int:
    """Shared memory of a backward GEMM block: ``stages`` ring stages of
    ``boxes`` 8 KB boxes with their barriers, and the alignment slack (as
    ``gemm_smem_bytes`` in csrc/sepconv_bwd.cu)."""
    return _SMEM_ALIGN + stages * (boxes * _BOX_BYTES + _BAR_BYTES)


def dx_smem_bytes(dilation: int) -> int:
    """The dx/d_dw tile with its halo: dd fp32, x and u bf16, per channel."""
    th, tw = DX_TILE
    return (th + 2 * dilation) * (tw + 2 * dilation) * _DX_CT * (4 + 2 + 2)


@functools.lru_cache(maxsize=None)
def bwd_plan(n: int, h: int, w: int, c: int, f: int, dilation: int, fold: bool,
             sms: int) -> BwdPlan:
    """Work split of the backward for (n, h, w) pixels, C→F, on a card with
    ``sms`` SMs; ``fold``: the statistics cotangent is folded (the GEMMs
    also load y).  The dx/d_dw blocks walk enough tiles to keep at most 256
    d_dw partials; the GEMM rings leave room for two blocks per SM; d_pw
    splits the pixels in multiples of 64 until the card has about four
    blocks per SM, with its partials under 64 MB."""
    p = n * h * w
    th, tw = DX_TILE
    ntiles = n * -(-h // th) * -(-w // tw)
    dx_tiles = -(-ntiles // _DX_MAX_PARTS)
    dd_boxes, dpw_boxes = (4, 5) if fold else (3, 3)
    dd_stages, dpw_stages = (3, 2) if fold else (4, 4)
    tiles = -(-c // _BOX) * -(-f // FWD_BN)
    splits = max(1, min(-(-_BLOCKS_PER_SM * sms // tiles), -(-p // _BOX),
                        _PARTIAL_CAP // (c * f * 4)))
    chunk = -(-p // splits // _BOX) * _BOX
    return BwdPlan(dx_tiles, -(-ntiles // dx_tiles), dx_smem_bytes(dilation),
                   dd_stages, gemm_smem_bytes(dd_stages, dd_boxes),
                   dpw_stages, gemm_smem_bytes(dpw_stages, dpw_boxes),
                   -(-p // chunk), chunk)


def sepconv_bwd(x, g, dwk, pwk, d, pre_relu: bool, dilation: int, *, a=None, b=None,
                skip=None, gr=None, y=None, gs1=None, gs2=None) -> BwdOut:
    """The backward kernels on bf16 CUDA tensors, any form: ``a``, ``b`` as
    in the forward (adds da, db), ``skip`` with ``gr`` (r's cotangent, may be
    None; adds d_skip), ``y`` with ``gs1``, ``gs2`` ((F,) fp32 cotangents of
    Σy and Σy², folded into g)."""
    n, h, w, c, f = _check_unit(x, dwk, pwk, dilation, pre_relu, a, b, skip)
    dev = x.device
    _check("g", g, (n, h, w, f), device=dev)
    _check("d", d, (n, h, w, c), device=dev)
    if gr is not None:
        if skip is None:
            raise ValueError("gr is the cotangent of r: it needs skip")
        _check("gr", gr, (n, h, w, c), device=dev)
    if (y is None) != (gs1 is None) or (y is None) != (gs2 is None):
        raise ValueError("the statistics cotangent needs y, gs1 and gs2")
    if y is not None:
        _check("y", y, (n, h, w, f), device=dev)
        _check("gs1", gs1, (f,), torch.float32, device=dev)
        _check("gs2", gs2, (f,), torch.float32, device=dev)
    p = n * h * w
    plan = bwd_plan(n, h, w, c, f, dilation, y is not None, _sm_count(dev.index))
    rows = 11 if a is not None else 9
    dx = torch.empty_like(x)
    dskip = torch.empty_like(x) if skip is not None else None
    dwab = torch.empty((rows, c), dtype=torch.float32, device=dev)
    dpw = torch.empty((c, f), dtype=torch.float32, device=dev)
    # scratch in one buffer: dd, the d_dw partials, the d_pw partials (each
    # a multiple of 8 floats, so every part stays 16-byte aligned)
    sizes = (p * c, plan.dx_blocks * rows * c, plan.splits * c * f)
    scratch = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    dd, ddw_part, dpw_part = scratch.split(sizes)
    launch("sepconv_bwd", _bwd_lib(), dev, x.data_ptr(), g.data_ptr(), dwk.data_ptr(),
           pwk.data_ptr(), d.data_ptr(), _ptr(a), _ptr(b), _ptr(skip), _ptr(gr), _ptr(y),
           _ptr(gs1), _ptr(gs2), dx.data_ptr(), _ptr(dskip), dwab.data_ptr(),
           dpw.data_ptr(), dd.data_ptr(), ddw_part.data_ptr(), dpw_part.data_ptr(),
           n, h, w, c, f, dilation, int(pre_relu), plan.dx_tiles, plan.dd_stages,
           plan.dpw_stages, plan.splits, plan.chunk)
    LAUNCHES["sepconv_bwd"] += 1
    FORM_LAUNCHES["sepconv_bwd"][form_name(a is not None, skip is not None, y is not None)] += 1
    da, db = (dwab[9], dwab[10]) if a is not None else (None, None)
    return BwdOut(dx, dwab[:9].view(3, 3, c), dpw, da, db, dskip)


# ---------------------------------------------------------------------------
# autograd entry points
# ---------------------------------------------------------------------------

def _device_kind(x):
    kind = x.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"fused_sepconv runs on cuda or cpu, got {x.device}")
    return kind


def _unit_dims(x, pwk):
    """(P, C, F) of a unit: pixels, input and output channels."""
    return x.numel() // x.shape[-1], x.shape[-1], pwk.shape[-1]


class _FusedSepconv(torch.autograd.Function):
    """Every form: outputs (y[, r][, Σy, Σy²]); the backward receives their
    cotangents (None where an output is unused) and returns (dx, da, db,
    d_skip, d_dwk, d_pwk), each None where its input was."""

    @staticmethod
    def forward(ctx, x, a, b, skip, dwk, pwk, pre_relu, dilation, emit_stats):
        ctx.set_materialize_grads(False)
        emit_d = any(ctx.needs_input_grad[:6])
        kw = dict(a=a, b=b, skip=skip, emit_stats=emit_stats)
        counter = UNIT_COUNTERS[-1] if UNIT_COUNTERS else None
        token = counter.enter() if counter is not None else None
        if _device_kind(x) == "cuda":
            out = sepconv_fwd(x, dwk, pwk, pre_relu, dilation, emit_d, **kw)
        else:
            out = sepconv_fwd_plain(x, dwk, pwk, pre_relu, dilation, **kw)
        if counter is not None:
            form = form_name(a is not None, skip is not None, emit_stats)
            counter.exit(token, form, *_unit_dims(x, pwk), False)
        ctx.pre_relu, ctx.dilation, ctx.emit_stats = pre_relu, dilation, emit_stats
        if emit_d:
            ctx.save_for_backward(x, a, b, skip, dwk, pwk, out.d,
                                  out.y if emit_stats else None)
        outs = (out.y,) + ((out.r,) if skip is not None else ())
        if emit_stats:
            outs += (out.stats[0], out.stats[1])
        return outs

    @staticmethod
    def backward(ctx, gy, *rest):
        x, a, b, skip, dwk, pwk, d, y = ctx.saved_tensors
        gr = rest[0] if skip is not None else None
        gs1 = gs2 = None
        if ctx.emit_stats:
            gs1, gs2 = rest[-2:]
        shape_y = (*x.shape[:-1], pwk.shape[-1])
        gy = (x.new_zeros(shape_y) if gy is None else gy.to(x.dtype)).contiguous()
        if gr is not None:
            gr = gr.to(x.dtype).contiguous()
        if gs1 is None and gs2 is None:
            y = None
        else:
            gs1, gs2 = ((x.new_zeros(pwk.shape[-1], dtype=torch.float32) if t is None
                         else t.float().contiguous()) for t in (gs1, gs2))
        kw = dict(a=a, b=b, skip=skip, gr=gr, y=y, gs1=gs1, gs2=gs2)
        counter = UNIT_COUNTERS[-1] if UNIT_COUNTERS else None
        token = counter.enter() if counter is not None else None
        if _device_kind(x) == "cuda":
            out = sepconv_bwd(x, gy, dwk, pwk, d, ctx.pre_relu, ctx.dilation, **kw)
        else:
            out = sepconv_bwd_plain(x, gy, dwk, pwk, d, ctx.pre_relu, ctx.dilation, **kw)
        if counter is not None:
            form = form_name(a is not None, skip is not None, ctx.emit_stats)
            counter.exit(token, form, *_unit_dims(x, pwk), True)
        # da and db rounded to a's type, as the JAX VJP rounds them
        da = out.da.to(a.dtype) if a is not None else None
        db = out.db.to(b.dtype) if b is not None else None
        return (out.dx, da, db, out.dskip, out.ddw.to(dwk.dtype), out.dpw.to(pwk.dtype),
                None, None, None)


def _unit(x, a, b, skip, dwk, pwk, pre_relu, dilation, emit_stats):
    c = lambda t: None if t is None else t.contiguous()  # noqa: E731
    return _FusedSepconv.apply(c(x), c(a), c(b), c(skip), c(dwk), c(pwk), bool(pre_relu),
                               int(dilation), bool(emit_stats))


def fused_sepconv(x, dwk, pwk, pre_relu: bool = True, dilation: int = 1):
    """[relu →] depthwise3x3('same', dilation) → pointwise, as one kernel on
    the card.  x: (N, H, W, C); dwk: (3, 3, C); pwk: (C, F).  Returns
    (N, H, W, F) in x.dtype; differentiable in x, dwk and pwk."""
    return _unit(x, None, None, None, dwk, pwk, pre_relu, dilation, False)[0]


def fused_sepconv_affine(x, a, b, dwk, pwk, pre_relu: bool = True, dilation: int = 1):
    """``[relu(] x·a + b [)] → dw3x3 → pw``, with a, b (C,) the preceding
    BatchNorm's apply coefficients in x.dtype.  Returns y."""
    return _unit(x, a, b, None, dwk, pwk, pre_relu, dilation, False)[0]


def fused_sepconv_stats(x, dwk, pwk, pre_relu: bool = True, dilation: int = 1):
    """``fused_sepconv`` that also returns the per-channel fp32 sums of the
    rounded output: ``(y, Σy, Σy²)``."""
    return _unit(x, None, None, None, dwk, pwk, pre_relu, dilation, True)


def fused_sepconv_affine_stats(x, a, b, dwk, pwk, pre_relu: bool = True,
                               dilation: int = 1):
    """``fused_sepconv_affine`` that also returns ``(Σy, Σy²)``:
    ``(y, Σy, Σy²)``."""
    return _unit(x, a, b, None, dwk, pwk, pre_relu, dilation, True)


def fused_sepconv_boundary(x, a, b, skip, dwk, pwk, dilation: int = 1):
    """The block boundary: ``r = relu(x·a + b + skip)`` (the next residual
    stream) and ``y = pw(dw3x3(r))``.  Returns ``(y, r)``."""
    return _unit(x, a, b, skip, dwk, pwk, True, dilation, False)


def fused_sepconv_boundary_stats(x, a, b, skip, dwk, pwk, dilation: int = 1):
    """``fused_sepconv_boundary`` that also returns ``(Σy, Σy²)``:
    ``(y, r, Σy, Σy²)``."""
    return _unit(x, a, b, skip, dwk, pwk, True, dilation, True)
