"""The port's CUDA kernel wrappers.  This file imports no JAX, so the
``gpu`` tests also run on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py

(``--noconftest`` because ``tests/conftest.py`` sets JAX up.)  Without a
card the ``gpu`` tests skip; the others check what the wrappers do on the
CPU: nothing is launched and nothing is computed there.
"""

import numpy as np
import pytest
import torch

from deepcam_tpu_torch.analysis import probe_element_window as pw
from deepcam_tpu_torch.ops import bn_glue as bg
from deepcam_tpu_torch.ops import bn_own as bo
from deepcam_tpu_torch.ops import fused_sepconv as fs


def _bf16(seed, *shape, scale=1.0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((scale * rng.randn(*shape)).astype(np.float32)).bfloat16()


def test_cpu_tensors_launch_no_kernel():
    fs.reset_launches()
    x = _bf16(0, 2, 12, 10, 24).requires_grad_()
    dwk = _bf16(1, 3, 3, 24, scale=0.3).requires_grad_()
    pwk = _bf16(2, 24, 16, scale=0.3).requires_grad_()
    a = (_bf16(6, 24, scale=0.2) + 1).requires_grad_()
    b = _bf16(7, 24, scale=0.1).requires_grad_()
    skip = _bf16(8, 2, 12, 10, 24).requires_grad_()
    outs = [fs.fused_sepconv(x, dwk, pwk, True, 1),
            fs.fused_sepconv_affine(x, a, b, dwk, pwk, False, 1),
            *fs.fused_sepconv_stats(x, dwk, pwk, True, 1),
            *fs.fused_sepconv_affine_stats(x, a, b, dwk, pwk, True, 1),
            *fs.fused_sepconv_boundary(x, a, b, skip, dwk, pwk, 1),
            *fs.fused_sepconv_boundary_stats(x, a, b, skip, dwk, pwk, 1)]
    sum(o.float().sum() for o in outs).backward()
    assert fs.LAUNCHES == {"sepconv_fwd": 0, "sepconv_bwd": 0}
    assert fs.FORM_LAUNCHES == {k: dict.fromkeys(fs.FORMS, 0) for k in fs.LAUNCHES}
    assert x.grad.shape == x.shape and dwk.grad.dtype == torch.bfloat16
    assert a.grad.dtype == b.grad.dtype == skip.grad.dtype == torch.bfloat16


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers check the device before anything is built or
    launched: a CPU tensor never reaches a kernel, and they never compute
    on the CPU themselves."""
    x, dwk, pwk = _bf16(3, 1, 8, 8, 8), _bf16(4, 3, 3, 8), _bf16(5, 8, 8)
    a = _bf16(6, 8)
    with pytest.raises(ValueError, match="CUDA"):
        fs.sepconv_fwd(x, dwk, pwk, True, 1, True)
    with pytest.raises(ValueError, match="CUDA"):
        fs.sepconv_fwd(x, dwk, pwk, True, 1, True, a=a, b=a, skip=x, emit_stats=True)
    with pytest.raises(ValueError, match="CUDA"):
        fs.sepconv_bwd(x, x, dwk, pwk, x, True, 1)
    with pytest.raises(ValueError, match="CUDA"):
        fs.sepconv_bwd(x, x, dwk, pwk, x, True, 1, a=a, b=a, skip=x, gr=x)


def test_form_names():
    assert [fs.form_name(aff, sk, st) for aff, sk, st in (
        (False, False, False), (True, False, False), (False, False, True),
        (True, False, True), (True, True, False), (True, True, True))] == list(fs.FORMS)


# Every fused unit shape of the full-resolution train step at batch 4
# (N, H, W, C, F, dilation): entry, middle, block20 and exit flows.
TRAIN_UNITS = [
    (4, 384, 576, 64, 128, 1), (4, 384, 576, 128, 128, 1),
    (4, 192, 288, 128, 256, 1), (4, 192, 288, 256, 256, 1),
    (4, 96, 144, 256, 728, 1), (4, 96, 144, 728, 728, 1),
    (4, 48, 72, 728, 728, 1), (4, 48, 72, 728, 1024, 1), (4, 48, 72, 1024, 1024, 1),
    (4, 48, 72, 1024, 1536, 2), (4, 48, 72, 1536, 1536, 2), (4, 48, 72, 1536, 2048, 2),
]
# the fused unit shapes that only the output-stride-8 model adds: the
# middle flow and block20's units at 96 x 144 and dilation 2, block20's
# sepconv_last there, exit conv3-5 at dilation 4 (block3's stride-1 tail
# runs at the entry shape 728→728 @ 96 x 144)
OS8_UNITS = [
    (4, 96, 144, 728, 728, 2), (4, 96, 144, 728, 1024, 2), (4, 96, 144, 1024, 1024, 1),
    (4, 96, 144, 1024, 1536, 4), (4, 96, 144, 1536, 1536, 4), (4, 96, 144, 1536, 2048, 4),
]
# ragged shapes: C, F off multiples of 16 or 64, P off a multiple of 64
RAGGED_UNITS = [(1, 9, 13, 24, 40, 1), (1, 7, 11, 728, 88, 1), (2, 5, 9, 40, 728, 2)]
# the H-shards of spatial sharding (parallel/spatial.py) at batch 2: each
# train unit on H/2 rows (S=2) and on H/4 (S=4), where the middle and exit
# flows run at 12 x 72, off the forward's 8 x 8 tile and the backward's
# 8 x 18 one
SPATIAL_UNITS = [(2, h // s, w, c, f, dil) for s in (2, 4)
                 for _, h, w, c, f, dil in TRAIN_UNITS]
# the shard shapes held on the card: the entry, middle, block20 and exit
# units at S=2 and S=4
SPATIAL_CARD_UNITS = [u for u in SPATIAL_UNITS if u[3:5] in
                      ((64, 128), (728, 728), (1024, 1024), (1536, 2048))]


@pytest.mark.parametrize("n,h,w,c,f,dil",
                         TRAIN_UNITS + OS8_UNITS + RAGGED_UNITS + SPATIAL_UNITS)
@pytest.mark.parametrize("sms", [132, 114])  # H100 SXM, H100 PCIe
def test_fwd_plan_fits(n, h, w, c, f, dil, sms):
    """The forward's plan: the resident d tile, the halo buffer (staged)
    and at least two ring stages fit one block's shared memory (half an
    SM's with two blocks per SM); K is C padded to wgmma's depth of 16; the
    pixel tiles cover every pixel."""
    p = n * h * w
    plan = fs.fwd_plan(n, h, w, c, f, dil, sms)
    limit = fs.SMEM_TWO_BLOCKS if plan.blocks_per_sm == 2 else fs.SMEM_ONE_BLOCK
    staged = plan.mode != fs.UNSTAGED
    assert plan.smem_bytes == fs.fwd_smem_bytes(c, dil, staged, plan.stages) <= limit
    boxes = -(-c // 64) * -(-f // 128)
    if plan.mode == fs.PRELOADED_2:  # a stage for every box of pw
        assert plan.stages == boxes <= 8
    else:
        assert 2 <= plan.stages <= 8
    assert plan.blocks_per_sm == (2 if plan.mode >= fs.STAGED_2 else 1)
    # the d tile holds whole 64-channel boxes: every K step of 16 it feeds
    # wgmma lies inside it, the channels from C up written as zeros
    assert plan.k_pad % 16 == 0 and c <= plan.k_pad < c + 16
    assert plan.k_pad <= -(-c // 64) * 64
    assert plan.bm == 64 == fs.FWD_TILE ** 2
    if staged:  # 8 x 8 tiles of each image
        assert plan.tiles == n * -(-h // 8) * -(-w // 8)
        assert fs.fwd_halo_bytes(dil) >= max((8 + 2 * dil) ** 2 * 128, 2 * 64 * 72 * 2)
    else:  # 64 pixels in a row of N*H*W
        assert plan.tiles * 64 >= p > (plan.tiles - 1) * 64
    assert plan.waves == pytest.approx(plan.tiles / (sms * plan.blocks_per_sm))
    assert -(-f // plan.bn) * plan.bn >= f


def test_fwd_plan_at_the_train_shapes():
    """The plans written down in PERF.md, by (C, F, dilation): h staged in
    8 x 8 tiles everywhere but C = 1536; two blocks per SM up to C = 256,
    with pw preloaded up to 128→256; ring stages 3 at C = 256, 6 at 728, 4
    at 1024, 2 at 1536.  The output-stride-8 shapes keep their (C, F)'s
    plan at dilation 2 and 4: the 1024→1536 halo at dilation 4 still fits
    one block."""
    want = {(64, 128, 1): (fs.PRELOADED_2, 1), (128, 128, 1): (fs.PRELOADED_2, 2),
            (128, 256, 1): (fs.PRELOADED_2, 4), (256, 256, 1): (fs.STAGED_2, 3),
            (256, 728, 1): (fs.STAGED_2, 3), (728, 728, 1): (fs.STAGED_1, 6),
            (728, 1024, 1): (fs.STAGED_1, 6), (1024, 1024, 1): (fs.STAGED_1, 4),
            (1024, 1536, 2): (fs.STAGED_1, 4), (1536, 1536, 2): (fs.UNSTAGED, 2),
            (1536, 2048, 2): (fs.UNSTAGED, 2), (728, 728, 2): (fs.STAGED_1, 6),
            (728, 1024, 2): (fs.STAGED_1, 6), (1024, 1536, 4): (fs.STAGED_1, 4),
            (1536, 1536, 4): (fs.UNSTAGED, 2), (1536, 2048, 4): (fs.UNSTAGED, 2)}
    for n, h, w, c, f, dil in TRAIN_UNITS + OS8_UNITS:
        plan = fs.fwd_plan(n, h, w, c, f, dil, 132)
        assert (plan.mode, plan.stages) == want[c, f, dil], (c, f)
    assert fs.fwd_plan(4, 48, 72, 728, 728, 1, 132).waves == pytest.approx(216 / 132)


@pytest.mark.parametrize("n,h,w,c,f,dil", TRAIN_UNITS + OS8_UNITS + RAGGED_UNITS
                         + [(2, 4, 6, 1024, 1536, 1)] + SPATIAL_UNITS)
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("sms", [132, 114])  # H100 SXM, H100 PCIe
def test_bwd_plan_bounds_partials(n, h, w, c, f, dil, fold, sms):
    plan = fs.bwd_plan(n, h, w, c, f, dil, fold, sms)
    p = n * h * w
    # d_pw: slices of whole 64-pixel boxes cover P; partials under 64 MB
    assert plan.chunk % 64 == 0 and plan.splits * plan.chunk >= p > (plan.splits - 1) * plan.chunk
    assert plan.splits * c * f * 4 <= 64 << 20
    # dx/d_dw: at most 256 partials, and the tiles cover the image
    th, tw = fs.DX_TILE
    ntiles = n * -(-h // th) * -(-w // tw)
    assert plan.dx_blocks <= 256 and plan.dx_blocks * plan.dx_tiles >= ntiles
    assert plan.dx_blocks * 11 * c * 4 <= 64 << 20
    # two blocks per SM of each kernel fit the SM's shared memory
    for smem in (plan.dx_smem, plan.dd_smem, plan.dpw_smem):
        assert smem <= fs.SMEM_TWO_BLOCKS
    assert plan.dd_stages >= 3 and plan.dpw_stages >= 2
    assert plan.dd_smem == fs.gemm_smem_bytes(plan.dd_stages, 4 if fold else 3)
    assert plan.dpw_smem == fs.gemm_smem_bytes(plan.dpw_stages, 5 if fold else 3)


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,w,c,f,pre_relu,dilation", [
    (2, 48, 72, 728, 728, True, 1),
    (2, 24, 36, 1536, 2048, True, 2),
    (1, 96, 144, 64, 128, False, 1),
    (1, 9, 13, 24, 40, True, 1),
])
def test_kernels_match_plain_on_card(n, h, w, c, f, pre_relu, dilation):
    """The CUDA kernels against the plain version on the same bf16 inputs
    on the card: y and dx within 2e-2 of the largest value (bf16 outputs),
    d_dw and d_pw within 1e-3 (fp32 sums in another order); d bit-exact
    (the same fp32 products and sums in the same order, rounded once)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device="cuda")).bfloat16()

    x, g = rnd(n, h, w, c), rnd(n, h, w, f)
    dwk, pwk = rnd(3, 3, c, scale=0.3), rnd(c, f, scale=c ** -0.5)
    y, d = fs.sepconv_fwd(x, dwk, pwk, pre_relu, dilation, True)[:2]
    y_ref, d_ref = fs.sepconv_fwd_plain(x, dwk, pwk, pre_relu, dilation)[:2]
    torch.testing.assert_close(d, d_ref, rtol=0, atol=0)
    got = fs.sepconv_bwd(x, g, dwk, pwk, d, pre_relu, dilation)[:3]
    want = fs.sepconv_bwd_plain(x, g, dwk, pwk, d_ref, pre_relu, dilation)[:3]
    torch.cuda.synchronize()
    for name, a, b, tol in zip(("y", "dx", "d_dw", "d_pw"), (y, *got),
                               (y_ref, *want), (2e-2, 2e-2, 1e-3, 1e-3)):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol * b.float().abs().max().item(), (name, err)


# bf16 outputs within 2e-2 of the largest value, fp32 sums within 1e-3
CARD_TOL = {"y": 2e-2, "dx": 2e-2, "dskip": 2e-2, "ddw": 1e-3, "dpw": 1e-3,
            "da": 1e-3, "db": 1e-3}


@pytest.mark.gpu
@pytest.mark.parametrize("form", fs.FORMS[1:])
@pytest.mark.parametrize("n,h,w,c,f,pre_relu,dilation", [
    (2, 48, 72, 728, 728, True, 1),
    (1, 24, 36, 1536, 2048, True, 2),
    (1, 96, 144, 64, 128, False, 1),
    (1, 9, 13, 24, 40, True, 1),
    # the output-stride-8 dilations: the staged halo at 2, the unstaged
    # taps at 4
    (1, 24, 36, 728, 728, True, 2),
    (1, 24, 36, 1536, 2048, True, 4),
])
def test_forms_match_plain_on_card(form, n, h, w, c, f, pre_relu, dilation):
    """Every other form against the plain version on the card: r and d
    bit-exact; y, dx, d_skip, d_dw, d_pw, da and db as CARD_TOL; Σy and
    Σy² of each channel within 1e-5 of that channel's Σ|y| and Σy² against
    fp64 sums of the kernel's own y (the epilogue sums the rounded tile it
    wrote).  Two calls give bit-identical statistics, d_dw, d_pw, da and db
    (fixed-order partial sums)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rnd(*shape, scale=1.0, shift=0.0):
        return (scale * torch.randn(*shape, generator=gen, device="cuda") + shift).bfloat16()

    affine, skip_on, stats = form != "stats", form.startswith("boundary"), "stats" in form
    pre_relu = pre_relu or skip_on
    x, g = rnd(n, h, w, c), rnd(n, h, w, f)
    dwk, pwk = rnd(3, 3, c, scale=0.3), rnd(c, f, scale=c ** -0.5)
    kw = {}
    if affine:
        kw.update(a=rnd(c, scale=0.2, shift=1.0), b=rnd(c, scale=0.1))
    if skip_on:
        kw["skip"] = rnd(n, h, w, c)
    out = fs.sepconv_fwd(x, dwk, pwk, pre_relu, dilation, True, emit_stats=stats, **kw)
    ref = fs.sepconv_fwd_plain(x, dwk, pwk, pre_relu, dilation, emit_stats=stats, **kw)
    torch.testing.assert_close(out.d, ref.d, rtol=0, atol=0)
    if skip_on:
        torch.testing.assert_close(out.r, ref.r, rtol=0, atol=0)
    bkw = dict(kw)
    if skip_on:
        bkw["gr"] = rnd(n, h, w, c)
    if stats:
        y64 = out.y.double()
        for s, want, scale in ((out.stats[0], y64.sum((0, 1, 2)), y64.abs().sum((0, 1, 2))),
                               (out.stats[1], (y64 ** 2).sum((0, 1, 2)), (y64 ** 2).sum((0, 1, 2)))):
            assert ((s.double() - want).abs() <= 1e-5 * scale).all()
        bkw.update(y=out.y, gs1=0.3 * torch.randn(f, generator=gen, device="cuda"),
                   gs2=0.1 * torch.randn(f, generator=gen, device="cuda"))
    got = fs.sepconv_bwd(x, g, dwk, pwk, out.d, pre_relu, dilation, **bkw)
    again = fs.sepconv_bwd(x, g, dwk, pwk, out.d, pre_relu, dilation, **bkw)
    want = fs.sepconv_bwd_plain(x, g, dwk, pwk, ref.d, pre_relu, dilation, **bkw)
    torch.cuda.synchronize()
    for name, tol in CARD_TOL.items():
        a = out.y if name == "y" else getattr(got, name)
        b = ref.y if name == "y" else getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            err = (a.float() - b.float()).abs().max().item()
            assert err <= tol * b.float().abs().max().item(), (name, err)
    for name in ("ddw", "dpw", "da", "db"):
        a, b = getattr(got, name), getattr(again, name)
        assert a is None or torch.equal(a, b), name
    if stats:
        again_fwd = fs.sepconv_fwd(x, dwk, pwk, pre_relu, dilation, False, emit_stats=True, **kw)
        assert torch.equal(out.stats, again_fwd.stats)


@pytest.mark.gpu
def test_dpw_long_slice_near_fp64_on_card():
    """d_pw over slices of 27648 pixels (the output-stride-8 exit unit at
    batch 4) on cancelling operands, as behind a train-mode BN
    (``analysis/dpw_accuracy.py``): the kernel's d_pw lies no further from
    the fp64 sum of the same bf16 operands than the plain version's fp32
    matmul does.  On an H100 the kernel read 6.9e-7 of the largest entry
    and the fp32 matmul 3.7e-6, where one run of tensor-core accumulation
    along the whole slice read 3.5e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepcam_tpu_torch.analysis import dpw_accuracy

    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    res = dpw_accuracy.measure(4, 96, 144, 1536, 2048, 4, flush)
    assert res["pixels_per_slice"] == 27648
    assert res["kernel"] <= res["plain"], res


@pytest.mark.gpu
def test_row_windows_match_plain_on_card():
    """The row-window copy (the archived probe's counterpart) against its
    plain version at the probe's shape and a ragged one: bit-exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for shape, th, d in ((pw.PROBE_SHAPE, pw.PROBE_TH, pw.PROBE_D), ((1, 13, 5, 8), 3, 2)):
        xp = torch.randn(*shape, generator=torch.Generator().manual_seed(2)).cuda()
        got = pw.row_windows(xp, th, d)
        torch.cuda.synchronize()
        assert torch.equal(got, pw.row_windows_plain(xp, th, d))


@pytest.mark.gpu
@pytest.mark.parametrize("form", fs.FORMS)
@pytest.mark.parametrize("n,h,w,c,f,dil", RAGGED_UNITS + SPATIAL_CARD_UNITS)
def test_ragged_shapes_match_plain_on_card(form, n, h, w, c, f, dil):
    """The redesigned kernels where C and F are off multiples of 16 and 64
    (the zero K padding of the d tile, TMA's zero fill past C and F, the
    ragged last F tile) and P is off a multiple of 64 (masked rows and
    statistics), and at the H-shards of spatial sharding (12 rows at S=4):
    every output against the plain version, as CARD_TOL; d and r
    bit-exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*shape, scale=1.0, shift=0.0):
        return (scale * torch.randn(*shape, generator=gen, device="cuda") + shift).bfloat16()

    affine, skip_on, stats = form not in ("base", "stats"), form.startswith("boundary"), \
        form.endswith("stats")
    x, g = rnd(n, h, w, c), rnd(n, h, w, f)
    dwk, pwk = rnd(3, 3, c, scale=0.3), rnd(c, f, scale=c ** -0.5)
    kw = {}
    if affine:
        kw.update(a=rnd(c, scale=0.2, shift=1.0), b=rnd(c, scale=0.1))
    if skip_on:
        kw["skip"] = rnd(n, h, w, c)
    out = fs.sepconv_fwd(x, dwk, pwk, True, dil, True, emit_stats=stats, **kw)
    ref = fs.sepconv_fwd_plain(x, dwk, pwk, True, dil, emit_stats=stats, **kw)
    torch.testing.assert_close(out.d, ref.d, rtol=0, atol=0)
    if skip_on:
        torch.testing.assert_close(out.r, ref.r, rtol=0, atol=0)
    bkw = dict(kw)
    if skip_on:
        bkw["gr"] = rnd(n, h, w, c)
    if stats:
        y64 = out.y.double()
        assert ((out.stats[0].double() - y64.sum((0, 1, 2))).abs()
                <= 1e-5 * y64.abs().sum((0, 1, 2))).all()
        bkw.update(y=out.y, gs1=0.3 * torch.randn(f, generator=gen, device="cuda"),
                   gs2=0.1 * torch.randn(f, generator=gen, device="cuda"))
    got = fs.sepconv_bwd(x, g, dwk, pwk, out.d, True, dil, **bkw)
    want = fs.sepconv_bwd_plain(x, g, dwk, pwk, ref.d, True, dil, **bkw)
    torch.cuda.synchronize()
    for name, tol in CARD_TOL.items():
        a = out.y if name == "y" else getattr(got, name)
        b = ref.y if name == "y" else getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            err = (a.float() - b.float()).abs().max().item()
            assert err <= tol * b.float().abs().max().item(), (name, err)


def test_launches_run_on_the_tensors_device(monkeypatch):
    """``build.launch`` makes the tensors' device the current one around the
    C call and passes that device's stream: the C side launches on the
    current device.  The guard is entered when another device is current,
    and skipped when the tensors' device already is.  Checked with a
    recording guard, as the CPU has no card; and every kernel wrapper
    launches through it."""
    import inspect

    from deepcam_tpu_torch.ops import build

    events = []

    class Guard:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            events.append(("enter", self.device))

        def __exit__(self, *exc):
            events.append(("exit", self.device))

    current = [0]
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 1000 + index,
                        raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0])
    dev = torch.device("cuda", 1)

    def kernel(*args):
        events.append(("call", args))
        return 0

    build.launch("k", kernel, dev, 7, 8)
    assert events == [("enter", dev), ("call", (7, 8, 1001)), ("exit", dev)]
    events.clear()
    current[0] = 1
    build.launch("k", kernel, dev, 7, 8)
    assert events == [("call", (7, 8, 1001))]
    with pytest.raises(RuntimeError, match="k launch failed: CUDA error 700"):
        build.launch("k", lambda *args: 700, dev)
    for fn, name in ((fs.sepconv_fwd, "sepconv_fwd"), (fs.sepconv_bwd, "sepconv_bwd"),
                     (pw.row_windows_kernel, "row_windows"), (bg.bn_glue_fwd, "bn_glue_fwd"),
                     (bg.bn_glue_bwd, "bn_glue_bwd"), (bo.stats, "bn_own_stats"),
                     (bo.apply, "bn_own_apply"), (bo.grad_stats, "bn_own_grad_stats"),
                     (bo.dx, "bn_own_dx")):
        src = inspect.getsource(fn)
        assert f'launch("{name}", ' in src and "cuda_stream" not in src, name


@pytest.mark.gpu
def test_a_second_card_launches_on_its_own_device():
    """Tensors on cuda:1 while cuda:0 is the current device: the forms run
    on cuda:1 and match their plain version there."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    gen = torch.Generator(device="cuda:1").manual_seed(4)

    def rnd(*shape, scale=1.0, shift=0.0):
        return (scale * torch.randn(*shape, generator=gen, device="cuda:1") + shift).bfloat16()

    x, g = rnd(2, 24, 36, 728), rnd(2, 24, 36, 728)
    dwk, pwk = rnd(3, 3, 728, scale=0.3), rnd(728, 728, scale=728 ** -0.5)
    a, b = rnd(728, scale=0.2, shift=1.0), rnd(728, scale=0.1)
    with torch.cuda.device(0):
        out = fs.sepconv_fwd(x, dwk, pwk, True, 1, True, a=a, b=b, emit_stats=True)
        got = fs.sepconv_bwd(x, g, dwk, pwk, out.d, True, 1, a=a, b=b)
        torch.cuda.synchronize(1)
    ref = fs.sepconv_fwd_plain(x, dwk, pwk, True, 1, a=a, b=b, emit_stats=True)
    want = fs.sepconv_bwd_plain(x, g, dwk, pwk, ref.d, True, 1, a=a, b=b)
    assert out.y.device == got.dx.device == torch.device("cuda", 1)
    torch.testing.assert_close(out.d, ref.d, rtol=0, atol=0)
    for name, u, v in (("y", out.y, ref.y), ("dx", got.dx, want.dx),
                       ("ddw", got.ddw, want.ddw), ("dpw", got.dpw, want.dpw)):
        err = (u.float() - v.float()).abs().max().item()
        assert err <= CARD_TOL[name] * v.float().abs().max().item(), (name, err)
