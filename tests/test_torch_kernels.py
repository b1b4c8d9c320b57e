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


@pytest.mark.parametrize("p,c,f", [
    (4 * 384 * 576, 64, 128),
    (4 * 48 * 72, 728, 728),
    (4 * 48 * 72, 1536, 2048),
    (2 * 4 * 6, 1024, 1536),
])
@pytest.mark.parametrize("sms", [132, 114])  # H100 SXM, H100 PCIe
def test_bwd_plan_bounds_partials(p, c, f, sms):
    ppb, splits, chunk = fs.bwd_plan(p, c, f, sms)
    assert ppb >= 256 and ppb % 32 == 0
    assert chunk % 32 == 0 and splits * chunk >= p > (splits - 1) * chunk
    assert splits * c * f * 4 <= 64 << 20
    assert -(-p // ppb) * 9 * c * 4 <= 64 << 20


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
