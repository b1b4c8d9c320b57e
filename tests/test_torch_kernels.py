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
    fs.fused_sepconv(x, dwk, pwk, True, 1).float().sum().backward()
    assert fs.LAUNCHES == {"sepconv_fwd": 0, "sepconv_bwd": 0}
    assert x.grad.shape == x.shape and dwk.grad.dtype == torch.bfloat16


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers check the device before anything is built or
    launched: a CPU tensor never reaches a kernel, and they never compute
    on the CPU themselves."""
    x, dwk, pwk = _bf16(3, 1, 8, 8, 8), _bf16(4, 3, 3, 8), _bf16(5, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        fs.sepconv_fwd(x, dwk, pwk, True, 1, True)
    with pytest.raises(ValueError, match="CUDA"):
        fs.sepconv_bwd(x, x, dwk, pwk, x, True, 1)


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
    y, d = fs.sepconv_fwd(x, dwk, pwk, pre_relu, dilation, True)
    y_ref, d_ref = fs.sepconv_fwd_plain(x, dwk, pwk, pre_relu, dilation)
    torch.testing.assert_close(d, d_ref, rtol=0, atol=0)
    got = fs.sepconv_bwd(x, g, dwk, pwk, d, pre_relu, dilation)
    want = fs.sepconv_bwd_plain(x, g, dwk, pwk, d_ref, pre_relu, dilation)
    torch.cuda.synchronize()
    for name, a, b, tol in zip(("y", "dx", "d_dw", "d_pw"), (y, *got),
                               (y_ref, *want), (2e-2, 2e-2, 1e-3, 1e-3)):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol * b.float().abs().max().item(), (name, err)
