"""The port's fused sepconv unit against the JAX Pallas kernel.

On the CPU the port's ``fused_sepconv`` runs its plain PyTorch version; the
JAX side runs ``fused_sepconv(..., interpret=True)``, the Pallas kernel in
interpret mode.  Forward and all three gradients, on the shapes of
``tests/test_fused_sepconv.py`` (pre_relu on and off, dilation 2, odd W,
C ≠ F).  Tolerances: fp32 forward 1e-5 and gradients 1e-4, as the JAX
kernel's own tests use; bf16 within 2e-2 of the largest value, because y,
dx and the cast d_dw, d_pw round to bf16 (one ulp is 2^-8 relative).

The kernels themselves are held to the plain version in
``tests/test_torch_kernels.py``, which runs on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepcam_tpu.ops.pallas.fused_sepconv import fused_sepconv as jax_fused_sepconv
from deepcam_tpu_torch.ops import fused_sepconv as fs

CASES = [
    # (N, H, W, C, F, pre_relu, dilation)
    (2, 16, 12, 16, 24, True, 1),
    (1, 8, 12, 8, 8, True, 1),
    (2, 12, 10, 24, 16, False, 1),
    (1, 16, 12, 16, 16, True, 2),
    (1, 24, 9, 40, 16, True, 1),
]


def _inputs(seed, n, h, w, c, f):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, h, w, c).astype(np.float32),
            (0.3 * rng.randn(3, 3, c)).astype(np.float32),
            (0.3 * rng.randn(c, f)).astype(np.float32),
            rng.randn(n, h, w, f).astype(np.float32))


def _jax_run(x, dwk, pwk, ct, pre_relu, dilation, dtype=jnp.float32):
    args = [jnp.asarray(a, dtype) for a in (x, dwk, pwk)]
    ctj = jnp.asarray(ct, jnp.float32)

    def loss(x, dwk, pwk):
        y = jax_fused_sepconv(x, dwk, pwk, pre_relu, dilation, True)
        return jnp.sum(y.astype(jnp.float32) * ctj), y

    grads, y = jax.grad(loss, argnums=(0, 1, 2), has_aux=True)(*args)
    return [np.asarray(a, np.float32) for a in (y, *grads)]


def _torch_run(x, dwk, pwk, ct, pre_relu, dilation, dtype=torch.float32):
    args = [torch.tensor(a).to(dtype).requires_grad_() for a in (x, dwk, pwk)]
    y = fs.fused_sepconv(*args, pre_relu, dilation)
    (y.float() * torch.from_numpy(ct)).sum().backward()
    return [t.detach().float().numpy() for t in (y, *(a.grad for a in args))]


@pytest.mark.parametrize("n,h,w,c,f,pre_relu,dilation", CASES)
def test_forward_matches_jax(n, h, w, c, f, pre_relu, dilation):
    x, dwk, pwk, _ = _inputs(0, n, h, w, c, f)
    want = np.asarray(jax_fused_sepconv(jnp.asarray(x), jnp.asarray(dwk),
                                        jnp.asarray(pwk), pre_relu, dilation, True))
    with torch.no_grad():
        got = fs.fused_sepconv(torch.from_numpy(x), torch.from_numpy(dwk),
                               torch.from_numpy(pwk), pre_relu, dilation).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,h,w,c,f,pre_relu,dilation", CASES)
def test_gradients_match_jax(n, h, w, c, f, pre_relu, dilation):
    inputs = _inputs(1, n, h, w, c, f)
    want = _jax_run(*inputs, pre_relu, dilation)
    got = _torch_run(*inputs, pre_relu, dilation)
    for name, g, r in zip(("y", "dx", "d_dw", "d_pw"), got, want):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("case", [CASES[0], CASES[3]])
def test_bf16_matches_jax(case):
    n, h, w, c, f, pre_relu, dilation = case
    inputs = _inputs(2, n, h, w, c, f)
    want = _jax_run(*inputs, pre_relu, dilation, jnp.bfloat16)
    got = _torch_run(*inputs, pre_relu, dilation, torch.bfloat16)
    for name, g, r in zip(("y", "dx", "d_dw", "d_pw"), got, want):
        np.testing.assert_allclose(g, r, rtol=0, atol=2e-2 * np.abs(r).max(),
                                   err_msg=name)


def test_plain_forward_emits_rounded_depthwise():
    """d is the bf16-rounded depthwise output the backward reads; y is its
    pointwise product rounded once."""
    x, dwk, pwk, _ = _inputs(3, *CASES[0][:5])
    xb, kb, pb = (torch.from_numpy(a).bfloat16() for a in (x, dwk, pwk))
    y, d = fs.sepconv_fwd_plain(xb, kb, pb, True, 1)
    assert d.dtype == torch.bfloat16 and y.dtype == torch.bfloat16
    torch.testing.assert_close(y, (d.float() @ pb.float()).bfloat16(), rtol=0, atol=0)
