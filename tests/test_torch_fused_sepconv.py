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
from tests.torch_port_ref import release_memory  # noqa: F401  (autouse)

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
    y, d = fs.sepconv_fwd_plain(xb, kb, pb, True, 1)[:2]
    assert d.dtype == torch.bfloat16 and y.dtype == torch.bfloat16
    torch.testing.assert_close(y, (d.float() @ pb.float()).bfloat16(), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the five other entry points: folded BN apply, emitted statistics, boundary
# ---------------------------------------------------------------------------

NEW_FORMS = ("affine", "stats", "affine_stats", "boundary", "boundary_stats")
# the shapes of CASES that differ in what the kernels do: one row tile
# (nh == 1), no ReLU, dilation 2, and odd W with C ≠ F and C not a lane
# multiple (several row tiles)
FORM_CASES = CASES[1:]


def _form_inputs(seed, n, h, w, c, f):
    """x, a, b, skip, dwk, pwk, and the cotangents of y, r, Σy, Σy²."""
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(n, h, w, c).astype(np.float32),
            "a": (rng.rand(c) + 0.5).astype(np.float32),
            "b": (0.1 * rng.randn(c)).astype(np.float32),
            "skip": rng.randn(n, h, w, c).astype(np.float32),
            "dwk": (0.3 * rng.randn(3, 3, c)).astype(np.float32),
            "pwk": (0.2 * rng.randn(c, f)).astype(np.float32),
            "gy": rng.randn(n, h, w, f).astype(np.float32),
            "gr": rng.randn(n, h, w, c).astype(np.float32),
            "gs1": (0.3 * rng.randn(f)).astype(np.float32),
            "gs2": (0.1 * rng.randn(f)).astype(np.float32)}


def _form_args(form):
    """The differentiable operands of the entry point, in its order."""
    if form.startswith("boundary"):
        return ("x", "a", "b", "skip", "dwk", "pwk")
    return ("x", "a", "b", "dwk", "pwk") if form.startswith("affine") else ("x", "dwk", "pwk")


def _form_outputs(form):
    outs = ("y", "r") if form.startswith("boundary") else ("y",)
    return outs + (("s1", "s2") if form.endswith("stats") else ())


def _loss_terms(outs, names, cts):
    """Σ y·gy [+ Σ r·gr] [+ Σ s1·gs1 + Σ s2·gs2]: a nonzero cotangent on
    every output."""
    ct_of = {"y": "gy", "r": "gr", "s1": "gs1", "s2": "gs2"}
    return [(o, cts[ct_of[k]]) for o, k in zip(outs, names)]


def _jax_form(form, inp, pre_relu, dilation, dtype):
    from deepcam_tpu.ops.pallas import fused_sepconv as jfs

    fn = getattr(jfs, f"fused_sepconv_{form}")
    names = _form_args(form)
    args = [jnp.asarray(inp[k], dtype) for k in names]
    cts = {k: jnp.asarray(inp[k]) for k in ("gy", "gr", "gs1", "gs2")}
    static = (dilation, True) if form.startswith("boundary") else (pre_relu, dilation, True)

    def loss(*args):
        outs = fn(*args, *static)
        total = sum(jnp.sum(o.astype(jnp.float32) * ct)
                    for o, ct in _loss_terms(outs, _form_outputs(form), cts))
        return total, outs

    # jitted: the interpret-mode kernels compile once instead of running
    # op by op
    grads, outs = jax.jit(jax.grad(loss, argnums=tuple(range(len(names))),
                                   has_aux=True))(*args)
    return ([np.asarray(o, np.float32) for o in outs],
            [np.asarray(g, np.float32) for g in grads])


def _torch_form(form, inp, pre_relu, dilation, dtype):
    fn = getattr(fs, f"fused_sepconv_{form}")
    names = _form_args(form)
    args = [torch.from_numpy(inp[k]).to(dtype).requires_grad_() for k in names]
    cts = {k: torch.from_numpy(inp[k]) for k in ("gy", "gr", "gs1", "gs2")}
    static = (dilation,) if form.startswith("boundary") else (pre_relu, dilation)
    outs = fn(*args, *static)
    total = sum((o.float() * ct).sum() for o, ct in _loss_terms(outs, _form_outputs(form), cts))
    total.backward()
    return ([o.detach().float().numpy() for o in outs],
            [a.grad.float().numpy() for a in args])


@pytest.mark.parametrize("form", NEW_FORMS)
@pytest.mark.parametrize("n,h,w,c,f,pre_relu,dilation", FORM_CASES)
def test_entry_point_matches_jax(form, n, h, w, c, f, pre_relu, dilation):
    """Each entry point against its JAX counterpart in interpret mode, fp32:
    every output (y, r, Σy, Σy²) within 1e-5 and every gradient (dx, da, db,
    d_skip, d_dw, d_pw) within 2e-4, with nonzero cotangents on r, Σy and
    Σy².  The boundary forms always apply the ReLU."""
    inp = _form_inputs(4, n, h, w, c, f)
    want_out, want_grad = _jax_form(form, inp, pre_relu, dilation, jnp.float32)
    got_out, got_grad = _torch_form(form, inp, pre_relu, dilation, torch.float32)
    for name, g, r in zip(_form_outputs(form), got_out, want_out):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5, err_msg=name)
    for name, g, r in zip(_form_args(form), got_grad, want_grad):
        np.testing.assert_allclose(g, r, rtol=2e-4, atol=2e-4, err_msg=f"d_{name}")


@pytest.mark.parametrize("form", NEW_FORMS)
def test_entry_point_bf16_matches_jax(form):
    """bf16 operands: every output and gradient within 2e-2 of its largest
    value (one bf16 ulp is 2^-8 relative; da and db are rounded to a's
    type, as the JAX VJP rounds them)."""
    n, h, w, c, f, pre_relu, dilation = CASES[3]
    inp = _form_inputs(5, n, h, w, c, f)
    want_out, want_grad = _jax_form(form, inp, pre_relu, dilation, jnp.bfloat16)
    got_out, got_grad = _torch_form(form, inp, pre_relu, dilation, torch.bfloat16)
    names = _form_outputs(form) + tuple(f"d_{k}" for k in _form_args(form))
    for name, g, r in zip(names, got_out + got_grad, want_out + want_grad):
        np.testing.assert_allclose(g, r, rtol=0, atol=2e-2 * np.abs(r).max(), err_msg=name)


def test_plain_forms_compose_from_the_base_form():
    """The plain version's prologue is the bf16 affine, residual add and ReLU
    rounded op by op, the boundary's r is the unit's input, and the
    statistics are fp32 sums of the rounded y."""
    inp = _form_inputs(6, *CASES[0][:5])
    x, a, b, skip, dwk, pwk = (torch.from_numpy(inp[k]).bfloat16()
                               for k in ("x", "a", "b", "skip", "dwk", "pwk"))
    out = fs.sepconv_fwd_plain(x, dwk, pwk, True, 1, a=a, b=b, skip=skip, emit_stats=True)
    r = torch.clamp_min(x * a + b + skip, 0)
    base = fs.sepconv_fwd_plain(r, dwk, pwk, False, 1)
    torch.testing.assert_close(out.r, r, rtol=0, atol=0)
    torch.testing.assert_close(out.y, base.y, rtol=0, atol=0)
    torch.testing.assert_close(out.d, base.d, rtol=0, atol=0)
    y32 = base.y.float()
    torch.testing.assert_close(out.stats, torch.stack([y32.sum((0, 1, 2)),
                                                       (y32 ** 2).sum((0, 1, 2))]))
