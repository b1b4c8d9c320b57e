"""The port's layers against the JAX package's flax modules, fp32 on the
CPU, with the JAX weights bridged in (layout transposes only).

Forward values within 1e-5 and gradients within 1e-4 (rtol and atol), the
tolerances of the JAX kernel's own tests; BN statistics within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcam_tpu.models import layers as jl
from deepcam_tpu_torch.models import layers as tl
from deepcam_tpu_torch.tools.weights import CONV_PERM, CONVT_PERM
from tests.torch_port_ref import jax_base_config


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).requires_grad_()


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _w(a, perm):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), perm)))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol, err_msg=msg)


def _jax_vjp(module, variables, x, ct, **kw):
    """Output and gradients (x, params) of sum(module(x) * ct)."""
    def f(params, x):
        y = module.apply({**variables, "params": params}, x, **kw)
        return jnp.sum(y * ct), y

    (gp, gx), y = jax.grad(f, argnums=(0, 1), has_aux=True)(variables["params"], x)
    return y, gx, gp


@pytest.mark.parametrize("relu", [False, True])
def test_batchnorm_matches_jax(relu):
    rng = np.random.RandomState(0)
    x = (2.0 * rng.randn(2, 6, 5, 8) + 0.5).astype(np.float32)
    ct = rng.randn(2, 6, 5, 8).astype(np.float32)
    params = {"scale": rng.rand(8).astype(np.float32) + 0.5,
              "bias": rng.randn(8).astype(np.float32)}
    stats = {"mean": rng.randn(8).astype(np.float32),
             "var": rng.rand(8).astype(np.float32) + 0.5}
    jbn = jl.BatchNorm2d(dtype=jnp.float32)

    def f(params, x):
        y, upd = jbn.apply({"params": params, "batch_stats": stats}, x, train=True,
                           relu=relu, mutable=["batch_stats"])
        return jnp.sum(y * ct), (y, upd["batch_stats"])

    (gp, gx), (y_tr, new_stats) = jax.grad(f, argnums=(0, 1), has_aux=True)(params, x)
    # eval reads the running statistics the train step just updated
    y_ev = jbn.apply({"params": params, "batch_stats": new_stats}, x, train=False,
                     relu=relu)

    bn = tl.BatchNorm2d(8)
    bn.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                        "bias": torch.from_numpy(params["bias"]),
                        "running_mean": torch.from_numpy(stats["mean"]),
                        "running_var": torch.from_numpy(stats["var"])})
    xt = _nchw(x)
    y = bn.train()(xt, relu=relu)
    (y * _nchw(ct).detach()).sum().backward()
    _close(_nhwc(y), y_tr, 1e-5, "train output")
    _close(bn.running_mean.numpy(), new_stats["mean"], 1e-5, "running mean")
    _close(bn.running_var.numpy(), new_stats["var"], 1e-5, "running var")
    _close(_nhwc(xt.grad), gx, 1e-4, "dx")
    _close(bn.weight.grad.numpy(), gp["scale"], 1e-4, "d scale")
    _close(bn.bias.grad.numpy(), gp["bias"], 1e-4, "d bias")
    with torch.no_grad():
        y = bn.eval()(_nchw(x), relu=relu)
    _close(_nhwc(y), y_ev, 1e-5, "eval output")


@pytest.mark.parametrize("kw,port_kw", [
    (dict(features=32, kernel_size=3, stride=2, padding=1, small_ch_vjp=True),
     dict(features=32, kernel_size=3, stride=2, padding=1)),
    (dict(features=24, kernel_size=3, padding=6, dilation=6),
     dict(features=24, kernel_size=3, padding=6, dilation=6)),
    (dict(features=12, kernel_size=1, use_bias=True),
     dict(features=12, kernel_size=1, use_bias=True)),
    (dict(features=24, kernel_size=1, stride=2),
     dict(features=24, kernel_size=1, stride=2)),
])
def test_conv2d_matches_jax(kw, port_kw):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 16, 14, 16).astype(np.float32)
    jconv = jl.Conv2d(dtype=jnp.float32, **kw)
    variables = jconv.init(jax.random.PRNGKey(0), x)
    ct = rng.randn(*jconv.apply(variables, x).shape).astype(np.float32)
    y_j, gx_j, gp_j = _jax_vjp(jconv, variables, x, ct)

    feats = port_kw.pop("features")
    k = port_kw.pop("kernel_size")
    conv = tl.Conv2d(16, feats, k, gen=torch.Generator().manual_seed(0), **port_kw)
    sd = {"weight": _w(variables["params"]["kernel"], CONV_PERM)}
    if "bias" in variables["params"]:
        sd["bias"] = torch.from_numpy(np.array(variables["params"]["bias"]))
    conv.load_state_dict(sd)
    xt = _nchw(x)
    y = conv(xt)
    (y * _nchw(ct).detach()).sum().backward()
    _close(_nhwc(y), y_j, 1e-5, "y")
    _close(_nhwc(xt.grad), gx_j, 1e-4, "dx")
    _close(np.transpose(conv.weight.grad.numpy(), np.argsort(CONV_PERM)),
           gp_j["kernel"], 1e-4, "d kernel")
    if "bias" in sd:
        _close(conv.bias.grad.numpy(), gp_j["bias"], 1e-4, "d bias")


@pytest.mark.parametrize("stride,dilation,pre_relu", [
    (2, 1, False), (2, 1, True), (1, 1, True), (1, 2, False),
])
def test_separable_conv_matches_jax(stride, dilation, pre_relu):
    """The stride-2 tail form (two convs) and the stride-1 fused unit (its
    plain version on the CPU) against the JAX module's XLA path."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 12, 10, 16).astype(np.float32)
    jsep = jl.SeparableConv2dSame(features=24, stride=stride, dilation=dilation,
                                  pre_relu=pre_relu, dtype=jnp.float32)
    with jax_base_config():
        variables = jsep.init(jax.random.PRNGKey(1), x)
        ct = rng.randn(*jsep.apply(variables, x).shape).astype(np.float32)
        y_j, gx_j, gp_j = _jax_vjp(jsep, variables, x, ct)

    sep = tl.SeparableConv2dSame(16, 24, stride=stride, dilation=dilation,
                                 pre_relu=pre_relu, gen=torch.Generator().manual_seed(0))
    p = variables["params"]
    sep.load_state_dict({"depthwise.weight": _w(p["depthwise"]["kernel"], CONV_PERM),
                         "pointwise.weight": _w(p["pointwise"]["kernel"], CONV_PERM)})
    xt = _nchw(x)
    y = sep(xt)
    (y * _nchw(ct).detach()).sum().backward()
    _close(_nhwc(y), y_j, 1e-5, "y")
    _close(_nhwc(xt.grad), gx_j, 1e-4, "dx")
    for name in ("depthwise", "pointwise"):
        g = getattr(sep, name).weight.grad.numpy()
        _close(np.transpose(g, np.argsort(CONV_PERM)), gp_j[name]["kernel"], 1e-4, name)


def test_conv_transpose_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 6, 9, 16).astype(np.float32)
    jct = jl.ConvTranspose2d(features=8, dtype=jnp.float32)
    variables = jct.init(jax.random.PRNGKey(2), x)
    ct = rng.randn(2, 12, 18, 8).astype(np.float32)
    y_j, gx_j, gp_j = _jax_vjp(jct, variables, x, ct)

    conv = tl.ConvTranspose2d(16, 8, gen=torch.Generator().manual_seed(0))
    conv.load_state_dict({"weight": _w(variables["params"]["kernel"], CONVT_PERM)})
    xt = _nchw(x)
    y = conv(xt)
    (y * _nchw(ct).detach()).sum().backward()
    _close(_nhwc(y), y_j, 1e-5, "y")
    _close(_nhwc(xt.grad), gx_j, 1e-4, "dx")
    _close(np.transpose(conv.weight.grad.numpy(), np.argsort(CONVT_PERM)),
           gp_j["kernel"], 1e-4, "d kernel")


@pytest.mark.parametrize("in_ch,out_ch,kw", [
    (16, 32, dict(reps=2, stride=2, start_with_relu=False)),      # entry: block1
    (32, 32, dict(reps=3)),                                        # middle: identity skip
    (32, 48, dict(reps=2, grow_first=False, is_last=True)),        # exit: block20
    (24, 24, dict(reps=3, dilation=2)),
])
def test_xception_block_train_matches_jax(in_ch, out_ch, kw):
    """One residual block in train mode: the BN batch-statistics backward,
    composed with the fused units, the tail sepconv and the skip.  A single
    block on (2, 16, 24) has 192-768 values per BN channel and is
    well-conditioned, so the gradients of every parameter and of the input
    are held to fp32 noise (1e-4 of each leaf's largest entry), unlike the
    whole model's train-mode gradients (``test_torch_model.py``)."""
    from deepcam_tpu.models.xception import XceptionBlock as JaxBlock
    from deepcam_tpu_torch.models.xception import XceptionBlock
    from deepcam_tpu_torch.tools.weights import load_jax_variables, state_dict_to_jax
    from tests.torch_port_ref import assert_trees_close

    rng = np.random.RandomState(4)
    x = (rng.randn(2, 16, 24, in_ch) + 0.3).astype(np.float32)
    jblock = JaxBlock(out_ch=out_ch, dtype=jnp.float32, **kw)
    with jax_base_config():
        variables = jblock.init(jax.random.PRNGKey(5), x, train=False)
        stats = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.rand(*a.shape).astype(np.float32) + 0.5),
            variables["batch_stats"])
        ct = rng.randn(*jblock.apply(variables, x, train=False).shape).astype(np.float32)

        def f(params, x):
            y, upd = jblock.apply({"params": params, "batch_stats": stats}, x, train=True,
                                  mutable=["batch_stats"])
            return jnp.sum(y * ct), (y, upd["batch_stats"])

        (gp, gx), (y_j, stats_j) = jax.grad(f, argnums=(0, 1), has_aux=True)(
            variables["params"], x)

    block = XceptionBlock(in_ch, out_ch, gen=torch.Generator().manual_seed(0), **kw)
    load_jax_variables(block, variables["params"], stats)
    xt = _nchw(x)
    y = block.train()(xt)
    (y * _nchw(ct).detach()).sum().backward()
    _close(_nhwc(y), y_j, 1e-5, "y")
    _, port_stats = state_dict_to_jax(block, block.state_dict())
    assert_trees_close(port_stats, stats_j, 1e-5, "batch_stats")
    grads, _ = state_dict_to_jax(block, {k: p.grad for k, p in block.named_parameters()})
    assert_trees_close(grads, gp, 1e-4, "param grads")
    assert_trees_close({"x": _nhwc(xt.grad)}, {"x": gx}, 1e-4, "dx")


@pytest.mark.parametrize("rate", [1, 2, 3, 6])
def test_fixed_padding_matches_jax(rate):
    assert tl.fixed_padding(3, rate) == jl.fixed_padding(3, rate)


def test_inits_follow_torch_semantics():
    """kaiming-normal std sqrt(2/fan_in) and the default uniform bound
    1/sqrt(fan_in), fan_in from weight.shape[1:] as torch computes it."""
    gen = torch.Generator().manual_seed(0)
    w = torch.empty(256, 64, 3, 3)
    tl.kaiming_normal_torch(w, gen)
    assert abs(w.std().item() / np.sqrt(2 / (64 * 9)) - 1) < 0.02
    tl.torch_default_conv_kernel_init(w, gen)
    bound = 1 / np.sqrt(64 * 9)
    assert w.abs().max().item() <= bound and w.abs().max().item() > 0.99 * bound
