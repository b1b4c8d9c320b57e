"""Train-mode BatchNorm's glue (``ops/bn_glue.py``) against the operations
``models/layers.py:BatchNorm2d`` composed before it, which ``composed``
below keeps.  This file imports no JAX, so the ``gpu`` tests also run on a
machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_bn_glue.py

On the CPU the glue runs its plain version, whose forward is the composed
operations and whose backward is autograd's through them: both are held
bit for bit.  On the card the kernels are held to the plain version and to
the composed path there: the forward bit for bit, the backward within 2
fp32 ulp.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from deepcam_tpu_torch.models import layers
from deepcam_tpu_torch.models.deeplab import DeepLabv3plus
from deepcam_tpu_torch.ops import bn_glue as bg
from deepcam_tpu_torch.ops import bn_own
from deepcam_tpu_torch.parallel import spatial
from deepcam_tpu_torch.profiling import spans
from deepcam_tpu_torch.train import losses as tl
from deepcam_tpu_torch.train.optim import build_optimizer
from deepcam_tpu_torch.train.trainer import create_train_state, make_train_step, running_stats

# every BatchNorm width of the two configurations
CHANNELS = [32, 48, 64, 128, 256, 728, 1024, 1536, 2048]
# train-mode BatchNorm calls a step: one per module
BN_CALLS = {16: 77, 8: 74}


def composed(bn, x, relu=False, fold=False, stats=None):
    """``BatchNorm2d.forward`` in train mode as PyTorch operations, as the
    port ran it before the glue was one function."""
    n = x.shape[0] * x.shape[2] * x.shape[3]
    if stats is not None:
        s1, s2 = stats
        mean, ex2 = s1 / n, s2 / n
    else:
        x32 = x.float()
        mean = x32.mean(dim=(0, 2, 3))
        ex2 = (x32 * x32).mean(dim=(0, 2, 3))
    sync = spatial.stats_group()
    if sync is not None:
        mean, ex2 = sync.mean(torch.stack([mean, ex2])).unbind(0)
        n = n * sync.count
    var = torch.clamp_min(ex2 - mean * mean, 0.0)
    if not layers.recomputing():
        with torch.no_grad():
            m = bn.momentum
            unbiased = var * (n / max(n - 1, 1))
            bn.running_mean.copy_((1.0 - m) * bn.running_mean + m * mean)
            bn.running_var.copy_((1.0 - m) * bn.running_var + m * unbiased)
    inv = torch.rsqrt(var + bn.eps) * bn.weight
    a = inv.to(bn.dtype)
    b = (bn.bias - mean * inv).to(bn.dtype)
    if fold:
        return a, b
    y = x.to(bn.dtype) * a[:, None, None] + b[:, None, None]
    return torch.relu(y) if relu else y


class _Group:
    """A statistics group of two ranks whose other rank's moments are
    ``other``: the mean of the two, differentiably in this rank's."""

    count = 2

    def __init__(self, other):
        self.other = other

    def mean(self, t):
        return (t + self.other) / 2


def _case(c, seed, dtype, device="cpu", shift=0.3):
    """A BatchNorm of width ``c`` with random affine and running statistics,
    a (2, c, 5, 7) input in ``dtype`` whose channels have their own mean,
    and random cotangents."""
    g = torch.Generator().manual_seed(seed)
    bn = layers.BatchNorm2d(c, dtype=dtype)
    with torch.no_grad():
        bn.weight.copy_(1 + 0.2 * torch.randn(c, generator=g))
        bn.bias.copy_(0.1 * torch.randn(c, generator=g))
        bn.running_mean.copy_(0.1 * torch.randn(c, generator=g))
        bn.running_var.copy_(0.5 + torch.rand(c, generator=g))
    x = torch.randn(2, c, 5, 7, generator=g) * (0.5 + torch.rand(c, 1, 1, generator=g))
    x = x + shift * torch.randn(c, 1, 1, generator=g)
    # a few channels whose variance cancels to zero or below (the clamp)
    x[:, :3] = 0.25
    cot = torch.randn(2, c, 5, 7, generator=g), torch.randn(2, c, generator=g)
    other = torch.rand(2, c, generator=g)
    return (bn.to(device), x.to(device=device, dtype=dtype).requires_grad_(),
            [t.to(device) for t in cot], other.to(device))


def _run(forward, bn, x, cot, fold, with_stats):
    """Forward, backward, and what both left: outputs, running statistics,
    and the gradients of x, the moments (with ``with_stats``), weight and
    bias."""
    bn.weight.grad = bn.bias.grad = x.grad = None
    stats = None
    if with_stats:
        x32 = x.float()
        stats = tuple(t.sum((0, 2, 3)) for t in (x32, x32 * x32))
        for t in stats:
            t.retain_grad()
    out = forward(bn, x, relu=not fold, fold=fold, stats=stats)
    if fold:
        loss = (out[0].float() * cot[1][0]).sum() + (out[1].float() * cot[1][1]).sum()
    else:
        loss = (out.float() * cot[0]).sum()
    loss.backward()
    outs = list(out) if fold else [out]
    got = {f"out{i}": o.detach().clone() for i, o in enumerate(outs)}
    got.update(running_mean=bn.running_mean.clone(), running_var=bn.running_var.clone(),
               dx=x.grad.clone(), dweight=bn.weight.grad.clone(), dbias=bn.bias.grad.clone())
    if with_stats:
        got.update(ds1=stats[0].grad.clone(), ds2=stats[1].grad.clone())
    return got


def _both(case, fold, with_stats, *, group=False, replay=False):
    bn, x, cot, other = case
    start = {k: v.clone() for k, v in bn.state_dict().items()}
    results = []
    for forward in (composed, layers.BatchNorm2d.forward):
        bn.load_state_dict(start)
        prev = spatial._set(None, 1, 0, False, _Group(other) if group else None, None)
        try:
            if replay:
                with layers._replaying():
                    results.append(_run(forward, bn, x, cot, fold, with_stats))
            else:
                results.append(_run(forward, bn, x, cot, fold, with_stats))
        finally:
            spatial._set(*prev)
    return results, start


def _assert_same_bits(want, got):
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        assert torch.equal(want[k], got[k]), (k, (want[k].float() - got[k].float()).abs().max())


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("fold", [True, False], ids=["fold", "apply"])
@pytest.mark.parametrize("with_stats", [True, False], ids=["kernel_stats", "reduced"])
def test_plain_glue_is_the_composed_arithmetic(c, fold, with_stats):
    """Forward outputs, running statistics, and the gradients of x, the
    moments, the weight and the bias, bit for bit, in bf16 compute."""
    want, got = _both(_case(c, c, torch.bfloat16), fold, with_stats)[0]
    _assert_same_bits(want, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_stats", [True, False], ids=["kernel_stats", "reduced"])
def test_statistics_group_moments(dtype, with_stats):
    """Under a statistics group the glue takes the group's averaged moments
    and the group's count: the same bits as the composed path."""
    (want, got), start = _both(_case(728, 5, dtype), True, with_stats, group=True)
    _assert_same_bits(want, got)
    assert not torch.equal(got["running_var"], start["running_var"])


@pytest.mark.parametrize("with_stats", [True, False], ids=["kernel_stats", "reduced"])
def test_remat_replay_leaves_running_statistics(with_stats):
    (want, got), start = _both(_case(256, 7, torch.bfloat16), False, with_stats, replay=True)
    _assert_same_bits(want, got)
    for k in ("running_mean", "running_var"):
        assert torch.equal(got[k], start[k]), k


def test_fp32_compute_and_sums_over_the_count():
    """fp32 compute, the moments handed over as sums (``div`` = n), and
    channel means far from zero (where E[x²] − mean² cancels most): the
    same bits as the composed path."""
    want, got = _both(_case(64, 11, torch.float32, shift=2.0), True, True)[0]
    _assert_same_bits(want, got)


def test_cpu_tensors_launch_no_kernel_and_count_spans():
    bg.reset_launches()
    spans.reset()
    bn, x, cot, _ = _case(128, 3, torch.bfloat16)
    _run(layers.BatchNorm2d.forward, bn, x, cot, True, True)
    with spans.span(spans.ROOT):
        pass
    (entry,) = spans.steps()
    assert bg.LAUNCHES == {"bn_glue_fwd": 0, "bn_glue_bwd": 0}
    assert entry["bn.fwd.n"] == entry["bn.bwd.n"] == 1
    assert entry["bn.fwd.ns"] > 0 and entry["bn.bwd.ns"] > 0


def test_kernel_wrappers_refuse_cpu_tensors():
    bn = _case(32, 1, torch.bfloat16)[0]
    m = torch.zeros(32)
    with pytest.raises(ValueError, match="CUDA"):
        bg.bn_glue_fwd(m, m, bn.weight, bn.bias, bn.running_mean, bn.running_var, 70, 70,
                       0.1, 1e-5, True, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        bg.bn_glue_bwd(m.bfloat16(), m.bfloat16(), torch.zeros(4, 32), bn.weight, 70)


def _bn_modules(model):
    return sum(isinstance(m, layers.BatchNorm2d) for m in model.modules())


def _train_step(model, batch):
    opt = build_optimizer("AdamW", model.parameters(), 1e-3, eps=1e-8, weight_decay=1e-2)
    state = create_train_state(model, opt)
    step = make_train_step(tl.class_weights(), fpw_1=tl.FPW_1, fpw_2=tl.FPW_2)
    state, metrics = step(state, *batch)
    return (float(metrics["loss"]), [p.detach().clone() for p in model.parameters()],
            [b.clone() for b in running_stats(model)])


@pytest.fixture
def few_torch_threads():
    """``tests/torch_port_ref.py:capped_torch_threads`` around a CPU test
    (imported here, where the card's machine never collects it)."""
    from tests.torch_port_ref import capped_torch_threads

    with capped_torch_threads():
        yield


@pytest.mark.usefixtures("few_torch_threads")
def test_model_train_step_matches_the_composed_step(monkeypatch):
    """One whole-model AdamW train step on the CPU (fp32, the JAX default
    configuration, the kernels' plain versions) through the glue, against
    the same step with BatchNorm composed as before: the loss, every
    parameter and every running statistic to fp32 tolerance.  The span
    record counts one glue call each way per BatchNorm module."""
    rng = np.random.RandomState(8)
    batch = (torch.from_numpy(rng.rand(2, 32, 48, 16).astype(np.float32)),
             torch.from_numpy(rng.randint(0, 3, size=(2, 32, 48)).astype(np.int32)))
    spans.reset()
    model = DeepLabv3plus(3, dtype=torch.float32, device="cpu", seed=21)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    got = _train_step(model, batch)
    entry = spans.steps()[-1]
    assert entry["bn.fwd.n"] == entry["bn.bwd.n"] == _bn_modules(model) == BN_CALLS[16]
    model.load_state_dict(start)
    monkeypatch.setattr(layers.BatchNorm2d, "forward", composed)
    want = _train_step(model, batch)
    assert got[0] == pytest.approx(want[0], rel=1e-6)
    for g, w in zip(got[1] + got[2], want[1] + want[2]):
        torch.testing.assert_close(g, w, rtol=1.3e-6, atol=1e-5)


@pytest.mark.usefixtures("few_torch_threads")
def test_os8_step_calls_the_glue_once_per_batchnorm():
    rng = np.random.RandomState(9)
    batch = (torch.from_numpy(rng.rand(2, 32, 48, 16).astype(np.float32)),
             torch.from_numpy(rng.randint(0, 3, size=(2, 32, 48)).astype(np.int32)))
    spans.reset()
    model = DeepLabv3plus(3, output_stride=8, decoder="interpolation", dtype=torch.float32,
                          device="cpu", seed=22)
    _train_step(model, batch)
    entry = spans.steps()[-1]
    assert entry["bn.fwd.n"] == entry["bn.bwd.n"] == _bn_modules(model) == BN_CALLS[8]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _ulps(a, b):
    """Largest distance in fp32 ulps (of the larger magnitude) between a and b."""
    a, b = a.float(), b.float()
    ulp = torch.finfo(torch.float32).eps * torch.maximum(a.abs(), b.abs()).clamp_min(
        torch.finfo(torch.float32).tiny)
    gap = (a - b).abs() / ulp
    return gap.max().item() if gap.numel() else 0.0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_match_plain_on_card(c, dtype):
    """Sums (``div`` = n) and means (``div`` = 1), with and without the
    running statistics' update: the forward's a, b, saved rows and running
    statistics bit for bit, the backward within 2 ulp, and one launch each
    way."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(c)

    def rnd(*shape, scale=1.0, shift=0.0):
        return scale * torch.randn(*shape, generator=gen, device=dev) + shift

    n = 2 * 48 * 72
    for div, update in ((n, True), (1, False)):
        m1 = rnd(c, scale=0.5) * div
        m2 = (m1 / div) ** 2 * div + rnd(c, scale=0.3, shift=1.0).abs() * div
        m2[:3] = m1[:3] ** 2 / div  # variance that cancels to zero or below
        weight, bias = rnd(c, scale=0.2, shift=1.0), rnd(c, scale=0.1)
        rm, rv = rnd(c, scale=0.1), rnd(c, scale=0.1, shift=1.0).abs()
        rm2, rv2 = rm.clone(), rv.clone()
        args = (div, n, 0.1, 1e-5, update, dtype)
        bg.reset_launches()
        a, b, saved = bg.bn_glue_fwd(m1, m2, weight, bias, rm, rv, *args)
        a2, b2, saved2 = bg.bn_glue_fwd_plain(m1, m2, weight, bias, rm2, rv2, *args)
        for name, u, v in (("a", a, a2), ("b", b, b2), ("saved", saved, saved2),
                           ("running_mean", rm, rm2), ("running_var", rv, rv2)):
            assert u.dtype == v.dtype and torch.equal(u, v), (name, div)
        ga, gb = rnd(c).to(dtype), rnd(c).to(dtype)
        got = bg.bn_glue_bwd(ga, gb, saved, weight, div)
        want = bg.bn_glue_bwd_plain(ga, gb, saved2, weight, div)
        torch.cuda.synchronize()
        assert bg.LAUNCHES == {"bn_glue_fwd": 1, "bn_glue_bwd": 1}
        for name, u, v in zip(("dweight", "dbias", "dm1", "dm2"), got, want):
            assert _ulps(u, v) <= 2, (name, div, _ulps(u, v))


@pytest.mark.gpu
@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("fold", [True, False], ids=["fold", "apply"])
@pytest.mark.parametrize("with_stats", [True, False], ids=["kernel_stats", "reduced"])
def test_kernels_match_the_composed_path_on_card(monkeypatch, c, fold, with_stats):
    """The layer through the glue's kernels against the composed CUDA
    operations, bf16 compute: outputs and running statistics bit for bit,
    the gradients within 2 ulp.  Over its own input the layer takes the
    composed statistics and apply around the glue here, as it did before
    ``ops/bn_own.py`` (whose layer ``tests/test_torch_bn_own.py`` holds)."""
    monkeypatch.setattr(bn_own, "serves", lambda x: False)
    case = _case(c, c, torch.bfloat16, device=_card())
    want, got = _both(case, fold, with_stats)[0]
    for k in want:
        if k.startswith(("out", "running")):
            assert torch.equal(want[k], got[k]), k
        else:
            assert _ulps(got[k], want[k]) <= 2, (k, _ulps(got[k], want[k]))


@pytest.mark.gpu
@pytest.mark.parametrize("stride,decoder", [(16, "deconv"), (8, "interpolation")])
def test_train_step_through_the_kernels_on_card(monkeypatch, stride, decoder):
    """One bf16 train step of each configuration (batch 2 at 128 x 192):
    the loss and the running statistics bit for bit against the composed
    step from the same weights, and one launch and one span each way per
    train-mode BatchNorm call.  The BatchNorms over their own input take
    the composed operations around the glue here, as they did before
    ``ops/bn_own.py`` (``tests/test_torch_bn_own.py`` holds a step through
    it to the composed step)."""
    dev = _card()
    monkeypatch.setattr(bn_own, "serves", lambda x: False)
    gen = torch.Generator(device=dev).manual_seed(stride)
    batch = (torch.rand(2, 128, 192, 16, generator=gen, device=dev).bfloat16(),
             torch.randint(0, 3, (2, 128, 192), generator=gen, device=dev))
    model = DeepLabv3plus(3, output_stride=stride, decoder=decoder, dtype=torch.bfloat16,
                          device=dev, seed=stride)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    bg.reset_launches()
    spans.reset()
    got = _train_step(model, batch)
    torch.cuda.synchronize()
    calls = BN_CALLS[stride]
    entry = spans.steps()[-1]
    assert _bn_modules(model) == calls
    assert bg.LAUNCHES == {"bn_glue_fwd": calls, "bn_glue_bwd": calls}
    assert entry["bn.fwd.n"] == entry["bn.bwd.n"] == calls
    model.load_state_dict(start)
    monkeypatch.setattr(layers.BatchNorm2d, "forward", composed)
    want = _train_step(model, batch)
    assert math.isfinite(got[0]) and got[0] == want[0]
    for g, w in zip(got[2], want[2]):
        assert torch.equal(g, w)
