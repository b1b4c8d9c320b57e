"""Train-mode BatchNorm over its own input on the card (``ops/bn_own.py``)
against the operations ``models/layers.py:BatchNorm2d`` composes
(``tests/test_torch_bn_glue.py:composed``).  This file imports no JAX, so
the ``gpu`` tests also run on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_bn_own.py

``ref_stats``, ``ref_apply``, ``ref_grad_stats`` and ``ref_dx`` below say in
PyTorch what each kernel entry computes.  On the CPU they stand in for the
launches (the ``refs_on_cpu`` fixture), so that the autograd function, its
routing and its spans run and are held to the composed path within the
bf16 roundings in which the two differ.  On the card the kernels are held
to them: the sums to fp64, the apply bit for bit, dx within one bf16
rounding; and the layer and a whole train step to the composed operations.
"""

from __future__ import annotations

import pytest
import torch

from deepcam_tpu_torch.models import layers
from deepcam_tpu_torch.models.tiramisu import FCDenseNet103
from deepcam_tpu_torch.ops import bn_own as bo
from deepcam_tpu_torch.parallel import spatial
from deepcam_tpu_torch.profiling import spans
from deepcam_tpu_torch.train import losses as tl
from deepcam_tpu_torch.train.optim import build_optimizer
from deepcam_tpu_torch.train.trainer import create_train_state, make_train_step, running_stats
from test_torch_bn_glue import _Group, composed

# train-mode BatchNorm calls over their own input a step: every one of the
# Tiramisu's (91 dense layers, 5 transitions down), and those of DeepLabV3+
# that no fused unit hands statistics (Xception's bn1 and bn2, the
# stride-2 tails' and skips' BNs, ASPP and the decoder)
OWN_CALLS = {"fcdensenet103": 96, 16: 18, 8: 15}
# every width those calls run at: the Tiramisu's concatenations (48 to 1072
# in steps of its growth rate, 16) and DeepLabV3+'s
WIDTHS = sorted(set(range(48, 1073, 16)) | {32, 64, 128, 256, 728, 1024, 1536, 2048})
# The layer through the function against the composed operations, normwise.
# The composed path takes means where the function takes sums over n, so a
# channel's bf16 (a, b) can round the other way: y within one bf16 rounding
# (2^-8).  The composed backward rounds Σg and Σg·x to bf16 (2^-8 each at
# most), which the glue's −Σg·mean + Σg·x can amplify per channel, and
# forms dx from two bf16 terms each rounded: d weight, d bias and dx within
# 2^-6.  The running statistics see the fp32 moments alone: 1e-5.
LAYER_LIMITS = {"y": 2.0 ** -8, "running_mean": 1e-5, "running_var": 1e-5, "dx": 2.0 ** -6,
                "dweight": 2.0 ** -6, "dbias": 2.0 ** -6}
# A train step through the kernels against the composed step: each gap
# within this many times the composed step's own spread under a one-rounding
# nudge of its input (``test_train_step_against_the_composed_step_on_card``).
STEP_SPREAD = 2.0


# ---------------------------------------------------------------------------
# what each kernel entry computes
# ---------------------------------------------------------------------------

def _g(dy, y, relu):
    """y's cotangent through the ReLU, as PyTorch's threshold_backward."""
    return torch.where(y <= 0, torch.zeros_like(dy), dy) if relu else dy


def ref_stats(x, p=None):
    """``bn_own.stats``: (Σx, Σx²) per channel, fp32."""
    x32 = x.float()
    return torch.stack([x32.sum((0, 2, 3)), (x32 * x32).sum((0, 2, 3))])


def ref_apply(x, a, b, relu, p=None):
    """``bn_own.apply``: the composed bf16 operations, each rounded."""
    y = x * a[:, None, None] + b[:, None, None]
    return torch.relu(y) if relu else y


def ref_grad_stats(dy, y, x, relu, p=None):
    """``bn_own.grad_stats``: (Σg, Σg·x) per channel, fp32."""
    g = _g(dy, y, relu).float()
    return torch.stack([g.sum((0, 2, 3)), (g * x.float()).sum((0, 2, 3))])


def ref_dx(dy, y, x, a, d1, d2, relu, p=None):
    """``bn_own.dx``: g·a + d1 + 2·x·d2 in fp32, rounded once to x's type."""
    g = _g(dy, y, relu).float()
    out = g * a.float()[:, None, None] + d1[:, None, None] + 2 * x.float() * d2[:, None, None]
    return out.to(x.dtype).contiguous(memory_format=torch.channels_last)


@pytest.fixture
def refs_on_cpu(monkeypatch):
    """The layer hands CPU tensors to ``bn_own``, whose launches run their
    references here (counted in ``LAUNCHES`` as the launches are)."""
    def counted(name, fn):
        def call(*args):
            bo.LAUNCHES[name] += 1
            return fn(*args)
        return call

    for attr, fn in (("stats", ref_stats), ("apply", ref_apply),
                     ("grad_stats", ref_grad_stats), ("dx", ref_dx)):
        monkeypatch.setattr(bo, attr, counted(f"bn_own_{attr}", fn))
    monkeypatch.setattr(bo, "plan", lambda device, rows, c, relu: (0,) * 6)
    monkeypatch.setattr(bo, "serves", lambda x: True)
    bo.reset_launches()
    yield
    bo.reset_launches()


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _bn(c, dtype, seed, device="cpu"):
    """A BatchNorm of width ``c`` with random affine and running statistics."""
    g = torch.Generator().manual_seed(seed)
    bn = layers.BatchNorm2d(c, dtype=dtype)
    with torch.no_grad():
        bn.weight.copy_(1 + 0.2 * torch.randn(c, generator=g))
        bn.bias.copy_(0.1 * torch.randn(c, generator=g))
        bn.running_mean.copy_(0.1 * torch.randn(c, generator=g))
        bn.running_var.copy_(0.5 + torch.rand(c, generator=g))
    return bn.to(device)


def _input(shape, dtype, seed, device="cpu", channels_last=True, constant=3):
    """x whose channels have their own mean and spread (the first
    ``constant`` channels constant, whose variance cancels to zero), and a
    cotangent for y."""
    g = torch.Generator().manual_seed(seed + 1)
    n, c, h, w = shape
    x = torch.randn(shape, generator=g) * (0.5 + torch.rand(c, 1, 1, generator=g))
    x = x + 0.3 * torch.randn(c, 1, 1, generator=g)
    x[:, :constant] = 0.25
    dy = torch.randn(shape, generator=g)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    return [t.to(device=device, dtype=dtype).contiguous(memory_format=fmt) for t in (x, dy)]


def _layer(forward, bn, x, dy, relu, start, x_grad=True):
    """``forward`` from the state ``start``: y, the running statistics and
    the gradients of x (with ``x_grad``), the weight and the bias."""
    bn.load_state_dict(start)
    bn.weight.grad = bn.bias.grad = None
    x = x.detach().clone().requires_grad_(x_grad)
    y = forward(bn, x, relu=relu)
    y.backward(dy)
    out = {"y": y.detach(), "running_mean": bn.running_mean.clone(),
           "running_var": bn.running_var.clone(), "dweight": bn.weight.grad.clone(),
           "dbias": bn.bias.grad.clone()}
    if x_grad:
        out["dx"] = x.grad
    return out


def _assert_within(got, want, limits):
    for k in want:
        u, v = got[k].double(), want[k].double()
        gap = ((u - v).norm() / v.norm()).item()
        assert gap <= limits[k], (k, gap)


def _entry():
    """The span entry of what ran since the last ``spans.reset``."""
    with spans.span(spans.ROOT):
        pass
    return spans.steps()[-1]


# ---------------------------------------------------------------------------
# on the CPU, the launches through their references
# ---------------------------------------------------------------------------

@pytest.mark.usefixtures("refs_on_cpu")
@pytest.mark.parametrize("shape", [(2, 48, 8, 12), (2, 24, 5, 7)], ids=["48", "24"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "no_relu"])
@pytest.mark.parametrize("channels_last", [True, False], ids=["nhwc", "nchw"])
@pytest.mark.parametrize("x_grad", [True, False], ids=["dx", "no_dx"])
def test_function_against_the_composed_path(shape, relu, channels_last, x_grad):
    """The layer through the function (one call each way, counted in its
    spans and launches; an input or cotangent in the other layout copied to
    channels_last) against the composed operations, within
    ``LAYER_LIMITS``; no dx launch where x takes no gradient."""
    bn = _bn(shape[1], torch.bfloat16, shape[1])
    x, dy = _input(shape, torch.bfloat16, shape[1], channels_last=channels_last)
    start = {k: v.clone() for k, v in bn.state_dict().items()}
    want = _layer(composed, bn, x, dy, relu, start, x_grad)
    spans.reset()
    got = _layer(layers.BatchNorm2d.forward, bn, x, dy, relu, start, x_grad)
    entry = _entry()
    assert entry["bn.own.fwd.n"] == entry["bn.own.bwd.n"] == 1
    assert entry["bn.fwd.n"] == entry["bn.bwd.n"] == 1
    assert bo.LAUNCHES == {"bn_own_stats": 1, "bn_own_apply": 1, "bn_own_grad_stats": 1,
                           "bn_own_dx": int(x_grad)}
    assert got["y"].is_contiguous(memory_format=torch.channels_last)
    _assert_within(got, want, LAYER_LIMITS)


@pytest.mark.parametrize("case", ["train", "replay", "eval", "fold", "stats", "group", "cpu",
                                  "other_type"])
def test_routing(monkeypatch, refs_on_cpu, case):
    """Which path a call takes: the function in train mode over its own
    input (a remat replay included, which leaves the running statistics);
    the composed path in eval mode, for ``fold``, for handed-in
    statistics, under a statistics group, and for a tensor ``serves``
    leaves to the CPU; an input not in bf16 refused."""
    c = 16
    bn = _bn(c, torch.bfloat16, 3)
    x, _ = _input((2, c, 4, 6), torch.bfloat16, 3)
    kw = {}
    if case == "eval":
        bn.eval()
    elif case == "fold":
        kw["fold"] = True
    elif case == "stats":
        x32 = x.float()
        kw["stats"] = (x32.sum((0, 2, 3)), (x32 * x32).sum((0, 2, 3)))
    elif case == "cpu":
        monkeypatch.setattr(bo, "serves", lambda t: t.device.type == "cuda")
    elif case == "other_type":
        x = x.float()
    start = {k: v.clone() for k, v in bn.state_dict().items()}
    group = _Group(torch.zeros(2, c)) if case == "group" else None
    prev = spatial._set(None, 1, 0, False, group, None)
    spans.reset()
    try:
        if case == "replay":
            with layers._replaying():
                bn(x, relu=True)
        elif case == "other_type":
            with pytest.raises(ValueError, match="bf16"):
                bn(x, relu=True)
        else:
            bn(x, relu=True, **kw)
    finally:
        spatial._set(*prev)
    own = _entry().get("bn.own.fwd.n", 0)
    assert own == (1 if case in ("train", "replay") else 0), case
    assert bo.LAUNCHES["bn_own_stats"] == own
    if case == "replay":
        assert all(torch.equal(v, bn.state_dict()[k]) for k, v in start.items())


def test_refusals():
    """``serves`` hands the layer only tensors on the card; ``bn_own``
    refuses, before any launch, an input or compute type other than bf16, a
    C not a multiple of 8 or above ``MAX_CHANNELS``, an empty input and
    one not 4-d."""
    bf = torch.bfloat16
    assert not bo.serves(torch.zeros(2, 16, 3, 3, dtype=bf))
    assert not bo.serves(torch.zeros(2, 16, 3, 3, dtype=bf, device="meta"))
    w = torch.ones(16)
    for x, dtype in ((torch.zeros(2, 16, 3, 3), bf),
                     (torch.zeros(2, 16, 3, 3, dtype=bf), torch.float32),
                     (torch.zeros(2, 20, 3, 3, dtype=bf), bf),
                     (torch.zeros(1, bo.MAX_CHANNELS + 8, 1, 1, dtype=bf), bf),
                     (torch.zeros(0, 16, 3, 3, dtype=bf), bf),
                     (torch.zeros(16, 3, 3, dtype=bf), bf)):
        with pytest.raises(ValueError, match="bf16"):
            bo.bn_own(x, w, w, w, w, relu=True, momentum=0.1, eps=1e-5, update=True,
                      dtype=dtype)
    assert bo.LAUNCHES == dict.fromkeys(bo.LAUNCHES, 0)


def _train_step(model, x, y):
    """One AdamW train step: the loss, the parameters' gradients and the
    running statistics."""
    opt = build_optimizer("AdamW", model.parameters(), 1e-3, eps=1e-8, weight_decay=1e-2)
    step = make_train_step(tl.class_weights(), fpw_1=tl.FPW_1, fpw_2=tl.FPW_2)
    metrics = step(create_train_state(model, opt), x, y)[1]
    return (float(metrics["loss"]), [p.grad.clone() for p in model.parameters()],
            [b.clone() for b in running_stats(model)])


@pytest.fixture
def few_torch_threads():
    """``tests/torch_port_ref.py:capped_torch_threads`` around a CPU test
    (imported here, where the card's machine never collects it)."""
    from tests.torch_port_ref import capped_torch_threads

    with capped_torch_threads():
        yield


@pytest.mark.usefixtures("few_torch_threads", "refs_on_cpu")
def test_tiramisu_step_counts_own_spans():
    """A bf16 train step of a tiny Tiramisu (widths multiples of 8) on the
    CPU: every BatchNorm (12 dense layers, 2 transitions down) through the
    function, one span and one launch of each entry each way, and the
    glue's spans beside them."""
    g = torch.Generator().manual_seed(2)
    x, y = torch.randn(2, 32, 48, 16, generator=g), torch.randint(0, 3, (2, 32, 48),
                                                                  generator=g)
    model = FCDenseNet103(3, growth_rate=8, first_conv=16, layers_per_block=(2, 3, 2, 3, 2),
                          dtype=torch.bfloat16, device="cpu", seed=5)
    spans.reset()
    loss = _train_step(model, x.bfloat16(), y.to(torch.int32))[0]
    entry = spans.steps()[-1]
    assert torch.isfinite(torch.tensor(loss))
    assert entry["bn.own.fwd.n"] == entry["bn.own.bwd.n"] == entry["bn.fwd.n"] == 14
    assert entry["bn.own.fwd.ns"] > 0 and entry["bn.own.bwd.ns"] > 0
    assert bo.LAUNCHES == dict.fromkeys(bo.LAUNCHES, 14)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _fp64_sums(*ts):
    """(Σ Πts, Σ |Πts|) per channel in fp64."""
    p = ts[0].double()
    for t in ts[1:]:
        p = p * t.double()
    return p.sum((0, 2, 3)), p.abs().sum((0, 2, 3))


def _held_sums(got, want, scale, where):
    """A channel's fp32 sum within 1e-5 of its Σ|·| of the fp64 sum: the
    relative error a summation of that many values in fp32 can keep."""
    gap = ((got.double() - want).abs() / scale.clamp_min(1e-30)).max().item()
    assert gap <= 1e-5, (where, gap)


def _kernels_case(c, shape, relu):
    dev = _card()
    x, dy = _input(shape, torch.bfloat16, c, device=dev)
    n = shape[0] * shape[2] * shape[3]
    p = bo.plan(dev, n, c, relu)
    bo.reset_launches()
    sums = bo.stats(x, p)
    again = bo.stats(x, p)
    assert torch.equal(sums, again), "two runs, other bits"
    s1, a1 = _fp64_sums(x)
    s2, _ = _fp64_sums(x, x)
    _held_sums(sums[0], s1, a1, "sum x")
    _held_sums(sums[1], s2, s2, "sum x^2")
    mean = sums[0] / n
    inv = torch.rsqrt((sums[1] / n - mean * mean).clamp_min(0) + 1e-5)
    a, b = inv.bfloat16(), (0.1 - mean * inv).bfloat16()
    y = bo.apply(x, a, b, relu, p)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, ref_apply(x, a, b, relu)), "apply"
    gsums = bo.grad_stats(dy, y, x, relu, p)
    gr = _g(dy, y, relu).float()
    g1, ag1 = _fp64_sums(gr)
    g2, ag2 = _fp64_sums(gr, x)
    _held_sums(gsums[0], g1, ag1, "sum g")
    _held_sums(gsums[1], g2, ag2, "sum g x")
    d1, d2 = torch.randn(2, c, device=dev) * 1e-3
    dx = bo.dx(dy, y, x, a, d1, d2, relu, p)
    terms = (gr.double() * a.double()[:, None, None], d1.double()[:, None, None],
             2 * x.double() * d2.double()[:, None, None])
    want = sum(terms)
    # one bf16 rounding of the result (2^-8 of it), and fp32's rounding of
    # the terms before it (2^-24 each, twice)
    limit = 2.0 ** -8 * want.abs() + 1e-6 * sum(t.abs() for t in terms)
    assert bool(((dx.double() - want).abs() <= limit).all()), "dx"
    torch.cuda.synchronize()
    assert bo.LAUNCHES == {"bn_own_stats": 2, "bn_own_apply": 1, "bn_own_grad_stats": 1,
                           "bn_own_dx": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("c", WIDTHS)
def test_kernels_at_every_width_on_card(c):
    """Each kernel at every width the cells run, (2, C, 12, 20), with ReLU:
    the sums against fp64, the apply bit-equal to the composed bf16
    operations for the same (a, b), dx against fp64, and the same bits
    from two runs of the statistics."""
    _kernels_case(c, (2, c, 12, 20), True)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 48, 384, 576), (2, 240, 96, 144), (2, 1072, 37, 53),
                                   (4, 2048, 24, 36), (4, 256, 1, 1)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "no_relu"])
def test_kernels_at_large_and_ragged_shapes_on_card(shape, relu):
    """Many blocks and their partial sums, row counts that leave a ragged
    tail, the widest C, and ASPP's pooled (N, 256, 1, 1)."""
    _kernels_case(shape[1], shape, relu)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [48, 256, 1072])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "no_relu"])
def test_layer_through_the_kernels_on_card(c, relu):
    """The layer through the kernels against the composed bf16 operations
    on the card, within ``LAYER_LIMITS``, over channels that are not
    constant (a constant channel's y is bf16 rounding alone)."""
    dev = _card()
    bn = _bn(c, torch.bfloat16, c, device=dev)
    x, dy = _input((2, c, 48, 72), torch.bfloat16, c, device=dev, constant=0)
    start = {k: v.clone() for k, v in bn.state_dict().items()}
    want = _layer(composed, bn, x, dy, relu, start)
    bo.reset_launches()
    spans.reset()
    got = _layer(layers.BatchNorm2d.forward, bn, x, dy, relu, start)
    torch.cuda.synchronize()
    assert bo.LAUNCHES == dict.fromkeys(bo.LAUNCHES, 1)
    assert got["dx"].is_contiguous(memory_format=torch.channels_last)
    _assert_within(got, want, LAYER_LIMITS)


def _net(model, dev):
    from deepcam_tpu_torch.models.deeplab import DeepLabv3plus

    if model == "fcdensenet103":
        return FCDenseNet103(3, dtype=torch.bfloat16, device=dev, seed=1)
    return DeepLabv3plus(3, output_stride=model,
                         decoder="deconv" if model == 16 else "interpolation",
                         dtype=torch.bfloat16, device=dev, seed=1)


def _batch(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    return (torch.rand(2, 128, 192, 16, generator=gen, device=dev).bfloat16(),
            torch.randint(0, 3, (2, 128, 192), generator=gen, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["fcdensenet103", 16, 8])
def test_train_step_launches_on_card(model):
    """One bf16 train step at 128 x 192, batch 2: each kernel launches once
    per own-statistics BatchNorm call, and so does each span."""
    dev = _card()
    net = _net(model, dev)
    bo.reset_launches()
    spans.reset()
    loss = _train_step(net, *_batch(dev))[0]
    torch.cuda.synchronize()
    calls = OWN_CALLS[model]
    entry = spans.steps()[-1]
    assert torch.isfinite(torch.tensor(loss))
    assert bo.LAUNCHES == dict.fromkeys(bo.LAUNCHES, calls)
    assert entry["bn.own.fwd.n"] == entry["bn.own.bwd.n"] == calls


def _nudged(x):
    """x with a third of its values one bf16 rounding up, a third down."""
    gen = torch.Generator(device=x.device).manual_seed(7)
    sign = torch.randint(0, 3, x.shape, generator=gen, device=x.device).float() - 1
    return (x.float() * (1 + sign * 2.0 ** -8)).bfloat16()


def _step_gaps(got, want):
    """The loss's relative gap; the gradients' and the running statistics'
    normwise over the whole model; and the median tensor's gradient gap."""
    def normwise(u, v):
        u = torch.cat([t.double().flatten() for t in u])
        v = torch.cat([t.double().flatten() for t in v])
        return ((u - v).norm() / v.norm()).item()

    per_tensor = sorted(normwise([u], [v]) for u, v in zip(got[1], want[1])
                        if v.norm() > 0)
    return {"loss": abs(got[0] - want[0]) / abs(want[0]), "grad": normwise(got[1], want[1]),
            "grad_median": per_tensor[len(per_tensor) // 2],
            "running": normwise(got[2], want[2])}


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["fcdensenet103", 16, 8])
def test_train_step_against_the_composed_step_on_card(monkeypatch, model):
    """One bf16 train step at 128 x 192, batch 2, through the kernels
    against the composed step from the same weights and batch: the loss,
    the parameters' gradients and the running statistics within
    ``STEP_SPREAD`` times the composed step's own spread when its input
    moves by one bf16 rounding (``_nudged``), the noise any bf16 rounding
    in the step leaves at random initialisation; the kernels round where
    the composed operations round otherwise ((a, b) from sums, Σg and Σg·x
    in fp32, dx rounded once)."""
    dev = _card()
    x, y = _batch(dev)
    start = {k: v.clone() for k, v in _net(model, dev).state_dict().items()}

    def step(inp):
        net = _net(model, dev)
        net.load_state_dict(start)
        return _train_step(net, inp, y)

    got = step(x)
    monkeypatch.setattr(layers.BatchNorm2d, "forward", composed)
    want = step(x)
    spread = step(_nudged(x))
    gaps, noise = _step_gaps(got, want), _step_gaps(spread, want)
    for k, gap in gaps.items():
        assert gap <= STEP_SPREAD * noise[k], (k, gap, noise[k])
