"""The plain reference against the port, on the CPU at a small size, and the
work the benchmark counts on it, through the DeepLabV3+ family
(``families/deeplabv3p.py``).  The test imports the port; the reference
does not."""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark import spec  # noqa: E402
from benchmark.cell import conv_backward_flops, flops_per_sample  # noqa: E402
from benchmark.reference.train import AdamW, Lamb, optimizer, weighted_ce  # noqa: E402
from benchmark.weights import make_weights  # noqa: E402

CONFIGS = ("deeplabv3p-os16-deconv", "deeplabv3p-os8-interp")
FAMILY = spec.family("deeplabv3p")


def config(name: str, size=None) -> dict:
    cfg = json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())
    if size:
        cfg["image_size"] = list(size)
    return cfg


def port_model(cfg: dict, weights: dict):
    model = FAMILY.build({**cfg, "compute_dtype": "float32"}, "cpu")
    model.load_state_dict(weights)
    return model


@pytest.mark.parametrize("name", CONFIGS)
def test_names_and_shapes_are_the_ports(name):
    """The reference's tensors are the port's state_dict, name for name
    and shape for shape (the weight-name map is the identity)."""
    cfg = config(name, (32, 48))
    weights = make_weights(cfg, 7, "cpu")
    sd = port_model(cfg, weights).state_dict()
    assert list(sd) == [n for n, _, _ in FAMILY.param_specs(cfg)]
    assert all(tuple(sd[n].shape) == tuple(weights[n].shape) for n in sd)


@pytest.mark.parametrize("name", CONFIGS)
def test_train_forward_matches_the_port(name):
    """Train-mode logits, loss and BN batch statistics at (2, 32, 48, 16)
    in fp32: the port's plain path and the reference agree to fp32
    rounding through train-mode BN over few pixels."""
    cfg = config(name, (32, 48))
    weights = make_weights(cfg, 3, "cpu")
    model = port_model(cfg, weights).train()
    x = torch.rand(2, 32, 48, 16, generator=torch.Generator().manual_seed(0))
    y = torch.randint(0, 3, (2, 32, 48), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        port = model(x)
        stats: dict = {}
        ref = FAMILY.forward(cfg, weights, x, stats=stats)
    assert ((port - ref).norm() / ref.norm()).item() < 1e-3
    assert abs(weighted_ce(port, y).item() - weighted_ce(ref, y).item()) < 1e-4
    moved = {n: b for n, b in model.named_buffers() if n.endswith("running_mean")}
    for name_, (mean, _) in stats.items():
        want = 0.1 * mean  # one momentum step from zero
        got = moved[f"{name_}.running_mean"]
        assert ((got - want).norm() / want.norm().clamp_min(1e-12)).item() < 1e-3, name_


def test_lamb_matches_the_ports():
    """Three LAMB steps on the same gradients: the reference's loop and
    the port's foreach optimizer agree to fp32 rounding."""
    from deepcam_tpu_torch.train.optim import build_optimizer

    g = torch.Generator().manual_seed(0)
    shapes = [(16, 8, 3, 3), (16,), (4, 16, 1, 1)]
    init = [torch.randn(s, generator=g) for s in shapes]
    grads = [[torch.randn(s, generator=g) * 3 for s in shapes] for _ in range(3)]
    port = [torch.nn.Parameter(t.clone()) for t in init]
    opt = build_optimizer("LAMB", port, 1e-3, eps=1e-8, weight_decay=1e-2)
    ref = {str(i): t.clone() for i, t in enumerate(init)}
    lamb = Lamb(ref, 1e-3, 1e-2)
    for step in grads:
        for p, gr in zip(port, step):
            p.grad = gr.clone()
        opt.step()
        lamb.step(ref, {str(i): gr for i, gr in enumerate(step)})
    for i, p in enumerate(port):
        assert torch.allclose(p.detach(), ref[str(i)], rtol=1e-6, atol=1e-7)


def test_adamw_matches_torch():
    """Three AdamW steps on the same gradients: the reference's loop and
    ``torch.optim.AdamW`` (the port's, ``optax.adamw``'s math) agree to
    fp32 rounding."""
    g = torch.Generator().manual_seed(1)
    shapes = [(16, 8, 3, 3), (16,), (4, 16, 1, 1)]
    init = [torch.randn(s, generator=g) for s in shapes]
    grads = [[torch.randn(s, generator=g) * 3 for s in shapes] for _ in range(3)]
    port = [torch.nn.Parameter(t.clone()) for t in init]
    opt = torch.optim.AdamW(port, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2)
    ref = {str(i): t.clone() for i, t in enumerate(init)}
    adamw = optimizer({"name": "AdamW", "lr": 1e-3, "eps": 1e-8, "weight_decay": 1e-2}, ref)
    assert isinstance(adamw, AdamW)
    for step in grads:
        for p, gr in zip(port, step):
            p.grad = gr.clone()
        opt.step()
        adamw.step(ref, {str(i): gr for i, gr in enumerate(step)})
    for i, p in enumerate(port):
        assert torch.allclose(p.detach(), ref[str(i)], rtol=1e-6, atol=1e-7)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="SGD"):
        optimizer({"name": "SGD", "lr": 1e-3, "eps": 1e-8, "weight_decay": 0.0}, {})


def hand_flops_middle_block(pixels: int) -> int:
    """Forward and backward of one 728-channel middle-flow block on
    ``pixels`` pixels: three units of a depthwise 3x3 (9 multiply-adds per
    pixel and channel) and a 728x728 pointwise; the backward computes the
    input and the weight gradient of each, twice the forward."""
    forward_macs = 3 * (pixels * 728 * 9 + pixels * 728 * 728)
    return 3 * 2 * forward_macs


def test_flop_count_of_a_middle_block():
    cfg = config(CONFIGS[0])
    block = [b for b in FAMILY.arch.blocks(16) if b.name == "block4"][0]
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        params = {n: torch.empty(s, requires_grad=True) for n, s, _ in FAMILY.param_specs(cfg)
                  if n.startswith("xception.block4.") and not FAMILY.is_buffer(n)}
        x = torch.empty((1, 728, 48, 72), requires_grad=True)
        counter = FlopCounterMode(display=False, custom_mapping={
            torch.ops.aten.convolution_backward: conv_backward_flops})
        with counter:
            FAMILY.model.Forward(cfg, params).block(block, x).sum().backward()
    assert counter.get_total_flops() == hand_flops_middle_block(48 * 72)


def test_flops_per_sample():
    """The whole step's count: three forward passes' worth of every
    convolution, the first one's input gradient left out."""
    assert flops_per_sample(config(CONFIGS[0])) == pytest.approx(1.96397e12, rel=1e-5)
    assert flops_per_sample(config(CONFIGS[1])) == pytest.approx(4.89206e12, rel=1e-5)


@pytest.mark.parametrize("name,n_units,forms", [
    (CONFIGS[0], 60, {"stats": 5, "affine_stats": 38, "boundary_stats": 16, "affine": 1}),
    (CONFIGS[1], 61, {"stats": 5, "affine_stats": 38, "boundary_stats": 16, "affine": 2}),
])
def test_sepconv_units(name, n_units, forms):
    """The stride-1 separable units of a training forward, in the forms the
    port launches per step (chip_smoke.py's counts)."""
    units = FAMILY.units(config(name), 2)
    assert len(units) == n_units
    seen: dict = {}
    for *_, form in units:
        seen[form] = seen.get(form, 0) + 1
    assert seen == forms
    assert sum(p * c * f for _, p, c, f, _, _ in units) > 0
    assert math.prod(config(name)["image_size"]) * 2 // 4 in {u[1] for u in units}
