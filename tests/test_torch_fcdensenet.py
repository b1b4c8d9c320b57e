"""FC-DenseNet103 (``models/tiramisu.py``) on the CPU: a tiny model against
the benchmark's plain reference (``benchmark/reference/fcdensenet.py``) in
fp32 and bf16, the dropout masks both sides draw, the published widths on
the meta device, the spans and counters of a train step, and the training
CLI's ``--model fcdensenet103``.

The tiny model: growth rate 4, a first conv of 8, blocks (2, 3 | 2 | 3, 2),
16 → 3 channels, (32, 64), batch 2.  Gradient gaps are taken, as the
benchmark's check takes them, over the larger of the tensor's reference
norm and the median tensor's: a BN after a transition up removes any
per-channel constant, so that transition's bias gradient is rounding alone
(~1e-9 against a median of ~0.07).
"""

from __future__ import annotations

import math
import os
import statistics

import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from benchmark import spec
from benchmark.reference import fcdensenet as ref
from benchmark.reference.quant import bf16, identity
from benchmark.reference.train import MOMENTUM, weighted_ce
from benchmark.weights import make_weights
from deepcam_tpu_torch.models import tiramisu
from deepcam_tpu_torch.models.layers import BatchNorm2d, Conv2d
from deepcam_tpu_torch.models.tiramisu import FCDenseNet103, TransitionUp
from deepcam_tpu_torch.profiling import spans
from deepcam_tpu_torch.train.losses import FPW_1, FPW_2, class_weights
from deepcam_tpu_torch.train.optim import build_optimizer
from deepcam_tpu_torch.train.schedule import get_lr_schedule
from deepcam_tpu_torch.train.trainer import create_train_state, make_train_step
from tests.torch_port_ref import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

TINY = {"family": "fcdensenet", "n_classes": 3, "in_channels": 16, "image_size": [32, 64],
        "growth_rate": 4, "first_conv": 8, "layers_per_block": [2, 3, 2, 3, 2],
        "dropout": 0.2, "dropout_seed": 7}
N_BN = 14  # 12 dense layers, 2 transitions down
SEED = 2 ** 33 + 151
# (logits, gradients, running statistics, eval logits): gaps as norms of the
# difference over the reference's norm (gradients: over the larger of it and
# the median tensor's).  fp32: the sides sum in other orders, and the port's
# BN takes its variance as E[x²]−E[x]² and backpropagates through both
# moments, where the reference takes two passes: 3e-7 on the logits, 1.2e-7
# on the statistics and 1e-4 on the worst gradient (the deep convs' weights,
# behind up to 14 BN backwards); the limits leave 10x and more.  bf16: every
# conv operand and activation rounds to 8 bits; the port reads 0.009 on the
# logits, 0.16 on the worst gradient (a transition's conv weight), 0.004 on
# the statistics and 0.006 on the eval logits, where the reference with bf16
# operands reads 0.006, 0.12, 0.002 and 0.005; every gradient scaled by 1.3
# would read 0.3.  The limits leave about 1.5x to 3x.
TOL = {"fp32": (1e-5, 1e-3, 1e-5, 1e-5), "bf16": (0.03, 0.25, 0.015, 0.02)}
# the loss: up to 1.1e-6 in fp32 (the thread count moves the sums' order),
# 2.8e-4 in bf16
LOSS_TOL = {"fp32": 1e-5, "bf16": 2e-3}


def tiny_model(dtype=torch.float32, cfg=TINY) -> FCDenseNet103:
    m = FCDenseNet103(cfg["n_classes"], in_ch=cfg["in_channels"],
                      growth_rate=cfg["growth_rate"], first_conv=cfg["first_conv"],
                      layers_per_block=cfg["layers_per_block"], dropout=cfg["dropout"],
                      dtype=dtype, device="cpu", seed=cfg["dropout_seed"])
    m.load_state_dict(make_weights(cfg, SEED, "cpu"))
    return m


def batch(cfg=TINY):
    g = torch.Generator().manual_seed(3)
    h, w = cfg["image_size"]
    return (torch.randn(2, h, w, cfg["in_channels"], generator=g),
            torch.randint(0, cfg["n_classes"], (2, h, w), generator=g))


def gap(a, b) -> float:
    return float((a.detach().double() - b.detach().double()).norm()
                 / b.detach().double().norm().clamp_min(1e-30))


def port_side(dtype):
    """One train forward and backward of the port, its running statistics
    after it, and the eval forward after that."""
    m = tiny_model(dtype)
    x, y = batch()
    m.train()
    logits = m(x)
    loss = weighted_ce(logits, y)
    loss.backward()
    grads = {n: p.grad for n, p in m.named_parameters()}
    stats = {n: b.clone() for n, b in m.named_buffers()}
    m.eval()
    with torch.no_grad():
        ev = m(x)
    return {"logits": logits.detach(), "loss": float(loss.detach()), "grads": grads, "stats": stats,
            "eval": ev}


def reference_side(cfg=TINY, quant=identity):
    """The same on the reference, its running statistics updated as
    ``reference/train.py`` updates them."""
    w = make_weights(cfg, SEED, "cpu")
    params = {k: v.clone().requires_grad_(not ref.is_buffer(k)) for k, v in w.items()}
    x, y = batch(cfg)
    bstats: dict = {}
    logits = ref.Forward(cfg, params, quant, 0)
    out = logits(x)
    bstats.update(logits.batch_stats)
    loss = weighted_ce(out, y)
    names = [k for k in params if not ref.is_buffer(k)]
    grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))
    stats = {}
    for name, (mean, var) in bstats.items():
        for key, v in (("running_mean", mean), ("running_var", var)):
            stats[f"{name}.{key}"] = (1 - MOMENTUM) * w[f"{name}.{key}"] + MOMENTUM * v
    after = {k: stats.get(k, v) for k, v in w.items()}
    with torch.no_grad():
        ev = ref.eval_forward(cfg, after, x, quant)
    return {"logits": out.detach(), "loss": float(loss.detach()), "grads": grads, "stats": stats,
            "eval": ev}


def gaps(port: dict, refs: dict) -> tuple:
    med = statistics.median(float(g.norm()) for g in refs["grads"].values())
    grad = max(float((port["grads"][n].double() - g.double()).norm()) / max(float(g.norm()), med)
               for n, g in refs["grads"].items())
    stat = max(gap(port["stats"][n], s) for n, s in refs["stats"].items())
    return (gap(port["logits"], refs["logits"]), grad, stat, gap(port["eval"], refs["eval"]),
            abs(port["loss"] - refs["loss"]) / refs["loss"])


@pytest.fixture(scope="module")
def sides():
    return {"fp32": port_side(torch.float32), "bf16": port_side(torch.bfloat16),
            "ref": reference_side()}


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_port_matches_the_reference(sides, precision):
    """Logits, loss, every gradient, the running statistics after a step,
    and eval-mode logits with those statistics."""
    got = gaps(sides[precision], sides["ref"])
    assert all(g <= t for g, t in zip(got[:4], TOL[precision])), got
    assert got[4] <= LOSS_TOL[precision], got


@pytest.mark.parametrize("change", ["no_dropout", "bf16_operands"])
def test_the_fp32_tolerances_are_tight(sides, change):
    """The reference without dropout, or with bf16 operands, each fail the
    fp32 tolerances against the fp32 port."""
    if change == "no_dropout":
        other = reference_side({**TINY, "dropout": 0.0})
    else:
        other = reference_side(quant=bf16)
    got = gaps(sides["fp32"], other)
    assert any(g > t for g, t in zip(got[:4], TOL["fp32"])) or got[4] > LOSS_TOL["fp32"], got


def test_dropout_masks_match_and_vary():
    """The same (t, l) draws the same mask on both sides; another t draws
    another; about a fifth is dropped."""
    shape = (2, 16, 64, 64)
    for args in [(7, 0, 0, 0), (7, 1, 3, 95), (2 ** 33 + 1, 0, 12, 4)]:
        assert tiramisu.dropout_key(*args) == ref.dropout_key(*args)
    key = ref.dropout_key(7, 0, 5, 3)
    port = tiramisu.keep_mask(shape, 0.2, key, "cpu")
    plain = ref.keep_mask(torch.empty(shape), 0.2, key)
    assert torch.equal(port, plain)
    other = tiramisu.keep_mask(shape, 0.2, ref.dropout_key(7, 0, 6, 3), "cpu")
    assert not torch.equal(port, other)
    assert abs(1 - float(port.float().mean()) - 0.2) < 0.01


def test_dropout_masks_repeat_under_a_checkpointed_recompute():
    """A dense block run under ``torch.utils.checkpoint`` recomputes with
    the masks of its forward: the same output and input gradient, bit for
    bit; and the model's forwards each draw anew."""
    m = tiny_model()
    m.train()
    key_of = m._keys()
    x = torch.randn(2, 8, 32, 64).contiguous(memory_format=torch.channels_last)
    outs = []
    for ckpt in (False, True):
        xi = x.clone().requires_grad_(True)
        if ckpt:
            y = torch.utils.checkpoint.checkpoint(m.down0, xi, key_of, use_reentrant=False)
        else:
            y = m.down0(xi, key_of)
        y.square().sum().backward()
        outs.append((y.detach(), xi.grad))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    a, b = m(batch()[0]), m(batch()[0])
    assert m.train_forwards == 3 and not torch.equal(a, b)


def test_published_widths_on_the_meta_device():
    """9,325,651 parameters, 96 BatchNorms, 98 convs and 5 transposed
    convs; the family's ``param_specs`` give the port's ``state_dict``
    names and shapes, in order."""
    cfg = spec.config("fcdensenet103")
    fam = spec.config_family(cfg)
    with torch.device("meta"):
        m = fam.build(cfg, "meta")
    mods = list(m.modules())
    assert sum(p.numel() for p in m.parameters()) == cfg["parameters"] == 9325651
    assert [sum(isinstance(x, k) for x in mods) for k in (BatchNorm2d, Conv2d, TransitionUp)
            ] == [96, 98, 5]
    assert [(n, tuple(s)) for n, s, _ in fam.param_specs(cfg)] == [
        (n, tuple(t.shape)) for n, t in m.state_dict().items()]


def test_spans_and_counters_of_a_train_step():
    """One train step of the tiny model: a ``dense.block`` span per block
    (5), a ``dense.transition`` per transition (4), and one BN glue call
    each way per BatchNorm (14)."""
    m = tiny_model()
    opt = build_optimizer("AdamW", m.parameters(), get_lr_schedule(1e-3, None), eps=1e-8,
                          weight_decay=1e-2)
    step = make_train_step(class_weights(), fpw_1=FPW_1, fpw_2=FPW_2)
    x, y = batch()
    spans.reset()
    step(create_train_state(m, opt), x, y.to(torch.int32))
    entry = spans.steps()[-1]
    assert (entry["dense.block.n"], entry["dense.transition.n"]) == (5, 4)
    assert entry["bn.fwd.n"] == entry["bn.bwd.n"] == N_BN
    assert entry["dense.block.ns"] + entry["dense.transition.ns"] <= entry["step.forward.ns"]


def _cli_args(root, out, *extra):
    from deepcam_tpu_torch.cli.train import build_parser

    return build_parser().parse_args([
        "--data_dir_prefix", root, "--output_dir", out, "--model", "fcdensenet103",
        "--optimizer", "AdamW", "--local_batch_size", "2", "--eval_local_batch_size", "1",
        "--max_epochs", "1", "--logging_frequency", "1", "--validation_frequency", "1",
        "--save_frequency", "1", "--amp_opt_level", "O1", "--target_iou", "2.0",
        "--device", "cpu", *extra])


def test_cli_trains_a_step(tmp_path):
    """``--model fcdensenet103`` through the training CLI on a 64x96 image
    in bf16: one AdamW step, a validation (the eval step) and a checkpoint
    that restores into a fresh model."""
    from deepcam_tpu_torch.ckpt.checkpoint import restore_checkpoint
    from deepcam_tpu_torch.cli.train import main
    from deepcam_tpu_torch.data.synthetic import make_synthetic_dataset

    root = make_synthetic_dataset(str(tmp_path / "data"), n_train=2, n_validation=1,
                                  shape=(64, 96), seed=1)
    out = str(tmp_path / "o")
    res = main(_cli_args(root, out))
    assert res["step"] == 1 and math.isfinite(res["eval_iou"])
    fresh = FCDenseNet103(device="cpu", seed=5)
    state = create_train_state(fresh, build_optimizer(
        "AdamW", fresh.parameters(), get_lr_schedule(1e-3, None), eps=1e-8, weight_decay=0.0))
    restore_checkpoint(os.path.join(out, "model_step_1.cpt"), state)
    assert not torch.equal(fresh.first_conv.weight, FCDenseNet103(device="cpu", seed=5)
                           .first_conv.weight)
    os.remove(os.path.join(out, "model_step_1.cpt"))


@pytest.mark.parametrize("extra", [["--remat"], ["--spatial", "2"]], ids=["remat", "spatial"])
def test_cli_refuses_what_the_tiramisu_does_not_take(tmp_path, extra):
    from deepcam_tpu_torch.cli.train import main

    with pytest.raises(NotImplementedError, match="fcdensenet103"):
        main(_cli_args(str(tmp_path / "none"), str(tmp_path / "o"), *extra))


def test_cli_model_default():
    from deepcam_tpu_torch.cli.train import build_parser

    assert build_parser().parse_args([]).model == "deeplabv3p"
    assert np.array_equal(tiramisu.LAYERS_PER_BLOCK, spec.config("fcdensenet103")[
        "layers_per_block"])
