"""The FC-DenseNet family (``families/fcdensenet.py``) in the harness: its
work per sample against a count from the shapes, a run of the cell on the
CPU at a small size that comes out ``correct`` and fails with every
gradient scaled, its dense layers as the roofline reader reads them, and
its reference free of the program.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark import cell, faults, spec  # noqa: E402

CELL = "tiramisu103-step-b2"
SEED = 2 ** 33 + 1611
# the tiny widths of the port's CPU tests, in fp32 at (32, 64)
TINY = {"image_size": [32, 64], "compute_dtype": "float32", "growth_rate": 4,
        "first_conv": 8, "layers_per_block": [2, 3, 2, 3, 2]}
# small-size limits: a sound fp32 run reads grad ~1e-4, grad_head ~1e-6,
# update ~0.01, bn_stats ~1e-6, bn_input ~1e-7; every gradient scaled by
# 1.3 reads grad_head 0.3
LIMITS = {"grad": 3.0, "grad_head": 0.03, "update": 0.25, "bn_stats": 0.06,
          "bn_input": 0.0065}
OVERRIDES = {"cfg": TINY, "traffic": {"resident_batches": 2}, "warmup_steps": 1,
             "timing_steps": 1, "capture_steps": 1, "limits": LIMITS}


def test_flops_per_sample_is_the_count_from_the_shapes():
    """2.1303 TFLOP a sample at the published shapes: three times the
    forward's 0.7142 (the dense layers' 3x3 convs, the transitions' 1x1
    convs and 3x3 transposed convs, the first conv and the classifier),
    less the first conv's input gradient, which no one asks for; within 1%
    of 2.143, three times the forward."""
    cfg = spec.config("fcdensenet103")
    fam = spec.config_family(cfg)
    p, g = fam.ref.plan(cfg), cfg["growth_rate"]
    h, w = cfg["image_size"]

    def pixels(level):
        return (h >> level) * (w >> level)

    def block(c, n):
        return sum(9 * (c + k * g) * g for k in range(n))

    macs = 9 * cfg["in_channels"] * cfg["first_conv"] * pixels(0)
    for i, (c, n) in enumerate(p["down"]):
        macs += (block(c, n) + p["skips"][i] ** 2) * pixels(i)
    macs += block(*p["bottleneck"]) * pixels(p["n_pool"])
    for i, (c, n) in enumerate(p["up"]):
        level = p["n_pool"] - 1 - i
        macs += 9 * p["tu"][i] ** 2 * pixels(level + 1) + block(c, n) * pixels(level)
    macs += p["classifier"] * cfg["n_classes"] * pixels(0)
    first_dx = 2 * 9 * cfg["in_channels"] * cfg["first_conv"] * pixels(0)
    flops = cell.flops_per_sample(cfg)
    assert flops == 3 * 2 * macs - first_dx
    assert abs(flops / 2.143e12 - 1) < 0.01


def test_units_are_the_dense_layers():
    """91 dense layers, each on its own path with its least time and on its
    BN's and conv's paths with none; the least time of a step at batch 2."""
    cfg = spec.config("fcdensenet103")
    units = spec.config_family(cfg).units(cfg, 2)
    own = [u for u in units if u[1] > 0]
    assert len(own) == 91 and len(units) == 3 * 91
    assert own[0][0] == "down0/layers/0" and units[1][0] == "down0/layers/0/bn"
    assert 7.0e-3 < sum(u[1] for u in units) < 8.5e-3


@pytest.fixture(scope="module")
def runs():
    """The cell at the tiny widths on the CPU: a sound traced run, and a run
    with every gradient scaled."""
    out = {"sound": cell.run_rank(CELL, SEED, 0.1, True, 0, 1, time.time(), device="cpu",
                                  overrides=OVERRIDES)}
    with faults.grad_scaled():
        out["grad_scaled"] = cell.run_rank(CELL, SEED, 0.1, False, 0, 1, time.time(),
                                           device="cpu", overrides=OVERRIDES)
    return out


def test_a_small_run_is_correct(runs):
    r = runs["sound"]
    assert r["correct"], r["checks"]
    assert "grad_units" not in r["checks"]
    got = r["metrics"]
    assert got["dense.fwd_host_ms"]["value"] > 0
    assert "sepconv_roofline" not in got and "data.wait_ms" not in got


def test_every_gradient_scaled_fails(runs):
    r = runs["grad_scaled"]
    assert not r["correct"]
    assert r["checks"]["grad_head"]["value"] > LIMITS["grad_head"]


def test_the_reference_loads_nothing_of_the_program():
    """The family imported for its reference, its forward and the FLOP
    count run, in a fresh interpreter: no module of the port is loaded."""
    code = f"""
import json, sys
sys.path.insert(0, {str(REPO)!r})
import torch
from benchmark import cell, spec
from benchmark.weights import make_weights
cfg = {{**spec.config("fcdensenet103"), **{TINY!r}}}
fam = spec.config_family(cfg)
fam.forward(cfg, make_weights(cfg, 3, "cpu"), torch.zeros(1, 32, 64, 16))
fam.layout(cfg), fam.units(cfg, 2), fam.faults(cfg), cell.flops_per_sample(cfg)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"jax", "jaxlib", "flax", "deepcam_tpu", "deepcam_tpu_torch"}


def test_the_reference_refuses_a_second_rank():
    """One forward per step over the same parameters draws forwards 0, 1,
    ...; a second forward in one step (a second emulated rank, whose masks
    the program keys by its rank) raises instead of drawing rank 0's."""
    import torch

    from benchmark.reference.train import run_steps
    from benchmark.weights import make_weights

    cfg = {**spec.config("fcdensenet103"), **TINY}
    weights = make_weights(cfg, SEED, "cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 32, 64, 16, generator=g)
    y = torch.randint(0, 3, (1, 32, 64), generator=g)
    opt = {"name": "AdamW", "lr": 1e-3, "eps": 1e-8, "weight_decay": 1e-2}
    assert len(run_steps(cfg, weights, [[(x, y)], [(x, y)]], opt)["loss"]) == 2
    with pytest.raises(NotImplementedError, match="rank"):
        run_steps(cfg, weights, [[(x, y), (x, y)]], opt)
