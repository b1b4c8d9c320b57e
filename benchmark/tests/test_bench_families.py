"""Model families found by name (``families/<family>.py``).

For both DeepLabV3+ configurations the family gives what the harness read
before families existed: the same tensors, parameter counts, weights from a
seed (bit for bit, against digests taken from the harness before the move),
the same tensors singled out for the held numbers, the same units and the
same work.  A second family enters as new files alone: a toy
conv-BN-ReLU segmenter with a max-pool and a transposed conv, whose program
is a plain module, runs ``run_rank`` on the CPU in a copy of the benchmark
and comes out ``correct``, reports nothing of the separable units, and
fails with every gradient scaled or with a limit on a number it cannot
compute.
"""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark import cell, check, spec  # noqa: E402
from benchmark.weights import make_weights  # noqa: E402

SEED = 2 ** 33 + 5
# (configuration, tensors, parameters, sha256 of [[name, shape, init]], sha256
# of every tensor's name and bytes from ``make_weights(cfg, SEED, "cpu")``,
# units, FLOPs per sample): read from the harness before the move
TODAY = [
    ("deeplabv3p-os16-deconv", 455, 56454720,
     "ed686ac270b95814fa6554faa3e880a56f718a9084b2d21d421df9e1cedd8561",
     "3b36aadd1ab6a7bc0a4bee999ab413dcff232253528f06f0d353e9fbb817b08d", 60, 1963974567936),
    ("deeplabv3p-os8-interp", 439, 54611779,
     "c5a25b3b0d153e14604539f3af66b69057228f7a6c3a6e2877e113a5d6807e89",
     "c3882885dce5f8e64db6f7297b09546f931103a4d706179163e3520e8b9a43a5", 61, 4892061499392),
]


def inferred_layout(fam, cfg: dict) -> dict:
    """The held numbers' tensors as the harness inferred them from the
    shapes before families existed: the parameters after the last BN, each
    depthwise (C, 1, k, k) weight followed by a pointwise (F, C, 1, 1) one,
    the first BN's two statistics."""
    specs = [(n, shape) for n, shape, _ in fam.param_specs(cfg)]
    last_bn = max(i for i, (n, _) in enumerate(specs) if fam.is_buffer(n))
    params = [(n, shape) for n, shape in specs if not fam.is_buffer(n)]
    return {"head": [n for n, _ in specs[last_bn + 1:]],
            "units": [(d, p) for (d, ds), (p, ps) in zip(params, params[1:])
                      if len(ds) == 4 and ds[1] == 1 and len(ps) == 4
                      and tuple(ps[2:]) == (1, 1)],
            "input_bn": [n for n, _ in specs if fam.is_buffer(n)][:2]}


@pytest.mark.parametrize("name,n_tensors,n_params,specs_sha,weights_sha,n_units,flops", TODAY,
                         ids=[t[0] for t in TODAY])
def test_family_path_is_todays(name, n_tensors, n_params, specs_sha, weights_sha, n_units,
                               flops):
    cfg = spec.config(name)
    fam = spec.config_family(cfg)
    specs = fam.param_specs(cfg)
    assert len(specs) == n_tensors
    assert sum(torch.Size(s).numel() for n, s, _ in specs if not fam.is_buffer(n)) == n_params
    assert hashlib.sha256(json.dumps([[n, list(s), i] for n, s, i in specs]).encode()
                          ).hexdigest() == specs_sha
    weights = make_weights(cfg, SEED, "cpu")
    digest = hashlib.sha256()
    for n, _, _ in specs:
        digest.update(n.encode())
        digest.update(weights[n].contiguous().numpy().tobytes())
    assert digest.hexdigest() == weights_sha
    assert fam.layout(cfg) == inferred_layout(fam, cfg)
    assert len(fam.units(cfg, 4)) == n_units
    assert cell.flops_per_sample(cfg) == flops


def test_unknown_family_raises():
    """A configuration that names no family, or a family with no file."""
    with pytest.raises(KeyError, match="nope.py"):
        spec.family("nope")
    with pytest.raises(KeyError, match="nope.py"):
        spec.config_family({"family": "nope"})
    with pytest.raises(KeyError, match="names no family"):
        spec.config_family({"model": "x"})


def test_a_limit_without_its_number_fails():
    """A workload's limit on a number the run did not produce fails the
    run; a number without a limit is printed and not held."""
    nums = {"grad": 0.01, "update": 0.02, "loss": 0.001}
    checks = check.judge(nums, {"grad": 3.0, "grad_units": 0.07})
    assert checks["grad_units"] == {"value": None, "limit": 0.07}
    assert checks["loss"] == {"value": 0.001, "limit": None}
    assert not check.passed(checks)
    assert check.passed(check.judge(nums, {"grad": 3.0}))


TOY_FAMILY = '''"""A toy segmenter: conv-BN-ReLU, a max-pool, conv-BN-ReLU, a transposed
conv back to full size, BN-ReLU and a 1x1 head; no separable units."""

import torch
import torch.nn.functional as F

from benchmark.reference.quant import identity

W = 8


def param_specs(cfg):
    c, k = cfg["in_channels"], cfg["n_classes"]

    def bn(name, width):
        return [(f"{name}.weight", (width,), "ones"), (f"{name}.bias", (width,), "zeros"),
                (f"{name}.running_mean", (width,), "zeros"),
                (f"{name}.running_var", (width,), "ones")]

    return ([("conv0.weight", (W, c, 3, 3), "kaiming")] + bn("bn0", W)
            + [("conv1.weight", (2 * W, W, 3, 3), "kaiming")] + bn("bn1", 2 * W)
            + [("up.weight", (2 * W, W, 2, 2), "uniform")] + bn("bn2", W)
            + [("head.weight", (k, W, 1, 1), "uniform"), ("head.bias", (k,), f"bias:{W}")])


def is_buffer(name):
    return name.endswith((".running_mean", ".running_var"))


def forward(cfg, p, x, quant=identity, stats=None):
    def bn(name, y):
        mean, var = y.mean(dim=(0, 2, 3)), y.var(dim=(0, 2, 3), unbiased=False)
        n = y.shape[0] * y.shape[2] * y.shape[3]
        if stats is not None:
            stats[name] = (mean.detach(), var.detach() * (n / (n - 1)))
        y = (y - mean[:, None, None]) * (torch.rsqrt(var + 1e-5) * p[f"{name}.weight"])[
            :, None, None] + p[f"{name}.bias"][:, None, None]
        return torch.relu(y)

    y = x.permute(0, 3, 1, 2)
    y = bn("bn0", F.conv2d(quant(y), quant(p["conv0.weight"]), padding=1))
    y = F.max_pool2d(y, 2)
    y = bn("bn1", F.conv2d(quant(y), quant(p["conv1.weight"]), padding=1))
    y = bn("bn2", F.conv_transpose2d(quant(y), quant(p["up.weight"]), stride=2))
    y = F.conv2d(quant(y), quant(p["head.weight"])) + p["head.bias"][:, None, None]
    return y.permute(0, 2, 3, 1)


class _BN(torch.nn.Module):
    """Train-mode BatchNorm with momentum 0.1 and no batch counter."""

    def __init__(self, width):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.ones(width))
        self.bias = torch.nn.Parameter(torch.zeros(width))
        self.register_buffer("running_mean", torch.zeros(width))
        self.register_buffer("running_var", torch.ones(width))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            self.training, 0.1, 1e-5)


class Toy(torch.nn.Module):
    def __init__(self, c, k):
        super().__init__()
        nn = torch.nn
        self.conv0, self.bn0 = nn.Conv2d(c, W, 3, padding=1, bias=False), _BN(W)
        self.conv1, self.bn1 = nn.Conv2d(W, 2 * W, 3, padding=1, bias=False), _BN(2 * W)
        self.up, self.bn2 = nn.ConvTranspose2d(2 * W, W, 2, stride=2, bias=False), _BN(W)
        self.head = nn.Conv2d(W, k, 1)

    def forward(self, x, remat=False):
        y = torch.relu(self.bn0(self.conv0(x.permute(0, 3, 1, 2).float())))
        y = torch.relu(self.bn1(self.conv1(F.max_pool2d(y, 2))))
        y = torch.relu(self.bn2(self.up(y)))
        return self.head(y).permute(0, 2, 3, 1)


def build(cfg, device):
    with torch.device("meta"):
        net = Toy(cfg["in_channels"], cfg["n_classes"])
    return net.to_empty(device=device)


def layout(cfg):
    return {"head": ["head.weight", "head.bias"], "units": [],
            "input_bn": ["bn0.running_mean", "bn0.running_var"]}


def units(cfg, batch):
    return []


def faults(cfg):
    return ["half_batch", "grad_scaled"]
'''

TOY_CONFIG = {"source": "a toy for the tests", "model": "toy segmenter", "family": "toyseg",
              "n_classes": 3, "in_channels": 16, "image_size": [32, 48],
              "compute_dtype": "float32", "param_dtype": "float32", "reduced": []}

TOY_LIMITS = {"grad": 0.01, "grad_head": 0.03, "update": 0.25, "bn_stats": 0.06,
              "bn_input": 0.0065}

TOY_RUNS = """
import json, sys, time
sys.path[:0] = [{copy!r}, {repo!r}]
import torch
torch.set_num_threads(3)
import benchmark
assert benchmark.__file__.startswith({copy!r}), benchmark.__file__
from benchmark import cell, faults
out = {{}}
kw = dict(device="cpu", overrides={{"warmup_steps": 1, "timing_steps": 1, "capture_steps": 1}})
out["sound"] = cell.run_rank("toy-step", 2 ** 33 + 9, 0.1, True, 0, 1, time.time(), **kw)
with faults.grad_scaled():
    out["grad_scaled"] = cell.run_rank("toy-step", 2 ** 33 + 9, 0.1, False, 0, 1, time.time(),
                                       **kw)
kw["overrides"]["limits"] = {{**{limits!r}, "grad_units": 0.07}}
out["units_limit"] = cell.run_rank("toy-step", 2 ** 33 + 9, 0.1, False, 0, 1, time.time(), **kw)
print("RESULTS", json.dumps(out))
"""


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """A copy of the benchmark with the toy family, configuration and cell
    added as new files (and manifest entries), and its runs."""
    root = tmp_path_factory.mktemp("toy")
    base = root / "benchmark"
    shutil.copytree(REPO / "benchmark", base, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    (base / "families" / "toyseg.py").write_text(TOY_FAMILY)
    (base / "configs" / "toyseg-small.json").write_text(json.dumps(TOY_CONFIG))
    wl = json.loads((base / "workloads" / "os8-step-b4.json").read_text())
    wl.update(config="toyseg-small", local_batch=2, limits=TOY_LIMITS,
              optimizer={"name": "AdamW", "lr": 1e-3, "eps": 1e-8, "weight_decay": 1e-2})
    wl["traffic"]["resident_batches"] = 2
    (base / "workloads" / "toy-step.json").write_text(json.dumps(wl))
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "toyseg-small", "source": "a toy for the tests",
                           "file": "benchmark/configs/toyseg-small.json", "reduced": [],
                           "why": "a second family"})
    man["workloads"].append({"name": "toy-step", "config": "toyseg-small",
                             "traffic": "toy-step", "chips": 1, "why": "a second family"})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    proc = subprocess.run(
        [sys.executable, "-c", TOY_RUNS.format(copy=str(root), repo=str(REPO),
                                               limits=TOY_LIMITS)],
        cwd=root, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(s for s in proc.stdout.splitlines() if s.startswith("RESULTS "))
    return {"runs": json.loads(line.split(" ", 1)[1]), "before": before}


def test_a_second_family_runs_correct(toy):
    """Sound: ``correct``, with no number, metric or limit of the separable
    units."""
    r = toy["runs"]["sound"]
    assert r["correct"], r["checks"]
    assert "grad_units" not in r["checks"]
    assert {"grad", "grad_head", "update", "bn_stats", "bn_input"} <= set(r["checks"])
    assert not {"sepconv_roofline", "sepconv.launch_host_ms"} & set(r["metrics"]), r["metrics"]
    assert "train_step.host_ms" in r["metrics"]


def test_a_second_family_fails_with_its_gradients_scaled(toy):
    r = toy["runs"]["grad_scaled"]
    assert not r["correct"]
    assert r["checks"]["grad_head"]["value"] > r["checks"]["grad_head"]["limit"]


def test_a_second_family_fails_a_limit_it_cannot_compute(toy):
    r = toy["runs"]["units_limit"]
    assert not r["correct"]
    assert r["checks"]["grad_units"] == {"value": None, "limit": 0.07}


def test_a_second_family_is_added_as_files(toy):
    """No file that the benchmark had changes."""
    assert all(p.read_bytes() == b for p, b in toy["before"].items())
