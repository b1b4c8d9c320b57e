"""The benchmark loads neither JAX nor the JAX package, and its reference
loads nothing of the program.  Each check runs in a fresh interpreter, so
that what another test imported does not count; names are compared by
their whole top-level part (``deepcam_tpu_torch`` begins with
``deepcam_tpu`` and is not it)."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "deepcam_tpu"}

LOADED = """
import json, sys
sys.path.insert(0, {repo!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(body: str) -> set:
    out = subprocess.run([sys.executable, "-c", LOADED.format(repo=str(REPO), body=body)],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_path_loads_no_jax():
    """The harness's run path, driven through a small run on the CPU (the
    port's modules that a run imports included), then the calibration's."""
    names = loaded("""
import time
import benchmark.run, benchmark.calibrate
from benchmark import cell
cell.run_rank("os8-step-b4", 5, 0.1, True, 0, 1, time.time(), device="cpu",
              overrides={"cfg": {"image_size": [32, 48]}, "warmup_steps": 1,
                         "timing_steps": 1, "capture_steps": 1})
""")
    assert not names & FORBIDDEN, sorted(names & FORBIDDEN)
    assert "deepcam_tpu_torch" in names  # the run did load the port


def test_reference_loads_nothing_of_the_program():
    """Every family module, its reference forward and weights at a small
    size, the reference's training step and the comparison."""
    names = loaded("""
import torch
import benchmark.reference.train, benchmark.traffic, benchmark.check
from benchmark import spec
from benchmark.weights import make_weights
for path in sorted((spec.HERE / "families").glob("*.py")):
    spec.family(path.stem)
for name in ("deeplabv3p-os16-deconv", "deeplabv3p-os8-interp"):
    cfg = {**spec.config(name), "image_size": [32, 48]}
    fam = spec.config_family(cfg)
    w = make_weights(cfg, 3, "cpu")
    fam.forward(cfg, w, torch.zeros(1, 32, 48, cfg["in_channels"]))
    fam.layout(cfg), fam.units(cfg, 2), fam.faults(cfg)
""")
    assert not names & (FORBIDDEN | {"deepcam_tpu_torch"}), sorted(names)
