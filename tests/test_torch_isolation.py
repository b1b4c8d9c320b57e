"""The port imports neither JAX nor anything of the JAX package.

Checked in a fresh subprocess (``tests/conftest.py`` has already imported
JAX into this one) by importing every module of the port and
``chip_smoke.py``, and statically by scanning their sources.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "deepcam_tpu_torch"
FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax", "optax", "deepcam_tpu")
# the data-parallel modules: the process-group wireup and the collectives;
# the profiling entry point and its tables, the observability modules and
# the offline data tools; the resize op and the checkpoint importer
NAMED_MODULES = ("deepcam_tpu_torch.core.mesh", "deepcam_tpu_torch.parallel.collectives",
                "deepcam_tpu_torch.cli.profile", "deepcam_tpu_torch.profiling.profiler",
                "deepcam_tpu_torch.profiling.op_table", "deepcam_tpu_torch.profiling.op_profile",
                "deepcam_tpu_torch.profiling.roofline_plot", "deepcam_tpu_torch.obs.visualizer",
                "deepcam_tpu_torch.obs.wandb_utils", "deepcam_tpu_torch.obs.analysis",
                "deepcam_tpu_torch.tools.split_data", "deepcam_tpu_torch.tools.summarize_data",
                "deepcam_tpu_torch.ops.interpolate",
                "deepcam_tpu_torch.tools.import_torch_checkpoint")

PROBE = """
import importlib, pkgutil, sys
import deepcam_tpu_torch
for m in pkgutil.walk_packages(deepcam_tpu_torch.__path__, "deepcam_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in {roots!r})
print("MODULES", len([m for m in sys.modules if m.startswith("deepcam_tpu_torch")]))
print("LOADED", sorted(m for m in sys.modules if m.startswith("deepcam_tpu_torch")))
print("BAD", bad)
"""


def test_importing_the_port_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(roots=set(FORBIDDEN_ROOTS))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.strip().splitlines())
    assert int(lines["MODULES"]) >= 15
    for name in NAMED_MODULES:
        assert repr(name) in lines["LOADED"], name
    assert lines["BAD"] == "[]", lines["BAD"]


def test_port_sources_name_no_jax():
    imp = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|deepcam_tpu)\b", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 15
    for name in NAMED_MODULES:
        assert ROOT / (name.replace(".", "/") + ".py") in files, name
    for f in files:
        text = f.read_text()
        assert not imp.search(text), f
        assert "deepcam_tpu." not in text, f
