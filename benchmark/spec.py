"""The benchmark's files, found by name: the manifest ``BENCHMARK.json`` at
the root of the checkout, ``configs/<config>.json``,
``workloads/<cell>.json``, ``metrics/<metric>.py`` and
``families/<family>.py``.  A cell, a configuration, a model family or a
per-layer metric is added as a new file and an entry in the manifest;
nothing here names one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(MANIFEST)


def workload_names(base: Path = HERE) -> List[str]:
    """Every cell whose workload file exists."""
    return sorted(p.stem for p in (base / "workloads").glob("*.json"))


def workload(name: str, base: Path = HERE) -> dict:
    """The workload file of cell ``name``, with its configuration under
    ``"cfg"``."""
    path = base / "workloads" / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no workload file for cell {name!r} ({path})")
    wl = load_json(path)
    wl["name"] = name
    wl["cfg"] = config(wl["config"], base)
    return wl


def config(name: str, base: Path = HERE) -> dict:
    path = base / "configs" / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no configuration file {path}")
    return load_json(path)


def _load(path: Path, module_name: str, what: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or not path.is_file():
        raise KeyError(f"no {what} ({path})")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_module(name: str, base: Path = HERE):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``,
    which defines ``read(ctx) -> float | None``."""
    return _load(base / "metrics" / f"{name}.py", f"benchmark_metric_{name}",
                 f"reader for per-layer metric {name!r}")


def family(name: str, base: Path = HERE):
    """The model family ``name`` that configurations name under
    ``"family"``: ``families/<name>.py``, which defines

    * ``param_specs(cfg)``: [(name, shape, init)] of every tensor, in the
      program's ``state_dict`` order (``weights.py`` reads ``init``), and
      ``is_buffer(name)``: whether a tensor is a BN running statistic;
    * ``forward(cfg, params, x, quant, stats)``: the plain fp32 reference's
      logits (N, H, W, classes) of a training forward over NHWC ``x``,
      with ``quant`` applied to the operands of every convolution (see
      ``reference/quant.py``) and each BN's batch (mean, unbiased variance)
      put into ``stats`` under the BN's name, whose running statistics are
      ``<name>.running_mean`` and ``<name>.running_var``;
    * ``build(cfg, device)``: the program's ``nn.Module`` with its storage
      on ``device``, uninitialised (the only function that imports the
      program, inside it);
    * ``layout(cfg)``: the tensors that ``check.py``'s numbers single out,
      ``head``, ``units`` and ``input_bn``, each possibly empty;
    * ``units(cfg, batch)``: the kernel units that roofline metrics read,
      possibly empty;
    * ``faults(cfg)``: the names of ``faults.py``'s faults that apply."""
    return _load(base / "families" / f"{name}.py", f"benchmark_family_{name}",
                 f"file for model family {name!r}")


def config_family(cfg: dict, base: Path = HERE):
    """The family that configuration ``cfg`` names."""
    if "family" not in cfg:
        raise KeyError(f"configuration {cfg.get('model', cfg)!r} names no family "
                       f"({base / 'families'}/<family>.py)")
    return family(cfg["family"], base)


def cell_metrics(man: dict, cell: str, kind: str) -> List[dict]:
    """The manifest's ``end_to_end`` or ``per_layer`` metrics that cell
    ``cell`` reports: those that list it under ``workloads``, and those
    without a list; a per-layer metric without a list only where the cell
    reports the end-to-end metric it ``moves``."""
    out = [m for m in man[kind] if cell in m.get("workloads", [cell])]
    if kind == "per_layer":
        ends = {m["name"] for m in cell_metrics(man, cell, "end_to_end")}
        out = [m for m in out if "workloads" in m or m["moves"] in ends]
    return out


def cell_entry(man: dict, cell: str) -> Dict:
    for w in man["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"cell {cell!r} is not in {MANIFEST.name}")
