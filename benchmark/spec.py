"""The benchmark's files, found by name: the manifest ``BENCHMARK.json`` at
the root of the checkout, ``configs/<config>.json``,
``workloads/<cell>.json`` and ``metrics/<metric>.py``.  A cell, a
configuration or a per-layer metric is added as a new file and an entry in
the manifest; nothing here names one."""

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


def metric_module(name: str, base: Path = HERE):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``,
    which defines ``read(ctx) -> float | None``."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    if spec is None or not path.is_file():
        raise KeyError(f"no reader for per-layer metric {name!r} ({path})")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(man: dict, cell: str, kind: str) -> List[dict]:
    """The manifest's ``end_to_end`` or ``per_layer`` metrics that cell
    ``cell`` reports: those without a ``workloads`` list and those that
    list it."""
    return [m for m in man[kind] if "workloads" not in m or cell in m["workloads"]]


def cell_entry(man: dict, cell: str) -> Dict:
    for w in man["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"cell {cell!r} is not in {MANIFEST.name}")
