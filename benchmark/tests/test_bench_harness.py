"""The benchmark's manifest and files keep to the benchmark's contract, a
cell is added as a file without an edit, the trace arithmetic is right on a
hand-made trace, and a run without a card fails without a result."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark import spec, trace  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = json.loads((REPO / "BENCHMARK.json").read_text())


def test_manifest_keys_and_characters():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for kind in ("end_to_end", "per_layer"):
        for m in MAN[kind]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
            assert m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                           "moves"}
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(1, len(MAN["workloads"]) // 4)
    assert len(json.dumps(MAN)) < 64 * 1024


def test_every_file_is_found_by_name():
    for c in MAN["configs"]:
        assert (REPO / c["file"]).is_file()
        assert spec.config(c["name"]) == json.loads((REPO / c["file"]).read_text())
    for w in MAN["workloads"]:
        wl = spec.workload(w["name"])
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
        assert w["traffic"] == w["name"]
    for m in MAN["per_layer"]:
        assert callable(spec.metric_module(m["name"]).read)
    for c in MAN["configs"]:
        fam = spec.config_family(spec.config(c["name"]))
        assert all(callable(getattr(fam, f)) for f in (
            "param_specs", "is_buffer", "forward", "build", "layout", "units", "faults"))
    assert sorted(w["name"] for w in MAN["workloads"]) == spec.workload_names()


def test_each_cell_reports_what_its_per_layer_metrics_move():
    """Every cell reports ``setup_s``, one more end-to-end metric and a
    per-layer one, and the end-to-end metric that each of its per-layer
    metrics moves; every ``workloads`` list names cells of the manifest."""
    cells = {w["name"] for w in MAN["workloads"]}
    for c in cells:
        ends = {m["name"] for m in spec.cell_metrics(MAN, c, "end_to_end")}
        layers = spec.cell_metrics(MAN, c, "per_layer")
        assert "setup_s" in ends and len(ends) >= 2 and layers, c
        assert all(m["moves"] in ends for m in layers), c
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]


def test_a_metric_without_a_list_follows_what_it_moves():
    man = {"end_to_end": [{"name": "rate"}, {"name": "mem"},
                          {"name": "only_b", "workloads": ["b"]}],
           "per_layer": [{"name": "free", "moves": "rate"},
                         {"name": "free_b", "moves": "only_b"},
                         {"name": "listed", "moves": "only_b", "workloads": ["a", "b"]}]}
    assert [m["name"] for m in spec.cell_metrics(man, "a", "end_to_end")] == ["rate", "mem"]
    assert [m["name"] for m in spec.cell_metrics(man, "a", "per_layer")] == ["free", "listed"]
    assert [m["name"] for m in spec.cell_metrics(man, "b", "per_layer")] == [
        "free", "free_b", "listed"]


def test_the_loop_readers():
    """The loop cells' rate and step time, and the twins that read as their
    originals do."""
    ms = [float(v) for v in range(1, 101)]
    ctx = {"samples_per_s_per_gpu": 12.5, "step_ms": ms}
    assert spec.metric_module("samples_per_s_per_gpu.loop").read(ctx) == 12.5
    assert spec.metric_module("samples_per_s_per_gpu.loop").read(
        {"samples_per_s_per_gpu": 0.0}) is None
    assert spec.metric_module("step_ms_p90.loop").read(ctx) == pytest.approx(90.9)
    assert spec.metric_module("step_ms_p90.loop").read({"step_ms": [3.0]}) is None
    names = {m["name"] for m in MAN["per_layer"]}
    twins = [n for n in names if n.endswith(".loop") and n[:-5] in names]
    assert len(twins) == 4
    trace_ctx = {"rows": rows((10, 30), (20, 40), (60, 70)), "window": (0.0, 100.0)}
    assert spec.metric_module("device.idle_pct.loop").read(trace_ctx) == pytest.approx(60.0)
    for n in twins:
        assert (spec.metric_module(n).read.__code__.co_filename
                == spec.metric_module(n[:-5]).read.__code__.co_filename)


def test_a_cell_is_added_as_a_file(tmp_path):
    """A workload file dropped into a copy is listed and read, and no file
    that was there changes."""
    base = tmp_path / "benchmark"
    shutil.copytree(REPO / "benchmark", base, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    wl = json.loads((base / "workloads" / "os16-loop-b2.json").read_text())
    wl["local_batch"] = 4
    (base / "workloads" / "os16-loop-b4.json").write_text(json.dumps(wl))
    assert "os16-loop-b4" in spec.workload_names(base)
    assert spec.workload("os16-loop-b4", base)["local_batch"] == 4
    assert all(p.read_bytes() == b for p, b in before.items())


def rows(*spans, cat="elementwise", scope=""):
    return [{"name": f"k{i}", "category": cat, "ts": s, "dur": e - s, "scope": scope}
            for i, (s, e) in enumerate(spans)]


def test_idle_share_on_a_hand_made_trace():
    ctx = {"rows": rows((10, 30), (20, 40), (60, 70)), "window": (0.0, 100.0)}
    # busy: [10, 40] and [60, 70] = 40 of 100
    assert spec.metric_module("device.idle_pct").read(ctx) == pytest.approx(60.0)
    cap = {"rows": ctx["rows"], "window": ctx["window"],
           "spans": [(0.0, 50.0, "next"), (50.0, 100.0, "step")]}
    # idle: [0, 10] in next, [40, 60] and [70, 100] in step; longest first
    gaps = trace.breakdown(cap)["idle_gaps"]
    assert [g[0] for g in gaps] == ["step", "step", "next"]
    assert [g[1] for g in gaps] == pytest.approx([30e-6, 20e-6, 10e-6])


def test_interval_arithmetic():
    """Union, clipping and subtraction, which the idle share and the idle
    gaps read."""
    assert trace.union([(20, 40), (0, 10), (5, 25)]) == [(0, 40)]
    assert trace.clip([(0, 10), (20, 40)], 5, 30) == [(5, 10), (20, 30)]
    # [0, 10] minus [5, 25] -> [0, 5]; [20, 40] minus [5, 25], [30, 35] -> [25, 30], [35, 40]
    assert trace.subtract([(0, 10), (20, 40)], [(5, 25), (30, 35)]) == [
        (0, 5), (25, 30), (35, 40)]
    assert trace.length([(0, 5), (25, 30)]) == 10


def test_run_without_a_card_fails_without_a_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "os16-loop-b2",
                          "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.gpu
def test_a_cell_runs_on_the_card():
    """One short run of the first cell on a card; skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "os16-loop-b2",
                          "--seed", "17", "--seconds", "3", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
