"""The port's host spans and counters (``profiling/spans.py``) and the
benchmark's readers of them, on the CPU.

A toy model with one fused separable unit (its plain version here) trains
a few steps through ``DataLoader``, ``prefetch_to_device`` and
``make_train_step``; the record must hold one entry per step, phases
inside the root, the root inside an outside clock, every reader-thread
read counted, and ranges in a profiler's trace only while it records.
The seven per-layer readers run through a small ``benchmark.cell.run_rank``
in a fresh interpreter (this one has JAX loaded, which a benchmark run
refuses).
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import spec
from deepcam_tpu_torch.data.pipeline import DataLoader, prefetch_to_device
from deepcam_tpu_torch.ops import fused_sepconv as fs
from deepcam_tpu_torch.profiling import spans
from deepcam_tpu_torch.train.trainer import create_train_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]
H, W, C, F = 8, 12, 16, 8
BATCH, STEPS = 2, 5
PHASES = ("step.forward", "step.backward", "step.optimizer")
LOOP_ONLY = ("data.reader_wait_ms", "data.stage_ms", "data.read_ms")
ANY_ENTRY = ("train_step.forward_host_ms", "train_step.backward_host_ms",
             "train_step.optimizer_host_ms", "sepconv.launch_host_ms")


class _Samples:
    """``n`` samples of (H, W, C) fp32 and (H, W) labels in {0, 1, 2}."""

    def __init__(self, n):
        rng = np.random.default_rng(0)
        self.items = [(rng.standard_normal((H, W, C), dtype=np.float32),
                       rng.integers(0, 3, (H, W)), f"s{i}") for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        time.sleep(0.001)
        return self.items[i]


class _Toy(torch.nn.Module):
    """One fused separable unit, then a 1x1 head to 3 classes (NHWC), and
    a bias of 2 M values that gives the optimizer a few ms of work."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.dwk = torch.nn.Parameter(0.3 * torch.randn(3, 3, C, generator=g))
        self.pwk = torch.nn.Parameter(0.3 * torch.randn(C, F, generator=g))
        self.head = torch.nn.Parameter(0.3 * torch.randn(F, 3, generator=g))
        self.bias = torch.nn.Parameter(torch.zeros(2 << 20))

    def forward(self, x, remat=False):
        return fs.fused_sepconv(x, self.dwk, self.pwk) @ self.head + self.bias.mean()


def toy_state():
    model = _Toy()
    return create_train_state(model, torch.optim.Adam(model.parameters(), lr=1e-3))


def train(n_steps=STEPS, workers=2):
    """``n_steps`` toy steps through the loader; the record is reset first.
    Returns each step's outside host seconds around ``step_fn``."""
    spans.reset()
    state = toy_state()
    step_fn = make_train_step((1.0, 2.0, 3.0))
    loader = DataLoader(_Samples(n_steps * BATCH), BATCH, num_workers=workers)
    outside = []
    for x, y, _ in prefetch_to_device(loader, "cpu"):
        t0 = time.perf_counter_ns()
        state, metrics = step_fn(state, x, y)
        outside.append(time.perf_counter_ns() - t0)
    assert np.isfinite(float(metrics["loss"]))
    return outside


def test_each_step_leaves_one_entry_with_its_phases_inside():
    outside = train()
    record = spans.steps()
    assert len(record) == STEPS
    for e, out_ns in zip(record, outside):
        assert e["step.n"] == 1
        assert all(e[f"{p}.ns"] > 0 and e[f"{p}.n"] == 1 for p in PHASES), e
        assert sum(e[f"{p}.ns"] for p in PHASES) <= e["step.ns"] <= out_ns
        assert e["sepconv.fwd.n"] == 1 and e["sepconv.bwd.n"] == 1
        assert 0 < e["sepconv.fwd.ns"] < e["step.forward.ns"]
        assert 0 < e["sepconv.bwd.ns"] < e["step.backward.ns"]


def test_reads_average_the_local_batch_and_none_is_lost():
    """With four reader threads every read is counted once: the reads over
    the run come to the local batch per step."""
    train(workers=4)
    record = spans.steps()
    assert sum(e.get("data.read.n", 0) for e in record) == STEPS * BATCH
    assert sum(e.get("data.wait.n", 0) for e in record) == STEPS
    assert sum(e.get("data.stage.n", 0) for e in record) == STEPS
    assert all(e.get("data.read.ns", 0) >= 1e6 * e.get("data.read.n", 0) for e in record)


def test_spans_from_many_threads_lose_no_count():
    """Sixteen threads add to the open entry at once, with the interpreter
    switching threads as often as it can; the root then closes it."""
    spans.reset()
    n_threads, each = 16, 2000

    def work():
        for _ in range(each):
            with spans.span("data.read"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    with spans.span(spans.ROOT):
        pass
    (entry,) = spans.steps()
    assert entry["data.read.n"] == n_threads * each and entry["step.n"] == 1


def _ranges(events, name):
    return [(e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
            if e.get("ph") == "X" and e["name"] == name]


def test_ranges_in_a_profiler_trace(tmp_path):
    """Under a CPU ``torch.profiler`` capture the phases are ranges inside
    the root's, and the record's durations agree with the ranges'."""
    train(n_steps=2)  # warm
    spans.reset()
    state = toy_state()
    step_fn = make_train_step((1.0, 2.0, 3.0))
    x = torch.randn(BATCH, 64, 96, C)
    y = torch.randint(0, 3, (BATCH, 64, 96))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            state, _ = step_fn(state, x, y)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    roots = _ranges(events, "deepcam.step")
    assert len(roots) == 3
    record = spans.steps()
    for p in PHASES:
        inner = _ranges(events, f"deepcam.{p}")
        assert len(inner) == 3, p
        for (s, e, tid), (rs, re_, rtid) in zip(inner, roots):
            assert tid == rtid and rs <= s and e <= re_, (p, s, e, rs, re_)
        for (s, e, _), entry in zip(inner, record):
            assert (e - s) * 1e3 == pytest.approx(entry[f"{p}.ns"], rel=0.1), p
    for (s, e, _), entry in zip(roots, record):
        assert (e - s) * 1e3 == pytest.approx(entry["step.ns"], rel=0.1)


def test_no_range_without_a_profiler(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    train(n_steps=2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with spans.span(spans.ROOT):
            pass
    assert [n for n in entered if n.startswith(spans.PREFIX)] == ["deepcam.step"]


def test_host_ns_counts_the_plain_version_and_resets():
    """The fused unit's plain version adds its host ns to the open entry,
    one call a direction; ``spans.reset`` drops what is open."""
    spans.reset()
    fs.reset_launches()
    x = torch.randn(1, H, W, C, requires_grad=True)
    fs.fused_sepconv(x, torch.randn(3, 3, C), torch.randn(C, F)).sum().backward()
    assert fs.LAUNCHES == {"sepconv_fwd": 0, "sepconv_bwd": 0}  # no kernel on the CPU
    with spans.span(spans.ROOT):
        pass
    (entry,) = spans.steps()
    assert entry["sepconv.fwd.ns"] > 0 and entry["sepconv.bwd.ns"] > 0
    assert entry["sepconv.fwd.n"] == 1 and entry["sepconv.bwd.n"] == 1
    fs.fused_sepconv(x, torch.randn(3, 3, C), torch.randn(C, F))
    spans.reset()
    with spans.span(spans.ROOT):
        pass
    assert "sepconv.fwd.ns" not in spans.steps()[0]


def test_counter_growth_per_entry_survives_a_reset():
    """What is added between two closes lands in the second's entry alone,
    and a reset of the launch counters in between leaves the record be."""
    spans.reset()
    spans.add("sepconv.fwd", 500)
    with spans.span(spans.ROOT):
        pass
    fs.reset_launches()
    spans.add("sepconv.fwd", 70)
    spans.add("sepconv.fwd", 30)
    with spans.span(spans.ROOT):
        pass
    assert [(e["sepconv.fwd.ns"], e["sepconv.fwd.n"]) for e in spans.steps()] == [
        (500, 1), (100, 2)]


def test_readers_return_none_on_a_short_or_outside_record():
    spans.reset()
    for _ in range(4):
        with spans.span(spans.ROOT):
            with spans.span("step.forward"):
                time.sleep(0.002)
    reader = spec.metric_module("train_step.forward_host_ms")
    ctx = {"step_host_s": [1.0, 1.0], "capture_steps": 2}
    assert reader.read(ctx) == pytest.approx(
        sum(e["step.forward.ns"] for e in spans.steps()[:2]) / 2e6)
    assert reader.read({**ctx, "step_host_s": [1.0] * 3}) is None  # 3 + 2 > 4 entries
    assert reader.read({**ctx, "step_host_s": [1.0, 0.0005]}) is None  # root outside
    assert spec.metric_module("data.reader_wait_ms").read(ctx) is None  # no data spans


RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(3)
from benchmark import cell
r = cell.run_rank({cell!r}, 2 ** 33 + 7, 0.1, True, 0, 1, time.time(), device="cpu",
                  overrides={{"cfg": {{"image_size": [32, 48], "compute_dtype": "float32"}},
                             "traffic": {traffic!r}, "warmup_steps": 1, "timing_steps": 1,
                             "capture_steps": 1}})
print("METRICS", json.dumps({{k: v["value"] for k, v in r["metrics"].items()}}))
"""


@pytest.mark.parametrize("cell,traffic", [
    ("os16-loop-b2", {"samples_per_rank": 4, "max_steps": 64}),
    ("os8-step-b4", {"resident_batches": 2})])
def test_readers_in_a_traced_run(cell, traffic):
    """The seven readers in a small traced run of each entry: positive in
    the loop; in the step entry, whose feed has no pipeline, the three
    ``data.*`` left out; the phases inside the benchmark's own span."""
    proc = subprocess.run(
        [sys.executable, "-c", RUN.format(root=str(ROOT), cell=cell, traffic=traffic)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(s for s in proc.stdout.splitlines() if s.startswith("METRICS "))
    got = json.loads(line.split(" ", 1)[1])
    assert all(got[m] > 0 for m in ANY_ENTRY), got
    if cell.startswith("os16-loop"):
        assert all(got[m] > 0 for m in LOOP_ONLY), got
    else:
        assert not set(LOOP_ONLY) & set(got), got
    assert sum(got[k] for k in ANY_ENTRY[:3]) <= got["train_step.host_ms"], got
