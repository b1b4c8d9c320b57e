"""The comparison that decides ``correct`` fails what it must: a run is driven
on the CPU at a small size, past the harness's look for a card, with the
timed path broken underneath, and ``correct`` comes out false; the sound
run passes, and the control (the reference in fp8) fails.

At (32, 48) the program runs in fp32 here, so that a sound run agrees with
the reference to fp32 rounding and the limits below (set for this size,
from the readings in ``PERF.md``) separate it from each fault.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark import cell as C  # noqa: E402
from benchmark import check, faults, spec  # noqa: E402

# small-size limits: sound fp32 runs read grad <= 0.012, grad_head <= 1e-5,
# grad_units <= 9e-4, update <= 0.03, bn_stats <= 1e-5 and bn_input <=
# 2e-7; the fp8 control reads bn_stats ~0.23, half a batch bn_input >=
# 0.04, every gradient scaled by 1.3 grad_head 0.3, the pointwise one
# grad_units 0.3, the fused backward's dx scaled by 1.3 grad ~27
LIMITS = {"grad": 3.0, "grad_head": 0.03, "grad_units": 0.07, "update": 0.25,
          "bn_stats": 0.06, "bn_input": 0.0065}
OVERRIDES = {"cfg": {"image_size": [32, 48], "compute_dtype": "float32"},
             "traffic": {"samples_per_rank": 8, "max_steps": 64},
             "warmup_steps": 1, "timing_steps": 1, "capture_steps": 1, "limits": LIMITS}
SEED = 2 ** 33 + 12345


def small_run(cell: str = "os16-loop-b2", world: int = 1) -> dict:
    return C.run_rank(cell, SEED, 0.1, False, 0, world, time.time(), device="cpu",
                      overrides=OVERRIDES)


def test_sound_run_is_correct():
    result = small_run()
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"peak_mem_gib", "setup_s"}  # the loop holds no rate


def test_a_traced_loop_run_reads_the_loop_rate():
    """The loop cell's per-layer line: its rate and step time among the
    metrics its manifest entries give it, and nothing else."""
    result = C.run_rank("os16-loop-b2", SEED, 0.1, True, 0, 1, time.time(), device="cpu",
                        overrides=OVERRIDES)
    assert result["correct"], result["checks"]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert got["samples_per_s_per_gpu.loop"] > 0 and got["step_ms_p90.loop"] > 0, got
    listed = {m["name"] for m in spec.cell_metrics(spec.manifest(), "os16-loop-b2",
                                                    "per_layer")}
    assert set(got) <= listed and "samples_per_s_per_gpu" not in got


def test_unchanged_state_fails():
    """A step that leaves the parameters as they were."""
    with faults.unchanged_state():
        result = small_run()
    assert not result["correct"]
    assert result["checks"]["update"]["value"] > LIMITS["update"]


def test_half_batch_fails():
    """A step that leaves out half of its batch, the mean taken over the
    rest."""
    with faults.half_batch():
        result = small_run()
    assert not result["correct"]


@pytest.mark.parametrize("fault", ["grad_scaled", "dpw_scaled", "dx_scaled"])
def test_scaled_gradients_fail(fault):
    """Gradients with the right signs and the wrong size: every gradient,
    or the fused backward's pointwise-weight or input gradient where it is
    made.  LAMB's first update and its trust ratio hide the first two from
    ``update``."""
    with faults.FAULTS[fault]():
        result = small_run()
    assert not result["correct"], result["checks"]


def test_control_fails():
    """The reference in fp8 put in the program's place fails a number that
    the program passes."""
    from benchmark.reference.quant import fp8_e4m3

    run = C.Run("os16-loop-b2", SEED, 0, 1, torch.device("cpu"), OVERRIDES)
    ref = C.reference_readings(run)
    control = C.reference_readings(run, quant=fp8_e4m3)
    checks = check.judge(check.numbers(control, ref, run.cfg), LIMITS)
    assert not check.passed(checks), checks


RANK = """
import json, sys, time
sys.path.insert(0, {repo!r})
from benchmark.tests.test_bench_faults import OVERRIDES, SEED
from benchmark import cell as C
from benchmark.faults import no_exchange
import contextlib
with no_exchange() if {broken} else contextlib.nullcontext():
    r = C.run_rank("os16-loop-b2", SEED, 0.1, False, {rank}, 2, time.time(),
                   device="cpu", overrides=OVERRIDES)
if {rank} == 0:
    print(json.dumps(r))
"""


def two_ranks(tmp_path, broken: bool) -> dict:
    """The loop cell's run as a two-rank data-parallel job on gloo."""
    from benchmark.run import free_port

    port = free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="2")
        code = RANK.format(repo=str(REPO), broken=broken, rank=r)
        log = open(tmp_path / f"rank{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                                       stdout=subprocess.PIPE if r == 0 else log,
                                       stderr=log, text=True), log))
    out, _ = procs[0][0].communicate(timeout=600)
    for p, log in procs:
        p.wait(timeout=60)
        log.close()
        assert p.returncode == 0, (tmp_path / "rank0.log").read_text()[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("broken", [False, True], ids=["exchanged", "not_exchanged"])
def test_exchange_between_ranks(tmp_path, broken):
    """Two ranks pass; without the exchange between them they fail."""
    result = two_ranks(tmp_path, broken)
    assert result["correct"] is not broken, result["checks"]
