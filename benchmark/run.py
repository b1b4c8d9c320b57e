"""Runs one cell of the port's benchmark once and prints one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics.  A cell on more than one
card starts one rank process per card with torchrun's variables set, on a
free localhost port, and rank 0 prints the line.  The run needs as many
CUDA cards as the cell asks for: without them it exits with code 4 and
prints no result.  It exits with code 1 and prints no result when the run
loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

T0 = time.time()  # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# builds and kernel caches stay inside the checkout, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR", str(REPO / "bench_cache" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(REPO / "bench_cache" / "torch_extensions"))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(script: Path, argv: list, world: int) -> int:
    """Starts ``world`` processes of ``script`` with ``argv`` and
    ``--rank r``, with torchrun's variables set (and one OpenMP thread, as
    torchrun sets it), and waits for all of them; a rank that fails stops
    the others.  Rank 0 writes to this process's standard output, the
    others to its standard error."""
    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
        env.setdefault("OMP_NUM_THREADS", "1")
        procs.append(subprocess.Popen([sys.executable, str(script), *argv, "--rank", str(r)],
                                      env=env,
                                      stdout=None if r == 0 else sys.stderr.fileno()))
    rc = 0
    try:
        while any(p.poll() is None for p in procs):
            bad = [p.returncode for p in procs if p.returncode not in (None, 0)]
            if bad:
                rc = bad[0]
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    return rc or max(p.returncode for p in procs)


def print_result(result: dict) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error (a limit whose number the run did not produce as "not
    produced"), then the result as the last line of standard output."""
    for name, c in result["checks"].items():
        value = "not produced" if c["value"] is None else repr(c["value"])
        print(f"check {name}: {value} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from benchmark import spec

    chips = spec.cell_entry(spec.manifest(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cell {args.workload} needs {chips} CUDA card(s); {n} found",
              file=sys.stderr)
        return 4
    if chips > 1 and args.rank is None:
        argv = ["--workload", args.workload, "--seed", str(args.seed), "--seconds",
                str(args.seconds), "--trace", str(args.trace), "--t0", repr(T0)]
        return launch_ranks(Path(__file__).resolve(), argv, chips)
    from benchmark.cell import run_rank

    rank = args.rank or 0
    result = run_rank(args.workload, args.seed, args.seconds, bool(args.trace), rank, chips,
                      args.t0 if args.t0 is not None else T0)
    if rank == 0:
        print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
