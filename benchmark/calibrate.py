"""Readings from which a cell's limits are set (see ``check.py``).

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> [<n> ...]
        [--program-only] [--dump <dir>]

For each seed, in one process per rank: the program's three compared steps
(the same set-up as ``run.py``'s, without the window), and rank 0 reads
each side against the fp32 reference:

* ``program``: the program itself, the lower reading;
* ``control``: the reference computed with fp8 (e4m3) operands in every
  convolution, one step of precision below the configuration's bf16;
* ``bf16``: the reference with bf16 operands, a witness of what the
  program's precision alone moves;
* the faults of ``faults.py`` that the configuration's family lists
  (``families/<family>.py:faults``), planted in the program, and, on more
  than one card, ``no_exchange``.

Each side's numbers are judged with the workload's limits, as a run judges
them, and its line says whether it came out ``correct``.  A state left
unchanged reads 1 in ``update`` and needs no run.  ``--program-only``
reads the program alone.  ``--dump`` writes each seed's readings per
tensor and per BN statistic (norms, gaps, and the cosine of each side's
first gradient with the reference's) to ``<dir>/<cell>.<seed>.json``.
Each seed's numbers are one JSON line on standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def _cosines(side: dict, ref: dict) -> dict:
    out = {}
    for n, r in ref["grad1_t"].items():
        p = side["grad1_t"][n]
        den = float(p.double().norm() * r.double().norm())
        out[n] = float((p.double() * r.double()).sum()) / den if den > 0 else 0.0
    return out


def _dump(path: Path, sides: dict, ref: dict) -> None:
    from benchmark import check

    bn_names = sorted(ref[check.BUFFERS])
    rows = {"grad": {n: {"ref": ref["grad1"][n],
                         **{k: s["grad1"][n] for k, s in sides.items()}}
                     for n in sorted(ref["grad1"])},
            "cos": {k: s["cos"] for k, s in sides.items() if "cos" in s},
            "delta": {n: {"ref": ref["delta"][n],
                          **{k: s["delta"][n] for k, s in sides.items()}}
                      for n in sorted(ref["delta"])},
            "bn": {n: {"ref": float(ref[check.BUFFERS][n].double().norm()),
                       **{k: float((s[check.BUFFERS][n].double()
                                    - ref[check.BUFFERS][n].double()).norm())
                          for k, s in sides.items()}}
                   for n in bn_names},
            "loss": {"ref": ref["loss"], **{k: s["loss"] for k, s in sides.items()}}}
    path.write_text(json.dumps(rows))


def program_side(run, fault: str = "", keep: bool = False) -> dict:
    """The program's readings of the compared steps, with ``fault``
    planted (see ``faults.py``)."""
    from benchmark import cell as C
    from benchmark.faults import FAULTS

    with FAULTS[fault]() if fault else contextlib.nullcontext():
        feed = run.entry.Feed(run)
        state, step_fn = C.build_program(run)
        out = C.compared_steps(run, state, step_fn, feed, keep)
        feed.close()
    del state, step_fn, feed
    C.free_memory()
    return out


def calibrate_rank(cell: str, seeds, rank: int, world: int, program_only: bool,
                   dump) -> None:
    from benchmark import cell as C
    from benchmark import check
    from benchmark.reference.quant import bf16, fp8_e4m3
    from deepcam_tpu_torch.core.mesh import destroy_distributed, device_for, init_distributed

    device = device_for("cuda")
    created = init_distributed("auto", "cuda") if world > 1 else False
    keep = dump is not None and rank == 0
    try:
        for seed in seeds:
            t0 = time.time()
            run = C.Run(cell, seed, rank, world, device)
            limits = run.wl.get("limits", {})
            faults = [] if program_only else run.family.faults(run.cfg) + (
                ["no_exchange"] if world > 1 else [])
            sides = {"program": program_side(run, keep=keep)}
            for fault in faults:
                sides[fault] = program_side(run, fault, keep)
            if world > 1:
                C.barrier(device)
            if rank == 0:
                t1 = time.time()
                ref = C.reference_readings(run, keep=keep)
                if not program_only:
                    sides["control"] = C.reference_readings(run, quant=fp8_e4m3, keep=keep)
                    sides["bf16"] = C.reference_readings(run, quant=bf16, keep=keep)
                line = {"cell": cell, "seed": seed}
                for name, side in sides.items():
                    nums = check.numbers(side, ref, run.cfg)
                    line[name] = {**nums, "correct": check.passed(check.judge(nums, limits))}
                    if keep:
                        side["cos"] = _cosines(side, ref)
                        side.pop("grad1_t")
                line["worst"] = {k: check.worst(sides["program"], ref, k, 3)
                                 for k in ("grad1", "delta", "bn")}
                line["loss"] = {"program": sides["program"]["loss"], "reference": ref["loss"]}
                line["seconds"] = {"program": t1 - t0, "references": time.time() - t1}
                if keep:
                    _dump(Path(dump) / f"{cell}.{seed}.json", sides, ref)
                print(json.dumps(line), flush=True)
                del ref
            del sides
            C.free_memory()
            if world > 1:
                C.barrier(device)
    finally:
        if created:
            destroy_distributed()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program-only", action="store_true")
    ap.add_argument("--dump", default=None)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    from benchmark import spec
    from benchmark.run import launch_ranks

    world = spec.cell_entry(spec.manifest(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print(f"cell {args.workload} needs {world} CUDA card(s)", file=sys.stderr)
        return 4
    if args.dump:
        Path(args.dump).mkdir(parents=True, exist_ok=True)
    if world > 1 and args.rank is None:
        argv = ["--workload", args.workload, "--seeds", *map(str, args.seeds)]
        if args.program_only:
            argv.append("--program-only")
        if args.dump:
            argv += ["--dump", args.dump]
        return launch_ranks(Path(__file__).resolve(), argv, world)
    calibrate_rank(args.workload, args.seeds, args.rank or 0, world, args.program_only,
                   args.dump)
    return 0


if __name__ == "__main__":
    sys.exit(main())
