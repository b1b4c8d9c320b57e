"""Per-kernel and per-family device-time report from a ``torch.profiler``
trace (counterpart of ``analysis/op_profile.py``).

    python -m deepcam_tpu_torch.profiling.op_profile LOGDIR_OR_TRACE [--top N]
        [--total] [--csv out.csv]

Point it at a trace file or the directory ``cli/profile.py --profile``
wrote (``<output_dir>/trace/<run_tag>``; the newest trace is taken).  It
prints the device time by kernel family, by module scope (with the
unattributed share), and the per-kernel table (name, time, invocations,
time avg, achieved TFLOP/s, flop/byte), per traced step.
"""

from __future__ import annotations

import argparse
import csv
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace", help="trace directory or *.trace.json[.gz] file")
    ap.add_argument("--top", type=int, default=30,
                    help="rows in the per-kernel table (default 30)")
    ap.add_argument("--total", action="store_true",
                    help="report totals over the trace instead of per step")
    ap.add_argument("--csv", default=None, help="also write the FULL per-kernel table here")
    pargs = ap.parse_args(argv)

    from .op_table import (category_table, format_table, load_device_ops, op_table,
                           per_step, scope_table, unattributed_share)

    ops = load_device_ops(pargs.trace)
    n_steps = ops.attrs["n_steps"]
    full, cats, scopes = op_table(ops), category_table(ops), scope_table(ops)
    steps = n_steps if not pargs.total and n_steps > 0 else 1
    if not pargs.total and n_steps > 0:
        full, cats, scopes = (per_step(t, n_steps) for t in (full, cats, scopes))
        where = f"per step ({n_steps} traced)"
    else:
        where = "trace total"

    if pargs.csv:
        with open(pargs.csv, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(full[0]) if full else ["name"])
            writer.writeheader()
            writer.writerows(full)

    region = ops.attrs["region_ms"] / steps
    print(f"== device time by kernel family [{where}] "
          f"(total {sum(cats.column('time_ms')):.2f} ms of {region:.2f} ms in the traced "
          f"regions)")
    print(format_table(cats))
    print(f"\n== device time by module scope [{where}] "
          f"(unattributed {100 * unattributed_share(ops):.1f}%)")
    print(format_table(scopes, pargs.top))
    print(f"\n== top {pargs.top} kernels by device time [{where}]")
    print(format_table(full, pargs.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
