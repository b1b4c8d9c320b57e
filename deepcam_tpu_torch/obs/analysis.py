"""Post-hoc analysis of MLPerf training logs (counterpart of
``deepcam_tpu/obs/analysis.py``): the loss, accuracy and learning-rate
curves of a ``:::MLLOG`` run against time and step, and whether and when
``target_accuracy_reached`` fired.  Plain dicts and lists; pandas only in
``to_dataframe``.
"""

from __future__ import annotations

from typing import Dict, List

from .mlperf_log import parse_mllog


def extract_series(records: List[dict], key: str):
    """[(time_ms, step_num, value)] for every event of ``key``."""
    return [(r["time_ms"], r.get("metadata", {}).get("step_num"), r.get("value"))
            for r in records if r["key"] == key]


def run_summary(path: str) -> Dict:
    """Summary of a training run's log: wall time, curves, convergence."""
    records = parse_mllog(path)
    by_key: Dict[str, List[dict]] = {}
    for r in records:
        by_key.setdefault(r["key"], []).append(r)

    def first_time(key):
        return by_key[key][0]["time_ms"] if key in by_key else None

    run_start, run_stop = first_time("run_start"), first_time("run_stop")
    target = by_key.get("target_accuracy_reached")
    return {
        "run_start_ms": run_start,
        "run_stop_ms": run_stop,
        "wall_seconds": (run_stop - run_start) / 1e3 if run_start and run_stop else None,
        **{k: extract_series(records, k) for k in ("train_loss", "train_accuracy",
                                                  "eval_loss", "eval_accuracy",
                                                  "learning_rate")},
        "global_batch_size": by_key.get("global_batch_size", [{}])[0].get("value"),
        "target_accuracy_reached": bool(target),
        "target_step": target[0].get("metadata", {}).get("step_num") if target else None,
        "epochs": len(by_key.get("epoch_start", [])),
    }


def to_dataframe(path: str):
    """The whole log as a pandas DataFrame (needs pandas), one row per
    record, its metadata in ``md_*`` columns."""
    import pandas as pd

    rows = []
    for r in parse_mllog(path):
        row = {k: r[k] for k in ("time_ms", "event_type", "key", "value")}
        row.update({f"md_{k}": v for k, v in r.get("metadata", {}).items()})
        rows.append(row)
    return pd.DataFrame(rows)
