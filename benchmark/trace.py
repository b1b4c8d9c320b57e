"""Reading the traced steps of a ``--trace 1`` run: the device activities
of the capture (through the frozen ``op_table``), the device's busy time,
the idle gaps labelled with the benchmark's own host span, and the table of
device operations.

Host spans are ``record_function`` ranges named ``bench.<span>``
(``bench.next``: blocked on the next batch; ``bench.step``: inside the
train step's call; ``bench.log``: reading loss and IoU to the host;
``bench.sync``: the synchronize that closes the capture), all inside
``bench.capture``.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Tuple

from .frozen.op_table import Intervals, load_device_ops

CAPTURE = "bench.capture"


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def clip(intervals, lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def subtract(a, b):
    """Parts of the disjoint sorted intervals ``a`` not covered by ``b``."""
    b = union(b)
    out = []
    for s, e in a:
        cur = s
        for bs, be in b:
            if be <= cur or bs >= e:
                continue
            if bs > cur:
                out.append((cur, bs))
            cur = max(cur, be)
        if cur < e:
            out.append((cur, e))
    return out


def export_events(prof) -> List[dict]:
    """The profiler's Chrome trace events, through a file under TMPDIR
    that is removed after reading."""
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def read_capture(events: List[dict], calls: List[list]) -> Dict:
    """The capture's window (start, end in microseconds), its device rows
    clipped to it, and the host spans inside it."""
    spans, window = [], None
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and e["name"].startswith("bench."):
            if e["name"] == CAPTURE:
                window = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            else:
                spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                              e["name"][len("bench."):]))
    if window is None:
        raise RuntimeError("the trace holds no capture range")
    lo, hi = window
    rows = [r for r in load_device_ops(events, calls)
            if r["ts"] + r["dur"] > lo and r["ts"] < hi]
    return {"window": window, "rows": rows, "spans": spans}


def busy(rows, window) -> List[Tuple[float, float]]:
    """The union of the rows' device intervals inside the window."""
    return union(clip([(r["ts"], r["ts"] + r["dur"]) for r in rows], *window))


def breakdown(cap: Dict, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time in the capture, and the
    longest idle gaps, each named by the host span its middle falls in."""
    per_op: Dict[str, float] = {}
    for r in cap["rows"]:
        per_op[r["name"]] = per_op.get(r["name"], 0.0) + r["dur"] * 1e-6
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = cap["window"]
    gaps = subtract([(lo, hi)], busy(cap["rows"], cap["window"]))
    host = Intervals(cap["spans"])
    named = [[host.innermost((s + e) / 2) or "other", (e - s) * 1e-6] for s, e in gaps]
    named.sort(key=lambda g: -g[1])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named[:top]}
