"""Per-kernel device-time tables from a ``torch.profiler`` Chrome trace
(counterpart of ``deepcam_tpu/profiling/op_table.py``, which reads xprof's).

Parity targets: the reference's nsight importers (``analysis/utils.py``:
per-kernel {Name, Time, Invocations, Time Avg} and metric means) and the
notebook that rolls them up by op and by category.  The source here is the
trace ``profiling/profiler.py:Profile`` writes (or any ``torch.profiler``
trace with CUDA activity).  One row per device activity instance (kernel,
memcpy, memset) with the columns of the JAX tables:

* ``name``, ``time_ms``: the kernel's name and device time;
* ``category``: its kernel family, one of ``FAMILIES``, from its name and
  the aten op that launched it;
* ``flops``, ``bytes``: a fused sepconv unit's analytic count
  (``profiler.unit_counts``; forward on ``sepconv_fwd_kernel``, the
  backward's dd and d_pw GEMMs on theirs, dx/d_dw with the backward's bytes
  on ``dx_ddw_kernel``); else the FLOPs of the innermost op around the
  launch that the profiler's ``with_flops`` counted (``aten::conv2d``
  around the cuDNN call; ``Profile`` writes them into the trace by External
  id, since the Chrome trace leaves them out), on that op's first conv or
  GEMM kernel (else its first kernel), and the input bytes of the
  launching op from its recorded shapes on the op's first kernel (outputs
  are not in the trace);
* ``scope``: ``<region>/<module path>``, the module path named like the JAX
  parameter tree (``Backward/xception/block4/sepconv1``), as the JAX
  ``tf_op`` path is ``<jit root>/<scope>``; "" where no module is found.

A kernel's launch (its ``cuda_runtime``/``cuda_driver`` event, by
correlation id; the port's ctypes launches have one too) gives the host
thread and time.  In the forward the innermost ``ModuleScopes`` range
around it names the module; in the backward, which runs on autograd's own
thread, the autograd node around the launch (``evaluate_function``) has a
sequence number, and the module whose forward call created that node
(``ModuleScopes``' record in the trace metadata) names it.  The ``Steps``
track of xprof becomes the ``ProfilerStep#N`` annotations or, without them,
the traced ``Profile`` regions.

The tables are plain rows (``Table``, a list of dicts); ``to_dataframe``
turns one into pandas, imported there only.
"""

from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence

from .profiler import REGIONS, SCOPES_KEY, unit_counts

FAMILIES = ("sepconv (hand-written)", "cudnn conv", "gemm", "elementwise", "reduction",
            "memcpy/memset", "nccl", "other")
UNATTRIBUTED = "(unattributed)"
_CONV_OPS = {"aten::cudnn_convolution", "aten::cudnn_convolution_transpose",
             "aten::convolution_backward", "aten::_convolution", "aten::convolution",
             "aten::conv2d", "aten::conv_transpose2d"}
_GEMM_OPS = {"aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::matmul",
             "aten::linear"}
_ELEMENT_BYTES = {"float": 4, "double": 8, "c10::BFloat16": 2, "c10::Half": 2, "int": 4,
                  "long int": 8, "short int": 2, "bool": 1, "unsigned char": 1,
                  "signed char": 1}


class Table(list):
    """Rows as dicts, in order; ``key`` names the column that names a row,
    ``attrs`` carries table-wide values (``n_steps``)."""

    def __init__(self, rows: Iterable[dict] = (), key: Optional[str] = None,
                 attrs: Optional[dict] = None):
        super().__init__(rows)
        self.key = key
        self.attrs = dict(attrs or {})

    def column(self, col: str) -> list:
        return [r[col] for r in self]

    def head(self, n: Optional[int]) -> "Table":
        return Table(self[:n] if n else self, self.key, self.attrs)


def to_dataframe(table: Table):
    """``table`` as a pandas DataFrame indexed by its key column."""
    import pandas as pd

    df = pd.DataFrame(list(table))
    return df.set_index(table.key) if table.key else df


def format_table(table: Table, top: Optional[int] = None) -> str:
    """Fixed-width text of ``table``'s first ``top`` rows, names cut to 60
    characters."""
    rows = table.head(top)
    if not rows:
        return "(no rows)"
    cols = list(rows[0])
    cells = [[str(c) for c in cols]]
    for r in rows:
        cells.append([f"{v:.3f}" if isinstance(v, float) else str(v)[:60]
                      for v in r.values()])
    widths = [max(len(row[i]) for row in cells) for i in range(len(cols))]
    return "\n".join("  ".join(c.ljust(w) if i == 0 else c.rjust(w)
                               for i, (c, w) in enumerate(zip(row, widths)))
                     for row in cells)


def find_trace(path: str) -> str:
    """``path`` itself if it is a file, else the newest ``*.trace.json`` or
    ``*.trace.json.gz`` under it (the logdir given to ``Profile``, or any
    ancestor)."""
    if os.path.isfile(path):
        return path
    hits = [p for pat in ("*.trace.json", "*.trace.json.gz")
            for p in glob.glob(os.path.join(path, "**", pat), recursive=True)]
    if not hits:
        raise FileNotFoundError(f"no *.trace.json[.gz] under {path}")
    return max(hits, key=os.path.getmtime)


def _read(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def kernel_family(name: str, cat: str = "kernel", op: str = "") -> str:
    """The family of a device activity: ``cat`` is its trace category and
    ``op`` the aten op that launched it ("" if unknown)."""
    lname = name.lower()
    if cat in ("gpu_memcpy", "gpu_memset") or lname.startswith(("memcpy", "memset")):
        return "memcpy/memset"
    if "dsc::" in name or "row_windows_kernel" in name:
        return "sepconv (hand-written)"
    if "nccl" in lname:
        return "nccl"
    if op in _CONV_OPS or any(k in lname for k in ("conv", "fprop", "dgrad", "wgrad",
                                                   "cudnn")):
        return "cudnn conv"
    if op in _GEMM_OPS or "gemm" in lname or "cutlass" in lname:
        return "gemm"
    if "reduce" in lname or "norm" in lname:
        return "reduction"
    if any(k in lname for k in ("elementwise", "multi_tensor_apply", "catarray", "copy")):
        return "elementwise"
    return "other"


class _Intervals:
    """Host-thread intervals (start, end, value) for innermost-containing
    lookups; properly nested or disjoint, as one thread's ranges are."""

    def __init__(self, items: List[tuple]):
        self.items = sorted(items)
        self.starts = [it[0] for it in self.items]

    def innermost(self, ts: float):
        i = bisect.bisect_right(self.starts, ts) - 1
        while i >= 0:
            start, end, value = self.items[i]
            if end >= ts:
                return value
            i -= 1
        return None


def _input_bytes(args: dict) -> float:
    total = 0
    for dims, typ in zip(args.get("Input Dims", []), args.get("Input type", [])):
        size = _ELEMENT_BYTES.get(typ)
        if size and dims and all(isinstance(d, int) for d in dims):
            n = 1
            for d in dims:
                n *= d
            total += n * size
    return float(total)


def _unit_work(name: str, unit: Sequence) -> tuple:
    """(flops, bytes) of a fused unit's kernel: see the module docstring."""
    p, c, f, form = unit
    w = unit_counts(form, p, c, f)
    if "sepconv_fwd_kernel" in name:
        return float(w["fwd_flops"]), float(w["fwd_bytes"])
    if "dd_kernel" in name or "dpw_kernel" in name:
        return float(2 * p * c * f), 0.0
    if "dx_ddw_kernel" in name:
        return float(36 * p * c), float(w["bwd_bytes"])
    return 0.0, 0.0


def load_device_ops(path: str) -> Table:
    """One row per device activity instance of the trace at ``path`` (a file
    or a directory, see ``find_trace``); ``attrs["n_steps"]`` is the number
    of traced steps (0 if the trace shows none), ``attrs["region_ms"]`` the
    host wall time of the traced regions."""
    trace = _read(find_trace(path))
    meta = trace.get(SCOPES_KEY) or {}
    if isinstance(meta, str):
        meta = json.loads(meta)
    calls = meta.get("calls", [])
    flops_by_ext = meta.get("flops", {})
    events = trace["traceEvents"]

    launches: Dict[int, tuple] = {}
    ops_by_ext: Dict[int, dict] = {}
    scopes, nodes, flop_ops, regions = {}, {}, {}, []
    module_paths = {c[2] for c in calls}
    units = {c[2]: c[3] for c in calls if c[3]}
    n_profiler_steps = 0
    for e in events:
        cat, args = e.get("cat"), e.get("args", {})
        if e.get("ph") != "X":
            continue
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = (e["tid"], e["ts"])
        elif cat == "cpu_op":
            if "External id" in args:
                ops_by_ext[args["External id"]] = e
            op_flops = flops_by_ext.get(str(args.get("External id")))
            if op_flops:
                flop_ops.setdefault(e["tid"], []).append(
                    (e["ts"], e["ts"] + e["dur"], (args["External id"], float(op_flops))))
            if e["name"].startswith("autograd::engine::evaluate_function") and \
                    "Sequence number" in args:
                nodes.setdefault(e["tid"], []).append(
                    (e["ts"], e["ts"] + e["dur"], args["Sequence number"]))
        elif cat == "user_annotation":
            if e["name"].startswith("ProfilerStep#"):
                n_profiler_steps += 1
            elif e["name"] in REGIONS:
                regions.append((e["ts"], e["ts"] + e["dur"], e["name"]))
            elif e["name"] in module_paths:
                scopes.setdefault(e["tid"], []).append(
                    (e["ts"], e["ts"] + e["dur"], e["name"]))
    scopes, nodes, flop_ops = ({t: _Intervals(v) for t, v in d.items()}
                               for d in (scopes, nodes, flop_ops))
    region_of = _Intervals(regions)
    # autograd sequence number -> innermost module whose call created it
    seq_module: Dict[int, str] = {}
    for lo, hi, mpath, _ in sorted(calls, key=lambda c: c[0] - c[1]):
        for s in range(lo, hi):
            seq_module[s] = mpath

    rows, charged, counted_rows = [], set(), {}
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X" or cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        args = e.get("args", {})
        ext = args.get("External id")
        op = ops_by_ext.get(ext, {})
        launch = launches.get(args.get("correlation"))
        if launch is None and op:
            launch = (op["tid"], op["ts"])
        module = counted = None
        if launch is not None:
            tid, ts = launch
            if tid in flop_ops:
                counted = flop_ops[tid].innermost(ts)
            if tid in scopes:
                module = scopes[tid].innermost(ts)
            if module is None and tid in nodes:
                seq = nodes[tid].innermost(ts)
                module = seq_module.get(seq) if seq is not None else None
        region = region_of.innermost(launch[1]) if launch is not None else None
        name = e["name"]
        family = kernel_family(name, cat, op.get("name", ""))
        flops = nbytes = 0.0
        if family == "sepconv (hand-written)" and module in units:
            flops, nbytes = _unit_work(name, units[module])
        else:
            if op and ext not in charged:
                charged.add(ext)
                nbytes = _input_bytes(op.get("args", {}))
            if counted is not None:
                counted_rows.setdefault(counted, []).append(len(rows))
        rows.append({"name": name, "category": family, "time_ms": float(e.get("dur", 0.0)) * 1e-3,
                     "flops": flops, "bytes": nbytes,
                     "scope": f"{region or 'trace'}/{module}" if module else ""})
    # a counted op's FLOPs go to its first conv or GEMM kernel, else to its
    # first kernel (an op may cast or transpose before its product)
    for (_, op_flops), idx in counted_rows.items():
        main = [i for i in idx if rows[i]["category"] in ("cudnn conv", "gemm")]
        rows[(main or idx)[0]]["flops"] = op_flops
    traced = [r for r in regions if r[2] == meta.get("region", r[2])]
    return Table(rows, attrs={"n_steps": n_profiler_steps or len(traced),
                              "region_ms": sum(end - start for start, end, _ in traced) * 1e-3})


def _aggregate(ops: Table, key: str, keyed: Sequence[str]) -> Table:
    groups: Dict[str, dict] = {}
    for r in ops:
        g = groups.get(r[key])
        if g is None:
            g = groups[r[key]] = {key: r[key], **{k: r[k] for k in keyed},
                                  "time_ms": 0.0, "invocations": 0, "flops": 0.0,
                                  "bytes": 0.0}
        g["time_ms"] += r["time_ms"]
        g["invocations"] += 1
        g["flops"] += r["flops"]
        g["bytes"] += r["bytes"]
    return Table(groups.values(), key, ops.attrs)


def _with_pct(table: Table) -> Table:
    total = max(sum(table.column("time_ms")), 1e-9)
    for r in table:
        r["time_pct"] = 100.0 * r["time_ms"] / total
    table.sort(key=lambda r: -r["time_ms"])
    return table


def op_table(ops: Table, top: Optional[int] = None) -> Table:
    """Per kernel name: category, time_ms, invocations, flops, bytes,
    time_avg_ms, tflops (achieved) and flop_per_byte, by time."""
    out = _aggregate(ops, "name", ("category",))
    for r in out:
        r["time_avg_ms"] = r["time_ms"] / r["invocations"]
        r["tflops"] = r["flops"] / (max(r["time_ms"], 1e-9) / 1e3) / 1e12
        r["flop_per_byte"] = r["flops"] / max(r["bytes"], 1.0)
    out.sort(key=lambda r: -r["time_ms"])
    return out.head(top)


def category_table(ops: Table) -> Table:
    """By kernel family: time_ms, invocations, flops, bytes, time_pct."""
    return _with_pct(_aggregate(ops, "category", ()))


def scope_table(ops: Table, depth: int = 3) -> Table:
    """By model scope truncated to ``depth`` path components after the
    region root (``xception/block4/sepconv1``); kernels without a module
    are ``(unattributed)``.  Columns as ``category_table``'s, keyed
    ``module``."""
    def trunc(s: str) -> str:
        if not s:
            return UNATTRIBUTED
        parts = s.split("/")
        return "/".join(parts[1:1 + depth]) or parts[0]

    return _with_pct(_aggregate(
        Table(({**r, "module": trunc(r["scope"])} for r in ops), attrs=ops.attrs),
        "module", ()))


def unattributed_share(ops: Table) -> float:
    """The fraction of device time in kernels without a module scope."""
    total = sum(ops.column("time_ms"))
    return sum(r["time_ms"] for r in ops if not r["scope"]) / total if total else 0.0


def per_step(table: Table, n_steps: int) -> Table:
    """``table`` with time_ms, flops, bytes and invocations per step."""
    if n_steps <= 0:
        return table
    return Table(({k: (v / n_steps if k in ("time_ms", "flops", "bytes", "invocations")
                       else v) for k, v in r.items()} for r in table),
                 table.key, table.attrs)
