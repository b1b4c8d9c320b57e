"""Device activities of a ``torch.profiler`` Chrome trace, each with its
kernel family and module scope (copied from
``deepcam_tpu_torch/profiling/op_table.py`` at commit 2718cf8).

Changed from the original: ``load_device_ops`` takes the trace's events and
the ``ModuleScopes`` record directly (not a file with the record in its
metadata), returns the module path itself as the scope, keeps each
activity's start, duration and device, and counts no FLOPs or bytes (the
benchmark counts work on its own reference).

A kernel's launch (its ``cuda_runtime``/``cuda_driver`` event, by
correlation id; the port's ctypes launches have one too) gives the host
thread and time.  In the forward the innermost module range around it names
the module; in the backward, which runs on autograd's own thread, the
autograd node around the launch (``evaluate_function``) has a sequence
number, and the module whose forward call created that node names it.
"""

from __future__ import annotations

import bisect
from typing import Dict, List

_CONV_OPS = {"aten::cudnn_convolution", "aten::cudnn_convolution_transpose",
             "aten::convolution_backward", "aten::_convolution", "aten::convolution",
             "aten::conv2d", "aten::conv_transpose2d"}
_GEMM_OPS = {"aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::matmul",
             "aten::linear"}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


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


class Intervals:
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


def load_device_ops(events: List[dict], calls: List[list]) -> List[dict]:
    """One row per device activity of ``events`` (a Chrome trace's
    ``traceEvents``): name, category (family), ts and dur (microseconds),
    device, and scope (the module path, "" where none is found).
    ``calls``: ``ModuleScopes.calls``, ``[seq_lo, seq_hi, path]`` per
    module call."""
    launches: Dict[int, tuple] = {}
    ops_by_ext: Dict[int, dict] = {}
    scopes, nodes = {}, {}
    module_paths = {c[2] for c in calls}
    for e in events:
        cat, args = e.get("cat"), e.get("args", {})
        if e.get("ph") != "X":
            continue
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = (e["tid"], e["ts"])
        elif cat == "cpu_op":
            if "External id" in args:
                ops_by_ext[args["External id"]] = e
            if e["name"].startswith("autograd::engine::evaluate_function") and \
                    "Sequence number" in args:
                nodes.setdefault(e["tid"], []).append(
                    (e["ts"], e["ts"] + e["dur"], args["Sequence number"]))
        elif cat == "user_annotation" and e["name"] in module_paths:
            scopes.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e["dur"], e["name"]))
    scopes, nodes = ({t: Intervals(v) for t, v in d.items()} for d in (scopes, nodes))
    # autograd sequence number -> innermost module whose call created it
    seq_module: Dict[int, str] = {}
    for lo, hi, mpath in sorted(calls, key=lambda c: c[0] - c[1]):
        for s in range(lo, hi):
            seq_module[s] = mpath

    rows = []
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X" or cat not in DEVICE_CATS:
            continue
        args = e.get("args", {})
        op = ops_by_ext.get(args.get("External id"), {})
        launch = launches.get(args.get("correlation"))
        if launch is None and op:
            launch = (op["tid"], op["ts"])
        module = None
        if launch is not None:
            tid, ts = launch
            if tid in scopes:
                module = scopes[tid].innermost(ts)
            if module is None and tid in nodes:
                seq = nodes[tid].innermost(ts)
                module = seq_module.get(seq) if seq is not None else None
        rows.append({"name": e["name"], "category": kernel_family(e["name"], cat,
                                                                  op.get("name", "")),
                     "ts": float(e["ts"]), "dur": float(e.get("dur", 0.0)),
                     "device": args.get("device", 0), "scope": module or ""})
    return rows
