"""Profiling: traced regions, module scopes, FLOP and byte counts, roofline
placement (counterpart of ``deepcam_tpu/profiling/profiler.py``).

Parity targets: the reference's ``Profile`` context manager
(``profile_hdf5_ddp.py:77-94``), which toggles the CUDA profiler for one of
Forward/Backward/Optimizer after warm-up, and its nsight roofline sweeps.
Here every region is a ``torch.profiler.record_function``; the target
region after warm-up is also traced with ``torch.profiler`` (CPU and CUDA
activities) into a Chrome trace, one per traced step, which
``profiling/op_table.py`` reads.

``ModuleScopes`` gives the trace its model scopes, named like the JAX
parameter tree (``xception/block4/sepconv1``): each module call is a
``record_function`` of its path, and the autograd sequence numbers its call
created are kept, so that a kernel of the backward (launched from an
autograd node on another thread, outside any forward range) is attributed
to the module whose forward made its node.  The ranges and each fused
unit's (P, C, F) go into the trace's metadata under ``SCOPES_KEY``.

``cost_analysis`` counts what XLA's cost model reports for a jitted
function: FLOPs through ``torch.utils.flop_counter.FlopCounterMode`` (2 per
multiply-add, for convs, transposed convs and GEMMs) and bytes as the
operand and result bytes of each aten op, through a ``TorchDispatchMode``.
Neither mode sees inside the fused sepconv units (on the card they are
ctypes launches, on the CPU their plain versions), so each unit adds its
analytic count (``unit_counts``) instead, through the hook
``ops/fused_sepconv.py`` calls only while a count runs.
"""

from __future__ import annotations

import gzip
import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..models.layers import SeparableConv2dSame
from ..ops import fused_sepconv as fs

# Peaks for roofline placement (per card): NVIDIA's data sheet, H100 SXM,
# dense, at the full 700 W power limit; the same peaks as chip_smoke.py.
GPU_PEAKS = {
    "h100-sxm": {"bf16_tflops": 989.0, "hbm_gbps": 3350.0},
}
# the trace metadata key of ModuleScopes' record
SCOPES_KEY = "deepcam_module_scopes"
# the phases of cli/profile.py, the regions a trace is taken of
REGIONS = ("Forward", "Backward", "Optimizer")


def unit_counts(form: str, p: int, c: int, f: int) -> Dict[str, float]:
    """Analytic work of one fused sepconv unit of this form on ``p`` pixels,
    C→F, bf16 activations: per direction, the GEMM FLOPs (the pointwise;
    the backward's dd and d_pw), the other FLOPs (the depthwise; the
    backward's dx and d_dw; the prologue and the statistics) and the bytes
    (each input read once, each output written once).  ``cost_analysis``
    adds ``fwd_flops``/``bwd_flops``, the multiply-adds FlopCounterMode
    would count, 2 each: 2·P·C·F + 18·P·C forward, 4·P·C·F + 36·P·C
    backward."""
    affine = form not in ("base", "stats")
    skip, stats = form.startswith("boundary"), form.endswith("stats")
    act_c, act_f = 2 * p * c, 2 * p * f  # one bf16 tensor of width C, F
    weights = 2 * (9 * c + c * f) + (4 * c if affine else 0)  # dwk, pwk[, a, b]
    pro = p * c * ((2 if affine else 0) + (1 if skip else 0) + 1)  # FMA, add, relu
    # forward: x[, skip] -> y, d[, r][, Σy, Σy²]
    fwd_bytes = (act_c * (2 if skip else 1) + weights + act_f + act_c
                 + (act_c if skip else 0) + (8 * f if stats else 0))
    # backward: x, g, d[, skip, gr][, y, gs1, gs2] -> dx, d_dw, d_pw[, da, db][, d_skip]
    bwd_bytes = (act_c * 3 + act_f + weights + (2 * act_c if skip else 0)
                 + (act_f + 8 * f if stats else 0)
                 + 4 * (9 * c + c * f) + (8 * c if affine else 0) + (act_c if skip else 0))
    return {
        "fwd_gemm_flops": 2 * p * c * f,
        "fwd_other_flops": 2 * 9 * p * c + pro + (3 * p * f if stats else 0),
        "fwd_bytes": fwd_bytes,
        "bwd_gemm_flops": 4 * p * c * f,
        "bwd_other_flops": (4 * 9 * p * c + 2 * pro + (4 * p * f if stats else 0)
                            + (4 * p * c if affine else 0)),
        "bwd_bytes": bwd_bytes,
        "fwd_flops": 2 * p * c * f + 18 * p * c,
        "bwd_flops": 4 * p * c * f + 36 * p * c,
    }


class _ByteCount(TorchDispatchMode):
    """Operand and result bytes of every aten op dispatched under it, ops
    inside a fused unit excepted (``depth`` > 0)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.depth = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.depth == 0:
            for t in torch.utils._pytree.tree_leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
        return out


class _UnitCount:
    """The hook ``ops/fused_sepconv.py`` calls around each unit while a
    count runs: the modes' own counts of the unit's inside are taken back
    out, and the unit's analytic count added."""

    def __init__(self, flops: FlopCounterMode, nbytes: _ByteCount):
        self.flops, self.nbytes = flops, nbytes
        self.unit_flops = 0
        self.unit_bytes = 0
        self.inner_flops = 0

    def enter(self):
        self.nbytes.depth += 1
        return self.flops.get_total_flops()

    def exit(self, token, form, p, c, f, backward):
        self.nbytes.depth -= 1
        self.inner_flops += self.flops.get_total_flops() - token
        counts = unit_counts(form, p, c, f)
        key = "bwd" if backward else "fwd"
        self.unit_flops += counts[f"{key}_flops"]
        self.unit_bytes += counts[f"{key}_bytes"]


def cost_analysis(fn: Callable, *args) -> Dict[str, float]:
    """FLOPs and bytes accessed of one call ``fn(*args)``: the counterpart
    of XLA's cost analysis (see the module docstring)."""
    flops, nbytes = FlopCounterMode(display=False), _ByteCount()
    units = _UnitCount(flops, nbytes)
    fs.UNIT_COUNTERS.append(units)
    try:
        with flops, nbytes:
            fn(*args)
    finally:
        fs.UNIT_COUNTERS.remove(units)
    return {
        "flops": float(flops.get_total_flops() - units.inner_flops + units.unit_flops),
        "bytes_accessed": float(nbytes.bytes + units.unit_bytes),
    }


@dataclass
class RooflineReport:
    flops: float
    bytes_accessed: float
    seconds_per_call: float
    achieved_tflops: float
    achieved_gbps: float
    arithmetic_intensity: float
    tensor_core_utilization: float  # vs peak bf16
    hbm_utilization: float
    generation: str
    device: str

    def summary(self) -> str:
        return (
            f"[roofline/{self.generation}, {self.device}] {self.achieved_tflops:.1f} TF/s "
            f"({100 * self.tensor_core_utilization:.1f}% tensor-core peak), "
            f"{self.achieved_gbps:.0f} GB/s ({100 * self.hbm_utilization:.1f}% HBM), "
            f"AI={self.arithmetic_intensity:.1f} flop/byte, "
            f"{1e3 * self.seconds_per_call:.1f} ms/call"
        )


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return f"{device.type} (not a roofline device)"


def roofline(fn: Callable, *args, generation: str = "h100-sxm", iters: int = 5,
             device="cuda") -> RooflineReport:
    """Places ``fn(*args)`` on the card's roofline: its FLOPs and bytes from
    ``cost_analysis``, its wall time over ``iters`` calls after one warm-up,
    each run ended by a synchronize of ``device``, against the peaks of
    ``generation``.  On the CPU the numbers are computed all the same and
    say nothing of a card."""
    from ..utils.sync import host_sync

    device = torch.device(device)
    costs = cost_analysis(fn, *args)
    fn(*args)
    host_sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    host_sync(device)
    dt = (time.perf_counter() - t0) / iters
    peaks = GPU_PEAKS[generation]
    flops, nbytes = costs["flops"], costs["bytes_accessed"]
    achieved_tflops = flops / dt / 1e12
    achieved_gbps = nbytes / dt / 1e9
    return RooflineReport(
        flops=flops, bytes_accessed=nbytes, seconds_per_call=dt,
        achieved_tflops=achieved_tflops, achieved_gbps=achieved_gbps,
        arithmetic_intensity=flops / max(nbytes, 1.0),
        tensor_core_utilization=achieved_tflops / peaks["bf16_tflops"],
        hbm_utilization=achieved_gbps / peaks["hbm_gbps"],
        generation=generation, device=_device_name(device))


class ModuleScopes:
    """While entered, every call of a named submodule of ``model`` is a
    ``record_function`` of its path (``xception/block4/sepconv1``), and
    ``calls`` records ``[seq_lo, seq_hi, path, unit]`` per call: the
    autograd sequence numbers the call created, and for a stride-1 fused
    unit ``[P, C, F, form]`` (else None).  ``calls`` holds the last forward's:
    it is cleared when the root module's call begins."""

    def __init__(self, model: torch.nn.Module):
        self.model = model
        self.calls: List[list] = []
        self._open: List[tuple] = []
        self._handles: List = []

    def _pre(self, module, args, path):
        if path == "":
            self.calls, self._open = [], []
            return
        rf = torch.profiler.record_function(path)
        rf.__enter__()
        self._open.append((rf, torch._C._autograd._get_sequence_nr()))

    def _post(self, module, args, kwargs, out, path):
        if path == "":
            return
        rf, seq_lo = self._open.pop()
        rf.__exit__(None, None, None)
        unit = None
        if isinstance(module, SeparableConv2dSame) and module.stride == 1:
            x, boundary = args[0], kwargs.get("boundary")
            form = fs.form_name(kwargs.get("bn_fold") is not None or boundary is not None,
                                boundary is not None, bool(kwargs.get("emit_stats")))
            unit = [x.shape[0] * x.shape[2] * x.shape[3], x.shape[1],
                    module.pointwise.weight.shape[0], form]
        self.calls.append([seq_lo, torch._C._autograd._get_sequence_nr(), path, unit])

    def __enter__(self):
        for name, module in self.model.named_modules():
            path = name.replace(".", "/")
            self._handles.append(module.register_forward_pre_hook(
                lambda m, a, p=path: self._pre(m, a, p)))
            self._handles.append(module.register_forward_hook(
                lambda m, a, k, o, p=path: self._post(m, a, k, o, p), with_kwargs=True))
        return self

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()
        self._handles = []
        return False


class Profile:
    """Region-scoped profiler (parity: profile_hdf5_ddp.py ``Profile``).

    Every region is a ``torch.profiler.record_function(name)``.  When
    ``name == target`` and ``step >= warmup_steps`` (and ``logdir`` is set)
    the region is also traced with ``torch.profiler`` (CPU and CUDA
    activities, shapes and FLOPs of the aten ops recorded) and written as
    one gzipped Chrome trace under ``logdir``, ``<name>_step<step>.<ns>
    .pt.trace.json.gz``, one per traced step, as JAX writes one per
    ``start_trace``.  ``scopes`` (a ``ModuleScopes``) puts its record into
    the trace under ``SCOPES_KEY``.  The profiler starts before the region's
    ``record_function`` and stops and writes after it, so a caller that
    times the work inside the ``with`` leaves those out."""

    _trace_active = False

    def __init__(self, name: str, step: int, target: Optional[str] = None,
                 warmup_steps: int = 0, logdir: Optional[str] = None,
                 scopes: Optional[ModuleScopes] = None):
        self.name, self.step, self.target = name, step, target
        self.warmup_steps, self.logdir, self.scopes = warmup_steps, logdir, scopes
        self.trace_path: Optional[str] = None
        self._prof = None
        self._region = None

    def __enter__(self):
        if (self.target is not None and self.name == self.target
                and self.step >= self.warmup_steps and self.logdir
                and not Profile._trace_active):
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts, record_shapes=True, with_flops=True)
            self._prof.__enter__()
            Profile._trace_active = True
        self._region = torch.profiler.record_function(self.name)
        self._region.__enter__()
        return self

    def __exit__(self, *exc):
        self._region.__exit__(*exc)
        if self._prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.__exit__(*exc)
            Profile._trace_active = False
            self.trace_path = self._write()
            self._prof = None
        return False

    def _write(self) -> str:
        """Writes the trace with ``SCOPES_KEY`` added: the region, the step,
        the scopes' record and the FLOPs the profiler counted per aten op
        (by the op's External id; the Chrome trace itself leaves them out)."""
        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir, f"{self.name}_step{self.step}."
                            f"{time.time_ns()}.pt.trace.json")
        self._prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        os.remove(path)
        trace[SCOPES_KEY] = {
            "region": self.name, "step": self.step,
            "calls": self.scopes.calls if self.scopes is not None else [],
            "flops": {str(e.id): e.flops for e in self._prof.events() if e.flops}}
        with gzip.open(path + ".gz", "wt") as f:
            json.dump(trace, f)
        return path + ".gz"
