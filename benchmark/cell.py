"""One run of one cell on one rank: set-up, the three compared steps, the
measured window, the traced capture, and the reference check.

Set-up builds the program's train state once (the port's model as the
configuration's family builds it, its storage on the card, the benchmark's
weights loaded into it; the workload's optimizer; ``make_train_step``),
drives it through the window's own feed and step for the three compared
steps, warms up, and hands the same state to the window.  The window runs a fixed
number of steps, worked out from the warm-up so that it lasts about
``--seconds``; a CUDA event on the compute stream marks each step boundary.
With ``--trace 1`` the last ``capture_steps`` steps run under
``torch.profiler``.  Once the window has closed and the peak memory is
read, the program's state is freed and rank 0 runs the reference.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import math
import statistics
import sys
import time
from typing import Callable, Dict, Optional

import torch

from . import check, spec, trace
from .reference.quant import identity
from .reference.train import full_fp32, run_steps
from .traffic import make_sample, normalize, stats
from .weights import make_weights

FORBIDDEN = ("jax", "jaxlib", "flax", "deepcam_tpu")
COMPARED_STEPS = 3


class Run:
    """What a rank knows of its run."""

    def __init__(self, cell: str, seed: int, rank: int = 0, world: int = 1,
                 device: Optional[torch.device] = None, overrides: Optional[dict] = None):
        self.cell, self.seed, self.rank, self.world = cell, int(seed), rank, world
        self.wl = spec.workload(cell)
        for key, value in (overrides or {}).items():
            if isinstance(value, dict):
                self.wl[key] = {**self.wl.get(key, {}), **value}
            else:
                self.wl[key] = value
        self.cfg = self.wl["cfg"]
        self.family = spec.config_family(self.cfg)
        self.entry = importlib.import_module(f"benchmark.entries.{self.wl['entry']}")
        self.device = device


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run must not hold,
    compared whole (``deepcam_tpu_torch`` is not ``deepcam_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

def build_program(run: Run):
    """(state, step_fn) of the port, with the benchmark's weights."""
    from deepcam_tpu_torch.train.losses import FPW_1, FPW_2, class_weights
    from deepcam_tpu_torch.train.optim import build_optimizer
    from deepcam_tpu_torch.train.schedule import get_lr_schedule
    from deepcam_tpu_torch.train.trainer import create_train_state, make_train_step

    cfg, opt = run.cfg, run.wl["optimizer"]
    model = run.family.build(cfg, run.device)
    weights = make_weights(cfg, run.seed, run.device)
    model.load_state_dict(weights)
    del weights
    schedule = get_lr_schedule(opt["lr"], opt.get("lr_schedule"))
    optimizer = build_optimizer(opt["name"], model.parameters(), schedule, eps=opt["eps"],
                                weight_decay=opt["weight_decay"])
    state = create_train_state(model, optimizer)
    step_fn = make_train_step(class_weights(), fpw_1=FPW_1, fpw_2=FPW_2, with_iou=True)
    return state, step_fn


def _norms(tensors) -> list:
    return torch.stack(torch._foreach_norm(list(tensors))).double().cpu().tolist()


def compared_steps(run: Run, state, step_fn: Callable, feed, keep: bool = False) -> dict:
    """The program's first ``COMPARED_STEPS`` steps through ``feed`` and
    ``step_fn``, and its readings (see ``check``).  The first gradient is
    the one the optimizer received, before any clip: the step clears the
    gradients before its backward, so after the first step they are still
    held.
    ``keep`` also keeps that gradient's tensors, on the host
    (``grad1_t``)."""
    names = [n for n, _ in state.model.named_parameters()]
    params = [p for _, p in state.model.named_parameters()]
    out = {"loss": [], "iou": []}
    for s in range(COMPARED_STEPS):
        x, y = feed.next()
        state, m = step_fn(state, x, y)
        out["loss"].append(m["loss"].item())
        out["iou"].append(m["iou"].item())
        if s == 0:
            out["grad1"] = dict(zip(names, _norms(p.grad for p in params)))
            if keep:
                out["grad1_t"] = {n: p.grad.detach().float().cpu() for n, p in
                                  zip(names, params)}
            out["bn"] = {n: b.detach().to("cpu", copy=True)
                         for n, b in state.model.named_buffers()
                         if run.family.is_buffer(n)}
    with torch.no_grad():
        w0 = make_weights(run.cfg, run.seed, run.device)
        out["delta"] = dict(zip(names, _norms(
            torch._foreach_sub([p.detach() for p in params], [w0[n] for n in names]))))
        out["bn"] = {n: b - w0[n].cpu() for n, b in out["bn"].items()}
        del w0
    return out


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

def reference_batches(run: Run):
    """batches[s][r] = rank r's (x fp32 NHWC normalised, labels) at step s,
    made again from the seed."""
    cfg, tr = run.cfg, run.wl["traffic"]
    minval, maxval = stats(cfg, run.seed)
    out = []
    for s in range(COMPARED_STEPS):
        step = []
        for r in range(run.world):
            idx = run.entry.indices(run.wl, s)
            xs, ys = zip(*[make_sample(cfg, tr, run.seed, r, i, run.device) for i in idx])
            step.append((normalize(torch.stack(xs), minval, maxval), torch.stack(ys)))
        out.append(step)
    return out


def reference_readings(run: Run, quant: Callable = identity, keep: bool = False) -> dict:
    """The reference's readings over the same steps (``quant``: the
    control, see ``calibrate.py``; ``keep`` as in ``compared_steps``)."""
    w = make_weights(run.cfg, run.seed, run.device)
    batches = reference_batches(run)
    with full_fp32():
        res = run_steps(run.cfg, w, batches, run.wl["optimizer"], quant)
    names = sorted(res["grad1"])
    bufs = sorted(res["buffers1"])
    out = {"loss": res["loss"], "iou": res["iou"],
           "grad1": dict(zip(names, _norms(res["grad1"][n] for n in names))),
           "delta": dict(zip(names, _norms(res["params"][n] - w[n] for n in names))),
           "bn": {n: (res["buffers1"][n] - w[n]).cpu() for n in bufs}}
    if keep:
        out["grad1_t"] = {n: res["grad1"][n].cpu() for n in names}
    del res, w, batches
    free_memory()
    return out


def free_memory():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# work counted on the reference
# ---------------------------------------------------------------------------

def conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding,
                        _dilation, transposed, _output_padding, _groups, output_mask,
                        out_shape=None) -> int:
    """FLOPs of a convolution's backward: one forward's multiply-adds, 2
    FLOPs each, for each of the input and weight gradients it computes.
    (``FlopCounterMode``'s own formula leaves out the groups in the weight
    gradient and counts a depthwise conv's hundreds of times over.)"""
    spatial = x_shape if transposed else grad_out_shape
    macs = math.prod(spatial) // spatial[1] * (x_shape[1] if transposed else grad_out_shape[1])
    macs *= math.prod(w_shape[1:])
    return 2 * macs * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def flops_per_sample(cfg: dict) -> float:
    """FLOPs of one sample's forward and backward (no recompute), counted by
    ``FlopCounterMode`` on the family's plain forward at the configuration's
    shapes, on the meta device, with ``conv_backward_flops`` for the
    backward's convolutions."""
    from torch.utils.flop_counter import FlopCounterMode

    from .reference.train import weighted_ce

    fam = spec.config_family(cfg)
    h, w = cfg["image_size"]
    with torch.device("meta"):
        params = {n: torch.empty(shape, requires_grad=not fam.is_buffer(n))
                  for n, shape, _ in fam.param_specs(cfg)}
        x = torch.empty((1, h, w, cfg["in_channels"]))
        y = torch.zeros((1, h, w), dtype=torch.int64)
        counter = FlopCounterMode(
            display=False,
            custom_mapping={torch.ops.aten.convolution_backward: conv_backward_flops})
        with counter:
            loss = weighted_ce(fam.forward(cfg, params, x), y)
            loss.backward()
    return float(counter.get_total_flops())


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------

def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def barrier(device: torch.device) -> None:
    if device.type == "cuda":
        torch.distributed.barrier(device_ids=[device.index])
    else:
        torch.distributed.barrier()


class Marks:
    """Step-boundary marks: CUDA events recorded on the compute stream on a
    card; host times on the CPU, where the tests drive a run."""

    def __init__(self, n: int, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = ([torch.cuda.Event(enable_timing=True) for _ in range(n)] if self.cuda
                      else [0.0] * n)

    def record(self, i: int) -> None:
        if self.cuda:
            self.marks[i].record()
        else:
            self.marks[i] = time.perf_counter()

    def intervals_ms(self) -> list:
        m = self.marks
        if self.cuda:
            return [m[i].elapsed_time(m[i + 1]) for i in range(len(m) - 1)]
        return [(m[i + 1] - m[i]) * 1e3 for i in range(len(m) - 1)]


def _span(name: str, on: bool):
    return torch.profiler.record_function(f"bench.{name}") if on else contextlib.nullcontext()


def window_steps(run: Run, state, step_fn, feed, seconds: float) -> int:
    """Warm-up steps, then steps timed to fix the window's length: the
    number of steps that lasts about ``seconds`` (rank 0's, under a process
    group)."""
    wl = run.wl
    for _ in range(wl["warmup_steps"]):
        x, y = feed.next()
        state, _ = step_fn(state, x, y)
    sync(run.device)
    t0 = time.perf_counter()
    for _ in range(wl["timing_steps"]):
        x, y = feed.next()
        state, _ = step_fn(state, x, y)
    sync(run.device)
    per_step = (time.perf_counter() - t0) / wl["timing_steps"]
    n = torch.tensor([max(math.ceil(seconds / per_step), wl["capture_steps"] + 2)],
                     device=run.device)
    if run.world > 1:
        torch.distributed.broadcast(n, 0)
    return int(n.item())


def measure(run: Run, state, step_fn, feed, n_steps: int, traced: bool, t0: float) -> dict:
    """The window: ``n_steps`` steps, the last ``capture_steps`` of them
    under the profiler when ``traced``."""
    from .frozen.module_scopes import ModuleScopes

    logfreq = run.wl["logging_frequency"]
    k = run.wl["capture_steps"] if traced else 0
    marks = Marks(n_steps + 1, run.device)
    waits, hosts, logged = [], [], []
    prof = scopes = capture = None
    gc.collect()
    if run.world > 1:
        barrier(run.device)
    sync(run.device)
    setup_s = time.time() - t0
    t_start = time.perf_counter()
    t_mid = None
    for i in range(n_steps):
        captured = traced and i >= n_steps - k
        if traced and i == n_steps - k:
            sync(run.device)
            t_mid = time.perf_counter()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if run.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            scopes = ModuleScopes(state.model).__enter__()
            capture = torch.profiler.record_function(trace.CAPTURE)
            capture.__enter__()
        ta = time.perf_counter()
        with _span("next", captured):
            x, y = feed.next()
        tb = time.perf_counter()
        marks.record(i)
        with _span("step", captured):
            state, metrics = step_fn(state, x, y)
        tc = time.perf_counter()
        if state.step % logfreq == 0:
            with _span("log", captured):
                logged.append((float(metrics["loss"]), float(metrics["iou"])))
        if not captured:
            waits.append(tb - ta)
            hosts.append(tc - tb)
    marks.record(n_steps)
    with _span("sync", traced):
        sync(run.device)
    t_end = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    out = {"setup_s": setup_s, "window_s": t_end - t_start, "steps": n_steps,
           "step_ms": marks.intervals_ms(), "waits": waits, "hosts": hosts, "peak": peak,
           "last_loss": float(metrics["loss"]), "logged": logged}
    if traced:
        capture.__exit__(None, None, None)
        scopes.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        out["uncaptured_s"] = t_mid - t_start
        out["events"] = trace.export_events(prof)
        out["calls"] = scopes.calls
    return out


# ---------------------------------------------------------------------------
# per-layer readings
# ---------------------------------------------------------------------------

def layer_context(run: Run, meas: dict) -> dict:
    """What the metric readers read: the host spans of the uncaptured
    steps, their step times (this rank's CUDA-event intervals) and rate,
    the FLOPs per sample, and the capture's device rows and window (see
    ``metrics/``)."""
    cap = trace.read_capture(meas.pop("events"), meas.pop("calls"))
    k = run.wl["capture_steps"]
    b = run.wl["local_batch"]
    units = run.family.units(run.cfg, b)
    return {"entry": run.wl["entry"], "world": run.world, "capture_steps": k,
            "data_wait_s": meas["waits"], "step_host_s": meas["hosts"],
            "step_ms": meas["step_ms"][:meas["steps"] - k],
            "samples_per_s_per_gpu": (meas["steps"] - k) * b / meas["uncaptured_s"],
            "flops_per_sample": flops_per_sample(run.cfg), "units": units,
            "rows": cap["rows"], "window": cap["window"], "capture": cap}


def read_layers(man: dict, run: Run, ctx: dict) -> Dict[str, dict]:
    """Each per-layer metric of the cell whose reader finds something."""
    out = {}
    for m in spec.cell_metrics(man, run.cell, "per_layer"):
        value = spec.metric_module(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def p90(values) -> float:
    return statistics.quantiles(values, n=10)[-1]


# ---------------------------------------------------------------------------
# one rank's run
# ---------------------------------------------------------------------------

def gather(obj, world: int) -> list:
    if world == 1:
        return [obj]
    out = [None] * world
    torch.distributed.all_gather_object(out, obj)
    return out


def run_rank(cell: str, seed: int, seconds: float, traced: bool, rank: int, world: int,
             t0: float, device: str = "cuda", overrides: Optional[dict] = None
             ) -> Optional[dict]:
    """One rank's run; rank 0 returns the result line's object (and the
    compared numbers under ``checks``), the other ranks None.  ``device``
    and ``overrides`` (keys of the workload file, ``cfg`` among them, laid
    over it) are for the tests, which drive a small run on the CPU."""
    from deepcam_tpu_torch.core.mesh import destroy_distributed, device_for, init_distributed

    dev = device_for(device)
    created = init_distributed("auto", device) if world > 1 else False
    try:
        run = Run(cell, seed, rank, world, dev, overrides)
        device = dev
        man = spec.manifest()
        feed = run.entry.Feed(run)
        state, step_fn = build_program(run)
        prog = compared_steps(run, state, step_fn, feed)
        n_steps = window_steps(run, state, step_fn, feed, seconds)
        meas = measure(run, state, step_fn, feed, n_steps, traced, t0)
        forbidden = forbidden_modules()
        local = {"step_ms": meas["step_ms"], "peak": meas["peak"], "forbidden": forbidden,
                 "failed": sum(not math.isfinite(v) for v in
                               [meas["last_loss"]] + [lv for lv, _ in meas["logged"]])}
        if traced:
            ctx = layer_context(run, meas)
            local["busy_s"] = trace.length(trace.busy(ctx["rows"], ctx["window"])) * 1e-6
            local["window_s"] = (ctx["window"][1] - ctx["window"][0]) * 1e-6
        feed.close()
        del state, step_fn, feed
        free_memory()
        ranks = gather(local, world)
        result = None
        if rank == 0:
            found = sorted({m for r in ranks for m in r["forbidden"]})
            if found:
                raise RuntimeError(f"the run loaded {found}: the port must not load JAX "
                                   "or the JAX package")
            t_ref = time.perf_counter()
            ref = reference_readings(run)
            print(f"setup_s {meas['setup_s']:.2f} window_s {meas['window_s']:.2f} steps "
                  f"{n_steps} reference_s {time.perf_counter() - t_ref:.2f}", file=sys.stderr)
            ms = sorted(meas["step_ms"])
            host_ms = 1e3 * statistics.mean(meas["hosts"])
            wait_ms = 1e3 * statistics.mean(meas["waits"])
            print(f"step_ms min {ms[0]:.2f} median {statistics.median(ms):.2f} p90 "
                  f"{p90(ms):.2f} max {ms[-1]:.2f}; host_ms {host_ms:.2f} wait_ms "
                  f"{wait_ms:.2f}", file=sys.stderr)
            for key in ("grad1", "delta", "bn"):
                for name, gap, p, r in check.worst(prog, ref, key):
                    print(f"worst {key} {name}: gap {gap:.4g} program {p:.6g} reference "
                          f"{r:.6g}", file=sys.stderr)
            print(f"loss program {prog['loss']} reference {ref['loss']}; iou program "
                  f"{prog['iou']} reference {ref['iou']}", file=sys.stderr)
            checks = check.judge(check.numbers(prog, ref, run.cfg), run.wl.get("limits", {}))
            b, w = run.wl["local_batch"], world
            kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
            device_info = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
                           "count": world, "memory_peak_bytes": max(r["peak"] for r in ranks)}
            if traced:
                metrics = read_layers(man, run, ctx)
                device_info["busy_s"] = sum(r["busy_s"] for r in ranks) / w
                device_info["window_s"] = ctx["window"][1] * 1e-6 - ctx["window"][0] * 1e-6
            else:
                step_ms = [max(r["step_ms"][i] for r in ranks) for i in range(n_steps)]
                values = {"samples_per_s_per_gpu": n_steps * b / meas["window_s"],
                          "step_ms_p90": p90(step_ms),
                          "peak_mem_gib": device_info["memory_peak_bytes"] / 2 ** 30,
                          "setup_s": meas["setup_s"]}
                metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                           for m in spec.cell_metrics(man, cell, "end_to_end")}
            result = {"correct": check.passed(checks), "attempted": n_steps,
                      "failed": sum(r["failed"] for r in ranks), "metrics": metrics,
                      "device": device_info}
            if traced:
                result["breakdown"] = trace.breakdown(ctx["capture"])
            result["checks"] = checks
        if world > 1:
            barrier(device)
        return result
    finally:
        if created:
            destroy_distributed()
