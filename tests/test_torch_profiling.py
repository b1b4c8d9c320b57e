"""The port's profiling against the JAX package's: the op tables over the
same op instances written as an xprof trace and as a torch.profiler trace,
the traced regions, the FLOP counts, the roofline plot, and the profiling
entry point as a whole (its report contract, its step-0 Forward loss and FLOPs
against JAX's ``forward``, and its three phases against one train step)."""

import gzip
import json
import os
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepcam_tpu.profiling import op_table as jax_op_table
from deepcam_tpu_torch.cli import profile as cli
from deepcam_tpu_torch.ops.fused_sepconv import (fused_sepconv_affine_stats,
                                                 fused_sepconv_boundary_stats)
from deepcam_tpu_torch.profiling import op_profile, op_table
from deepcam_tpu_torch.profiling.profiler import (SCOPES_KEY, Profile, cost_analysis,
                                                  roofline, unit_counts)
from deepcam_tpu_torch.profiling.roofline_plot import plot_roofline
from tests.torch_port_ref import capped_torch_threads, jax_default_config, port_variables
from tests.torch_port_ref import few_torch_threads, release_memory  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

UNIT = [96, 16, 24, "affine_stats"]  # P, C, F, form of xception/block4/sepconv1
_W = unit_counts("affine_stats", 96, 16, 24)
# (name, trace category, launching op, family, ms, flops, bytes, module, thread)
# per step; "fwd" launches on the main thread inside the module's range,
# "bwd" on autograd's thread inside a node the module's call created
INSTANCES = [
    ("sm90_xmma_fprop_implicit_gemm_bf16f32_tilesize128x128", "kernel",
     "aten::cudnn_convolution", "cudnn conv", 2.0, 4e9, 1e6, "upsample/deconv3", "fwd"),
    ("void at::native::vectorized_elementwise_kernel<4, add>", "kernel", "aten::add",
     "elementwise", 0.5, 0.0, 2e6, "xception/block4/bn0", "fwd"),
    ("void at::native::reduce_kernel<512, 1, sum>", "kernel", "aten::sum", "reduction", 0.25,
     0.0, 4e5, "xception/block4/sepconv1", "bwd"),
    ("void dsc::sepconv_fwd_kernel<true, false, 1, true, false, 1>(CUtensorMap_st)", "kernel",
     "_FusedSepconv", "sepconv (hand-written)", 0.3, float(_W["fwd_flops"]),
     float(_W["fwd_bytes"]), "xception/block4/sepconv1", "fwd"),
    ("void dsc::dpw_kernel<true>(CUtensorMap_st)", "kernel", "_FusedSepconvBackward",
     "sepconv (hand-written)", 0.4, float(2 * 96 * 16 * 24), 0.0, "xception/block4/sepconv1",
     "bwd"),
    ("Memcpy DtoD (Device -> Device)", "gpu_memcpy", "aten::copy_", "memcpy/memset", 0.1, 0.0,
     8e5, "", "fwd"),
]
CALLS = [[100, 110, "xception/block4", None], [103, 105, "xception/block4/sepconv1", UNIT],
         [105, 107, "xception/block4/bn0", None], [200, 202, "upsample/deconv3", None]]
SEQ = {"xception/block4/sepconv1": 104, "upsample/deconv3": 201}
N_STEPS = 2


def _write_jax_trace(root):
    """The xprof shape ``tests/test_op_table.py`` fabricates."""
    run = os.path.join(root, "plugins", "profile", "2026_01_01_00_00_00")
    os.makedirs(run)
    events = [{"ph": "M", "pid": 3, "tid": 1, "name": "thread_name", "args": {"name": "Steps"}},
              {"ph": "M", "pid": 3, "tid": 2, "name": "thread_name",
               "args": {"name": "XLA Ops"}}]
    for s in range(N_STEPS):
        events.append({"ph": "X", "pid": 3, "tid": 1, "name": str(s), "ts": 1e4 * s,
                       "dur": 9e3})
        for i, (name, _, _, family, ms, flops, nbytes, module, _) in enumerate(INSTANCES):
            events.append({"ph": "X", "pid": 3, "tid": 2, "name": name,
                           "ts": 1e4 * s + 100 * i, "dur": ms * 1e3,
                           "args": {"device_duration_ps": ms * 1e9, "model_flops": flops,
                                    "bytes_accessed": nbytes, "hlo_category": family,
                                    "tf_op": f"jit(step)/{module}" if module else ""}})
    with gzip.open(os.path.join(run, "vm.trace.json.gz"), "wt") as f:
        json.dump({"traceEvents": events}, f)


def _write_torch_trace(path):
    """The torch.profiler shape: a traced Backward region per step, module
    ranges and ops on the main thread (1), autograd nodes on thread 2,
    runtime launches linked to kernels by correlation id, kernels on the
    card's stream (pid 0, tid 7), and ``Profile``'s metadata."""
    events, flops, ext, corr = [], {}, 1000, 5000
    for s in range(N_STEPS):
        base = 1e4 * s
        events.append({"ph": "X", "cat": "user_annotation", "name": "Backward", "pid": 1,
                       "tid": 1, "ts": base, "dur": 9e3, "args": {"External id": ext}})
        ext += 1
        events.append({"ph": "X", "cat": "user_annotation", "name": "xception/block4",
                       "pid": 1, "tid": 1, "ts": base + 150, "dur": 300,
                       "args": {"External id": ext}})
        ext += 1
        for i, (name, cat, op, _, ms, fl, nbytes, module, thread) in enumerate(INSTANCES):
            ts, tid = base + 100 * (i + 1), 1 if thread == "fwd" else 2
            if thread == "fwd" and module:
                events.append({"ph": "X", "cat": "user_annotation", "name": module, "pid": 1,
                               "tid": 1, "ts": ts - 10, "dur": 20,
                               "args": {"External id": ext + 1000}})
            if thread == "bwd":
                events.append({"ph": "X", "cat": "cpu_op", "pid": 1, "tid": 2, "ts": ts - 8,
                               "dur": 16, "name": "autograd::engine::evaluate_function: X",
                               "args": {"External id": ext + 2000,
                                        "Sequence number": SEQ[module]}})
            op_bytes = 0.0 if op.startswith("_FusedSepconv") else nbytes
            events.append({"ph": "X", "cat": "cpu_op", "name": op, "pid": 1, "tid": tid,
                           "ts": ts - 5, "dur": 10,
                           "args": {"External id": ext, "Input Dims": [[int(op_bytes) // 4]],
                                    "Input type": ["float"]}})
            if fl and not op.startswith("_FusedSepconv"):
                flops[str(ext)] = fl
            events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                           "pid": 1, "tid": tid, "ts": ts, "dur": 2,
                           "args": {"External id": ext, "correlation": corr}})
            events.append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
                           "ts": base + 5000 + 100 * i, "dur": ms * 1e3,
                           "args": {"External id": ext, "correlation": corr}})
            ext, corr = ext + 1, corr + 1
    trace = {"traceEvents": events,
             SCOPES_KEY: {"region": "Backward", "step": 1, "calls": CALLS, "flops": flops}}
    with gzip.open(path, "wt") as f:
        json.dump(trace, f)


@pytest.fixture
def traces(tmp_path):
    _write_jax_trace(str(tmp_path / "xprof"))
    os.makedirs(tmp_path / "torch" / "run")
    _write_torch_trace(str(tmp_path / "torch" / "run" / "Backward_step1.1.pt.trace.json.gz"))
    return str(tmp_path / "xprof"), str(tmp_path / "torch")


def _assert_same_table(port, ref, cols):
    """Port rows keyed like the JAX DataFrame's index, within 1e-9 (relative)."""
    assert sorted(r[port.key] for r in port) == sorted(ref.index)
    assert [r[port.key] for r in port][:1] == list(ref.index[:1])  # sorted by time
    for r in port:
        for c in cols:
            want = ref.loc[r[port.key], c]
            if isinstance(want, str):
                assert r[c] == want, (r[port.key], c)
            else:
                np.testing.assert_allclose(r[c], want, rtol=1e-9, err_msg=f"{r[port.key]} {c}")


def test_op_tables_match_jax_on_the_same_instances(traces):
    """op_table, category_table, scope_table and per_step of the port over
    the torch trace give the JAX functions' numbers over the xprof trace
    of the same op instances (time, invocations, flops, bytes and the
    derived columns, 1e-9): the kernel families, the FLOPs by op id, the
    input bytes from the recorded shapes, the fused unit's analytic count,
    and the scopes from module ranges (forward) and from autograd sequence
    numbers (backward) all land where the instances say."""
    xprof, torch_dir = traces
    ref = jax_op_table.load_device_ops(xprof)
    ops = op_table.load_device_ops(torch_dir)
    assert ops.attrs["n_steps"] == ref.attrs["n_steps"] == N_STEPS
    assert len(ops) == len(ref) == N_STEPS * len(INSTANCES)
    assert {r["scope"] for r in ops} == {
        f"Backward/{m}" if m else "" for *_, m, _ in INSTANCES}
    cols = ["category", "time_ms", "invocations", "flops", "bytes", "time_avg_ms", "tflops",
            "flop_per_byte"]
    _assert_same_table(op_table.op_table(ops), jax_op_table.op_table(ref), cols)
    _assert_same_table(op_table.per_step(op_table.op_table(ops), N_STEPS),
                       jax_op_table.per_step(jax_op_table.op_table(ref), N_STEPS), cols)
    agg = ["time_ms", "invocations", "flops", "bytes", "time_pct"]
    _assert_same_table(op_table.category_table(ops), jax_op_table.category_table(ref), agg)
    for depth in (1, 3):
        _assert_same_table(op_table.scope_table(ops, depth),
                           jax_op_table.scope_table(ref, depth), agg)
    assert op_table.op_table(ops, top=2) == op_table.op_table(ops)[:2]
    share = op_table.unattributed_share(ops)
    assert share == pytest.approx(0.1 / sum(i[4] for i in INSTANCES), rel=1e-12)
    df = op_table.to_dataframe(op_table.category_table(ops))
    np.testing.assert_allclose(df.loc["cudnn conv", "time_ms"], 2.0 * N_STEPS)


def test_an_ops_flops_go_to_its_conv_kernel(tmp_path):
    """An ``aten::conv2d`` the profiler counted (4e9 FLOPs) first copies
    its input (an ``aten::copy_`` inside it), then runs the cuDNN kernel:
    the FLOPs land on the conv kernel, each op's input bytes on its own
    first kernel."""
    def op(name, ext, ts, dur, **args):
        return {"ph": "X", "cat": "cpu_op", "name": name, "pid": 1, "tid": 1, "ts": ts,
                "dur": dur, "args": {"External id": ext, **args}}

    events = [op("aten::conv2d", 1, 0, 50), op("aten::copy_", 2, 5, 10,
                                                **{"Input Dims": [[1000], [1000]],
                                                   "Input type": ["c10::BFloat16"] * 2}),
              op("aten::cudnn_convolution", 3, 20, 25)]
    for i, (name, ext) in enumerate([("void at::native::elementwise_kernel<copy>", 2),
                                     ("sm90_xmma_fprop_implicit_gemm_bf16", 3)]):
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1,
                       "tid": 1, "ts": 10 + 20 * i, "dur": 2,
                       "args": {"External id": ext, "correlation": 7 + i}})
        events.append({"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7,
                       "ts": 100 + 10 * i, "dur": 5,
                       "args": {"External id": ext, "correlation": 7 + i}})
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events,
                                SCOPES_KEY: {"region": "Forward", "flops": {"1": 4e9}}}))
    copy, conv = op_table.load_device_ops(str(path))
    assert (copy["category"], copy["flops"], copy["bytes"]) == ("elementwise", 0.0, 4000.0)
    assert (conv["category"], conv["flops"], conv["bytes"]) == ("cudnn conv", 4e9, 0.0)


def test_kernel_families():
    family = op_table.kernel_family
    assert family("dsc::reduce_kernel(float const*, float*, int, long, int)") == \
        "sepconv (hand-written)"
    assert family("void at::native::reduce_kernel<512, 1>") == "reduction"
    assert family("row_windows_kernel(float4 const*)") == "sepconv (hand-written)"
    assert family("sm90_xmma_gemm_bf16bf16", op="aten::convolution_backward") == "cudnn conv"
    assert family("sm90_xmma_gemm_bf16bf16", op="aten::mm") == "gemm"
    assert family("ncclDevKernel_AllReduce_Sum_f32_RING_LL") == "nccl"
    assert family("Memset (Device)", cat="gpu_memset") == "memcpy/memset"
    assert family("void at::native::(anonymous namespace)::CatArrayBatchedCopy<>") == \
        "elementwise"
    assert family("void at::native::multi_tensor_apply_kernel<LpNormFunctor>") == "reduction"
    assert family("mystery") == "other"
    assert set(op_table.FAMILIES) >= {"sepconv (hand-written)", "cudnn conv", "gemm",
                                      "elementwise", "reduction", "memcpy/memset", "nccl",
                                      "other"}


def test_find_trace_resolves_a_logdir(traces, tmp_path):
    _, torch_dir = traces
    path = op_table.find_trace(torch_dir)
    assert path.endswith(".pt.trace.json.gz") and op_table.find_trace(path) == path
    newer = tmp_path / "torch" / "run" / "Backward_step2.2.pt.trace.json"
    time.sleep(0.01)
    newer.write_text(json.dumps({"traceEvents": []}))
    assert op_table.find_trace(torch_dir) == str(newer)
    with pytest.raises(FileNotFoundError):
        op_table.find_trace(str(tmp_path / "xprof" / "nothing"))


def test_op_profile_prints_the_tables(traces, tmp_path, capsys):
    _, torch_dir = traces
    assert op_profile.main([torch_dir, "--top", "5", "--csv", str(tmp_path / "ops.csv")]) == 0
    out = capsys.readouterr().out
    assert "device time by kernel family [per step (2 traced)]" in out
    assert "unattributed 2.8%" in out and "xception/block4/sepconv1" in out
    assert "sm90_xmma_fprop_implicit_gemm" in out and "cudnn conv" in out
    with open(tmp_path / "ops.csv") as f:
        assert len(f.read().splitlines()) == 1 + len(INSTANCES)
    assert op_profile.main([torch_dir, "--total"]) == 0
    assert "trace total" in capsys.readouterr().out


def test_profile_traces_only_the_target_after_warmup(tmp_path):
    """Two warm-up steps, then the target region is traced once per step
    (CPU activity here), with the region's annotation in it and the other
    regions' not; no target, no trace."""
    logdir = str(tmp_path / "trace")
    x = torch.randn(64, 64)
    paths = []
    for step in range(4):
        for name in ("Forward", "Backward"):
            with Profile(name, step, target="Backward", warmup_steps=2, logdir=logdir) as p:
                (x @ x).sum()
            paths.append((name, step, p.trace_path))
        with Profile("Optimizer", step, logdir=logdir) as p:
            x.add_(0)
        assert p.trace_path is None
    traced = [(n, s) for n, s, path in paths if path]
    assert traced == [("Backward", 2), ("Backward", 3)]
    assert sorted(os.listdir(logdir)) == sorted(os.path.basename(p) for *_, p in paths if p)
    with gzip.open(paths[-1][2], "rt") as f:
        trace = json.load(f)
    names = {e["name"] for e in trace["traceEvents"] if e.get("cat") == "user_annotation"}
    assert "Backward" in names and "Forward" not in names
    assert trace[SCOPES_KEY]["region"] == "Backward" and trace[SCOPES_KEY]["step"] == 3
    assert "aten::mm" in {e["name"] for e in trace["traceEvents"] if e.get("cat") == "cpu_op"}
    assert any(v == 2 * 64 ** 3 for v in trace[SCOPES_KEY]["flops"].values())
    assert op_table.load_device_ops(logdir).attrs["n_steps"] == 1


@pytest.mark.parametrize("form", ["affine_stats", "boundary_stats"])
def test_unit_flops_equal_the_analytic_count(form):
    """One fused unit counts 2·P·C·F + 18·P·C forward and 4·P·C·F + 36·P·C
    backward, exactly, whatever its plain version computes inside."""
    n, h, w, c, f = 2, 6, 8, 16, 24
    p = n * h * w
    rng = np.random.RandomState(0)

    def t(*shape, grad=False):
        return torch.tensor(rng.randn(*shape).astype(np.float32), requires_grad=grad)

    x, a, b, skip = t(n, h, w, c, grad=True), t(c, grad=True), t(c, grad=True), t(n, h, w, c)
    dwk, pwk = t(3, 3, c, grad=True), t(c, f, grad=True)
    if form == "affine_stats":
        run = lambda: fused_sepconv_affine_stats(x, a, b, dwk, pwk)  # noqa: E731
    else:
        run = lambda: fused_sepconv_boundary_stats(x, a, b, skip, dwk, pwk)  # noqa: E731
    fwd = cost_analysis(run)
    assert fwd["flops"] == 2 * p * c * f + 18 * p * c == unit_counts(form, p, c, f)["fwd_flops"]
    out = run()
    loss = out[0].sum() + out[-1].sum()
    bwd = cost_analysis(loss.backward)
    assert bwd["flops"] == 4 * p * c * f + 36 * p * c
    assert fwd["bytes_accessed"] >= unit_counts(form, p, c, f)["fwd_bytes"]


def test_conv_and_deconv_flops_equal_the_analytic_count():
    """2 per multiply-add: a 3x3 conv over its output pixels, a transposed
    conv over its input pixels."""
    x = torch.randn(2, 8, 10, 12)
    conv = cost_analysis(F.conv2d, x, torch.randn(16, 8, 3, 3), None, 1, 1)
    assert conv["flops"] == 2 * 2 * 10 * 12 * 16 * 8 * 9
    assert conv["bytes_accessed"] >= 4 * (x.numel() + 16 * 8 * 9 + 2 * 16 * 10 * 12)
    deconv = cost_analysis(lambda: F.conv_transpose2d(x, torch.randn(8, 4, 3, 3), stride=2,
                                                      padding=1, output_padding=1))
    assert deconv["flops"] == 2 * 2 * 10 * 12 * 8 * 4 * 9


def test_plot_roofline_writes_a_png(tmp_path):
    x = torch.randn(128, 128)
    rl = roofline(torch.matmul, x, x, device="cpu", iters=2)
    assert rl.flops == 2 * 128 ** 3 and rl.device.startswith("cpu")
    assert "h100-sxm" in rl.summary()
    out = plot_roofline([rl, {"arithmetic_intensity": 10.0, "achieved_tflops": 50.0,
                              "label": "step"}], output_path=str(tmp_path / "roof.png"))
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def _args(tmp_path, *extra):
    return cli.build_parser().parse_args([
        "--output_dir", str(tmp_path), "--local_batch_size", "1", "--num_warmup_steps", "1",
        "--num_profile_steps", "2", "--image_size", "32", "48", "--amp_opt_level", "O0",
        "--device", "cpu", *extra])


def test_profile_cli_runs_and_reports(capsys, tmp_path):
    """The contract of ``tests/test_profile_cli.py`` at (1, 32, 48, 16)."""
    args = _args(tmp_path)
    assert cli.build_parser().parse_args([]).device == "cuda"
    assert args.gpu == "h100-sxm"
    report = cli.main(args)
    out = capsys.readouterr().out
    assert "REPORT: step 0" in out and "REPORT: step 2" in out
    assert "REPORT: [roofline/h100-sxm" in out
    assert "Forward" in report and "Backward" in report and "Optimizer" in report
    assert report["Forward"]["flops"] > 0
    assert report["Backward"]["flops"] > report["Forward"]["flops"]
    assert report["Forward"]["mean_seconds"] > 0 and report["Optimizer"]["mean_seconds"] > 0
    assert "roofline" in report
    assert np.isfinite(report["roofline"]["achieved_tflops"])
    assert report["roofline"]["flops"] == pytest.approx(
        report["Forward"]["flops"] + report["Backward"]["flops"], rel=1e-12)


def test_forward_loss_and_flops_match_jax():
    """The CLI's step-0 Forward at its default local batch 2, from the
    seed-333 weights carried to JAX by the weight bridge and the
    RandomState(0) batch: the loss within 1e-5 (relative) of JAX's
    ``forward`` (XLA sepconv, the default configuration), and the FLOP
    count within FLOP_RATIO of XLA's cost analysis of it (measured 1.206).
    The port counts every tap of a padded conv, as FlopCounterMode does;
    XLA counts only the taps that land inside the input, which at 32x48
    leaves out most taps of the dilated exit and ASPP convs on the 2x3
    stride-16 map (a 3x3 conv at dilation 6 on 48x72 already counts 1.155x
    in the port); XLA also counts elementwise work, which the port does
    not.  Batch 2, not 1: at batch 1 the exit BNs normalize 6 pixels per
    channel, and the port's own train-mode loss moves by up to 2.2e-5
    under a 1e-7 nudge of its input, above 1e-5 (at batch 2, 1.6e-6)."""
    import jax
    import jax.numpy as jnp

    from deepcam_tpu.models.deeplab import DeepLabv3plus as JaxDeepLab
    from deepcam_tpu.train.losses import weighted_ce_loss

    args = cli.build_parser().parse_args([
        "--image_size", "32", "48", "--amp_opt_level", "O0", "--device", "cpu"])
    assert args.local_batch_size == 2
    model, _, x, y, weights, _ = cli.setup(args)
    loss = float(cli.forward_loss(model, x, y, weights).detach())
    flops = cost_analysis(cli.forward_loss, model, x, y, weights)["flops"]
    variables = port_variables(cli.SEED)
    with jax_default_config():
        jm = JaxDeepLab(n_classes=3, dtype=jnp.float32)

        def forward(params, batch_stats, x, y):
            logits, updates = jm.apply({"params": params, "batch_stats": batch_stats}, x,
                                       train=True, mutable=["batch_stats"])
            return weighted_ce_loss(logits, y, weights), updates["batch_stats"]

        rng = np.random.RandomState(0)
        xj = rng.rand(2, 32, 48, 16).astype(np.float32)
        yj = rng.randint(0, 3, size=(2, 32, 48)).astype(np.int32)
        np.testing.assert_array_equal(xj, x.numpy())
        compiled = jax.jit(forward).lower(variables["params"], variables["batch_stats"],
                                          xj, yj).compile()
        ref = float(compiled(variables["params"], variables["batch_stats"], xj, yj)[0])
        costs = compiled.cost_analysis()
        costs = costs[0] if isinstance(costs, list) else costs
    assert abs(loss - ref) <= 1e-5 * abs(ref)
    ratio = flops / float(costs["flops"])
    assert FLOP_RATIO[0] <= ratio <= FLOP_RATIO[1], ratio


FLOP_RATIO = (1.0, 1.25)


def test_phases_equal_one_train_step():
    """Forward, Backward and Optimizer of the CLI (AdamW) on one state,
    one ``make_train_step`` on an identical state: the loss and every
    parameter after the update within 1e-6 (relative to each tensor's
    largest entry)."""
    from deepcam_tpu_torch.train.trainer import create_train_state, make_train_step

    args = cli.build_parser().parse_args([
        "--local_batch_size", "1", "--image_size", "32", "48", "--amp_opt_level", "O0",
        "--device", "cpu"])
    with capped_torch_threads():
        model, opt, x, y, weights, _ = cli.setup(args)
        before = model.xception.block4.sepconv1.pointwise.weight.detach().clone()
        loss = cli.forward_loss(model, x, y, weights)
        cli.backward(opt, loss)
        opt.step()
        ref_model, ref_opt, _, _, _, _ = cli.setup(args)
        state, metrics = make_train_step(weights, with_iou=False)(
            create_train_state(ref_model, ref_opt), x, y)
    assert abs(loss.detach().item() - metrics["loss"].item()) <= 1e-6 * abs(metrics["loss"].item())
    ref = dict(ref_model.named_parameters())
    for k, p in model.named_parameters():
        scale = ref[k].detach().abs().max().clamp_min(1e-30)
        assert float((p - ref[k]).detach().abs().max() / scale) <= 1e-6, k
    assert not torch.equal(before, model.xception.block4.sepconv1.pointwise.weight)
