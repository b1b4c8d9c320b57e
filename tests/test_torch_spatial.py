"""The port's spatial H-sharding on the CPU (``parallel/spatial.py``): one
spatial group of two ranks, separate processes in a gloo group (the
spawner and the run-wide cache of ``tests/torch_port_ref.py``), in fp32
on the kernels' plain versions.

* The groups' arithmetic against the JAX package's mesh.
* The sepconv unit in its forms, sharded on two ranks, against the JAX
  package's ``SeparableConv2dSame._spatial_call`` under ``shard_map`` on a
  2-device mesh (its XLA path): output, each rank's emitted statistics and
  every gradient within 1e-5 of the largest value.  The overlapping strips
  (a 3-row shard at dilation 2) against the port's own unsharded unit,
  where the JAX module drops a cross term of Σy².
* The other hooks (3x3 convs, the deconv, BN with and without kernel
  statistics, the gathered ASPP region) against the port's unsharded
  modules, the odd-shard errors, and spatial mode at S=1 against no mode
  (the same bits).
* The two-rank spatial train step (2 AdamW steps, a global batch of 2 at
  (64, 48, 16), the JAX default configuration) against JAX's
  ``make_train_step_spatial`` on a (1, 2) mesh and against the port's
  unsharded step, with the gates of ``tests/test_torch_dist.py``; the
  spatial eval step against JAX's and the unsharded one.
* A 2-process run of the CLI with ``--spatial 2``, and with
  ``--spatial_impl gspmd --remat``.
"""

import contextlib
import json
import os
import pickle
from datetime import timedelta

import numpy as np
import pytest
import torch

from deepcam_tpu_torch.core import mesh
from deepcam_tpu_torch.models import layers
from deepcam_tpu_torch.models.deeplab import DeepLabv3plus
from deepcam_tpu_torch.parallel import spatial
from deepcam_tpu_torch.tools.weights import CONV_PERM, state_dict_to_jax
from deepcam_tpu_torch.train import losses as tl
from deepcam_tpu_torch.train.optim import build_optimizer
from deepcam_tpu_torch.train.trainer import (create_train_state, make_eval_step,
                                             make_train_step, running_stats)
from tests.torch_port_ref import flatten, release_memory  # noqa: F401  (autouse)
from tests.torch_port_ref import few_torch_threads  # noqa: F401
from tests.torch_port_ref import bits_digest, spawn_ranks, start_ranks

pytestmark = pytest.mark.usefixtures("few_torch_threads")

S = 2
TOL = 1e-5
# the unit cases: (N, H, W, C) → F, and each form's switches
UNIT_X, UNIT_F = (2, 8, 12, 16), 24
UNIT_FORMS = {
    "pre_d1": dict(pre_relu=True, dilation=1),
    "pre_d2": dict(pre_relu=True, dilation=2),
    "affine_stats_d2": dict(pre_relu=True, dilation=2, affine=True, stats=True),
    "boundary_stats": dict(dilation=1, affine=True, stats=True, boundary=True),
    "stride2_affine": dict(stride=2, affine=True),
}
# 3-row shards at dilation 2 on three ranks: the middle rank's two strips
# overlap
OVERLAP_X, OVERLAP_S = (2, 9, 12, 16), 3
HOOKS = ("conv_s1", "conv_s1_d2", "conv_s2", "deconv", "bn", "bn_kernel_stats", "aspp")
# the train and eval steps
SEED = 21
LR, EPS, WD = 1e-3, 1e-8, 1e-2
SHAPE = (64, 48)
EVAL_VALID = (1.0, 1.0, 0.0)
NUDGES = 3


def _to(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().numpy().copy()


def _rel(got, want):
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


# ---------------------------------------------------------------------------
# cases, made from seeds with numpy (the same in every process)
# ---------------------------------------------------------------------------

def _unit_case(form, shape=UNIT_X):
    cfg = {"stride": 1, "dilation": 1, "pre_relu": False, "affine": False, "stats": False,
           "boundary": False, **(UNIT_FORMS.get(form) or
                                 dict(pre_relu=True, dilation=2, affine=True, stats=True))}
    rng = np.random.RandomState(sorted(UNIT_FORMS).index(form) if form in UNIT_FORMS else 9)
    n, h, w, c = shape
    ho, wo = (h // 2, w // 2) if cfg["stride"] == 2 else (h, w)
    f32 = np.float32
    return {**cfg, "x": rng.randn(n, h, w, c).astype(f32),
            "dw": (rng.randn(3, 3, 1, c) / 3).astype(f32),
            "pw": (rng.randn(1, 1, c, UNIT_F) / 4).astype(f32),
            "a": (0.5 + rng.rand(c)).astype(f32), "b": rng.randn(c).astype(f32),
            "skip": rng.randn(n, h, w, c).astype(f32),
            "ct": rng.randn(n, ho, wo, UNIT_F).astype(f32),
            "cr": rng.randn(n, h, w, c).astype(f32),
            "gs1": rng.randn(UNIT_F).astype(f32), "gs2": (0.1 * rng.randn(UNIT_F)).astype(f32)}


def _unit_port(case, rows):
    """The port's unit on rows ``rows`` of the case (H, NHWC): y, its
    statistics and r, and the gradients of Σ y·ct + Σ r·cr + gs1·Σy +
    gs2·Σy² (each rank's stats are its rows'; their sum is the whole's)."""
    sl = lambda a: _to(a[:, rows])  # noqa: E731
    gen = torch.Generator().manual_seed(0)
    m = layers.SeparableConv2dSame(case["x"].shape[-1], UNIT_F, stride=case["stride"],
                                   dilation=case["dilation"], pre_relu=case["pre_relu"],
                                   gen=gen)
    with torch.no_grad():
        m.depthwise.weight.copy_(_to(case["dw"].transpose(CONV_PERM)))
        m.pointwise.weight.copy_(_to(case["pw"].transpose(CONV_PERM)))
    leaves = {"x": sl(case["x"]).permute(0, 3, 1, 2).requires_grad_()}
    if case["affine"]:
        leaves.update(a=_to(case["a"]).requires_grad_(), b=_to(case["b"]).requires_grad_())
    if case["boundary"]:
        leaves["skip"] = sl(case["skip"]).permute(0, 3, 1, 2).requires_grad_()
        y, st, r = m(leaves["x"], emit_stats=True,
                     boundary=((leaves["a"], leaves["b"]), leaves["skip"]))
    else:
        y = m(leaves["x"], bn_fold=(leaves["a"], leaves["b"]) if case["affine"] else None,
              emit_stats=case["stats"])
        (y, st), r = (y if case["stats"] else (y, None)), None
    ct = case["ct"][:, rows] if case["stride"] == 1 else case["ct"][
        :, slice(rows.start // 2, rows.stop // 2)]
    loss = (y.permute(0, 2, 3, 1) * _to(ct)).sum()
    if r is not None:
        loss = loss + (r.permute(0, 2, 3, 1) * sl(case["cr"])).sum()
    if st is not None:
        loss = loss + (_to(case["gs1"]) * st[0]).sum() + (_to(case["gs2"]) * st[1]).sum()
    loss.backward()
    out = {"y": _np(y.permute(0, 2, 3, 1)), "dx": _np(leaves["x"].grad.permute(0, 2, 3, 1)),
           "ddw": _np(m.depthwise.weight.grad).transpose(2, 3, 1, 0),
           "dpw": _np(m.pointwise.weight.grad).transpose(2, 3, 1, 0)}
    if st is not None:
        out.update(s1=_np(st[0]), s2=_np(st[1]))
    for k in ("a", "b", "skip"):
        if k in leaves:
            g = leaves[k].grad
            out["d" + k] = _np(g.permute(0, 2, 3, 1) if k == "skip" else g)
    return out


def _hook_case(name):
    """(module, input, cotangent, forward): a hook's module made from a
    seed, an NCHW input and the cotangent of its output."""
    gen = torch.Generator().manual_seed(HOOKS.index(name))
    x = torch.randn(2, 16, 8, 12, generator=gen)
    if name.startswith("conv"):
        d, stride = (2 if name.endswith("d2") else 1), (2 if name == "conv_s2" else 1)
        mod = layers.Conv2d(16, 24, 3, stride=stride, padding=d, dilation=d, gen=gen)
        return mod, x, torch.randn(2, 24, 8 // stride, 12 // stride, generator=gen), mod
    if name == "deconv":
        mod = layers.ConvTranspose2d(16, 24, gen=gen)
        return mod, x, torch.randn(2, 24, 16, 24, generator=gen), mod
    if name.startswith("bn"):
        mod = layers.BatchNorm2d(16)
        with torch.no_grad():
            mod.weight.copy_(0.5 + torch.rand(16, generator=gen))
            mod.bias.copy_(torch.randn(16, generator=gen))
        x = 2.0 * x + 0.5
        stats = name == "bn_kernel_stats"

        def fwd(xx):
            st = (xx.sum((0, 2, 3)), (xx * xx).sum((0, 2, 3))) if stats else None
            return mod(xx, relu=True, stats=st)
        return mod, x, torch.randn(2, 16, 8, 12, generator=gen), fwd
    model = DeepLabv3plus(3, dtype=torch.float32, device="cpu", seed=SEED)
    feats = torch.randn(2, 2048, 4, 6, generator=gen).contiguous(
        memory_format=torch.channels_last)
    return model, feats, torch.randn(2, 256, 4, 6, generator=gen), model.aspp


def _hook_port(name, rows):
    """The hook on rows ``rows`` (dim 2) of its input: output, input
    gradient, parameter gradients and BN running statistics."""
    mod, x, ct, fwd = _hook_case(name)
    mod.train()
    xs = x[:, :, rows].detach().clone().requires_grad_()
    y = fwd(xs)
    start, stop, _ = rows.indices(x.shape[2])
    scale = y.shape[2] / xs.shape[2]  # output rows per input row
    (y * ct[:, :, int(start * scale):int(stop * scale)]).sum().backward()
    return {"y": _np(y), "dx": _np(xs.grad),
            "grads": {k: _np(p.grad) for k, p in mod.named_parameters() if p.grad is not None},
            "running": {k: _np(b) for k, b in mod.named_buffers() if "running" in k}}


def _model():
    return DeepLabv3plus(3, dtype=torch.float32, device="cpu", seed=SEED)


def _trees(model):
    params, stats = state_dict_to_jax(model, model.state_dict())
    return flatten(params), flatten(stats)


def _batches():
    """Two global batches of 2 at SHAPE, and an eval batch of 3."""
    rng = np.random.RandomState(4)
    train = [(rng.rand(2, *SHAPE, 16).astype(np.float32),
              rng.randint(0, 3, size=(2, *SHAPE)).astype(np.int32)) for _ in range(2)]
    n = len(EVAL_VALID)
    return train, (rng.rand(n, *SHAPE, 16).astype(np.float32),
                   rng.randint(0, 3, size=(n, *SHAPE)).astype(np.int32))


def _nudged(train, seed, nudge=1e-7):
    rng = np.random.RandomState(200 + seed)
    return [((x * (1 + nudge * rng.randn(*x.shape))).astype(np.float32), y) for x, y in train]


def _my_rows(h):
    """This rank's rows of an H of ``h``."""
    i, size = mesh.spatial_index(), mesh.spatial_size()
    return slice(i * h // size, (i + 1) * h // size)


# ---------------------------------------------------------------------------
# the ranks: separate processes, one spatial group
# ---------------------------------------------------------------------------

def _rank_units(forms):
    """The unit cases ``forms`` on this rank's rows, under spatial mode."""
    out = {}
    for form in forms:
        case = _unit_case(form, OVERLAP_X if form == "overlap" else UNIT_X)
        out[form] = _unit_port(case, _my_rows(case["x"].shape[1]))
    return out


def _rank_hooks():
    return {name: _hook_port(name, _my_rows(8 if name != "aspp" else 4)) for name in HOOKS}


def _rank_eval():
    """The spatial eval step of the initial weights on this rank's rows of
    the eval batch."""
    _, (xe, ye) = _batches()
    rows = _my_rows(SHAPE[0])
    model = _model()
    eval_fn = spatial.make_eval_step_spatial(tl.class_weights(), fpw_1=tl.FPW_1,
                                             fpw_2=tl.FPW_2)
    sums = eval_fn(create_train_state(model, build_optimizer("AdamW", model.parameters(), LR)),
                   _to(xe[:, rows]), _to(ye[:, rows]), _to(np.asarray(EVAL_VALID, np.float32)))
    return [float(t) for t in sums]


def _spatial_train(remat):
    """2 spatial train steps on this rank's rows of each global batch: the
    state and the metrics."""
    model = _model()
    state = create_train_state(model, build_optimizer("AdamW", model.parameters(), LR,
                                                      eps=EPS, weight_decay=WD))
    step = spatial.make_train_step_spatial(tl.class_weights(), fpw_1=tl.FPW_1,
                                           fpw_2=tl.FPW_2, remat=remat)
    train, _ = _batches()
    rows = _my_rows(SHAPE[0])
    metrics = []
    for x, y in train:
        state, m = step(state, _to(x[:, rows]), _to(y[:, rows]))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _rank_steps():
    """2 spatial train steps on this rank's rows of each global batch, and
    the same with remat, compared bit for bit here: parameters, gradients
    and running statistics."""
    state, metrics = _spatial_train(remat=False)
    model = state.model
    flat = torch.cat([t.detach().reshape(-1)
                      for t in list(model.parameters()) + running_stats(model)])
    lo, hi = flat.clone(), flat.clone()
    torch.distributed.all_reduce(lo, op=torch.distributed.ReduceOp.MIN)
    torch.distributed.all_reduce(hi, op=torch.distributed.ReduceOp.MAX)
    out = {"metrics": metrics, "identical": bool(torch.equal(lo, hi)), "step": state.step,
           "trees": _trees(model) if mesh.spatial_index() == 0 else None}
    digest = bits_digest(model)
    del state, model
    rstate, rmetrics = _spatial_train(remat=True)
    out["remat_same_bits"] = rmetrics == metrics and bits_digest(rstate.model) == digest
    return out


def _rank_cli(root, out, extra=()):
    from deepcam_tpu_torch.cli.train import build_parser, main

    out = os.path.join(out, f"rank{mesh.get_rank()}")  # a write by rank 1 would show
    args = build_parser().parse_args([
        "--data_dir_prefix", root, "--output_dir", out, "--run_tag", "spatial",
        "--optimizer", "LAMB", "--local_batch_size", "1", "--eval_local_batch_size", "2",
        "--max_epochs", "1", "--logging_frequency", "1", "--validation_frequency", "2",
        "--save_frequency", "2", "--training_visualization_frequency", "2",
        "--amp_opt_level", "O0", "--target_iou", "2.0", "--device", "cpu", "--seed", "333",
        "--spatial", str(S), *extra])
    return main(args)


JOBS = {"units": lambda: _rank_units(UNIT_FORMS), "overlap": lambda: _rank_units(["overlap"]),
        "hooks": _rank_hooks, "errors": lambda: _odd_shard_errors(), "eval": lambda: _rank_eval()}


def rank_main(job: str) -> None:
    """Entry of a rank process: joins the gloo group through the job's file
    store, splits it into spatial groups (the CLI job lets ``main`` do
    that), runs the job (the modules' under spatial mode) and pickles its
    result."""
    job = json.loads(job)
    torch.set_num_threads(2)
    torch.distributed.init_process_group(
        "gloo", init_method="file://" + job["store"], rank=job["rank"],
        world_size=job["world"], timeout=timedelta(seconds=120))
    try:
        if job["kind"] == "cli":
            result = _rank_cli(job["root"], job["out"], job["extra"])
        else:  # one spatial group of all the ranks
            groups = mesh.init_spatial_groups(job["world"])
            if job["kind"] == "steps":
                result = _rank_steps()
            else:
                with spatial.spatial_mode(groups.group, groups.size):
                    result = JOBS[job["kind"]]()
        with open(job["result"], "wb") as f:
            pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)
    finally:
        mesh.destroy_distributed()


@contextlib.contextmanager
def ranks_of(tmp_path, kind, world=S):
    """Runs job ``kind`` on ``world`` ranks while the block computes its
    references; the results land in the yielded list at the block's end."""
    wait = start_ranks(tmp_path, "tests.test_torch_spatial", kind, world)
    results = []
    try:
        yield results
    finally:
        results.extend(wait())


def _joined(per_rank, dim):
    return np.concatenate(per_rank, axis=dim)


# ---------------------------------------------------------------------------
# the groups
# ---------------------------------------------------------------------------

def test_spatial_groups_match_the_jax_mesh():
    """W=4, S=2: spatial groups [[0, 1], [2, 3]] and data indices
    [0, 0, 1, 1], the rows and row indices of the JAX mesh's
    ``(W/S, S)`` reshape of the devices.  S must divide the world and the
    ranks on a host; without a process group the world is one rank."""
    import jax

    from deepcam_tpu.core import mesh as jax_mesh

    groups, data = mesh.spatial_layout(4, 2)
    jm = jax_mesh.make_mesh(spatial=2, devices=jax.devices()[:4])
    ids = [[d.id for d in row] for row in jm.devices]
    assert groups == [[0, 1], [2, 3]] == ids
    assert data == [0, 0, 1, 1] == [i for i, row in enumerate(ids) for _ in row]
    assert mesh.spatial_layout(4, 4, local_world=4) == ([[0, 1, 2, 3]], [0, 0, 0, 0])
    with pytest.raises(ValueError, match="does not divide the 3 ranks"):
        mesh.spatial_layout(3, 2)
    with pytest.raises(ValueError, match="ranks on each host"):
        mesh.spatial_layout(6, 2, local_world=3)
    assert mesh.initialized_dist() is None
    g = mesh.init_spatial_groups(1)
    try:
        assert (g.group, g.index, g.size, g.data_index, g.data_size) == (None, 0, 1, 0, 1)
        with pytest.raises(ValueError, match="does not divide the 1 ranks"):
            mesh.init_spatial_groups(2)
    finally:
        mesh.destroy_distributed()
    assert (mesh.spatial_size(), mesh.data_size()) == (1, 1)


# ---------------------------------------------------------------------------
# the sepconv unit against the JAX package's spatial path
# ---------------------------------------------------------------------------

def _unit_jax(case):
    """The JAX unit's ``_spatial_call`` under shard_map on a (1, 2) mesh,
    XLA path: y, each shard's (Σy, Σy²) and the gradients of the loss of
    ``_unit_port`` (the statistics summed from y)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from deepcam_tpu.core import mesh as jax_mesh
    from deepcam_tpu.models import layers as jl
    from deepcam_tpu.parallel import spatial as jsp

    mod = jl.SeparableConv2dSame(features=UNIT_F, stride=case["stride"],
                                 dilation=case["dilation"], pre_relu=case["pre_relu"],
                                 dtype=jnp.float32)
    sharded, whole = P("data", "spatial"), P()
    names = ["x", "a", "b", "skip"]
    specs = [sharded, whole, whole, sharded]

    def body(params, x, a, b, skip, ct, cr, gs1, gs2):
        with jsp.spatial_mode("spatial", S):
            def loss_fn(params, x, a, b, skip):
                kw = {}
                if case["boundary"]:
                    kw["boundary"] = ((a, b), skip)
                elif case["affine"]:
                    kw["bn_fold"] = (a, b)
                out = mod.apply({"params": params}, x, **kw)
                y, r = (out[0], out[2]) if case["boundary"] else (out, None)
                loss = jnp.sum(y * ct)
                if r is not None:
                    loss = loss + jnp.sum(r * cr)
                s1, s2 = jnp.sum(y, (0, 1, 2)), jnp.sum(y * y, (0, 1, 2))
                if case["stats"]:
                    loss = loss + jnp.sum(gs1 * s1) + jnp.sum(gs2 * s2)
                return loss, (y, jnp.stack([s1, s2])[None])

            (_, (y, st)), grads = jax.value_and_grad(
                loss_fn, argnums=(0, 1, 2, 3, 4), has_aux=True)(params, x, a, b, skip)
        gp, gx, ga, gb, gskip = grads
        return (y, st, lax.psum(gp, "spatial"), gx, lax.psum(ga, "spatial"),
                lax.psum(gb, "spatial"), gskip)

    jm = jax_mesh.make_mesh(spatial=S, devices=jax.devices()[:S])
    f = jax.shard_map(body, mesh=jm, in_specs=(whole, *specs, sharded, sharded, whole, whole),
                      out_specs=(sharded, P("spatial"), whole, sharded, whole, whole, sharded),
                      check_vma=False)
    params = {"depthwise": {"kernel": case["dw"]}, "pointwise": {"kernel": case["pw"]}}
    y, st, gp, gx, ga, gb, gskip = jax.jit(f)(
        params, *[jnp.asarray(case[k]) for k in names + ["ct", "cr", "gs1", "gs2"]])
    out = {"y": np.asarray(y), "dx": np.asarray(gx),
           "ddw": np.asarray(gp["depthwise"]["kernel"]),
           "dpw": np.asarray(gp["pointwise"]["kernel"]),
           "da": np.asarray(ga), "db": np.asarray(gb), "dskip": np.asarray(gskip)}
    out["stats"] = np.asarray(st)  # (S, 2, F): each shard's sums
    return out


def test_sepconv_units_match_jax_spatial_path(tmp_path):
    """Each form (pre-ReLU at dilations 1 and 2, affine_stats at 2,
    boundary_stats, the stride-2 tail with the BN apply), sharded over the
    two ranks, against the JAX module's spatial path on the same shards:
    the joined output, each rank's emitted (Σy, Σy²) against the sums of
    the JAX output's rows on that shard, the gradients of x and of the
    boundary's skip (joined), and of the weights, a and b (summed over the
    ranks), each within 1e-5 of its largest value."""
    with ranks_of(tmp_path, "units") as results:
        wants = {form: _unit_jax(_unit_case(form)) for form in UNIT_FORMS}
    for form, want in wants.items():
        case = _unit_case(form)
        ranks = [r[form] for r in results]
        errs = {"y": _rel(_joined([r["y"] for r in ranks], 1), want["y"]),
                "dx": _rel(_joined([r["dx"] for r in ranks], 1), want["dx"])}
        for k in ("ddw", "dpw", "da", "db"):
            if k in ranks[0]:
                errs[k] = _rel(sum(r[k] for r in ranks), want[k])
        if "dskip" in ranks[0]:
            errs["dskip"] = _rel(_joined([r["dskip"] for r in ranks], 1), want["dskip"])
        if case["stats"]:
            for i, r in enumerate(ranks):
                for j, k in enumerate(("s1", "s2")):
                    errs[f"{k}_rank{i}"] = _rel(r[k], want["stats"][i, j])
        bad = {k: v for k, v in errs.items() if not v <= TOL}
        assert not bad, (form, bad)


def _unsharded_unit(case):
    return _unit_port(case, slice(None))


def test_overlapping_strips_match_the_unsharded_unit(tmp_path):
    """3-row shards at dilation 2 on three ranks (d ≤ H_shard < 2d, as the
    exit flow at S=3): the middle rank's middle row takes both strips, and
    the affine_stats unit's output, statistics (summed over the ranks, with
    the cross term of Σy²) and gradients match the port's unsharded unit
    within 1e-5.  JAX's fused path drops that cross term; its value is not
    the reference here."""
    case = _unit_case("overlap", OVERLAP_X)
    with ranks_of(tmp_path, "overlap", OVERLAP_S) as results:
        want = _unsharded_unit(case)
    ranks = [r["overlap"] for r in results]
    assert len(ranks) == OVERLAP_S and ranks[1]["y"].shape[1] == 3 and case["dilation"] == 2
    errs = {k: _rel(_joined([r[k] for r in ranks], 1), want[k]) for k in ("y", "dx")}
    for k in ("s1", "s2", "ddw", "dpw", "da", "db"):
        errs[k] = _rel(sum(r[k] for r in ranks), want[k])
    assert max(errs.values()) <= TOL, errs


# ---------------------------------------------------------------------------
# the other hooks, against the port's unsharded modules
# ---------------------------------------------------------------------------

def test_hooks_match_the_unsharded_modules(tmp_path):
    """3x3 convs (stride 1 at dilations 1 and 2, stride 2), the x2 deconv,
    BN in train mode reducing x itself and from kernel-style statistics,
    and the ASPP region on gathered rows: the joined output, the joined
    input gradient and each parameter's gradient summed over the ranks
    within 1e-5 of the unsharded module's; BN's running statistics (the
    unbiased variance over the group's count) the same on both ranks and
    within 1e-6 of the unsharded ones."""
    with ranks_of(tmp_path, "hooks") as results:
        wants = {name: _hook_port(name, slice(None)) for name in HOOKS}
    for name, want in wants.items():
        ranks = [r[name] for r in results]
        errs = {"y": _rel(_joined([r["y"] for r in ranks], 2), want["y"]),
                "dx": _rel(_joined([r["dx"] for r in ranks], 2), want["dx"])}
        assert sorted(ranks[0]["grads"]) == sorted(want["grads"]), name
        for k, g in want["grads"].items():
            errs[k] = _rel(sum(r["grads"][k] for r in ranks), g)
        assert max(errs.values()) <= TOL, (name, errs)
        for k, v in want["running"].items():
            assert np.array_equal(ranks[0]["running"][k], ranks[1]["running"][k]), (name, k)
            assert _rel(ranks[0]["running"][k], v) <= 1e-6, (name, k)
        if name.startswith("bn") or name == "aspp":
            assert want["running"], name


def test_spatial_mode_of_one_rank_is_the_same_bits():
    """``spatial_mode`` with S=1 has nothing to exchange and changes
    nothing: a train-mode step of the whole model gives the same logits,
    gradients and running statistics, bit for bit, as no mode."""
    x = torch.rand(1, 32, 48, 16, generator=torch.Generator().manual_seed(3))

    def run(mode):
        model = _model().train()
        with spatial.spatial_mode(None, 1) if mode else contextlib.nullcontext():
            assert spatial.spatial_active() is False
            y = model(x)
        (y * y).sum().backward()
        return ([y.detach()] + [p.grad for p in model.parameters()]
                + [b.clone() for b in model.buffers()])

    for a, b in zip(run(False), run(True), strict=True):
        assert torch.equal(a, b)


def _odd_shard_errors():
    """The errors of what the strips cannot correct, on H-shards of two
    ranks (each check raises before any exchange)."""
    gen = torch.Generator().manual_seed(0)
    cases = [
        (layers.Conv2d(4, 4, 3, stride=2, padding=1, gen=gen), torch.randn(1, 4, 5, 6)),
        (layers.SeparableConv2dSame(4, 8, stride=2, gen=gen), torch.randn(1, 4, 3, 6)),
        (layers.SeparableConv2dSame(8, 8, dilation=2, gen=gen), torch.randn(1, 8, 1, 6)),
        (_model(), torch.rand(1, 40, 48, 16)),
        (DeepLabv3plus(3, output_stride=8, decoder="interpolation", device="cpu"),
         torch.rand(1, 32, 48, 16)),
    ]
    errors = []
    for mod, x in cases:
        try:
            mod(x)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    return errors


def test_odd_shards_raise(tmp_path):
    """What the strips cannot correct raises on every rank, naming the
    fix: an odd shard at a stride-2 conv and at a stride-2 sepconv tail, a
    shard shorter than the dilation, an input H not divisible by 16·S,
    the interpolation decoder; and a dataset whose H does not split into
    the shards (a shard's rows and the whole sample otherwise)."""
    want = ["stride-2 op", "stride-2 op", "shorter than the dilation 2",
            "divisible by 16·S", "deconv decoder only"]
    from deepcam_tpu_torch.data.dataset import MemoryCamDataset

    files = {"train/0.h5": (np.zeros((8, 4, 16), np.float32), np.zeros((8, 4), np.int32))}
    stats = {"minval": np.zeros(16, np.float32), "maxval": np.ones(16, np.float32)}
    with ranks_of(tmp_path, "errors") as results:
        with pytest.raises(ValueError, match="does not split into 3"):
            MemoryCamDataset("train", "stats.h5", range(16), files=files, stats=stats,
                             h_shard=(0, 3))
        shard = MemoryCamDataset("train", "stats.h5", range(16), files=files, stats=stats,
                                 h_shard=(1, 2))
        assert (shard.data_shape, shard.label_shape) == ((4, 4, 16), (4, 4))
        assert shard[0][0].shape == (4, 4, 16) and shard.full_sample("train/0.h5")[1].shape == (8, 4)
    for errors in results:
        assert len(errors) == len(want)
        for got, w in zip(errors, want):
            assert got is not None and w in got, (got, w)


# ---------------------------------------------------------------------------
# the train and eval steps
# ---------------------------------------------------------------------------

def _unsharded_steps(train):
    """The port's one-process step (``make_train_step``) on the global
    batches: what the spatial group computes as one DDP rank."""
    model = _model()
    state = create_train_state(model, build_optimizer("AdamW", model.parameters(), LR,
                                                      eps=EPS, weight_decay=WD))
    step = make_train_step(tl.class_weights(), fpw_1=tl.FPW_1, fpw_2=tl.FPW_2)
    metrics = []
    for x, y in train:
        state, m = step(state, _to(x), _to(y))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _trees(model)


def _entry_diffs(a, b):
    return np.concatenate([np.abs(a[k] - b[k]).ravel() for k in b])


def _leaf_errs(a, b):
    return np.array([np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), 1e-30) for k in b])


def _jax_spatial_steps(train):
    """JAX's ``make_train_step_spatial`` on a (1, 2) mesh from the port's
    initial weights: the metrics, parameters and running statistics."""
    import jax
    import jax.numpy as jnp

    from deepcam_tpu.core import mesh as jax_mesh
    from deepcam_tpu.models.deeplab import DeepLabv3plus as JaxDeepLab
    from deepcam_tpu.parallel.spatial import make_train_step_spatial as jax_step_spatial
    from deepcam_tpu.train.optim import build_optimizer as jax_build_optimizer
    from deepcam_tpu.train.trainer import create_train_state as jax_create_state
    from tests.torch_port_ref import jax_default_config, port_variables

    variables = port_variables(SEED)
    with jax_default_config():
        jm = JaxDeepLab(n_classes=3, dtype=jnp.float32)
        jmesh = jax_mesh.make_mesh(spatial=S, devices=jax.devices()[:S])
        assert (jmesh.shape["data"], jmesh.shape["spatial"]) == (1, S)
        tx = jax_build_optimizer("AdamW", LR, eps=EPS, weight_decay=WD)
        jstep = jax_step_spatial(jm, tx, list(tl.class_weights()), jmesh, fpw_1=tl.FPW_1,
                                 fpw_2=tl.FPW_2)
        state = jax.device_put(jax_create_state(jm, variables, tx),
                               jax_mesh.replicated(jmesh))
        ref_m = []
        for x, y in train:
            state, m = jstep(state, jax.device_put(x, jax_mesh.batch_sharding(jmesh)),
                             jax.device_put(y, jax_mesh.batch_sharding(jmesh)))
            ref_m.append({k: float(v) for k, v in m.items()})
        ref_p = flatten(jax.tree_util.tree_map(np.asarray, state.params))
        ref_s = flatten(jax.tree_util.tree_map(np.asarray, state.batch_stats))
        del state
    return ref_m, ref_p, ref_s


def test_spatial_steps_match_jax_and_the_unsharded_step(tmp_path):
    """Two spatial ranks' train steps against JAX's
    ``make_train_step_spatial`` on a (1, 2) mesh (XLA sepconv path, whose
    BN reduces y itself: right at the exit flow's 2-row shards at dilation
    2) and against the port's unsharded step, from the same weights and
    batches.  The ranks are bit-identical.  Step 1: loss within 1e-5
    relative of both; IoU within 1e-6 of JAX's, which sums the same
    shards, and within 2x the nudged spread of the unsharded step's (one
    pixel flips the argmax there: 1.35e-4 of IoU, as one of the nudges
    flips it).  Step 2, the parameters and the running statistics: within
    2x the port's own spread under a 1e-7 input nudge (NUDGES runs of the
    unsharded step), as in ``tests/test_torch_dist.py``."""
    from tests.torch_port_ref import port_variables

    with ranks_of(tmp_path, "steps") as results:
        train, _ = _batches()
        one_m, (one_p, one_s) = _unsharded_steps(train)
        nudged = [_unsharded_steps(_nudged(train, seed)) for seed in range(NUDGES)]
        ref_m, ref_p, ref_s = _jax_spatial_steps(train)
    r0, r1 = results
    assert r0["identical"] and r1["identical"] and r0["metrics"] == r1["metrics"]
    assert r0["remat_same_bits"] and r1["remat_same_bits"]
    assert r0["step"] == r1["step"] == 2
    port_m, (port_p, port_s) = r0["metrics"], r0["trees"]
    start = flatten(port_variables(SEED)["params"])

    spread_loss = max(abs(m[1]["loss"] - one_m[1]["loss"]) for m, _ in nudged)
    spread_iou = max(abs(m[0]["iou"] - one_m[0]["iou"]) for m, _ in nudged)
    nudge_p = [_entry_diffs(p, one_p) for _, (p, _) in nudged]
    nudge_s = [_leaf_errs(s, one_s) for _, (_, s) in nudged]
    assert np.median(_entry_diffs(start, one_p)) > LR
    for label, m, p, s in (("jax", ref_m, ref_p, ref_s), ("unsharded", one_m, one_p, one_s)):
        assert abs(port_m[0]["loss"] - m[0]["loss"]) <= 1e-5 * m[0]["loss"], label
        # JAX shards the same sums: tight; the unsharded sums in another order
        iou_tol = 1e-6 if label == "jax" else 2 * spread_iou + 1e-6
        assert abs(port_m[0]["iou"] - m[0]["iou"]) <= iou_tol, label
        assert abs(port_m[1]["loss"] - m[1]["loss"]) <= 2 * spread_loss + 1e-6 * m[1]["loss"]
        diffs = _entry_diffs(port_p, p)
        for q in (0.5, 0.99):
            assert np.quantile(diffs, q) <= 2 * max(np.quantile(n, q) for n in nudge_p), \
                (label, q)
        errs = _leaf_errs(port_s, s)
        assert np.median(errs) <= 2 * max(np.median(n) for n in nudge_s), label
        assert errs.max() <= 2 * max(n.max() for n in nudge_s), label


def test_spatial_eval_matches_jax_and_the_unsharded_eval(tmp_path):
    """The spatial eval step over 3 samples (the last masked out) from the
    initial weights: rank 0 returns (count, loss_sum, iou_sum) within 1e-5
    of JAX's ``make_eval_step_spatial`` on a (1, 2) mesh and of the
    port's unsharded ``make_eval_step``; rank 1 returns zeros, so that a
    sum over the ranks counts each sample once."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from deepcam_tpu.core import mesh as jax_mesh
    from deepcam_tpu.models.deeplab import DeepLabv3plus as JaxDeepLab
    from deepcam_tpu.parallel.spatial import make_eval_step_spatial as jax_eval_spatial
    from deepcam_tpu.train.optim import build_optimizer as jax_build_optimizer
    from deepcam_tpu.train.trainer import create_train_state as jax_create_state
    from tests.torch_port_ref import jax_default_config, port_variables

    with ranks_of(tmp_path, "eval") as results:
        _, (x, y) = _batches()
        valid = np.asarray(EVAL_VALID, np.float32)
        model = _model()
        one = make_eval_step(tl.class_weights(), fpw_1=tl.FPW_1, fpw_2=tl.FPW_2)(
            create_train_state(model, build_optimizer("AdamW", model.parameters(), LR)),
            _to(x), _to(y), _to(valid))
        with jax_default_config():
            jm = JaxDeepLab(n_classes=3, dtype=jnp.float32)
            jmesh = jax_mesh.make_mesh(spatial=S, devices=jax.devices()[:S])
            tx = jax_build_optimizer("AdamW", LR)
            state = jax.device_put(jax_create_state(jm, port_variables(SEED), tx),
                                   jax_mesh.replicated(jmesh))
            ref = jax_eval_spatial(jm, list(tl.class_weights()), jmesh, fpw_1=tl.FPW_1,
                                   fpw_2=tl.FPW_2)(
                state, jax.device_put(x, jax_mesh.batch_sharding(jmesh)),
                jax.device_put(y, jax_mesh.batch_sharding(jmesh)),
                jax.device_put(valid, NamedSharding(jmesh, P("data"))))
    r0, r1 = results
    assert r1 == [0.0, 0.0, 0.0]
    for want in ([float(t) for t in ref], [float(t) for t in one]):
        assert r0[0] == want[0] == 2.0
        for got, w in zip(r0[1:], want[1:]):
            assert abs(got - w) <= TOL * abs(w), (r0, want)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--spatial_impl", "gspmd", "--remat"]],
                         ids=["shard_map", "gspmd_remat"])
def test_two_process_spatial_cli_run(tmp_path, extra):
    """``cli/train.py:main`` with ``--spatial 2`` on two ranks: one data
    group, local batch 1 per group, over 2 train and 3 validation samples
    of (64, 48, 16): 2 steps on each rank, one validation that counts each
    sample once, one save, one training plot (a whole sample, unsharded),
    all from rank 0 alone; the MLPerf keys.  The same with
    ``--spatial_impl gspmd --remat``: the gspmd step (statistics over the
    world, here the group), rematerialized, and the spatial eval step."""
    from deepcam_tpu_torch.data.synthetic import make_synthetic_dataset
    from deepcam_tpu_torch.obs.mlperf_log import parse_mllog

    pytest.importorskip("matplotlib")
    root = make_synthetic_dataset(str(tmp_path / "data"), n_train=2, n_validation=3,
                                  shape=SHAPE, seed=1)
    out = tmp_path / "out"
    try:
        r0, r1 = spawn_ranks(tmp_path / "cli", "tests.test_torch_spatial", "cli", S,
                             root=root, out=str(out), extra=extra)
        for r in (r0, r1):
            assert (r["step"], r["epoch"], r["eval_samples_seen"]) == (2, 1, 3.0), r
        assert r0["eval_iou"] == r1["eval_iou"] and 0.0 <= r0["eval_iou"] <= 1.0
        assert not (out / "rank1").exists()
        assert sorted(os.listdir(out / "rank0")) == ["logs", "model_step_2.cpt", "plots"]
        plots = os.listdir(out / "rank0" / "plots")
        assert len(plots) == 1 and plots[0].startswith("training-"), plots
        recs = parse_mllog(str(out / "rank0" / "logs" / "spatial.log"))
        by = {r["key"]: r["value"] for r in recs}
        assert (by["global_batch_size"], by["train_samples"], by["eval_samples"]) == (1, 2, 3)
        assert [r["key"] for r in recs].count("train_loss") == 2
        assert [r["key"] for r in recs].count("eval_accuracy") == 1
    finally:
        for f in tmp_path.rglob("*.cpt"):
            f.unlink()  # 678 MB: tmp directories outlive the run
