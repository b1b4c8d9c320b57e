"""The port's gspmd step (``parallel/gspmd.py``) on the CPU: four rank
processes in one gloo group, two data groups of two spatial ranks (D=2,
S=2), spawned once per test run and shared by the tests of this file
(``tests/torch_port_ref.py:shared_once``); fp32 on the kernels' plain
versions, the JAX default configuration.  A global batch of 4 at (64, 32,
16): data group g holds samples 2g and 2g+1, each of its ranks half their
rows.

* The train step against JAX's ``make_train_step_gspmd`` on a (data 2,
  spatial 2) mesh of the 8-device CPU mesh (XLA sepconv path).
* Two steps and the eval of the trained state against the port's
  one-process steps on the global batch (the math of one device), and the
  spatial step's group-only statistics on the same ranks, which this path
  must not reproduce.
* The gathered ASPP region's BN counts the data groups, not the ranks.
* ``remat=True`` gives the same bits.
"""

import json
import pickle
from datetime import timedelta

import numpy as np
import pytest
import torch

from deepcam_tpu_torch.core import mesh
from deepcam_tpu_torch.models.deeplab import DeepLabv3plus
from deepcam_tpu_torch.parallel import collectives, spatial
from deepcam_tpu_torch.parallel.gspmd import global_score, make_train_step_gspmd
from deepcam_tpu_torch.tools.weights import load_jax_variables, state_dict_to_jax
from deepcam_tpu_torch.train import losses as tl
from deepcam_tpu_torch.train.metrics import compute_score
from deepcam_tpu_torch.train.optim import build_optimizer
from deepcam_tpu_torch.train.trainer import (average_running_stats, create_train_state,
                                             make_eval_step, make_train_step, running_stats)
from tests.torch_port_ref import flatten, release_memory  # noqa: F401  (autouse)
from tests.torch_port_ref import few_torch_threads  # noqa: F401
from tests.torch_port_ref import _release_freed_memory, bits_digest, shared_once, start_ranks

pytestmark = pytest.mark.usefixtures("few_torch_threads")

W, S = 4, 2
D = W // S
SEED = 21
LR, EPS, WD = 1e-3, 1e-8, 1e-2
SHAPE = (64, 32)
EVAL_VALID = (1.0, 1.0, 1.0, 0.0)
NUDGES = 2
# the ASPP region's input: (N, 2048, H/16, W/16) features of the global batch
ASPP_FEATS = (2 * D, 2048, 4, 6)


def _to(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _model():
    return DeepLabv3plus(3, dtype=torch.float32, device="cpu", seed=SEED)


def _state(model):
    return create_train_state(model, build_optimizer("AdamW", model.parameters(), LR,
                                                     eps=EPS, weight_decay=WD))


def _weights():
    return dict(class_weights=tl.class_weights(), fpw_1=tl.FPW_1, fpw_2=tl.FPW_2)


def _batches():
    """Two global batches of 4 at SHAPE, and an eval batch of 4."""
    rng = np.random.RandomState(6)

    def batch():
        return (rng.rand(2 * D, *SHAPE, 16).astype(np.float32),
                rng.randint(0, 3, size=(2 * D, *SHAPE)).astype(np.int32))

    return [batch() for _ in range(2)], batch()


def _nudged(train, seed, nudge=1e-7):
    rng = np.random.RandomState(300 + seed)
    return [((x * (1 + nudge * rng.randn(*x.shape))).astype(np.float32), y) for x, y in train]


def _score_case():
    """Global (N, H, W) predictions and labels for ``global_score``."""
    rng = np.random.RandomState(7)
    return (rng.randint(0, 3, size=(2 * D, 8, 6)).astype(np.int32),
            rng.randint(0, 3, size=(2 * D, 8, 6)).astype(np.int32))


def _aspp_case():
    gen = torch.Generator().manual_seed(5)
    feats = torch.randn(*ASPP_FEATS, generator=gen)
    return feats, torch.randn(ASPP_FEATS[0], 256, *ASPP_FEATS[2:], generator=gen)


def _aspp(feats, ct):
    """The model's ASPP region in train mode on ``feats``: its output, the
    input gradient and the parameter gradients of Σ y·ct, and the running
    statistics it leaves."""
    model = _model().train()
    feats = feats.contiguous(memory_format=torch.channels_last).requires_grad_()
    y = model.aspp(feats)
    (y * ct).sum().backward()
    mods = {k: m for k, m in model.named_children() if k.startswith(("aspp", "gap_", "conv1", "bn1"))}
    return {"y": y.detach().numpy(), "dx": feats.grad.numpy(),
            "grads": {f"{k}.{n}": p.grad.numpy().copy() for k, m in mods.items()
                      for n, p in m.named_parameters()},
            "running": {f"{k}.{n}": b.numpy().copy() for k, m in mods.items()
                        for n, b in m.named_buffers() if "running" in n}}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _share(h):
    """This rank's (samples, rows) of a global batch whose samples are H
    ``h`` high: its data group's samples, its rows of each."""
    g = mesh.spatial_groups()
    rows = h // S
    return (slice(2 * g.data_index, 2 * g.data_index + 2),
            slice(g.index * rows, (g.index + 1) * rows))


def _mine(a):
    """This rank's share of a global NHWC (or NHW) array, as a tensor."""
    samples, rows = _share(a.shape[1])
    return _to(a[samples, rows])


def _mine_nchw(t):
    """This rank's share of a global NCHW tensor."""
    samples, rows = _share(t.shape[2])
    return t[samples, :, rows]


def _stats(model):
    return flatten(state_dict_to_jax(model, model.state_dict())[1])


def _run(make, remat, train):
    """2 steps of ``make``'s step on this rank's shares: the state, the
    metrics and the running statistics after step 1 (flat)."""
    model = _model()
    state = _state(model)
    step = make(**_weights(), remat=remat)
    metrics, first = [], None
    for x, y in train:
        state, m = step(state, _mine(x), _mine(y))
        metrics.append({k: float(v) for k, v in m.items()})
        first = first or _stats(model)
    return state, metrics, first


def _rank_run():
    """2 gspmd steps, the same with remat (compared bit for bit here), the
    group-only statistics of step 1, the eval of the gspmd state, the ASPP
    region under world statistics and ``global_score``."""
    groups = mesh.spatial_groups()
    assert (groups.size, groups.data_size) == (S, D)
    train, (xe, ye) = _batches()
    state, metrics, first = _run(make_train_step_gspmd, False, train)
    model = state.model
    digest = bits_digest(model)
    out = {"metrics": metrics, "step": state.step, "stats1": first,
           "identical": len(set(collectives.allgather_object(digest))) == 1}
    if groups.index == 0 and groups.data_index == 0:
        out["trees"] = state_dict_to_jax(model, model.state_dict())
    valid = _to(np.asarray(EVAL_VALID, np.float32)[2 * groups.data_index:][:2])
    eval_fn = spatial.make_eval_step_spatial(**_weights())
    out["eval"] = [float(t) for t in eval_fn(state, _mine(xe), _mine(ye), valid)]
    del state, model
    rstate, rmetrics, _ = _run(make_train_step_gspmd, True, train)
    out["remat_same_bits"] = rmetrics == metrics and bits_digest(rstate.model) == digest
    del rstate
    # the spatial step's group-only statistics after step 1: each spatial group's own
    # (one train-mode forward under the default statistics group), then
    # averaged over the ranks as its step averages them
    gmodel = _model().train()
    with torch.no_grad(), spatial.spatial_mode(groups.group, groups.size):
        gmodel(_mine(train[0][0]))
        average_running_stats(gmodel)
    out["group_only_stats1"] = _stats(gmodel)
    del gmodel
    feats, ct = _aspp_case()
    with spatial.spatial_mode(groups.group, groups.size, world_stats=True):
        out["aspp"] = _aspp(_mine_nchw(feats), _mine_nchw(ct))
    preds, labels = _score_case()
    out["score"] = [float(t) for t in global_score(_mine(preds), _mine(labels), 3,
                                                   torch.tensor(float(mesh.get_rank())))]
    return out


def rank_main(job: str) -> None:
    """Entry of a rank process: joins the gloo group through the job's file
    store, splits it into spatial groups of S, runs ``_rank_run`` and
    pickles its result."""
    job = json.loads(job)
    torch.set_num_threads(1)  # four ranks: one thread each
    torch.distributed.init_process_group(
        "gloo", init_method="file://" + job["store"], rank=job["rank"],
        world_size=job["world"], timeout=timedelta(seconds=120))
    try:
        mesh.init_spatial_groups(S)
        result = _rank_run()
        with open(job["result"], "wb") as f:
            pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)
    finally:
        mesh.destroy_distributed()


# ---------------------------------------------------------------------------
# one device on the global batch, computed while the ranks run
# ---------------------------------------------------------------------------

def _one_device(train):
    """The port's one-process step on the global batches: metrics, the
    (params, stats) trees (flat), and the running statistics after step
    1."""
    model = _model()
    state = _state(model)
    step = make_train_step(**_weights())
    metrics, first = [], None
    for x, y in train:
        state, m = step(state, _to(x), _to(y))
        metrics.append({k: float(v) for k, v in m.items()})
        first = first or _stats(model)
    params, stats = state_dict_to_jax(model, model.state_dict())
    return metrics, flatten(params), flatten(stats), first


def _jax_step1(train):
    """Step 1's metrics of JAX's ``make_train_step_gspmd`` on a (2, 2) mesh
    (XLA sepconv path, the JAX default configuration) from the port's
    initial weights.  Its compiled code is dropped after."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from deepcam_tpu.core import mesh as jax_mesh
    from deepcam_tpu.models.deeplab import DeepLabv3plus as JaxDeepLab
    from deepcam_tpu.parallel.gspmd import make_train_step_gspmd as jstep
    from deepcam_tpu.train.optim import build_optimizer as jax_build_optimizer
    from deepcam_tpu.train.trainer import create_train_state as jax_create_state
    from tests.torch_port_ref import jax_default_config, port_variables

    with jax_default_config():
        jm = JaxDeepLab(n_classes=3, dtype=jnp.float32)
        jmesh = jax_mesh.make_mesh(spatial=S, devices=jax.devices()[:W])
        assert (jmesh.shape["data"], jmesh.shape["spatial"]) == (D, S)
        sharded = NamedSharding(jmesh, P("data", "spatial"))
        tx = jax_build_optimizer("AdamW", LR, eps=EPS, weight_decay=WD)
        step = jstep(jm, tx, list(tl.class_weights()), jmesh, fpw_1=tl.FPW_1, fpw_2=tl.FPW_2)
        state = jax.device_put(jax_create_state(jm, port_variables(SEED), tx),
                               jax_mesh.replicated(jmesh))
        x, y = train[0]
        _, m = step(state, jax.device_put(x, sharded), jax.device_put(y, sharded))
        metrics = {k: float(v) for k, v in m.items()}
        del state, step, m
    jax.clear_caches()
    return metrics


def _compute(tmp):
    """The ranks with the one-process references beside them, then JAX:
    the suite runs several workers on one machine, and the four ranks and
    the JAX compile each take several GB, so they never overlap."""
    train, _ = _batches()
    wait = start_ranks(tmp, "tests.test_torch_gspmd", "gspmd", W)
    ranks = []
    try:
        one = _one_device(train)
        nudged = [_one_device(_nudged(train, seed))[:3] for seed in range(NUDGES)]
        aspp = _aspp(*_aspp_case())
    finally:
        ranks.extend(wait())
    _release_freed_memory()
    return {"ranks": ranks, "one": one, "nudged": nudged, "aspp": aspp,
            "jax": _jax_step1(train)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return shared_once(tmp_path_factory, "torch_gspmd_ranks",
                       lambda: _compute(tmp_path_factory.mktemp("gspmd")))


def _entry_diffs(a, b):
    return np.concatenate([np.abs(a[k] - b[k]).ravel() for k in b])


def _leaf_errs(a, b):
    return np.array([np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), 1e-30) for k in b])


def _rel(got, want):
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


def _eval_sums(ranks):
    """The eval's (count, loss_sum, iou_sum) summed over the ranks, as
    ``cli/train.py:validate`` sums them."""
    return [sum(r["eval"][i] for r in ranks) for i in range(3)]


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_gspmd_steps_match_jax_and_one_device_on_the_global_batch(run):
    """The four ranks are bit-identical in parameters and running
    statistics after 2 steps, without an average of the statistics.

    Against JAX's ``make_train_step_gspmd`` on a (2, 2) mesh (XLA sepconv
    path, the JAX default configuration) from the port's initial weights:
    step 1's loss within 1e-5 relative, both the global batch's; its IoU
    within 2x the spread of the one-process step's IoU under a 1e-7 input
    nudge: JAX sums the statistics in another order, and at the random
    initial weights argmax ties are close enough that a pixel flips (at
    (64, 48): 7.5e-6 from JAX, where the nudges moved the one-process IoU
    by up to 1.1e-4).

    Against the port's one-process step on the global batch of 4: step 1's
    loss within 1e-5 relative and IoU within 2x the nudged spread; step 2's
    loss, the parameters and the running statistics within 2x the port's
    own spread under a 1e-7 input nudge (NUDGES runs), as
    ``tests/test_torch_spatial.py`` holds the halo step.  The world sync
    shows in the running statistics: after step 1 (the same weights
    everywhere) within 1e-5 of the one-process ones on every leaf, where
    the spatial step's group-only statistics (each data group's batch of
    2, then averaged over the groups, from the same ranks) are more than
    100x further (the variance of 2 samples, not 4).  The eval of the
    trained state equals the one-process eval of the same weights within
    1e-5."""
    ref = run["jax"]
    got = run["ranks"][0]["metrics"][0]
    assert abs(got["loss"] - ref["loss"]) <= 1e-5 * ref["loss"], (got, ref)
    one_iou = run["one"][0][0]["iou"]
    spread_jax_iou = max(abs(m[0]["iou"] - one_iou) for m, _, _ in run["nudged"])
    assert abs(got["iou"] - ref["iou"]) <= 2 * spread_jax_iou + 1e-6, (got, ref)

    ranks, (one_m, one_p, one_s, one_s1), nudged = (run["ranks"], run["one"],
                                                    run["nudged"])
    assert all(r["identical"] and r["step"] == 2 for r in ranks)
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    port_m = ranks[0]["metrics"]
    port_p, port_s = (flatten(t) for t in ranks[0]["trees"])

    spread_loss = max(abs(m[1]["loss"] - one_m[1]["loss"]) for m, _, _ in nudged)
    spread_iou = max(abs(m[0]["iou"] - one_m[0]["iou"]) for m, _, _ in nudged)
    assert abs(port_m[0]["loss"] - one_m[0]["loss"]) <= 1e-5 * one_m[0]["loss"]
    assert abs(port_m[0]["iou"] - one_m[0]["iou"]) <= 2 * spread_iou + 1e-6
    assert abs(port_m[1]["loss"] - one_m[1]["loss"]) <= 2 * spread_loss + 1e-6 * one_m[1]["loss"]
    diffs, nudge_p = _entry_diffs(port_p, one_p), [_entry_diffs(p, one_p) for _, p, _ in nudged]
    for q in (0.5, 0.99):
        assert np.quantile(diffs, q) <= 2 * max(np.quantile(n, q) for n in nudge_p), q
    errs, nudge_s = _leaf_errs(port_s, one_s), [_leaf_errs(s, one_s) for _, _, s in nudged]
    limit = 2 * max(n.max() for n in nudge_s)
    assert np.median(errs) <= 2 * max(np.median(n) for n in nudge_s)
    assert errs.max() <= limit
    world1 = max(_leaf_errs(r["stats1"], one_s1).max() for r in ranks)
    group1 = _leaf_errs(ranks[0]["group_only_stats1"], one_s1).max()
    assert world1 <= 1e-5, world1
    assert group1 > 100 * world1, (group1, world1)

    model = _model()
    load_jax_variables(model, *ranks[0]["trees"])
    _, (xe, ye) = _batches()
    want = [float(t) for t in make_eval_step(**_weights())(
        _state(model), _to(xe), _to(ye), _to(np.asarray(EVAL_VALID, np.float32)))]
    sums = _eval_sums(ranks)
    assert sums[0] == want[0]
    for g, w in zip(sums[1:], want[1:]):
        assert abs(g - w) <= 1e-5 * abs(w), (sums, want)


def test_gspmd_region_score_and_remat(run):
    """The gathered ASPP region under world statistics, where every rank
    of a group holds the same full-H rows of its group's 2 samples: its
    BNs average over the 2 data groups with the count times D, so their
    running variance (unbiased over 4·4·6 = 96 pixels) and means equal
    the unsharded region's on the 4 samples within 1e-6 on every rank (a
    count times W would scale the variance's update by 1.0053); the output
    and input gradient joined, and each parameter's gradient summed over
    the ranks, within 1e-5.

    ``global_score`` on each rank's share of (4, 8, 6) predictions and
    labels: the loss the mean of the ranks' (0, 1, 2, 3), and the IoU
    ``compute_score`` of the whole global batch (counts summed before the
    ratio), within 1e-7, the same on every rank.

    ``make_train_step_gspmd(remat=True)`` on the same ranks from the same
    weights: after 2 steps the metrics, every parameter, gradient and
    running statistic equal the step without remat bit for bit, on every
    rank."""
    regions, want = [r["aspp"] for r in run["ranks"]], run["aspp"]

    def joined(key):  # rows within a group, then the groups' samples
        return np.concatenate([np.concatenate([regions[g * S + i][key] for i in range(S)], 2)
                               for g in range(D)], 0)

    errs = {k: _rel(joined(k), want[k]) for k in ("y", "dx")}
    assert sorted(regions[0]["grads"]) == sorted(want["grads"])
    for k, g in want["grads"].items():
        errs[k] = _rel(sum(r["grads"][k] for r in regions), g)
    assert max(errs.values()) <= 1e-5, errs
    assert len(want["running"]) == 12  # 4 atrous branches, the GAP branch, bn1
    for k, v in want["running"].items():
        assert all(np.array_equal(r["running"][k], regions[0]["running"][k]) for r in regions), k
        assert _rel(regions[0]["running"][k], v) <= 1e-6, k

    preds, labels = _score_case()
    score = float(compute_score(_to(preds), _to(labels), 3))
    for r in run["ranks"]:
        assert r["score"] == run["ranks"][0]["score"]
        assert r["score"][0] == 1.5 and abs(r["score"][1] - score) <= 1e-7, (r["score"], score)
    assert all(r["remat_same_bits"] for r in run["ranks"])
