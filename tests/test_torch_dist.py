"""The port's data parallelism on the CPU: two processes in a gloo group.

Ranks are separate Python processes joined through a ``file://`` store in
the test's tmp directory (no port, so test workers never collide), each
with torch capped at 2 threads.

* The two-rank train step (2 AdamW steps, global batch 4 at (32, 48, 16),
  2 samples per rank, the JAX default configuration) against the JAX
  package's ``make_train_step`` on a 2-device mesh, and against an
  in-process emulation of the two ranks (per-rank BN, averaged gradients,
  one update, averaged running statistics).  The ranks are bit-identical
  to each other, and the same steps with ``remat=True`` to them.
* Validation over uneven shards (5 samples: 2 and 3) against one process.
* A 2-process run of the CLI.
* The wireup: when ``init_distributed`` initializes, and when it raises.
"""

import functools
import json
import os
import pickle
import socket
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

from deepcam_tpu_torch.cli.train import validate
from deepcam_tpu_torch.core import mesh
from deepcam_tpu_torch.data.pipeline import DataLoader
from deepcam_tpu_torch.models.deeplab import DeepLabv3plus
from deepcam_tpu_torch.ops.classify import argmax_channels
from deepcam_tpu_torch.parallel import collectives
from deepcam_tpu_torch.tools.weights import load_jax_variables, state_dict_to_jax
from deepcam_tpu_torch.train import losses as tl
from deepcam_tpu_torch.train.metrics import compute_score
from deepcam_tpu_torch.train.optim import build_optimizer
from deepcam_tpu_torch.train.trainer import (create_train_state, make_eval_step,
                                             make_train_step, running_stats)
from tests.torch_port_ref import flatten, release_memory  # noqa: F401  (autouse)
from tests.torch_port_ref import few_torch_threads  # noqa: F401
from tests.torch_port_ref import bits_digest, shared_once, spawn_ranks

pytestmark = pytest.mark.usefixtures("few_torch_threads")

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
SEED = 21
LR, EPS, WD = 1e-3, 1e-8, 1e-2
SHAPE = (32, 48)
EVAL_SAMPLES, EVAL_BATCH = 5, 2
NUDGES = 3


def _batches():
    """Two global batches of 4 (2 per rank), and the 5 validation samples."""
    rng = np.random.RandomState(3)
    train = [(rng.rand(2 * WORLD, *SHAPE, 16).astype(np.float32),
              rng.randint(0, 3, size=(2 * WORLD, *SHAPE)).astype(np.int32))
             for _ in range(2)]
    val = (rng.rand(EVAL_SAMPLES, *SHAPE, 16).astype(np.float32),
           rng.randint(0, 3, size=(EVAL_SAMPLES, *SHAPE)).astype(np.int32))
    return train, val


def _nudged(train, seed, nudge=1e-7):
    rng = np.random.RandomState(100 + seed)
    return [((x * (1 + nudge * rng.randn(*x.shape))).astype(np.float32), y) for x, y in train]


def _shard(a, rank):
    return torch.from_numpy(a[2 * rank:2 * rank + 2])


def _model():
    return DeepLabv3plus(3, dtype=torch.float32, device="cpu", seed=SEED)


def _trees(model):
    params, stats = state_dict_to_jax(model, model.state_dict())
    return flatten(params), flatten(stats)


# ---------------------------------------------------------------------------
# the ranks: separate processes
# ---------------------------------------------------------------------------

def _validation_shard(rank):
    """This rank's shard of the 5 validation samples as the CLI builds it
    (the last rank takes the remainder: 2 and 3 samples), served from
    memory, with stats that make the normalization the identity."""
    from deepcam_tpu_torch.data.dataset import MemoryCamDataset

    _, (x, y) = _batches()
    files = {f"validation/{i}.h5": (x[i], y[i]) for i in range(EVAL_SAMPLES)}
    stats = {"minval": np.zeros(16, np.float32), "maxval": np.ones(16, np.float32)}
    return MemoryCamDataset("validation", "stats.h5", range(16), files=files, stats=stats,
                            allow_uneven_distribution=True, comm_size=WORLD,
                            comm_rank=rank)


def _train(rank, remat):
    """2 train steps on this rank's shard: the state and the metrics."""
    model = _model()
    state = create_train_state(model, build_optimizer("AdamW", model.parameters(), LR,
                                                      eps=EPS, weight_decay=WD))
    step = make_train_step(tl.class_weights(), fpw_1=tl.FPW_1, fpw_2=tl.FPW_2, remat=remat)
    train, _ = _batches()
    metrics = []
    for x, y in train:
        state, m = step(state, _shard(x, rank), _shard(y, rank))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _rank_steps(rank):
    """2 train steps on this rank's shard, the same steps with remat
    (compared bit for bit here), then the CLI's validation over its
    validation shard.  Returns the metrics, whether the ranks' parameters
    and running statistics are bit-identical, whether remat gave the same
    bits, the eval sums, and (rank 0) the trees."""
    assert collectives.allreduce_sum_scalar(rank + 1) == 3.0
    assert collectives.broadcast_from_host0(rank) == 0
    collectives.barrier()
    state, metrics = _train(rank, remat=False)
    model = state.model
    flat = torch.cat([t.detach().reshape(-1)
                      for t in list(model.parameters()) + running_stats(model)])
    lo, hi = flat.clone(), flat.clone()
    torch.distributed.all_reduce(lo, op=torch.distributed.ReduceOp.MIN)
    torch.distributed.all_reduce(hi, op=torch.distributed.ReduceOp.MAX)
    eval_fn = make_eval_step(tl.class_weights(), fpw_1=tl.FPW_1, fpw_2=tl.FPW_2)
    shard = _validation_shard(rank)
    sums = validate(state, eval_fn, DataLoader(shard, EVAL_BATCH, num_workers=1,
                                               drop_last=False), "cpu")
    out = {"metrics": metrics, "identical": bool(torch.equal(lo, hi)),
           "eval": list(sums), "eval_shard": len(shard),
           "trees": _trees(model) if rank == 0 else None,
           "replica": type(state.replica).__name__, "step": state.step}
    digest = bits_digest(model)
    del state, model
    rstate, rmetrics = _train(rank, remat=True)
    out["remat_same_bits"] = rmetrics == metrics and bits_digest(rstate.model) == digest
    return out


def _rank_cli(rank, root, out):
    from deepcam_tpu_torch.cli.train import build_parser, main

    args = build_parser().parse_args([
        "--data_dir_prefix", root, "--output_dir", os.path.join(out, f"rank{rank}"),
        "--run_tag", "dist", "--optimizer", "LAMB", "--local_batch_size", "1",
        "--eval_local_batch_size", str(EVAL_BATCH), "--max_epochs", "1",
        "--logging_frequency", "1", "--validation_frequency", "2", "--save_frequency", "2",
        "--amp_opt_level", "O0", "--target_iou", "2.0", "--device", "cpu", "--seed", "333"])
    return main(args)


def rank_main(job: str) -> None:
    """Entry of a rank process: joins the gloo group through the job's file
    store, runs the job and pickles its result."""
    job = json.loads(job)
    torch.set_num_threads(2)
    rank = job["rank"]
    torch.distributed.init_process_group(
        "gloo", init_method="file://" + job["store"], rank=rank, world_size=WORLD,
        timeout=timedelta(seconds=120))
    try:
        assert mesh.init_distributed("auto", "cpu") is False  # adopts the group
        assert (mesh.get_rank(), mesh.get_size()) == (rank, WORLD)
        if job["kind"] == "steps":
            result = _rank_steps(rank)
        else:
            result = _rank_cli(rank, job["root"], job["out"])
        with open(job["result"], "wb") as f:
            pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)
    finally:
        mesh.destroy_distributed()


def _spawn(tmp, kind, **kw):
    """Runs ``kind`` on WORLD rank processes; returns their results."""
    return spawn_ranks(tmp, "tests.test_torch_dist", kind, WORLD, **kw)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' results, computed once per test run and shared by
    the run's workers (``shared_once``)."""
    return shared_once(tmp_path_factory, "torch_dist_ranks",
                       lambda: _spawn(tmp_path_factory.mktemp("ranks"), "steps"))


# ---------------------------------------------------------------------------
# the same two ranks in one process
# ---------------------------------------------------------------------------

def _emulate(train):
    """Two ranks' data-parallel steps in one process: each rank's forward
    and backward with its own BN batch statistics from the same running
    statistics, the gradients averaged, one AdamW update, the running
    statistics averaged (JAX's ``pmean(new_bs)``), loss and IoU averaged.
    Returns the metrics, the final trees and each rank's own running
    statistics of the last step."""
    model = _model()
    opt = build_optimizer("AdamW", model.parameters(), LR, eps=EPS, weight_decay=WD)
    weights = tl.class_weights()
    names = [n for n, _ in model.named_buffers() if n.endswith(("running_mean", "running_var"))]
    stats, params = running_stats(model), list(model.parameters())
    metrics = []
    model.train()
    for x, y in train:
        start = [s.clone() for s in stats]
        grads, rank_stats, losses, ious = [], [], [], []
        for rank in range(WORLD):
            torch._foreach_copy_(stats, start)
            xr, yr = _shard(x, rank), _shard(y, rank)
            logits = model(xr)
            loss = tl.weighted_ce_loss(logits, yr, weights, tl.FPW_1, tl.FPW_2)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            grads.append([p.grad.clone() for p in params])
            rank_stats.append([s.clone() for s in stats])
            losses.append(loss.detach())
            with torch.no_grad():
                ious.append(compute_score(argmax_channels(logits), yr, num_classes=3))
        for p, *g in zip(params, *grads):
            p.grad = sum(g) / WORLD
        opt.step()
        torch._foreach_copy_(stats, [sum(s) / WORLD for s in zip(*rank_stats)])
        metrics.append({"loss": float(sum(losses) / WORLD), "iou": float(sum(ious) / WORLD)})
    own = [flatten(state_dict_to_jax(model, dict(zip(names, rs)))[1]) for rs in rank_stats]
    return metrics, _trees(model), own


def _leaf_errs(a, b):
    return np.array([np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), 1e-30) for k in b])


def _entry_diffs(a, b):
    return np.concatenate([np.abs(a[k] - b[k]).ravel() for k in b])


def test_ranks_match_the_in_process_emulation(ranks):
    """The spawned ranks against the emulation of both in one process: the
    same math with only the order of the sums changed, so each leaf of the
    parameters and running statistics within 1e-6 of its largest entry, and
    the metrics within 1e-6.  The ranks are bit-identical to each other.
    BN stays per rank: the emulation differs from one process taking the
    global batch of 4, and the running statistics are the ranks' mean, not
    rank 0's own."""
    r0, r1 = ranks
    assert r0["identical"] and r1["identical"]
    assert r0["metrics"] == r1["metrics"] and r0["step"] == r1["step"] == 2
    assert r0["replica"] == "DistributedDataParallel"
    train, _ = _batches()
    metrics, (params, stats), own = _emulate(train)
    got_params, got_stats = r0["trees"]
    assert sorted(got_params) == sorted(params) and sorted(got_stats) == sorted(stats)
    assert _leaf_errs(got_params, params).max() <= 1e-6
    assert _leaf_errs(got_stats, stats).max() <= 1e-6
    for got, want in zip(r0["metrics"], metrics):
        for k in ("loss", "iou"):
            assert abs(got[k] - want[k]) <= 1e-6 * max(abs(want[k]), 1.0), (k, got, want)
    # averaged, not broadcast: rank 0's own statistics are far from the mean
    assert _leaf_errs(own[0], stats).max() > 1e-2  # 0.28 measured

    # one process over the global batch of 4: BN over 4 samples, not 2
    model = _model()
    state = create_train_state(model, build_optimizer("AdamW", model.parameters(), LR,
                                                      eps=EPS, weight_decay=WD))
    step = make_train_step(tl.class_weights(), fpw_1=tl.FPW_1, fpw_2=tl.FPW_2)
    x, y = train[0]
    state, m = step(state, torch.from_numpy(x), torch.from_numpy(y))
    assert abs(float(m["loss"]) - metrics[0]["loss"]) > 1e-4 * metrics[0]["loss"]


def test_remat_ranks_are_the_same_bits(ranks):
    """The two ranks' steps with ``remat=True`` (the model's forward under
    ``torch.utils.checkpoint`` inside DDP, replayed in the backward) from
    the same weights: after 2 steps the metrics, every parameter, gradient
    and running statistic equal the steps without remat bit for bit, on
    both ranks."""
    assert all(r["remat_same_bits"] for r in ranks)


def test_two_rank_steps_match_jax_two_device_mesh(ranks):
    """The spawned ranks against the JAX package's ``make_train_step`` on a
    2-device mesh, from the same weights and batches, at the tolerances of
    ``test_torch_trainer.py``'s one-device test.  Step 1 runs on identical
    weights: loss within 1e-5 relative, IoU within 1e-6.  Step 2, the
    parameters and the running statistics: within 2x the port's own spread
    under a 1e-7 input nudge, measured with the in-process emulation (so
    one set of rank processes serves every test).  Here the step-2 loss is
    more chaotic than in the one-device test: three nudges moved it by
    2.0e-3, 6.0e-3 and 6.5e-3 (CPU, 2 threads), so the spread is the
    largest over NUDGES nudged runs, for every quantity held to it."""
    import jax
    import jax.numpy as jnp

    from deepcam_tpu.core import mesh as meshlib
    from deepcam_tpu.models.deeplab import DeepLabv3plus as JaxDeepLab
    from deepcam_tpu.train.optim import build_optimizer as jax_build_optimizer
    from deepcam_tpu.train.trainer import create_train_state as jax_create_state
    from deepcam_tpu.train.trainer import make_train_step as jax_make_step
    from tests.torch_port_ref import jax_default_config, port_variables

    r0 = ranks[0]
    port_m, (port_p, port_s) = r0["metrics"], r0["trees"]
    train, _ = _batches()
    emu_m, (emu_p, emu_s), _ = _emulate(train)
    nudged = [_emulate(_nudged(train, seed))[:2] for seed in range(NUDGES)]

    variables = port_variables(SEED)
    start = flatten(variables["params"])
    with jax_default_config():
        jm = JaxDeepLab(n_classes=3, dtype=jnp.float32)
        jmesh = meshlib.make_mesh(devices=jax.devices()[:WORLD])
        assert jmesh.shape["data"] == WORLD
        tx = jax_build_optimizer("AdamW", LR, eps=EPS, weight_decay=WD)
        jstep = jax_make_step(jm, tx, list(tl.class_weights()), jmesh, fpw_1=tl.FPW_1,
                              fpw_2=tl.FPW_2)
        state = jax.device_put(jax_create_state(jm, variables, tx), meshlib.replicated(jmesh))
        ref_m = []
        for x, y in train:
            state, m = jstep(state, jnp.asarray(x), jnp.asarray(y))
            ref_m.append({k: float(v) for k, v in m.items()})
        ref_p = flatten(jax.tree_util.tree_map(np.asarray, state.params))
        ref_s = flatten(jax.tree_util.tree_map(np.asarray, state.batch_stats))
        del state

    assert abs(port_m[0]["loss"] - ref_m[0]["loss"]) <= 1e-5 * ref_m[0]["loss"]
    assert abs(port_m[0]["iou"] - ref_m[0]["iou"]) <= 1e-6
    spread = max(abs(m[1]["loss"] - emu_m[1]["loss"]) for m, _ in nudged)
    assert abs(port_m[1]["loss"] - ref_m[1]["loss"]) <= 2 * spread + 1e-6 * ref_m[1]["loss"]

    port = _entry_diffs(port_p, ref_p)
    nudge = [_entry_diffs(p, emu_p) for _, (p, _) in nudged]
    assert np.median(_entry_diffs(start, ref_p)) > LR
    for q in (0.5, 0.99):
        assert np.quantile(port, q) <= 2 * max(np.quantile(n, q) for n in nudge), q

    port = _leaf_errs(port_s, ref_s)
    nudge = [_leaf_errs(s, emu_s) for _, (_, s) in nudged]
    assert np.median(port) <= 2 * max(np.median(n) for n in nudge)
    assert port.max() <= 2 * max(n.max() for n in nudge)


def test_eval_over_uneven_shards_matches_one_process(ranks):
    """The CLI's validation over shards of 2 and 3 samples at eval batch 2
    (rank 0 pads its second call with valid=0): both ranks read the same
    sums, and they equal one process's eval over the 5 samples, to fp32 sum
    order."""
    r0, r1 = ranks
    assert (r0["eval_shard"], r1["eval_shard"]) == (2, 3)
    assert r0["eval"] == r1["eval"]
    params, stats = r0["trees"]
    model = _model()
    load_jax_variables(model, _nest(params), _nest(stats))
    state = create_train_state(model, build_optimizer("AdamW", model.parameters(), LR))
    eval_fn = make_eval_step(tl.class_weights(), fpw_1=tl.FPW_1, fpw_2=tl.FPW_2)
    _, (x, y) = _batches()
    want = [float(t) for t in eval_fn(state, torch.from_numpy(x), torch.from_numpy(y),
                                      torch.ones(EVAL_SAMPLES))]
    count, loss_sum, iou_sum = r0["eval"]
    assert count == want[0] == EVAL_SAMPLES
    assert abs(loss_sum - want[1]) <= 1e-6 * abs(want[1]), (r0["eval"], want)
    assert abs(iou_sum - want[2]) <= 1e-6 * EVAL_SAMPLES, (r0["eval"], want)


def _nest(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def test_two_process_cli_run(tmp_path):
    """``cli/train.py:main`` on two ranks, local batch 1, over 4 train and 5
    validation samples: 2 steps on each rank, one validation that counts
    each sample once, one save.  Rank 0 alone writes the checkpoint and the
    MLPerf log (each rank has its own --output_dir here, so a write by rank
    1 would show)."""
    from deepcam_tpu_torch.data.synthetic import make_synthetic_dataset
    from deepcam_tpu_torch.obs.mlperf_log import parse_mllog

    root = make_synthetic_dataset(str(tmp_path / "data"), n_train=4,
                                  n_validation=EVAL_SAMPLES, shape=SHAPE, seed=1)
    out = tmp_path / "out"
    try:
        r0, r1 = _spawn(tmp_path / "cli", "cli", root=root, out=str(out))
        for r in (r0, r1):
            assert (r["step"], r["epoch"], r["eval_samples_seen"]) == (2, 1, 5.0), r
        assert r0["eval_iou"] == r1["eval_iou"] and 0.0 <= r0["eval_iou"] <= 1.0
        assert not (out / "rank1").exists()
        assert sorted(os.listdir(out / "rank0")) == ["logs", "model_step_2.cpt"]
        recs = parse_mllog(str(out / "rank0" / "logs" / "dist.log"))
        by = {r["key"]: r["value"] for r in recs}
        assert (by["global_batch_size"], by["train_samples"], by["eval_samples"]) == (2, 4, 5)
        assert by["submission_platform"].startswith("2x")
        assert [r["key"] for r in recs].count("run_start") == 1
        assert [r["key"] for r in recs].count("train_loss") == 2
    finally:
        for f in tmp_path.rglob("*.cpt"):
            f.unlink()  # 678 MB: tmp directories outlive the run


# ---------------------------------------------------------------------------
# the wireup, in this process
# ---------------------------------------------------------------------------

@pytest.fixture
def no_torchrun_env(monkeypatch):
    for var in mesh.TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    assert mesh.initialized_dist() is None
    yield monkeypatch
    mesh.destroy_distributed()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_wireup_without_a_launcher_stays_one_process(no_torchrun_env):
    assert mesh.init_distributed("auto", "cpu") is False
    assert mesh.initialized_dist() is None
    assert (mesh.get_rank(), mesh.get_size(), mesh.get_local_rank()) == (0, 1, 0)
    # the collectives are identities without a group
    collectives.barrier()
    assert collectives.broadcast_from_host0({"a": 1}) == {"a": 1}
    assert collectives.allreduce_sum_scalar(2.5) == 2.5
    t = torch.ones(3)
    assert collectives.allreduce_mean_(t) is t and torch.equal(t, torch.ones(3))


def test_dummy_never_initializes(no_torchrun_env):
    env = dict(WORLD_SIZE="2", RANK="0", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    for k, v in env.items():
        no_torchrun_env.setenv(k, v)
    assert mesh.init_distributed("dummy", "cpu") is False
    assert mesh.initialized_dist() is None


def test_wireup_raises_when_the_store_is_unreachable(no_torchrun_env):
    """torchrun's variables name a world of 2 whose store nobody serves:
    ``auto`` raises after its timeout instead of running one process."""
    env = dict(WORLD_SIZE="2", RANK="1", LOCAL_RANK="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    for k, v in env.items():
        no_torchrun_env.setenv(k, v)
    # a 2 s rendezvous instead of torch's default of minutes
    no_torchrun_env.setattr(torch.distributed, "init_process_group", functools.partial(
        torch.distributed.init_process_group, timeout=timedelta(seconds=2)))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not initialize"):
        mesh.init_distributed("auto", "cpu")
    assert time.monotonic() - t0 < 60
    assert mesh.initialized_dist() is None
    no_torchrun_env.delenv("MASTER_PORT")
    with pytest.raises(RuntimeError, match="incomplete"):
        mesh.init_distributed("auto", "cpu")


def test_device_for_keeps_an_explicit_index(no_torchrun_env):
    current = []
    no_torchrun_env.setattr(torch.cuda, "is_available", lambda: True)
    no_torchrun_env.setattr(torch.cuda, "set_device", current.append)
    no_torchrun_env.setenv("LOCAL_RANK", "1")
    assert mesh.device_for("cuda:0") == torch.device("cuda", 0)
    assert mesh.device_for("cuda") == torch.device("cuda", 1)
    assert current == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert mesh.device_for("cpu") == torch.device("cpu") and len(current) == 2


def test_device_for_never_falls_back_to_the_cpu(no_torchrun_env):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.device_for("cuda")
