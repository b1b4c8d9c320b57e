"""The port's checkpoints: the reference's schema, exact round trips, the
async writer, and the JAX package's importer reading what the port wrote.

A module fixture (no JAX) takes two LAMB updates of the full-width model
on the CPU and saves it, so the optimizer state is real.
"""

import os

import numpy as np
import pytest
import torch

from deepcam_tpu_torch.ckpt.checkpoint import (AsyncCheckpointWriter, checkpoint_path,
                                               restore_checkpoint, save_checkpoint)
from deepcam_tpu_torch.models.deeplab import DeepLabv3plus
from deepcam_tpu_torch.tools.ref_names import reference_names
from deepcam_tpu_torch.tools.weights import assignments
from deepcam_tpu_torch.train.optim import build_optimizer
from deepcam_tpu_torch.train.trainer import create_train_state
from tests.torch_port_ref import capped_torch_threads, port_variables
from tests.torch_port_ref import few_torch_threads, release_memory  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

LR, EPS, WD = 1e-3, 1e-8, 1e-2


def _state(seed=5):
    model = DeepLabv3plus(3, dtype=torch.float32, device="cpu", seed=seed)
    opt = build_optimizer("LAMB", model.parameters(), LR, eps=EPS, weight_decay=WD)
    return create_train_state(model, opt)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two LAMB updates from random gradients and random BN running
    statistics, saved at step 2, epoch 3."""
    with capped_torch_threads():
        state = _lamb_steps(_state(), 2)
        with torch.no_grad():
            gen = torch.Generator().manual_seed(1)
            for name, b in state.model.named_buffers():
                b.copy_(torch.rand(b.shape, generator=gen) + (name.endswith("var")))
        path = checkpoint_path(str(tmp_path_factory.mktemp("ckpt")), "model", state.step)
        save_checkpoint(path, state, epoch=3)
    yield state, path
    os.remove(path)  # 678 MB: tmp directories outlive the run


@pytest.fixture(autouse=True)
def _remove_checkpoints(tmp_path):
    yield
    for f in tmp_path.rglob("*.cpt"):
        f.unlink()


def _lamb_steps(state, n):
    gen = torch.Generator().manual_seed(0)
    for _ in range(n):
        for p in state.model.parameters():
            p.grad = 0.1 * torch.randn(p.shape, generator=gen)
        state.optimizer.step()
        state.step += 1
    state.optimizer.zero_grad(set_to_none=True)
    return state


def _assert_same(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    pa, pb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    for k, p in pa.items():
        st_a, st_b = a.optimizer.state[p], b.optimizer.state[pb[k]]
        assert sorted(st_a) == sorted(st_b) == ["exp_avg", "exp_avg_sq", "step"], k
        for name in st_a:
            assert torch.equal(st_a[name], st_b[name]), (k, name)
    assert a.step == b.step


def test_schema_and_round_trip(trained):
    state, path = trained
    assert os.path.basename(path) == "model_step_2.cpt"
    blob = torch.load(path, map_location="cpu", weights_only=True)
    assert sorted(blob) == ["epoch", "model", "optimizer", "step"]
    assert (blob["step"], blob["epoch"]) == (2, 3)
    keys = list(blob["model"])
    assert all(k.startswith("module.") for k in keys)
    for k in ("module.xception_features.block1.rep.0.conv1.weight",
              "module.xception_features.block2.rep.1.conv1.weight",
              "module.xception_features.block3.rep.6.pointwise.weight",
              "module.xception_features.block20.rep.6.conv1.weight",
              "module.xception_features.block1.skipbn.running_var",
              "module.global_avg_pool.1.weight", "module.upsample.conv1.6.bias",
              "module.upsample.last_deconv.0.weight"):
        assert k in blob["model"], k
    n_params = sum(1 for k in keys if not k.endswith(("running_mean", "running_var")))
    assert n_params == len(list(state.model.parameters()))
    assert sorted(blob["optimizer"]["state"]) == list(range(n_params))
    assert blob["optimizer"]["param_groups"][0]["params"] == list(range(n_params))

    fresh = _state(seed=6)
    fresh, epoch = restore_checkpoint(path, fresh)
    assert epoch == 3 and fresh.epoch == 3
    _assert_same(fresh, state)


def test_async_writer_matches_sync(trained, tmp_path):
    state, path = trained
    writer = AsyncCheckpointWriter()
    out = str(tmp_path / "a.cpt")
    writer.save(out, state, epoch=3)
    writer.wait()
    a = torch.load(out, map_location="cpu", weights_only=True)
    b = torch.load(path, map_location="cpu", weights_only=True)
    assert list(a["model"]) == list(b["model"])
    assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
    assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]
    for i, st in b["optimizer"]["state"].items():
        assert all(torch.equal(st[k], a["optimizer"]["state"][i][k]) for k in st)


def test_async_writer_raises_the_worker_error(tmp_path):
    state = _state()
    writer = AsyncCheckpointWriter()
    writer.save(str(tmp_path / "missing_dir" / "x.cpt"), state, epoch=0)
    with pytest.raises((OSError, RuntimeError), match="missing_dir"):
        writer.wait()
    writer.wait()  # the error is raised once


def test_only_rank_0_writes(tmp_path, monkeypatch):
    """Under a process group rank 0 alone writes, sync or async, and the
    other ranks take no snapshot."""
    from deepcam_tpu_torch.ckpt import checkpoint

    def no_snapshot(*args):
        raise AssertionError("a rank other than 0 took a snapshot")

    monkeypatch.setattr(checkpoint, "get_rank", lambda: 1)
    monkeypatch.setattr(checkpoint, "snapshot", no_snapshot)
    state = _state()
    save_checkpoint(str(tmp_path / "sync.cpt"), state, epoch=0)
    writer = AsyncCheckpointWriter()
    writer.save(str(tmp_path / "async.cpt"), state, epoch=0)
    writer.wait()
    assert writer._thread is None and os.listdir(tmp_path) == []


def _rewrite(path, out, edit):
    """``path``'s checkpoint with ``edit(blob)`` applied, saved as ``out``."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    edit(blob)
    torch.save(blob, out)
    return out


@pytest.mark.parametrize("prefix", ["module.", ""])
def test_restores_a_reference_style_checkpoint(trained, tmp_path, prefix):
    """The reference's ``nn.BatchNorm2d`` also saves ``num_batches_tracked``
    (one per BN, 77 in the model), and a file may lack DDP's ``module.``
    prefix: such a file restores to exactly the tensors of the untouched
    one."""
    state, path = trained

    def edit(blob):
        model = {}
        for k, v in blob["model"].items():
            model[prefix + k[len("module."):]] = v
            if k.endswith("running_var"):
                tracked = prefix + k[len("module."):-len("running_var")] + "num_batches_tracked"
                model[tracked] = torch.tensor(2, dtype=torch.long)
        assert sum(k.endswith("num_batches_tracked") for k in model) == 77
        blob["model"] = model

    ref = _rewrite(path, str(tmp_path / "ref.cpt"), edit)
    fresh, epoch = restore_checkpoint(ref, _state(seed=6))
    assert epoch == 3
    _assert_same(fresh, state)


def test_optimizer_states_without_step_restore_count_0(trained, tmp_path):
    """A per-parameter state without ``step`` reads as 0, and the restored
    count is the largest over the parameters, on every parameter: with no
    step saved the next LAMB update is the first."""
    _, path = trained

    def drop(keep):
        def edit(blob):
            for i, st in blob["optimizer"]["state"].items():
                if i not in keep:
                    del st["step"]
        return edit

    fresh, _ = restore_checkpoint(_rewrite(path, str(tmp_path / "a.cpt"), drop(())),
                                  _state(seed=6))
    states = [fresh.optimizer.state[p] for p in fresh.model.parameters()]
    assert all(float(st["step"]) == 0.0 for st in states)
    fresh, _ = restore_checkpoint(_rewrite(path, str(tmp_path / "b.cpt"), drop({3})),
                                  _state(seed=6))
    assert all(float(fresh.optimizer.state[p]["step"]) == 2.0
               for p in fresh.model.parameters())


def test_a_missing_weight_still_raises(trained, tmp_path):
    _, path = trained

    def edit(blob):
        del blob["model"]["module.xception_features.block4.rep.1.conv1.weight"]

    with pytest.raises(KeyError, match="block4.rep.1.conv1.weight"):
        restore_checkpoint(_rewrite(path, str(tmp_path / "m.cpt"), edit), _state(seed=6))


def test_name_map_raises_on_an_unassigned_tensor():
    model = DeepLabv3plus(3, dtype=torch.float32, device="cpu", seed=1)
    model.xception.block4.register_buffer("extra", torch.zeros(1))
    with pytest.raises(KeyError, match="unassigned.*block4.extra"):
        reference_names(model)


def test_model_keys_equal_the_importers():
    """The reference keys the port writes are exactly the torch keys JAX's
    importer assigns to the model, without ``num_batches_tracked``."""
    from deepcam_tpu.tools.import_torch_checkpoint import build_assignments

    names = [ref for _, ref in reference_names(_state().model)]
    sd = dict.fromkeys(names)
    keys = {tk for tk, _, _ in build_assignments(sd, port_variables(5))}
    assert keys == set(names) and len(names) == len(set(names))


def test_jax_importer_reads_the_port_checkpoint(tmp_path):
    """``convert_checkpoint(..., optimizer="LAMB")`` turns a file the port
    wrote after two LAMB updates into the JAX package's, which holds the
    port's parameters, batch statistics, first and second moments and count
    through the port's layout bridge (``tools/weights.py``).  The port's
    state is read back from its own file (exact, as the round trip shows),
    so that only one copy of the model is alive beside the importer's."""
    from flax import serialization

    from deepcam_tpu.tools.import_torch_checkpoint import convert_checkpoint

    state = _lamb_steps(_state(seed=7), 2)
    path = str(tmp_path / "model_step_2.cpt")
    save_checkpoint(path, state, epoch=3)
    plan = [(key, coll, path_, perm, ref) for (key, coll, path_, perm), ref in
            zip(assignments(state.model), _ref_of(state.model))]
    del state

    out = str(tmp_path / "jax.cpt")
    info = convert_checkpoint(path, out, optimizer="LAMB", start_lr=LR, adam_eps=EPS,
                              weight_decay=WD)
    assert (info["step"], info["epoch"]) == (2, 3)
    with open(out, "rb") as f:
        payload = serialization.msgpack_restore(f.read())
    os.remove(out)

    def adam_state(tree):
        if isinstance(tree, dict):
            if {"count", "mu", "nu"} <= set(tree):
                return tree
            for v in tree.values():
                found = adam_state(v)
                if found is not None:
                    return found
        return None

    adam = adam_state(payload["opt_state"])
    assert int(np.asarray(adam["count"])) == 2 and int(np.asarray(payload["step"])) == 2
    blob = torch.load(path, map_location="cpu", weights_only=True)
    index = {k: i for i, k in enumerate(
        k for k in blob["model"] if not k.endswith(("running_mean", "running_var")))}
    n = 0
    for key, coll, path_, perm, ref in plan:
        sources = [(payload[coll], blob["model"]["module." + ref])]
        if coll == "params":
            st = blob["optimizer"]["state"][index["module." + ref]]
            sources += [(adam["mu"], st["exp_avg"]), (adam["nu"], st["exp_avg_sq"])]
        for tree, tensor in sources:
            got = tree
            for k in path_:
                got = got[k]
            want = tensor.numpy()
            if perm is not None:
                want = np.transpose(want, np.argsort(perm))
            np.testing.assert_array_equal(np.asarray(got), want, err_msg=key)
            n += 1
    assert n == 3 * len(index) + (len(blob["model"]) - len(index))


def _ref_of(model):
    """The reference name of each of ``assignments(model)``'s keys, in order."""
    ref = dict(reference_names(model))
    return [ref[key] for key, _, _, _ in assignments(model)]
