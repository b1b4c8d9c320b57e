"""The port's training CLI on the CPU at (32, 48), fp32 (``O0``), with
LAMB under warmup + multistep: step and epoch counts, the MLPerf key
sequence and learning rates, checkpoints, the resume that runs its epoch
again, the (N+1)-sample validation budget, the flag surface, and failures
that end the run.  And the slice as a whole: the port's loop, started from
a checkpoint of the JAX model's weights, against the JAX package's train
step with LAMB and the same schedule on the batches of the JAX loader.
"""

import os

import numpy as np
import pytest
import torch

from deepcam_tpu_torch.cli.train import (build_parser, compute_dtype, main, make_datasets,
                                         train_loop)
from deepcam_tpu_torch.data.pipeline import DataLoader
from deepcam_tpu_torch.data.synthetic import make_synthetic_dataset
from deepcam_tpu_torch.obs.mlperf_log import parse_mllog
from deepcam_tpu_torch.train.schedule import get_lr_schedule
from tests.torch_port_ref import few_torch_threads, release_memory  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

SCHEDULE = "type=multistep,milestones=1 3,decay_rate=0.1"
SCHEDULE_DICT = {"type": "multistep", "milestones": "1 3", "decay_rate": "0.1"}
HEADER = ["submission_benchmark", "submission_org", "submission_division",
          "submission_status", "submission_platform"]
INIT = ["init_start", "cache_clear", "seed", "global_batch_size", "opt_name",
        "opt_base_learning_rate", "opt_learning_rate_warmup_steps",
        "opt_learning_rate_warmup_factor", "opt_epsilon", "train_samples", "eval_samples"]


def expected_keys(start_step, epochs, steps_per_epoch, logging, validation, save,
                  invalid=False):
    """The key sequence of a run that reaches its end."""
    keys = HEADER + INIT + (["invalid_submission"] if invalid else []) + ["init_stop",
                                                                         "run_start"]
    step = start_step
    for _ in range(epochs):
        keys.append("epoch_start")
        for _ in range(steps_per_epoch):
            step += 1
            if step % logging == 0:
                keys += ["learning_rate", "train_accuracy", "train_loss"]
            if step % validation == 0:
                keys += ["eval_start", "eval_accuracy", "eval_loss", "eval_stop"]
            if save and step % save == 0:
                keys += ["save_start", "save_stop"]
        keys.append("epoch_stop")
    return keys + ["run_stop"]


def _args(root, out, tag, *extra):
    return build_parser().parse_args([
        "--data_dir_prefix", root, "--output_dir", out, "--run_tag", tag,
        "--optimizer", "LAMB", "--start_lr", "1e-3", "--weight_decay", "1e-2",
        "--lr_schedule", SCHEDULE, "--lr_warmup_steps", "1", "--lr_warmup_factor", "2",
        "--local_batch_size", "2", "--eval_local_batch_size", "2",
        "--logging_frequency", "1", "--amp_opt_level", "O0", "--target_iou", "2.0",
        "--device", "cpu", "--seed", "333", *extra])


def test_flag_surface_covers_reference():
    ours = {a.dest for a in build_parser()._actions}
    reference_flags = [
        "wireup_method", "wandb_certdir", "run_tag", "output_dir", "checkpoint",
        "data_dir_prefix", "max_inter_threads", "max_epochs", "save_frequency",
        "validation_frequency", "max_validation_steps", "logging_frequency",
        "training_visualization_frequency", "validation_visualization_frequency",
        "local_batch_size", "channels", "optimizer", "start_lr", "adam_eps", "weight_decay",
        "loss_weight_pow", "lr_warmup_steps", "lr_warmup_factor", "lr_schedule",
        "target_iou", "model_prefix", "amp_opt_level", "enable_wandb", "resume_logging"]
    assert not [f for f in reference_flags if f not in ours]
    from deepcam_tpu.cli.train import build_parser as jax_parser

    jax_flags = {a.dest for a in jax_parser()._actions}
    assert jax_flags <= ours and ours - jax_flags == {"device"}
    assert build_parser().parse_args([]).device == "cuda"


@pytest.mark.parametrize("pow_", [-0.125, -0.5, 0.0])
def test_loss_weight_pow_matches_jax(pow_):
    """The class weights the CLI builds from ``--loss_weight_pow``."""
    from deepcam_tpu.train.losses import class_weights as jax_class_weights
    from deepcam_tpu_torch.train.losses import class_weights

    args = build_parser().parse_args(["--loss_weight_pow", str(pow_)])
    assert class_weights(args.loss_weight_pow) == tuple(jax_class_weights(pow_))


@pytest.mark.parametrize("extra", [
    ["--spatial", "2"], ["--spatial_impl", "gspmd"], ["--remat"],
    ["--checkpoint_format", "orbax"], ["--wireup_method", "jax"], ["--enable_wandb"],
    ["--training_visualization_frequency", "1"],
    ["--validation_visualization_frequency", "1"]])
def test_refused_flags_raise(tmp_path, extra):
    with pytest.raises(NotImplementedError, match="does not take"):
        main(_args(str(tmp_path / "none"), str(tmp_path / "o"), "r", *extra))


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = _args(str(tmp_path / "none"), str(tmp_path / "o"), "r")
    args.device = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args)


@pytest.fixture(autouse=True)
def _remove_checkpoints(tmp_path):
    """A checkpoint of the full-width model with LAMB state is 678 MB, and
    tmp directories outlive the run."""
    yield
    for f in tmp_path.rglob("*.cpt"):
        f.unlink()


@pytest.fixture
def small_root(tmp_path):
    return make_synthetic_dataset(str(tmp_path / "data"), n_train=4, n_validation=3,
                                  shape=(32, 48), seed=1)


def test_run_checkpoints_and_resume(small_root, tmp_path):
    """Two epochs of 2 steps with validation every 2 steps and a save at
    step 4, then a resume from it: it runs epoch 2 again, with the
    validation budget of --max_validation_steps 0 (one sample) and an async
    save every 2 steps."""
    out = str(tmp_path / "out")
    res = main(_args(small_root, out, "run", "--max_epochs", "2",
                     "--validation_frequency", "2", "--save_frequency", "4"))
    assert (res["step"], res["epoch"], res["eval_samples_seen"]) == (4, 2, 3.0)
    assert 0.0 <= res["eval_iou"] <= 1.0
    recs = parse_mllog(os.path.join(out, "logs", "run.log"))
    assert [r["key"] for r in recs] == expected_keys(0, 2, 2, 1, 2, 4)
    by = {r["key"]: r for r in recs}
    assert (by["global_batch_size"]["value"], by["train_samples"]["value"],
            by["eval_samples"]["value"], by["opt_name"]["value"]) == (2, 4, 3, "LAMB")
    assert by["run_stop"]["metadata"]["status"] == "success"
    sched = get_lr_schedule(1e-3, SCHEDULE_DICT, 1, 2.0)
    lrs = [(r["metadata"]["step_num"], r["value"]) for r in recs if r["key"] == "learning_rate"]
    assert lrs == [(s, sched(s - 1)) for s in range(1, 5)]
    assert [v for _, v in lrs] == pytest.approx([1e-3, 2e-3, 2e-4, 2e-4], rel=1e-6)
    losses = [r["value"] for r in recs if r["key"] == "train_loss"]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert sorted(f for f in os.listdir(out) if f.endswith(".cpt")) == ["model_step_4.cpt"]
    blob = torch.load(os.path.join(out, "model_step_4.cpt"), map_location="cpu",
                      weights_only=True)
    assert (blob["step"], blob["epoch"]) == (4, 1)

    res = main(_args(small_root, out, "resume", "--max_epochs", "2",
                     "--validation_frequency", "2", "--save_frequency", "2",
                     "--checkpoint", os.path.join(out, "model_step_4.cpt"),
                     "--max_validation_steps", "0", "--async_checkpoint"))
    assert (res["step"], res["epoch"], res["eval_samples_seen"]) == (6, 2, 1.0)
    recs = parse_mllog(os.path.join(out, "logs", "resume.log"))
    assert [r["key"] for r in recs] == expected_keys(4, 1, 2, 1, 2, 2, invalid=True)
    by = {r["key"]: r for r in recs}
    assert by["epoch_start"]["metadata"] == {**by["epoch_start"]["metadata"],
                                             "epoch_num": 2, "step_num": 4}
    assert by["eval_samples"]["value"] == 0  # min(3, 0 steps x batch 2)
    lrs = [(r["metadata"]["step_num"], r["value"]) for r in recs if r["key"] == "learning_rate"]
    assert lrs == [(5, sched(4)), (6, sched(5))]
    blob = torch.load(os.path.join(out, "model_step_6.cpt"), map_location="cpu",
                      weights_only=True)
    assert (blob["step"], blob["epoch"]) == (6, 1)
    assert all(int(st["step"]) == 6 for st in blob["optimizer"]["state"].values())


@pytest.mark.parametrize("level,dtype", [("O0", torch.float32), ("O1", torch.bfloat16),
                                         ("O2", torch.bfloat16)])
def test_amp_level_sets_the_compute_type(small_root, level, dtype):
    """O0 computes in fp32; O1 and O2 in bf16 with fp32 parameters, and the
    datasets then emit bf16 samples, as in the JAX CLI."""
    assert compute_dtype(level) == dtype
    args = _args(small_root, "unused", "amp", "--amp_opt_level", level)
    train_set, validation_set = make_datasets(args)
    assert train_set.bf16_out == validation_set.bf16_out == (dtype == torch.bfloat16)
    data, _, _ = next(iter(DataLoader(train_set, 2)))
    assert data.dtype == dtype


def test_bf16_run(small_root, tmp_path):
    """One O1 step at batch 4: bf16 compute, fp32 parameters, finite loss."""
    out = str(tmp_path / "o")
    args = _args(small_root, out, "bf16", "--amp_opt_level", "O1", "--local_batch_size", "4",
                 "--max_epochs", "1", "--validation_frequency", "100", "--save_frequency", "0")
    res = train_loop(args, *make_datasets(args))
    assert res.metrics["step"] == 1 and res.state.model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in res.state.model.parameters())
    losses = [r["value"] for r in parse_mllog(os.path.join(out, "logs", "bf16.log"))
              if r["key"] == "train_loss"]
    assert len(losses) == 1 and np.isfinite(losses[0])


@pytest.mark.parametrize("where", ["loader", "prefetch", "writer"])
def test_a_failure_ends_the_run(small_root, tmp_path, monkeypatch, where):
    from deepcam_tpu_torch.ckpt import checkpoint
    from deepcam_tpu_torch.data import dataset, pipeline

    args = _args(small_root, str(tmp_path / "o"), "f", "--max_epochs", "1",
                 "--validation_frequency", "100", "--async_checkpoint",
                 "--save_frequency", "1" if where == "writer" else "0")
    if where == "loader":
        read = dataset.CamDataset._read

        def bad_read(self, filename):
            if filename == self.files[-1] and "train" in filename:
                raise OSError("unreadable sample")
            return read(self, filename)

        monkeypatch.setattr(dataset.CamDataset, "_read", bad_read)
        train_set, validation_set = make_datasets(args)
        with pytest.raises(OSError, match="unreadable"):
            train_loop(args, train_set, validation_set)
        return
    if where == "prefetch":
        def bad_prefetch(it, device, depth=2):
            yield next(iter(it))
            raise RuntimeError("copy to the device failed")

        monkeypatch.setattr(pipeline, "prefetch_to_device", bad_prefetch)
        match = "copy to the device"
    else:
        def bad_write(path, payload):
            raise OSError("disk full")

        monkeypatch.setattr(checkpoint, "_write", bad_write)
        match = "disk full"
    with pytest.raises((OSError, RuntimeError), match=match):
        main(args)
    recs = parse_mllog(os.path.join(str(tmp_path / "o"), "logs", "f.log"))
    assert "run_stop" not in [r["key"] for r in recs]


def test_loop_matches_jax_train_steps(tmp_path):
    """Two LAMB steps under warmup + multistep from the same weights: the
    port's loop (through the CLI, resumed from a checkpoint of the weights)
    against the JAX package's ``make_train_step`` and ``build_optimizer``
    on the batches of its own ``DataLoader`` over the same files.  Step 1
    runs on identical weights (see the tolerance below).  Step 2: within
    2x the distance between the port and the port started from weights
    nudged by 1e-7 (relative), as ``test_torch_trainer.py`` holds them,
    because train-mode gradients of the random net are chaotic at this
    size."""
    import jax
    import jax.numpy as jnp

    from deepcam_tpu.core import mesh as meshlib
    from deepcam_tpu.data.dataset import CamDataset as JaxCamDataset
    from deepcam_tpu.data.pipeline import DataLoader as JaxDataLoader
    from deepcam_tpu.models.deeplab import DeepLabv3plus as JaxDeepLab
    from deepcam_tpu.train import losses as jl
    from deepcam_tpu.train.optim import build_optimizer as jax_build
    from deepcam_tpu.train.schedule import get_lr_schedule as jax_schedule
    from deepcam_tpu.train.trainer import create_train_state as jax_create_state
    from deepcam_tpu.train.trainer import make_train_step as jax_make_step
    from deepcam_tpu_torch.ckpt.checkpoint import save_checkpoint
    from deepcam_tpu_torch.models.deeplab import DeepLabv3plus
    from deepcam_tpu_torch.tools.weights import load_jax_variables
    from deepcam_tpu_torch.train.optim import build_optimizer
    from deepcam_tpu_torch.train.trainer import create_train_state
    from tests.torch_port_ref import jax_default_config, port_variables

    root = make_synthetic_dataset(str(tmp_path / "data"), n_train=4, n_validation=1,
                                  shape=(32, 48), seed=2)
    variables = port_variables(31)

    def port_losses(tag, nudge):
        model = DeepLabv3plus(3, dtype=torch.float32, device="cpu")
        load_jax_variables(model, variables["params"], variables["batch_stats"])
        if nudge:
            gen = torch.Generator().manual_seed(1)
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1 + nudge * torch.randn(p.shape, generator=gen))
        opt = build_optimizer("LAMB", model.parameters(), 1e-3)
        path = str(tmp_path / f"{tag}_step_0.cpt")
        save_checkpoint(path, create_train_state(model, opt), epoch=0)
        out = str(tmp_path / tag)
        res = main(_args(root, out, tag, "--max_epochs", "1", "--validation_frequency",
                         "100", "--save_frequency", "0", "--checkpoint", path))
        assert res["step"] == 2
        recs = parse_mllog(os.path.join(out, "logs", f"{tag}.log"))
        return [r["value"] for r in recs if r["key"] == "train_loss"]

    port, nudged = port_losses("port", 0.0), port_losses("nudged", 1e-7)

    with jax_default_config():
        jm = JaxDeepLab(n_classes=3, dtype=jnp.float32)
        mesh = meshlib.make_mesh(devices=jax.devices()[:1])
        sched = jax_schedule(1e-3, SCHEDULE_DICT, warmup_steps=1, warmup_factor=2.0)
        tx = jax_build("LAMB", sched, eps=1e-8, weight_decay=1e-2)
        step = jax_make_step(jm, tx, list(jl.class_weights()), mesh, fpw_1=jl.FPW_1,
                             fpw_2=jl.FPW_2)
        state = jax.device_put(jax_create_state(jm, variables, tx), meshlib.replicated(mesh))
        ds = JaxCamDataset(os.path.join(root, "train"), os.path.join(root, "stats.h5"),
                           channels=range(16), shuffle=True)
        ref = []
        for x, y, _ in JaxDataLoader(ds, 2, num_workers=2):
            state, m = step(state, jnp.asarray(x), jnp.asarray(y))
            ref.append(float(m["loss"]))

    assert len(port) == len(nudged) == len(ref) == 2
    # Step 1's loss is a forward on identical weights and batch.  On these
    # normalized samples the train-mode BN statistics (one-pass E[x²] -
    # E[x]², fp32 sums in each stack's order) leave the two stacks 1.2e-5
    # apart: measured, the port reads 2.3494136, JAX 2.3494411, and the
    # port's plain path in fp64 (BN statistics still fp32) 2.3494031, so
    # JAX's fp32 forward sits 1.6e-5 from it and the port's 4.5e-6.
    assert abs(port[0] - ref[0]) <= 3e-5 * abs(ref[0]), (port, ref)
    spread = abs(nudged[1] - port[1])
    assert abs(port[1] - ref[1]) <= 2 * spread + 1e-6 * abs(ref[1]), (port, ref, nudged)
