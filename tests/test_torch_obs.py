"""The port's observability against the JAX package's on the same inputs:
the visualizer's pixels, the wandb shim (inert without wandb; with a fake
wandb the same calls, arguments and keys as the JAX shim), and the log
analysis over a log the port's MLPerf logger wrote."""

import io

import numpy as np
import pytest
import torch

from deepcam_tpu.obs import analysis as jax_analysis
from deepcam_tpu.obs import visualizer as jax_visualizer
from deepcam_tpu.obs import wandb_utils as jax_wandb
from deepcam_tpu_torch.obs import analysis, visualizer, wandb_utils
from deepcam_tpu_torch.obs.mlperf_log import MLPerfLogger
from tests.torch_port_ref import install_fake_wandb
from tests.torch_port_ref import release_memory  # noqa: F401


def _png_pixels(path):
    from PIL import Image

    with open(path, "rb") as f:
        return np.asarray(Image.open(io.BytesIO(f.read())).convert("RGBA"))


def test_visualizer_draws_the_jax_pixels(tmp_path):
    """Channel 0 with the prediction and label contours, from the same
    arrays: the decoded PNGs are equal pixel for pixel (tolerance 0)."""
    rng = np.random.RandomState(3)
    data = rng.rand(24, 36).astype(np.float32)
    pred = rng.randint(0, 3, (24, 36)).astype(np.int32)
    label = rng.randint(0, 3, (24, 36)).astype(np.int32)
    name = "/x/data-2006-05-17-12-3.h5"
    assert visualizer.parse_cam_filename(name) == jax_visualizer.parse_cam_filename(name) \
        == (2006, 5, 17, 12, 3)
    assert visualizer.parse_cam_filename("data-2000-01-01-3.h5") == (0,) * 5
    got, want = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    visualizer.CamVisualizer().plot(name, got, data, pred, label)
    jax_visualizer.CamVisualizer().plot(name, want, data, pred, label)
    a, b = _png_pixels(got), _png_pixels(want)
    assert a.shape == b.shape and a.shape[0] > 500
    np.testing.assert_array_equal(a, b)


def test_wandb_shim_is_inert_without_wandb(tmp_path):
    assert not wandb_utils.HAVE_WANDB  # not installed here
    wb = wandb_utils.WandbLogger(enable=True, rank=0, certdir=str(tmp_path), run_tag="r")
    assert not wb.active
    wb.log({"train_loss": 1.0}, 1)
    wb.log_image("training_examples", "x.png", "c", 1)
    wb.watch(torch.nn.Linear(2, 2), 1)


def _small_model():
    from deepcam_tpu_torch.models.xception import XceptionBlock

    block = XceptionBlock(8, 16, 2, stride=2, gen=torch.Generator().manual_seed(0))
    block(torch.randn(2, 8, 6, 8)).square().mean().backward()
    return block


def test_wandb_shim_calls_match_the_jax_shim(tmp_path, monkeypatch):
    """With a fake wandb: login, ``init``, the config, ``log``, ``log_image``
    and ``watch`` carry the JAX shim's arguments and keys; the histograms
    hold the same values (the port's tensors in torch layout, so compared
    sorted).  Off rank 0 and when not enabled nothing is called."""
    from deepcam_tpu_torch.tools.weights import state_dict_to_jax

    model = _small_model()
    params, _ = state_dict_to_jax(model, dict(model.named_parameters()))
    grads, _ = state_dict_to_jax(model, {k: p.grad for k, p in model.named_parameters()})
    fakes = []
    for shim, watch in ((wandb_utils, lambda wb: wb.watch(model, 20)),
                        (jax_wandb, lambda wb: wb.watch(params, grads, 20))):
        fake = install_fake_wandb(monkeypatch, shim, certdir=tmp_path / "cert")
        kw = dict(certdir=str(tmp_path / "cert"), run_tag="tag", resume_logging=True,
                  config={"optimizer": "LAMB", "start_lr": 1e-3})
        assert not shim.WandbLogger(enable=True, rank=1, **kw).active
        assert not shim.WandbLogger(enable=False, rank=0, **kw).active
        wb = shim.WandbLogger(enable=True, rank=0, **kw)
        wb.log({"train_loss": 0.5, "learning_rate": 1e-3}, 10)
        wb.log_image("validation_examples", "/p/validation-1.png",
                     "Prediction vs. Ground Truth", 10)
        watch(wb)
        fakes.append(fake)
    port, ref = fakes
    assert [c[0] for c in port.calls] == [c[0] for c in ref.calls] == [
        "login", "init", "log", "log", "log"]
    assert port.calls[0] == ref.calls[0] and port.calls[1] == ref.calls[1]
    assert vars(port.config) == vars(ref.config) == {"optimizer": "LAMB", "start_lr": 1e-3}
    assert port.calls[2] == ref.calls[2]
    (_, pimg, pstep), (_, rimg, rstep) = port.calls[3], ref.calls[3]
    assert pstep == rstep == 10 and list(pimg) == list(rimg) == ["validation_examples"]
    assert [(i.path, i.caption) for i in pimg["validation_examples"]] == \
        [(i.path, i.caption) for i in rimg["validation_examples"]]
    (_, phist, pstep), (_, rhist, rstep) = port.calls[4], ref.calls[4]
    assert pstep == rstep == 20
    assert sorted(phist) == sorted(rhist)
    assert any(k.startswith("gradients/") for k in phist) and \
        "parameters/sepconv0/depthwise/kernel" in phist
    for k in rhist:
        np.testing.assert_array_equal(np.sort(phist[k].values), np.sort(rhist[k].values), k)


def _write_log(path):
    logger = MLPerfLogger(path, "deepcam", "deepcam_tpu", barrier_fn=lambda: None)
    logger.log_event(key="global_batch_size", value=8)
    logger.log_start(key="run_start", sync=True)
    for epoch in (1, 2):
        logger.log_start(key="epoch_start", metadata={"epoch_num": epoch})
        for step in (2 * epoch - 1, 2 * epoch):
            md = {"epoch_num": epoch, "step_num": step}
            logger.log_event(key="learning_rate", value=1e-3 / step, metadata=md)
            logger.log_event(key="train_loss", value=1.0 / step, metadata=md)
            logger.log_event(key="train_accuracy", value=0.1 * step, metadata=md)
        md = {"epoch_num": epoch, "step_num": 2 * epoch}
        logger.log_event(key="eval_accuracy", value=0.4 * epoch, metadata=md)
        logger.log_event(key="eval_loss", value=0.9 / epoch, metadata=md)
        logger.log_end(key="epoch_stop", metadata={"epoch_num": epoch})
    logger.log_event(key="target_accuracy_reached", value=0.8,
                     metadata={"epoch_num": 2, "step_num": 4})
    logger.log_end(key="run_stop", sync=True, metadata={"status": "success"})
    logger.close()


def test_log_analysis_matches_jax(tmp_path):
    """``extract_series``, ``run_summary`` and ``to_dataframe`` read the same
    values from one log the port's logger wrote (exact)."""
    path = str(tmp_path / "run.log")
    _write_log(path)
    summary, ref = analysis.run_summary(path), jax_analysis.run_summary(path)
    assert summary == ref
    assert summary["target_accuracy_reached"] and summary["target_step"] == 4
    assert summary["epochs"] == 2 and summary["global_batch_size"] == 8
    assert [s for _, s, _ in summary["train_loss"]] == [1, 2, 3, 4]
    records = analysis.parse_mllog(path)
    for key in ("train_loss", "eval_accuracy", "learning_rate", "missing"):
        assert analysis.extract_series(records, key) == \
            jax_analysis.extract_series(records, key)
    got, want = analysis.to_dataframe(path), jax_analysis.to_dataframe(path)
    assert list(got.columns) == list(want.columns)
    assert got.astype(str).equals(want.astype(str))


@pytest.mark.parametrize("missing", [".wandbirc", "token"])
def test_wandb_shim_without_credentials_stays_inert(tmp_path, monkeypatch, missing):
    """An absent certificate or one without a token leaves the shim inert,
    as the JAX shim is, and logs nothing."""
    fake = install_fake_wandb(monkeypatch, wandb_utils)
    if missing == "token":
        (tmp_path / ".wandbirc").write_text("user-only\n")
    wb = wandb_utils.WandbLogger(enable=True, rank=0, certdir=str(tmp_path), run_tag="r")
    wb.log({"train_loss": 1.0}, 1)
    assert not wb.active and fake.calls == []
