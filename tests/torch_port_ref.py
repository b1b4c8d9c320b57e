"""Shared helpers of the ``test_torch_*`` files: the JAX reference in the
port's two configurations, the port's base configuration, whole-model
variables, numpy tree comparison, and a fixture that returns a worker's
freed memory."""

from __future__ import annotations

import contextlib
import ctypes
import gc

import numpy as np
import pytest


def _release_freed_memory():
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):  # not glibc
        pass


@pytest.fixture(autouse=True)
def release_memory():
    """Hands the worker's freed heap back to the system before and after
    each test.  glibc keeps freed memory resident, so an xdist worker that
    ran the JAX package's large tests stays at 10-18 GB until it exits; the
    suite runs several workers on one machine.  A module enables this by
    importing it."""
    _release_freed_memory()
    yield
    _release_freed_memory()


@contextlib.contextmanager
def capped_torch_threads(n_max: int = 2):
    """Caps torch's intra-op threads at ``n_max`` inside the block.  The
    suite runs six workers on one machine; with every worker's pool as wide
    as the machine, full-width CPU work of the port ran ten times slower
    than alone."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, n_max))
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture
def few_torch_threads():
    """``capped_torch_threads`` around the test; a module enables it with
    ``pytestmark``."""
    with capped_torch_threads():
        yield


@contextlib.contextmanager
def jax_base_config():
    """The JAX model as the port runs it: unfused XLA sepconv (the plain
    reference path), no BN-apply fold, no kernel-emitted statistics (and so
    no block-boundary fold), plain concats, full-resolution logits."""
    from deepcam_tpu.models import layers

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "_SEPCONV_IMPL", "xla")
        mp.setattr(layers, "_BN_FOLD", False)
        mp.setattr(layers, "_FUSED_STATS", False)
        for var in ("DEEPCAM_BN_FOLD", "DEEPCAM_FUSED_STATS"):
            mp.setenv(var, "0")
        for var in ("DEEPCAM_SPLIT_CONCAT", "DEEPCAM_BLOCK_LOSS"):
            mp.setenv(var, "0")
        yield


@contextlib.contextmanager
def jax_default_config(sepconv_impl: str = "xla"):
    """The JAX model's default configuration, which the port runs by
    default: BN-apply fold, kernel-emitted statistics and the block-boundary
    fold on, plain concats, full-resolution logits.  ``sepconv_impl`` is
    "xla" (the unfused reference path: the same math, the BN reducing y
    itself) or "fused" (the Pallas kernels, in interpret mode on the CPU)."""
    from deepcam_tpu.models import layers

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "_SEPCONV_IMPL", sepconv_impl)
        mp.setattr(layers, "_BN_FOLD", True)
        mp.setattr(layers, "_FUSED_STATS", True)
        for var in ("DEEPCAM_BN_FOLD", "DEEPCAM_FUSED_STATS", "DEEPCAM_BOUNDARY_FOLD"):
            mp.setenv(var, "1")
        for var in ("DEEPCAM_SPLIT_CONCAT", "DEEPCAM_BLOCK_LOSS", "DEEPCAM_BLOCK_EVAL"):
            mp.setenv(var, "0")
        yield


@contextlib.contextmanager
def port_base_config():
    """The port in the configuration of its first slice (and of
    ``jax_base_config``): no BN-apply fold, no kernel statistics, and so no
    boundary fold."""
    from deepcam_tpu_torch.models import layers

    fold, stats = layers._BN_FOLD, layers._FUSED_STATS
    layers.set_bn_fold(False)
    layers.set_fused_stats(False)
    try:
        yield
    finally:
        layers.set_bn_fold(fold)
        layers.set_fused_stats(stats)


def port_variables(seed: int, n_classes: int = 3, **model_kw):
    """{"params", "batch_stats"} of the JAX DeepLabv3plus as numpy trees,
    from the port's own seeded initialisation through the weight bridge: the
    same tree as the JAX model's ``init`` (``test_torch_weights.py``,
    ``test_torch_variants.py``), at a fraction of the cost of compiling that
    init.  ``model_kw`` (``output_stride``, ``decoder``) go to the port's
    model."""
    import torch

    from deepcam_tpu_torch.models.deeplab import DeepLabv3plus
    from deepcam_tpu_torch.tools.weights import state_dict_to_jax

    model = DeepLabv3plus(n_classes, dtype=torch.float32, device="cpu", seed=seed, **model_kw)
    params, stats = state_dict_to_jax(model, model.state_dict())
    return {"params": params, "batch_stats": stats}


def flatten(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, prefix + (str(k),)))
        return out
    return {"/".join(prefix): np.asarray(tree, np.float32)}


def assert_trees_close(got, want, rel, label):
    """Every leaf of ``want`` is in ``got`` and agrees within
    ``rel · max|want leaf|`` (absolute, per leaf)."""
    g, w = flatten(got), flatten(want)
    assert sorted(g) == sorted(w), (label, sorted(set(g) ^ set(w))[:10])
    worst = ("", 0.0)
    for k in w:
        assert g[k].shape == w[k].shape, (label, k, g[k].shape, w[k].shape)
        scale = max(float(np.abs(w[k]).max()), 1e-30)
        err = float(np.abs(g[k] - w[k]).max()) / scale
        if err > worst[1]:
            worst = (k, err)
    assert worst[1] <= rel, f"{label}: worst leaf {worst[0]} rel err {worst[1]:.3e}"
    return worst


class FakeWandb:
    """A stand-in for the ``wandb`` module that records what the shims call:
    ``calls`` holds ("init", kwargs), ("log", payload, step) and
    ("login", argv)."""

    class Image:
        def __init__(self, path, caption=None):
            self.path, self.caption = path, caption

    class Histogram:
        def __init__(self, values):
            self.values = np.asarray(values)

    def __init__(self):
        import types

        self.calls = []
        self.config = types.SimpleNamespace()

    def init(self, **kwargs):
        self.calls.append(("init", kwargs))

    def log(self, payload, step=None):
        self.calls.append(("log", payload, step))

    def logged(self):
        """Every key logged, with the steps it was logged at."""
        keys = {}
        for call in self.calls:
            if call[0] == "log":
                for k in call[1]:
                    keys.setdefault(k, []).append(call[2])
        return keys


def install_fake_wandb(monkeypatch, *shims, certdir=None):
    """A ``FakeWandb`` in ``sys.modules`` and in each shim module (what
    importing it would have bound), ``wandb login`` recorded instead of run,
    and a ``.wandbirc`` in ``certdir`` if given."""
    import sys

    fake = FakeWandb()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    for shim in shims:
        monkeypatch.setattr(shim, "_wandb", fake)
        monkeypatch.setattr(shim, "HAVE_WANDB", True)
        monkeypatch.setattr(shim.subprocess, "call",
                            lambda argv: fake.calls.append(("login", argv)) or 0)
    if certdir is not None:
        certdir.mkdir(parents=True, exist_ok=True)
        (certdir / ".wandbirc").write_text("deepcam-user 0123456789abcdef\n")
    return fake
