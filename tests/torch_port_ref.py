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


def port_variables(seed: int, n_classes: int = 3):
    """{"params", "batch_stats"} of the JAX DeepLabv3plus as numpy trees,
    from the port's own seeded initialisation through the weight bridge: the
    same tree as the JAX model's ``init`` (``test_torch_weights.py``), at a
    fraction of the cost of compiling that init."""
    import torch

    from deepcam_tpu_torch.models.deeplab import DeepLabv3plus
    from deepcam_tpu_torch.tools.weights import state_dict_to_jax

    model = DeepLabv3plus(n_classes, dtype=torch.float32, device="cpu", seed=seed)
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
