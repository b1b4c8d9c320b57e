"""Shared helpers of the ``test_torch_*`` files: the JAX reference in the
port's configuration, and numpy tree comparison."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest


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
