"""Names of the port's tensors in the reference PyTorch model's schema.

The reference's ``DeepLabv3_plus`` names its tensors after its modules:
``xception_features.block1.rep.1.conv1.weight`` (a separable conv's
depthwise kernel inside a block's ``rep`` Sequential, whose parameterless
ReLUs take indices too), ``upsample.deconv1.0.weight``,
``global_avg_pool.1.weight``.  The port names its modules after the JAX
tree.  ``reference_names`` pairs the two, in the reference's registration
order, which is its ``state_dict`` order and, without the BN running
statistics, the order its optimizer indexes parameters in.

Layouts agree (OIHW, depthwise (C, 1, 3, 3), transposed conv (I, O, 3, 3)),
so the map only renames.  It raises on a port tensor it leaves unassigned
or assigns twice, and on a model with the interpolation decoder: the
reference names its decoder after the deconv one's modules, and the repo
holds no reference schema for the interpolation decoder (the JAX package's
importer maps the deconv decoder only).
"""

from __future__ import annotations

from collections import Counter
from typing import List, Tuple

import torch

BN_KEYS = ("weight", "bias", "running_mean", "running_var")
BUFFER_SUFFIXES = (".running_mean", ".running_var")


def conv_names(port: str, ref: str, bias: bool = False) -> List[Tuple[str, str]]:
    """(port key, reference key) of a conv's weight, and its bias."""
    return [(f"{port}.weight", f"{ref}.weight")] + (
        [(f"{port}.bias", f"{ref}.bias")] if bias else [])


def bn_names(port: str, ref: str) -> List[Tuple[str, str]]:
    return [(f"{port}.{k}", f"{ref}.{k}") for k in BN_KEYS]


def sep_names(port: str, ref: str) -> List[Tuple[str, str]]:
    """A separable conv: the reference's ``conv1`` is the depthwise."""
    return [(f"{port}.depthwise.weight", f"{ref}.conv1.weight"),
            (f"{port}.pointwise.weight", f"{ref}.pointwise.weight")]


def xception_names(x: torch.nn.Module) -> List[Tuple[str, str]]:
    """[(port key, reference key), ...] of the backbone ``model.xception``
    at either output stride, in the reference's order."""
    xr = "xception_features"
    out = conv_names("xception.conv1", f"{xr}.conv1") + bn_names("xception.bn1", f"{xr}.bn1")
    out += conv_names("xception.conv2", f"{xr}.conv2") + bn_names("xception.bn2", f"{xr}.bn2")
    blocks = sorted((int(n[5:]), n) for n, _ in x.named_children() if n.startswith("block"))
    for _, name in blocks:
        blk, p, r = getattr(x, name), f"xception.{name}", f"{xr}.{name}"
        # the reference registers the skip before its rep Sequential
        if blk.skip_conv is not None:
            out += conv_names(f"{p}.skip_conv", f"{r}.skip")
            out += bn_names(f"{p}.skip_bn", f"{r}.skipbn")
        # rep = [ReLU, sepconv, BN] per unit, without the first ReLU when
        # the block does not start with one, then the bare tail sepconv
        # (stride 2, or stride 1 with is_last)
        first = 1 if blk.start_with_relu else 0
        for i in range(blk.n_units):
            out += sep_names(f"{p}.sepconv{i}", f"{r}.rep.{3 * i + first}")
            out += bn_names(f"{p}.bn{i}", f"{r}.rep.{3 * i + first + 1}")
        if blk.tail is not None:
            out += sep_names(f"{p}.{blk.tail}", f"{r}.rep.{3 * blk.n_units + first - 1}")
    for i in (3, 4, 5):
        out += sep_names(f"xception.conv{i}", f"{xr}.conv{i}")
        out += bn_names(f"xception.bn{i}", f"{xr}.bn{i}")
    return out


def reference_names(model: torch.nn.Module) -> List[Tuple[str, str]]:
    """[(port state_dict key, reference key without ``module.``), ...] for
    every tensor of the port's ``DeepLabv3plus``, in the reference's order.
    ``FCDenseNet103`` has no reference checkpoint in this repository: its
    checkpoints name its tensors as its ``state_dict`` does."""
    from ..models.tiramisu import FCDenseNet103

    if isinstance(model, FCDenseNet103):
        return [(k, k) for k in model.state_dict()]
    if model.decoder != "deconv":
        raise NotImplementedError(
            f"reference_names: no reference checkpoint schema for the {model.decoder!r} "
            "decoder (the reference schema names the deconv decoder only)")
    out = xception_names(model.xception)
    for i in range(1, len(model.rates) + 1):
        out += conv_names(f"aspp{i}.atrous_conv", f"aspp{i}.atrous_convolution")
        out += bn_names(f"aspp{i}.bn", f"aspp{i}.bn")
    out += conv_names("gap_conv", "global_avg_pool.1")
    out += bn_names("gap_bn", "global_avg_pool.2")
    out += conv_names("conv1", "conv1")
    out += bn_names("bn1", "bn1")
    out += conv_names("conv2", "conv2")
    out += bn_names("bn2", "bn2")
    for k in (1, 2):
        out += conv_names(f"upsample.deconv{k}", f"upsample.deconv{k}.0")
        out += bn_names(f"upsample.deconv{k}_bn", f"upsample.deconv{k}.1")
    out += conv_names("upsample.conv0", "upsample.conv1.0")
    out += bn_names("upsample.bn0", "upsample.conv1.1")
    out += conv_names("upsample.conv1", "upsample.conv1.3")
    out += bn_names("upsample.bn1", "upsample.conv1.4")
    out += conv_names("upsample.conv2", "upsample.conv1.6", bias=True)
    out += conv_names("upsample.deconv3", "upsample.deconv3.0")
    out += bn_names("upsample.deconv3_bn", "upsample.deconv3.1")
    out += conv_names("upsample.last_deconv", "upsample.last_deconv.0")

    port_keys = Counter(p for p, _ in out)
    have = set(model.state_dict())
    twice = sorted(k for k, n in port_keys.items() if n > 1)
    unknown = sorted(set(port_keys) - have)
    missing = sorted(have - set(port_keys))
    if twice or unknown or missing:
        raise KeyError(f"reference name map: assigned twice {twice}, not in the model "
                       f"{unknown}, unassigned {missing}")
    return out


def is_parameter(key: str) -> bool:
    """True for a parameter's key, False for a BN running statistic."""
    return not key.endswith(BUFFER_SUFFIXES)
