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
or assigns twice.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Tuple

import torch

BN_KEYS = ("weight", "bias", "running_mean", "running_var")
BUFFER_SUFFIXES = (".running_mean", ".running_var")


def reference_names(model: torch.nn.Module) -> List[Tuple[str, str]]:
    """[(port state_dict key, reference key without ``module.``), ...] for
    every tensor of the port's ``DeepLabv3plus``, in the reference's order."""
    out: List[Tuple[str, str]] = []

    def conv(port, ref, bias=False):
        out.append((f"{port}.weight", f"{ref}.weight"))
        if bias:
            out.append((f"{port}.bias", f"{ref}.bias"))

    def bn(port, ref):
        out.extend((f"{port}.{k}", f"{ref}.{k}") for k in BN_KEYS)

    def sep(port, ref):
        out.append((f"{port}.depthwise.weight", f"{ref}.conv1.weight"))
        out.append((f"{port}.pointwise.weight", f"{ref}.pointwise.weight"))

    x, xr = model.xception, "xception_features"
    conv("xception.conv1", f"{xr}.conv1")
    bn("xception.bn1", f"{xr}.bn1")
    conv("xception.conv2", f"{xr}.conv2")
    bn("xception.bn2", f"{xr}.bn2")
    blocks = sorted((int(n[5:]), n) for n, _ in x.named_children() if n.startswith("block"))
    for _, name in blocks:
        blk, p, r = getattr(x, name), f"xception.{name}", f"{xr}.{name}"
        # the reference registers the skip before its rep Sequential
        if blk.skip_conv is not None:
            conv(f"{p}.skip_conv", f"{r}.skip")
            bn(f"{p}.skip_bn", f"{r}.skipbn")
        # rep = [ReLU, sepconv, BN] per unit, without the first ReLU when
        # the block does not start with one, then the bare tail sepconv
        first = 1 if blk.start_with_relu else 0
        for i in range(blk.n_units):
            sep(f"{p}.sepconv{i}", f"{r}.rep.{3 * i + first}")
            bn(f"{p}.bn{i}", f"{r}.rep.{3 * i + first + 1}")
        if blk.tail is not None:
            sep(f"{p}.{blk.tail}", f"{r}.rep.{3 * blk.n_units + first - 1}")
    for i in (3, 4, 5):
        sep(f"xception.conv{i}", f"{xr}.conv{i}")
        bn(f"xception.bn{i}", f"{xr}.bn{i}")
    for i in range(1, len(model.rates) + 1):
        conv(f"aspp{i}.atrous_conv", f"aspp{i}.atrous_convolution")
        bn(f"aspp{i}.bn", f"aspp{i}.bn")
    conv("gap_conv", "global_avg_pool.1")
    bn("gap_bn", "global_avg_pool.2")
    conv("conv1", "conv1")
    bn("bn1", "bn1")
    conv("conv2", "conv2")
    bn("bn2", "bn2")
    for k in (1, 2):
        conv(f"upsample.deconv{k}", f"upsample.deconv{k}.0")
        bn(f"upsample.deconv{k}_bn", f"upsample.deconv{k}.1")
    conv("upsample.conv0", "upsample.conv1.0")
    bn("upsample.bn0", "upsample.conv1.1")
    conv("upsample.conv1", "upsample.conv1.3")
    bn("upsample.bn1", "upsample.conv1.4")
    conv("upsample.conv2", "upsample.conv1.6", bias=True)
    conv("upsample.deconv3", "upsample.deconv3.0")
    bn("upsample.deconv3_bn", "upsample.deconv3.1")
    conv("upsample.last_deconv", "upsample.last_deconv.0")

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
