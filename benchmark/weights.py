"""The model's weights, made on the device from the seed.

One normal draw covers every kaiming-initialised tensor and one uniform draw
every tensor with PyTorch's default init; each tensor is a slice of its
draw, scaled by its own fan-in (the ``param_specs`` of the configuration's
family, ``families/<family>.py``).  The same seed gives the same weights,
which the program loads through ``load_state_dict`` and the reference
takes as they are.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from . import spec
from .seeds import sub_seed


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: fp32 tensor} for every tensor of the family's
    ``param_specs(cfg)``."""
    specs = spec.config_family(cfg).param_specs(cfg)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    sizes = {"normal": 0, "uniform": 0}
    for _, shape, init in specs:
        kind = "normal" if init == "kaiming" else "uniform"
        if init in ("kaiming", "uniform") or init.startswith("bias:"):
            sizes[kind] += math.prod(shape)
    normal = torch.randn(sizes["normal"], generator=gen, device=device)
    uniform = torch.rand(sizes["uniform"], generator=gen, device=device).mul_(2).sub_(1)
    at = {"normal": 0, "uniform": 0}
    out = {}
    for name, shape, init in specs:
        n = math.prod(shape)
        if init == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            fan_in = int(init[5:]) if init.startswith("bias:") else math.prod(shape[1:])
            kind = "normal" if init == "kaiming" else "uniform"
            scale = math.sqrt(2.0 / fan_in) if init == "kaiming" else 1.0 / math.sqrt(fan_in)
            src = normal if kind == "normal" else uniform
            out[name] = (src[at[kind]:at[kind] + n] * scale).view(shape)
            at[kind] += n
    return out
