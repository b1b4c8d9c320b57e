"""FC-DenseNet103, the "One Hundred Layers Tiramisu" (Jégou et al.,
arXiv:1611.09326, Table 2; github.com/SimJeg/FC-DenseNet), on the port's
normal path: the same train and eval steps, DDP and checkpoints as
DeepLabV3+.

Input (N, H, W, C) NHWC → logits (N, H, W, n_classes) NHWC in fp32.  Inside,
activations are NCHW in ``torch.channels_last`` memory, as in
``deeplab.py``; every op computes in ``dtype`` (bf16 on the card) from fp32
parameters, and BatchNorm is ``layers.BatchNorm2d`` (train-mode glue
kernels, eval-mode running statistics).

* first layer: 3x3 conv, C → ``first_conv``, with bias;
* dense layer: BN → ReLU → 3x3 conv with bias to ``growth_rate`` channels →
  dropout; it returns ``cat([input, new])``;
* dense blocks of ``layers_per_block`` layers: the down blocks pass their
  whole stack on (and keep it as the skip), the bottleneck and the up
  blocks only their new features, except the last up block, which passes
  its whole stack;
* transition down: BN → ReLU → 1x1 conv (m → m, bias) → dropout → 2x2 max
  pool;
* transition up: 3x3 transposed conv, stride 2, padding 0, bias, on the
  previous block's new features, cropped from (2h+1, 2w+1) to the skip's
  (2h, 2w) (a centre crop with an excess of one keeps rows and columns
  0 .. 2h-1), then ``cat([up, skip])``;
* classifier: 1x1 conv with bias to the classes.

Initialisation: He normal (std sqrt(2 / fan_in), torch's fan-in) for every
conv and transposed-conv weight, zero biases, BN γ 1 and β 0.

Dropout draws its masks reproducibly: in train mode, dropout ``l`` (0 ..,
the dense layers and transitions down in forward order) of train forward
``t`` (counted from the model's construction) keeps the elements where
``torch.rand((N, H, W, C), generator=Generator(dropout_key(seed, rank, t,
l))) >= p``, drawn in NHWC order and viewed as NCHW, and applies ``x *
mask / (1 - p)`` in ``dtype``.  A plain reference can so draw the same
masks on the same device, and a checkpointed recompute draws them again.
Eval mode applies no dropout.

Spans (``profiling/spans.py``): ``dense.block`` around each dense block's
forward and ``dense.transition`` around each transition down and up.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import resolve_device
from ..core.mesh import get_rank
from ..parallel import spatial
from ..profiling.spans import span
from .layers import BatchNorm2d, Conv2d, kaiming_normal_torch

LAYERS_PER_BLOCK = (4, 5, 7, 10, 12, 15, 12, 10, 7, 5, 4)


def dropout_key(seed: int, rank: int, t: int, l: int) -> int:
    """The seed of dropout ``l``'s generator in train forward ``t`` of rank
    ``rank``: 63 bits of a BLAKE2b digest of the four numbers."""
    digest = hashlib.blake2b(f"{seed}:{rank}:{t}:{l}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & (2 ** 63 - 1)


def keep_mask(shape, p: float, key: int, device) -> torch.Tensor:
    """The boolean keep-mask of an (N, C, H, W) activation: uniform draws in
    NHWC order from a generator seeded with ``key``, kept where >= p."""
    n, c, h, w = shape
    gen = torch.Generator(device=device).manual_seed(key)
    return (torch.rand((n, h, w, c), generator=gen, device=device) >= p).permute(0, 3, 1, 2)


class Dropout:
    """Where a dropout of the model draws its masks: its index ``l``."""

    def __init__(self, p: float, index: int):
        self.p, self.index = p, index

    def __call__(self, x: torch.Tensor, key_of) -> torch.Tensor:
        """``key_of(l)`` gives the generator key of dropout ``l`` in this
        forward, or is None outside train mode."""
        if key_of is None or self.p == 0:
            return x
        mask = keep_mask(x.shape, self.p, key_of(self.index), x.device)
        return (x * mask).div_(1.0 - self.p)


class DenseLayer(nn.Module):
    """BN → ReLU → 3x3 conv (bias) → dropout; returns ``cat([x, new])``."""

    def __init__(self, in_ch: int, growth: int, drop: Dropout, *, dtype: torch.dtype,
                 gen: torch.Generator):
        super().__init__()
        self.bn = BatchNorm2d(in_ch, dtype=dtype)
        self.conv = _conv(in_ch, growth, 3, dtype, gen)
        self.drop = drop

    def forward(self, x: torch.Tensor, key_of) -> torch.Tensor:
        new = self.drop(self.conv(self.bn(x, relu=True)), key_of)
        return torch.cat([x, new], 1).contiguous(memory_format=torch.channels_last)


class DenseBlock(nn.Module):
    """``n`` dense layers on ``in_ch`` channels; returns the whole stack
    (``keep_input``) or only the ``n * growth`` new channels."""

    def __init__(self, in_ch: int, n: int, growth: int, drops: List[Dropout],
                 keep_input: bool, *, dtype: torch.dtype, gen: torch.Generator):
        super().__init__()
        self.in_ch, self.keep_input = in_ch, keep_input
        self.layers = nn.ModuleList(
            DenseLayer(in_ch + i * growth, growth, drops[i], dtype=dtype, gen=gen)
            for i in range(n))

    def forward(self, x: torch.Tensor, key_of) -> torch.Tensor:
        with span("dense.block"):
            for layer in self.layers:
                x = layer(x, key_of)
            return x if self.keep_input else x[:, self.in_ch:]


class TransitionDown(nn.Module):
    """BN → ReLU → 1x1 conv (m → m, bias) → dropout → 2x2 max pool."""

    def __init__(self, ch: int, drop: Dropout, *, dtype: torch.dtype, gen: torch.Generator):
        super().__init__()
        self.bn = BatchNorm2d(ch, dtype=dtype)
        self.conv = _conv(ch, ch, 1, dtype, gen)
        self.drop = drop

    def forward(self, x: torch.Tensor, key_of) -> torch.Tensor:
        with span("dense.transition"):
            x = self.drop(self.conv(self.bn(x, relu=True)), key_of)
            return F.max_pool2d(x, 2)


class TransitionUp(nn.Module):
    """3x3 transposed conv, stride 2, padding 0, with bias, cropped to the
    skip's size and put before it: ``cat([up, skip])``.  Weight (I, O, 3,
    3) as torch's ConvTranspose2d."""

    def __init__(self, ch: int, *, dtype: torch.dtype, gen: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(ch, ch, 3, 3))
        kaiming_normal_torch(self.weight, gen)
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        with span("dense.transition"):
            y = F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype), stride=2)
            h, w = skip.shape[2:]
            y = y[:, :, :h, :w] + self.bias.to(self.dtype)[:, None, None]
            return torch.cat([y, skip], 1).contiguous(memory_format=torch.channels_last)


def _conv(in_ch: int, out_ch: int, k: int, dtype, gen) -> Conv2d:
    """A conv with bias, He normal weights and a zero bias."""
    conv = Conv2d(in_ch, out_ch, k, padding=k // 2, use_bias=True,
                  kernel_init=kaiming_normal_torch, dtype=dtype, gen=gen)
    with torch.no_grad():
        conv.bias.zero_()
    return conv


class FCDenseNet103(nn.Module):
    """FC-DenseNet at the widths of Table 2 by default (growth rate 16, a
    48-channel first conv, blocks of 4, 5, 7, 10, 12 | 15 | 12, 10, 7, 5, 4
    layers, dropout 0.2); any odd-length ``layers_per_block`` gives the
    same design with ``len // 2`` pools.

    ``dtype`` is the compute type; parameters stay fp32.  ``seed`` makes
    the weights (a CPU generator; they are then moved to ``device``) and
    keys the dropout masks.  ``train_forwards`` counts the train-mode
    forwards since construction (the ``t`` of the dropout keys)."""

    def __init__(self, n_classes: int = 3, *, in_ch: int = 16, growth_rate: int = 16,
                 first_conv: int = 48, layers_per_block: Sequence[int] = LAYERS_PER_BLOCK,
                 dropout: float = 0.2, dtype: torch.dtype = torch.float32, device="cuda",
                 seed: int = 0):
        super().__init__()
        if len(layers_per_block) % 2 != 1:
            raise ValueError("layers_per_block needs an odd length: down blocks, the "
                             "bottleneck, up blocks")
        device = resolve_device(device)
        self.dtype, self.n_pool, self.seed = dtype, len(layers_per_block) // 2, seed
        self.train_forwards = 0
        gen = torch.Generator().manual_seed(seed)
        kw = dict(dtype=dtype, gen=gen)
        g, n_pool = growth_rate, self.n_pool
        drops = iter(Dropout(dropout, i) for i in range(sum(layers_per_block) + n_pool))

        def block(c, n, keep):
            return DenseBlock(c, n, g, [next(drops) for _ in range(n)], keep, **kw)

        self.first_conv = _conv(in_ch, first_conv, 3, dtype, gen)
        c, skips = first_conv, []
        for i in range(n_pool):
            n = layers_per_block[i]
            setattr(self, f"down{i}", block(c, n, True))
            c += n * g
            skips.append(c)
            setattr(self, f"td{i}", TransitionDown(c, next(drops), **kw))
        self.bottleneck = block(c, layers_per_block[n_pool], False)
        for i in range(n_pool):
            new = layers_per_block[n_pool + i] * g
            setattr(self, f"tu{i}", TransitionUp(new, **kw))
            c = new + skips[n_pool - 1 - i]
            n = layers_per_block[n_pool + 1 + i]
            setattr(self, f"up{i}", block(c, n, i == n_pool - 1))
        self.classifier = _conv(c + n * g, n_classes, 1, dtype, gen)
        self.to(device)

    def _keys(self):
        """The dropout key function of this forward, or None in eval mode."""
        if not self.training:
            return None
        t = self.train_forwards
        self.train_forwards += 1
        seed, rank = self.seed, get_rank()
        return lambda l: dropout_key(seed, rank, t, l)

    def forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """x: (N, H, W, C) NHWC → fp32 logits (N, H, W, n_classes) NHWC;
        H and W divisible by 2 ** (number of pools)."""
        if remat:
            raise NotImplementedError("FCDenseNet103 takes no remat")
        if spatial.spatial_active():
            raise NotImplementedError("FCDenseNet103 takes no spatial partitioning")
        key_of = self._keys()
        x = x.permute(0, 3, 1, 2).to(self.dtype).contiguous(memory_format=torch.channels_last)
        x = self.first_conv(x)
        skips = []
        for i in range(self.n_pool):
            x = getattr(self, f"down{i}")(x, key_of)
            skips.append(x)
            x = getattr(self, f"td{i}")(x, key_of)
        x = self.bottleneck(x, key_of)
        for i in range(self.n_pool):
            x = getattr(self, f"tu{i}")(x, skips[self.n_pool - 1 - i])
            x = getattr(self, f"up{i}")(x, key_of)
        return self.classifier(x).float().permute(0, 2, 3, 1)
