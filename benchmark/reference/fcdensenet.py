"""Plain FC-DenseNet103 in fp32, the "One Hundred Layers Tiramisu": the
benchmark's reference, written from the published architecture (Jégou et
al., arXiv:1611.09326, Table 2, and its code at github.com/SimJeg/FC-DenseNet),
with no kernel, fusion or cache.

It imports nothing of the program: plain ``torch.nn.functional`` on a dict
of tensors named as ``param_specs`` names them.  A configuration gives
``growth_rate``, ``first_conv``, ``layers_per_block`` (down blocks, the
bottleneck, up blocks), ``dropout`` and ``dropout_seed``.

* first layer: 3x3 conv with bias, padding 1;
* dense layer: train-mode BN (batch statistics, biased variance for the
  apply, unbiased for the running update, eps 1e-5) → ReLU → 3x3 conv with
  bias → dropout, then ``cat([input, new])``; a down block passes on its
  whole stack (the skip), the bottleneck and the up blocks their new
  features, the last up block its whole stack;
* transition down: BN → ReLU → 1x1 conv with bias → dropout → 2x2 max pool;
* transition up: 3x3 transposed conv, stride 2, padding 0, with bias,
  cropped to the skip's (2h, 2w) from the top left (the centre crop of an
  excess of one), then ``cat([up, skip])``;
* classifier: 1x1 conv with bias.

Dropout ``l`` (the dense layers and transitions down in forward order) of
train forward ``t`` keeps the elements where ``torch.rand((N, H, W, C))``,
drawn from a generator seeded with ``dropout_key(dropout_seed, rank, t,
l)`` on the input's device and viewed as NCHW, is >= p, and applies ``x *
mask / (1 - p)``.  ``t`` counts the forwards over one ``params`` dict (each
run of ``reference/train.py:run_steps`` makes a new one); the rank is 0,
for one card, and ``forward`` refuses a second forward over parameters that
no update changed since the last, as ``run_steps`` makes one per emulated
rank in a step: the masks of rank r are keyed by (r, step), which the
family's ``forward`` is not told.  This is how the program draws its masks,
so both sides drop the same elements.

On a CUDA device, and only there, each dense block runs under
``torch.utils.checkpoint`` (a batch-2 forward at full resolution would
hold about 60 GB in fp32); the arithmetic is the same, and on the meta
device, where ``flops_per_sample`` counts, nothing is recomputed.

``quant`` is applied to both operands of every convolution and to the
gradients that flow back to them (``quant.py``).
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .quant import identity

EPS = 1e-5
# the last params dict that ``forward`` saw, its forwards so far, and the
# parameters' in-place versions at the last of them
_seen: list = [None, 0, None]


def dropout_key(seed: int, rank: int, t: int, l: int) -> int:
    """63 bits of the BLAKE2b digest of ``"seed:rank:t:l"``."""
    digest = hashlib.blake2b(f"{seed}:{rank}:{t}:{l}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & (2 ** 63 - 1)


def keep_mask(x: torch.Tensor, p: float, key: int) -> torch.Tensor:
    n, c, h, w = x.shape
    if x.device.type == "meta":
        return torch.ones((n, c, h, w), dtype=torch.bool, device=x.device)
    gen = torch.Generator(device=x.device).manual_seed(key)
    return (torch.rand((n, h, w, c), generator=gen, device=x.device) >= p).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------

def plan(cfg: dict) -> dict:
    """Channel counts: ``down[i]`` = (input, layers) of down block i,
    ``skips``, the bottleneck's (input, layers), ``tu[i]`` = the channels
    of transition up i, ``up[i]`` = (input, layers), and the classifier's
    input."""
    g, lpb = cfg["growth_rate"], cfg["layers_per_block"]
    n_pool = len(lpb) // 2
    c, down, skips = cfg["first_conv"], [], []
    for i in range(n_pool):
        down.append((c, lpb[i]))
        c += lpb[i] * g
        skips.append(c)
    bottleneck = (c, lpb[n_pool])
    tu, up = [], []
    for i in range(n_pool):
        tu.append(lpb[n_pool + i] * g)
        c = tu[-1] + skips[n_pool - 1 - i]
        up.append((c, lpb[n_pool + 1 + i]))
    return {"down": down, "skips": skips, "bottleneck": bottleneck, "tu": tu, "up": up,
            "classifier": c + lpb[-1] * g, "n_pool": n_pool}


def _bn(name: str, width: int) -> List[tuple]:
    return [(f"{name}.weight", (width,), "ones"), (f"{name}.bias", (width,), "zeros"),
            (f"{name}.running_mean", (width,), "zeros"),
            (f"{name}.running_var", (width,), "ones")]


def _conv(name: str, in_ch: int, out_ch: int, k: int) -> List[tuple]:
    return [(f"{name}.weight", (out_ch, in_ch, k, k), "kaiming"),
            (f"{name}.bias", (out_ch,), "zeros")]


def _block(name: str, in_ch: int, n: int, g: int) -> List[tuple]:
    out = []
    for i in range(n):
        c = in_ch + i * g
        out += _bn(f"{name}.layers.{i}.bn", c) + _conv(f"{name}.layers.{i}.conv", c, g, 3)
    return out


def param_specs(cfg: dict) -> List[tuple]:
    """[(name, shape, init)] of every tensor, in the program's
    ``state_dict`` order: He normal ("kaiming") conv and transposed-conv
    weights, zero biases, BN γ 1 and β 0, running mean 0 and variance 1."""
    p, g = plan(cfg), cfg["growth_rate"]
    out = _conv("first_conv", cfg["in_channels"], cfg["first_conv"], 3)
    for i, (c, n) in enumerate(p["down"]):
        out += _block(f"down{i}", c, n, g)
        out += _bn(f"td{i}.bn", p["skips"][i]) + _conv(f"td{i}.conv", p["skips"][i],
                                                      p["skips"][i], 1)
    out += _block("bottleneck", *p["bottleneck"], g)
    for i, (c, n) in enumerate(p["up"]):
        out += [(f"tu{i}.weight", (p["tu"][i], p["tu"][i], 3, 3), "kaiming"),
                (f"tu{i}.bias", (p["tu"][i],), "zeros")]
        out += _block(f"up{i}", c, n, g)
    return out + _conv("classifier", p["classifier"], cfg["n_classes"], 1)


def is_buffer(name: str) -> bool:
    return name.endswith((".running_mean", ".running_var"))


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

class Forward:
    """One forward over ``params``: train forward ``t`` (``batch_stats``
    collects each BN's (mean, unbiased variance)), or with ``t`` None an
    eval forward (each BN's running statistics, no dropout)."""

    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor], quant: Callable,
                 t: Optional[int]):
        self.cfg, self.p, self.quant, self.t = cfg, params, quant, t
        self.batch_stats: Dict[str, tuple] = {}

    def conv(self, name, x, padding=0):
        y = F.conv2d(self.quant(x), self.quant(self.p[f"{name}.weight"]), padding=padding)
        return y + self.p[f"{name}.bias"][:, None, None]

    def bn_relu(self, name, x):
        if self.t is None:
            mean, var = self.p[f"{name}.running_mean"], self.p[f"{name}.running_var"]
        else:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            n = x.shape[0] * x.shape[2] * x.shape[3]
            self.batch_stats[name] = (mean.detach(), var.detach() * (n / max(n - 1, 1)))
        inv = torch.rsqrt(var + EPS) * self.p[f"{name}.weight"]
        y = (x - mean[:, None, None]) * inv[:, None, None] + self.p[f"{name}.bias"][:, None,
                                                                                   None]
        return torch.relu(y)

    def dropout(self, x, l):
        p = self.cfg["dropout"]
        if p == 0 or self.t is None:
            return x
        key = dropout_key(self.cfg["dropout_seed"], 0, self.t, l)
        return x * keep_mask(x, p, key) / (1.0 - p)

    def layer(self, name, x, l):
        new = self.conv(f"{name}.conv", self.bn_relu(f"{name}.bn", x), padding=1)
        return torch.cat([x, self.dropout(new, l)], 1)

    def block(self, name, x, n, first_l, keep_input):
        c = x.shape[1]

        def run(x):
            for i in range(n):
                x = self.layer(f"{name}.layers.{i}", x, first_l + i)
            return x if keep_input else x[:, c:]

        if x.device.type == "cuda":
            return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False,
                                                     preserve_rng_state=False)
        return run(x)

    def transition_down(self, name, x, l):
        x = self.dropout(self.conv(f"{name}.conv", self.bn_relu(f"{name}.bn", x)), l)
        return F.max_pool2d(x, 2)

    def transition_up(self, name, x, skip):
        y = F.conv_transpose2d(self.quant(x), self.quant(self.p[f"{name}.weight"]), stride=2)
        y = y[:, :, :skip.shape[2], :skip.shape[3]] + self.p[f"{name}.bias"][:, None, None]
        return torch.cat([y, skip], 1)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, C) fp32 → logits (N, H, W, n_classes) fp32."""
        lpb = self.cfg["layers_per_block"]
        n_pool = len(lpb) // 2
        x = self.conv("first_conv", x.permute(0, 3, 1, 2), padding=1)
        skips, l = [], 0
        for i in range(n_pool):
            x = self.block(f"down{i}", x, lpb[i], l, True)
            skips.append(x)
            l += lpb[i]
            x = self.transition_down(f"td{i}", x, l)
            l += 1
        x = self.block("bottleneck", x, lpb[n_pool], l, False)
        l += lpb[n_pool]
        for i in range(n_pool):
            x = self.transition_up(f"tu{i}", x, skips[n_pool - 1 - i])
            n = lpb[n_pool + 1 + i]
            x = self.block(f"up{i}", x, n, l, i == n_pool - 1)
            l += n
        return self.conv("classifier", x).permute(0, 2, 3, 1)


def forward(cfg: dict, params: Dict[str, torch.Tensor], x: torch.Tensor,
            quant: Callable = identity, stats: Optional[dict] = None) -> torch.Tensor:
    """Logits of one training forward, the ``t``-th over ``params`` (0 for
    a dict not seen last); each BN's batch (mean, unbiased variance) goes
    into ``stats`` when given.  Raises on a second forward before an update
    of ``params``: a second rank's, whose masks this reference cannot key."""
    versions = tuple(v._version for v in params.values())
    if _seen[0] is not params:
        _seen[:] = [params, 0, None]
    elif _seen[2] == versions:
        raise NotImplementedError(
            "the FC-DenseNet reference draws one rank's dropout masks: a second forward "
            "in one step (a cell of more than one rank) needs (rank, t) passed to it")
    t = _seen[1]
    _seen[1:] = [t + 1, versions]
    fwd = Forward(cfg, params, quant, t)
    out = fwd(x)
    if stats is not None:
        stats.update(fwd.batch_stats)
    return out


def eval_forward(cfg: dict, params: Dict[str, torch.Tensor], x: torch.Tensor,
                 quant: Callable = identity) -> torch.Tensor:
    """Logits of an eval forward: each BN's running statistics, no
    dropout."""
    return Forward(cfg, params, quant, None)(x)
