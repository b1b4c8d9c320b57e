"""Optimizers (counterpart of ``deepcam_tpu/train/optim.py``).

This slice ports AdamW, the bench's optimizer; Adam, LAMB and the LR
schedules come later.
"""

from __future__ import annotations

from typing import Iterable

import torch


def build_optimizer(name: str, params: Iterable[torch.nn.Parameter],
                    learning_rate: float, eps: float = 1e-8,
                    weight_decay: float = 1e-6) -> torch.optim.Optimizer:
    """``AdamW``: the math of ``optax.adamw`` (b1 0.9, b2 0.999, eps added
    to sqrt(v̂), decoupled weight decay on every parameter), which
    ``torch.optim.AdamW`` computes in the same form."""
    if name != "AdamW":
        raise NotImplementedError(f"optimizer {name!r} is not ported yet")
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=eps,
                             weight_decay=weight_decay, foreach=True)
