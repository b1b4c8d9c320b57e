"""Optimizers (counterpart of ``deepcam_tpu/train/optim.py``).

``Adam`` (coupled L2 weight decay), ``AdamW`` (decoupled) and ``LAMB``
(apex FusedLAMB at its defaults: gradients clipped to global norm 1.0, then
the math of ``optax.lamb``), selected by the CLI's ``--optimizer``.

The learning rate is a float or a schedule (``train/schedule.py``).  A
schedule is evaluated inside ``step()`` at the optimizer's own update count
BEFORE that update increments it, as optax's ``scale_by_learning_rate``
evaluates it: the lr of update ``s`` (0-based) is ``schedule(s)``, and it is
written into every ``param_group["lr"]``.  The count is each parameter's
``state["step"]``, which the checkpoint carries, so a resume needs no
scheduler state.

Every optimizer keeps ``exp_avg``, ``exp_avg_sq`` and ``step`` per
parameter, under the names torch's Adam and apex's FusedLAMB use, which the
reference checkpoint schema (``ckpt/checkpoint.py``) stores.
"""

from __future__ import annotations

from typing import Callable, Iterable, Union

import numpy as np
import torch

LearningRate = Union[float, Callable[[int], float]]
# apex FusedLAMB's default, which the reference keeps
MAX_GRAD_NORM = 1.0


def update_count(opt: torch.optim.Optimizer) -> int:
    """Updates taken so far: the ``step`` of the first parameter's state
    (every parameter takes every update), 0 before the first."""
    first = opt.param_groups[0]["params"][0]
    step = opt.state.get(first, {}).get("step", 0)
    return int(step)


class _ScheduledLR:
    """``step()`` first sets every group's lr to ``schedule(update_count)``
    when the optimizer was given a schedule."""

    schedule = None

    def _apply_schedule(self) -> None:
        if self.schedule is not None:
            lr = float(self.schedule(update_count(self)))
            for group in self.param_groups:
                group["lr"] = lr

    def step(self, closure=None):
        self._apply_schedule()
        return super().step(closure)


class Adam(_ScheduledLR, torch.optim.Adam):
    """``torch.optim.Adam(weight_decay=wd)``: wd·p added to the gradient
    before the moments, the math of optax's ``add_decayed_weights →
    scale_by_adam`` (torch computes the bias corrections in double, optax
    in fp32)."""


class AdamW(_ScheduledLR, torch.optim.AdamW):
    """``torch.optim.AdamW``: the math of ``optax.adamw`` (eps added to
    sqrt(v̂), decoupled weight decay on every parameter)."""


class LAMB(_ScheduledLR, torch.optim.Optimizer):
    """Layer-wise adaptive Adam with apex FusedLAMB's defaults, in one
    ``torch._foreach_*`` pass over all parameters:

    1. g ← g / ‖g‖ · MAX_GRAD_NORM when the global norm ‖g‖ over every
       gradient is at least MAX_GRAD_NORM (``optax.clip_by_global_norm``);
    2. m ← (1−b1)·g + b1·m, v ← (1−b2)·g² + b2·v, with bias corrections
       1 − b^t at update t = count + 1;
    3. u ← m̂ / (sqrt(v̂) + eps) + wd·p;
    4. a per-tensor trust ratio ‖p‖ / ‖u‖, 1 where either norm is 0
       (``optax.scale_by_trust_ratio``);
    5. p ← p − lr · ratio · u.

    Each product and sum is rounded where optax rounds it.  The clip and the
    trust ratios stay on the device: a step does not wait for the card.
    """

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        self._apply_schedule()
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        groups = [(g, [p for p in g["params"] if p.grad is not None]) for g in self.param_groups]
        grads = [p.grad for _, ps in groups for p in ps]
        if not grads:
            return loss
        if any(g.is_sparse for g in grads):
            raise RuntimeError("LAMB does not take sparse gradients")
        # 1. global-norm clip: g / ‖g‖ · max where triggered, g itself
        # (divided and multiplied by exact ones) where not
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        below = gnorm < MAX_GRAD_NORM
        one = torch.ones((), dtype=gnorm.dtype, device=gnorm.device)
        div = torch.where(below, one, gnorm)
        mul = torch.where(below, one, torch.full_like(one, MAX_GRAD_NORM))
        clipped = torch._foreach_mul(torch._foreach_div(grads, div), mul)
        at = 0
        for group, params in groups:
            n = len(params)
            g = clipped[at:at + n]
            at += n
            if n:
                self._update(group, params, g)
        return loss

    def _update(self, group, params, grads):
        b1, b2 = group["betas"]
        eps, wd, lr = group["eps"], group["weight_decay"], group["lr"]
        states = [self.state[p] for p in params]
        for p, st in zip(params, states):
            if not st:
                st["step"] = torch.tensor(0.0)
                st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        count = int(states[0]["step"]) + 1
        m = [st["exp_avg"] for st in states]
        v = [st["exp_avg_sq"] for st in states]
        # 2. moments, as optax's update_moment rounds them
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
        # bias corrections in fp32, as optax computes 1 - decay**count
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
        # 3. u = m̂ / (sqrt(v̂) + eps) + wd·p
        denom = torch._foreach_sqrt(torch._foreach_div(v, bc2))
        torch._foreach_add_(denom, eps)
        u = torch._foreach_div(torch._foreach_div(m, bc1), denom)
        if wd != 0.0:
            torch._foreach_add_(u, torch._foreach_mul(params, wd))
        # 4. per-tensor trust ratio, 1 where either norm is 0
        pn = torch.stack(torch._foreach_norm(params))
        un = torch.stack(torch._foreach_norm(u))
        ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
        torch._foreach_mul_(u, list(ratio.unbind()))
        # 5. p ← p + (−lr · ratio · u)
        torch._foreach_mul_(u, -lr)
        torch._foreach_add_(params, u)
        for st in states:
            st["step"] += 1


def build_optimizer(name: str, params: Iterable[torch.nn.Parameter],
                    learning_rate: LearningRate, eps: float = 1e-8,
                    weight_decay: float = 1e-6) -> torch.optim.Optimizer:
    """The optimizer of the CLI's ``--optimizer`` flag over ``params``,
    b1 0.9 and b2 0.999, with ``learning_rate`` a float or a schedule."""
    schedule = learning_rate if callable(learning_rate) else None
    lr = float(schedule(0)) if schedule is not None else float(learning_rate)
    if name == "Adam":
        opt = Adam(params, lr=lr, betas=(0.9, 0.999), eps=eps, weight_decay=weight_decay,
                   foreach=True)
    elif name == "AdamW":
        opt = AdamW(params, lr=lr, betas=(0.9, 0.999), eps=eps, weight_decay=weight_decay,
                    foreach=True)
    elif name == "LAMB":
        opt = LAMB(params, lr=lr, betas=(0.9, 0.999), eps=eps, weight_decay=weight_decay)
    else:
        raise NotImplementedError(f"Error, optimizer {name} not supported")
    opt.schedule = schedule
    return opt
