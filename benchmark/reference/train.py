"""The plain reference of a training step: weighted cross-entropy, the train
IoU, the workload's optimizer and data parallelism over R ranks, in fp32,
over the plain forward of the configuration's family
(``families/<family>.py``).  The optimizers: LAMB (apex FusedLAMB at its
defaults: global-norm clip at 1.0, then ``optax.lamb``'s math) and AdamW
(``optax.adamw``, no clip).

``run_steps`` follows the program's first steps from the same weights on
the same batches and returns what the comparison reads: each step's loss
and IoU, the first step's gradient (before any clip) and BN running
statistics, and the parameters after the last step.  Nothing here imports
the program.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Sequence

import torch

from .. import spec
from .quant import identity

# the reference's class pixel frequencies (mlcommons/hpc deepcam), raised
# to the loss-weight power -0.125
CLASS_FREQUENCIES = (0.986267818390377, 0.0004578708870701058, 0.01327431072255291)
LOSS_WEIGHT_POW = -0.125
MOMENTUM = 0.1
BETAS = (0.9, 0.999)
EPS = 1e-8
MAX_GRAD_NORM = 1.0


@contextlib.contextmanager
def full_fp32():
    """TF32 off for matmuls and cuDNN while the reference runs."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def weighted_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over pixels of weight[label] * CE(logits, label)."""
    w = torch.tensor([f ** LOSS_WEIGHT_POW for f in CLASS_FREQUENCIES],
                     dtype=torch.float32, device=logits.device)
    lab = labels.long()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, lab[..., None])[..., 0]
    return (w[lab] * (lse - picked)).mean()


def mean_iou(logits: torch.Tensor, labels: torch.Tensor, n_classes: int) -> float:
    """IoU of the whole batch as one sample, averaged over classes; a class
    absent from both prediction and label scores 1."""
    pred = logits.argmax(-1)
    total = 0.0
    for j in range(n_classes):
        tp = ((pred == j) & (labels == j)).sum().item()
        fp = ((pred == j) & (labels != j)).sum().item()
        fn = ((pred != j) & (labels == j)).sum().item()
        union = tp + fp + fn
        total += tp / union if union else 1.0
    return total / n_classes


class Lamb:
    """LAMB over a dict of fp32 parameters, one tensor at a time."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, weight_decay: float):
        self.lr, self.wd, self.t = lr, weight_decay, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def clip(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        norm = math.sqrt(sum(float(g.double().pow(2).sum()) for g in grads.values()))
        if norm < MAX_GRAD_NORM:
            return grads
        return {k: g * (MAX_GRAD_NORM / norm) for k, g in grads.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        """Updates ``params`` in place."""
        self.t += 1
        b1, b2 = BETAS
        g_clip = self.clip(grads)
        for k, p in params.items():
            g = g_clip[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).add_(g * g, alpha=1 - b2)
            u = (self.m[k] / (1 - b1 ** self.t)) / ((self.v[k] / (1 - b2 ** self.t)).sqrt()
                                                   + EPS)
            u = u + self.wd * p
            pn, un = p.norm(), u.norm()
            ratio = pn / un if (pn > 0 and un > 0) else torch.ones((), device=p.device)
            p.sub_(self.lr * ratio * u)


class AdamW:
    """AdamW over a dict of fp32 parameters, one tensor at a time: the math
    of ``optax.adamw`` (b1 0.9, b2 0.999, eps added to sqrt(v̂), bias
    corrections, decoupled decay lr·wd·p on every tensor, no clip)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, weight_decay: float,
                 eps: float = EPS):
        self.lr, self.wd, self.eps, self.t = lr, weight_decay, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        """Updates ``params`` in place."""
        self.t += 1
        b1, b2 = BETAS
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).add_(g * g, alpha=1 - b2)
            u = (self.m[k] / (1 - b1 ** self.t)) / ((self.v[k] / (1 - b2 ** self.t)).sqrt()
                                                   + self.eps)
            p.sub_(self.lr * (u + self.wd * p))


def optimizer(opt: dict, params: Dict[str, torch.Tensor]):
    """The reference of the workload's ``optimizer`` (its ``name``, ``lr``,
    ``weight_decay`` and ``eps``)."""
    if opt["name"] == "LAMB":
        return Lamb(params, opt["lr"], opt["weight_decay"])
    if opt["name"] == "AdamW":
        return AdamW(params, opt["lr"], opt["weight_decay"], opt["eps"])
    raise ValueError(f"the reference has no optimizer {opt['name']!r}")


def run_steps(cfg: dict, weights: Dict[str, torch.Tensor],
              batches: Sequence[Sequence[tuple]], opt: dict,
              quant: Callable = identity) -> dict:
    """The reference's training steps.  ``weights``: every tensor of the
    family's ``param_specs`` (fp32, on the device it runs on; not
    modified); ``opt``: the workload's ``optimizer``.
    ``batches[s][r]``: rank r's (x NHWC fp32, labels) at step s; the
    gradients are averaged over ranks, each rank's BN uses its own batch
    statistics, and the running statistics are the mean of the ranks'
    updates.  Returns {"loss": [...], "iou": [...], "grad1": {name: g},
    "buffers1": {...}, "params": {...}}: the loss and IoU of each step
    averaged over ranks, the first step's gradient as the optimizer
    receives it (averaged over ranks, before any clip) and running
    statistics, and the last step's parameters."""
    fam = spec.config_family(cfg)
    n_cls = cfg["n_classes"]
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()
              if not fam.is_buffer(k)}
    buffers = {k: v.detach().clone() for k, v in weights.items() if fam.is_buffer(k)}
    update = optimizer(opt, params)
    out = {"loss": [], "iou": [], "grad1": None}
    for step in batches:
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        means = {k: torch.zeros_like(v) for k, v in buffers.items()}
        losses, ious = [], []
        for x, y in step:
            stats: dict = {}
            logits = fam.forward(cfg, params, x, quant, stats)
            loss = weighted_ce(logits, y)
            g = torch.autograd.grad(loss, list(params.values()))
            with torch.no_grad():
                for k, gk in zip(params, g):
                    grads[k] += gk / len(step)
                for name, (mean, var) in stats.items():
                    means[f"{name}.running_mean"] += mean / len(step)
                    means[f"{name}.running_var"] += var / len(step)
            losses.append(loss.item())
            ious.append(mean_iou(logits.detach(), y, n_cls))
            del logits, loss, g
        if out["grad1"] is None:
            out["grad1"] = {k: v.clone() for k, v in grads.items()}
        update.step(params, grads)
        with torch.no_grad():
            for k in buffers:
                buffers[k].mul_(1 - MOMENTUM).add_(MOMENTUM * means[k])
        if "buffers1" not in out:
            out["buffers1"] = {k: v.clone() for k, v in buffers.items()}
        out["loss"].append(sum(losses) / len(losses))
        out["iou"].append(sum(ious) / len(ious))
    out["params"] = {k: v.detach() for k, v in params.items()}
    return out
