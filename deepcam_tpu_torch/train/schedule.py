"""Learning-rate schedules (counterpart of ``deepcam_tpu/train/schedule.py``).

Plain ``step -> float`` functions of the optimizer's update count, with the
semantics of the reference's torch schedulers:

* multistep decay (torch ``MultiStepLR`` stepped once per optimizer step):
  lr = start_lr * gamma^(number of milestones <= step);
* linear warmup (``GradualWarmupScheduler``): over ``warmup_steps`` steps
  the lr ramps from ``start_lr`` towards ``start_lr * multiplier``;
  afterwards the wrapped schedule runs with its step shifted by
  ``warmup_steps`` and its lr scaled by ``multiplier``.

No scheduler object keeps state, so a resume needs only the step.  Values
are computed in fp32, as the JAX schedules compute them.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence

import numpy as np

Schedule = Callable[[int], float]


def multistep_schedule(start_lr: float, milestones: Sequence[int],
                       gamma: float) -> Schedule:
    """lr(step) = start_lr * gamma ** (number of milestones <= step): the lr
    used at optimizer step ``s`` (0-based) has decayed at every milestone
    ``m <= s``."""
    ms = sorted(int(m) for m in milestones)

    def schedule(step: int) -> float:
        n = sum(m <= int(step) for m in ms)
        return float(np.float32(start_lr) * np.float32(gamma) ** np.float32(n))

    return schedule


def warmup_wrap(base_schedule: Schedule, start_lr: float, warmup_steps: int,
                multiplier: float) -> Schedule:
    """GradualWarmupScheduler semantics around ``base_schedule``:
    ``start_lr * ((multiplier - 1) * step / warmup_steps + 1)`` while
    ``step < warmup_steps``, then ``multiplier * base(step - warmup_steps)``."""
    if warmup_steps <= 0:
        return base_schedule

    def schedule(step: int) -> float:
        step = int(step)
        if step < warmup_steps:
            ramp = np.float32(multiplier - 1.0) * np.float32(step) \
                / np.float32(warmup_steps) + np.float32(1.0)
            return float(np.float32(start_lr) * ramp)
        return float(np.float32(multiplier) * np.float32(base_schedule(step - warmup_steps)))

    return schedule


def get_lr_schedule(start_lr: float, scheduler_arg: Optional[Mapping[str, str]],
                    warmup_steps: int = 0, warmup_factor: float = 1.0) -> Schedule:
    """The schedule of the CLI's ``--lr_schedule`` dict
    (``type=multistep,milestones="15000 25000",decay_rate=0.1``) with the
    warmup around it; with no dict the lr is constant at ``start_lr`` (and
    no warmup applies, as in the JAX CLI)."""
    if not scheduler_arg:
        lr = float(np.float32(start_lr))
        return lambda step: lr
    if scheduler_arg["type"] != "multistep":
        raise ValueError(f"Error, scheduler type {scheduler_arg['type']} not supported.")
    milestones = [int(x) for x in str(scheduler_arg["milestones"]).split()]
    base = multistep_schedule(start_lr, milestones, float(scheduler_arg["decay_rate"]))
    return warmup_wrap(base, start_lr, warmup_steps, warmup_factor)
