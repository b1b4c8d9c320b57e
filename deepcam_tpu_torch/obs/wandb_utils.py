"""Optional Weights & Biases logging (counterpart of
``deepcam_tpu/obs/wandb_utils.py``).

The reference's ``have_wandb`` blocks: credentials from ``.wandbirc`` in
``--wandb_certdir``, a rank-0 run resumed by run tag, the
hyperparameters mirrored into the run's config, scalar logs of the train
and eval loss and accuracy and the learning rate, and image logs of the
visualizations.  Every call is a no-op when wandb is not installed or not
enabled, or off rank 0.
"""

from __future__ import annotations

import os
import subprocess
from typing import Any, Mapping, Optional

import torch

try:
    import wandb as _wandb

    HAVE_WANDB = True
except ImportError:
    _wandb = None
    HAVE_WANDB = False


class WandbLogger:
    """Rank-0 wandb run; inert when disabled or unavailable."""

    def __init__(self, enable: bool, rank: int, certdir: str, run_tag: str,
                 resume_logging: bool = False, project: str = "deepcam",
                 config: Optional[Mapping[str, Any]] = None):
        self.active = bool(enable and HAVE_WANDB and rank == 0)
        if not self.active:
            return
        certfile = os.path.join(certdir, ".wandbirc")
        try:
            with open(certfile) as f:
                wblogin, wbtoken = f.readlines()[0].replace("\n", "").split()[:2]
        except (OSError, IndexError, ValueError):
            print(f"Error, cannot open WandB certificate {certfile}.")
            self.active = False
            return
        subprocess.call(["wandb", "login", wbtoken])
        _wandb.init(entity=wblogin, project=project, name=run_tag, id=run_tag,
                    resume=run_tag if resume_logging else False)
        for k, v in (config or {}).items():
            setattr(_wandb.config, k, v)

    def log(self, metrics: Mapping[str, Any], step: int) -> None:
        if self.active:
            _wandb.log(dict(metrics), step=step)

    def log_image(self, key: str, path: str, caption: str, step: int) -> None:
        if self.active:
            _wandb.log({key: [_wandb.Image(path, caption=caption)]}, step=step)

    def watch(self, model: torch.nn.Module, step: int) -> None:
        """One histogram per parameter and, where it has one, per gradient
        (``p.grad`` as the last step left it), under the JAX shim's keys
        ``parameters/<path>`` and ``gradients/<path>`` with the JAX
        parameter tree's path (``tools/weights.py``): the analogue of the
        reference's ``wandb.watch(net)``, at the CLI's cadence."""
        if not self.active:
            return
        from ..tools.weights import assignments

        tensors = dict(model.named_parameters())
        payload = {}
        for prefix, read in (("parameters", lambda p: p), ("gradients", lambda p: p.grad)):
            for key, coll, path, _ in assignments(model):
                t = read(tensors[key]) if coll == "params" else None
                if t is not None:
                    payload[f"{prefix}/{'/'.join(path)}"] = _wandb.Histogram(
                        t.detach().float().cpu().numpy().ravel())
        if payload:
            _wandb.log(payload, step=step)
