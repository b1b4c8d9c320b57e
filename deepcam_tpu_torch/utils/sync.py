"""Host synchronization (counterpart of ``deepcam_tpu/utils/sync.py``)."""

from __future__ import annotations

import torch


def host_sync(device="cuda") -> None:
    """Blocks until all work queued on ``device`` has finished; nothing to
    wait for on the CPU, where PyTorch runs each op before it returns."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
