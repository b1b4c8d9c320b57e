"""PyTorch and CUDA port of deepcam_tpu for NVIDIA Hopper (H100).

The JAX package ``deepcam_tpu`` stays the reference; this package imports
nothing of it and nothing of JAX.  Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a torch.device; raises if it names CUDA and no card is
    present (an entry point never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU")
    return dev
