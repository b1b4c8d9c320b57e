"""Process-group wireup (counterpart of ``deepcam_tpu/core/mesh.py``).

There is no device mesh here.  The JAX package drives all of a host's
chips from one process over a ``('data', 'spatial')`` mesh; the port runs
one process per card, as the reference's DDP does
(``train_hdf5_ddp.py``), and data parallelism is a ``torch.distributed``
process group: NCCL between cards, gloo on the CPU.  This module holds the
wireup and the rank queries; the collectives are in
``parallel/collectives.py``.
"""

from __future__ import annotations

import os

import torch

from .. import resolve_device

# the variables torchrun sets for each process it starts
TORCHRUN_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def initialized_dist():
    """``torch.distributed`` when a process group is initialized, else
    None."""
    dist = torch.distributed
    return dist if dist.is_available() and dist.is_initialized() else None


def _launched_by_torchrun() -> bool:
    """True when torchrun's variables are set, ``WORLD_SIZE=1`` included;
    raises when only some of them are (a launcher that set half of them
    would otherwise start N single-process runs)."""
    present = [v for v in TORCHRUN_VARS if v in os.environ]
    if present and len(present) < len(TORCHRUN_VARS):
        missing = sorted(set(TORCHRUN_VARS) - set(present))
        raise RuntimeError(f"torchrun's variables are incomplete: {missing} not set")
    return bool(present)


def init_distributed(wireup_method: str = "auto", device="cuda") -> bool:
    """Joins this process to the process group.  Returns True if it created
    the group (the caller then destroys it), False otherwise.

    * ``dummy`` never initializes (one process).
    * A group that is already initialized is used as it is: a launcher or a
      test may build its own (gloo over a file store, say).
    * ``auto`` initializes whenever torchrun's variables are set
      (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
      ``MASTER_PORT``; ``WORLD_SIZE=1`` included) through ``env://``, with
      NCCL for a CUDA ``device`` and gloo for the CPU, and initializes
      nothing without them.  If that initialization fails it raises: a
      half-wired job would train N independent models."""
    if wireup_method == "dummy":
        return False
    if wireup_method != "auto":
        raise ValueError(f"wireup method {wireup_method!r}: the port takes auto or dummy")
    if initialized_dist() is not None or not _launched_by_torchrun():
        return False
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    try:
        torch.distributed.init_process_group(backend, init_method="env://")
    except Exception as e:
        raise RuntimeError(
            f"init_distributed(auto): torchrun's variables are set (WORLD_SIZE="
            f"{os.environ['WORLD_SIZE']}, RANK={os.environ['RANK']}, MASTER_ADDR="
            f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}) but the "
            f"{backend} process group did not initialize: {e}") from e
    return True


def destroy_distributed() -> None:
    """Leaves the process group, if one is initialized."""
    if initialized_dist() is not None:
        torch.distributed.destroy_process_group()


def get_rank() -> int:
    """This process's rank in the group; 0 without one.  Parity:
    ``comm.get_rank`` (comm.py:26-34)."""
    dist = initialized_dist()
    return dist.get_rank() if dist is not None else 0


def get_size() -> int:
    """The group's size; 1 without one.  Parity: ``comm.get_size``
    (comm.py:53-61)."""
    dist = initialized_dist()
    return dist.get_world_size() if dist is not None else 1


def get_local_rank() -> int:
    """The rank on this host: torchrun's ``LOCAL_RANK``, else 0.  Parity:
    ``comm.get_local_rank`` (comm.py:37-50)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def device_for(device="cuda") -> torch.device:
    """The device this process runs on.  ``"cuda"`` becomes
    ``cuda:LOCAL_RANK``; an explicit index (``"cuda:0"``) is kept as given.
    Either becomes the current CUDA device, which NCCL and the kernels'
    launches read.  Never falls back to the CPU: raises without a card, as
    ``resolve_device`` does."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if dev.index is None:
        dev = torch.device("cuda", get_local_rank())
    torch.cuda.set_device(dev)
    return dev
