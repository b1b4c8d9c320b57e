"""Collectives over the process group (counterpart of
``deepcam_tpu/parallel/collectives.py``).

The reference's explicit collective surface: ``dist.barrier`` (timed log
keys), ``dist.broadcast`` (step and epoch), ``dist.all_reduce(SUM)`` (the
eval accumulators), plus DDP's gradient all-reduce, which lives in
``train/trainer.py``.  Each function here is an identity without a process
group, so one process runs the same code.  NCCL on the card, gloo on the
CPU (gloo also takes CUDA tensors, through the host).
"""

from __future__ import annotations

from typing import Any

import torch

from ..core.mesh import initialized_dist


def _nccl(dist) -> bool:
    return dist.get_backend() == "nccl"


def barrier() -> None:
    """Waits for every process (parity: dist.barrier / the mlperf barrier,
    mlperf_log_utils.py:107-114).  An NCCL barrier names this rank's card:
    left to itself, NCCL guesses device 0 and can hang."""
    dist = initialized_dist()
    if dist is None:
        return
    if _nccl(dist):
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def broadcast_from_host0(value: Any) -> Any:
    """Rank 0's ``value`` (any picklable object) on every rank (parity: the
    step/epoch broadcast, train_hdf5_ddp.py:263-272)."""
    dist = initialized_dist()
    if dist is None:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def allgather_object(value: Any) -> list:
    """Every rank's ``value`` (any picklable object), in rank order, on
    every rank; ``[value]`` without a group."""
    dist = initialized_dist()
    if dist is None:
        return [value]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def allreduce_sum_scalar(x: float) -> float:
    """A host scalar summed over all processes, in float64 (parity: the
    eval accumulators' all-reduce, train_hdf5_ddp.py:490-492)."""
    dist = initialized_dist()
    where = "cuda" if dist is not None and _nccl(dist) else "cpu"
    return allreduce_sum_(torch.tensor([float(x)], dtype=torch.float64, device=where)).item()


def allreduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over all processes, in place, on its device."""
    dist = initialized_dist()
    if dist is not None:
        dist.all_reduce(t)
    return t


def allreduce_mean_(t: torch.Tensor) -> torch.Tensor:
    """``t`` averaged over all processes, in place: the JAX step's
    ``pmean``."""
    dist = initialized_dist()
    if dist is not None:
        dist.all_reduce(t)
        t.div_(dist.get_world_size())
    return t
