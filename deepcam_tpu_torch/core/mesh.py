"""Process-group wireup (counterpart of ``deepcam_tpu/core/mesh.py``).

There is no device mesh here.  The JAX package drives all of a host's
chips from one process over a ``('data', 'spatial')`` mesh; the port runs
one process per card, as the reference's DDP does
(``train_hdf5_ddp.py``), and data parallelism is a ``torch.distributed``
process group: NCCL between cards, gloo on the CPU.  This module holds the
wireup and the rank queries; the collectives are in
``parallel/collectives.py``.

Spatial sharding (``--spatial S``, ``parallel/spatial.py``) splits the
world into W/S groups of S consecutive ranks, as the JAX package reshapes
its devices into a ``(W/S, S)`` ``('data', 'spatial')`` mesh
(``make_mesh``): the ranks of a group share each sample, each holding H/S
of its rows, and the group plays one data-parallel rank.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

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
    """Leaves the process group, if one is initialized, and forgets the
    spatial groups."""
    forget_spatial_groups()
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


# ---------------------------------------------------------------------------
# spatial groups
# ---------------------------------------------------------------------------

def spatial_layout(world: int, spatial: int, local_world: Optional[int] = None):
    """The ranks of each spatial group and each rank's data index, for
    ``world`` ranks in groups of ``spatial`` consecutive ones: the rows of
    ``reshape(world // spatial, spatial)`` over the ranks, as the JAX
    package's ``make_mesh(spatial=)`` lays out its devices.  Raises when
    ``spatial`` does not divide the world, or the ranks on one host
    (``local_world``): a group must not straddle hosts, as the JAX CLI
    keeps each group on one host's chips."""
    if spatial < 1:
        raise ValueError(f"--spatial must be >= 1, got {spatial}")
    if world % spatial:
        raise ValueError(f"--spatial {spatial} does not divide the {world} ranks")
    if local_world is not None and local_world % spatial:
        raise ValueError(
            f"--spatial {spatial} must divide the ranks on each host ({local_world}), "
            "so that each spatial group stays on one host")
    groups = [list(range(g * spatial, (g + 1) * spatial)) for g in range(world // spatial)]
    return groups, [r // spatial for r in range(world)]


@dataclass
class SpatialGroups:
    """This rank's place in the spatial layout: its group (``group`` is
    None at ``size`` 1, where nothing is exchanged), its index in the
    group, its data index and the number of data groups."""

    group: Optional[object]
    index: int
    size: int
    data_index: int
    data_size: int


_SPATIAL: Optional[SpatialGroups] = None


def init_spatial_groups(spatial: int) -> SpatialGroups:
    """Splits the process group into spatial groups of ``spatial``
    consecutive ranks (``spatial_layout``), this rank's kept.  Every rank
    calls ``new_group`` for every group, in the same order, as
    ``torch.distributed`` requires.  ``spatial`` 1 makes groups of one
    rank and exchanges nothing; without a process group the world is this
    one process."""
    global _SPATIAL
    world, rank = get_size(), get_rank()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    groups, data_index = spatial_layout(world, spatial, local)
    mine = None
    if spatial > 1:
        for ranks in groups:
            g = torch.distributed.new_group(ranks)
            if rank in ranks:
                mine = g
    _SPATIAL = SpatialGroups(mine, rank % spatial, spatial, data_index[rank], world // spatial)
    return _SPATIAL


def forget_spatial_groups() -> None:
    """Drops what ``init_spatial_groups`` kept (not the process groups it
    made, which live as long as the process group)."""
    global _SPATIAL
    _SPATIAL = None


def spatial_groups() -> SpatialGroups:
    """This rank's spatial groups, as ``init_spatial_groups`` made them;
    without that call, groups of one rank: every rank its own data
    group."""
    if _SPATIAL is not None:
        return _SPATIAL
    return SpatialGroups(None, 0, 1, get_rank(), get_size())


def spatial_index() -> int:
    """This rank's index in its spatial group (its share of the rows)."""
    return spatial_groups().index


def spatial_size() -> int:
    """The ranks of a spatial group (S)."""
    return spatial_groups().size


def data_index() -> int:
    """This rank's data group: the shard of the datasets it reads."""
    return spatial_groups().data_index


def data_size() -> int:
    """The number of data groups (W/S): the data-parallel width."""
    return spatial_groups().data_size
