"""The process group of column parallelism on ``torch.distributed``.

Counterpart of ``mpp_tpu/parallel/distributed.py``.  The reference
distributes grid columns over MPI ranks (PETSC_COMM_WORLD from
MPI_COMM_WORLD, standalone_mpp.F90:75-76); the JAX package shards the
column axis of one global array over a device ``Mesh``.  PyTorch's idiom
is SPMD processes: one rank a device, each holding its own block of
columns (the mpp_bounds begc:endc analog, ``process_local_slice``), with
the collectives of ``torch.distributed`` between them: NCCL for ranks on
CUDA devices, gloo for ranks on the CPU.

A :class:`ColumnGroup` (the group, this rank, the world size and this
rank's device) takes the place of the ``Mesh`` wherever the JAX package
takes one.  Single-process runs skip initialization
(``initialize_distributed`` returns False) and pass no group.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

#: seconds a collective may wait for the other ranks before it raises
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class ColumnGroup:
    """The ranks that share the column axis: ``group`` (None: the default
    world group), this process's ``rank`` in it, its ``world_size`` and
    this rank's ``device`` (its tensors and collectives live there)."""
    group: Optional[object]
    rank: int
    world_size: int
    device: torch.device


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join (or skip) the process group.

    Returns True if ``torch.distributed.init_process_group`` ran.  The
    arguments default to the standard environment (MASTER_ADDR /
    MASTER_PORT through ``env://``, WORLD_SIZE, RANK), as ``torchrun``
    sets it; with neither an ``init_method`` nor MASTER_ADDR this is a
    single-process run and the call does nothing.  ``timeout_s`` bounds
    every collective's wait.  The backend defaults to NCCL where this
    process has a CUDA device, gloo on the CPU; one that fails to start
    raises."""
    if init_method is None:
        if "MASTER_ADDR" not in os.environ:
            return False
        init_method = "env://"
    world_size = int(world_size if world_size is not None
                     else os.environ.get("WORLD_SIZE", "1"))
    rank = int(rank if rank is not None else os.environ.get("RANK", "0"))
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def rank_device(group=None) -> torch.device:
    """This rank's device under the group's backend: the CUDA device of
    LOCAL_RANK (default: the rank modulo the visible cards) for NCCL,
    the CPU for gloo."""
    if dist.get_backend(group) == "nccl":
        local = int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        return torch.device("cuda", local)
    return torch.device("cpu")


def global_column_mesh(group=None) -> ColumnGroup:
    """The column group over ALL ranks of the initialized process group
    (or over ``group``), with this rank's device."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "initialize_distributed first")
    return ColumnGroup(group=group, rank=dist.get_rank(group),
                       world_size=dist.get_world_size(group),
                       device=rank_device(group))


def process_local_slice(n_global: int, axis_size: int, index: int):
    """[start, stop) of the globally sharded column axis owned by shard
    ``index`` (the mpp_bounds begc/endc analog, mpp_bounds.F90:9-27)."""
    per = n_global // axis_size
    rem = n_global % axis_size
    start = index * per + min(index, rem)
    stop = start + per + (1 if index < rem else 0)
    return start, stop
