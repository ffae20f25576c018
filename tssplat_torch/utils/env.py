"""Rank discovery and the process group (port of
``tssplat_tpu/utils/env.py``; reference utils/config.py:12-24).

A rank is one process on one device: ranks take the place of the JAX
package's devices. ``torchrun`` (or ``tools/run_ranks.py``) sets RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT; SLURM and Open MPI
set their own keys, read as the JAX package reads them.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device

_RANK_KEYS = ("RANK", "LOCAL_RANK", "SLURM_PROCID", "JSM_NAMESPACE_RANK")
_WORLD_KEYS = ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE")
_LOCAL_KEYS = ("LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK")


def _env_int(keys, default: int) -> int:
    for k in keys:
        v = os.environ.get(k)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                pass
    return default


def get_rank() -> int:
    """This process's rank: the process group's once it is initialized,
    else the first of the environment's rank keys, else 0."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return _env_int(_RANK_KEYS, 0)


def get_world_size() -> int:
    """The number of ranks: the process group's once it is initialized,
    else the first of the environment's world keys, else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return _env_int(_WORLD_KEYS, 1)


def rank_device(device: DeviceLike = None) -> torch.device:
    """The device of this rank: ``device`` when given, else
    ``cuda:{LOCAL_RANK}``, wrapped around the cards there are (ranks beyond
    the card count share them)."""
    if device is not None:
        return resolve_device(device)
    resolve_device("cuda")                    # raises without a card
    return torch.device("cuda", _env_int(_LOCAL_KEYS, 0)
                        % torch.cuda.device_count())


def init_distributed(backend: Optional[str] = None,
                     timeout: datetime.timedelta = datetime.timedelta(
                         minutes=10),
                     device: DeviceLike = None,
                     coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None
                     ) -> Optional[torch.device]:
    """Join the process group when the environment (or ``num_processes``)
    says there is more than one rank; a no-op (returning None) at world
    size 1 or when the group exists. Returns this rank's device
    (``rank_device(device)``).

    ``backend`` defaults to ``nccl`` when every rank has a card of its own
    and ``gloo`` on the CPU or when ranks share a card (NCCL refuses two
    ranks on one device; gloo's all_reduce and broadcast take CUDA
    tensors). The address is ``coordinator_address`` ("host:port", JAX's
    argument) when given, else MASTER_ADDR:MASTER_PORT (``env://``);
    ``num_processes`` and ``process_id`` (JAX's names) the world size and
    this rank, else the environment's."""
    world = get_world_size() if num_processes is None else int(num_processes)
    if world <= 1 or dist.is_initialized():
        return None
    dev = rank_device(device)
    if backend is None:
        local_world = _env_int(("LOCAL_WORLD_SIZE",), world)
        backend = "nccl" if dev.type == "cuda" and \
            local_world <= torch.cuda.device_count() else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend=backend, timeout=timeout, world_size=world,
        rank=get_rank() if process_id is None else int(process_id),
        init_method=f"tcp://{coordinator_address}" if coordinator_address
        else "env://")
    return dev
