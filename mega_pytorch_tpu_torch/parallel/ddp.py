"""Data parallelism over cards (counterpart of
``mega_pytorch_tpu/parallel/mesh.py``): one process a card, as ``torchrun``
starts them, the model wrapped in ``DistributedDataParallel``, whose
all-reduce of the gradients takes the place of the JAX package's sharded
sample axis.

An iteration's ``IMS_PER_BATCH`` samples are split as ``shard_batch`` splits
them over the mesh's ``data`` axis: rank r takes the contiguous share
``[r * k, (r + 1) * k)``, k = IMS_PER_BATCH / world, so an iteration sees
the same samples whatever the world size. A world that does not divide
IMS_PER_BATCH is refused (the JAX trainer falls back to a smaller mesh,
which has no ``torchrun`` counterpart).

    torchrun --nproc_per_node N -m mega_pytorch_tpu_torch.tools.train_net ...
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

TIMEOUT = datetime.timedelta(minutes=10)


def init_distributed(device, init_method: str = "env://", rank: int | None = None,
                     world_size: int | None = None) -> tuple[int, int, torch.device]:
    """Join the process group of this training → (rank, world size, this
    process's device). Without ``rank`` and ``world_size``, ``torchrun``'s
    ``RANK``, ``LOCAL_RANK`` and ``WORLD_SIZE`` say them, and a world of 1
    (a plain ``python`` run) starts no group. The backend follows the
    device asked for: NCCL on ``cuda:LOCAL_RANK``, gloo for ``cpu``."""
    device = torch.device(device)
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
        if world_size == 1:
            return 0, 1, device
        rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device.type == "cuda":
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device}")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=TIMEOUT,
                            device_id=device if backend == "nccl" else None)
    return rank, world_size, device


def destroy_distributed() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def samples_per_rank(ims_per_batch: int, world_size: int) -> int:
    """k = IMS_PER_BATCH / world; raises where the world does not divide it."""
    if ims_per_batch % world_size:
        raise ValueError(f"SOLVER.IMS_PER_BATCH {ims_per_batch} is not a multiple of the "
                         f"world size {world_size}")
    return ims_per_batch // world_size


def rank_share(batch: list, rank: int, world_size: int) -> list:
    """Rank ``rank``'s contiguous share of an iteration's batch."""
    k = samples_per_rank(len(batch), world_size)
    return batch[rank * k:(rank + 1) * k]


def rank_seed(seed: int, rank: int) -> int:
    """The seed of a rank's ``torch.Generator``: ``seed`` on rank 0 (a
    one-process run draws as before), distinct for every (seed, rank)."""
    return seed + (rank << 32)


def rank_rng(seed: int, rank: int) -> np.random.RandomState:
    """A rank's host draws (references, flips): ``RandomState(seed)`` on
    rank 0, seeded by the pair (seed, rank) on the others."""
    return np.random.RandomState(seed if rank == 0 else [seed, rank])


def wrap(model: torch.nn.Module, device) -> torch.nn.Module:
    """``model`` in ``DistributedDataParallel`` where a process group runs,
    else ``model``. Every trainable parameter takes a gradient in every
    method's ``forward_train`` (``find_unused_parameters`` False: a
    parameter left out is a fault to find, not to skip), and the buffers
    (FrozenBN statistics) are the same on every rank and never change, so
    they are not broadcast."""
    if not dist.is_initialized():
        return model
    device = torch.device(device)
    return DistributedDataParallel(
        model, device_ids=[device] if device.type == "cuda" else None,
        broadcast_buffers=False, find_unused_parameters=False)


def unwrap(model: torch.nn.Module) -> torch.nn.Module:
    """The module inside a ``DistributedDataParallel`` (its state dict's
    names carry no ``module.`` prefix), or ``model`` itself."""
    return model.module if isinstance(model, DistributedDataParallel) else model
