"""Communication between training processes (counterpart of
``mega_pytorch_tpu/utils/comm.py``) on ``torch.distributed``: the world
size and rank, a barrier, gathering any picklable object from every rank,
and the mean (or sum) of a dict of scalars over ranks. Without an
initialised process group each is the one-process case: world 1, rank 0,
nothing to wait for or gather."""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if _active() else 1


def get_rank() -> int:
    return dist.get_rank() if _active() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def synchronize() -> None:
    """Barrier across every process of the group."""
    if get_world_size() > 1:
        dist.barrier()


def all_gather(data: Any) -> list[Any]:
    """Every rank's ``data`` (any picklable object), in rank order."""
    world = get_world_size()
    if world == 1:
        return [data]
    out: list[Any] = [None] * world
    dist.all_gather_object(out, data)
    return out


def reduce_dict(input_dict: dict, average: bool = True) -> dict:
    """The mean (or, with ``average`` False, the sum) over ranks of a dict
    of scalars (floats or one-element tensors), as floats; the same dict on
    every rank. One ``all_reduce`` of the values stacked in key order, on
    the backend's device (the card under NCCL)."""
    world = get_world_size()
    if world == 1:
        return {k: float(v) for k, v in input_dict.items()}
    names = sorted(input_dict)
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    values = torch.stack([torch.as_tensor(input_dict[k], dtype=torch.float32,
                                          device=device).reshape(()) for k in names])
    dist.all_reduce(values)
    if average:
        values /= world
    reduced = dict(zip(names, values.tolist()))
    return {k: reduced[k] for k in input_dict}
