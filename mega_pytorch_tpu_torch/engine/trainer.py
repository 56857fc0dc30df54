"""Training loop (counterpart of ``mega_pytorch_tpu/engine/trainer.py``):
iteration-based, per-method input plumbing, the summed losses, an SGD step
and the warmup-multistep schedule, window-smoothed meters with an ETA,
periodic checkpoints with resume, and an optional validation hook.

A process runs its samples of an iteration one after the other, each
sample's losses divided by its sample count and their gradients summed.
Under ``DistributedDataParallel`` (one process a card, ``parallel/ddp.py``)
the all-reduce of the last sample's backward averages the sums over the
ranks, so the step takes the mean over all the iteration's samples: the
JAX package's mean over its sample axis, sharded over the ``data`` mesh.
"""

from __future__ import annotations

import contextlib
import datetime
import time
from typing import Iterator

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel

from ..parallel.ddp import unwrap
from ..utils import comm
from ..utils.logger import MetricLogger


def assemble_inputs(method: str, sample: dict):
    """One preprocessed sample → (model inputs, ground truth), numpy: the
    base detector's (frames, sizes); RDN's, FGFA's and DFF's (cur + refs,
    sizes); MEGA's {"local": (cur + local refs, sizes), "memory": ...,
    "global": ...}."""
    gt = sample["gt"]
    if method == "base":
        return (sample["cur"], sample["cur_size"]), gt
    if method in ("rdn", "fgfa", "dff"):
        return (np.concatenate([sample["cur"], sample["ref"]]),
                np.concatenate([sample["cur_size"], sample["ref_size"]])), gt
    if method == "mega":
        local = (np.concatenate([sample["cur"], sample["ref_l"]]),
                 np.concatenate([sample["cur_size"], sample["ref_l_size"]]))
        return {"local": local, "memory": (sample["ref_m"], sample["ref_m_size"]),
                "global": (sample["ref_g"], sample["ref_g_size"])}, gt
    raise ValueError(f"unknown method {method!r}")


def to_device(inputs, gt: dict, device):
    """numpy inputs and ground truth → tensors on ``device`` (labels int64)."""
    def move(x):
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(move(v) for v in x)
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    gt = move(gt)
    gt["labels"] = gt["labels"].long()
    return move(inputs), gt


def accumulate(model, method: str, samples: list[dict], device, generator=None,
               count: int | None = None) -> dict:
    """Per sample, the model's losses (called as the model, so that
    ``DistributedDataParallel`` sees the call) and the backward of their sum
    over ``count`` (default: the sample count), the gradients adding up.
    Under DDP every sample but the last runs under ``no_sync``, and the last
    one's backward averages the gradients over the ranks. Returns the
    losses summed over the samples and divided by ``count``, detached."""
    totals: dict = {}
    count = count or len(samples)
    for i, sample in enumerate(samples):
        inputs, gt = to_device(*assemble_inputs(method, sample), device)
        defer = isinstance(model, DistributedDataParallel) and i < len(samples) - 1
        with model.no_sync() if defer else contextlib.nullcontext():
            losses = model(inputs, gt, generator)
            (sum(losses.values()) / count).backward()
        for name, v in losses.items():
            totals[name] = totals.get(name, 0.0) + v.detach() / count
    return totals


def train_step(model, optimizer, scheduler, method: str, samples: list[dict], device,
               generator=None) -> dict:
    """One SGD step over this process's ``samples``: ``accumulate``, then
    ``optimizer.step()`` and ``scheduler.step()``. Returns this process's
    losses (means over its samples, detached)."""
    optimizer.zero_grad(set_to_none=True)
    totals = accumulate(model, method, samples, device, generator)
    optimizer.step()
    scheduler.step()
    return totals


def do_train(cfg, model, batches: Iterator[list[dict]], optimizer, scheduler,
             checkpointer, logger, start_iter: int = 0,
             generator: torch.Generator | None = None, log_period: int = 20,
             validation_hook=None) -> dict:
    """Run iterations ``start_iter + 1 .. SOLVER.MAX_ITER`` over ``batches``
    (lists of this process's preprocessed samples). ``model`` may be
    wrapped in ``DistributedDataParallel``. Saves ``model_{iteration:07d}``
    every ``SOLVER.CHECKPOINT_PERIOD`` iterations and ``model_final`` at the
    end, from the main process only and with the unwrapped module's state,
    every process waiting for the save; calls
    ``validation_hook(module, iteration)`` every ``SOLVER.TEST_PERIOD``
    (> 0). Returns a record: the last iteration, and per iteration its
    losses (means over every process's samples) and its seconds (ending
    with the losses read on the host, which waits for the card)."""
    method = cfg.MODEL.VID.METHOD if cfg.MODEL.VID.ENABLE else "base"
    max_iter, ckpt_period = cfg.SOLVER.MAX_ITER, cfg.SOLVER.CHECKPOINT_PERIOD
    module = unwrap(model)
    device = next(module.parameters()).device
    meters = MetricLogger()
    record = dict(iteration=start_iter, losses=[], iter_s=[])
    start_time = last = time.perf_counter()
    iteration = start_iter

    def save(name):
        if comm.is_main_process():
            checkpointer.save(name, module, optimizer, scheduler, iteration)
        comm.synchronize()

    model.train()
    for samples in batches:
        if iteration >= max_iter:
            break
        iteration += 1
        data_time = time.perf_counter() - last
        losses = comm.reduce_dict(
            train_step(model, optimizer, scheduler, method, samples, device, generator))
        batch_time = time.perf_counter() - last
        last = time.perf_counter()
        meters.update(loss=sum(losses.values()), **losses)
        meters.update(time=batch_time, data=data_time)
        record["losses"].append(losses)
        record["iter_s"].append(batch_time)
        record["iteration"] = iteration

        if iteration % log_period == 0 or iteration == max_iter:
            eta = meters.meters["time"].global_avg * (max_iter - iteration)
            mem = (torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
            logger.info(f"eta: {datetime.timedelta(seconds=int(eta))}  iter: {iteration}  "
                        f"{meters}  lr: {optimizer.param_groups[0]['lr']:.6f}  "
                        f"max mem: {mem / 2**20:.0f}MB")
        if iteration % ckpt_period == 0:
            save(f"model_{iteration:07d}")
        if (validation_hook is not None and cfg.SOLVER.TEST_PERIOD > 0
                and iteration % cfg.SOLVER.TEST_PERIOD == 0):
            logger.info(f"running validation at iter {iteration}")
            validation_hook(module, iteration)
            model.train()

    save("model_final")
    total = time.perf_counter() - start_time
    done = max(iteration - start_iter, 1)
    logger.info(f"Total training time: {datetime.timedelta(seconds=int(total))} "
                f"({total / done:.4f} s / it)")
    return record
