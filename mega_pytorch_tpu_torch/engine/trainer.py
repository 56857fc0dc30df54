"""Training loop (counterpart of ``mega_pytorch_tpu/engine/trainer.py``):
iteration-based, per-method input plumbing, the summed losses, an SGD step
and the warmup-multistep schedule, window-smoothed meters with an ETA,
periodic checkpoints with resume, and an optional validation hook.

One card: the samples of an iteration run one after the other, each
sample's losses divided by the sample count and their gradients summed
(the JAX package's mean over its vmapped samples). Multi-card data
parallelism is not ported.
"""

from __future__ import annotations

import datetime
import time
from typing import Iterator

import numpy as np
import torch

from ..utils.logger import MetricLogger


def assemble_inputs(method: str, sample: dict):
    """One preprocessed sample → (model inputs, ground truth), numpy: the
    base detector's (frames, sizes); MEGA's {"local": (cur + local refs,
    sizes), "memory": ..., "global": ...}."""
    gt = sample["gt"]
    if method == "base":
        return (sample["cur"], sample["cur_size"]), gt
    if method == "mega":
        local = (np.concatenate([sample["cur"], sample["ref_l"]]),
                 np.concatenate([sample["cur_size"], sample["ref_l_size"]]))
        return {"local": local, "memory": (sample["ref_m"], sample["ref_m_size"]),
                "global": (sample["ref_g"], sample["ref_g_size"])}, gt
    raise NotImplementedError(f"training of {method!r} is not ported")


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


def train_losses(model, method: str, inputs, gt: dict, generator=None) -> dict:
    """The model's four losses on one sample's device inputs."""
    if method == "base":
        return model.forward_train(*inputs, gt, generator)
    return model.forward_train(inputs, gt, generator)


def train_step(model, optimizer, scheduler, method: str, samples: list[dict], device,
               generator=None) -> dict:
    """One SGD step over ``samples``: forward, the sum of the losses,
    backward, ``optimizer.step()``, ``scheduler.step()``. Returns the losses
    (means over the samples, detached)."""
    optimizer.zero_grad(set_to_none=True)
    totals: dict = {}
    for sample in samples:
        losses = train_losses(model, method, *to_device(*assemble_inputs(method, sample),
                                                        device), generator)
        (sum(losses.values()) / len(samples)).backward()
        for k, v in losses.items():
            totals[k] = totals.get(k, 0.0) + v.detach() / len(samples)
    optimizer.step()
    scheduler.step()
    return totals


def do_train(cfg, model, batches: Iterator[list[dict]], optimizer, scheduler,
             checkpointer, logger, start_iter: int = 0,
             generator: torch.Generator | None = None, log_period: int = 20,
             validation_hook=None) -> dict:
    """Run iterations ``start_iter + 1 .. SOLVER.MAX_ITER`` over ``batches``
    (lists of preprocessed samples). Saves ``model_{iteration:07d}`` every
    ``SOLVER.CHECKPOINT_PERIOD`` iterations and ``model_final`` at the end;
    calls ``validation_hook(model, iteration)`` every ``SOLVER.TEST_PERIOD``
    (> 0). Returns a record: the last iteration, and per iteration its
    losses and its seconds (ending with the losses read on the host, which
    waits for the card)."""
    method = cfg.MODEL.VID.METHOD if cfg.MODEL.VID.ENABLE else "base"
    max_iter, ckpt_period = cfg.SOLVER.MAX_ITER, cfg.SOLVER.CHECKPOINT_PERIOD
    device = next(model.parameters()).device
    meters = MetricLogger()
    record = dict(iteration=start_iter, losses=[], iter_s=[])
    start_time = last = time.perf_counter()
    iteration = start_iter
    model.train()
    for samples in batches:
        if iteration >= max_iter:
            break
        iteration += 1
        data_time = time.perf_counter() - last
        losses = train_step(model, optimizer, scheduler, method, samples, device, generator)
        losses = {k: float(v) for k, v in losses.items()}
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
            checkpointer.save(f"model_{iteration:07d}", model, optimizer, scheduler,
                              iteration)
        if (validation_hook is not None and cfg.SOLVER.TEST_PERIOD > 0
                and iteration % cfg.SOLVER.TEST_PERIOD == 0):
            logger.info(f"running validation at iter {iteration}")
            validation_hook(model, iteration)
            model.train()

    checkpointer.save("model_final", model, optimizer, scheduler, iteration)
    total = time.perf_counter() - start_time
    done = max(iteration - start_iter, 1)
    logger.info(f"Total training time: {datetime.timedelta(seconds=int(total))} "
                f"({total / done:.4f} s / it)")
    return record
