"""The DDP training step against the plain step on the same samples.

    torchrun --nproc_per_node N -m mega_pytorch_tpu_torch.tools.ddp_check

Every rank builds ``rdn_R_101``'s training model (seed 0) on its card, with
its FrozenBN statistics calibrated on seeded 720p frames (``train_bench``),
and the same seeded synthetic samples, ``SOLVER.IMS_PER_BATCH`` (4) an
iteration, for 2 iterations. Rank 0 first runs the plain iterations over
all the samples from the same state, each rank's share of a batch with that
rank's generator, as the ranks draw: the shares' gradients added in rank
order, then in the reverse order, then once more in rank order with a
planted fault, the last rank's last sample left out. The second run shows
the spread that DDP may add: the all-reduce adds the ranks' gradients in
its own order, a last-bit change that the proposals' sort and NMS can turn
into more by the next iteration, and on the card cuDNN's weight gradients
and atomic adds are not bit-reproducible either. The third shows what a
fault that keeps the ranks equal reads. Then every rank runs its share
(``parallel/ddp.py:rank_share``) through ``train_step`` on the DDP-wrapped
model twice from the same state, the first k - 1 of its k samples under
``no_sync`` (the second run is the warm one, to time). Each tensor's update
on rank 0 is held against the first plain run's (``_rel``: relative to that
tensor's largest update, after a few f32 steps of the parameter); both DDP
runs must stay within max(FLOOR, FACTOR x the spread), the fault must read
above that bound, and every rank's weights must equal rank 0's. Rank 0
prints the result as one JSON line; the exit code is 1 where a check
failed.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

# DDP's updates against the plain step's: the larger of FLOOR and FACTOR
# times the spread between two plain runs (both read by ``_rel``); the
# planted fault must read above it (readings in PERF.md, section 6)
FLOOR, FACTOR = 1e-5, 8.0
FRAME = (720, 1280)  # VID's 720p frames, resized by the preset


def _updates(model, initial):
    return {n: (v.detach() - initial[n]).clone() for n, v in model.state_dict().items()
            if v.is_floating_point()}


def _rel(x, y, initial):
    """The largest over tensors of max|x - y| / max|y|: updates x and y of
    the parameters ``initial``, read as differences of rounded parameters,
    so a few of the parameter's own f32 steps (4 eps max|p|) are allowed
    first; the denominator is at least a thousandth of the largest update
    of any tensor, so that an update that is rounding noise (a key bias's
    gradient is zero in exact arithmetic: it shifts a query's logits alike)
    is read against the model's."""
    floor = 1e-3 * max(v.abs().max().item() for v in y.values())
    eps = torch.finfo(torch.float32).eps
    return max(max((x[n] - y[n]).abs().max().item()
                   - 4 * eps * initial[n].abs().max().item(), 0.0)
               / max(y[n].abs().max().item(), floor) for n in y)


def check(cfg, device, iters: int = 2, seed: int = 0, frame_hw=FRAME,
          on_run=None) -> dict:
    """The comparison described above, in a process group already joined
    (one rank will do). ``on_run()``, where given, is called before each
    run, so that the last (warm) DDP run's launches can be counted alone.
    Returns rank 0's record (other ranks: how far their weights are from
    rank 0's)."""
    from ..engine.trainer import accumulate, train_step
    from ..models.detectors import build_training_model
    from ..parallel import ddp
    from ..solver import make_lr_scheduler, make_optimizer
    from ..utils import comm
    from .train_bench import calibrate_frozen_bn, calibration_frames, synthetic_samples

    rank, world = comm.get_rank(), comm.get_world_size()
    method = cfg.MODEL.VID.METHOD if cfg.MODEL.VID.ENABLE else "base"
    k = cfg.SOLVER.IMS_PER_BATCH
    rs = np.random.RandomState(seed)
    model = build_training_model(cfg, device, torch.Generator(device).manual_seed(seed))
    calibrate_frozen_bn(model, calibration_frames(cfg, frame_hw, rs, device))
    initial = {n: v.detach().clone() for n, v in model.state_dict().items()}
    samples = synthetic_samples(cfg, frame_hw, rs, iters * k)

    def plain_step(optimizer, scheduler, batch, gens, order, fault):
        """The whole batch in this process, each rank's share with that
        rank's generator, every sample's losses over the batch size; the
        ranks' shares in ``order`` (1, or -1 for the reverse); with
        ``fault`` the last rank's last sample left out."""
        optimizer.zero_grad(set_to_none=True)
        totals: dict = {}
        for r, gen in list(enumerate(gens))[::order]:
            share = ddp.rank_share(batch, r, world)
            if fault and r == world - 1:
                share = share[:-1]
            losses = accumulate(model, method, share, device, gen, count=k)
            totals = {n: totals.get(n, 0.0) + v for n, v in losses.items()}
        optimizer.step()
        scheduler.step()
        return totals

    def run(ddp_model=None, order=1, fault=False):
        """``iters`` iterations from the initial state: the plain step, or
        with ``ddp_model`` this rank's share through ``train_step``."""
        model.load_state_dict(initial)
        optimizer = make_optimizer(cfg, model)
        scheduler = make_lr_scheduler(cfg, optimizer)
        gens = [torch.Generator(device).manual_seed(ddp.rank_seed(seed, r))
                for r in range(world)]
        if on_run is not None:
            on_run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for i in range(iters):
            batch = samples[i * k:(i + 1) * k]
            if ddp_model is None:
                losses = plain_step(optimizer, scheduler, batch, gens, order, fault)
            else:
                losses = train_step(ddp_model, optimizer, scheduler, method,
                                    ddp.rank_share(batch, rank, world), device, gens[rank])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3 / iters
        return _updates(model, initial), losses, ms

    record: dict = dict(world=world, preset_method=method, iters=iters,
                        samples_per_iteration=k)
    if rank == 0:
        plain, losses_p, ms_a = run()
        other, _, ms_b = run(order=-1)
        spread = _rel(other, plain, initial)
        other, _, _ = run(fault=True)
        fault = _rel(other, plain, initial)
        del other
        record.update(plain_losses={n: float(v) for n, v in losses_p.items()},
                      plain_ms=[ms_a, ms_b], spread=spread, fault=fault)
    comm.synchronize()
    wrapped = ddp.wrap(model, device)
    if not isinstance(wrapped, torch.nn.parallel.DistributedDataParallel):
        raise RuntimeError("ddp_check: no process group, so no DistributedDataParallel")
    errs, ddp_ms = [], []
    for _ in range(2):
        got, losses_d, ms_d = run(wrapped)
        if rank == 0:
            errs.append(_rel(got, plain, initial))
        ddp_ms.append(ms_d)
        del got
    losses_d = comm.reduce_dict(losses_d)  # the mean over every rank's samples
    # every rank's weights against rank 0's
    worst = 0.0
    for v in model.state_dict().values():
        ref = v.detach().clone()
        torch.distributed.broadcast(ref, 0)
        worst = max(worst, (v.detach() - ref).abs().max().item() if v.is_floating_point()
                    else float(not torch.equal(v, ref)))
    ranks_apart = comm.all_gather(worst)
    if rank != 0:
        return dict(rank=rank, apart=worst)
    err = max(errs)
    bound = max(FLOOR, FACTOR * record["spread"])
    record.update(backend=torch.distributed.get_backend(), ddp_losses=losses_d,
                  ddp_ms=ddp_ms, err=err, bound=bound, ranks_apart=max(ranks_apart),
                  ok=bool(err <= bound < record["fault"] and max(ranks_apart) == 0.0))
    return record


def main() -> int:
    from ..config import get_preset
    from ..parallel import ddp

    if not torch.cuda.is_available():
        raise SystemExit("ddp_check: no CUDA card here")
    rank, world, device = ddp.init_distributed("cuda")
    if world == 1:
        raise SystemExit("ddp_check: run it under torchrun (a world of one joins no group)")
    cfg = get_preset("rdn_R_101")
    try:
        ddp.samples_per_rank(cfg.SOLVER.IMS_PER_BATCH, world)
        record = check(cfg, device)
    finally:
        ddp.destroy_distributed()
    if rank == 0:
        import subprocess

        record["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip().splitlines()
        print(json.dumps(record))
        return 0 if record["ok"] else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
