"""The processes of ``tests/test_torch_train_ddp.py``: each rank of a CPU
world on gloo runs one task of the port's data parallelism and saves what it
saw. No JAX here: the workers are the port's own processes, as under
``torchrun``.

``spawn_world`` starts ``world`` processes with ``torch.multiprocessing``
(spawn), their process group joined through a ``file://`` store in the
test's own directory (no port, so parallel test workers never meet), and
kills them at a deadline. Each task reads its inputs from a pickle and
writes each rank's result to ``rank{r}.pkl``.
"""

from __future__ import annotations

import os
import pickle
import time

import torch
import torch.multiprocessing as mp

from mega_pytorch_tpu_torch.config import get_preset
from mega_pytorch_tpu_torch.engine.trainer import train_step
from mega_pytorch_tpu_torch.models.detectors.rcnn import GeneralizedRCNN
from mega_pytorch_tpu_torch.models.detectors.rdn import GeneralizedRCNNRDN
from mega_pytorch_tpu_torch.parallel import ddp
from mega_pytorch_tpu_torch.solver import make_lr_scheduler, make_optimizer
from mega_pytorch_tpu_torch.utils import comm

CPU = torch.device("cpu")


def build_model(payload):
    """The payload's detector with its weights, prepared for training as
    ``seeded_training`` prepares it."""
    cls = GeneralizedRCNN if payload["method"] == "base" else GeneralizedRCNNRDN
    configs = payload["configs"][:1] if payload["method"] == "base" else payload["configs"]
    model = cls(*configs)
    model.load_state_dict(payload["state"], strict=True)
    model.backbone.freeze_(model.c.freeze_at)
    return model.train()


def solver_cfg(opts):
    cfg = get_preset("base_R_50")
    cfg.merge_from_list(opts)
    return cfg


def one_step(payload, samples, rank: int = 0, model_wrapper=lambda m: m):
    """One ``train_step`` over ``samples`` from the payload's weights →
    (the model's state after it, the losses)."""
    model = build_model(payload)
    cfg = solver_cfg(payload["opts"])
    optimizer = make_optimizer(cfg, model)
    scheduler = make_lr_scheduler(cfg, optimizer)
    losses = train_step(model_wrapper(model), optimizer, scheduler, payload["method"],
                        samples, CPU, torch.Generator().manual_seed(ddp.rank_seed(0, rank)))
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return state, {k: float(v) for k, v in losses.items()}


def _step(rank, world, payload):
    """The DDP step: this rank's share of the payload's samples."""
    share = ddp.rank_share(payload["samples"], rank, world)
    state, losses = one_step(payload, share, rank, lambda m: ddp.wrap(m, CPU))
    return dict(state=state, losses=comm.reduce_dict(losses), share=len(share))


def _comm(rank, world, payload):
    comm.synchronize()
    return dict(world=comm.get_world_size(), rank=comm.get_rank(),
                main=comm.is_main_process(),
                gathered=comm.all_gather({"rank": rank, "items": list(range(rank + 2))}),
                mean=comm.reduce_dict({"a": rank + 1.0, "b": torch.tensor(2.0 * rank)}),
                total=comm.reduce_dict({"a": rank + 1.0}, average=False))


def _train_net(rank, world, payload):
    """``train_net.main`` as ``torchrun`` would start this rank, counting
    the checkpoints it saves and keeping the trained model's state."""
    from torch.nn.parallel import DistributedDataParallel

    from mega_pytorch_tpu_torch.engine import trainer
    from mega_pytorch_tpu_torch.tools import train_net
    from mega_pytorch_tpu_torch.utils.checkpoint import Checkpointer

    saves, seen = [], {}
    save, do_train = Checkpointer.save, trainer.do_train

    def counting_save(self, name, *args, **kw):
        saves.append(name)
        return save(self, name, *args, **kw)

    def keeping_do_train(cfg, model, *args, **kw):
        record = do_train(cfg, model, *args, **kw)
        seen.update(ddp=isinstance(model, DistributedDataParallel), state={
            k: v.detach().clone() for k, v in ddp.unwrap(model).state_dict().items()})
        return record

    Checkpointer.save, trainer.do_train = counting_save, keeping_do_train
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
    record = train_net.main(payload["argv"], dist_init=payload["init"])
    return dict(record=record, saves=saves, **seen)


def _ddp_check(rank, world, payload):
    """``tools/ddp_check.py``'s comparison of the DDP step with the plain
    step, on this world."""
    from mega_pytorch_tpu_torch.tools import ddp_check

    cfg = get_preset(payload["preset"])
    cfg.merge_from_list(payload["opts"])
    return ddp_check.check(cfg, CPU, payload["iters"], frame_hw=payload["frame"])


TASKS = {"step": _step, "comm": _comm, "train_net": _train_net, "ddp_check": _ddp_check}


def _run(rank, world, task, in_path, out_dir, store):
    torch.set_num_threads(2)
    with open(in_path, "rb") as f:
        payload = pickle.load(f)
    if task != "train_net":  # train_net joins the group itself
        ddp.init_distributed("cpu", f"file://{store}", rank=rank, world_size=world)
    try:
        result = TASKS[task](rank, world, payload)
    finally:
        ddp.destroy_distributed()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn_world(task: str, payload: dict, tmp_path, world: int = 2,
                timeout: float = 300.0) -> list:
    """Run ``task`` on ``world`` gloo ranks → each rank's result; fails the
    test (and kills the ranks) after ``timeout`` seconds."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    in_path, store = tmp_path / "payload.pkl", tmp_path / "store"
    payload = dict(payload, init=f"file://{store}")
    with open(in_path, "wb") as f:
        pickle.dump(payload, f)
    ctx = mp.start_processes(_run, args=(world, task, str(in_path), str(tmp_path), str(store)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{task}: the world did not finish in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = []
    for rank in range(world):
        with open(tmp_path / f"rank{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out
