"""Data-parallel training over the cell's cards: one process a card, the
port's ``parallel/ddp.py`` (``init_distributed``, ``wrap``) and
``engine/trainer.py:train_step`` with the preset's SGD and warmup schedule,
one sample a card an iteration (the published recipe's IMS_PER_BATCH 4 on
4 cards). Each rank draws a pool of samples from ``rank_seed(seed, rank)``
in set-up, so the host producer is out of the loop; ``train_step`` copies
each sample to the card, as training does.

Set-up drives the wrapped model through its first three iterations; the
window then runs on. After the window rank 0 frees the program's state
and the plain reference retrains the three iterations over all the
ranks' samples (their mean), from the same weights and draws."""

from __future__ import annotations

import math
import os
import socket
import time
import traceback

import numpy as np
import torch

from ..harness import trace
from ..harness.spec import Cell, metric_reader
from ..harness.weights import calibrated_weights
from ..reference import train as ref_train
from ..reference.ops import float32_matmul
from ..reference.params import param_spec
from .offline_lockstep import port_config

PIXEL_MEAN_BGR = np.array([102.9801, 115.9465, 122.7717], np.float32)
SETUP_ITERS = 3


def rank_seed(seed: int, rank: int) -> int:
    """A rank's draws, distinct for every (seed, rank) in the low 32 bits
    too (a CPU generator reads no more)."""
    return (seed % 2 ** 59) * 16 + rank + 1


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def draw_samples(c: dict, t: dict, seed: int, rank: int, device) -> list:
    """Rank ``rank``'s pool: samples in the port's layout (normalized BGR
    canvases, sizes, padded ground truth of ``gt_boxes`` boxes, each 10 to
    40 % of the image a side, classes 1..30), frames drawn on ``device``,
    held on the host."""
    gen = torch.Generator(device).manual_seed(rank_seed(seed, rank) + 17)
    h, w = c["canvas"]
    ih, iw = t["image_size"]
    groups = t["frames"]
    n_frames = sum(groups.values())
    mean = torch.tensor(PIXEL_MEAN_BGR, device=device)
    out = []
    for _ in range(t["pool_per_rank"]):
        u8 = torch.randint(0, 256, (n_frames, h, w, 3), generator=gen, device=device,
                           dtype=torch.uint8)
        x = u8.flip(-1).float() - mean
        x[:, ih:] = 0
        x[:, :, iw:] = 0
        frames = x.cpu().numpy()
        r = torch.rand((8,), generator=gen, device=device).cpu().numpy()
        n = int(t["gt_boxes"][0] + math.floor(r[0] * (t["gt_boxes"][1] - t["gt_boxes"][0] + 1)))
        xy = torch.rand((n, 2), generator=gen, device=device).cpu().numpy() * [0.6 * iw, 0.6 * ih]
        wh = (0.1 + 0.3 * torch.rand((n, 2), generator=gen, device=device).cpu().numpy()) * [iw, ih]
        boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        labels = torch.randint(1, c["num_classes"], (n,), generator=gen,
                               device=device).cpu().numpy()
        g = c["max_gt_boxes"]
        gt = {"boxes": np.zeros((1, g, 4), np.float32), "labels": np.zeros((1, g), np.int64),
              "valid": np.zeros((1, g), bool)}
        gt["boxes"][0, :n], gt["labels"][0, :n], gt["valid"][0, :n] = boxes, labels, True
        size = np.array([ih, iw], np.float32)
        sample, i = {"gt": gt}, 0
        for key, k in (("cur", 1), ("ref_l", groups["local"] - 1),
                       ("ref_m", groups["memory"]), ("ref_g", groups["global"])):
            part = frames[i:i + k]
            i += k
            sample[key] = part
            sample[key + "_size"] = np.stack([size] * k)
        out.append(sample)
    return out


def reference_sample(sample: dict, device) -> dict:
    """A port-layout sample as the reference takes it."""
    def frames(arrs, sizes):
        x = torch.as_tensor(np.ascontiguousarray(arrs), device=device).permute(0, 3, 1, 2)
        return x.contiguous(), [tuple(float(v) for v in s) for s in sizes]

    gt = {k: torch.as_tensor(v[0], device=device) for k, v in sample["gt"].items()}
    return {"local": frames(np.concatenate([sample["cur"], sample["ref_l"]]),
                            np.concatenate([sample["cur_size"], sample["ref_l_size"]])),
            "memory": frames(sample["ref_m"], sample["ref_m_size"]),
            "global": frames(sample["ref_g"], sample["ref_g_size"]), "gt": gt}


def trainable(c: dict) -> list:
    frozen = tuple(f"backbone.{m}." for m in ["stem"] + [f"layer{i}" for i in range(1, c["freeze_at"])])
    return [n for n, _, _ in param_spec(c)
            if not n.startswith(frozen) and ".bn" not in n and "_bn." not in n]


def _leaf_gaps(prog: dict, ref: dict, ref_grad: dict) -> tuple[float, float, str, int]:
    """Per leaf |prog - ref| / max(ref, median leaf's ref), over the leaves
    whose reference gradient is at least a thousandth of the median leaf's
    → (worst gap, median gap, worst leaf, leaves left out)."""
    gmed = float(np.median(list(ref_grad.values())))
    keep = [k for k in ref if ref_grad[k] >= 1e-3 * gmed]
    med = float(np.median([ref[k] for k in keep]))
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], float(np.median(list(gaps.values()))), worst, len(ref) - len(keep)


class Worker:
    def __init__(self, cell: Cell, seed: int, rank: int, world: int, port: int, device: str):
        self.cell, self.seed, self.rank, self.world = cell, seed, rank, world
        self.c, self.t, self.s = cell.config, cell.traffic, cell.settings
        from mega_pytorch_tpu_torch.parallel import ddp

        self.ddp = ddp
        if device == "cuda":
            torch.cuda.set_device(rank)
        else:  # ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        _, _, self.device = ddp.init_distributed(device, f"tcp://localhost:{port}", rank, world)

    def setup(self) -> None:
        from mega_pytorch_tpu_torch.models.detectors import detection_model
        from mega_pytorch_tpu_torch.solver import make_lr_scheduler, make_optimizer

        c, dev = self.c, self.device
        self.P = calibrated_weights(c, c["weights_seed"], dev, tuple(self.t["image_size"]))
        cfg = port_config(c)
        self.cfg = cfg
        model = detection_model(cfg, dev)
        model.load_state_dict(self.P, strict=True)
        model.backbone.freeze_(cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT)
        self.model = model.train()
        self.optimizer = make_optimizer(cfg, model)
        self.scheduler = make_lr_scheduler(cfg, self.optimizer)
        self.wrapped = self.make_wrapped(model)
        self.pool = draw_samples(c, self.t, self.seed, self.rank, dev)
        self.gen = torch.Generator(dev).manual_seed(rank_seed(self.seed, self.rank))
        self.iteration = 0

    def make_wrapped(self, model):
        return self.ddp.wrap(model, self.device)

    def step(self) -> dict:
        from mega_pytorch_tpu_torch.engine.trainer import train_step

        sample = self.pool[self.iteration % len(self.pool)]
        self.iteration += 1
        return train_step(self.wrapped, self.optimizer, self.scheduler, "mega", [sample],
                          self.device, self.gen)

    def mean_loss(self, losses: dict) -> float:
        total = sum(losses.values()).detach().reshape(1)
        torch.distributed.all_reduce(total)
        return float(total) / self.world

    def first_iterations(self) -> dict:
        """The set-up's iterations, with what the comparison reads on rank 0:
        each iteration's mean loss, the first gradient from the optimizer's
        state, the parameters' change after the last."""
        names = dict(self.model.named_parameters())
        p0 = {k: names[k].detach().clone() for k in trainable(self.c)} if self.rank == 0 else {}
        out = {"losses": []}
        for it in range(SETUP_ITERS):
            out["losses"].append(self.mean_loss(self.step()))
            if it == 0 and self.rank == 0:
                out["grad0"] = {}
                for group in self.optimizer.param_groups:
                    for p in group["params"]:
                        k = next(n for n, q in names.items() if q is p)
                        buf = self.optimizer.state[p].get("momentum_buffer")
                        out["grad0"][k] = (0.0 if buf is None else  # no step taken
                                           float((buf - group["weight_decay"] * p0[k]).norm()))
        if self.rank == 0:
            out["change"] = {k: float((names[k].detach() - p0[k]).norm()) for k in p0}
        return out

    def window(self, seconds: float) -> dict:
        flag = torch.zeros(1, device=self.device)
        iters, times = 0, []
        torch.distributed.barrier()
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            self.mean_loss(self.step())
            times.append(time.perf_counter() - t)
            iters += 1
            flag.fill_(float(time.perf_counter() - t0 >= seconds))
            torch.distributed.broadcast(flag, 0)
            if flag.item():
                break
        wall = time.perf_counter() - t0
        return {"iterations": iters, "wall_s": wall,
                "samples_per_s": iters * self.world / wall,
                "iter_ms_median": float(np.median(times)) * 1e3}

    def traced(self, steps: int) -> dict:
        expected = self.cell.settings["ranges"]

        def run():
            for _ in range(steps):
                self.mean_loss(self.step())
            torch.cuda.synchronize(self.device)

        with trace.layer_ranges(*trace.declared_ranges(self.model, expected)):
            events, wall = trace.profile(run, steps)
        summary = trace.summarize(events, wall, steps, expected)
        trace.check_ranges(summary, expected)
        summary["nccl_s"] = trace.kernel_s(summary, "nccl")
        return summary


def _worker(rank, world, port, cell, seed, seconds, trace_on, t_process, device, queue,
            fault=None, controls=False):
    try:
        w = Worker(cell, seed, rank, world, port, device)
        w.setup()
        if fault is not None:
            fault(w)
        first = w.first_iterations()
        setup_s = time.time() - t_process
        win = w.window(seconds)
        summary = w.traced(cell.settings["trace_steps"]) if trace_on else None
        peak = torch.cuda.max_memory_allocated(w.device) if w.device.type == "cuda" else 0
        queue.put((rank, {"first": first, "window": win, "setup_s": setup_s,
                          "trace": summary, "peak": peak}))
        if rank == 0:
            w.wrapped = w.model = w.optimizer = w.scheduler = None
            if w.device.type == "cuda":
                torch.cuda.empty_cache()
            queue.put(("reference", reference_readings(cell, seed, w.P, w.device, trace_on,
                                                       controls)))
        w.ddp.destroy_distributed()
    except BaseException:  # the launcher reports it and fails the run
        queue.put((rank, {"error": traceback.format_exc()}))


def reference_readings(cell: Cell, seed: int, P: dict, device, count_flops: bool,
                       controls: bool = False) -> dict:
    """The reference's three iterations over every rank's samples: losses,
    first gradients' and changes' leaf norms; with ``controls`` also the
    float8 control's and the planted faults' (as the reference in the
    program's place)."""
    c, t = cell.config, cell.traffic
    world = cell.chips
    pools = [draw_samples(c, t, seed, r, device) for r in range(world)]
    steps = [[reference_sample(pools[r][it], device) for r in range(world)]
             for it in range(SETUP_ITERS)]
    names = trainable(c)

    def run(mode="float32", drop=None, alter=False):
        gens = [torch.Generator(device).manual_seed(rank_seed(seed, r)) for r in range(world)]
        use = steps
        if alter:  # a ground-truth label altered where the sample is fed
            use = [[dict(s, gt=dict(s["gt"], labels=s["gt"]["labels"] % 30 + 1)) if i == 0
                    else s for i, s in enumerate(row)] for row in steps]
        with float32_matmul():
            out = ref_train.train(use, gens, P, names, c, mode, drop)
        return {"losses": [sum(v.values()) for v in out["losses"]],
                "grad0": {k: float(v.norm()) for k, v in out["grad0"].items()},
                "change": {k: float((out["params"][k] - P[k]).norm()) for k in names}}

    t0 = time.time()
    res = {"reference": run()}
    res["reference_s"] = time.time() - t0
    if controls:
        res["control"] = run("float8")
        res["half_the_batch"] = run(drop=set(range(world // 2, world)))
        res["no_exchange"] = run(drop=set(range(1, world)))
        res["answer_altered"] = run(alter=True)
    if count_flops:
        from ..harness.flops import count

        gen = torch.Generator(device).manual_seed(0)
        W = {k: (v.detach().clone().requires_grad_(True) if k in names else v)
             for k, v in P.items()}

        def one():
            parts = ref_train.losses(steps[0][0], gen, W, c, ref_train.STPrecision())
            sum(parts.values()).backward()
        with float32_matmul():
            res["sample_flops"] = count(one)
    return res


def numbers(prog: dict, ref: dict) -> dict:
    """The three iterations' loss gap (the largest relative one), and the
    first gradient's and the parameters' change's leaf gaps: the median
    leaf's (compared) and the worst leaf's (reported: the position weights'
    Wg, whose log(relu(.) + 1e-6) makes the gradient of pairs near the floor
    swing with the last bits, leads it)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    grad, grad_med, grad_leaf, _ = _leaf_gaps(prog["grad0"], ref["grad0"], ref["grad0"])
    change, change_med, change_leaf, left = _leaf_gaps(prog["change"], ref["change"],
                                                       ref["grad0"])
    return {"loss_gap": loss, "grad_gap_median": grad_med, "change_gap_median": change_med,
            "grad_gap_worst": grad, "change_gap_worst": change, "grad_leaf": grad_leaf,
            "change_leaf": change_leaf, "leaves_left_out": left}


def launch(cell: Cell, seed: int, seconds: float, trace_on: bool, t_process: float,
           device: str = "cuda", fault=None, controls: bool = False,
           timeout: float = 900) -> dict:
    """Start one process a card, collect each rank's record and rank 0's
    reference readings; every process is joined (or ended) before return."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker, args=(r, cell.chips, port, cell, seed, seconds,
                                                trace_on, t_process, device, queue, fault,
                                                controls))
             for r in range(cell.chips)]
    for p in procs:
        p.start()
    got: dict = {}
    deadline = time.time() + timeout
    try:
        while len(got) < cell.chips + 1 and time.time() < deadline:
            try:
                key, rec = queue.get(timeout=5)
            except Exception:  # queue.Empty: look whether a worker died
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                continue
            got[key] = rec
            if "error" in rec:
                raise RuntimeError(f"rank {key} failed:\n{rec['error']}")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()
    if len(got) < cell.chips + 1:
        raise RuntimeError(f"the ranks gave {sorted(got, key=str)} of {cell.chips} and the reference")
    return got


def run(cell: Cell, seed: int, seconds: float, trace_on: bool, t_process: float,
        device="cuda", fault=None) -> tuple[dict, list]:
    from ..harness import compare

    got = launch(cell, seed, seconds, trace_on, t_process, device, fault)
    ranks = [got[r] for r in range(cell.chips)]
    ref = got["reference"]
    nums = numbers(ranks[0]["first"], ref["reference"])
    ok, checks = compare.judge(nums, cell.settings["limits"])
    win = ranks[0]["window"]
    setup_s = max(r["setup_s"] for r in ranks)
    metrics = {}
    if not trace_on:
        values = {"samples_per_s": win["samples_per_s"], "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        traces = [r["trace"] for r in ranks]
        ctx = {"trace": traces[0], "traces": traces, "window": win, "world": cell.chips,
               "peak_bytes": max(r["peak"] for r in ranks),
               "step_flops": cell.chips * ref["sample_flops"]}
        for m in cell.per_layer:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": ok, "attempted": win["iterations"] * cell.chips, "failed": 0,
              "metrics": metrics, "seed": seed, "window": dict(win, setup_s=setup_s),
              "compared": nums, "reference_s": ref["reference_s"],
              "losses": {"program": ranks[0]["first"]["losses"],
                         "reference": ref["reference"]["losses"]}}
    if trace_on:
        busy = sum(tr["busy_s"] for tr in traces) / len(traces)
        result["trace"] = {"busy_s": busy, "wall_s": traces[0]["wall_s"]}
        result["breakdown"] = {"device_ops": traces[0]["device_ops"],
                               "idle_gaps": traces[0]["idle_gaps"]}
    result["memory_peak_bytes"] = max(r["peak"] for r in ranks)
    return result, checks
