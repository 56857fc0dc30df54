"""FLOPs and model FLOP utilisation of one step on the card (counterpart of
the repo's ``tools/profile_mfu.py``, with its two modes).

    python -m mega_pytorch_tpu_torch.tools.profile_mfu [--lanes 12] \\
        [--canvas 608x1024] [--iters 8] [--peak-tflops 989] [--out DIR]
    python -m mega_pytorch_tpu_torch.tools.profile_mfu --train [--iters 8] ...

The step is the MEGA flagship's lockstep step (``build_mega_flagship``:
R-101, bf16, s2d(4)-packed frames, seeded random weights) over ``--lanes``
lanes (12 by default, the port's offline cell; the JAX tool's default is
4), or with ``--train`` one ``mega_R_101`` training iteration (one sample
of cur + 2 local, 3 memory and 2 global frames: forward, backward, SGD;
FrozenBN statistics calibrated as ``profile_stream`` does).

1. FLOPs of one step, counted by ``torch.utils.flop_counter.FlopCounterMode``:
   convolutions and matrix products (the fc layers, ROIAlign's two
   einsums, the attention projections), and every hand-written kernel by
   the formula registered with its operator (``ops/kernels/operators.py``):
   twice the multiply-adds of the products its function defines, whoever
   computes it, so a step counts the same FLOPs on the CPU and on the card.
   On the CPU relation attention runs the module's einsum path, whose
   products are the kernels' formulas; its FLOPs then count as aten work,
   not as kernel work. In training the card's attention backward recomputes
   the plain forward (as the JAX package's ``custom_vjp`` does), which the
   count includes. The kernels' sines and cosines, exponentials and
   logarithms are listed apart and are not FLOPs. Elementwise work is not
   counted: XLA's ``cost_analysis``, which the JAX tool reads, counts it
   (FrozenBN, relu, pooling, adds) and counts only the taps of a padded
   convolution that fall inside its input, so the two tools' totals are
   not the same measure.
2. ms a step: the host clock around each of ``--iters`` steps, each ended by
   ``torch.cuda.synchronize()``, after warm-up steps; the median.
3. achieved TFLOP/s = FLOPs / step time, and the MFU against
   ``--peak-tflops`` (989: the H100 SXM's dense bf16 rate).
4. device time by kernel family from a ``torch.profiler`` trace of
   ``--iters`` steps: cuDNN convolutions, GEMMs, each hand-written kernel,
   NMS (every kernel launched inside the ``nms`` span that
   ``ops/nms.py:nms`` opens while a profiler records), copies (casts
   included), elementwise, and the rest, with each family's largest
   kernels. Families go by kernel name, so a convolution that cuDNN runs
   as a GEMM kernel counts as a GEMM; the idle share is 1 - busy / the
   plain step's ms (the profiler's own overhead stretches the traced
   steps).

Needs a CUDA card; prints a summary and, with ``--out``, writes it as JSON.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import tempfile
import time
from collections import Counter, defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..ops.kernels.operators import SPECIAL_FUNCTIONS
from . import profile_stream

PEAK_TFLOPS = 989.0  # H100 SXM, dense bf16 (NVIDIA's data sheet, 700 W)
CANVAS = profile_stream.CANVAS
DEVICE_CATS = profile_stream.DEVICE_CATS
# kernel family of a device kernel, by the first pattern in its name
HAND_WRITTEN = (("stem_pool_kernel", "stem_pool_packed"),
                ("relation_attention_pos_tc_kernel", "relation attention \"compute\""),
                ("relation_attention_tc_kernel<true", "relation attention \"input\""),
                ("relation_attention_tc_kernel<(bool)1", "relation attention \"input\""),
                ("relation_attention_tc_kernel", "relation attention \"none\""),
                ("position_bias_kernel", "fused_position_bias"),
                ("roi_align_kernel", "roi_align"))
CONV = ("conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit_convolve")
GEMM = ("gemm", "gemv", "nvjet", "cublas", "cutlass", "splitk", "dot_kernel")
COPY = ("copy",)
ELEMENTWISE = ("elementwise",)


class _KernelTally(TorchDispatchMode):
    """Counts the special functions of each kernel operator that runs."""

    def __init__(self):
        super().__init__()
        self.special: dict[str, Counter] = defaultdict(Counter)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        count = SPECIAL_FUNCTIONS.get(func._overloadpacket)
        if count is not None:
            shapes = [tuple(a.shape) if isinstance(a, torch.Tensor) else a for a in args]
            self.special[_op_name(func._overloadpacket)].update(count(*shapes))
        return func(*args, **(kwargs or {}))


def _op_name(packet) -> str:
    return str(packet).split(".")[-1]


class _WholeStep:
    """Stands in for ``FlopCounterMode``'s module tracker: everything counts
    under "Global" alone. The tracker's per-module backward hooks fail in a
    training step (a view that requires grad but has no gradient function
    reaches a module), and the tool reads only the totals."""

    parents = {"Global"}

    def __enter__(self):
        return self

    def __exit__(self, *args):
        return None


def count_flops(fn) -> dict:
    """Run ``fn()`` once under ``FlopCounterMode``: {"flops": total,
    "kernel_flops": {operator: FLOPs of the hand-written kernels' operators},
    "by_op": {aten or kernel operator: FLOPs}, "special": {operator:
    {"sin_cos", "exp", "log"}}}."""
    tally = _KernelTally()
    counter = FlopCounterMode(display=False)
    counter.mod_tracker = _WholeStep()
    with counter, tally:
        fn()
    by_op = {str(op): int(n) for op, n in counter.get_flop_counts()["Global"].items()}
    kernel = {_op_name(op): int(n) for op, n in counter.get_flop_counts()["Global"].items()
              if op in SPECIAL_FUNCTIONS}
    return {"flops": int(counter.get_total_flops()), "kernel_flops": kernel, "by_op": by_op,
            "special": {name: dict(c) for name, c in tally.special.items()}}


def mega_step(lanes: int = 12, canvas=CANVAS, device="cuda", compute_dtype="bfloat16"):
    """(one lockstep step of the MEGA flagship as a callable, frames a
    step): ``lanes`` lanes of synthetic packed frames on ``canvas``, weights
    from ``torch.Generator(device).manual_seed(0)``."""
    from ..models.detectors.mega import build_mega_flagship

    model = build_mega_flagship(*canvas, device=device, lanes=lanes,
                                generator=torch.Generator(device).manual_seed(0),
                                compute_dtype=compute_dtype)
    steps = profile_stream._lockstep_steps(model, lanes, np.random.RandomState(0), canvas)
    return lambda: next(steps), lanes


def train_step(device="cuda"):
    """(one ``mega_R_101`` training iteration as a callable, samples an
    iteration), with FrozenBN statistics calibrated on two frames."""
    from ..models.detectors import build_training_model
    from ..solver import make_lr_scheduler, make_optimizer
    from .train_bench import calibrate_frozen_bn, calibration_frames

    cfg = profile_stream._train_cfg("mega_train")
    rs = np.random.RandomState(0)
    model = build_training_model(cfg, device, torch.Generator(device).manual_seed(0))
    calibrate_frozen_bn(model, calibration_frames(cfg, profile_stream.TRAIN_FRAME, rs, device))
    optimizer = make_optimizer(cfg, model)
    steps = profile_stream._train_steps(model, optimizer, make_lr_scheduler(cfg, optimizer),
                                        cfg, rs)
    return lambda: next(steps), cfg.SOLVER.IMS_PER_BATCH


def step_ms(step, warmup: int, iters: int) -> float:
    """Median host-clock ms of ``iters`` synchronised steps after ``warmup``."""
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    ms = []
    for _ in range(iters):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def kernel_family(name: str) -> str:
    """The family of a device kernel (NMS is told by its range, not its name)."""
    low = name.lower()
    for pattern, family in HAND_WRITTEN:
        if pattern in name:
            return family
    for patterns, family in ((CONV, "convolutions (cuDNN)"), (GEMM, "GEMMs"),
                             (COPY, "copies"), (ELEMENTWISE, "elementwise")):
        if any(p in low for p in patterns):
            return family
    return "other"


def device_time_by_family(step, iters: int) -> dict:
    """Device ms a step by kernel family, from a ``torch.profiler`` trace of
    ``iters`` steps; also the device's busy ms and idle share."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prof:
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    nms = defaultdict(list)  # thread -> [(start, end)] of the nms ranges
    for e in spans:
        if e.get("cat") == "user_annotation" and e["name"] == "nms":
            nms[e["tid"]].append((e["ts"], e["ts"] + e["dur"]))
    in_nms = set()  # correlation ids of the launches and copies made inside a range
    for e in spans:
        corr = e.get("args", {}).get("correlation")
        if corr is not None and e.get("cat") == "cuda_runtime" and any(
                a <= e["ts"] <= b for a, b in nms.get(e["tid"], ())):
            in_nms.add(corr)
    device = [e for e in spans if e.get("cat") in DEVICE_CATS]
    families = defaultdict(float)
    names = defaultdict(lambda: defaultdict(float))  # family -> kernel name -> ms
    for e in device:
        if e.get("args", {}).get("correlation") in in_nms:
            family = "NMS"
        elif e["cat"] != "kernel":
            family = "copies"
        else:
            family = kernel_family(e["name"])
        families[family] += e["dur"] / 1e3 / iters
        names[family][e["name"][:90]] += e["dur"] / 1e3 / iters
    busy = profile_stream._union_us([(e["ts"], e["ts"] + e["dur"]) for e in device]) / 1e3
    return {"ms_per_step_by_family": dict(sorted(families.items(), key=lambda kv: -kv[1])),
            "top_kernels_by_family": {
                f: dict(sorted(n.items(), key=lambda kv: -kv[1])[:4]) for f, n in names.items()},
            "device_busy_ms_per_step": busy / iters,
            "idle_share_profiled": 1.0 - busy / wall_ms}


def profile(step, per_step: int, warmup: int, iters: int,
            peak_tflops: float = PEAK_TFLOPS, trace: bool = True) -> dict:
    """The counts, the step time, the achieved rate, the MFU and (with
    ``trace``) the device time by family of ``step`` on the card."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile_mfu: needs a CUDA card")
    for _ in range(warmup):  # cuDNN plans and the kernel build before the count
        step()
    counts = count_flops(step)
    ms = step_ms(step, 1, iters)
    tflops = counts["flops"] / (ms * 1e-3) / 1e12
    out = {
        "card": torch.cuda.get_device_name(0),
        "gflop_per_step": counts["flops"] / 1e9,
        "gflop_per_frame": counts["flops"] / 1e9 / per_step,
        "kernel_gflop_per_step": sum(counts["kernel_flops"].values()) / 1e9,
        "kernel_gflop_by_operator": {k: v / 1e9 for k, v in counts["kernel_flops"].items()},
        "kernel_special_functions": counts["special"],
        "gflop_by_op": {k: v / 1e9 for k, v in sorted(counts["by_op"].items(),
                                                       key=lambda kv: -kv[1])},
        "ms_per_step": ms,
        "achieved_tflops": tflops,
        "mfu": tflops / peak_tflops,
        "peak_tflops": peak_tflops,
    }
    if trace:
        out["trace"] = device_time_by_family(step, iters)
        # the profiler slows the host, so the idle share of the plain step
        # reads the device's busy time against the step's own time
        out["trace"]["idle_share"] = 1.0 - out["trace"]["device_busy_ms_per_step"] / ms
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lanes", type=int, default=12)
    ap.add_argument("--canvas", default=f"{CANVAS[0]}x{CANVAS[1]}")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--peak-tflops", type=float, default=PEAK_TFLOPS)
    ap.add_argument("--train", action="store_true",
                    help="one mega_R_101 training iteration instead of the lockstep step")
    ap.add_argument("--out", default=None, help="directory for summary.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_mfu: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if args.train:
        step, per_step = train_step()
        label = "mega_R_101 training iteration (1 sample)"
    else:
        canvas = tuple(int(x) for x in args.canvas.split("x"))
        step, per_step = mega_step(args.lanes, canvas)
        label = f"MEGA R-101 lockstep step, {args.lanes} lanes, {canvas[0]}x{canvas[1]}"
    rec = dict(profile(step, per_step, args.warmup, args.iters, args.peak_tflops),
               step=label, nvidia_smi=smi)
    unit = "sample" if args.train else "frame"
    print(f"=== {label} on {smi} ===")
    print(f"FLOPs: {rec['gflop_per_step']:.1f} GFLOP a step ({rec['gflop_per_frame']:.1f} a "
          f"{unit}), of which {rec['kernel_gflop_per_step']:.2f} in hand-written kernels")
    print(f"step: {rec['ms_per_step']:.2f} ms; achieved {rec['achieved_tflops']:.1f} TFLOP/s "
          f"= {100 * rec['mfu']:.2f} % MFU (peak {args.peak_tflops} TFLOP/s)")
    tr = rec["trace"]
    print(f"device busy {tr['device_busy_ms_per_step']:.2f} ms a step: idle share "
          f"{tr['idle_share']:.3f} of the plain step ({tr['idle_share_profiled']:.3f} of the "
          f"profiled one); device ms a step by family (largest kernels):")
    for family, ms in tr["ms_per_step_by_family"].items():
        top = "; ".join(f"{n[:50]} {t:.2f}" for n, t in tr["top_kernels_by_family"][family].items())
        print(f"  {family:>30s}: {ms:8.3f}  ({top})")
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / "summary.json").write_text(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
