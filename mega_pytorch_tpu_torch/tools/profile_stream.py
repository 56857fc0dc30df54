"""Where a streaming step's time goes, on one CUDA card.

    python -m mega_pytorch_tpu_torch.tools.profile_stream --out DIR [--lanes L]

Builds the flagship (MEGA R-101, bf16, 608x1024, seeded random weights) and
streams the synthetic video of ``chip_smoke.py`` through ``run_video`` (one
lane), or with ``--lanes L`` drives L lockstep lanes of synthetic frames
through ``make_lockstep_step`` (every lane on the one-video schedule, its
frames from a pool of random canvases):

  1. warm-up steps (cuDNN plans, the kernel build), not counted;
  2. plain steps: host clock per step with a synchronise after it;
  3. layer steps: every piece of the step below is wrapped to synchronise
     before and after itself, giving its host-clock ms (the pieces nest);
  4. profiled steps under ``torch.profiler`` (CPU and CUDA activity), whose
     trace is exported. From the trace: the device's busy time as the union
     of kernel, memcpy and memset intervals, the idle share as 1 - busy /
     wall, launches and host synchronisations per step, and device time by
     kernel name (the 15 largest, and every relation attention kernel).

Prints a summary and writes it, with the gzipped trace, under ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import shutil
import statistics
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from ..data.transforms import s2d_pack_frames
from ..engine.batched_inference import make_lockstep_step
from ..engine.inference import run_video, synthetic_video, video_schedule
from ..models.detectors import mega as mega_mod
from ..models.detectors.mega import build_mega_flagship

CANVAS = (608, 1024)
NUM_FRAMES = 40  # 52 steps with the 12 warm-up steps
WARMUP, STEPS = 20, 10  # steps not counted; steps in each of the 3 phases
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync")


def _lockstep_steps(model, lanes: int, rs: np.random.RandomState):
    """Endless lockstep steps of ``lanes`` lanes on the one-video schedule."""
    dev = next(model.parameters()).device
    v = model.v
    pool = torch.from_numpy(s2d_pack_frames(
        rs.randint(0, 256, (16, *CANVAS, 3), dtype=np.uint8), 4)).to(dev)
    size = torch.tensor(CANVAS, dtype=torch.float32, device=dev).expand(lanes, 2)
    step = make_lockstep_step(model)
    carries = model.zero_carry(lanes, dev)
    sched = video_schedule(NUM_FRAMES, v.all_frame_interval - v.key_frame_location - 1,
                           v.global_size)
    lane = torch.arange(lanes, device=dev)
    s = 0
    while True:
        fidx, gidx, reset, emit = sched[s % len(sched)]
        flags = torch.tensor([reset, gidx is not None, emit], device=dev)
        frames = pool[(5 * lane + fidx) % len(pool)]
        gframes = pool[(3 * lane + (gidx or 0)) % len(pool)]
        carries, dets = step(carries, frames, size, gframes, size,
                             *(f.expand(lanes) for f in flags))
        s += 1
        yield dets


def _steps(gen, n):
    """Run n steps; host-clock ms of each, synchronised."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        next(gen)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


@contextlib.contextmanager
def _layer_timers(model):
    """Wrap the step's pieces; yields {piece: [ms per call]}."""
    calls = defaultdict(list)

    def timed(label, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            calls[label].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    ext = model.extractor
    methods = [
        (model, "precompute_pair", "precompute_pair (whole)"),
        (model.backbone, "forward", "backbone, local + global frame of each lane"),
        (model.rpn, "forward", "RPN head"),
        (ext, "enhance_features", "res5 head + 1x1 reduce"),
        (ext, "pool_flat", "ROIAlign"),
        (ext, "fc0", "fc0"),
        (model, "detect_key", "detect_key (whole)"),
        (ext, "extract_test", "attention stages (extract_test)"),
        (model.predictor, "forward", "predictor"),
    ]
    functions = [
        ("shared_ref_key_postprocess", "RPN postprocess, key sets (6000 -> 300)"),
        ("rpn_postprocess", "RPN postprocess, global frames (6000 -> 75)"),
        ("postprocess_detections", "postprocess_detections (per-class NMS)"),
    ]
    saved = {name: getattr(mega_mod, name) for name, _ in functions}
    for obj, name, label in methods:
        setattr(obj, name, timed(label, getattr(obj, name)))
    for name, label in functions:
        setattr(mega_mod, name, timed(label, getattr(mega_mod, name)))
    try:
        yield calls
    finally:
        for obj, name, _ in methods:
            delattr(obj, name)  # the class attribute shows through again
        for name, fn in saved.items():
            setattr(mega_mod, name, fn)


def _per_step_median(ms, steps):
    """Median over steps of a piece's summed ms (its calls come in step order,
    the same number in each step)."""
    per = len(ms) // steps
    return statistics.median(sum(ms[i * per:(i + 1) * per]) for i in range(steps))


def _union_us(intervals):
    total, end = 0.0, -float("inf")
    for start, stop in sorted(intervals):
        if stop <= end:
            continue
        total += stop - max(start, end)
        end = stop
    return total


def _trace_summary(events, steps, wall_ms):
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    kernels = [e for e in device if e["cat"] == "kernel"]
    busy_ms = _union_us([(e["ts"], e["ts"] + e["dur"]) for e in device]) / 1e3
    by_name = defaultdict(float)  # names cut to 90 characters, so that
    for e in kernels:             # instances of one template add up
        by_name[e["name"][:90]] += e["dur"] / 1e3
    runtime = defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cuda_runtime":
            runtime[e["name"]][0] += 1
            runtime[e["name"]][1] += e["dur"] / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {
        "profiled_steps": steps,
        "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "kernel_sum_ms_per_step": sum(by_name.values()) / steps,
        "kernel_launches_per_step": len(kernels) / steps,
        "launch_api_ms_per_step": runtime["cudaLaunchKernel"][1] / steps,
        "sync_calls_per_step": {n: runtime[n][0] / steps for n in SYNC_CALLS},
        "device_ms_per_step_by_kernel": {n: ms / steps for n, ms in top},
        "attention_ms_per_step_by_kernel": {
            n: ms / steps for n, ms in by_name.items() if "relation_attention" in n},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="directory for the results")
    ap.add_argument("--lanes", type=int, default=1, help="lockstep lanes (default 1)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_stream: needs a CUDA card")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    model = build_mega_flagship(*CANVAS, device="cuda",
                                generator=torch.Generator("cuda").manual_seed(0))
    rs = np.random.RandomState(0)
    if args.lanes == 1:
        gen = run_video(model, *synthetic_video(rs, NUM_FRAMES, *CANVAS))
    else:
        gen = _lockstep_steps(model, args.lanes, rs)
    _steps(gen, WARMUP)
    plain = _steps(gen, STEPS)
    with _layer_timers(model) as calls:
        layered = _steps(gen, STEPS)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    profiled = _steps(gen, STEPS)
    prof.stop()
    gen.close()

    raw = out / "trace.json"
    prof.export_chrome_trace(str(raw))
    with open(raw) as f:
        events = json.load(f)["traceEvents"]
    with open(raw, "rb") as src, gzip.open(out / "trace.json.gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    raw.unlink()

    summary = {
        "card": smi,
        "lanes": args.lanes,
        "steps": {"warmup": WARMUP, "per_phase": STEPS},
        "plain_ms_per_step_median": statistics.median(plain),
        "plain_ms_per_step": plain,
        "layered_ms_per_step_median": statistics.median(layered),
        "layer_ms_per_step_median": {
            label: _per_step_median(ms, STEPS) for label, ms in calls.items()},
        "layer_calls_per_step": {label: len(ms) / STEPS
                                 for label, ms in calls.items()},
        "profiled_ms_per_step_median": statistics.median(profiled),
        "trace": _trace_summary(events, STEPS, sum(profiled)),
    }
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
