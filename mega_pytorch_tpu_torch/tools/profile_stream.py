"""Where a streaming step's (or a training iteration's) time goes, on one
CUDA card.

    python -m mega_pytorch_tpu_torch.tools.profile_stream --out DIR \
        [--method {mega,rdn,fgfa,dff,mega_train}] [--lanes L]

Builds the method's flagship (R-101, bf16, 608x1024, seeded random weights;
``build_method_flagship``). MEGA with one lane (its default) streams the
synthetic video of ``chip_smoke.py`` through ``run_video``; with ``--lanes
L`` it drives L lockstep lanes of synthetic frames through
``make_lockstep_step`` (every lane on the one-video schedule, its frames
from a pool of random canvases). RDN and FGFA (4 lanes by default) drive
``make_lockstep_step_windowed`` with every lane pushing a new frame each
step after its first; DFF (4 lanes) alternates ``make_lockstep_steps_dff``'s
key step and 9 non-key steps, its key interval of 10. ``mega_train`` runs
``engine/trainer.py:train_step`` of the ``mega_R_101`` preset for training
(``build_training_model``, FrozenBN statistics calibrated as chip_smoke's
train phase does, SGD) on 4 seeded synthetic samples of 720x1280 frames in
turn (``tools/train_bench.py``), one sample an iteration:

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
from ..engine.batched_inference import (
    make_lockstep_step,
    make_lockstep_step_windowed,
    make_lockstep_steps_dff,
)
from ..engine.inference import run_video, synthetic_video, video_schedule
from ..models.detectors import build_method_flagship
from ..models.detectors import dff as dff_mod
from ..models.detectors import fgfa as fgfa_mod
from ..models.detectors import mega as mega_mod
from ..models.detectors import rcnn as rcnn_mod
from ..models.detectors import rdn as rdn_mod

CANVAS = (608, 1024)
TRAIN_FRAME = (720, 1280)  # mega_train: VID's 720p frames, resized by the preset

NUM_FRAMES = 40  # 52 steps with the 12 warm-up steps
WARMUP, STEPS = 20, 10  # steps not counted; steps in each of the 3 phases
KEY_INTERVAL = 10  # DFF
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync")


def _train_cfg():
    from ..config import get_preset

    return get_preset("mega_R_101")


def _lockstep_steps(model, lanes: int, rs: np.random.RandomState):
    """Endless MEGA lockstep steps of ``lanes`` lanes on the one-video schedule."""
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


def _method_steps(model, lanes: int, rs: np.random.RandomState):
    """Endless lockstep steps of RDN or FGFA (every lane resets on the first
    step, then pushes a frame each step) or DFF (a key step, then
    KEY_INTERVAL - 1 non-key steps)."""
    dev = next(model.parameters()).device
    method = model.v.method
    pool = rs.randint(0, 256, (16, *CANVAS, 3), dtype=np.uint8)
    if method == "rdn":
        pool = s2d_pack_frames(pool, 4)
    pool = torch.from_numpy(pool).to(dev)
    size = torch.tensor(CANVAS, dtype=torch.float32, device=dev).expand(lanes, 2)
    lane = torch.arange(lanes, device=dev)
    if method == "dff":
        key_step, nonkey_step = make_lockstep_steps_dff(model)
    else:
        step = make_lockstep_step_windowed(model)
        pushes = torch.zeros(lanes, dtype=torch.bool, device=dev)
    carries, s = None, 0
    while True:
        frames = pool[(5 * lane + s) % len(pool)]
        if method == "dff":
            fn = key_step if s % KEY_INTERVAL == 0 else nonkey_step
            carries, dets = fn(carries, frames, size)
        else:
            carries, dets = step(carries, frames, size, pushes)
        s += 1
        yield dets


def _train_steps(model, optimizer, scheduler, rs: np.random.RandomState):
    """Endless training iterations of MEGA on seeded synthetic samples."""
    from ..engine.trainer import train_step
    from .train_bench import synthetic_mega_samples

    dev = next(model.parameters()).device
    samples = synthetic_mega_samples(_train_cfg(), TRAIN_FRAME, rs)
    gen = torch.Generator(dev).manual_seed(0)
    s = 0
    while True:
        losses = train_step(model, optimizer, scheduler, "mega", [samples[s % len(samples)]],
                            dev, gen)
        s += 1
        yield losses


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
def _layer_timers(model, optimizer=None):
    """Wrap the step's pieces (training: ``optimizer``'s step too); yields
    {piece: [ms per call]}."""
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
    method = model.v.method
    if optimizer is not None:  # a MEGA training iteration
        methods = [
            (model, "forward_train", "forward_train (whole)"),
            (model.backbone, "forward", "backbone, local / global / memory frames"),
            (model.rpn, "forward", "RPN head"),
            (ext, "extract_train", "extract_train (whole)"),
            (ext, "enhance_features", "res5 head"),
            (ext, "pool_flat", "ROIAlign"),
            (ext, "fc0", "fc0"),
            (model.predictor, "forward", "predictor"),
            (optimizer, "step", "SGD step"),
        ]
        functions = [
            (rcnn_mod, "rpn_loss", "RPN loss"),
            (rcnn_mod, "rpn_postprocess", "RPN postprocess, cur (6000 -> 300)"),
            (mega_mod, "rpn_postprocess", "RPN postprocess, local refs (6000 -> 75)"),
            (rdn_mod, "rpn_postprocess", "RPN postprocess, memory / global (6000 -> 75)"),
            (rcnn_mod, "subsample_proposals", "subsample_proposals"),
        ]
    elif method == "mega":
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
            (rdn_mod, "shared_ref_key_postprocess",
             "RPN postprocess, key sets (6000 -> 300)"),
            (mega_mod, "rpn_postprocess", "RPN postprocess, global frames (6000 -> 75)"),
            (rcnn_mod, "postprocess_detections", "postprocess_detections (per-class NMS)"),
        ]
    elif method == "rdn":
        methods = [
            (model, "precompute", "precompute (whole)"),
            (model.backbone, "forward", "backbone, one frame a lane"),
            (model.rpn, "forward", "RPN head"),
            (ext, "enhance_features", "res5 head"),
            (ext, "pool_flat", "ROIAlign"),
            (ext, "fc0", "fc0 (fcs_0)"),
            (model, "detect_key", "detect_key (whole)"),
            (ext, "extract_test", "attention stages (extract_test)"),
            (model.predictor, "forward", "predictor"),
        ]
        functions = [
            (rdn_mod, "shared_ref_key_postprocess",
             "RPN postprocess, key sets (6000 -> 300)"),
            (rcnn_mod, "postprocess_detections", "postprocess_detections (per-class NMS)"),
        ]
    else:  # fgfa, dff: the flow net, the warp, and the single-frame heads
        warp_mod = fgfa_mod if method == "fgfa" else dff_mod
        methods = [
            (model.backbone, "forward", "backbone, one frame a lane (key steps for dff)"),
            (model.flownet, "forward", "FlowNetS"),
            (model, "detect_heads", "detect_heads (whole)"),
            (model.rpn, "forward", "RPN head"),
            (ext, "forward", "res5 head + ROIAlign + fc6/fc7"),
            (model.predictor, "forward", "predictor"),
        ]
        if method == "fgfa":
            methods += [(model, "precompute", "precompute (whole)"),
                        (model.embednet, "forward", "embedding net"),
                        (model, "detect_key", "detect_key (whole)")]
        else:
            methods += [(model, "detect_non_key", "detect_non_key (whole)")]
        functions = [
            (warp_mod, "warp_by_flow", "warp_by_flow"),
            (rcnn_mod, "rpn_postprocess", "RPN postprocess (6000 -> 300)"),
            (rcnn_mod, "postprocess_detections", "postprocess_detections (per-class NMS)"),
        ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in functions]
    # an instance's own attribute (the LR scheduler's wrapper of
    # optimizer.step) is put back; elsewhere the class attribute shows through
    own = [(obj, name, vars(obj).get(name)) for obj, name, _ in methods]
    for obj, name, label in methods:
        setattr(obj, name, timed(label, getattr(obj, name)))
    for mod, name, label in functions:
        setattr(mod, name, timed(label, getattr(mod, name)))
    try:
        yield calls
    finally:
        for obj, name, fn in own:
            if fn is None:
                delattr(obj, name)
            else:
                setattr(obj, name, fn)
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _per_step_median(ms, steps):
    """Median over steps of a piece's summed ms (its calls come in step order,
    the same number in each step); the mean over the steps where a piece
    runs on some steps only (DFF's backbone, on key steps)."""
    per = len(ms) // steps
    if per * steps != len(ms) or per == 0:
        return sum(ms) / steps
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
    ap.add_argument("--method", default="mega",
                    choices=("mega", "rdn", "fgfa", "dff", "mega_train"))
    ap.add_argument("--lanes", type=int, default=None,
                    help="lockstep lanes (default: 1 for mega, 4 for the others)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_stream: needs a CUDA card")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    lanes = args.lanes or (1 if args.method.startswith("mega") else 4)
    rs = np.random.RandomState(0)
    optimizer = None
    if args.method == "mega_train":
        from ..models.detectors import build_training_model
        from ..solver import make_lr_scheduler, make_optimizer
        from .train_bench import calibrate_frozen_bn, calibration_frames

        cfg = _train_cfg()
        model = build_training_model(cfg, "cuda", torch.Generator("cuda").manual_seed(0))
        calibrate_frozen_bn(model, calibration_frames(cfg, TRAIN_FRAME, rs, "cuda"))
        optimizer = make_optimizer(cfg, model)
        gen = _train_steps(model, optimizer, make_lr_scheduler(cfg, optimizer), rs)
    else:
        model = build_method_flagship(args.method, *CANVAS, device="cuda", lanes=lanes,
                                      generator=torch.Generator("cuda").manual_seed(0))
        if args.method != "mega":
            gen = _method_steps(model, lanes, rs)
        elif lanes == 1:
            gen = run_video(model, *synthetic_video(rs, NUM_FRAMES, *CANVAS))
        else:
            gen = _lockstep_steps(model, lanes, rs)
    _steps(gen, WARMUP)
    plain = _steps(gen, STEPS)
    with _layer_timers(model, optimizer) as calls:
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
        "method": args.method,
        "lanes": lanes,
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
