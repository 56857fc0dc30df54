#!/usr/bin/env python3
"""End-to-end check of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device: the card's name, and ``nvidia-smi``'s name and power limit;
  2. build: the CUDA kernels from ``mega_pytorch_tpu_torch/csrc`` (nvcc,
     sm_90a), with the build seconds and the ptxas register lines;
  3. kernels against their plain PyTorch versions at every shape the
     flagship path gives them: stem pool (exact, bf16 and f32), relation
     attention mode "none" (atol 6e-3) and "compute" (atol 2e-2 against the
     f32-sinusoid plain version), a 2-lane call whose lane 0 equals the
     1-lane call, all-invalid refs giving zeros; each with the kernel's and
     the plain version's time (TF32 off for the f32 checks);
  4. stream: MEGA R-101 in bf16 at 608x1024 with seeded random weights runs a
     40-frame synthetic video through ``run_video``; detections must be
     finite with 300 slots, and every kernel launch count must be exactly
     what the path implies; prints ms/frame, frames/s and peak memory;
  5. determinism: the first 15 steps again from a fresh carry give
     bit-identical detections.
The last two lines are the kernel table and the device record as JSON.
Any failed check raises, and the script exits non-zero.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from itertools import islice
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CANVAS = (608, 1024)
NUM_FRAMES = 40
ATOL_NONE, ATOL_POS = 6e-3, 2e-2
TIMING_REPEATS = 25  # timed turns per version
TIMING_INNER = 10  # back-to-back calls per timed turn


def _fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _time_pair(plain_fn, kernel_fn, repeats=TIMING_REPEATS):
    """Median ms per call of each, from CUDA events around TIMING_INNER
    back-to-back calls, after a warm-up, the two versions in turns."""
    import torch

    def once(fn):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TIMING_INNER):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / TIMING_INNER

    plain_fn(), kernel_fn()
    torch.cuda.synchronize()
    plain, kernel = [], []
    for i in range(repeats):
        order = [(plain, plain_fn), (kernel, kernel_fn)]
        for acc, fn in (order if i % 2 == 0 else order[::-1]):
            acc.append(once(fn))
    return statistics.median(kernel), statistics.median(plain)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{name}; devices {torch.cuda.device_count()}")
    print(f"[device] nvidia-smi: {smi}")
    return name, smi


def phase_build():
    from mega_pytorch_tpu_torch.ops.kernels.build import load_library

    lib = load_library()
    verb = "built" if lib.built else "loaded"
    print(f"[build] {verb} {lib.path.name} in {lib.seconds:.2f} s")
    for line in lib.ptxas:
        print(f"[build] ptxas: {line}")


def _attention_inputs(gen, b, n, m, dev):
    import torch

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def boxes(count):
        ctr = torch.rand(b, count, 2, generator=gen, device=dev) * torch.tensor(
            [CANVAS[1], CANVAS[0]], device=dev)
        wh = 16 + torch.rand(b, count, 2, generator=gen, device=dev) * 300
        return torch.cat([ctr - wh / 2, ctr + wh / 2], -1).contiguous()

    bf = torch.bfloat16
    return dict(
        q=randn(b, 16, n, 64).to(bf), k=randn(b, 16, m, 64).to(bf),
        v=randn(b, 16, m, 64).to(bf), uk=randn(b, 16, m, scale=8.0),  # as q.k
        valid=torch.rand(b, m, generator=gen, device=dev) > 0.2,
        rois=boxes(n), refs=boxes(m),
        wk=randn(64, 16, scale=0.05),
        wb=torch.rand(16, generator=gen, device=dev) * 0.1,
    )


def phase_kernels():
    import torch
    from mega_pytorch_tpu_torch.ops.kernels import relation_attention as ra
    from mega_pytorch_tpu_torch.ops.kernels import stem_pool as sp

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    rows = {}

    for dtype in (torch.bfloat16, torch.float32):
        y = (torch.randn(2, 152, 256, 256, generator=gen, device=dev) * 2).to(dtype)
        scale = torch.rand(256, generator=gen, device=dev) + 0.5
        shift = torch.randn(256, generator=gen, device=dev)
        got = sp.stem_pool_packed(y, scale, shift, 64)
        want = sp.stem_pool_packed_reference(y, scale, shift, 64)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        exact = torch.equal(got, want)
        ms, plain_ms = _time_pair(
            lambda: sp.stem_pool_packed_reference(y, scale, shift, 64),
            lambda: sp.stem_pool_packed(y, scale, shift, 64))
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        print(f"[kernels] stem_pool {tag} (2,152,256,256)->(2,152,256,64): "
              f"max_abs_err {err:.3e} exact {exact}; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
        if not exact:
            _fail(f"stem_pool {tag} is not bit-exact with its plain version")
        if dtype == torch.bfloat16:
            rows["stem_pool_packed"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    def check_attention(label, n, m, pos):
        x = _attention_inputs(gen, 1, n, m, dev)
        if pos:
            args = (x["q"], x["k"], x["v"], x["uk"], x["rois"], x["refs"], x["wk"],
                    x["wb"], x["valid"])
            kern = lambda: ra.flash_relation_attention_pos(*args)  # noqa: E731
            plain = lambda: ra.reference_relation_attention_pos(*args)  # noqa: E731
            tol = ATOL_POS
        else:
            args = (x["q"], x["k"], x["v"], x["uk"], x["valid"])
            kern = lambda: ra.flash_relation_attention(*args)  # noqa: E731
            plain = lambda: ra.reference_relation_attention(  # noqa: E731
                *args[:4], None, args[4])
            tol = ATOL_NONE
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            _fail(f"{label}: non-finite kernel output")
        err = (got - want).abs().max().item()
        ms, plain_ms = _time_pair(plain, kern)
        print(f"[kernels] {label} N={n} M={m}: max_abs_err {err:.3e} "
              f"(atol {tol}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not err <= tol:
            _fail(f"{label}: max_abs_err {err} above atol {tol}")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    # every shape the detect step gives the kernels; a table row carries the
    # first shape's times and the largest error over all of its shapes
    shapes = {
        "flash_relation_attention": [
            ("global enhance", 2175, 750), ("global residual", 300, 750)],
        "flash_relation_attention_pos": [
            ("stage 0", 675, 3750), ("stage 1", 675, 750), ("stage 2", 300, 750)],
    }
    for name, cases in shapes.items():
        pos = name.endswith("_pos")
        mode = "compute" if pos else "none"
        results = [check_attention(f"relation_attention {mode} ({label})", n, m, pos)
                   for label, n, m in cases]
        rows[name] = dict(results[0],
                          max_abs_err=max(r["max_abs_err"] for r in results))

    # lanes: a 2-lane call's lane 0 equals the 1-lane call, in both modes
    x = _attention_inputs(gen, 2, 675, 750, dev)
    one = lambda t: t[:1].contiguous()  # noqa: E731
    for pos in (False, True):
        if pos:
            two = ra.flash_relation_attention_pos(
                x["q"], x["k"], x["v"], x["uk"], x["rois"], x["refs"], x["wk"],
                x["wb"], x["valid"])
            solo = ra.flash_relation_attention_pos(
                one(x["q"]), one(x["k"]), one(x["v"]), one(x["uk"]), one(x["rois"]),
                one(x["refs"]), x["wk"], x["wb"], one(x["valid"]))
        else:
            two = ra.flash_relation_attention(x["q"], x["k"], x["v"], x["uk"], x["valid"])
            solo = ra.flash_relation_attention(one(x["q"]), one(x["k"]), one(x["v"]),
                                               one(x["uk"]), one(x["valid"]))
        same = torch.equal(two[:1], solo)
        print(f"[kernels] lanes {'compute' if pos else 'none'}: B=2 lane 0 == B=1: {same}")
        if not same:
            _fail("a 2-lane call's lane 0 differs from the 1-lane call")

    # all-invalid refs give exact zeros
    none_valid = torch.zeros_like(x["valid"])
    z0 = ra.flash_relation_attention(x["q"], x["k"], x["v"], x["uk"], none_valid)
    z1 = ra.flash_relation_attention_pos(x["q"], x["k"], x["v"], x["uk"], x["rois"],
                                         x["refs"], x["wk"], x["wb"], none_valid)
    zmax = max(z0.abs().max().item(), z1.abs().max().item())
    print(f"[kernels] all-invalid refs: max |out| {zmax}")
    if zmax != 0.0:
        _fail("all-invalid refs did not give exact zeros")
    return rows


def phase_stream():
    import numpy as np
    import torch
    from mega_pytorch_tpu_torch.engine.inference import run_video, synthetic_video
    from mega_pytorch_tpu_torch.models.detectors.mega import build_mega_flagship
    from mega_pytorch_tpu_torch.ops.kernels import relation_attention as ra
    from mega_pytorch_tpu_torch.ops.kernels import stem_pool as sp

    t0 = time.perf_counter()
    model = build_mega_flagship(*CANVAS, device="cuda",
                                generator=torch.Generator("cuda").manual_seed(0))
    frames, gframes = synthetic_video(np.random.RandomState(0), NUM_FRAMES, *CANVAS)
    torch.cuda.synchronize()
    print(f"[stream] built MEGA R-101 bf16 {CANVAS[0]}x{CANVAS[1]} in "
          f"{time.perf_counter() - t0:.1f} s; frames {frames.shape} uint8")

    kernels = (sp.stem_pool_packed, ra.flash_relation_attention,
               ra.flash_relation_attention_pos)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    step_ms, outs = [], []
    t_prev = time.perf_counter()
    for out in run_video(model, frames, gframes):
        torch.cuda.synchronize()
        now = time.perf_counter()
        step_ms.append((now - t_prev) * 1e3)
        t_prev = now
        outs.append(out.dets)
    launches = {k.__name__: k.launches for k in kernels}
    steps = len(outs)
    expect = {"stem_pool_packed": steps, "flash_relation_attention": 2 * steps,
              "flash_relation_attention_pos": 3 * steps}
    print(f"[stream] steps {steps} (40 frames + 12 warm-up); launches {launches}; "
          f"expected {expect}")
    if launches != expect:
        _fail(f"kernel launch counts {launches} != expected {expect}")
    last = outs[-1]
    if tuple(last.boxes.shape) != (1, 300, 4) or tuple(last.scores.shape) != (1, 300):
        _fail(f"detections have shape {tuple(last.boxes.shape)}")
    for d in outs:
        if not (torch.isfinite(d.boxes).all() and torch.isfinite(d.scores).all()):
            _fail("non-finite detections")
    n_valid = int(last.valid.sum())
    steady = step_ms[20:]
    ms = statistics.median(steady)
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"[stream] detections (1, 300) finite; last frame {n_valid} valid, "
          f"top score {last.scores.max().item():.6f}")
    print(f"[stream] steady state (steps 20..{steps - 1}, 1 lane, per-step sync): "
          f"median {ms:.2f} ms/frame, {1e3 / ms:.2f} frames/s, mean "
          f"{statistics.mean(steady):.2f} ms; first step {step_ms[0]:.1f} ms; "
          f"peak memory {peak:.0f} MiB")
    return model, frames, gframes, outs, launches


def phase_determinism(model, frames, gframes, outs):
    import torch
    from mega_pytorch_tpu_torch.engine.inference import run_video

    again = [o.dets for o in islice(run_video(model, frames, gframes), 15)]
    for i, (a, b) in enumerate(zip(outs[:15], again)):
        for name in a._fields:
            if not torch.equal(getattr(a, name), getattr(b, name)):
                _fail(f"re-run step {i}: {name} differs")
    print(f"[determinism] 15 steps re-run from a fresh carry: detections "
          f"bit-identical ({15 * 300} slots)")


def main():
    if not (ROOT / "mega_pytorch_tpu_torch").is_dir():
        _fail("the mega_pytorch_tpu_torch package is not beside this script")
    sys.path.insert(0, str(ROOT))
    name, smi = phase_device()
    phase_build()
    rows = phase_kernels()
    model, frames, gframes, outs, launches = phase_stream()
    phase_determinism(model, frames, gframes, outs)

    import torch

    source = {
        "stem_pool_packed": ("cuda", "mega_pytorch_tpu_torch/csrc/stem_pool.cu",
                             "mega_pytorch_tpu/ops/pallas/stem_pool.py:93"),
        "flash_relation_attention": (
            "cuda", "mega_pytorch_tpu_torch/csrc/relation_attention.cu",
            "mega_pytorch_tpu/ops/pallas/relation_attention.py:712"),
        "flash_relation_attention_pos": (
            "cuda", "mega_pytorch_tpu_torch/csrc/relation_attention.cu",
            "mega_pytorch_tpu/ops/pallas/relation_attention.py:749"),
    }
    table = []
    for kname, (route, src, replaces) in source.items():
        table.append(dict(name=kname, route=route, source=src, replaces=replaces,
                          launches=launches[kname], **rows[kname]))
    print(f"[result] {smi}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
