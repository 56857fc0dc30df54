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
     f32-sinusoid plain version; against the tiled plain version in the
     kernel's arithmetic, 2^-7 max|v| and a mean error of 5e-5), a 2-lane
     call whose lane 0 equals the 1-lane
     call, all-invalid refs giving zeros; mode "input" at the stage-0 shape
     (atol 6e-3) and ``fused_position_bias`` against its f32 plain version
     in weight space (rtol 5e-3, atol 6e-3); at the 12-lane step's shapes
     (B=12) the stem pool, "none" at both of its shapes, "compute" at stages
     0-2 (both tolerances) and "input" at stage 0; a 12-lane call of each
     attention mode whose every lane equals the 1-lane call exactly; each
     with the kernel's and the plain version's time (TF32 off), the bound
     from the card's peak rates and, for "none" and "input", the time of
     ``scaled_dot_product_attention`` on the same inputs;
  4. stream: MEGA R-101 in bf16 at 608x1024 with seeded random weights runs a
     40-frame synthetic video through ``run_video`` (one lane); detections
     must be finite with 300 slots, and every kernel launch count must be
     exactly what the path implies; prints ms/frame, frames/s and peak memory;
  5. determinism: the first 15 steps again from a fresh carry give
     bit-identical detections;
  6. lanes: the same model built for 12 lanes serves 24 synthetic videos of
     12-40 frames from an in-memory dataset through
     ``compute_on_dataset_lockstep``; every frame must be emitted exactly
     once, detections finite with 300 slots, each step must launch 1 stem
     pool, 2 "none" and 3 "compute" kernels whatever the lane count (and no
     "input" or standalone position-bias kernel), and the
     first 15 steps re-run from fresh carries must be bit-identical; prints
     ms/step, frames/s and peak memory;
  7. position-bias paths: ``RelationAttention(pos_emb=...)`` (mode "input")
     against the same module with ``pos_rois`` (mode "compute"), and
     ``fused_position_bias`` against that module's log bias, at the stage-0
     shape.
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

import numpy as np

ROOT = Path(__file__).resolve().parent
CANVAS = (608, 1024)
NUM_FRAMES = 40
LANES, NUM_VIDEOS = 12, 24
ATOL_NONE, ATOL_POS = 6e-3, 2e-2
# mode "compute" against its tiled plain version, which rounds p * pw to
# bf16 where the kernel does: pw differs in its last f32 bits (hardware sine
# and log, sums in another order), which can round a p * pw at a bf16
# boundary to its other neighbour, so the largest error may reach one step
# (2^-7 relative) of a ref that carries a row, 2^-7 max|v|; such steps are
# rare, so the mean error must stay below MEAN_POS_TILED (the kernel's
# mean error against the flat version is ~2e-4 to 4e-4)
MEAN_POS_TILED = 5e-5
RTOL_BIAS, ATOL_BIAS = 5e-3, 6e-3  # fused_position_bias in weight space
TIMING_REPEATS = 25  # timed turns per version
TIMING_INNER = 10  # back-to-back calls per timed turn
# the card's peak rates for bound_ms (NVIDIA H100 SXM data sheet, 700 W);
# special functions (hardware sine, cosine, exp2, log2) issue at 16 a clock
# per SM (CUDA programming guide, compute capability 9.0): 132 SMs at the
# 1.98 GHz boost clock
HBM_BYTES_PER_S, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
SFU_OPS = 132 * 16 * 1.98e9
# kernel launches per detect step on the model path (both lane counts)
PER_STEP = {"stem_pool_packed": 1, "flash_relation_attention": 2,
            "flash_relation_attention_pos": 3, "flash_relation_attention_bias": 0,
            "fused_position_bias": 0}


def _fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _time_pair(plain_fn, kernel_fn, repeats=TIMING_REPEATS):
    """(kernel, plain) median ms per call, the two versions in turns
    (``tools/kernel_bench.time_alternating``)."""
    from mega_pytorch_tpu_torch.tools.kernel_bench import time_alternating

    plain, kernel = time_alternating([plain_fn, kernel_fn], repeats, TIMING_INNER)
    return kernel, plain


def _bound(nbytes, bf16_flops=0.0, f32_ops=0.0, sfu_ops=0.0):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate and
    the operations over their peak rate, each kind on its own units:
    tensor-core bf16 FLOPs, f32 operations on the CUDA cores, and special
    functions on the special function units."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(bf16_flops / BF16_FLOPS, f32_ops / F32_FLOPS, sfu_ops / SFU_OPS) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _attention_bound(mode, x, bias=None):
    """The least time of one attention call on x: each operand read once and
    the f32 output written once; QK and PV (and in mode "compute" the two
    32-deep Wg contractions) on the tensor cores; per (pair, group) the
    scale, mask, max and sum in f32 (+ the bias add, or pw's add, relu,
    + 1e-6 and product with p) and the exp on the special function units,
    which in mode "compute" also take per pair the 2 logs and 32 sinusoids
    of dx/dy."""
    b, g, n, d = x["q"].shape
    pairs = b * n * x["k"].shape[2]
    tensors = [x["q"], x["k"], x["v"], x["uk"], x["valid"]]
    flops, f32, sfu = pairs * g * 4 * d, pairs * g * 4, pairs * g
    if mode == "compute":
        tensors += [x["rois"], x["refs"], x["wk"], x["wb"]]
        flops += pairs * g * 2 * 2 * 32
        f32 += pairs * g * 4
        sfu += pairs * 34
    elif mode == "input":
        tensors.append(bias)
        f32 += pairs * g
    return _bound(_nbytes(*tensors) + b * g * n * d * 4, flops, f32, sfu)


def _library_fn(x, bias=None):
    """scaled_dot_product_attention on x with the mask as a bf16 attn_mask
    (uk / 8 on valid refs, -inf on invalid ones, plus the log bias): the
    function of modes "none" / "input", with bf16 logit terms and output,
    and NaN where a lane has no valid ref. The yardstick of library_ms; the
    port never calls it."""
    import torch
    import torch.nn.functional as F

    mask = torch.where(x["valid"][:, None, None, :], x["uk"][:, :, None, :] * 0.125,
                       float("-inf"))
    if bias is not None:
        mask = mask + bias
    mask = mask.to(torch.bfloat16)
    return lambda: F.scaled_dot_product_attention(x["q"], x["k"], x["v"], attn_mask=mask)


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
    from mega_pytorch_tpu_torch.tools.kernel_bench import attention_inputs

    return attention_inputs(gen, b, n, m, dev, CANVAS)


def _attention_fns(ra, mode, x, bias=None):
    """(kernel call, plain call, atol) of one attention mode on inputs x."""
    if mode == "compute":
        args = (x["q"], x["k"], x["v"], x["uk"], x["rois"], x["refs"], x["wk"],
                x["wb"], x["valid"])
        return (lambda: ra.flash_relation_attention_pos(*args),
                lambda: ra.reference_relation_attention_pos(*args), ATOL_POS)
    base = (x["q"], x["k"], x["v"], x["uk"])
    if mode == "none":
        return (lambda: ra.flash_relation_attention(*base, x["valid"]),
                lambda: ra.reference_relation_attention(*base, None, x["valid"]),
                ATOL_NONE)
    return (lambda: ra.flash_relation_attention_bias(*base, bias, x["valid"]),
            lambda: ra.reference_relation_attention(*base, bias, x["valid"]),
            ATOL_NONE)


def _check_tiled(ra, x, got, label):
    """Mode "compute" output ``got`` against the tiled plain version, lane by
    lane: the largest error within 2^-7 max|v| and the mean within
    MEAN_POS_TILED. Returns (largest, mean, bound)."""
    from mega_pytorch_tpu_torch.tools.kernel_bench import per_lane

    args = (x["q"], x["k"], x["v"], x["uk"], x["rois"], x["refs"], x["wk"], x["wb"],
            x["valid"])
    tiled = per_lane(ra.reference_relation_attention_pos_tiled, args, x["q"].shape[0])
    diff = (got - tiled).abs()
    err, mean = diff.max().item(), diff.mean().item()
    bound = 2.0 ** -7 * x["v"].float().abs().max().item()
    if not (err <= bound and mean <= MEAN_POS_TILED):
        _fail(f"{label}: {err} (mean {mean}) from the tiled plain version, above "
              f"{bound} (mean {MEAN_POS_TILED})")
    return err, mean, bound


def _stage_bias(pb, x):
    """The (B, 16, N, M) f32 log position bias of x's boxes, lane by lane."""
    import torch

    return torch.cat([
        pb.reference_position_bias(x["rois"][i:i + 1], x["refs"][i:i + 1], x["wk"],
                                   x["wb"], 64, sin_dtype=torch.float32)
        for i in range(x["q"].shape[0])]).contiguous()


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
        if dtype == torch.bfloat16:  # bound: bytes in and out, 4 f32 ops an input
            rows["stem_pool_packed"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                **_bound(_nbytes(y, got), f32_ops=4 * y.numel()))

    def check_attention(label, n, m, pos):
        mode = "compute" if pos else "none"
        x = _attention_inputs(gen, 1, n, m, dev)
        kern, plain, tol = _attention_fns(ra, mode, x)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            _fail(f"{label}: non-finite kernel output")
        err = (got - want).abs().max().item()
        ms, plain_ms = _time_pair(plain, kern)
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **_attention_bound(mode, x))
        tiled = ""
        if pos:
            err_t, mean_t, bound_t = _check_tiled(ra, x, got, label)
            row["library_ms"] = None
            tiled = (f", tiled {err_t:.3e} (atol {bound_t:.3e}), mean {mean_t:.2e} "
                     f"(atol {MEAN_POS_TILED})")
        else:
            row["library_ms"] = _time_pair(_library_fn(x), kern)[1]
        print(f"[kernels] {label} N={n} M={m}: max_abs_err {err:.3e} (atol {tol})"
              f"{tiled}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}), library {row['library_ms']}")
        if not err <= tol:
            _fail(f"{label}: max_abs_err {err} above atol {tol}")
        return row

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

    from mega_pytorch_tpu_torch.ops.kernels import position_bias as pb

    # mode "input" at the stage-0 shape, with the log bias the path would add
    x = _attention_inputs(gen, 1, 675, 3750, dev)
    bias = _stage_bias(pb, x)
    args = (x["q"], x["k"], x["v"], x["uk"], bias, x["valid"])
    got = ra.flash_relation_attention_bias(*args)
    want = ra.reference_relation_attention(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        _fail("relation_attention input: non-finite kernel output")
    err = (got - want).abs().max().item()
    ms, plain_ms = _time_pair(lambda: ra.reference_relation_attention(*args),
                              lambda: ra.flash_relation_attention_bias(*args))
    print(f"[kernels] relation_attention input (stage 0) N=675 M=3750, bias "
          f"{bias.numel() * 4 / 1e6:.0f} MB f32: max_abs_err {err:.3e} (atol "
          f"{ATOL_NONE}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    if not err <= ATOL_NONE:
        _fail(f"relation_attention input: max_abs_err {err} above atol {ATOL_NONE}")
    kern = lambda: ra.flash_relation_attention_bias(*args)  # noqa: E731
    rows["flash_relation_attention_bias"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, **_attention_bound("input", x, bias),
        library_ms=_time_pair(_library_fn(x, bias), kern)[1])
    z = ra.flash_relation_attention_bias(*args[:5], torch.zeros_like(x["valid"]))
    print(f"[kernels] all-invalid refs, mode input: max |out| {z.abs().max().item()}")
    if z.abs().max().item() != 0.0:
        _fail("mode input: all-invalid refs did not give exact zeros")

    # the standalone position bias at (675, 3750, g=16), in weight space
    pargs = (x["rois"][0].contiguous(), x["refs"][0].contiguous(), x["wk"], x["wb"])
    got = pb.fused_position_bias(*pargs).exp()
    want = pb.reference_position_bias(*pargs, 64, sin_dtype=torch.float32).exp()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    excess = ((got - want).abs() - (ATOL_BIAS + RTOL_BIAS * want.abs())).max().item()
    ms, plain_ms = _time_pair(
        lambda: pb.reference_position_bias(*pargs, 64, sin_dtype=torch.float32),
        lambda: pb.fused_position_bias(*pargs))
    print(f"[kernels] fused_position_bias (675, 3750, g=16): weight-space "
          f"max_abs_err {err:.3e} (rtol {RTOL_BIAS}, atol {ATOL_BIAS}); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
    if not (torch.isfinite(got).all() and excess <= 0.0):
        _fail("fused_position_bias differs from its plain version beyond tolerance")
    # bound: per pair 4 + 16 logs, 64 sinusoids, 16 x 64 FMAs, 16 bias adds
    # and relus, all f32; the (16, N, M) f32 output written once
    n_pairs = pargs[0].shape[0] * pargs[1].shape[0]
    rows["fused_position_bias"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        **_bound(_nbytes(*pargs, got), f32_ops=n_pairs * (20 + 64 + 2 * 1024 + 32)))

    # the path's kernels at the 12-lane step's shapes (2 x 12 frames, B=12)
    y = (torch.randn(2 * LANES, 152, 256, 256, generator=gen, device=dev) * 2
         ).to(torch.bfloat16)
    scale = torch.rand(256, generator=gen, device=dev) + 0.5
    shift = torch.randn(256, generator=gen, device=dev)
    exact = torch.equal(sp.stem_pool_packed(y, scale, shift, 64),
                        sp.stem_pool_packed_reference(y, scale, shift, 64))
    ms, plain_ms = _time_pair(lambda: sp.stem_pool_packed_reference(y, scale, shift, 64),
                              lambda: sp.stem_pool_packed(y, scale, shift, 64), repeats=5)
    bound = _bound(_nbytes(y) + y.numel() // 4 * y.element_size(), f32_ops=4 * y.numel())
    print(f"[kernels] {LANES} lanes: stem_pool bf16 ({2 * LANES},152,256,256): exact "
          f"{exact}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
    if not exact:
        _fail("stem_pool is not bit-exact at the 12-lane shape")
    del y
    for mode, label, n, m in (("none", "global enhance", 2175, 750),
                              ("none", "global residual", 300, 750),
                              ("compute", "stage 0", 675, 3750),
                              ("compute", "stage 1", 675, 750),
                              ("compute", "stage 2", 300, 750),
                              ("input", "stage 0", 675, 3750)):
        x = _attention_inputs(gen, LANES, n, m, dev)
        bias = _stage_bias(pb, x) if mode == "input" else None
        kern, plain, tol = _attention_fns(ra, mode, x, bias)
        got = kern()
        err = (got - plain()).abs().max().item()
        if not torch.isfinite(got).all():
            _fail(f"relation_attention {mode} ({label}) at B={LANES}: non-finite")
        tiled = ""
        if mode == "compute":
            err_t, mean_t, bound_t = _check_tiled(ra, x, got, f"compute ({label}) B={LANES}")
            tiled = (f", tiled {err_t:.3e} (atol {bound_t:.3e}), mean {mean_t:.2e} (atol "
                     f"{MEAN_POS_TILED})")
        ms, plain_ms = _time_pair(plain, kern, repeats=5)
        bound = _attention_bound(mode, x, bias)
        print(f"[kernels] {LANES} lanes: relation_attention {mode} ({label}) B={LANES} "
              f"N={n} M={m}: max_abs_err {err:.3e} (atol {tol}){tiled}; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']})")
        if not err <= tol:
            _fail(f"relation_attention {mode} ({label}) at B={LANES}: max_abs_err {err}")
        del x, bias, got, kern, plain

    # 12 lanes: every lane of a B=12 call equals the B=1 call on its data
    x = _attention_inputs(gen, LANES, 300, 750, dev)
    x["valid"][3] = False  # one lane with no valid ref
    bias = _stage_bias(pb, x)

    def call(mode, sl):
        def t(name):
            return (bias if name == "bias" else x[name])[sl].contiguous()
        if mode == "none":
            return ra.flash_relation_attention(t("q"), t("k"), t("v"), t("uk"),
                                               t("valid"))
        if mode == "compute":
            return ra.flash_relation_attention_pos(
                t("q"), t("k"), t("v"), t("uk"), t("rois"), t("refs"), x["wk"],
                x["wb"], t("valid"))
        return ra.flash_relation_attention_bias(t("q"), t("k"), t("v"), t("uk"),
                                                t("bias"), t("valid"))

    for mode in ("none", "compute", "input"):
        batched = call(mode, slice(None))
        same = all(torch.equal(batched[i:i + 1], call(mode, slice(i, i + 1)))
                   for i in range(LANES))
        print(f"[kernels] lanes {mode}: every lane of B={LANES} == its B=1 call: "
              f"{same}")
        if not same:
            _fail(f"mode {mode}: a {LANES}-lane call differs from its 1-lane calls")
    return rows


def phase_stream():
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


class _Canvas:
    """What the preprocessor hands the engine: a uint8 canvas and its size."""

    def __init__(self, image):
        self.image = image
        self.size = np.array(image.shape[:2], np.float32)


class _Preprocessor:
    """In-memory stand-in: frames already are full canvases."""

    def _prep_u8(self, img, flip):
        return _Canvas(img)


class _SyntheticVideos:
    """In-memory stand-in for the VID dataset, with the duck-typed API the
    lockstep engine reads. Video v has ``lengths[v]`` frames; frames come
    from a pool of random uint8 canvases; the global refs of a video follow a
    fixed permutation of its frames (global_size of them on frame 0, then one
    per frame), as the MEGA dataset's shuffled schedule does."""

    def __init__(self, lengths, rs, canvas, global_size=10, pool=32):
        self.pool = rs.randint(0, 256, (pool, *canvas, 3), dtype=np.uint8)
        self.lengths = list(lengths)
        self.image_set_index, self.pattern, self.frame_seg_len = [], [], []
        self.first = []
        for v, n in enumerate(self.lengths):
            for f in range(n):
                self.first.append(len(self.image_set_index) - f)
                self.image_set_index.append(f"val/v{v:03d}/{f:06d}")
                self.pattern.append(f"val/v{v:03d}/%06d")
                self.frame_seg_len.append(n)
        self.perm = [rs.permutation(n) for n in self.lengths]
        self.global_size = global_size
        self.info_calls = np.zeros(len(self.image_set_index), np.int64)

    def _video(self, pattern):
        return int(pattern.split("/")[1][1:])

    def load_frame(self, pattern, fid):
        return self.pool[(7 * self._video(pattern) + fid) % len(self.pool)]

    def global_ref_ids(self, idx):
        v = self._video(self.pattern[idx])
        f = idx - self.first[idx]
        count = self.global_size if f == 0 else 1
        return [int(self.perm[v][(f + j) % self.lengths[v]]) for j in range(count)]

    def get_img_info(self, idx):
        self.info_calls[idx] += 1  # once per emission of frame idx
        return {"height": self.pool.shape[1], "width": self.pool.shape[2]}


def run_lanes(model, ds, lanes, dev):
    """Serve ``ds`` through ``compute_on_dataset_lockstep`` with ``lanes``
    lanes and check the run; returns (per-step ms, emissions per step,
    launches, launches per step as measured, run seconds). Device-agnostic,
    so it also runs on the CPU."""
    import torch
    from mega_pytorch_tpu_torch.engine import batched_inference as bi
    from mega_pytorch_tpu_torch.ops.kernels import relation_attention as ra
    from mega_pytorch_tpu_torch.ops.kernels import stem_pool as sp

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    from mega_pytorch_tpu_torch.ops.kernels import position_bias as pb

    # every kernel, those no model path launches too, so that their 0 per
    # step is measured as well
    kernels = (sp.stem_pool_packed, ra.flash_relation_attention,
               ra.flash_relation_attention_pos, ra.flash_relation_attention_bias,
               pb.fused_position_bias)
    per_step = {k.__name__: PER_STEP[k.__name__] for k in kernels}
    if dev.type != "cuda":  # plain versions: no launches
        per_step = dict.fromkeys(per_step, 0)
    slots = model.c.detections_per_img
    record = dict(ms=[], dets=[], inputs=[], emitted=[], bad_counts=[],
                  finite=torch.ones((), dtype=torch.bool, device=dev))
    make_step = bi.make_lockstep_step

    def recording_make_step(m):
        step = make_step(m)

        def run(carries, *inputs):
            before = {k.__name__: k.launches for k in kernels}
            t = time.perf_counter()
            carries, dets = step(carries, *inputs)
            sync()
            record["ms"].append((time.perf_counter() - t) * 1e3)
            delta = {k.__name__: k.launches - before[k.__name__] for k in kernels}
            if delta != per_step:
                record["bad_counts"].append((len(record["ms"]) - 1, delta))
            if tuple(dets.boxes.shape) != (lanes, slots, 4):
                _fail(f"lockstep detections have shape {tuple(dets.boxes.shape)}")
            record["finite"] = record["finite"] & torch.isfinite(dets.boxes).all() \
                & torch.isfinite(dets.scores).all()
            record["emitted"].append(int(inputs[-1].sum()))
            if len(record["dets"]) < 15:
                record["inputs"].append([a.clone() for a in inputs])
                record["dets"].append([d.clone() for d in dets])
            return carries, dets
        return run

    for k in kernels:
        k.launches = 0
    bi.make_lockstep_step = recording_make_step
    try:
        t0 = time.perf_counter()
        results = bi.compute_on_dataset_lockstep(
            model, ds, range(len(ds.image_set_index)), _Preprocessor(), lanes=lanes)
        wall = time.perf_counter() - t0
    finally:
        bi.make_lockstep_step = make_step
    launches = {k.__name__: k.launches for k in kernels}
    steps = len(record["ms"])
    n_frames = len(ds.image_set_index)
    print(f"[lanes] {steps} steps of {lanes} lanes; launches {launches}; per step "
          f"{per_step} expected, steps that differ: {record['bad_counts'][:3]}")
    if record["bad_counts"] or steps == 0:
        _fail(f"lockstep kernel launch counts per step differ from {per_step}")
    once = bool((ds.info_calls == 1).all()) and sorted(results) == list(range(n_frames))
    print(f"[lanes] frames emitted exactly once: {once} ({len(results)} of "
          f"{n_frames}; {sum(record['emitted'])} emissions)")
    if not once or sum(record["emitted"]) != n_frames:
        _fail("not every frame was emitted exactly once")
    if not bool(record["finite"]):
        _fail("non-finite lockstep detections")
    for r in results.values():
        if len(r["boxes"]) > slots or not np.isfinite(r["boxes"]).all():
            _fail(f"an extracted prediction has more than {slots} or non-finite boxes")

    # the first 15 steps again, from fresh carries, bit for bit
    step = make_step(model)
    carries = model.zero_carry(lanes, dev)
    for i, (inputs, want) in enumerate(zip(record["inputs"], record["dets"])):
        carries, dets = step(carries, *inputs)
        for name, a, b in zip(dets._fields, dets, want):
            if not torch.equal(a, b):
                _fail(f"lockstep re-run step {i}: {name} differs")
    print(f"[lanes] determinism: {len(record['dets'])} steps re-run from fresh "
          f"carries: detections bit-identical ({len(record['dets']) * lanes * slots} "
          f"slots)")
    return record["ms"], record["emitted"], launches, per_step, wall


def phase_lanes(smi):
    import torch
    from mega_pytorch_tpu_torch.models.detectors.mega import build_mega_flagship

    t0 = time.perf_counter()
    model = build_mega_flagship(*CANVAS, device="cuda", lanes=LANES,
                                generator=torch.Generator("cuda").manual_seed(0))
    rs = np.random.RandomState(0)
    lengths = rs.randint(12, 41, NUM_VIDEOS)
    ds = _SyntheticVideos(lengths, rs, CANVAS)
    torch.cuda.synchronize()
    print(f"[lanes] built MEGA R-101 bf16 {CANVAS[0]}x{CANVAS[1]} for "
          f"{model.lanes} lanes in {time.perf_counter() - t0:.1f} s; {NUM_VIDEOS} "
          f"videos of {lengths.min()}-{lengths.max()} frames, {lengths.sum()} frames")
    torch.cuda.reset_peak_memory_stats()
    step_ms, emitted, launches, per_step, wall = run_lanes(model, ds, model.lanes,
                                                           torch.device("cuda"))
    peak = torch.cuda.max_memory_allocated() / 2**20
    steady = step_ms[5:]
    ms = statistics.median(steady)
    full = [t for t, e in zip(step_ms[5:], emitted[5:]) if e == LANES]
    n_frames = len(ds.image_set_index)
    print(f"[lanes] steady state (steps 5..{len(step_ms) - 1}, {LANES} lanes, "
          f"per-step sync): median {ms:.2f} ms/step = {LANES * 1e3 / ms:.2f} "
          f"lane-steps/s; {len(full)} steps with all {LANES} lanes emitting, median "
          f"{statistics.median(full) if full else float('nan'):.2f} ms/step = "
          f"{LANES * 1e3 / statistics.median(full) if full else float('nan'):.2f} "
          f"frames/s; first step {step_ms[0]:.1f} ms; {smi}")
    print(f"[lanes] whole run: {n_frames} frames emitted in {wall:.2f} s = "
          f"{n_frames / wall:.2f} frames/s (warm-up steps and idle tail "
          f"included); peak memory {peak:.0f} MiB; {smi}")
    return launches, per_step


def phase_position_bias_paths():
    """The two kernels no model path launches, through their own entry
    points: RelationAttention(pos_emb=...) launches mode "input"; the
    standalone bias is its own entry point. Counts are read around this."""
    import torch
    from mega_pytorch_tpu_torch.models.roi_heads.attention import (
        RelationAttention,
        position_embedding,
    )
    from mega_pytorch_tpu_torch.ops.kernels import position_bias as pb
    from mega_pytorch_tpu_torch.ops.kernels import relation_attention as ra

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(1)
    att = RelationAttention(1024, 64, 16, True, torch.bfloat16, dev)
    for m in att.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(gen)
    att.Wg.bias.data.fill_(0.05)
    for m in att.modules():
        if hasattr(m, "cast_weights_"):
            m.cast_weights_()
    att.eval().requires_grad_(False)
    x = _attention_inputs(gen, 1, 675, 3750, dev)
    roi = torch.randn(1, 675, 1024, generator=gen, device=dev)
    ref = torch.randn(1, 3750, 1024, generator=gen, device=dev)
    with torch.inference_mode():
        emb = position_embedding(x["rois"], x["refs"])  # (1, 675, 3750, 64) f32
        computed = att(roi, ref, x["valid"], pos_rois=(x["rois"], x["refs"]))
        kernels = (ra.flash_relation_attention_bias, pb.fused_position_bias)
        for k in kernels:
            k.launches = 0
        got = att(roi, ref, x["valid"], pos_emb=emb)
        bias = pb.fused_position_bias(x["rois"][0].contiguous(), x["refs"][0].contiguous(),
                                      att.Wg.kernel.float().contiguous(),
                                      att.Wg.bias.float().contiguous())
        launches = {k.__name__: k.launches for k in kernels}
        pw = (emb[0] @ att.Wg.kernel.float() + att.Wg.bias.float()).clamp_min(0.0)
        weight_err = (bias.exp() - (pw + 1e-6).permute(2, 0, 1)).abs().max().item()
    err = (got - computed).abs().max().item()
    print(f"[paths] RelationAttention pos_emb (mode input) vs pos_rois (mode "
          f"compute), N=675 M=3750: max_abs_err {err:.3e} (atol {ATOL_POS}); "
          f"fused_position_bias vs the module's pos_emb weight: {weight_err:.3e} "
          f"(atol {ATOL_BIAS}); launches {launches}")
    if not err <= ATOL_POS or not weight_err <= ATOL_BIAS:
        _fail("the position-bias paths disagree")
    if launches != {"flash_relation_attention_bias": 1, "fused_position_bias": 1}:
        _fail(f"position-bias path launch counts {launches}")
    return launches


def main():
    if not (ROOT / "mega_pytorch_tpu_torch").is_dir():
        _fail("the mega_pytorch_tpu_torch package is not beside this script")
    sys.path.insert(0, str(ROOT))
    name, smi = phase_device()
    phase_build()
    rows = phase_kernels()
    model, frames, gframes, outs, launches = phase_stream()
    phase_determinism(model, frames, gframes, outs)
    del model, frames, gframes, outs

    import torch

    torch.cuda.empty_cache()
    lane_launches, per_step = phase_lanes(smi)
    path_launches = phase_position_bias_paths()

    source = {
        "stem_pool_packed": ("cuda", "mega_pytorch_tpu_torch/csrc/stem_pool.cu",
                             "mega_pytorch_tpu/ops/pallas/stem_pool.py:93"),
        "flash_relation_attention": (
            "cuda", "mega_pytorch_tpu_torch/csrc/relation_attention.cu",
            "mega_pytorch_tpu/ops/pallas/relation_attention.py:712"),
        "flash_relation_attention_pos": (
            "cuda", "mega_pytorch_tpu_torch/csrc/relation_attention.cu",
            "mega_pytorch_tpu/ops/pallas/relation_attention.py:749"),
        "flash_relation_attention_bias": (
            "cuda", "mega_pytorch_tpu_torch/csrc/relation_attention.cu",
            "mega_pytorch_tpu/ops/pallas/relation_attention.py:519"),
        "fused_position_bias": (
            "cuda", "mega_pytorch_tpu_torch/csrc/position_bias.cu",
            "mega_pytorch_tpu/ops/pallas/position_bias.py:112"),
    }
    # launches: the model path's kernels count in the lanes run (phase 6);
    # the two kernels no model path reaches count in their own path (phase 7);
    # launches_per_step is what every step of the lanes run launched
    counts = {**lane_launches, **path_launches}
    print(f"[result] launches per kernel: stream (1 lane) {launches}; lanes "
          f"({LANES}) {lane_launches}; position-bias paths {path_launches}")
    table = []
    for kname, (route, src, replaces) in source.items():
        table.append(dict(name=kname, route=route, source=src, replaces=replaces,
                          launches=counts[kname], launches_per_step=per_step[kname],
                          **rows[kname]))
    print(f"[result] {smi}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
