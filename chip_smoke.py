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
     ``scaled_dot_product_attention`` on the same inputs; ROIAlign at MEGA's
     key and global calls and FGFA's call (bf16 maps into bf16, within 1e-5
     of the largest magnitude in f32), with its time, the plain version's
     and its byte bound (no library yardstick: no torchvision); the
     bottleneck epilogue at MEGA's 24 maps of each stage (bit for bit the
     plain version), with its time, the plain version's, the unfolded tail's
     and its byte bound;
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
     pool, 2 "none", 3 "compute", 2 ROIAlign kernels and 99 bottleneck
     epilogues (the C4 body's 90, res5's 9) whatever the lane count (and no
     "input" or standalone position-bias kernel), and the
     first 15 steps re-run from fresh carries must be bit-identical; prints
     ms/step, frames/s and peak memory;
  7. position-bias paths: ``RelationAttention(pos_emb=...)`` (mode "input")
     against the same module with ``pos_rois`` (mode "compute"), and
     ``fused_position_bias`` against that module's log bias, at the stage-0
     shape;
  8. RDN kernels: mode "compute" with uk = 0 (RDN's attention has no u bias)
     at RDN's three shapes, (300, 2775), (555, 2775) and (300, 555), at B=1
     and B=4, against both plain versions (as in phase 3), every lane of B=4
     equal to its B=1 call; the stem pool at RDN's launch (4 frames); times,
     bounds and shares;
  9. methods: RDN (2 base stages and the advanced stage), FGFA and DFF (key
     interval 10), each R-101 in bf16 at 608x1024 with seeded random
     weights, built for 4 lanes, serve 8 synthetic videos of 12-40 frames
     through ``compute_on_dataset_lockstep``; every frame must be emitted
     exactly once with finite boxes, each step must launch exactly RDN's 1
     stem pool, 4 "compute" and 1 ROIAlign kernels (FGFA and DFF: 1
     ROIAlign) and 99 bottleneck epilogues (DFF's non-key steps: res5's
     9), and the
     first 15 steps re-run from fresh carries must be bit-identical; prints
     ms/step, frames/s and peak memory;
  10. base: the single-frame detector's ``forward_test`` on 4 packed frames
     launches the stem pool and ROIAlign once a call and gives finite
     detections; its
     stem on s2d(2)-packed frames of the canvas launches no kernel and in
     f32 equals the canonical branch within 1e-4 + 1e-5 max|out|;
  11. eval path: the evaluation entry point's code over a synthetic
     ILSVRC2015 tree written to a temporary directory (index, XML
     annotations; 12 videos of 10-20 frames of 720x1280, two portrait) whose
     dataset, the port's ``VIDMEGADataset``, draws its frames instead of
     decoding files: MEGA R-101 from the ``mega_R_101`` preset (no channel
     reduce) with 12 lanes through ``compute_on_dataset`` (resize, global
     schedule, ``video_shards``), each step launching what phase 6's do,
     every frame predicted once with finite boxes inside its image, the
     first 15 steps re-run bit for bit, ``evaluate_predictions`` with a
     synthetic motion-IoU table (finite AP50 in the four buckets; random
     weights make the values meaningless) and ``write_result``; then base
     R-101 through the serial engine over the 10-frame first video (f32
     canvases packed s2d(4) by ``pack_factor``: one stem pool launch a
     frame, nothing else). Prints the host resize's
     ms a frame, the whole run's frames/s and ms/step, and the producer's
     time a batch against the step;
  12. train kernels: modes "none" and "input" through their autograd
     Functions at every shape of a MEGA and of an RDN training iteration
     (two lanes, one with no valid ref): one launch, within 6e-3 of the
     tiled plain version, zeros on the empty lane, gradients equal to
     autograd through the plain version bit for bit; times at one lane;
  13. train: MEGA R-101 training through ``tools/train_net.py``'s ``main``
     (the ``mega_R_101`` preset: bf16 compute, f32 master weights, the
     608x1024 canvas, one sample an iteration of cur + 2 local, 3 memory and
     2 global frames) over a synthetic on-disk ILSVRC2015 train tree (VID
     videos in the VID_train_15frames form and DET stills, two
     orientations, frames drawn) for 14 iterations with a checkpoint at 7:
     finite losses, every trainable group moved by the first step, frozen
     parameters and buffers bit-identical, 3 "none" and 5 "input" launches
     (and no other kernel) every iteration, and the checkpoint restoring
     into a fresh model, optimizer and scheduler bit for bit. Prints ms an
     iteration, samples/s, the producer's ms an iteration and peak memory;
  14. method training: RDN (``rdn_R_101``, the advanced stage, 4 samples an
     iteration of cur + 2 refs in turn), FGFA (``fgfa_R_101``) and DFF
     (``dff_R_101``) through ``train_net``'s ``main`` over the same tree, 6
     iterations each with a checkpoint at 3: the checks of phase 13, every
     trainable module moved by the first step (FlowNetS and the embedding
     net included), 16 "input" launches every RDN iteration and none for
     FGFA and DFF;
  15. ddp: a one-rank NCCL process group and ``DistributedDataParallel``
     (``tools/ddp_check.py``): two ``rdn_R_101`` iterations through
     ``train_step`` on the wrapped model (``no_sync`` on the first three
     samples of each) against the same iterations through the plain step,
     run twice for the card's own spread and once with the last sample
     left out (a planted fault); each tensor's update in two DDP runs (the
     second warm) within max(1e-5, 8x the spread) of the plain one's,
     relative to its largest, and the fault above that bound;
  16. pos function: mode "compute" through its autograd Function at one
     lane of MEGA stage 0 (675, 3750) and of RDN's base stages (300, 2775,
     uk = 0), Wg's bias raised by 2: one launch, the forward bit for bit
     the kernel's, the eight gradients within 1e-6 of each leaf's largest
     magnitude from autograd through the bf16-sinusoid plain version;
     forward and backward times;
  17. tta: base R-101 (bf16) through ``tools/test_net.py``'s ``main`` with
     ``TEST.BBOX_AUG`` (scales 400-1200 and the base size, each flipped:
     18 runs a frame) over 3 JPEG frames of 720x1280 on disk: the run
     count, the detection cap, boxes inside the image, 18 stem pool
     launches in every frame and no other kernel; ms a warm frame (the
     first, which meets 18 new canvas shapes, left out), split into the
     host's preprocessing, the detector runs and the rest;
  18. demo: ``tools/demo.py``'s ``main`` with ``mega_R_101`` (bf16,
     608x1024, packed) over 12 JPEG frames of 720x1280: 12 annotated frames
     of the input size written, detections bit for bit those of
     ``StreamingInferencer`` on the same frames, the stem pool, "none" and
     "compute" launched; ms a frame, split into the serial engine's steps
     and the rest;
  19. gn: ``base_R_50`` with group norm (bf16, packed frames) against
     itself in f32 on RGB frames, and its f32 packed route against the
     canonical one; no stem pool launch and no bottleneck epilogue; an
     R-101 32x8d C4 body (``build_resnet_c4``, frozen BN, grouped 3x3
     convolutions) timed, 90 epilogues a pass;
  20. native loader, information only: whether ``data/native_loader.py``
     builds here (g++, libjpeg) and why not; if it does, ``load_batch``
     equal to ``load_frame`` frame by frame and both timed beside the PIL
     path;
  21. zoo: at published widths in bf16 with random weights, R-50-FPN
     (``ResNetFPNBody`` and ``FPN`` with the max-pool top block, P2-P6, on 2
     s2d(4)-packed 800x1344 canvases of 720x1280 frames resized by
     MIN_SIZE_TEST 800 / MAX_SIZE_TEST 1333: exactly 1 stem pool launch),
     RetinaNet R-50-FPN (80 classes, 9 anchors, 4 convs; P3-P7 with "p6p7"
     from C5; ``retinanet_inference`` per image, 1000 / 0.05 / 0.4 / 100),
     ``CombinedROIHeads`` on P2 (``mask_probs`` of 100 detections,
     ``mask_losses`` of 128 ROIs over 16 dense GT masks, ``keypoint_logits``
     of 100 ROIs an image), FBNet's default arch with its rpn, bbox and mask
     groups on one frame, each timed; ROIPool, DFConv2d v1 / v2 and the
     deformable ROI pooling modules at full width with their peak memory;
     finite outputs and boxes inside the image; each piece at 128x192 in
     f32 (TF32 off) on the card against the same module on the CPU within
     1e-4 of the largest magnitude, RetinaNet's keep sets equal; the folded
     stem pool (``frame_rows``) on 24 frames bit for bit the unfolded
     kernel and its plain version, the folded stem timed against the
     unfolded one;
  22. classic head and MFU: a synthetic full-width R-101 Detectron pickle
     (protocol 2, the AffineChannel scales and biases, momentum and fc1000
     blobs) loaded by ``load_c2_weights`` into ``mega_R_101`` on the card,
     every backbone and res5 tensor equal to its blob and the stem on a
     packed frame bit for bit that of a model given the weights by
     ``load_state_dict``; the base R-101 C4 body with res2-res5 from that
     pickle on one packed 608x1024 frame (1 stem pool launch), then 300
     proposals through ``ResNet50Conv5ROIFeatureExtractor`` and
     ``FastRCNNPredictor`` in bf16, ms and peak memory, and the same
     modules in f32 at 128x192 on the card against the CPU within 1e-4;
     ``tools/profile_mfu.py``'s FLOP count of one MEGA step (1 lane,
     320x512, f32) equal on the CPU and on the card, then the 12-lane MEGA
     step and one ``mega_R_101`` training iteration counted (with the
     launches of the counted step, as phases 6 and 13 require) and timed:
     GFLOP a step, ms, achieved TFLOP/s and MFU against 989 TFLOP/s.
Each phase prints its seconds. The last two lines are the kernel table and
the device record as JSON. Any failed check raises, and the script exits
non-zero.
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
# the s2d(2) stem against the canonical one in f32 (TF32 off): the same sums
# of 147 products in another order by cuDNN's algorithms, so ATOL_STEM plus
# RTOL_STEM times the largest output
ATOL_STEM, RTOL_STEM = 1e-4, 1e-5
TIMING_REPEATS = 25  # timed turns per version
TIMING_INNER = 10  # back-to-back calls per timed turn
# the card's peak rates for bound_ms (NVIDIA H100 SXM data sheet, 700 W);
# special functions (hardware sine, cosine, exp2, log2) issue at 16 a clock
# per SM (CUDA programming guide, compute capability 9.0): 132 SMs at the
# 1.98 GHz boost clock
HBM_BYTES_PER_S, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
SFU_OPS = 132 * 16 * 1.98e9
# lockstep lanes and videos of the methods phase (the JAX package's
# tools/bench_methods.py runs 4 lanes)
METHOD_LANES, METHOD_VIDEOS = 4, 8
DFF_KEY_INTERVAL = 10
# the eval path: on-disk synthetic videos of VID's 720p frames
EVAL_VIDEOS, EVAL_FRAME = 12, (720, 1280)
# RDN's attention shapes: (N, M) of base stages 0-1, the advanced stage and
# the final stage (37 window frames of 75 refs, 15 of them distilled)
RDN_SHAPES = (("base stages", 300, 2775), ("advanced stage", 555, 2775),
              ("final stage", 300, 555))
# MEGA R-101 training (phase 13): iterations, the checkpoint's iteration;
# the synthetic train tree's videos (frame counts; 15 frames of each
# indexed) and DET stills, at VID's 720p
TRAIN_ITERS, TRAIN_CKPT = 14, 7
TRAIN_VIDEOS, TRAIN_STILLS, TRAIN_FRAME = (40, 60, 30, 50, 45, 35), 4, (720, 1280)
# the (N, M) of each attention call of a training iteration (ROI batch 128,
# 75 refs a frame and 15 distilled; cur + 2 local, 3 memory, 2 global
# frames; one global residual stage)
TRAIN_ATTENTION = {
    "flash_relation_attention": [("memory global", 225, 150),
                                 ("key + local global", 353, 150),
                                 ("global residual", 128, 150)],
    "flash_relation_attention_bias": [("memory stage 0", 45, 225), ("memory stage 1", 45, 45),
                                      ("local stage 0", 173, 450), ("local stage 1", 173, 90),
                                      ("local stage 2", 128, 90),
                                      # RDN training (ROI batch 128; cur + 2 refs of 75,
                                      # 15 of each distilled): base stages, advanced
                                      # stage, final stage
                                      ("rdn base stages", 128, 225),
                                      ("rdn advanced stage", 45, 225),
                                      ("rdn final stage", 128, 45)],
}
# kernel launches per engine step on each path (any lane count); every
# kernel is listed, so that its 0 is measured too
_NO_KERNEL = {"stem_pool_packed": 0, "flash_relation_attention": 0,
              "flash_relation_attention_pos": 0, "flash_relation_attention_bias": 0,
              "fused_position_bias": 0, "roi_align": 0, "bottleneck_epilogue": 0}
# bottleneck epilogues of one pass of a bf16 frozen-BN body in eval mode,
# three a block: the R-101 C4 body's 30 blocks, a res5 head's 3, an R-50
# FPN body's 16 (training, f32 and group norm launch none)
EPI_C4, EPI_RES5, EPI_R50_FPN = 90, 9, 48
EPI_PASS = EPI_C4 + EPI_RES5
# ROIAlign: MEGA pools the key frames' and the global frames' proposals (the
# refs are the key set's first 75), RDN the key set, FGFA and DFF the box
# head's proposals; every method runs the C4 body once a step (over all its
# frames) and res5 once, but DFF's non-key steps run res5 alone
PER_STEP = {
    "mega": dict(_NO_KERNEL, stem_pool_packed=1, flash_relation_attention=2,
                 flash_relation_attention_pos=3, roi_align=2, bottleneck_epilogue=EPI_PASS),
    "rdn": dict(_NO_KERNEL, stem_pool_packed=1, flash_relation_attention_pos=4, roi_align=1,
                bottleneck_epilogue=EPI_PASS),
    "fgfa": dict(_NO_KERNEL, roi_align=1, bottleneck_epilogue=EPI_PASS),
    "dff": dict(_NO_KERNEL, roi_align=1, bottleneck_epilogue=EPI_PASS),
}
DFF_NON_KEY_STEP = dict(PER_STEP["dff"], bottleneck_epilogue=EPI_RES5)
# a training iteration: the canonical stem on RGB frames (no stem pool),
# the position bias in plain f32 into mode "input", no "compute"; ROIAlign
# of the global, memory, key and local pools
PER_ITER_TRAIN = dict(_NO_KERNEL, flash_relation_attention=3, flash_relation_attention_bias=5,
                      roi_align=4)
# RDN, FGFA and DFF training (phase 14): iterations and the checkpoint's
# iteration; per iteration, RDN's IMS_PER_BATCH 4 samples each launch
# "input" at its 2 base stages, the advanced stage and the final stage, and
# ROIAlign of the key ROIs and of the refs; FGFA and DFF reach ROIAlign
# alone, once for the box head (RGB frames, no attention)
METHOD_TRAIN_ITERS, METHOD_TRAIN_CKPT = 6, 3
METHOD_TRAIN = {
    "rdn": ("rdn_R_101", "VIDRDNDataset",
            dict(_NO_KERNEL, flash_relation_attention_bias=16, roi_align=8)),
    "fgfa": ("fgfa_R_101", "VIDFGFADataset", dict(_NO_KERNEL, roi_align=1)),
    "dff": ("dff_R_101", "VIDDFFDataset", dict(_NO_KERNEL, roi_align=1)),
}
# the one-rank NCCL DDP step (phase 15): iterations of rdn_R_101 against
# the plain step (tools/ddp_check.py states the bound)
DDP_ITERS = 2
# the "compute" Function (phase 16), one lane: (label, N, M, u bias)
POS_FUNCTION_SHAPES = (("MEGA stage 0", 675, 3750, True), ("RDN base stages", 300, 2775, False))
# its gradients against autograd through the bf16-sinusoid plain version,
# which its backward recomputes on the same operands: equal to the last bit
# unless the library takes another algorithm for a product; 1e-6 of each
# leaf's largest magnitude
RTOL_POS_GRAD = 1e-6
# test-time augmentation through test_net (phase 17): maskrcnn-benchmark's
# TTA example scales, each run plain and flipped with the base size: 18
# detector runs a frame
TTA_SCALES = (400, 500, 600, 700, 900, 1000, 1100, 1200)
TTA_FRAMES, TTA_RUNS = 3, 2 + 2 * len(TTA_SCALES)
# the frame-folder demo (phase 18) and the native loader (phase 20)
DEMO_FRAMES = 12
# the GN R-50 C4 body (phase 19) on packed frames against itself in f32 on
# RGB frames (TF32 off). In f32 the two stem routes are the same sums in
# another order: RTOL_GN_F32 of the largest magnitude. In bf16, 8 bits
# (2^-9 relative rounding) at each of ~40 convolutions and norms add up
# through 13 residual blocks: on the CPU at 160x256 the bf16 body sat
# 2.7e-2 to 4.6e-2 of the largest magnitude (largest error) and 3.3e-2 to
# 3.7e-2 of the mean magnitude (mean error) from the f32 one, so the bounds
# are about twice those
RTOL_GN_F32, RTOL_GN_MAX, RTOL_GN_MEAN = 1e-4, 1e-1, 6e-2
# the detector zoo (phase 21): maskrcnn-benchmark's e2e_*_R_50_FPN_1x test
# sizes, MIN_SIZE_TEST 800 / MAX_SIZE_TEST 1333 on an 800x1344 canvas (size
# divisibility 32): ZOO_FRAMES drawn 720x1280 frames resized to 750x1333;
# each piece also at ZOO_SMALL in f32 on the card against the CPU, within
# RTOL_ZOO of the largest magnitude (f32 sums in another order, TF32 off)
ZOO_FRAMES, ZOO_FRAME, ZOO_SIZES, ZOO_CANVAS = 2, (720, 1280), (800, 1333), (800, 1344)
ZOO_SMALL, RTOL_ZOO = (128, 192), 1e-4
# phase 22: proposals through the classic C4 head (maskrcnn-benchmark's
# POST_NMS_TOP_N_TEST at one image); the MFU tool's step counted on the CPU
# and on the card at MFU_SMALL (one lane, f32: 20x32x15 anchors, above the
# RPN's 6000), then its 12-lane step and a training iteration, each after
# MFU_WARMUP steps and timed over MFU_ITERS
CLASSIC_ROIS = 300
MFU_SMALL, MFU_WARMUP, MFU_ITERS = (320, 512), 3, 5


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


def _position_bias_bound(pargs, out):
    """(bound, old count) of one fused_position_bias call: each operand read
    once and the (16, N, M) f32 output written once; per pair the Wg
    contraction (2 x 64 x 16 FLOPs) on the tensor cores, the 2 logs of dx/dy,
    their 32 sinusoids and the 16 output logs on the special function units,
    and per (pair, group) the bias add, relu and + 1e-6 in f32, as
    _attention_bound counts the position weight of mode "compute". The old
    count, the f32 kernel's, put the contraction on the CUDA cores: per pair
    4 + 16 logs, 64 sinusoids, 16 x 64 FMAs and 16 bias adds and relus."""
    n_pairs = pargs[0].shape[0] * pargs[1].shape[0]
    nbytes = _nbytes(*pargs, out)
    g = out.shape[0]
    return (_bound(nbytes, bf16_flops=n_pairs * 2 * 64 * g, f32_ops=n_pairs * g * 3,
                   sfu_ops=n_pairs * (2 + 32 + g)),
            _bound(nbytes, f32_ops=n_pairs * (20 + 64 + 2 * 1024 + 32)))


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


# ROIAlign at the flagship paths' calls (phase 3): (label, lanes, ROIs, map
# (H, W, C), pooled, whether the map is every other one of a lane pair, as
# MEGA's global maps are); boxes of 16-512 pixels anywhere on the canvas;
# the kernel within ROI_ALIGN_RTOL of the largest magnitude from the plain
# version (f32 sums in another order)
ROI_ALIGN_CALLS = (("mega key", LANES, 300, (38, 64, 2048), 7, True),
                   ("mega global", LANES, 75, (38, 64, 2048), 7, True),
                   ("fgfa", METHOD_LANES, 300, (38, 64, 2048), 7, False))
ROI_ALIGN_RTOL = 1e-5
# the bottleneck epilogue at MEGA's 24 maps a step (phase 3): (label, map
# (N, C, H, W), with the residual); layer3's last pass is the row of the
# kernel table
EPILOGUE_CALLS = (("layer3 out", (2 * LANES, 1024, 38, 64), True),
                  ("layer3 mid", (2 * LANES, 256, 38, 64), False),
                  ("layer1 out", (2 * LANES, 256, 152, 256), True),
                  ("layer2 out", (2 * LANES, 512, 76, 128), True),
                  ("res5 out", (2 * LANES, 2048, 38, 64), True))


def _roi_align_rows(gen, dev):
    """Each ROI_ALIGN_CALLS call with a bf16 map into a bf16 output, as
    ``Res5Pooler.pool_flat`` calls it: the kernel against the plain version
    (which rounds its f32 result once), and the f32 output within
    ROI_ALIGN_RTOL; kernel and plain ms, and the bound: the output written
    once and each lane's map read once. There is no library yardstick:
    torchvision, whose ``roi_align`` is the usual one, is not installed."""
    import torch
    from mega_pytorch_tpu_torch.ops import roi_align as ra

    rows = {}
    for label, lanes, count, (h, w, c), pooled, paired in ROI_ALIGN_CALLS:
        maps = torch.randn(lanes, 2 if paired else 1, h, w, c, generator=gen, device=dev)
        feat = maps.to(torch.bfloat16)[:, -1]
        del maps
        canvas = torch.tensor([16.0 * w, 16.0 * h], device=dev)
        ctr = torch.rand(lanes, count, 2, generator=gen, device=dev) * canvas
        wh = 16 + torch.rand(lanes, count, 2, generator=gen, device=dev) * 496
        rois = torch.cat([ctr - wh / 2, ctr + wh / 2], -1)
        args = (1 / 16, pooled, pooled, 0, 10)
        got = ra.roi_align(feat, rois, *args)
        want = ra.roi_align_reference(feat, rois, *args)
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        bf16 = torch.bfloat16

        def kernel():
            return ra.roi_align(feat, rois, *args, out_dtype=bf16)

        def plain():
            return ra.roi_align_reference(feat, rois, *args, out_dtype=bf16)

        ms, plain_ms = _time_pair(plain, kernel, repeats=5)
        out = kernel()
        bound = _bound(_nbytes(out, rois) + lanes * h * w * c * feat.element_size())
        print(f"[kernels] roi_align {label} ({lanes}, {count}) on ({h}, {w}, {c}) bf16, "
              f"{pooled}x{pooled} into bf16: f32 max_abs_err {err:.3e} (rtol "
              f"{ROI_ALIGN_RTOL} of {scale:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}), share "
              f"{bound['bound_ms'] / ms:.3f}; no library yardstick (no torchvision)")
        if not (err <= ROI_ALIGN_RTOL * scale and torch.isfinite(got).all()):
            _fail(f"roi_align {label} differs from its plain version beyond tolerance")
        rows[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                           **bound)
        del feat, rois, got, want, out
    return rows


def _epilogue_rows(gen, dev):
    """Each EPILOGUE_CALLS call in bf16: the kernel bit for bit its plain
    version; kernel and plain ms, the unfolded tail it replaces (FrozenBN's
    product and sum in bf16, relu, the residual add and relu) and the bound:
    a and r read once and y written once."""
    import torch
    from mega_pytorch_tpu_torch.ops.kernels import bottleneck_epilogue as be

    rows = {}
    bf16 = torch.bfloat16
    for label, shape, residual in EPILOGUE_CALLS:
        def draw():
            x = torch.randn(shape, generator=gen, device=dev) * 2
            return x.to(bf16).contiguous(memory_format=torch.channels_last)

        a, r = draw(), draw() if residual else None
        shift = torch.randn(shape[1], generator=gen, device=dev)
        scale = (torch.rand(shape[1], generator=gen, device=dev) + 0.5).to(bf16)
        shift16 = shift.to(bf16)
        got = be.bottleneck_epilogue(a, shift, r)
        exact = torch.equal(got, be.bottleneck_epilogue_reference(a, shift, r))

        def unfolded():
            y = a * scale.view(-1, 1, 1) + shift16.view(-1, 1, 1)
            return torch.relu(torch.relu(y) if r is None else y + r)

        ms, plain_ms = _time_pair(lambda: be.bottleneck_epilogue_reference(a, shift, r),
                                  lambda: be.bottleneck_epilogue(a, shift, r), repeats=9)
        unfolded_ms, _ = _time_pair(lambda: be.bottleneck_epilogue(a, shift, r), unfolded,
                                    repeats=9)
        bound = _bound(_nbytes(a, got) + (_nbytes(r) if residual else 0))
        print(f"[kernels] bottleneck_epilogue {label} {shape} bf16, residual {residual}: "
              f"exact {exact}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, the unfolded "
              f"tail {unfolded_ms:.4f} ms; bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}), share {bound['bound_ms'] / ms:.3f}")
        if not exact:
            _fail(f"bottleneck_epilogue {label} is not bit-exact with its plain version")
        rows[label] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, unfolded_ms=unfolded_ms,
                           library_ms=None, **bound)
        del a, r, got
    return rows


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
    bound, old = _position_bias_bound(pargs, got)
    print(f"[kernels] fused_position_bias (675, 3750, g=16): weight-space "
          f"max_abs_err {err:.3e} (rtol {RTOL_BIAS}, atol {ATOL_BIAS}); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}), share {bound['bound_ms'] / ms:.3f}; the old count "
          f"(all f32 on the CUDA cores) {old['bound_ms']:.4f} ms "
          f"({old['bound_by']}), share {old['bound_ms'] / ms:.3f}")
    if not (torch.isfinite(got).all() and excess <= 0.0):
        _fail("fused_position_bias differs from its plain version beyond tolerance")
    rows["fused_position_bias"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        bound_ms_f32_count=old["bound_ms"], **bound)

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
    del x, bias
    roi_rows = _roi_align_rows(gen, dev)
    rows["roi_align"] = dict(roi_rows["mega key"], calls=roi_rows)
    epilogue_rows = _epilogue_rows(gen, dev)
    rows["bottleneck_epilogue"] = dict(epilogue_rows["layer3 out"], calls=epilogue_rows)
    return rows


def phase_rdn_kernels():
    """The RDN path's kernels at its shapes: the stem pool over the 4 lanes'
    frames, and mode "compute" with uk = 0 at RDN's three attention shapes,
    at B=1 and B=4. Returns (stem pool entry, list of "compute" entries)."""
    import torch
    from mega_pytorch_tpu_torch.ops.kernels import relation_attention as ra
    from mega_pytorch_tpu_torch.ops.kernels import stem_pool as sp

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(2)
    b = METHOD_LANES
    y = (torch.randn(b, 152, 256, 256, generator=gen, device=dev) * 2).to(torch.bfloat16)
    scale = torch.rand(256, generator=gen, device=dev) + 0.5
    shift = torch.randn(256, generator=gen, device=dev)
    got = sp.stem_pool_packed(y, scale, shift, 64)
    exact = torch.equal(got, sp.stem_pool_packed_reference(y, scale, shift, 64))
    ms, plain_ms = _time_pair(lambda: sp.stem_pool_packed_reference(y, scale, shift, 64),
                              lambda: sp.stem_pool_packed(y, scale, shift, 64))
    stem = dict(shape=list(y.shape), ms=ms, plain_ms=plain_ms,
                **_bound(_nbytes(y, got), f32_ops=4 * y.numel()))
    print(f"[rdn kernels] stem_pool bf16 ({b},152,256,256)->({b},152,256,64): exact "
          f"{exact}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{stem['bound_ms']:.4f} ms ({stem['bound_by']})")
    if not exact:
        _fail("stem_pool is not bit-exact at RDN's shape")
    del y, got

    entries = []
    for label, n, m in RDN_SHAPES:
        for lanes in (1, b):
            x = _attention_inputs(gen, lanes, n, m, dev)
            x["uk"] = torch.zeros_like(x["uk"])  # RDN: no u bias
            kern, plain, tol = _attention_fns(ra, "compute", x)
            got = kern()
            err = (got - plain()).abs().max().item()
            if not torch.isfinite(got).all():
                _fail(f"compute ({label}) B={lanes}: non-finite kernel output")
            err_t, mean_t, bound_t = _check_tiled(ra, x, got, f"compute ({label}) B={lanes}")
            ms, plain_ms = _time_pair(plain, kern, repeats=TIMING_REPEATS if lanes == 1 else 5)
            bound = _attention_bound("compute", x)
            same = None
            if lanes > 1:
                def one(t, i):
                    return t[i:i + 1].contiguous()
                same = all(torch.equal(got[i:i + 1], ra.flash_relation_attention_pos(
                    one(x["q"], i), one(x["k"], i), one(x["v"], i), one(x["uk"], i),
                    one(x["rois"], i), one(x["refs"], i), x["wk"], x["wb"],
                    one(x["valid"], i))) for i in range(lanes))
            print(f"[rdn kernels] compute ({label}) B={lanes} N={n} M={m}, uk = 0: "
                  f"max_abs_err {err:.3e} (atol {tol}), tiled {err_t:.3e} (atol "
                  f"{bound_t:.3e}), mean {mean_t:.2e} (atol {MEAN_POS_TILED}); kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
                  f"({bound['bound_by']}), share {bound['bound_ms'] / ms:.3f}"
                  + ("" if same is None else f"; every lane == its B=1 call: {same}"))
            if not err <= tol:
                _fail(f"compute ({label}) B={lanes}: max_abs_err {err} above atol {tol}")
            if same is False:
                _fail(f"compute ({label}): a {lanes}-lane call differs from its 1-lane calls")
            entries.append(dict(stage=label, B=lanes, N=n, M=m, max_abs_err=err,
                                tiled_err=err_t, tiled_mean_err=mean_t, ms=ms,
                                plain_ms=plain_ms, **bound))
            del x, got, kern, plain
    return stem, entries


def phase_stream():
    import torch
    from mega_pytorch_tpu_torch.engine.inference import run_video, synthetic_video
    from mega_pytorch_tpu_torch.models.detectors.mega import build_mega_flagship
    from mega_pytorch_tpu_torch.ops.kernels import relation_attention as ra
    from mega_pytorch_tpu_torch.ops.kernels import stem_pool as sp
    from mega_pytorch_tpu_torch.ops.kernels.bottleneck_epilogue import bottleneck_epilogue
    from mega_pytorch_tpu_torch.ops.roi_align import roi_align

    t0 = time.perf_counter()
    model = build_mega_flagship(*CANVAS, device="cuda",
                                generator=torch.Generator("cuda").manual_seed(0))
    frames, gframes = synthetic_video(np.random.RandomState(0), NUM_FRAMES, *CANVAS)
    torch.cuda.synchronize()
    print(f"[stream] built MEGA R-101 bf16 {CANVAS[0]}x{CANVAS[1]} in "
          f"{time.perf_counter() - t0:.1f} s; frames {frames.shape} uint8")

    kernels = (sp.stem_pool_packed, ra.flash_relation_attention,
               ra.flash_relation_attention_pos, roi_align, bottleneck_epilogue)
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
              "flash_relation_attention_pos": 3 * steps, "roi_align": 2 * steps,
              "bottleneck_epilogue": EPI_PASS * steps}
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


def _kernels():
    from mega_pytorch_tpu_torch.ops.kernels import position_bias as pb
    from mega_pytorch_tpu_torch.ops.kernels import relation_attention as ra
    from mega_pytorch_tpu_torch.ops.kernels import stem_pool as sp
    from mega_pytorch_tpu_torch.ops.kernels.bottleneck_epilogue import bottleneck_epilogue
    from mega_pytorch_tpu_torch.ops.roi_align import roi_align

    return (sp.stem_pool_packed, ra.flash_relation_attention,
            ra.flash_relation_attention_pos, ra.flash_relation_attention_bias,
            pb.fused_position_bias, roi_align, bottleneck_epilogue)


def run_lanes(model, ds, lanes, dev, run=None, tag=None):
    """Serve ``ds`` through ``compute_on_dataset_lockstep`` with ``lanes``
    lanes (or through ``run()``, which must reach it, with ``ds`` as its
    dataset) and check the run: the launches of every kernel on every step
    against ``PER_STEP[model.v.method]``, every frame emitted exactly once
    with finite boxes, and the first 15 steps re-run from the engine's first
    carries bit for bit. Returns (per-step ms, emissions per step, launches,
    launches per step as measured, run seconds, the kind of each step, the
    predictions). Device-agnostic, so it also runs on the CPU."""
    import torch
    from mega_pytorch_tpu_torch.engine import batched_inference as bi

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    kernels = _kernels()
    method = model.v.method
    tag = tag or f"lanes {method}"
    per_step = dict(PER_STEP[method])
    non_key = dict(DFF_NON_KEY_STEP)
    if dev.type != "cuda":  # plain versions: no launches
        per_step, non_key = dict.fromkeys(per_step, 0), dict.fromkeys(non_key, 0)
    slots = model.c.detections_per_img
    record = dict(ms=[], kinds=[], emitted=[], replay=[], bad_counts=[], first=[],
                  replay_on=True, last=None,
                  finite=torch.ones((), dtype=torch.bool, device=dev))
    factories = {name: getattr(bi, name) for name in (
        "make_lockstep_step", "make_lockstep_step_windowed", "make_lockstep_steps_dff")}

    def recording(kind, step):
        def run(carries, *inputs):
            if not record["first"]:
                record["first"].append(carries)  # the engine's first carries
            elif carries is not record["last"]:
                record["replay_on"] = False
            before = {k.__name__: k.launches for k in kernels}
            t = time.perf_counter()
            carries, dets = step(carries, *inputs)
            sync()
            record["ms"].append((time.perf_counter() - t) * 1e3)
            record["kinds"].append(kind)
            record["emitted"].append(0)  # counted by the engine's _extract
            delta = {k.__name__: k.launches - before[k.__name__] for k in kernels}
            if delta != (non_key if kind == "non-key" else per_step):
                record["bad_counts"].append((len(record["ms"]) - 1, delta))
            # a canvas group of fewer videos than lanes runs fewer lanes
            if not (dets.boxes.shape[0] <= lanes and tuple(dets.boxes.shape[1:]) == (slots, 4)):
                _fail(f"lockstep detections have shape {tuple(dets.boxes.shape)}")
            record["finite"] = record["finite"] & torch.isfinite(dets.boxes).all() \
                & torch.isfinite(dets.scores).all()
            # the replay follows the first canvas group only: another group
            # starts from fresh carries (not the last step's)
            if record["replay_on"] and len(record["replay"]) < 15:
                record["replay"].append((step, [a.clone() for a in inputs],
                                         [d.clone() for d in dets]))
            record["last"] = carries
            return carries, dets
        return run

    def counting_extract(*args):
        record["emitted"][-1] += 1
        return extract(*args)

    extract = bi._extract
    patched = {
        "make_lockstep_step": lambda m: recording(
            "step", factories["make_lockstep_step"](m)),
        "make_lockstep_step_windowed": lambda m: recording(
            "step", factories["make_lockstep_step_windowed"](m)),
        "make_lockstep_steps_dff": lambda m: tuple(
            recording(kind, fn) for kind, fn in zip(
                ("key", "non-key"), factories["make_lockstep_steps_dff"](m))),
    }
    for k in kernels:
        k.launches = 0
    for name, fn in patched.items():
        setattr(bi, name, fn)
    bi._extract = counting_extract
    try:
        t0 = time.perf_counter()
        if run is None:
            results = bi.compute_on_dataset_lockstep(
                model, ds, range(len(ds.image_set_index)), _Preprocessor(), lanes=lanes)
        else:
            results = run()
        wall = time.perf_counter() - t0
    finally:
        for name, fn in factories.items():
            setattr(bi, name, fn)
        bi._extract = extract
    launches = {k.__name__: k.launches for k in kernels}
    steps = len(record["ms"])
    n_frames = len(ds.image_set_index)
    print(f"[{tag}] {steps} steps of {lanes} lanes; launches {launches}; per "
          f"step {per_step} expected (DFF's non-key steps {non_key}), steps that differ: "
          f"{record['bad_counts'][:3]}")
    if record["bad_counts"] or steps == 0:
        _fail(f"{method}: lockstep kernel launch counts per step differ from {per_step}")
    once = bool((ds.info_calls == 1).all()) and sorted(results) == list(range(n_frames))
    print(f"[{tag}] frames emitted exactly once: {once} ({len(results)} of "
          f"{n_frames}; {sum(record['emitted'])} emissions)")
    if not once or sum(record["emitted"]) != n_frames:
        _fail(f"{method}: not every frame was emitted exactly once")
    if not bool(record["finite"]):
        _fail(f"{method}: non-finite lockstep detections")
    for r in results.values():
        if len(r["boxes"]) > slots or not np.isfinite(r["boxes"]).all():
            _fail(f"an extracted prediction has more than {slots} or non-finite boxes")

    # the first 15 steps again, from the engine's first carries, bit for bit
    carries = record["first"][0]
    for i, (step, inputs, want) in enumerate(record["replay"]):
        carries, dets = step(carries, *inputs)
        for name, a, b in zip(dets._fields, dets, want):
            if not torch.equal(a, b):
                _fail(f"{method}: lockstep re-run step {i}: {name} differs")
    print(f"[{tag}] determinism: {len(record['replay'])} steps re-run from "
          f"fresh carries: detections bit-identical "
          f"({len(record['replay']) * lanes * slots} slots)")
    return (record["ms"], record["emitted"], launches, per_step, wall, record["kinds"],
            results)


def _lane_stats(step_ms, emitted, lanes, n_frames, wall, smi, tag):
    """Print and return the steady-state ms/step (steps 5..), frames/s with
    every lane emitting, and whole-run frames/s."""
    steady = step_ms[5:]
    ms = statistics.median(steady)
    full = [t for t, e in zip(step_ms[5:], emitted[5:]) if e == lanes]
    full_ms = statistics.median(full) if full else float("nan")
    print(f"[{tag}] steady state (steps 5..{len(step_ms) - 1}, {lanes} lanes, "
          f"per-step sync): median {ms:.2f} ms/step = {lanes * 1e3 / ms:.2f} "
          f"lane-steps/s; {len(full)} steps with all {lanes} lanes emitting, median "
          f"{full_ms:.2f} ms/step = {lanes * 1e3 / full_ms:.2f} frames/s; first step "
          f"{step_ms[0]:.1f} ms; {smi}")
    print(f"[{tag}] whole run: {n_frames} frames emitted in {wall:.2f} s = "
          f"{n_frames / wall:.2f} frames/s (warm-up steps and idle tail included); "
          f"{smi}")
    return dict(ms_per_step=ms, frames_per_s_all_emitting=lanes * 1e3 / full_ms,
                frames_per_s_whole_run=n_frames / wall)


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
    step_ms, emitted, launches, per_step, wall, _, _ = run_lanes(model, ds, model.lanes,
                                                                 torch.device("cuda"))
    peak = torch.cuda.max_memory_allocated() / 2**20
    _lane_stats(step_ms, emitted, LANES, len(ds.image_set_index), wall, smi, "lanes")
    print(f"[lanes] peak memory {peak:.0f} MiB; {smi}")
    return launches, per_step


def phase_methods(smi):
    """RDN, FGFA and DFF through the lockstep engine with 4 lanes; returns
    {method: (launches, launches per step)}."""
    import torch
    from mega_pytorch_tpu_torch.models.detectors import build_method_flagship

    out = {}
    for method in ("rdn", "fgfa", "dff"):
        t0 = time.perf_counter()
        model = build_method_flagship(method, *CANVAS, device="cuda", lanes=METHOD_LANES,
                                      generator=torch.Generator("cuda").manual_seed(0))
        rs = np.random.RandomState(0)
        lengths = rs.randint(12, 41, METHOD_VIDEOS)
        ds = _SyntheticVideos(lengths, rs, CANVAS, global_size=0)
        if method == "dff":
            ds.key_interval = DFF_KEY_INTERVAL
        torch.cuda.synchronize()
        print(f"[methods] built {method} R-101 bf16 {CANVAS[0]}x{CANVAS[1]} for "
              f"{model.lanes} lanes in {time.perf_counter() - t0:.1f} s; "
              f"{METHOD_VIDEOS} videos of {lengths.min()}-{lengths.max()} frames, "
              f"{lengths.sum()} frames")
        torch.cuda.reset_peak_memory_stats()
        step_ms, emitted, launches, per_step, wall, kinds, _ = run_lanes(
            model, ds, METHOD_LANES, torch.device("cuda"))
        peak = torch.cuda.max_memory_allocated() / 2**20
        _lane_stats(step_ms, emitted, METHOD_LANES, len(ds.image_set_index), wall, smi,
                    f"methods {method}")
        if method == "dff":
            for kind in ("key", "non-key"):
                ms = [t for t, k in zip(step_ms[5:], kinds[5:]) if k == kind]
                print(f"[methods dff] {kind} steps: {len(ms)}, median "
                      f"{statistics.median(ms):.2f} ms/step; {smi}")
        print(f"[methods {method}] peak memory {peak:.0f} MiB; {smi}")
        out[method] = (launches, per_step)
        del model
        torch.cuda.empty_cache()
    return out


def phase_base(smi):
    """The single-frame detector on 4 s2d(4)-packed frames: one stem pool
    and one ROIAlign launch a call, no other kernel, finite detections.
    Returns the launches."""
    import torch
    from mega_pytorch_tpu_torch.data.transforms import normalize_u8_frames, s2d_pack_frames
    from mega_pytorch_tpu_torch.models.detectors import build_method_flagship

    dev = torch.device("cuda")
    model = build_method_flagship("base", *CANVAS, device=dev, lanes=METHOD_LANES,
                                  generator=torch.Generator("cuda").manual_seed(0))
    rs = np.random.RandomState(1)
    frames = s2d_pack_frames(
        rs.randint(0, 256, (METHOD_LANES, *CANVAS, 3), dtype=np.uint8), 4)
    sizes = torch.tensor(CANVAS, dtype=torch.float32, device=dev).expand(METHOD_LANES, 2)
    kernels = _kernels()
    calls, ms = 4, []
    with torch.inference_mode():
        images = normalize_u8_frames(torch.from_numpy(frames).to(dev), sizes)
        for k in kernels:
            k.launches = 0
        for _ in range(calls):
            t0 = time.perf_counter()
            dets = model.forward_test(images, sizes)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k.__name__: k.launches for k in kernels}
    expect = dict(_NO_KERNEL, stem_pool_packed=calls, roi_align=calls,
                  bottleneck_epilogue=EPI_PASS * calls)
    finite = bool(torch.isfinite(dets.boxes).all() and torch.isfinite(dets.scores).all())
    print(f"[base] forward_test on {METHOD_LANES} packed frames x {calls} calls: "
          f"launches {launches} (expected {expect}); detections "
          f"{tuple(dets.boxes.shape)} finite {finite}, {int(dets.valid.sum())} valid; "
          f"median {statistics.median(ms[1:]):.2f} ms/call; {smi}")
    if launches != expect:
        _fail(f"base: launch counts {launches} != {expect}")
    if not finite or tuple(dets.boxes.shape) != (METHOD_LANES, 300, 4):
        _fail("base: detections not finite or of the wrong shape")
    _check_s2d2_stem(model.backbone.stem, rs, kernels, smi)
    del model
    torch.cuda.empty_cache()
    return launches


def _check_s2d2_stem(stem, rs, kernels, smi):
    """The stem on s2d(2)-packed frames of the flagship canvas: no kernel
    launch (the JAX package runs none on this branch), finite in the model's
    bf16, and in f32 with the model's weights (TF32 off) equal to the
    canonical 7x7/2 branch within ATOL_STEM + RTOL_STEM max|out|."""
    import torch
    from mega_pytorch_tpu_torch.data.transforms import normalize_u8_frames, s2d_pack_frames
    from mega_pytorch_tpu_torch.models.backbone.resnet import Stem

    dev = torch.device("cuda")
    raw = rs.randint(0, 256, (2, *CANVAS, 3), dtype=np.uint8)
    sizes = torch.tensor([CANVAS, (CANVAS[0] - 18, CANVAS[1] - 42)], dtype=torch.float32,
                         device=dev)  # one padded canvas
    f32 = Stem(64, torch.float32, dev)
    f32.load_state_dict(stem.state_dict())  # canonical kernel and frozen BN
    f32.eval().requires_grad_(False)
    with torch.inference_mode():
        x3 = normalize_u8_frames(torch.from_numpy(raw).to(dev), sizes)
        x12 = normalize_u8_frames(torch.from_numpy(s2d_pack_frames(raw, 2)).to(dev), sizes)
        for k in kernels:
            k.launches = 0
        low = stem(x12)
        got, want = f32(x12), f32(x3)
        torch.cuda.synchronize()
        launches = sum(k.launches for k in kernels)
    err = (got - want).abs().max().item()
    tol = ATOL_STEM + RTOL_STEM * want.abs().max().item()
    shape = (2, 64, CANVAS[0] // 4, CANVAS[1] // 4)
    print(f"[base] stem on s2d(2)-packed frames (2, {CANVAS[0] // 2}, {CANVAS[1] // 2}, 12): "
          f"{tuple(got.shape)}, f32 against the canonical branch max_abs_err {err:.3e} "
          f"(tolerance {tol:.3e}); bf16 finite "
          f"{bool(torch.isfinite(low).all())}; kernel launches {launches}; {smi}")
    if launches != 0:
        _fail(f"the s2d(2) stem launched {launches} kernels")
    if tuple(got.shape) != shape or tuple(low.shape) != shape or not err <= tol:
        _fail("the s2d(2) stem differs from the canonical branch")
    if not torch.isfinite(low).all():
        _fail("the s2d(2) stem in bf16 is not finite")


def _write_vid_tree(root: Path, lengths, portrait, frame_hw, rs,
                    index="VID_val_videos.txt", det=False, listed=None):
    """A synthetic ILSVRC2015 layout under ``root``: the index
    ``ImageSets/{index}`` (VID: ``folder 1 seg_id seg_len`` lines of videos
    ``val/v{v}``; ``det``: ``folder/frame id`` lines of stills ``train/d{v}``)
    and one XML annotation a frame with 1-3 random boxes of the 30 wnids;
    video (or still) v is portrait where ``portrait[v]``; with ``listed``,
    only that many evenly spaced frames of each video are indexed and
    annotated (the VID_train_15frames form). No frame files: the
    dataset that reads this tree synthesises its frames. Returns the
    synthetic motion-IoU table (one value a box), as
    ``vid_eval.load_motion_ious`` reads it."""
    from mega_pytorch_tpu_torch.data.datasets.vid import VID_WNIDS

    ilsvrc = root / "ILSVRC2015"
    (ilsvrc / "ImageSets").mkdir(parents=True, exist_ok=True)
    kind = "DET" if det else "VID"
    lines, mious = [], []
    for v, n in enumerate(lengths):
        h, w = frame_hw[::-1] if portrait[v] else frame_hw
        folder = f"train/d{v:03d}" if det else f"val/v{v:03d}"
        (ilsvrc / "Annotations" / kind / folder).mkdir(parents=True)
        frames = range(n) if listed is None else np.linspace(0, n - 1, listed).astype(int)
        for f in frames:
            objs = []
            for _ in range(rs.randint(1, 4)):
                x1, y1 = rs.randint(0, w - 40), rs.randint(0, h - 40)
                x2, y2 = x1 + rs.randint(20, w - x1), y1 + rs.randint(20, h - y1)
                objs.append(f"<object><name>{VID_WNIDS[rs.randint(1, 31)]}</name><bndbox>"
                            f"<xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax>"
                            f"<ymax>{y2}</ymax></bndbox></object>")
            (ilsvrc / "Annotations" / kind / folder / f"{f:06d}.xml").write_text(
                f"<annotation><size><height>{h}</height><width>{w}</width></size>"
                f"{''.join(objs)}</annotation>")
            mious.append(rs.rand(len(objs)))
            lines.append(f"{folder}/{f:06d} {len(lines) + 1}" if det
                         else f"{folder} {len(lines) + 1} {f} {n}")
    (ilsvrc / "ImageSets" / index).write_text("\n".join(lines) + "\n")
    return mious


def _synthetic_frames(base, frame_hw, rs, pool=6):
    """``base`` (a dataset class of the port) whose ``decode_rgb`` draws the
    frame from a pool of seeded uint8 frames of its video's orientation
    instead of reading a file (this machine has no JPEG decoder), and which
    counts ``get_img_info`` calls. Everything else is the port's own."""
    frames = {
        False: rs.randint(0, 256, (pool, *frame_hw, 3), dtype=np.uint8),
        True: rs.randint(0, 256, (pool, *frame_hw[::-1], 3), dtype=np.uint8),
    }

    class SyntheticFrames(base):
        def __init__(self, *args, portrait=(), **kw):
            super().__init__(*args, **kw)
            self.portrait = portrait
            self.info_calls = np.zeros(len(self), np.int64)

        def decode_rgb(self, path):
            video, frame = path.split("/")[-2:]
            v, f = int(video[1:]), int(frame.split(".")[0])
            return frames[bool(self.portrait[v])][(7 * v + f) % pool]

        def get_img_info(self, idx):
            self.info_calls[idx] += 1
            return super().get_img_info(idx)

    return SyntheticFrames


def run_eval_path(dev, cfg, base_cfg, frame_hw, lengths, portrait, lanes, smi, tag="eval"):
    """The evaluation entry point's path on a synthetic on-disk VID tree:
    ``cfg``'s MEGA through ``compute_on_dataset(lanes=lanes)`` (the port's
    dataset, index and XML parsing, global schedule, ``EvalPreprocessor``
    with ``resize_bilinear_u8``, ``video_shards``), checked per step by
    ``run_lanes``; ``evaluate_predictions`` with a motion-IoU table and
    ``write_result``; then ``base_cfg``'s detector through the serial
    engine over the first video. Returns (launches, launches per step,
    MEGA seconds a step, base launches)."""
    import tempfile

    import scipy.io as sio
    import torch
    from mega_pytorch_tpu_torch.data import transforms as tf
    from mega_pytorch_tpu_torch.data.datasets.vid import VIDDataset, VIDMEGADataset
    from mega_pytorch_tpu_torch.data.loader import EvalPreprocessor
    from mega_pytorch_tpu_torch.data.paths_catalog import dataset_args
    from mega_pytorch_tpu_torch.data.samplers import video_shards
    from mega_pytorch_tpu_torch.engine.inference import compute_on_dataset, evaluate_predictions
    from mega_pytorch_tpu_torch.models.detectors import build_detection_model
    from mega_pytorch_tpu_torch.tools.test_net import dataset_kwargs, video_starts, write_result
    from mega_pytorch_tpu_torch.utils import profiler

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    rs = np.random.RandomState(7)
    prep = EvalPreprocessor(min_size=cfg.INPUT.MIN_SIZE_TEST, max_size=cfg.INPUT.MAX_SIZE_TEST,
                            canvas_short=cfg.TPU.CANVAS_HEIGHT,
                            canvas_long=cfg.TPU.CANVAS_WIDTH, max_gt=cfg.TPU.MAX_GT_BOXES)
    # the host input layer, per frame: the resize, then the canvas and the pack
    img = rs.randint(0, 256, (*frame_hw, 3), dtype=np.uint8)
    oh, ow = tf.resize_hw(*frame_hw, cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST)
    host_ms = {}
    for name, fn in (("resize", lambda: tf.resize_bilinear_u8(img, oh, ow)),
                     ("resize+canvas", lambda: prep._prep_u8(img, flip=False)),
                     ("resize+canvas+s2d(4) pack",
                      lambda: tf.s2d_pack_frames(prep._prep_u8(img, flip=False).image, 4))):
        fn()
        ts = []
        for _ in range(20):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        host_ms[name] = statistics.median(ts)
    print(f"[{tag}] host input per frame {frame_hw[0]}x{frame_hw[1]} -> ({oh}, {ow}), median "
          f"of 20 on one thread: " + ", ".join(f"{k} {v:.2f} ms" for k, v in host_ms.items())
          + f"; {smi}")

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        mious = _write_vid_tree(root, lengths, portrait, frame_hw, rs)
        t0 = time.perf_counter()
        model = build_detection_model(cfg, dev, torch.Generator(dev).manual_seed(0), lanes)
        sync()
        ds = _synthetic_frames(VIDMEGADataset, frame_hw, rs)(
            **dataset_args("VID_val_videos", tmp), portrait=portrait,
            **dataset_kwargs(cfg, "mega", 0))
        indices = video_shards(video_starts(ds), len(ds), 1)[0]
        print(f"[{tag}] built {cfg.MODEL.BACKBONE.CONV_BODY} MEGA ({cfg.TPU.COMPUTE_DTYPE}, "
              f"reduce channel {cfg.MODEL.VID.ROI_BOX_HEAD.REDUCE_CHANNEL}) for {lanes} lanes "
              f"in {time.perf_counter() - t0:.1f} s; {len(lengths)} videos "
              f"({int(np.sum(portrait))} portrait) of {min(lengths)}-{max(lengths)} frames, "
              f"{len(ds)} frames of {frame_hw[0]}x{frame_hw[1]}")
        # the host feed's spans: the producer's "feed" a lane batch, the
        # step's "queue_wait" for it
        with profiler.recording():
            step_ms, emitted, launches, per_step, wall, _, preds = run_lanes(
                model, ds, lanes, dev, tag=tag,
                run=lambda: compute_on_dataset(model, ds, indices, prep, "mega", lanes=lanes))
        spans = profiler.recorded()["spans"]
        lane = _lane_stats(step_ms, emitted, lanes, len(ds), wall, smi, tag)
        feed = spans["feed"]["host_ms"] / spans["feed"]["calls"]
        wait = spans["queue_wait"]["host_ms"] / spans["queue_wait"]["calls"]
        print(f"[{tag}] host feed: the producer's mean {feed:.2f} ms per {lanes}-lane batch "
              f"({2 * lanes} frames) against the median step {lane['ms_per_step']:.2f} ms: "
              f"share {feed / lane['ms_per_step']:.3f}; the step's mean wait on the queue "
              f"{wait:.2f} ms over {spans['queue_wait']['calls']} waits; the whole run "
              f"{wall * 1e3 / len(step_ms):.2f} ms a step ({len(step_ms)} steps, two canvas "
              f"groups one after the other); {smi}")
        for i in indices:
            h, w = ds.get_img_info(i)["height"], ds.get_img_info(i)["width"]
            b = preds[i]["boxes"]
            if len(b) and not (np.isfinite(b).all() and b[:, [0, 2]].max() <= w + 1
                               and b[:, [1, 3]].max() <= h + 1 and b.min() >= -1):
                _fail(f"{tag}: frame {i} has boxes outside its {h}x{w} image")
        mat = root / "motion_iou.mat"
        cells = np.empty((len(mious), 1), object)
        for i, m in enumerate(mious):
            cells[i, 0] = m.reshape(-1, 1)
        sio.savemat(mat, {"motion_iou": cells})
        result = evaluate_predictions(ds, preds, str(mat))
        write_result(result, tmp)
        saved = json.loads((root / "result.json").read_text())
        aps = {k: saved[k]["map"] for k in saved}
        print(f"[{tag}] result.json AP50 by motion bucket {aps} (random weights: the values "
              f"mean nothing, only that evaluation ran)")
        if sorted(aps) != ["all", "fast", "medium", "slow"] or not all(
                np.isfinite(v) for v in aps.values()):
            _fail(f"{tag}: result.json lacks a finite AP50 of the four motion buckets")
        del model
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        base = build_detection_model(base_cfg, dev, torch.Generator(dev).manual_seed(0))
        base_ds = _synthetic_frames(VIDDataset, frame_hw, rs)(
            **dataset_args("VID_val_videos", tmp), portrait=portrait)
        video = list(range(lengths[0]))
        kernels = _kernels()
        for k in kernels:
            k.launches = 0
        sync()
        t0 = time.perf_counter()
        base_preds = compute_on_dataset(base, base_ds, video, prep, "base")
        sync()
        base_s = time.perf_counter() - t0
        base_launches = {k.__name__: k.launches for k in kernels}
        finite = all(np.isfinite(p["boxes"]).all() and np.isfinite(p["scores"]).all()
                     for p in base_preds.values())
        print(f"[{tag}] base ({base_cfg.MODEL.BACKBONE.CONV_BODY}) through the serial engine "
              f"over video 0 ({len(video)} frames, f32 canvases packed s2d(4)): "
              f"{len(base_preds)} frames predicted, finite {finite}, "
              f"{len(video) / base_s:.2f} frames/s, launches {base_launches}; {smi}")
        if sorted(base_preds) != video or not finite:
            _fail(f"{tag}: the base method's serial run did not predict every frame")
        if base_launches != dict(_NO_KERNEL, stem_pool_packed=len(video),
                                 roi_align=len(video),
                                 bottleneck_epilogue=EPI_PASS * len(video)):
            _fail(f"{tag}: the serial base run launched {base_launches}, not one stem pool, "
                  f"one ROIAlign and a body and res5 pass of epilogues a frame")
        del base
    return launches, per_step, lane["ms_per_step"], base_launches


def phase_eval_path(smi):
    """The eval path at full width: MEGA R-101 (the preset, no channel
    reduce) in bf16 on the 608x1024 canvas with 12 lanes over 12 on-disk
    synthetic videos of 10-20 frames of 720x1280 (two of them portrait),
    then base R-101 serially over the 10-frame first video."""
    import torch
    from mega_pytorch_tpu_torch.config import get_preset

    rs = np.random.RandomState(11)
    lengths = [10] + [int(n) for n in rs.randint(10, 21, EVAL_VIDEOS - 1)]
    portrait = [v in (3, 8) for v in range(EVAL_VIDEOS)]
    return run_eval_path(torch.device("cuda"), get_preset("mega_R_101").freeze(),
                         get_preset("base_R_101").freeze(), EVAL_FRAME, lengths, portrait,
                         LANES, smi)


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


def phase_train_kernels():
    """Modes "none" and "input" at every shape of a training iteration,
    through their autograd Function: on two lanes, lane 0 with ragged valid refs
    and lane 1 with none, the forward (one launch) against the tiled plain
    version (atol ATOL_NONE, zeros on the empty lane) and the gradients
    against ``torch.autograd.grad`` through the plain version on the same
    operands, bit for bit (the Function's backward recomputes it); the
    kernel, its plain version and the library call timed on lane 0.
    Returns {kernel name: [entry per shape]}."""
    import torch
    from mega_pytorch_tpu_torch.ops.kernels import relation_attention as ra

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(5)
    out = {}
    for name, cases in TRAIN_ATTENTION.items():
        mode = "none" if name == "flash_relation_attention" else "input"
        wrapper = getattr(ra, name)
        entries = []
        for label, n, m in cases:
            x = _attention_inputs(gen, 2, n, m, dev)
            x["valid"][1] = False
            if label.startswith("rdn"):  # RDN's attention has no u bias
                x["uk"] = torch.zeros_like(x["uk"])
            ops = [x["q"], x["k"], x["v"], x["uk"]]
            if mode == "input":  # the log bias of the train path's f32 sinusoids
                x["wb"] = x["wb"] * 0.0  # Wg's initial bias: pw at its relu floor for ~half
                from mega_pytorch_tpu_torch.ops.kernels import position_bias as pb
                ops.append(_stage_bias(pb, x))
            ops = [t.clone().requires_grad_() for t in ops]
            before = wrapper.launches
            got = ra.RelationAttentionFunction.apply(
                *ops[:4], ops[4] if mode == "input" else None, x["valid"], wrapper)
            launched = wrapper.launches - before
            cot = torch.randn(got.shape, generator=gen, device=dev)
            grads = torch.autograd.grad(got, ops, cot)
            bias = ops[4] if mode == "input" else None
            plain = ra.reference_relation_attention(*ops[:4], bias, x["valid"])
            want = torch.autograd.grad(plain, ops, cot)
            same = all(g.dtype == t.dtype and torch.equal(g, w)
                       for g, w, t in zip(grads, want, ops))
            detached = [t.detach() for t in ops]
            tiled = ra.reference_relation_attention_tiled(
                *detached[:4], detached[4] if mode == "input" else None, x["valid"])
            err = (got.detach() - tiled).abs().max().item()
            empty = got[1].abs().max().item()
            torch.cuda.synchronize()
            lane = {k: v[:1].contiguous() for k, v in x.items() if torch.is_tensor(v)
                    and v.dim() > 1}
            lane.update(wk=x["wk"], wb=x["wb"])
            lane_bias = detached[4][:1].contiguous() if mode == "input" else None
            kern, plain_fn, _ = _attention_fns(ra, mode, lane, lane_bias)
            ms, plain_ms = _time_pair(plain_fn, kern)
            library_ms = _time_pair(_library_fn(lane, lane_bias), kern)[1]
            bound = _attention_bound(mode, lane, lane_bias)
            print(f"[train kernels] {mode} ({label}) N={n} M={m}, B=2 (lane 1 empty): "
                  f"launches {launched}, max_abs_err {err:.3e} from the tiled plain version "
                  f"(atol {ATOL_NONE}), empty lane {empty}; gradients == autograd through "
                  f"the plain version, bit for bit: {same}; B=1 kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
                  f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
            if launched != 1 or not err <= ATOL_NONE or empty != 0.0:
                _fail(f"train kernels: {mode} ({label}) launches {launched}, err {err}, "
                      f"empty lane {empty}")
            if not same:
                _fail(f"train kernels: {mode} ({label}) gradients differ from the plain "
                      "version's")
            entries.append(dict(stage=label, B=1, N=n, M=m, max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, library_ms=library_ms, **bound))
            del x, ops, got, grads, want, plain
        out[name] = entries
    return out


def _snapshot(model, optimizer, scheduler):
    """Clones of the model's state, the optimizer's per-parameter state and
    the scheduler's position."""
    import torch

    def clone(x):
        if torch.is_tensor(x):
            return x.detach().clone()
        return {k: clone(v) for k, v in x.items()} if isinstance(x, dict) else x

    return (clone(model.state_dict()), clone(optimizer.state_dict()["state"]),
            scheduler.last_epoch)


def _same_state(a, b) -> bool:
    import torch

    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_state(a[k], b[k]) for k in a)
    return a == b


def run_training(smi, preset, dataset_name, iters, ckpt, per_iter, tag):
    """Training of ``preset`` at full width through ``tools/train_net.py``'s
    ``main`` on the card (bf16 compute, f32 master weights from seed 0, the
    608x1024 canvas, MIN_SIZE_TRAIN 600 / MAX_SIZE_TRAIN 1000, the preset's
    IMS_PER_BATCH samples an iteration, one after the other, and its frames
    a sample), over a synthetic on-disk ILSVRC2015 train tree (VID videos in
    the VID_train_15frames index form and DET stills of TRAIN_FRAME, two
    orientations, frames drawn; the port's ``dataset_name`` class reads
    it), ``iters`` iterations with a checkpoint at ``ckpt``. Checks finite
    losses, every trainable group and every trainable module moved by the
    first step, frozen parameters and buffers bit-identical at the end, the
    launches of every iteration (``per_iter``), and a fresh model,
    optimizer and scheduler restored from the checkpoint equal to the live
    state there bit for bit. Returns (launches, launches per iteration)."""
    import tempfile

    import torch
    from mega_pytorch_tpu_torch.data import paths_catalog
    from mega_pytorch_tpu_torch.data.datasets import vid
    from mega_pytorch_tpu_torch.data.paths_catalog import dataset_args
    from mega_pytorch_tpu_torch.engine import trainer
    from mega_pytorch_tpu_torch.models import detectors
    from mega_pytorch_tpu_torch.models.detectors import build_training_model
    from mega_pytorch_tpu_torch.solver import make_lr_scheduler, make_optimizer
    from mega_pytorch_tpu_torch.tools import train_net
    from mega_pytorch_tpu_torch.tools.test_net import load_config
    from mega_pytorch_tpu_torch.tools.train_bench import (
        _ref_groups,
        calibrate_frozen_bn,
        calibration_frames,
    )
    from mega_pytorch_tpu_torch.utils import profiler
    from mega_pytorch_tpu_torch.utils.checkpoint import Checkpointer

    dev = torch.device("cuda")
    rs = np.random.RandomState(13)
    kernels = _kernels()
    rec: dict = dict(step_ms=[], launches=[])
    step = trainer.train_step

    def recording_step(model, optimizer, scheduler, *args, **kw):
        if not rec["step_ms"]:
            rec.update(model=model, optimizer=optimizer, scheduler=scheduler,
                       initial=_snapshot(model, optimizer, scheduler)[0])
        before = {k.__name__: k.launches for k in kernels}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = step(model, optimizer, scheduler, *args, **kw)
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["launches"].append({k.__name__: k.launches - before[k.__name__] for k in kernels})
        if len(rec["step_ms"]) == 1:  # which parameters the first step moved
            initial = rec["initial"]
            moved = {n: not torch.equal(p.detach(), initial[n])
                     for n, p in model.named_parameters() if p.requires_grad}
            rec["moved"] = {g["name"]: [moved[n] for n in _names(model, g)]
                            for g in optimizer.param_groups}
            rec["moved_modules"] = {}
            for n, m in moved.items():
                top = n.split(".")[0]
                rec["moved_modules"][top] = rec["moved_modules"].get(top, False) or m
        if len(rec["step_ms"]) == ckpt:
            rec["at_ckpt"] = _snapshot(model, optimizer, scheduler)
        return losses

    def _names(model, group):
        by_id = {id(p): n for n, p in model.named_parameters()}
        return [by_id[id(p)] for p in group["params"]]

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        portrait = {"VID_train_15frames": [v in (1, 4) for v in range(len(TRAIN_VIDEOS))],
                    "DET_train_30classes": [v == 2 for v in range(TRAIN_STILLS)]}
        _write_vid_tree(root, TRAIN_VIDEOS, portrait["VID_train_15frames"], TRAIN_FRAME, rs,
                        index="VID_train_15frames.txt", listed=15)
        _write_vid_tree(root, [1] * TRAIN_STILLS, portrait["DET_train_30classes"],
                        TRAIN_FRAME, rs, index="DET_train_30classes.txt", det=True)
        frames_cls = _synthetic_frames(getattr(vid, dataset_name), TRAIN_FRAME, rs)

        def synthetic_dataset(name, method, is_train, data_dir, rng):
            return frames_cls(**dataset_args(name, data_dir), is_train=is_train, rng=rng,
                              portrait=portrait[name])

        out_dir = root / "out"
        args = ["--preset", preset, "--data-dir", tmp, "--output-dir", str(out_dir),
                "--seed", "0", "--device", "cuda", "opts", "SOLVER.MAX_ITER",
                str(iters), "SOLVER.CHECKPOINT_PERIOD", str(ckpt)]
        cfg = load_config(train_net.parse_args(args))
        k = cfg.SOLVER.IMS_PER_BATCH
        refs = " + ".join(f"{n} {key}" for key, n in _ref_groups(cfg).items())
        print(f"[{tag}] {preset}: {cfg.MODEL.BACKBONE.CONV_BODY} {cfg.MODEL.VID.METHOD}, "
              f"{cfg.TPU.COMPUTE_DTYPE} compute, canvas {cfg.TPU.CANVAS_HEIGHT}x"
              f"{cfg.TPU.CANVAS_WIDTH}, MIN/MAX_SIZE_TRAIN {cfg.INPUT.MIN_SIZE_TRAIN}/"
              f"{cfg.INPUT.MAX_SIZE_TRAIN}, ROI batch {cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE}"
              f", {k} samples an iteration of cur + {refs}; sets {cfg.DATASETS.TRAIN}: "
              f"{len(TRAIN_VIDEOS)} videos of {min(TRAIN_VIDEOS)}-{max(TRAIN_VIDEOS)} frames "
              f"and {TRAIN_STILLS} stills of {TRAIN_FRAME[0]}x{TRAIN_FRAME[1]}, two portrait "
              "videos and one portrait still")
        torch.cuda.reset_peak_memory_stats()
        for kern in kernels:
            kern.launches = 0
        # the FrozenBN statistics of the seeded model calibrated on two
        # seeded frames of the training frames' kind, preprocessed as they are
        calib = calibration_frames(cfg, TRAIN_FRAME, rs, dev)

        def calibrated(*a, **kw):
            return calibrate_frozen_bn(build(*a, **kw), calib)

        build, catalog = detectors.build_training_model, paths_catalog.build_dataset
        trainer.train_step = recording_step
        detectors.build_training_model = calibrated
        paths_catalog.build_dataset = synthetic_dataset
        try:
            t0 = time.perf_counter()
            # the loader's "feed" span: each batch's reading and preprocessing
            with profiler.recording():
                record = train_net.main(args)
            wall = time.perf_counter() - t0
        finally:
            trainer.train_step = step
            detectors.build_training_model, paths_catalog.build_dataset = build, catalog
        feed_span = profiler.recorded()["spans"]["feed"]
        launches = {kern.__name__: kern.launches for kern in kernels}
        peak = torch.cuda.max_memory_allocated() / 2**20

        n_iter = len(record["losses"])
        for i, losses in enumerate(record["losses"]):
            print(f"[{tag}] iteration {i + 1}: " + ", ".join(
                f"{key} {v:.5f}" for key, v in losses.items())
                + f"; {rec['step_ms'][i]:.1f} ms")
        if n_iter != iters or not all(np.isfinite(v) for losses in record["losses"]
                                      for v in losses.values()):
            _fail(f"{tag}: {n_iter} iterations, or a loss that is not finite")
        bad = [(i, c) for i, c in enumerate(rec["launches"]) if c != per_iter]
        print(f"[{tag}] launches {launches}; per iteration {per_iter} expected, "
              f"iterations that differ: {bad[:3]}")
        if bad:
            _fail(f"{tag}: kernel launches per iteration differ from the expected")
        moved = {g: (sum(m), len(m)) for g, m in rec["moved"].items()}
        print(f"[{tag}] parameters the first step moved, by group: {moved}; modules moved: "
              f"{rec['moved_modules']}")
        if not all(n > 0 for n, _ in moved.values()) or not all(
                rec["moved_modules"].values()):
            _fail(f"{tag}: a trainable parameter group or module did not move in the first "
                  "step")
        model, optimizer, scheduler = rec["model"], rec["optimizer"], rec["scheduler"]
        params = dict(model.named_parameters())
        final = model.state_dict()
        frozen = [n for n in final if n not in params or not params[n].requires_grad]
        kept = all(torch.equal(final[n], rec["initial"][n]) for n in frozen)
        print(f"[{tag}] {len(frozen)} frozen parameters and buffers (stem, layer1, "
              f"FrozenBN) bit-identical after {n_iter} iterations: {kept}")
        if not kept or not any(n.startswith("backbone.stem.") for n in frozen):
            _fail(f"{tag}: a frozen parameter or buffer changed")

        payload = Checkpointer(str(out_dir)).load(str(out_dir / f"model_{ckpt:07d}.pth"))
        fresh = build_training_model(cfg, dev, torch.Generator(dev).manual_seed(1))
        fresh_opt = make_optimizer(cfg, fresh)
        fresh_sched = make_lr_scheduler(cfg, fresh_opt)
        start = Checkpointer.restore(payload, fresh, fresh_opt, fresh_sched)
        restored = _snapshot(fresh, fresh_opt, fresh_sched)
        same = [_same_state(a, b) for a, b in zip(restored, rec["at_ckpt"])]
        print(f"[{tag}] checkpoint {ckpt} restored into a fresh model, optimizer and "
              f"scheduler: iteration {start}; weights, momentum buffers, scheduler position "
              f"equal the live state there bit for bit: {same}")
        if start != ckpt or not all(same):
            _fail(f"{tag}: the checkpoint does not restore the saved state")
        del fresh, fresh_opt, fresh_sched, payload, rec["at_ckpt"], rec["initial"]
        del model, optimizer, scheduler, rec["model"], rec["optimizer"], rec["scheduler"]

    steady = rec["step_ms"][2:]
    ms = statistics.median(steady)
    loop_s = sum(record["iter_s"])
    feed = feed_span["host_ms"] / feed_span["calls"]
    frames = k * (1 + sum(_ref_groups(cfg).values()))
    print(f"[{tag}] iteration (synchronised, median of iterations 3..{n_iter}): {ms:.1f} ms; "
          f"first {rec['step_ms'][0]:.1f} ms; whole run {n_iter * k} samples in "
          f"{loop_s:.2f} s of the loop = {n_iter * k / loop_s:.3f} samples/s ({wall:.1f} s "
          f"with set-up); producer mean {feed:.1f} ms an iteration ({frames} frames read and "
          f"preprocessed on one thread) against the {ms:.1f} ms iteration: share "
          f"{feed / ms:.3f}; peak memory {peak:.0f} MiB; {smi}")
    torch.cuda.empty_cache()
    return launches, per_iter


def phase_train(smi):
    """MEGA R-101 training (the ``mega_R_101`` preset: one sample an
    iteration of cur + 2 local, 3 memory and 2 global frames), TRAIN_ITERS
    iterations with a checkpoint at TRAIN_CKPT."""
    return run_training(smi, "mega_R_101", "VIDMEGADataset", TRAIN_ITERS, TRAIN_CKPT,
                        PER_ITER_TRAIN, "train")


def phase_method_training(smi):
    """RDN (``rdn_R_101``: the advanced stage, IMS_PER_BATCH 4 samples of cur
    + 2 refs one after the other), FGFA (``fgfa_R_101``: cur + 2 refs) and
    DFF (``dff_R_101``: cur + 1 ref) training, METHOD_TRAIN_ITERS iterations
    each with a checkpoint at METHOD_TRAIN_CKPT. Returns {method: (launches,
    launches per iteration)}."""
    return {method: run_training(smi, preset, dataset_name, METHOD_TRAIN_ITERS,
                                 METHOD_TRAIN_CKPT, per_iter, f"{method} train")
            for method, (preset, dataset_name, per_iter) in METHOD_TRAIN.items()}


def phase_pos_function():
    """Mode "compute" through ``RelationAttentionPosFunction`` at one lane of
    MEGA stage 0 and of RDN's base stages (uk = 0): one launch, the forward
    bit for bit the kernel's, nothing launched in backward, and the eight
    gradients (q, k, v, uk, rois, refs, Wg's kernel and bias) against
    ``torch.autograd.grad`` through the plain version with bf16 sinusoids,
    each within RTOL_POS_GRAD of its leaf's largest magnitude; the forward
    and backward timed against the plain version's. Wg's bias is raised by
    2 (as the card tests' ``_pos``): at pw's relu floor the function is
    ill-conditioned in the sinusoids' last bits, where one bf16 step of a
    sinusoid switches pw between 0 and a small value. Returns one entry a
    shape."""
    import torch
    from mega_pytorch_tpu_torch.ops.kernels import relation_attention as ra
    from mega_pytorch_tpu_torch.tools.kernel_bench import time_alternating

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(9)
    names = ("q", "k", "v", "uk", "rois", "refs", "wk", "wb")
    launch, fn = ra.flash_relation_attention_pos, ra.RelationAttentionPosFunction
    entries = []
    for label, n, m, u_bias in POS_FUNCTION_SHAPES:
        x = _attention_inputs(gen, 1, n, m, dev)
        if not u_bias:
            x["uk"] = torch.zeros_like(x["uk"])
        x["wb"] = x["wb"] + 2.0
        ops, valid = [x[k] for k in names], x["valid"]
        kernel_out = launch(*ops, valid)
        leaves = [t.clone().requires_grad_() for t in ops]
        before = launch.launches
        out = fn.apply(*leaves, valid, launch)
        cot = torch.randn(out.shape, generator=gen, device=dev)
        grads = torch.autograd.grad(out, leaves, cot)
        launched = launch.launches - before
        same_fwd = torch.equal(out.detach(), kernel_out)
        plain = ra.reference_relation_attention_pos(*leaves, valid, sin_dtype=torch.bfloat16)
        want = torch.autograd.grad(plain, leaves, cot)
        errs = {name: (g.float() - w.float()).abs().max().item()
                / max(w.float().abs().max().item(), 1e-30)
                for name, g, w in zip(names, grads, want)}
        bit = all(torch.equal(g, w) for g, w in zip(grads, want))
        dtypes = all(g.dtype == t.dtype for g, t in zip(grads, leaves))
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        del plain, want, grads, out

        def fwd():
            return fn.apply(*leaves, valid, launch)

        def fwd_bwd():
            return torch.autograd.grad(fn.apply(*leaves, valid, launch), leaves, cot)

        def plain_fwd():
            return ra.reference_relation_attention_pos(*leaves, valid,
                                                       sin_dtype=torch.bfloat16)

        def plain_fwd_bwd():
            return torch.autograd.grad(plain_fwd(), leaves, cot)

        pf, kf, pfb, kfb = time_alternating([plain_fwd, fwd, plain_fwd_bwd, fwd_bwd], 5, 3)
        entry = dict(stage=label, B=1, N=n, M=m, fwd_ms=kf, bwd_ms=kfb - kf,
                     plain_fwd_ms=pf, plain_bwd_ms=pfb - pf,
                     grad_rel_err=max(errs.values()), grads_bit_equal=bit)
        print(f"[pos function] {label} N={n} M={m} B=1 (uk {'drawn' if u_bias else '0'}, Wg "
              f"bias + 2): launches {launched}, forward == kernel bit for bit {same_fwd}; "
              f"gradients vs autograd through the bf16-sinusoid plain version, largest "
              f"relative error per leaf "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f" (tolerance {RTOL_POS_GRAD}), bit for bit {bit}; forward {kf:.4f} ms "
              f"(plain {pf:.4f}), backward {kfb - kf:.4f} ms (plain {pfb - pf:.4f})")
        if launched != 1 or not same_fwd or not dtypes or not finite:
            _fail(f"pos function ({label}): launches {launched}, forward equal {same_fwd}, "
                  f"dtypes {dtypes}, finite {finite}")
        if not all(e <= RTOL_POS_GRAD for e in errs.values()):
            _fail(f"pos function ({label}): gradients {errs} beyond {RTOL_POS_GRAD}")
        entries.append(entry)
        del x, ops, leaves
        torch.cuda.empty_cache()
    return entries


def _draw_frames(rs, n, frame_hw):
    """n uint8 RGB frames: a smooth gradient with a few coloured boxes that
    move from frame to frame (frames a JPEG encoder compresses as it would
    a video's, unlike noise)."""
    h, w = frame_hw
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 200 // w, yy * 200 // h, (xx + yy) * 100 // (h + w)], -1)
    boxes = [(rs.randint(0, h // 2), rs.randint(0, w // 2), rs.randint(h // 12, h // 4),
              rs.randint(w // 12, w // 4), rs.randint(0, 256, 3), rs.randint(-8, 9, 2))
             for _ in range(4)]
    frames = []
    for f in range(n):
        img = base.astype(np.uint8).copy()
        for y, x, bh, bw, color, (dy, dx) in boxes:
            y0, x0 = np.clip(y + dy * f, 0, h - bh), np.clip(x + dx * f, 0, w - bw)
            img[y0:y0 + bh, x0:x0 + bw] = color
        frames.append(img)
    return frames


def _write_jpegs(folder: Path, frames):
    """frames → ``folder/{i:06d}.JPEG`` (PIL, quality 90)."""
    from PIL import Image

    folder.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, arr in enumerate(frames):
        paths.append(folder / f"{i:06d}.JPEG")
        Image.fromarray(arr).save(paths[-1], quality=90)
    return paths


def phase_tta(smi):
    """Test-time augmentation through ``tools/test_net.py``'s ``main``: the
    ``base_R_101`` preset (bf16, 608x1024 canvas, random weights from seed
    0) over an on-disk ILSVRC2015 tree of one video of TTA_FRAMES JPEG
    frames of 720x1280 (index, XML annotations, files decoded by PIL), with
    ``TEST.BBOX_AUG`` on, ``H_FLIP`` and ``SCALE_H_FLIP``, TTA_SCALES and
    ``MAX_SIZE`` 2000: every frame runs the detector TTA_RUNS times and
    launches the stem pool TTA_RUNS times (counted per frame), the merged
    detections capped at TEST.DETECTIONS_PER_IMG and inside the image,
    evaluation run. Each frame's ``im_detect_bbox_aug`` (after the decode)
    is timed whole, with its host preprocessing (``preprocess_image``: the
    resize and the canvas) and its detector runs (``forward_test``, the
    device synchronised on both sides) apart; the first frame meets every
    canvas shape for the first time, so the reported ms are the median of
    the frames after it. Returns (launches, launches a frame, ms a frame)."""
    import tempfile

    import torch
    from mega_pytorch_tpu_torch.engine import bbox_aug
    from mega_pytorch_tpu_torch.models.detectors.rcnn import GeneralizedRCNN
    from mega_pytorch_tpu_torch.tools import test_net

    rs = np.random.RandomState(17)
    kernels = _kernels()
    stem = next(k for k in kernels if k.__name__ == "stem_pool_packed")
    calls, prep_s, runs_s, frames = [0], [0.0], [0.0], []
    forward_test, detect = GeneralizedRCNN.forward_test, bbox_aug.im_detect_bbox_aug
    preprocess = bbox_aug.preprocess_image

    def counted(self, *a):
        calls[0] += 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = forward_test(self, *a)
        torch.cuda.synchronize()
        runs_s[0] += time.perf_counter() - t0
        return out

    def timed_preprocess(*a, **k):
        t0 = time.perf_counter()
        out = preprocess(*a, **k)
        prep_s[0] += time.perf_counter() - t0
        return out

    def timed_frame(*a, **k):
        prep_s[0] = runs_s[0] = 0.0
        before = stem.launches
        t0 = time.perf_counter()
        out = detect(*a, **k)  # host arrays: the device has finished
        ms = (time.perf_counter() - t0) * 1e3
        frames.append(dict(ms=ms, prep_ms=prep_s[0] * 1e3, runs_ms=runs_s[0] * 1e3,
                           stem_pools=stem.launches - before))
        return out

    opts = ["TEST.BBOX_AUG.ENABLED", "True", "TEST.BBOX_AUG.H_FLIP", "True",
            "TEST.BBOX_AUG.SCALE_H_FLIP", "True", "TEST.BBOX_AUG.SCALES", str(TTA_SCALES),
            "TEST.BBOX_AUG.MAX_SIZE", "2000"]
    patched = (counted, timed_frame, timed_preprocess)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        _write_vid_tree(root, [TTA_FRAMES], [False], EVAL_FRAME, rs,
                        index="VID_val_frames.txt")
        _write_jpegs(root / "ILSVRC2015" / "Data" / "VID" / "val" / "v000",
                     _draw_frames(rs, TTA_FRAMES, EVAL_FRAME))
        for k in kernels:
            k.launches = 0
        (GeneralizedRCNN.forward_test, bbox_aug.im_detect_bbox_aug,
         bbox_aug.preprocess_image) = patched
        try:
            t0 = time.perf_counter()
            run = test_net.main(["--preset", "base_R_101", "--data-dir", tmp, "--output-dir",
                                 str(root / "out"), "--device", "cuda", "opts", *opts])
            wall = time.perf_counter() - t0
        finally:
            (GeneralizedRCNN.forward_test, bbox_aug.im_detect_bbox_aug,
             bbox_aug.preprocess_image) = forward_test, detect, preprocess
        launches = {k.__name__: k.launches for k in kernels}
    preds = run["predictions"]
    cap = 300  # the preset's TEST.DETECTIONS_PER_IMG
    h, w = EVAL_FRAME
    counts = [len(p["boxes"]) for p in preds.values()]
    inside = all(np.isfinite(p["boxes"]).all() and (not len(p["boxes"]) or (
        p["boxes"][:, [0, 2]].max() <= w + 1 and p["boxes"][:, [1, 3]].max() <= h + 1
        and p["boxes"].min() >= -1)) for p in preds.values())
    expect = dict(_NO_KERNEL, stem_pool_packed=TTA_RUNS * TTA_FRAMES,
                  roi_align=TTA_RUNS * TTA_FRAMES,
                  bottleneck_epilogue=EPI_PASS * TTA_RUNS * TTA_FRAMES)
    warm = {k: statistics.median(f[k] for f in frames[1:]) for k in ("ms", "prep_ms", "runs_ms")}
    rest = warm["ms"] - warm["prep_ms"] - warm["runs_ms"]
    per_frame = "; ".join(f"{f['ms']:.1f} ms (preprocessing {f['prep_ms']:.1f}, runs "
                          f"{f['runs_ms']:.1f}), {f['stem_pools']} stem pools" for f in frames)
    print(f"[tta] base_R_101 (bf16) through test_net.main, TEST.BBOX_AUG: the base size and "
          f"scales {TTA_SCALES}, each with its flip, MAX_SIZE 2000, {TTA_FRAMES} JPEG frames of "
          f"{h}x{w}: {calls[0]} detector runs ({TTA_RUNS} a frame expected), detections a "
          f"frame {counts} (cap {cap}), inside the image {inside}; launches {launches} "
          f"(expected {expect}); per frame (after the decode): {per_frame}; warm frames "
          f"(median of frames 2..{TTA_FRAMES}): {warm['ms']:.1f} ms a frame = host "
          f"preprocessing {warm['prep_ms']:.1f} ({TTA_RUNS} resizes and canvases) + detector "
          f"runs {warm['runs_ms']:.1f} (synchronised) + the rest {rest:.1f} (packing, copies, "
          f"merge); main {wall:.1f} s with the model's build; AP50 "
          f"{run['result']['all']['map']:.4f} (random weights); {smi}")
    if calls[0] != TTA_RUNS * TTA_FRAMES or sorted(preds) != list(range(TTA_FRAMES)):
        _fail(f"tta: {calls[0]} detector runs over {sorted(preds)}")
    if max(counts) > cap or not inside:
        _fail("tta: detections beyond the cap or outside the image")
    if launches != expect or [f["stem_pools"] for f in frames] != [TTA_RUNS] * TTA_FRAMES:
        _fail(f"tta: launches {launches} != {expect}, or not {TTA_RUNS} stem pools in "
              f"every frame ({[f['stem_pools'] for f in frames]})")
    torch.cuda.empty_cache()
    return launches, dict(_NO_KERNEL, stem_pool_packed=TTA_RUNS, roi_align=TTA_RUNS,
                          bottleneck_epilogue=EPI_PASS * TTA_RUNS), warm["ms"]


def phase_demo(smi):
    """The frame-folder demo: DEMO_FRAMES JPEG frames of 720x1280 through
    ``tools/demo.py``'s ``main`` with the ``mega_R_101`` preset (bf16,
    608x1024 canvas, random weights from seed 0, s2d(4)-packed canvases):
    every frame annotated and written at the input size, the stem pool,
    "none" and "compute" launched, one detection a frame (the attention
    counts a multiple of the frames), and its detections bit for bit those
    of ``StreamingInferencer`` over the same frames with the same seeded
    model and preprocessor. The run is timed whole, with the serial
    engine's steps (``StreamingInferencer.step``, the device synchronised on
    both sides; frame 0's step holds the window's read-ahead and the global
    frames) apart from the rest (decodes, preprocessing, drawing, writing).
    Returns (launches, ms a frame)."""
    import tempfile

    import torch
    from PIL import Image

    from mega_pytorch_tpu_torch.config import get_preset
    from mega_pytorch_tpu_torch.data.loader import eval_preprocessor
    from mega_pytorch_tpu_torch.engine.batched_inference import _to_host, pack_factor
    from mega_pytorch_tpu_torch.engine.inference import StreamingInferencer, _extract
    from mega_pytorch_tpu_torch.models.detectors import build_detection_model
    from mega_pytorch_tpu_torch.tools import demo

    dev = torch.device("cuda")
    rs = np.random.RandomState(19)
    kernels = _kernels()
    wall, steps_s = [], [0.0]
    run_demo, step = demo.run_demo, StreamingInferencer.step

    def timed_run(*a, **k):
        t0 = time.perf_counter()
        out = run_demo(*a, **k)  # host arrays and written files: the device has finished
        wall.append(time.perf_counter() - t0)
        return out

    def timed_step(self, sample):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(self, sample)
        torch.cuda.synchronize()
        steps_s[0] += time.perf_counter() - t0
        return out

    with tempfile.TemporaryDirectory() as tmp:
        folder, out_dir = Path(tmp) / "frames", Path(tmp) / "vis"
        _write_jpegs(folder, _draw_frames(rs, DEMO_FRAMES, EVAL_FRAME))
        for k in kernels:
            k.launches = 0
        demo.run_demo, StreamingInferencer.step = timed_run, timed_step
        try:
            run = demo.main(["--preset", "mega_R_101", "--input-folder", str(folder),
                             "--output-folder", str(out_dir), "--device", "cuda",
                             "--confidence-threshold", "0.05"])
        finally:
            demo.run_demo, StreamingInferencer.step = run_demo, step
        launches = {k.__name__: k.launches for k in kernels}
        written = sorted(out_dir.iterdir())
        sizes = set()
        for p in written:
            with Image.open(p) as im:
                sizes.add(im.size)
        cfg = get_preset("mega_R_101").freeze()
        model = build_detection_model(cfg, dev, torch.Generator(dev).manual_seed(0))
        video = demo.FolderVideo(str(folder))
        ds = demo.VideoDataset(video, "mega", cfg)
        prep = eval_preprocessor(cfg)
        runner = StreamingInferencer(model, "mega", prep, ds)
        want = {}
        for i in range(len(ds)):
            sample = prep(ds[i])
            want[i] = _extract(_to_host(runner.step(sample)), sample["cur_size"][0],
                               EVAL_FRAME)
    preds = run["predictions"]
    same = sorted(preds) == sorted(want) and all(
        np.array_equal(preds[i][k], want[i][k]) for i in want
        for k in ("boxes", "scores", "labels"))
    ms = wall[0] * 1e3 / DEMO_FRAMES
    steps_ms = steps_s[0] * 1e3 / DEMO_FRAMES
    h, w = EVAL_FRAME
    packed = pack_factor("mega", (cfg.TPU.CANVAS_HEIGHT, cfg.TPU.CANVAS_WIDTH))
    print(f"[demo] mega_R_101 (bf16, packed s2d({packed})) over {DEMO_FRAMES} JPEG frames of "
          f"{h}x{w}: {len(written)} annotated frames written, sizes {sorted(sizes)}; "
          f"detections == StreamingInferencer's bit for bit {same} "
          f"({sum(len(p['boxes']) for p in preds.values())} boxes); launches {launches}; "
          f"{ms:.1f} ms a frame end to end = the engine's steps {steps_ms:.1f} (synchronised) "
          f"+ the rest {ms - steps_ms:.1f} (decodes, preprocessing, drawing, writing); {smi}")
    if len(written) != DEMO_FRAMES or sizes != {(w, h)}:
        _fail(f"demo: {len(written)} frames of sizes {sizes} written")
    if not same:
        _fail("demo: detections differ from StreamingInferencer's")
    path_kernels = ("stem_pool_packed", "flash_relation_attention",
                    "flash_relation_attention_pos", "roi_align", "bottleneck_epilogue")
    # a body pass of epilogues with each stem pool, and whole res5 passes
    res5_epilogues = launches["bottleneck_epilogue"] - EPI_C4 * launches["stem_pool_packed"]
    if (not all(launches[k] > 0 for k in path_kernels)
            or res5_epilogues <= 0 or res5_epilogues % EPI_RES5
            or launches["flash_relation_attention_bias"] or launches["fused_position_bias"]
            or launches["flash_relation_attention"] % DEMO_FRAMES
            or launches["flash_relation_attention_pos"] % DEMO_FRAMES):
        _fail(f"demo: launches {launches}")
    del model, runner
    torch.cuda.empty_cache()
    return launches, ms


def phase_gn(smi):
    """Group norm: ``base_R_50`` with ``BottleneckWithGN`` / ``StemWithGN``
    (bf16, random weights from seed 0) on 2 s2d(4)-packed 608x1024 frames:
    its C4 map against the same weights in f32 on the canonical RGB frames
    (TF32 off) within RTOL_GN_MAX / RTOL_GN_MEAN, the f32 model's packed
    route against its canonical one within RTOL_GN_F32, no stem pool
    launch, ``forward_test`` finite; then ``build_resnet_c4`` of R-101 with
    NUM_GROUPS 32 and WIDTH_PER_GROUP 8 (the X-101-32x8d widths, frozen BN)
    timed on one packed frame. Returns the GN detector's launches."""
    import torch
    from mega_pytorch_tpu_torch.config import get_preset
    from mega_pytorch_tpu_torch.data.transforms import normalize_u8_frames, s2d_pack_frames
    from mega_pytorch_tpu_torch.models.backbone.resnet import build_resnet_c4
    from mega_pytorch_tpu_torch.models.detectors import build_detection_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    opts = ["MODEL.RESNETS.TRANS_FUNC", "BottleneckWithGN",
            "MODEL.RESNETS.STEM_FUNC", "StemWithGN"]
    models = {}
    for dtype in ("bfloat16", "float32"):
        cfg = get_preset("base_R_50")
        cfg.merge_from_list(opts + ["TPU.COMPUTE_DTYPE", dtype])
        models[dtype] = build_detection_model(cfg.freeze(), dev,
                                              torch.Generator(dev).manual_seed(0))
    rs = np.random.RandomState(21)
    raw = _draw_frames(rs, 2, CANVAS)
    sizes = torch.tensor(CANVAS, dtype=torch.float32, device=dev).expand(2, 2)
    kernels = _kernels()
    with torch.inference_mode():
        x48 = normalize_u8_frames(torch.from_numpy(s2d_pack_frames(np.stack(raw), 4)).to(dev),
                                  sizes)
        x3 = normalize_u8_frames(torch.from_numpy(np.stack(raw)).to(dev), sizes)
        for k in kernels:
            k.launches = 0
        got = models["bfloat16"].backbone(x48).float()
        dets = models["bfloat16"].forward_test(x48, sizes)
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in kernels}
        packed32 = models["float32"].backbone(x48)
        torch.cuda.synchronize()
        launches_f32 = sum(k.launches for k in kernels)
        want = models["float32"].backbone(x3)
    err = (got - want).abs()
    scale = want.abs()
    rel_max, rel_mean = (err.max() / scale.max()).item(), (err.mean() / scale.mean()).item()
    rel_f32 = ((packed32 - want).abs().max() / scale.max()).item()
    finite = bool(torch.isfinite(dets.boxes).all() and torch.isfinite(dets.scores).all())
    print(f"[gn] base_R_50 with group norm on 2 {CANVAS[0]}x{CANVAS[1]} frames, C4 map "
          f"{tuple(got.shape)}, against f32 on the RGB frames: f32 on the packed frames "
          f"{rel_f32:.3e} of the largest magnitude (tolerance {RTOL_GN_F32}); bf16 on the "
          f"packed frames largest error {rel_max:.3e} of the largest magnitude (tolerance "
          f"{RTOL_GN_MAX}), mean error {rel_mean:.3e} of the mean magnitude (tolerance "
          f"{RTOL_GN_MEAN}); forward_test finite {finite}; launches {launches} (f32 packed "
          f"route: {launches_f32}); {smi}")
    if launches != dict(_NO_KERNEL, roi_align=1) or launches_f32 != 1:
        _fail(f"gn: launches {launches}, {launches_f32}: the GN stem must take no kernel "
              f"(forward_test's one ROIAlign aside)")
    if not (rel_f32 <= RTOL_GN_F32 and rel_max <= RTOL_GN_MAX
            and rel_mean <= RTOL_GN_MEAN) or not finite:
        _fail("gn: the GN backbone differs from its f32 canonical self or is not finite")
    del models, dets
    torch.cuda.empty_cache()

    cfg = get_preset("base_R_101")
    cfg.merge_from_list(["MODEL.RESNETS.NUM_GROUPS", "32", "MODEL.RESNETS.WIDTH_PER_GROUP",
                         "8"])
    body = build_resnet_c4(cfg.freeze(), dev)
    gen = torch.Generator(dev).manual_seed(1)
    for m in body.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(gen)
    for m in body.modules():
        if hasattr(m, "cast_weights_"):
            m.cast_weights_()
    body.eval().requires_grad_(False)
    ms = []
    from mega_pytorch_tpu_torch.ops.kernels.bottleneck_epilogue import (
        bottleneck_epilogue as epilogue,
    )

    epilogue.launches = 0
    with torch.inference_mode():
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c4 = body(x48[:1])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    print(f"[gn] build_resnet_c4 R-101 32x8d (NUM_GROUPS 32, WIDTH_PER_GROUP 8, bf16, "
          f"frozen BN): C4 map {tuple(c4.shape)} finite {bool(torch.isfinite(c4).all())}, "
          f"median {statistics.median(ms[1:]):.2f} ms a packed {CANVAS[0]}x{CANVAS[1]} frame "
          f"(first call {ms[0]:.1f} ms), bottleneck epilogues {epilogue.launches}; {smi}")
    if tuple(c4.shape) != (1, CANVAS[0] // 16, CANVAS[1] // 16, 1024) or not bool(
            torch.isfinite(c4).all()):
        _fail("gn: the 32x8d C4 body's output is wrong")
    if epilogue.launches != 6 * EPI_C4:
        _fail(f"gn: the 32x8d C4 body launched {epilogue.launches} epilogues in 6 passes")
    del body
    torch.cuda.empty_cache()
    return launches


def phase_native_loader(smi):
    """Information only: whether the native JPEG loader builds on this
    machine (g++, libjpeg's jpeglib.h), and the reason if not. If it builds,
    ``load_batch`` of DEMO_FRAMES 720x1280 JPEG frames must equal
    ``load_frame`` frame by frame; both are timed beside the port's PIL
    decode and PIL-exact resize. Host code: a missing toolchain does not
    fail the check."""
    import tempfile

    from mega_pytorch_tpu_torch.config import get_preset
    from mega_pytorch_tpu_torch.data import native_loader
    from mega_pytorch_tpu_torch.data.datasets.vid import decode_rgb
    from mega_pytorch_tpu_torch.data.transforms import preprocess_image

    try:
        native_loader.get_lib()
    except subprocess.CalledProcessError as e:
        reason = " ".join(str(e.stderr).split())[-300:]
        print(f"[loader] unavailable: g++ failed: {reason}")
        return {"built": False, "reason": f"g++ failed: {reason}"}
    except OSError as e:
        print(f"[loader] unavailable: {e}")
        return {"built": False, "reason": str(e)}
    rs = np.random.RandomState(23)
    cfg = get_preset("mega_R_101")  # the demo's sizes: 600 / 1000 on the 608x1024 canvas
    args = (cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST)
    canvas = (cfg.TPU.CANVAS_HEIGHT, cfg.TPU.CANVAS_WIDTH)
    with tempfile.TemporaryDirectory() as tmp:
        paths = [str(p) for p in _write_jpegs(Path(tmp), _draw_frames(rs, DEMO_FRAMES,
                                                                     EVAL_FRAME))]
        flips = [False] * len(paths)
        t0 = time.perf_counter()
        batch, hws = native_loader.load_batch(paths, *args, flips, *canvas)
        batch_ms = (time.perf_counter() - t0) * 1e3 / len(paths)
        t0 = time.perf_counter()
        frames = [native_loader.load_frame(p, *args, False, *canvas) for p in paths]
        frame_ms = (time.perf_counter() - t0) * 1e3 / len(paths)
        t0 = time.perf_counter()
        pil = [preprocess_image(decode_rgb(p), *args, False, *canvas) for p in paths]
        pil_ms = (time.perf_counter() - t0) * 1e3 / len(paths)
    same = all(np.array_equal(batch[i], f) and tuple(hws[i]) == hw
               for i, (f, hw) in enumerate(frames))
    oh, ow = frames[0][1]
    diff = float(np.abs(batch[0][:oh, :ow] - pil[0].image[:oh, :ow]).mean())
    print(f"[loader] built; load_batch == load_frame frame by frame {same}; per "
          f"{EVAL_FRAME[0]}x{EVAL_FRAME[1]} frame: load_batch {batch_ms:.2f} ms (8 threads), "
          f"load_frame {frame_ms:.2f} ms, PIL decode + PIL-exact preprocess_image "
          f"{pil_ms:.2f} ms (one thread); mean difference from the PIL-exact canvas "
          f"{diff:.3f} levels; {smi}")
    if not same:
        _fail("loader: load_batch differs from load_frame")
    return {"built": True, "batch_ms": batch_ms, "frame_ms": frame_ms, "pil_ms": pil_ms}


def _sync_ms(fn, repeats=5):
    """(median ms, last result) of ``fn`` over ``repeats`` calls after one
    warm-up, each call synchronised on the host clock."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms), out


def _peak(fn):
    """(median ms, peak MB, scratch MB above what was allocated before, result)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms, out = _sync_ms(fn, 3)
    peak = torch.cuda.max_memory_allocated()
    return ms, peak / 2**20, (peak - base) / 2**20, out


def _zoo_frames(dev):
    """ZOO_FRAMES drawn 720x1280 frames through the port's preprocessing at
    MIN_SIZE_TEST 800 / MAX_SIZE_TEST 1333 onto the 800x1344 canvas:
    (s2d(4)-packed normalised frames, RGB normalised canvases, sizes)."""
    import torch
    from mega_pytorch_tpu_torch.data.transforms import (
        normalize_u8_frames,
        preprocess_image_u8,
        s2d_pack_frames,
    )

    rs = np.random.RandomState(24)
    pre = [preprocess_image_u8(f, *ZOO_SIZES, False, *ZOO_CANVAS)
           for f in _draw_frames(rs, ZOO_FRAMES, ZOO_FRAME)]
    canvas = np.stack([p.image for p in pre])
    sizes = torch.tensor(np.stack([p.size for p in pre]), device=dev)
    packed = normalize_u8_frames(torch.from_numpy(s2d_pack_frames(canvas, 4)).to(dev), sizes)
    rgb = normalize_u8_frames(torch.from_numpy(canvas).to(dev), sizes)
    return packed, rgb, sizes


def _zoo_boxes(rs, b, n, h, w, lo=16.0, hi=400.0):
    """(b, n, 4) boxes of lo-hi pixels inside an h x w image."""
    wh = rs.uniform(lo, hi, size=(b, n, 2))
    x1 = rs.uniform(0, w - 1 - wh[..., 0])
    y1 = rs.uniform(0, h - 1 - wh[..., 1])
    return np.stack([x1, y1, x1 + wh[..., 0], y1 + wh[..., 1]], -1).astype(np.float32)


def _same_on_card(name, cpu_module, inputs, call, dev, rtol=RTOL_ZOO, tag="zoo"):
    """The f32 module on the CPU and a copy on the card, on the same inputs:
    each output within ``rtol`` of its largest magnitude."""
    import copy

    import torch

    def to_card(x):
        if isinstance(x, (list, tuple)):
            return [to_card(v) for v in x]
        return x.to(dev) if isinstance(x, torch.Tensor) else x

    def flat(out):
        return list(out) if isinstance(out, (list, tuple)) else [out]

    card = copy.deepcopy(cpu_module).to(dev)
    with torch.inference_mode():
        want = flat(call(cpu_module, *inputs))
        got = flat(call(card, *to_card(inputs)))
    worst = 0.0
    for g, w in zip(got, want):
        g = g.float().cpu()
        if g.shape != w.shape or not torch.isfinite(g).all():
            _fail(f"{tag}: {name} on the card: shape {tuple(g.shape)} vs {tuple(w.shape)} "
                  f"or not finite")
        scale = w.abs().max().item()
        worst = max(worst, (g - w).abs().max().item() / max(scale, 1e-30))
    print(f"[{tag}] {name}: card (f32, TF32 off) against the CPU, largest error "
          f"{worst:.3e} of the largest magnitude (tolerance {rtol})")
    if not worst <= rtol:
        _fail(f"{tag}: {name} differs on the card from the CPU by {worst:.3e}")


def _zoo_correctness(dev):
    """Each zoo piece at a reduced size, f32 with TF32 off, on the card
    against the same module on the CPU (same weights, same inputs)."""
    import torch
    from mega_pytorch_tpu_torch.config import get_default_cfg
    from mega_pytorch_tpu_torch.data.transforms import s2d_pack_frames
    from mega_pytorch_tpu_torch.models.backbone import fbnet, fpn
    from mega_pytorch_tpu_torch.models.layers import (
        DeformRoIPoolingPack,
        ModulatedDeformRoIPoolingPack,
        init_module_,
    )
    from mega_pytorch_tpu_torch.models.roi_heads.combined import CombinedROIHeads
    from mega_pytorch_tpu_torch.models.roi_heads.subsample import SampledRois
    from mega_pytorch_tpu_torch.models.rpn import retinanet
    from mega_pytorch_tpu_torch.ops.deform_conv import DFConv2d
    from mega_pytorch_tpu_torch.ops.roi_pool import roi_pool

    h, w = ZOO_SMALL
    print(f"[zoo] correctness at a reduced size: {ZOO_FRAMES} frames of {h}x{w} "
          f"(s2d(4)-packed), R-50-FPN, RetinaNet with 80 classes on P3-P7, the mask and "
          f"keypoint heads on P2 (20 ROIs an image), FBNet default on one frame, ops on "
          f"small maps")
    cpu_gen = torch.Generator().manual_seed(0)
    rs = np.random.RandomState(25)
    x = torch.from_numpy(s2d_pack_frames(
        (rs.randn(ZOO_FRAMES, h, w, 3) * 50).astype(np.float32), 4))
    body = init_module_(fpn.ResNetFPNBody("R-50"), cpu_gen)
    _same_on_card("R-50-FPN body", body, [x], lambda m, a: m(a), dev)
    with torch.inference_mode():
        feats = body(x)
    top = init_module_(fpn.FPN(256, "maxpool"), cpu_gen)
    _same_on_card("FPN maxpool", top, [feats], lambda m, a: m(a), dev)
    p6p7 = init_module_(fpn.FPN(256, "p6p7", in_channels=(None, 512, 1024, 2048)), cpu_gen)
    _same_on_card("FPN p6p7 (RetinaNet)", p6p7, [[None, *feats[1:]]],
                                      lambda m, a: m(a), dev)
    with torch.inference_mode():
        levels = p6p7([None, *feats[1:]])
    head = init_module_(retinanet.RetinaNetHead(256), cpu_gen)
    head.cls_logits.weight.mul_(5.0)  # scores spread past the 0.05 threshold
    _same_on_card("RetinaNet head", head, [levels],
                                            lambda m, a: [t for part in m(a) for t in part], dev)
    # inference on the CPU's head outputs, on both devices: equal keep sets
    with torch.inference_mode():
        logits, deltas = head(levels)
    anchors = retinanet.retinanet_anchors([tuple(f.shape[1:3]) for f in levels])
    size = (float(h), float(w))
    for i in range(ZOO_FRAMES):
        args = ([a for a in anchors], [l[i] for l in logits], [d[i] for d in deltas])
        want = retinanet.retinanet_inference(*args, size)
        got = [t.cpu() for t in retinanet.retinanet_inference(
            *[[t.to(dev) for t in a] for a in args], size)]
        box_err = (got[0] - want[0]).abs().max().item() / want[0].abs().max().item()
        score_err = (got[1] - want[1]).abs().max().item()
        same = (torch.equal(got[3], want[3]) and torch.equal(got[2], want[2])
                and box_err <= RTOL_ZOO and score_err <= RTOL_ZOO)
        kept = int(want[3].sum())
        print(f"[zoo] retinanet_inference image {i}: {kept} kept on the CPU; on the card "
              f"the same keep set and labels {same}, boxes within {box_err:.3e} of the "
              f"largest coordinate, scores within {score_err:.3e}")
        if not same or kept == 0:
            _fail("zoo: RetinaNet's keep set on the card differs from the CPU's (or is empty)")

    rois = torch.from_numpy(_zoo_boxes(rs, ZOO_FRAMES, 20, h, w, 8.0, 60.0))
    labels = torch.from_numpy(rs.randint(1, 81, size=(ZOO_FRAMES, 20)))
    masks = torch.from_numpy(rs.rand(ZOO_FRAMES, 4, h, w) > 0.5)
    matched = torch.from_numpy(rs.randint(0, 4, size=(ZOO_FRAMES, 20)))
    heads = init_module_(CombinedROIHeads(256, True, True, 81, 17, spatial_scale=0.25),
                         cpu_gen)
    with torch.inference_mode():
        p2 = top(feats)[0]

    def heads_call(m, p2, boxes, lab, msk, match):
        rois_ = SampledRois(boxes, torch.ones_like(lab, dtype=torch.bool), lab,
                            torch.zeros_like(boxes))
        return [m.mask_probs(p2, boxes, lab), m.mask_losses(p2, rois_, msk, match)["loss_mask"],
                m.keypoint_logits(p2, boxes)]

    _same_on_card("CombinedROIHeads", heads,
                                            [p2, rois, labels, masks, matched],
                                            heads_call, dev)
    cfg = get_default_cfg()
    cfg.merge_from_list(["TPU.COMPUTE_DTYPE", "float32"])
    trunk = init_module_(fbnet.build_fbnet_backbone(cfg), cpu_gen)
    img = torch.from_numpy((rs.randn(1, h, w, 3) * 50).astype(np.float32))
    _same_on_card("FBNet default trunk", trunk, [img],
                                         lambda m, a: m(a), dev)
    with torch.inference_mode():
        t_out = trunk(img)
    for group in ("rpn", "bbox", "mask"):
        hd = init_module_(fbnet.build_fbnet_head(cfg, group, trunk.out_channels), cpu_gen)
        _same_on_card(f"FBNet default {group} group", hd, [t_out],
                                                lambda m, a: m(a), dev)

    c4 = torch.from_numpy(rs.randn(1, 10, 14, 64).astype(np.float32))
    pool_rois = torch.from_numpy(_zoo_boxes(rs, 1, 30, 160, 224, 4.0, 150.0))
    with torch.inference_mode():
        want = roi_pool(c4, pool_rois, 1 / 16.0)
        got = roi_pool(c4.to(dev), pool_rois.to(dev), 1 / 16.0).cpu()
    print(f"[zoo] roi_pool (1, 10, 14, 64), 30 ROIs: card equal to the CPU bit for bit: "
          f"{torch.equal(got, want)}")
    if not torch.equal(got, want):
        _fail("zoo: roi_pool on the card differs from the CPU")
    fmap = torch.from_numpy(rs.randn(1, 12, 16, 32).astype(np.float32))
    for modulated in (False, True):
        dconv = init_module_(DFConv2d(32, 32, with_modulated_dcn=modulated,
                                      deformable_groups=2), cpu_gen)
        dconv.offset.weight.normal_(0.0, 0.05, generator=cpu_gen)  # offsets take effect
        tag = "v2" if modulated else "v1"
        _same_on_card(f"DFConv2d {tag}", dconv, [fmap],
                                                 lambda m, a: m(a), dev)
        cls = ModulatedDeformRoIPoolingPack if modulated else DeformRoIPoolingPack
        pack = init_module_(cls(1 / 8.0, 7, 32, False, sample_per_part=4, trans_std=0.1,
                                deform_fc_channels=64), cpu_gen)
        for name in ("offset_fc2", "mask_fc1"):
            if hasattr(pack, name):
                getattr(pack, name).weight.normal_(0.0, 0.05, generator=cpu_gen)
        _same_on_card(cls.__name__, pack, [fmap[0], pool_rois[0] * 0.6],
                                    lambda m, a, r: m(a, r), dev)


def _time_folded_stem(gen, dev, smi):
    """The folded stem pool (frame_rows) at the MEGA 12-lane step's 24 frames:
    bit for bit the unfolded kernel on every frame's rows and the plain
    version, junk in the seam rows; the folded stem (pad, conv on the strip,
    pool, slice) timed against the unfolded one (conv, pool); the unfolded
    pool timed beside the folded one and its plain version."""
    import torch
    import torch.nn.functional as F
    from mega_pytorch_tpu_torch.models.backbone.resnet import Stem
    from mega_pytorch_tpu_torch.ops.kernels import stem_pool as sp

    n, t, u, s = 2 * LANES, 152, 256, 153
    y = (torch.randn(n, t, u, 256, generator=gen, device=dev) * 2).to(torch.bfloat16)
    scale = torch.rand(256, generator=gen, device=dev) + 0.5
    shift = torch.randn(256, generator=gen, device=dev)
    junk = (torch.randn(n, s - t, u, 256, generator=gen, device=dev) * 50).to(torch.bfloat16)
    folded = torch.cat([y, junk], 1).reshape(1, n * s, u, 256)
    before = sp.stem_pool_packed.launches
    got = sp.stem_pool_packed(folded, scale, shift, 64, frame_rows=s)
    unfolded = sp.stem_pool_packed(y, scale, shift, 64)
    launched = sp.stem_pool_packed.launches - before
    plain = sp.stem_pool_packed_reference(folded, scale, shift, 64, frame_rows=s)
    torch.cuda.synchronize()
    rows_equal = torch.equal(got.reshape(n, s, u, 64)[:, :t], unfolded)
    plain_equal = torch.equal(got, plain)
    del plain
    from mega_pytorch_tpu_torch.tools.kernel_bench import time_alternating

    plain_ms, ms_u, ms_f = time_alternating(
        [lambda: sp.stem_pool_packed_reference(folded, scale, shift, 64, frame_rows=s),
         lambda: sp.stem_pool_packed(y, scale, shift, 64),
         lambda: sp.stem_pool_packed(folded, scale, shift, 64, frame_rows=s)],
        9, TIMING_INNER)
    bound = _bound(_nbytes(folded, got), f32_ops=4 * folded.numel())
    print(f"[zoo] stem_pool folded (1, {n * s}, {u}, 256), frame_rows {s} ({n} frames of {t} "
          f"rows, one junk seam row each): rows equal to the unfolded kernel's bit for bit "
          f"{rows_equal}, equal to the plain version {plain_equal}; kernel {ms_f:.4f} ms, "
          f"plain {plain_ms:.4f} ms, unfolded ({n}, {t}, {u}, 256) {ms_u:.4f} ms; folded "
          f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}); {smi}")
    if not (rows_equal and plain_equal) or launched != 2:
        _fail("zoo: the folded stem pool differs from the unfolded kernel or its plain version")
    del folded, junk, got, unfolded

    stem = Stem(64, torch.bfloat16, dev)
    stem.init_weights(gen)
    stem.eval().requires_grad_(False)
    x = (torch.randn(n, t, u, 48, generator=gen, device=dev) * 50).to(torch.bfloat16)

    def unfolded_stem():
        return stem(x)

    def folded_stem():
        strip = F.pad(x, (0, 0, 0, 0, 0, 1)).reshape(1, n * s, u, 48)
        yy = F.conv2d(strip.permute(0, 3, 1, 2), stem.w3, padding=1).permute(0, 2, 3, 1)
        out = sp.stem_pool_packed(yy, stem.scale4, stem.shift4, 64, frame_rows=s)
        return out.reshape(n, s, u, 64)[:, :t].permute(0, 3, 1, 2)

    with torch.inference_mode():
        diff = (folded_stem().float() - unfolded_stem().float()).abs().max().item()
        ms_fs, ms_us = _time_pair(unfolded_stem, folded_stem, repeats=9)
    print(f"[zoo] whole stem on {n} packed frames: folded (pad, conv on the (1, {n * s}, {u}, "
          f"48) strip, pool, slice) {ms_fs:.4f} ms, unfolded (conv, pool) {ms_us:.4f} ms; "
          f"largest difference between the two {diff:.3e}; {smi}")
    return dict(ms=ms_f, plain_ms=plain_ms, unfolded_ms=ms_u, stem_ms=ms_fs,
                unfolded_stem_ms=ms_us, max_abs_err=0.0, library_ms=None, **bound)


def phase_zoo(smi):
    """The detector zoo at published widths, bf16, random weights from
    ``torch.Generator("cuda").manual_seed(0)``: R-50-FPN (body and FPN with
    the max-pool top block on two packed 800x1344 canvases: one stem pool
    launch), RetinaNet R-50-FPN (P3-P7, the head, inference per image), the
    mask and keypoint heads through ``CombinedROIHeads`` on P2, FBNet's
    default arch and head groups, ROIPool, DFConv2d and the deformable ROI
    pooling modules; the correctness of each at a reduced size on the card
    against the CPU; the folded stem pool. Returns (launches of the zoo
    path, the folded stem pool's table entry)."""
    import torch
    from mega_pytorch_tpu_torch.config import get_default_cfg
    from mega_pytorch_tpu_torch.models.backbone import fbnet, fpn
    from mega_pytorch_tpu_torch.models.layers import (
        DeformRoIPoolingPack,
        ModulatedDeformRoIPoolingPack,
        init_module_,
    )
    from mega_pytorch_tpu_torch.models.roi_heads.combined import CombinedROIHeads
    from mega_pytorch_tpu_torch.models.roi_heads.subsample import SampledRois
    from mega_pytorch_tpu_torch.models.rpn import retinanet
    from mega_pytorch_tpu_torch.ops.deform_conv import DFConv2d
    from mega_pytorch_tpu_torch.ops.roi_pool import roi_pool

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    bf = torch.bfloat16
    kernels = _kernels()
    packed, rgb, sizes = _zoo_frames(dev)
    im_h, im_w = (float(v) for v in sizes[0].tolist())
    body = init_module_(fpn.ResNetFPNBody("R-50", dtype=bf, device=dev), gen, cast=True)
    top = init_module_(fpn.FPN(256, "maxpool", dtype=bf, device=dev), gen, cast=True)
    p6p7 = init_module_(fpn.FPN(256, "p6p7", in_channels=(None, 512, 1024, 2048), dtype=bf,
                                device=dev), gen, cast=True)
    head = init_module_(retinanet.RetinaNetHead(256, dtype=bf, device=dev), gen, cast=True)
    heads = init_module_(CombinedROIHeads(256, True, True, 81, 17, spatial_scale=0.25,
                                          dtype=bf, device=dev), gen, cast=True)
    cfg = get_default_cfg()
    cfg.merge_from_list(["TPU.COMPUTE_DTYPE", "bfloat16"])
    trunk = init_module_(fbnet.build_fbnet_backbone(cfg, dev), gen, cast=True)
    fb_heads = {g: init_module_(fbnet.build_fbnet_head(cfg, g, trunk.out_channels, dev), gen,
                                cast=True) for g in ("rpn", "bbox", "mask")}
    rs = np.random.RandomState(26)
    det_boxes = torch.from_numpy(_zoo_boxes(rs, ZOO_FRAMES, 100, im_h, im_w)).to(dev)
    det_labels = torch.from_numpy(rs.randint(1, 81, size=(ZOO_FRAMES, 100))).to(dev)
    roi_boxes = torch.from_numpy(_zoo_boxes(rs, ZOO_FRAMES, 128, im_h, im_w)).to(dev)
    sampled = SampledRois(roi_boxes, torch.ones(ZOO_FRAMES, 128, dtype=torch.bool, device=dev),
                          torch.from_numpy(rs.randint(0, 81, size=(ZOO_FRAMES, 128))).to(dev),
                          torch.zeros(ZOO_FRAMES, 128, 4, device=dev))
    gt = _zoo_boxes(rs, ZOO_FRAMES, 16, im_h, im_w, 32.0, 600.0).round().astype(int)
    gt_masks = torch.zeros(ZOO_FRAMES, 16, *ZOO_CANVAS, dtype=torch.bool, device=dev)
    for b, g in np.ndindex(ZOO_FRAMES, 16):
        x1, y1, x2, y2 = gt[b, g]
        gt_masks[b, g, y1:y2, x1:x2] = True
    matched = torch.from_numpy(rs.randint(0, 16, size=(ZOO_FRAMES, 128))).to(dev)

    def retina_levels(feats):
        return p6p7([None, *feats[1:]])

    def retina_inference(logits, deltas, anchors):
        return [retinanet.retinanet_inference(anchors, [l[i] for l in logits],
                                              [d[i] for d in deltas], (im_h, im_w))
                for i in range(ZOO_FRAMES)]

    def fbnet_all():
        t_out = trunk(rgb[:1])
        return [t_out] + [h(t_out) for h in fb_heads.values()]

    with torch.inference_mode():
        # the zoo path once, counted from 0: every launch it makes
        for k in kernels:
            k.launches = 0
        feats = body(packed)
        pyramid = top(feats)
        torch.cuda.synchronize()
        fpn_launches = {k.__name__: k.launches for k in kernels}
        levels = retina_levels(body(packed))
        logits, deltas = head(levels)
        anchors = retinanet.retinanet_anchors([tuple(f.shape[1:3]) for f in levels],
                                              device=dev)
        dets = retina_inference(logits, deltas, anchors)
        probs = heads.mask_probs(pyramid[0], det_boxes, det_labels)
        loss = heads.mask_losses(pyramid[0], sampled, gt_masks, matched)["loss_mask"]
        kp = heads.keypoint_logits(pyramid[0], det_boxes)
        fb = fbnet_all()
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in kernels}

        shapes = [tuple(p.shape) for p in pyramid]
        want = [(ZOO_FRAMES, ZOO_CANVAS[0] // s, ZOO_CANVAS[1] // s, 256) for s in (4, 8, 16, 32)]
        want.append((ZOO_FRAMES, -(-ZOO_CANVAS[0] // 64), -(-ZOO_CANVAS[1] // 64), 256))
        finite = all(bool(torch.isfinite(t).all()) for t in [*feats, *pyramid, *levels, *logits,
                                                            *deltas, probs, loss, kp, *fb])
        inside = all(bool(((d[0][:, 0::2] >= 0) & (d[0][:, 0::2] <= im_w - 1)
                           & (d[0][:, 1::2] >= 0) & (d[0][:, 1::2] <= im_h - 1)).all()
                          and torch.isfinite(d[1]).all()) for d in dets)
        kept = [int(d[3].sum()) for d in dets]
        print(f"[zoo] R-50-FPN on {ZOO_FRAMES} packed {ZOO_CANVAS[0]}x{ZOO_CANVAS[1]} canvases "
              f"(images {int(im_h)}x{int(im_w)}): P2-P6 {shapes}; launches of the body + FPN "
              f"call {fpn_launches}; RetinaNet levels {[tuple(f.shape[1:3]) for f in levels]}, "
              f"kept {kept} of 100 an image, boxes inside the image {inside}; all bf16 outputs "
              f"finite {finite}; mask loss {loss.item():.4f}")
        if (fpn_launches != dict(_NO_KERNEL, stem_pool_packed=1,
                                 bottleneck_epilogue=EPI_R50_FPN) or shapes != want):
            _fail(f"zoo: R-50-FPN launched {fpn_launches} or gave {shapes}")
        # ROIAlign: the mask head for mask_probs and mask_losses, the targets
        # of each frame's instance masks, the keypoint head
        zoo_launches = dict(_NO_KERNEL, stem_pool_packed=2, roi_align=3 + ZOO_FRAMES,
                            bottleneck_epilogue=2 * EPI_R50_FPN)
        if not (finite and inside) or launches != zoo_launches:
            _fail(f"zoo: outputs not finite, boxes outside the image, or launches {launches}")

        ms = {}
        ms["R-50-FPN body + FPN, 2 frames"] = _sync_ms(lambda: top(body(packed)))[0]
        ms["RetinaNet body"] = _sync_ms(lambda: body(packed))[0] / ZOO_FRAMES
        ms["RetinaNet FPN (P3-P7)"] = _sync_ms(lambda: retina_levels(feats))[0] / ZOO_FRAMES
        ms["RetinaNet head"] = _sync_ms(lambda: head(levels))[0] / ZOO_FRAMES
        ms["RetinaNet inference"] = _sync_ms(
            lambda: retina_inference(logits, deltas, anchors))[0] / ZOO_FRAMES
        ms["mask_probs, 100 detections an image"] = _sync_ms(
            lambda: heads.mask_probs(pyramid[0], det_boxes, det_labels))[0]
        ms["mask_losses, 128 ROIs, 16 GT masks an image"] = _sync_ms(
            lambda: heads.mask_losses(pyramid[0], sampled, gt_masks, matched))[0]
        ms["keypoint_logits, 100 ROIs an image"] = _sync_ms(
            lambda: heads.keypoint_logits(pyramid[0], det_boxes))[0]
        ms["FBNet default, trunk + rpn, bbox, mask groups, 1 frame"] = _sync_ms(fbnet_all)[0]
        ms["of which the FBNet trunk"] = _sync_ms(lambda: trunk(rgb[:1]))[0]
        for g, h in fb_heads.items():
            ms[f"of which the FBNet {g} group"] = _sync_ms(lambda h=h: h(fb[0]))[0]
        retina = sum(v for k, v in ms.items() if k.startswith("RetinaNet"))
        print(f"[zoo] ms (bf16, host clock, synchronised; RetinaNet per image, "
              f"{retina:.2f} in all): {json.dumps({k: round(v, 3) for k, v in ms.items()})}; "
              f"{smi}")
        del feats, pyramid, levels, logits, deltas, dets, probs, kp, fb, gt_masks

        # the zoo's ops at full width: ms, peak memory and the scratch above the inputs
        c4_hw = (ZOO_CANVAS[0] // 16, ZOO_CANVAS[1] // 16)  # the C4 map: (50, 84)
        c8_hw = (ZOO_CANVAS[0] // 8, ZOO_CANVAS[1] // 8)  # P3: (100, 168)
        c4 = torch.randn(1, *c4_hw, 1024, generator=gen, device=dev).to(bf)
        rois300 = torch.from_numpy(_zoo_boxes(rs, 1, 300, im_h, im_w)).to(dev)
        ops = {}
        ops[f"roi_pool 300 ROIs 7x7 on {tuple(c4.shape)} bf16"] = _peak(
            lambda: roi_pool(c4, rois300, 1 / 16.0))
        del c4
        fmap = torch.randn(1, *c8_hw, 256, generator=gen, device=dev).to(bf)
        for modulated in (False, True):
            dconv = init_module_(DFConv2d(256, 256, with_modulated_dcn=modulated,
                                          deformable_groups=2, dtype=bf, device=dev), gen)
            dconv.offset.weight.normal_(0.0, 0.01, generator=gen)
            ops[f"DFConv2d {'v2' if modulated else 'v1'} 256->256, 2 groups, "
                f"{tuple(fmap.shape)} bf16"] = _peak(lambda: dconv(fmap))
        c4_256 = torch.randn(*c4_hw, 256, generator=gen, device=dev)
        for cls in (DeformRoIPoolingPack, ModulatedDeformRoIPoolingPack):
            pack = init_module_(cls(1 / 16.0, 7, 256, False, sample_per_part=4, trans_std=0.1,
                                    device=dev), gen)
            ops[f"{cls.__name__} 300 ROIs, out 7, on {tuple(c4_256.shape)}"] = _peak(
                lambda: pack(c4_256, rois300[0]))
        for name, (t_ms, peak, scratch, out) in ops.items():
            if not torch.isfinite(out).all():
                _fail(f"zoo: {name} is not finite")
        print("[zoo] ops: " + "; ".join(
            f"{name}: {t_ms:.3f} ms, peak {peak:.0f} MB ({scratch:.0f} MB above its inputs)"
            for name, (t_ms, peak, scratch, _) in ops.items()) + f"; {smi}")
        del fmap, c4_256, ops

    _zoo_correctness(dev)
    folded = _time_folded_stem(gen, dev, smi)
    torch.cuda.empty_cache()
    return launches, folded


def _c2_blobs(state_dict, rs):
    """A Detectron blob dict for every backbone and res5 tensor of
    ``state_dict`` (port names) that the C2 loader reaches, drawn from
    ``rs``: conv weights (OIHW) at 1/sqrt(fan-in), AffineChannel scales near
    1 and biases near 0; plus a (one-element) momentum blob a conv and the
    fc1000 blobs a pickle also holds, which the loader skips by name.
    Returns (blobs, {port name: blob name})."""
    branch = {"conv1": "2a", "conv2": "2b", "conv3": "2c", "downsample_conv": "1",
              "bn1": "2a", "bn2": "2b", "bn3": "2c", "downsample_bn": "1"}
    blobs, names = {}, {}
    for name, t in state_dict.items():
        parts = name.split(".")
        if parts[-1] not in ("weight", "bias"):
            continue
        if parts[:3] == ["backbone", "stem", "conv1"]:
            blob = "conv1_w"
        elif parts[:3] == ["backbone", "stem", "bn1"]:
            blob = "res_conv1_bn_" + ("s" if parts[-1] == "weight" else "b")
        elif parts[0] == "backbone" or parts[:3] == ["extractor", "head", "layer4"]:
            layer, block, mod, leaf = parts[-4:]
            kind = "_w" if "conv" in mod else "_bn_s" if leaf == "weight" else "_bn_b"
            blob = f"res{int(layer[len('layer'):]) + 1}_{block}_branch{branch[mod]}{kind}"
        else:
            continue
        shape = tuple(t.shape)
        if blob.endswith("_w"):
            arr = rs.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
            blobs[blob + "_momentum"] = np.zeros(1, np.float32)
        else:
            arr = (1.0 if blob.endswith("_s") else 0.0) + 0.1 * rs.standard_normal(shape)
        blobs[blob] = arr.astype(np.float32)
        names[name] = blob
    blobs["fc1000_w"] = rs.standard_normal((1000, 2048)).astype(np.float32)
    blobs["fc1000_b"] = np.zeros(1000, np.float32)
    return blobs, names


def _packed_frame(hw, dev):
    """One drawn frame on an ``hw`` canvas, s2d(4)-packed and normalised."""
    import torch
    from mega_pytorch_tpu_torch.data.transforms import normalize_u8_frames, s2d_pack_frames

    frame = _draw_frames(np.random.RandomState(31), 1, hw)[0]
    sizes = torch.tensor([hw], dtype=torch.float32, device=dev)
    return normalize_u8_frames(torch.from_numpy(s2d_pack_frames(frame[None], 4)).to(dev), sizes)


def _check_c2(dev, pickle_path, smi):
    """A full-width R-101 Detectron pickle written to ``pickle_path`` and
    loaded into a ``mega_R_101`` model on the card: every backbone and res5
    tensor equal to its blob (in the tensor's dtype), the skipped blobs
    reaching nothing, and the stem on one packed frame bit for bit that of a
    second model given the same weights by ``load_state_dict`` (whose stem
    differed before)."""
    import pickle

    import torch
    from mega_pytorch_tpu_torch.config import get_preset
    from mega_pytorch_tpu_torch.models.detectors import build_detection_model
    from mega_pytorch_tpu_torch.utils.model_ingest import load_c2_weights

    cfg = get_preset("mega_R_101")
    model = build_detection_model(cfg, dev, torch.Generator(dev).manual_seed(0))
    blobs, names = _c2_blobs(model.state_dict(), np.random.RandomState(32))
    t0 = time.perf_counter()
    with open(pickle_path, "wb") as f:
        pickle.dump({"blobs": blobs}, f, protocol=2)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    load_c2_weights(str(pickle_path), model)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    own = model.state_dict()
    wrong = [n for n, b in names.items()
             if not torch.equal(own[n].cpu(), torch.from_numpy(blobs[b]).to(own[n].dtype))]
    loaded = sum(1 for b in blobs if not b.endswith("_momentum") and not b.startswith("fc1000"))
    twin = build_detection_model(cfg, dev, torch.Generator(dev).manual_seed(1))
    packed = _packed_frame(CANVAS, dev)
    with torch.inference_mode():
        before = twin.backbone.stem(packed)
        twin.load_state_dict(own)
        got, want = model.backbone.stem(packed), twin.backbone.stem(packed)
    same, differed = torch.equal(got, want), not torch.equal(before, want)
    print(f"[c2] a synthetic Detectron R-101 pickle, {len(blobs)} blobs, "
          f"{pickle_path.stat().st_size / 2**20:.0f} MB, written in {write_s:.2f} s and loaded "
          f"into mega_R_101 on the card in {load_s:.2f} s: {len(names)} backbone and res5 "
          f"tensors of {loaded} loadable blobs, {len(wrong)} unequal to their blobs; the stem "
          f"on one packed {CANVAS[0]}x{CANVAS[1]} frame bit for bit that of a model given the "
          f"weights by state_dict: {same} (before the load: {not differed}); {smi}")
    if wrong or len(names) != loaded:
        _fail(f"c2: {len(wrong)} tensors unequal to their blobs ({wrong[:3]}), or "
              f"{len(names)} of {loaded} blobs loaded")
    if not (same and differed):
        _fail("c2: the loaded stem differs from one given the same weights by state_dict")


def _classic_modules(dev, dtype, gen):
    """The base R-101 C4 body and the classic box head, weights drawn from
    ``gen`` and stored in ``dtype``, named as the C2 loader names them
    (``backbone``, ``extractor.head``)."""
    import torch
    from mega_pytorch_tpu_torch.models.backbone.resnet import ResNetC4
    from mega_pytorch_tpu_torch.models.layers import init_module_
    from mega_pytorch_tpu_torch.models.roi_heads.extractors import (
        ResNet50Conv5ROIFeatureExtractor,
    )
    from mega_pytorch_tpu_torch.models.roi_heads.predictors import FastRCNNPredictor

    return init_module_(torch.nn.ModuleDict({
        "backbone": ResNetC4("R-101", dtype=dtype, device=dev),
        "extractor": ResNet50Conv5ROIFeatureExtractor("R-101", dtype=dtype, device=dev),
        "predictor": FastRCNNPredictor(dtype=dtype, device=dev),
    }), gen, cast=dtype != torch.float32)


def _classic_forward(m, packed, rois):
    """Body, classic head and predictor: (C4 map, ROI maps, logits, deltas)."""
    c4 = m["backbone"](packed)
    feats = m["extractor"](c4, rois)
    return (c4, feats, *m["predictor"](feats))


def _phase_classic_head(dev, pickle_path, kernels, smi):
    """The base R-101 C4 body (res2-res5 from the pickle) on one packed
    608x1024 frame, then CLASSIC_ROIS proposals through the classic head and
    FastRCNNPredictor in bf16: one stem pool and one ROIAlign launch, finite
    outputs, ms and peak memory; the same modules in f32 at 128x192 on the
    card against the CPU. Returns the launches of the bf16 call."""
    import torch
    from mega_pytorch_tpu_torch.utils.model_ingest import load_c2_weights

    head = _classic_modules(dev, torch.bfloat16, torch.Generator(dev).manual_seed(5))
    load_c2_weights(str(pickle_path), head)
    rs = np.random.RandomState(33)
    packed = _packed_frame(CANVAS, dev)
    rois = torch.from_numpy(_zoo_boxes(rs, 1, CLASSIC_ROIS, *CANVAS)).to(dev)
    with torch.inference_mode():
        for k in kernels:
            k.launches = 0
        out = _classic_forward(head, packed, rois)
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in kernels}
        ms, peak, scratch, out = _peak(lambda: _classic_forward(head, packed, rois))
        body_ms = _sync_ms(lambda: head["backbone"](packed))[0]
    shapes = [tuple(t.shape) for t in out]
    want = [(1, CANVAS[0] // 16, CANVAS[1] // 16, 1024), (1, CLASSIC_ROIS, 7, 7, 2048),
            (1, CLASSIC_ROIS, 31), (1, CLASSIC_ROIS, 124)]
    finite = all(bool(torch.isfinite(t).all()) for t in out)
    print(f"[classic] base R-101 C4 body on one packed {CANVAS[0]}x{CANVAS[1]} frame, then "
          f"{CLASSIC_ROIS} proposals through ResNet50Conv5ROIFeatureExtractor (14x14 ROIAlign, "
          f"res5 with stride 2) and FastRCNNPredictor, bf16: {ms:.3f} ms (the body alone "
          f"{body_ms:.3f}), peak {peak:.0f} MB ({scratch:.0f} MB above the weights and "
          f"inputs); outputs {shapes}, finite {finite}; launches {launches}; {smi}")
    if (shapes != want or not finite
            or launches != dict(_NO_KERNEL, stem_pool_packed=1, roi_align=1,
                                bottleneck_epilogue=EPI_PASS)):
        _fail(f"classic: outputs {shapes} (want {want}), finite {finite}, launches {launches}")
    del head, out
    rois_small = torch.from_numpy(_zoo_boxes(rs, 1, 16, *ZOO_SMALL, lo=8.0, hi=100.0))
    _same_on_card("classic C4 body + head + FastRCNNPredictor at 128x192",
                  _classic_modules("cpu", torch.float32, torch.Generator().manual_seed(6)),
                  (_packed_frame(ZOO_SMALL, "cpu"), rois_small), _classic_forward, dev,
                  tag="classic")
    return launches


def _time_operator_route():
    """What the kernels' entries pay for being PyTorch operators (the MFU
    tool's FLOP formulas hang on them): ``flash_relation_attention`` and
    ``flash_relation_attention_pos`` through their operators against their
    implementations called directly, at one lane of the global enhance, the
    global residual and stage 0 (CUDA events, in turns; information only). Each
    implementation counts its own launches, so the counts are put back."""
    import torch
    from mega_pytorch_tpu_torch.ops.kernels import relation_attention as ra

    gen = torch.Generator("cuda").manual_seed(7)
    rows = []
    for name, (n, m), route, direct in (
            ("none", (2175, 750), ra.flash_relation_attention, ra._none_impl),
            ("none", (300, 750), ra.flash_relation_attention, ra._none_impl),
            ("compute", (675, 3750), ra.flash_relation_attention_pos, ra._pos_impl)):
        x = _attention_inputs(gen, 1, n, m, "cuda")
        args = [x[k] for k in ("q", "k", "v", "uk")]
        if name == "compute":
            args += [x["rois"], x["refs"], x["wk"], x["wb"]]
        args.append(x["valid"])
        before = (ra.flash_relation_attention.launches, ra.flash_relation_attention_pos.launches)
        op_ms, direct_ms = _time_pair(lambda: direct(*args), lambda: route(*args))
        ra.flash_relation_attention.launches, ra.flash_relation_attention_pos.launches = before
        rows.append(f"{name} ({n}, {m}): operator {op_ms:.4f} ms, direct {direct_ms:.4f} ms")
    print("[mfu] kernel entries as operators, one lane (CUDA events over "
          f"{TIMING_INNER} back-to-back calls, median of {TIMING_REPEATS} turns): "
          + "; ".join(rows))


def _phase_mfu(kernels, smi):
    """``tools/profile_mfu.py``'s count and timing: one MEGA lockstep step
    at MFU_SMALL with one lane counted on the CPU and on the card (equal
    totals), then the 12-lane MEGA step and one ``mega_R_101`` training
    iteration on the card, each counted once right after its warm-up with
    the launches that step made (as the path's own phases require), then
    timed. Returns ({path: launches}, {path: record})."""
    import torch
    from mega_pytorch_tpu_torch.tools import profile_mfu as pm

    _time_operator_route()
    counts = {}
    for dev in ("cpu", "cuda"):
        step, _ = pm.mega_step(1, MFU_SMALL, dev, "float32")
        counts[dev] = pm.count_flops(step)
        del step
    cpu_flops, card_flops = counts["cpu"]["flops"], counts["cuda"]["flops"]
    print(f"[mfu] one MEGA lockstep step, 1 lane, {MFU_SMALL[0]}x{MFU_SMALL[1]}, f32: "
          f"{cpu_flops} FLOPs counted on the CPU, {card_flops} on the card (of which hand-"
          f"written kernels {counts['cpu']['kernel_flops']} / {counts['cuda']['kernel_flops']}: "
          f"the CPU runs attention's einsum path)")
    if cpu_flops != card_flops or not counts["cuda"]["kernel_flops"]:
        _fail(f"mfu: the same step counts {cpu_flops} FLOPs on the CPU, {card_flops} on the card")
    launches, records = {}, {}
    for path, make, expect in (
            ("mfu mega step", lambda: pm.mega_step(LANES), PER_STEP["mega"]),
            ("mfu train", pm.train_step, PER_ITER_TRAIN)):
        step, per_step = make()
        for _ in range(MFU_WARMUP):
            step()
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        c = pm.count_flops(step)
        torch.cuda.synchronize()
        launches[path] = {k.__name__: k.launches for k in kernels}
        ms = pm.step_ms(step, 0, MFU_ITERS)
        tflops = c["flops"] / (ms * 1e-3) / 1e12
        rec = {"gflop_per_step": c["flops"] / 1e9,
               "gflop_per_frame": c["flops"] / 1e9 / per_step,
               "kernel_gflop": {k: v / 1e9 for k, v in c["kernel_flops"].items()},
               "kernel_special_functions": c["special"],
               "gflop_by_op": {k: v / 1e9 for k, v in c["by_op"].items()},
               "ms_per_step": ms, "achieved_tflops": tflops, "mfu": tflops / pm.PEAK_TFLOPS}
        records[path] = rec
        print(f"[mfu] {path}: {rec['gflop_per_step']:.1f} GFLOP a step "
              f"({rec['gflop_per_frame']:.1f} a {'sample' if 'train' in path else 'frame'}), "
              f"{sum(rec['kernel_gflop'].values()):.2f} of them in hand-written kernels "
              f"{rec['kernel_gflop']}; {ms:.2f} ms a step (median of {MFU_ITERS}); "
              f"{tflops:.1f} TFLOP/s = {100 * rec['mfu']:.2f} % MFU of {pm.PEAK_TFLOPS} "
              f"TFLOP/s; launches of the counted step {launches[path]}; {smi}")
        by_op = {k: round(v, 3) for k, v in rec["gflop_by_op"].items()}
        print(f"[mfu] {path}: GFLOP by operator {json.dumps(by_op)}; special functions "
              f"{rec['kernel_special_functions']}")
        if launches[path] != expect or not np.isfinite(tflops):
            _fail(f"mfu: {path} launched {launches[path]} (want {expect})")
        del step
        torch.cuda.empty_cache()
    return launches, records


def phase_classic_mfu(smi):
    """Detectron weights, the classic C4 head and the MFU count (phase 22).
    Returns ({path: launches}, {path: MFU record})."""
    import tempfile

    import torch

    dev = torch.device("cuda")
    kernels = _kernels()
    with tempfile.TemporaryDirectory() as tmp:
        pickle_path = Path(tmp) / "R-101.pkl"
        _check_c2(dev, pickle_path, smi)
        torch.cuda.empty_cache()
        launches = {"classic c4 head": _phase_classic_head(dev, pickle_path, kernels, smi)}
    torch.cuda.empty_cache()
    mfu_launches, records = _phase_mfu(kernels, smi)
    launches.update(mfu_launches)
    return launches, records


def phase_ddp(smi):
    """DistributedDataParallel on the card: a one-rank NCCL process group
    (``parallel/ddp.py:init_distributed`` with a ``file://`` store in a
    temporary directory) and ``tools/ddp_check.py``'s comparison: DDP_ITERS
    iterations of ``rdn_R_101`` (4 samples an iteration, the first three
    backward passes of each under ``no_sync``) through ``train_step`` on
    the wrapped model, against the same iterations through the plain step,
    run twice from the same calibrated state, samples and generator seeds
    (the second run shows the card's own spread) and once with the last
    sample left out (a planted fault); each tensor's update in both DDP runs
    (the second one warm) within max(1e-5, 8x that spread), the fault above
    it. Returns (launches, launches per iteration) of the warm DDP run."""
    import tempfile

    import torch
    from mega_pytorch_tpu_torch.config import get_preset
    from mega_pytorch_tpu_torch.parallel import ddp
    from mega_pytorch_tpu_torch.tools import ddp_check

    kernels = _kernels()

    def reset():
        for kern in kernels:
            kern.launches = 0

    with tempfile.TemporaryDirectory() as tmp:
        rank, world, dev = ddp.init_distributed("cuda", f"file://{tmp}/store", rank=0,
                                                world_size=1)
        try:
            rec = ddp_check.check(get_preset("rdn_R_101"), dev, DDP_ITERS, seed=17,
                                  frame_hw=TRAIN_FRAME, on_run=reset)
        finally:
            ddp.destroy_distributed()
    launches = {kern.__name__: kern.launches for kern in kernels}
    per_iter = {name: n // DDP_ITERS for name, n in launches.items()}
    print(f"[ddp] {rec['backend']} world {rec['world']} ({dev}), rdn_R_101, {DDP_ITERS} "
          f"iterations of {rec['samples_per_iteration']} samples (3 backward passes under "
          f"no_sync each): largest per-tensor difference of the updates from the plain "
          f"step, relative to the tensor's largest update: DDP {rec['err']:.3e}, a second "
          f"plain run {rec['spread']:.3e}; bound {rec['bound']:.3e}; the planted fault "
          f"(last sample left out) {rec['fault']:.3e}; losses at the last iteration DDP "
          f"{rec['ddp_losses']}, plain {rec['plain_losses']}; ms an iteration DDP "
          f"{rec['ddp_ms'][0]:.1f} / {rec['ddp_ms'][1]:.1f} (warm), plain "
          f"{rec['plain_ms'][0]:.1f} / {rec['plain_ms'][1]:.1f}; launches {launches}; {smi}")
    if not rec["ok"]:
        _fail(f"ddp: the DDP step's updates differ from the plain step's by "
              f"{rec['err']:.3e} (bound {rec['bound']:.3e}, the planted fault "
              f"{rec['fault']:.3e}), or the ranks differ")
    if per_iter != METHOD_TRAIN["rdn"][2] or any(n % DDP_ITERS for n in launches.values()):
        _fail(f"ddp: launches {launches} over {DDP_ITERS} iterations")
    torch.cuda.empty_cache()
    return launches, per_iter


def main():
    if not (ROOT / "mega_pytorch_tpu_torch").is_dir():
        _fail("the mega_pytorch_tpu_torch package is not beside this script")
    sys.path.insert(0, str(ROOT))
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"[time] phase {name}: {seconds[name]:.1f} s")
        return out

    name, smi = timed("device", phase_device)
    timed("build", phase_build)
    rows = timed("kernels", phase_kernels)
    rdn_stem, rdn_pos = timed("rdn kernels", phase_rdn_kernels)
    model, frames, gframes, outs, launches = timed("stream", phase_stream)
    timed("determinism", phase_determinism, model, frames, gframes, outs)
    del model, frames, gframes, outs

    import torch

    torch.cuda.empty_cache()
    lane_launches, per_step = timed("lanes", phase_lanes, smi)
    methods = timed("methods", phase_methods, smi)
    base_launches = timed("base", phase_base, smi)
    eval_launches, eval_per_step, _, eval_base = timed("eval path", phase_eval_path, smi)
    path_launches = timed("position-bias paths", phase_position_bias_paths)
    train_shapes = timed("train kernels", phase_train_kernels)
    train_launches, train_per_iter = timed("train", phase_train, smi)
    method_training = timed("method training", phase_method_training, smi)
    ddp_launches, ddp_per_iter = timed("ddp", phase_ddp, smi)
    pos_function = timed("pos function", phase_pos_function)
    tta_launches, tta_per_frame, _ = timed("tta", phase_tta, smi)
    demo_launches, _ = timed("demo", phase_demo, smi)
    gn_launches = timed("gn", phase_gn, smi)
    timed("native loader", phase_native_loader, smi)
    zoo_launches, folded = timed("zoo", phase_zoo, smi)
    classic_launches, mfu = timed("classic head and mfu", phase_classic_mfu, smi)

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
        "roi_align": ("cuda", "mega_pytorch_tpu_torch/csrc/roi_align.cu",
                      "none (mega_pytorch_tpu/ops/roi_align.py is plain JAX)"),
        "bottleneck_epilogue": ("cuda", "mega_pytorch_tpu_torch/csrc/bottleneck_epilogue.cu",
                                "none (XLA fuses the JAX package's FrozenBN, relu and "
                                "residual add into its convolutions)"),
    }
    # launches: each path's run counts from 0 and is read just after it: the
    # MEGA lanes run (phase 6), the methods (phase 9), the base detector
    # (phase 10), the eval path (phase 11), MEGA training (phase 13), RDN,
    # FGFA and DFF training (phase 14), the DDP step (phase 15), test-time
    # augmentation through test_net (phase 17), the demo (phase 18), the GN
    # base detector (phase 19), the zoo (phase 21: R-50-FPN, RetinaNet, the
    # mask and keypoint heads, FBNet), the classic C4 head and the MFU tool's
    # counted steps (phase 22), and the position-bias paths (phase 7) for
    # the kernel no model path reaches; launches_per_step is what every step
    # (training: iteration; TTA: frame) of each run launched
    by_path = {"mega": lane_launches, **{m: c for m, (c, _) in methods.items()},
               "base": base_launches, "eval path": eval_launches,
               "eval path base (serial)": eval_base,
               "position-bias paths": path_launches, "train": train_launches,
               **{f"{m} train": c for m, (c, _) in method_training.items()},
               "rdn train ddp": ddp_launches, "tta": tta_launches, "demo": demo_launches,
               "gn base": gn_launches, "zoo": zoo_launches, **classic_launches}
    per_step_by_path = {"mega": per_step, **{m: p for m, (_, p) in methods.items()},
                        "eval path": eval_per_step, "train": train_per_iter,
                        **{f"{m} train": p for m, (_, p) in method_training.items()},
                        "rdn train ddp": ddp_per_iter, "tta": tta_per_frame,
                        "mfu mega step": classic_launches["mfu mega step"],
                        "mfu train": classic_launches["mfu train"]}
    print(f"[result] launches per kernel: stream (1 lane) {launches}; by path {by_path}")
    print(f"[result] phase seconds {json.dumps({k: round(v, 1) for k, v in seconds.items()})}")
    rows["stem_pool_packed"]["rdn_shape"] = rdn_stem
    rows["stem_pool_packed"]["folded"] = folded
    pos = rows["flash_relation_attention_pos"]
    pos["rdn_shapes"] = rdn_pos
    pos["max_abs_err"] = max([pos["max_abs_err"]] + [e["max_abs_err"] for e in rdn_pos])
    pos["function_shapes"] = pos_function
    for kname, entries in train_shapes.items():
        rows[kname]["train_shapes"] = entries
        rows[kname]["max_abs_err"] = max([rows[kname]["max_abs_err"]]
                                         + [e["max_abs_err"] for e in entries])
    table = []
    for kname, (route, src, replaces) in source.items():
        table.append(dict(
            name=kname, route=route, source=src, replaces=replaces,
            launches=sum(c.get(kname, 0) for c in by_path.values()),
            launches_by_path={p: c[kname] for p, c in by_path.items() if kname in c},
            launches_per_step={p: c[kname] for p, c in per_step_by_path.items()},
            **rows[kname]))
    print(f"[result] mfu {json.dumps(mfu)}")
    print(f"[result] {smi}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
