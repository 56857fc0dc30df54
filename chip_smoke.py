#!/usr/bin/env python3
"""The PyTorch port's entry points on one CUDA card.

    python3 chip_smoke.py

Each phase drives entry points of the port at the flagship's widths and
checks what they give: kernel launch counts, every frame emitted once with
finite boxes, bit-identical re-runs and restores, agreement with the CPU,
and each kernel's wrapper against its plain version at the main path's
shapes.
Speed is measured by the benchmark (``benchmark/run.py``), the kernels'
numerics at every shape and edge by the card tests
(``tests/test_torch_kernels_cuda.py``), whose cases at the path's shapes
phase 18 runs. Phases, each printing its own lines:
  1. device: the card's name, and ``nvidia-smi``'s name and power limit;
  2. build: the CUDA kernels from ``mega_pytorch_tpu_torch/csrc`` (nvcc,
     sm_90a), with the build seconds and the ptxas register lines;
  3. stream: MEGA R-101 in bf16 at 608x1024 with seeded random weights runs a
     40-frame synthetic video through ``run_video`` (one lane); detections
     must be finite with 300 slots, and every kernel launch count must be
     exactly what the path implies;
  4. determinism: the first 15 steps again from a fresh carry give
     bit-identical detections;
  5. lanes: the same model built for 12 lanes serves 24 synthetic videos of
     12-40 frames from an in-memory dataset through
     ``compute_on_dataset_lockstep``; every frame must be emitted exactly
     once, detections finite with 300 slots, each step must launch 1 stem
     pool, 2 "none", 3 "compute", 2 ROIAlign kernels and 99 bottleneck
     epilogues (the C4 body's 90, res5's 9) whatever the lane count (and no
     "input" or standalone position-bias kernel), and the first 15 steps
     re-run from fresh carries must be bit-identical;
  6. methods: RDN (2 base stages and the advanced stage), FGFA and DFF (key
     interval 10), each R-101 in bf16 at 608x1024 with seeded random
     weights, built for 4 lanes, serve 8 synthetic videos of 12-40 frames
     through ``compute_on_dataset_lockstep``; every frame must be emitted
     exactly once with finite boxes, each step must launch exactly RDN's 1
     stem pool, 4 "compute" and 1 ROIAlign kernels (FGFA and DFF: 1
     ROIAlign) and 99 bottleneck epilogues (DFF's non-key steps: res5's
     9), and the first 15 steps re-run from fresh carries must be
     bit-identical;
  7. base: the single-frame detector's ``forward_test`` on 4 packed frames
     launches the stem pool and ROIAlign once a call and gives finite
     detections; its stem on s2d(2)-packed frames of the canvas launches no
     kernel and in f32 equals the canonical branch within 1e-4 + 1e-5
     max|out|;
  8. eval path: the evaluation entry point's code over a synthetic
     ILSVRC2015 tree written to a temporary directory (index, XML
     annotations; 12 videos of 10-20 frames of 720x1280, two portrait) whose
     dataset, the port's ``VIDMEGADataset``, draws its frames instead of
     decoding files: MEGA R-101 from the ``mega_R_101`` preset (no channel
     reduce) with 12 lanes through ``compute_on_dataset`` (resize, global
     schedule, ``video_shards``), each step launching what phase 5's do,
     every frame predicted once with finite boxes inside its image, the
     first 15 steps re-run bit for bit, ``evaluate_predictions`` with a
     synthetic motion-IoU table (finite AP50 in the four buckets; random
     weights make the values meaningless) and ``write_result``; then base
     R-101 through the serial engine over the 10-frame first video (f32
     canvases packed s2d(4) by ``pack_factor``: one stem pool launch a
     frame, nothing else);
  9. train: MEGA R-101 training through ``tools/train_net.py``'s ``main``
     (the ``mega_R_101`` preset: bf16 compute, f32 master weights, the
     608x1024 canvas, one sample an iteration of cur + 2 local, 3 memory and
     2 global frames) over a synthetic on-disk ILSVRC2015 train tree (VID
     videos in the VID_train_15frames form and DET stills, two
     orientations, frames drawn) for 14 iterations with a checkpoint at 7:
     finite losses, every trainable group moved by the first step, frozen
     parameters and buffers bit-identical, 3 "none", 5 "input" and 4
     ROIAlign launches (and no other kernel) every iteration, and the
     checkpoint restoring into a fresh model, optimizer and scheduler bit
     for bit;
  10. method training: RDN (``rdn_R_101``, the advanced stage, 4 samples an
     iteration of cur + 2 refs in turn), FGFA (``fgfa_R_101``) and DFF
     (``dff_R_101``) through ``train_net``'s ``main`` over the same tree, 6
     iterations each with a checkpoint at 3: the checks of phase 9, every
     trainable module moved by the first step (FlowNetS and the embedding
     net included), 16 "input" launches every RDN iteration and none for
     FGFA and DFF;
  11. ddp: a one-rank NCCL process group and ``DistributedDataParallel``
     (``tools/ddp_check.py``): two ``rdn_R_101`` iterations through
     ``train_step`` on the wrapped model (``no_sync`` on the first three
     samples of each) against the same iterations through the plain step,
     run twice for the card's own spread and once with the last sample
     left out (a planted fault); each tensor's update in two DDP runs
     within max(1e-5, 8x the spread) of the plain one's, relative to its
     largest, and the fault above that bound;
  12. tta: base R-101 (bf16) through ``tools/test_net.py``'s ``main`` with
     ``TEST.BBOX_AUG`` (scales 400-1200 and the base size, each flipped:
     18 runs a frame) over 3 JPEG frames of 720x1280 on disk: the run
     count, the detection cap, boxes inside the image, 18 stem pool
     launches in every frame and no other kernel;
  13. demo: ``tools/demo.py``'s ``main`` with ``mega_R_101`` (bf16,
     608x1024, packed) over 12 JPEG frames of 720x1280: 12 annotated frames
     of the input size written, detections bit for bit those of
     ``StreamingInferencer`` on the same frames, the stem pool, "none" and
     "compute" launched;
  14. gn: ``base_R_50`` with group norm (bf16, packed frames) against
     itself in f32 on RGB frames, and its f32 packed route against the
     canonical one; no stem pool launch and no bottleneck epilogue; an
     R-101 32x8d C4 body (``build_resnet_c4``, frozen BN, grouped 3x3
     convolutions) on a packed frame, 90 epilogues a pass;
  15. native loader, information only: whether ``data/native_loader.py``
     builds here (g++, libjpeg) and why not; if it does, ``load_batch``
     equal to ``load_frame`` frame by frame;
  16. zoo: at published widths in bf16 with random weights, R-50-FPN
     (``ResNetFPNBody`` and ``FPN`` with the max-pool top block, P2-P6, on 2
     s2d(4)-packed 800x1344 canvases of 720x1280 frames resized by
     MIN_SIZE_TEST 800 / MAX_SIZE_TEST 1333: exactly 1 stem pool launch),
     RetinaNet R-50-FPN (80 classes, 9 anchors, 4 convs; P3-P7 with "p6p7"
     from C5; ``retinanet_inference`` per image, 1000 / 0.05 / 0.4 / 100),
     ``CombinedROIHeads`` on P2 (``mask_probs`` of 100 detections,
     ``mask_losses`` of 128 ROIs over 16 dense GT masks, ``keypoint_logits``
     of 100 ROIs an image), FBNet's default arch with its rpn, bbox and mask
     groups on one frame; ROIPool, DFConv2d v1 / v2 and the deformable ROI
     pooling modules at full width; finite outputs and boxes inside the
     image; each piece at 128x192 in f32 (TF32 off) on the card against the
     same module on the CPU within 1e-4 of the largest magnitude,
     RetinaNet's keep sets equal;
  17. classic head and FLOP count: a synthetic full-width R-101 Detectron
     pickle (protocol 2, the AffineChannel scales and biases, momentum and
     fc1000 blobs) loaded by ``load_c2_weights`` into ``mega_R_101`` on the
     card, every backbone and res5 tensor equal to its blob and the stem on
     a packed frame bit for bit that of a model given the weights by
     ``load_state_dict``; the base R-101 C4 body with res2-res5 from that
     pickle on one packed 608x1024 frame (1 stem pool launch), then 300
     proposals through ``ResNet50Conv5ROIFeatureExtractor`` and
     ``FastRCNNPredictor`` in bf16, and the same modules in f32 at 128x192
     on the card against the CPU within 1e-4; ``tools/profile_mfu.py``'s
     FLOP count of one MEGA step (1 lane, 320x512, f32) equal on the CPU and
     on the card, then the 12-lane MEGA step and one ``mega_R_101`` training
     iteration counted, with the launches of the counted step (as phases 5
     and 9 require);
  18. kernels: each kernel's wrapper on card tensors at the main path's
     shapes against its plain version, through the card tests' own cases
     (``MAIN_PATH_CASES``, at those tests' tolerances): MEGA's 12-lane and
     RDN's 4-lane step, mode "input" at the training shapes and the
     standalone position bias at MEGA's stage 0; one line a kernel with its
     launches in phase 5's run and the cases that launched it.
Each phase prints its seconds; the last line is the device record as JSON.
TF32 stays off throughout. Any failed check raises, and the script exits
non-zero.
"""

from __future__ import annotations

import json
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
# the s2d(2) stem against the canonical one in f32 (TF32 off): the same sums
# of 147 products in another order by cuDNN's algorithms, so ATOL_STEM plus
# RTOL_STEM times the largest output
ATOL_STEM, RTOL_STEM = 1e-4, 1e-5
# lockstep lanes and videos of the methods phase (the JAX package's
# tools/bench_methods.py runs 4 lanes)
METHOD_LANES, METHOD_VIDEOS = 4, 8
DFF_KEY_INTERVAL = 10
# the eval path: on-disk synthetic videos of VID's 720p frames
EVAL_VIDEOS, EVAL_FRAME = 12, (720, 1280)
# MEGA R-101 training (phase 9): iterations, the checkpoint's iteration;
# the synthetic train tree's videos (frame counts; 15 frames of each
# indexed) and DET stills, at VID's 720p
TRAIN_ITERS, TRAIN_CKPT = 14, 7
TRAIN_VIDEOS, TRAIN_STILLS, TRAIN_FRAME = (40, 60, 30, 50, 45, 35), 4, (720, 1280)
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
# RDN, FGFA and DFF training (phase 10): iterations and the checkpoint's
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
# the one-rank NCCL DDP step (phase 11): iterations of rdn_R_101 against
# the plain step (tools/ddp_check.py states the bound)
DDP_ITERS = 2
# test-time augmentation through test_net (phase 12): maskrcnn-benchmark's
# TTA example scales, each run plain and flipped with the base size: 18
# detector runs a frame
TTA_SCALES = (400, 500, 600, 700, 900, 1000, 1100, 1200)
TTA_FRAMES, TTA_RUNS = 3, 2 + 2 * len(TTA_SCALES)
# the frame-folder demo (phase 13) and the native loader (phase 15)
DEMO_FRAMES = 12
# the GN R-50 C4 body (phase 14) on packed frames against itself in f32 on
# RGB frames (TF32 off). In f32 the two stem routes are the same sums in
# another order: RTOL_GN_F32 of the largest magnitude. In bf16, 8 bits
# (2^-9 relative rounding) at each of ~40 convolutions and norms add up
# through 13 residual blocks: on the CPU at 160x256 the bf16 body sat
# 2.7e-2 to 4.6e-2 of the largest magnitude (largest error) and 3.3e-2 to
# 3.7e-2 of the mean magnitude (mean error) from the f32 one, so the bounds
# are about twice those
RTOL_GN_F32, RTOL_GN_MAX, RTOL_GN_MEAN = 1e-4, 1e-1, 6e-2
# the detector zoo (phase 16): maskrcnn-benchmark's e2e_*_R_50_FPN_1x test
# sizes, MIN_SIZE_TEST 800 / MAX_SIZE_TEST 1333 on an 800x1344 canvas (size
# divisibility 32): ZOO_FRAMES drawn 720x1280 frames resized to 750x1333;
# each piece also at ZOO_SMALL in f32 on the card against the CPU, within
# RTOL_ZOO of the largest magnitude (f32 sums in another order, TF32 off)
ZOO_FRAMES, ZOO_FRAME, ZOO_SIZES, ZOO_CANVAS = 2, (720, 1280), (800, 1333), (800, 1344)
ZOO_SMALL, RTOL_ZOO = (128, 192), 1e-4
# phase 17: proposals through the classic C4 head (maskrcnn-benchmark's
# POST_NMS_TOP_N_TEST at one image); the MFU tool's step counted on the CPU
# and on the card at MFU_SMALL (one lane, f32: 20x32x15 anchors, above the
# RPN's 6000)
CLASSIC_ROIS = 300
MFU_SMALL = (320, 512)
# phase 18: the card tests of tests/test_torch_kernels_cuda.py and which of
# their parametrised cases are the main path's shapes: the stem pool on
# MEGA's 24 and RDN's 4 packed frames; every attention call of MEGA's
# 12-lane step ("none", "compute") and RDN's 4-lane step ("compute"); mode
# "input" at the training shapes; the position bias at MEGA's stage 0;
# ROIAlign's MEGA key and global calls and FGFA's, into f32 and bf16; the
# epilogue at each stage of MEGA's 24 maps (mid passes without the
# residual, out passes with it)
MAIN_PATH_CASES = (
    ("test_stem_pool_kernel_exact",
     lambda a: a["n"] in (2 * LANES, METHOD_LANES) and a["u"] == 256
     and a["dtype"] == "bfloat16"),
    ("test_attention_at_mega_step_12_lanes", lambda a: True),
    ("test_attention_compute_at_rdn_shapes_without_u", lambda a: a["lanes"] == METHOD_LANES),
    ("test_train_functions_at_train_shapes", lambda a: a["mode"] == "input"),
    ("test_position_bias_kernel_matches_plain", lambda a: (a["n"], a["m"]) == (675, 3750)),
    ("test_roi_align_kernel_matches_plain",
     lambda a: a["case"][0] in ("mega", "mega global", "fgfa")),
    ("test_bottleneck_epilogue_kernel_exact",
     lambda a: a["stage"] != "ragged" and a["residual"] == a["stage"].endswith("out")),
)


def _fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


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
    return name


def phase_build():
    from mega_pytorch_tpu_torch.ops.kernels.build import load_library

    lib = load_library()
    verb = "built" if lib.built else "loaded"
    print(f"[build] {verb} {lib.path.name} in {lib.seconds:.2f} s")
    for line in lib.ptxas:
        print(f"[build] ptxas: {line}")


def phase_stream():
    import torch
    from mega_pytorch_tpu_torch.engine.inference import run_video, synthetic_video
    from mega_pytorch_tpu_torch.models.detectors.mega import build_mega_flagship

    model = build_mega_flagship(*CANVAS, device="cuda",
                                generator=torch.Generator("cuda").manual_seed(0))
    frames, gframes = synthetic_video(np.random.RandomState(0), NUM_FRAMES, *CANVAS)
    print(f"[stream] built MEGA R-101 bf16 {CANVAS[0]}x{CANVAS[1]}; frames {frames.shape} "
          "uint8")
    kernels = _kernels()
    for k in kernels:
        k.launches = 0
    outs = [out.dets for out in run_video(model, frames, gframes)]
    launches = {k.__name__: k.launches for k in kernels}
    steps = len(outs)
    expect = {name: n * steps for name, n in PER_STEP["mega"].items()}
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
    print(f"[stream] detections (1, 300) finite; last frame {int(last.valid.sum())} valid, "
          f"top score {last.scores.max().item():.6f}")
    return model, frames, gframes, outs


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
    carries bit for bit. Returns the predictions and each kernel's launches
    in the run. Device-agnostic, so it also runs on the CPU."""
    import torch
    from mega_pytorch_tpu_torch.engine import batched_inference as bi

    kernels = _kernels()
    method = model.v.method
    tag = tag or f"lanes {method}"
    per_step = dict(PER_STEP[method])
    non_key = dict(DFF_NON_KEY_STEP)
    if dev.type != "cuda":  # plain versions: no launches
        per_step, non_key = dict.fromkeys(per_step, 0), dict.fromkeys(non_key, 0)
    slots = model.c.detections_per_img
    record = dict(emitted=[], replay=[], bad_counts=[], first=[], replay_on=True, last=None,
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
            carries, dets = step(carries, *inputs)
            record["emitted"].append(0)  # counted by the engine's _extract
            delta = {k.__name__: k.launches - before[k.__name__] for k in kernels}
            if delta != (non_key if kind == "non-key" else per_step):
                record["bad_counts"].append((len(record["emitted"]) - 1, delta))
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
        if run is None:
            results = bi.compute_on_dataset_lockstep(
                model, ds, range(len(ds.image_set_index)), _Preprocessor(), lanes=lanes)
        else:
            results = run()
    finally:
        for name, fn in factories.items():
            setattr(bi, name, fn)
        bi._extract = extract
    launches = {k.__name__: k.launches for k in kernels}
    steps = len(record["emitted"])
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
    return results, launches


def phase_lanes():
    import torch
    from mega_pytorch_tpu_torch.models.detectors.mega import build_mega_flagship

    model = build_mega_flagship(*CANVAS, device="cuda", lanes=LANES,
                                generator=torch.Generator("cuda").manual_seed(0))
    rs = np.random.RandomState(0)
    lengths = rs.randint(12, 41, NUM_VIDEOS)
    ds = _SyntheticVideos(lengths, rs, CANVAS)
    print(f"[lanes] built MEGA R-101 bf16 {CANVAS[0]}x{CANVAS[1]} for {model.lanes} lanes; "
          f"{NUM_VIDEOS} videos of {lengths.min()}-{lengths.max()} frames, "
          f"{lengths.sum()} frames")
    return run_lanes(model, ds, model.lanes, torch.device("cuda"))[1]


def phase_methods():
    """RDN, FGFA and DFF through the lockstep engine with 4 lanes."""
    import torch
    from mega_pytorch_tpu_torch.models.detectors import build_method_flagship

    for method in ("rdn", "fgfa", "dff"):
        model = build_method_flagship(method, *CANVAS, device="cuda", lanes=METHOD_LANES,
                                      generator=torch.Generator("cuda").manual_seed(0))
        rs = np.random.RandomState(0)
        lengths = rs.randint(12, 41, METHOD_VIDEOS)
        ds = _SyntheticVideos(lengths, rs, CANVAS, global_size=0)
        if method == "dff":
            ds.key_interval = DFF_KEY_INTERVAL
        print(f"[methods] built {method} R-101 bf16 {CANVAS[0]}x{CANVAS[1]} for "
              f"{model.lanes} lanes; {METHOD_VIDEOS} videos of {lengths.min()}-"
              f"{lengths.max()} frames, {lengths.sum()} frames")
        run_lanes(model, ds, METHOD_LANES, torch.device("cuda"))
        del model
        torch.cuda.empty_cache()


def phase_base():
    """The single-frame detector on 4 s2d(4)-packed frames: one stem pool,
    one ROIAlign and a body and res5 pass of epilogues a call, no other
    kernel, finite detections."""
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
    calls = 4
    with torch.inference_mode():
        images = normalize_u8_frames(torch.from_numpy(frames).to(dev), sizes)
        for k in kernels:
            k.launches = 0
        for _ in range(calls):
            dets = model.forward_test(images, sizes)
    launches = {k.__name__: k.launches for k in kernels}
    expect = dict(_NO_KERNEL, stem_pool_packed=calls, roi_align=calls,
                  bottleneck_epilogue=EPI_PASS * calls)
    finite = bool(torch.isfinite(dets.boxes).all() and torch.isfinite(dets.scores).all())
    print(f"[base] forward_test on {METHOD_LANES} packed frames x {calls} calls: "
          f"launches {launches} (expected {expect}); detections "
          f"{tuple(dets.boxes.shape)} finite {finite}, {int(dets.valid.sum())} valid")
    if launches != expect:
        _fail(f"base: launch counts {launches} != {expect}")
    if not finite or tuple(dets.boxes.shape) != (METHOD_LANES, 300, 4):
        _fail("base: detections not finite or of the wrong shape")
    _check_s2d2_stem(model.backbone.stem, rs, kernels)
    del model
    torch.cuda.empty_cache()


def _check_s2d2_stem(stem, rs, kernels):
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
        launches = sum(k.launches for k in kernels)
    err = (got - want).abs().max().item()
    tol = ATOL_STEM + RTOL_STEM * want.abs().max().item()
    shape = (2, 64, CANVAS[0] // 4, CANVAS[1] // 4)
    print(f"[base] stem on s2d(2)-packed frames (2, {CANVAS[0] // 2}, {CANVAS[1] // 2}, 12): "
          f"{tuple(got.shape)}, f32 against the canonical branch max_abs_err {err:.3e} "
          f"(tolerance {tol:.3e}); bf16 finite "
          f"{bool(torch.isfinite(low).all())}; kernel launches {launches}")
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


def run_eval_path(dev, cfg, base_cfg, frame_hw, lengths, portrait, lanes, tag="eval"):
    """The evaluation entry point's path on a synthetic on-disk VID tree:
    ``cfg``'s MEGA through ``compute_on_dataset(lanes=lanes)`` (the port's
    dataset, index and XML parsing, global schedule, ``EvalPreprocessor``
    with ``resize_bilinear_u8``, ``video_shards``), checked per step by
    ``run_lanes``; ``evaluate_predictions`` with a motion-IoU table and
    ``write_result``; then ``base_cfg``'s detector through the serial
    engine over the first video."""
    import tempfile

    import scipy.io as sio
    import torch
    from mega_pytorch_tpu_torch.data.datasets.vid import VIDDataset, VIDMEGADataset
    from mega_pytorch_tpu_torch.data.loader import EvalPreprocessor
    from mega_pytorch_tpu_torch.data.paths_catalog import dataset_args
    from mega_pytorch_tpu_torch.data.samplers import video_shards
    from mega_pytorch_tpu_torch.engine.inference import compute_on_dataset, evaluate_predictions
    from mega_pytorch_tpu_torch.models.detectors import build_detection_model
    from mega_pytorch_tpu_torch.tools.test_net import dataset_kwargs, video_starts, write_result

    rs = np.random.RandomState(7)
    prep = EvalPreprocessor(min_size=cfg.INPUT.MIN_SIZE_TEST, max_size=cfg.INPUT.MAX_SIZE_TEST,
                            canvas_short=cfg.TPU.CANVAS_HEIGHT,
                            canvas_long=cfg.TPU.CANVAS_WIDTH, max_gt=cfg.TPU.MAX_GT_BOXES)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        mious = _write_vid_tree(root, lengths, portrait, frame_hw, rs)
        model = build_detection_model(cfg, dev, torch.Generator(dev).manual_seed(0), lanes)
        ds = _synthetic_frames(VIDMEGADataset, frame_hw, rs)(
            **dataset_args("VID_val_videos", tmp), portrait=portrait,
            **dataset_kwargs(cfg, "mega", 0))
        indices = video_shards(video_starts(ds), len(ds), 1)[0]
        print(f"[{tag}] built {cfg.MODEL.BACKBONE.CONV_BODY} MEGA ({cfg.TPU.COMPUTE_DTYPE}, "
              f"reduce channel {cfg.MODEL.VID.ROI_BOX_HEAD.REDUCE_CHANNEL}) for {lanes} lanes; "
              f"{len(lengths)} videos ({int(np.sum(portrait))} portrait) of "
              f"{min(lengths)}-{max(lengths)} frames, {len(ds)} frames of "
              f"{frame_hw[0]}x{frame_hw[1]}")
        preds, _ = run_lanes(model, ds, lanes, dev, tag=tag,
                             run=lambda: compute_on_dataset(model, ds, indices, prep, "mega",
                                                            lanes=lanes))
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
        base_preds = compute_on_dataset(base, base_ds, video, prep, "base")
        base_launches = {k.__name__: k.launches for k in kernels}
        finite = all(np.isfinite(p["boxes"]).all() and np.isfinite(p["scores"]).all()
                     for p in base_preds.values())
        print(f"[{tag}] base ({base_cfg.MODEL.BACKBONE.CONV_BODY}) through the serial engine "
              f"over video 0 ({len(video)} frames, f32 canvases packed s2d(4)): "
              f"{len(base_preds)} frames predicted, finite {finite}, launches {base_launches}")
        if sorted(base_preds) != video or not finite:
            _fail(f"{tag}: the base method's serial run did not predict every frame")
        if base_launches != dict(_NO_KERNEL, stem_pool_packed=len(video),
                                 roi_align=len(video),
                                 bottleneck_epilogue=EPI_PASS * len(video)):
            _fail(f"{tag}: the serial base run launched {base_launches}, not one stem pool, "
                  f"one ROIAlign and a body and res5 pass of epilogues a frame")
        del base


def phase_eval_path():
    """The eval path at full width: MEGA R-101 (the preset, no channel
    reduce) in bf16 on the 608x1024 canvas with 12 lanes over 12 on-disk
    synthetic videos of 10-20 frames of 720x1280 (two of them portrait),
    then base R-101 serially over the 10-frame first video."""
    import torch
    from mega_pytorch_tpu_torch.config import get_preset

    rs = np.random.RandomState(11)
    lengths = [10] + [int(n) for n in rs.randint(10, 21, EVAL_VIDEOS - 1)]
    portrait = [v in (3, 8) for v in range(EVAL_VIDEOS)]
    run_eval_path(torch.device("cuda"), get_preset("mega_R_101").freeze(),
                  get_preset("base_R_101").freeze(), EVAL_FRAME, lengths, portrait, LANES)


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


def run_training(preset, dataset_name, iters, ckpt, per_iter, tag):
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
    state there bit for bit."""
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
    from mega_pytorch_tpu_torch.utils.checkpoint import Checkpointer

    dev = torch.device("cuda")
    rs = np.random.RandomState(13)
    kernels = _kernels()
    rec: dict = dict(launches=[])
    step = trainer.train_step

    def recording_step(model, optimizer, scheduler, *args, **kw):
        if not rec["launches"]:
            rec.update(model=model, optimizer=optimizer, scheduler=scheduler,
                       initial=_snapshot(model, optimizer, scheduler)[0])
        before = {k.__name__: k.launches for k in kernels}
        losses = step(model, optimizer, scheduler, *args, **kw)
        rec["launches"].append({k.__name__: k.launches - before[k.__name__] for k in kernels})
        if len(rec["launches"]) == 1:  # which parameters the first step moved
            initial = rec["initial"]
            moved = {n: not torch.equal(p.detach(), initial[n])
                     for n, p in model.named_parameters() if p.requires_grad}
            rec["moved"] = {g["name"]: [moved[n] for n in _names(model, g)]
                            for g in optimizer.param_groups}
            rec["moved_modules"] = {}
            for n, m in moved.items():
                top = n.split(".")[0]
                rec["moved_modules"][top] = rec["moved_modules"].get(top, False) or m
        if len(rec["launches"]) == ckpt:
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
        refs = " + ".join(f"{n} {key}" for key, n in _ref_groups(cfg).items())
        print(f"[{tag}] {preset}: {cfg.MODEL.BACKBONE.CONV_BODY} {cfg.MODEL.VID.METHOD}, "
              f"{cfg.TPU.COMPUTE_DTYPE} compute, canvas {cfg.TPU.CANVAS_HEIGHT}x"
              f"{cfg.TPU.CANVAS_WIDTH}, MIN/MAX_SIZE_TRAIN {cfg.INPUT.MIN_SIZE_TRAIN}/"
              f"{cfg.INPUT.MAX_SIZE_TRAIN}, ROI batch {cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE}"
              f", {cfg.SOLVER.IMS_PER_BATCH} samples an iteration of cur + {refs}; sets "
              f"{cfg.DATASETS.TRAIN}: {len(TRAIN_VIDEOS)} videos of {min(TRAIN_VIDEOS)}-"
              f"{max(TRAIN_VIDEOS)} frames and {TRAIN_STILLS} stills of {TRAIN_FRAME[0]}x"
              f"{TRAIN_FRAME[1]}, two portrait videos and one portrait still")
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
            record = train_net.main(args)
        finally:
            trainer.train_step = step
            detectors.build_training_model, paths_catalog.build_dataset = build, catalog
        launches = {kern.__name__: kern.launches for kern in kernels}

        n_iter = len(record["losses"])
        for i, losses in enumerate(record["losses"]):
            print(f"[{tag}] iteration {i + 1}: " + ", ".join(
                f"{key} {v:.5f}" for key, v in losses.items()))
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
    torch.cuda.empty_cache()


def phase_train():
    """MEGA R-101 training (the ``mega_R_101`` preset: one sample an
    iteration of cur + 2 local, 3 memory and 2 global frames), TRAIN_ITERS
    iterations with a checkpoint at TRAIN_CKPT."""
    run_training("mega_R_101", "VIDMEGADataset", TRAIN_ITERS, TRAIN_CKPT, PER_ITER_TRAIN,
                 "train")


def phase_method_training():
    """RDN (``rdn_R_101``: the advanced stage, IMS_PER_BATCH 4 samples of cur
    + 2 refs one after the other), FGFA (``fgfa_R_101``: cur + 2 refs) and
    DFF (``dff_R_101``: cur + 1 ref) training, METHOD_TRAIN_ITERS iterations
    each with a checkpoint at METHOD_TRAIN_CKPT."""
    for method, (preset, dataset_name, per_iter) in METHOD_TRAIN.items():
        run_training(preset, dataset_name, METHOD_TRAIN_ITERS, METHOD_TRAIN_CKPT, per_iter,
                     f"{method} train")


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


def phase_tta():
    """Test-time augmentation through ``tools/test_net.py``'s ``main``: the
    ``base_R_101`` preset (bf16, 608x1024 canvas, random weights from seed
    0) over an on-disk ILSVRC2015 tree of one video of TTA_FRAMES JPEG
    frames of 720x1280 (index, XML annotations, files decoded by PIL), with
    ``TEST.BBOX_AUG`` on, ``H_FLIP`` and ``SCALE_H_FLIP``, TTA_SCALES and
    ``MAX_SIZE`` 2000: every frame runs the detector TTA_RUNS times and
    launches the stem pool TTA_RUNS times (counted per frame), the merged
    detections capped at TEST.DETECTIONS_PER_IMG and inside the image,
    evaluation run."""
    import tempfile

    import torch
    from mega_pytorch_tpu_torch.engine import bbox_aug
    from mega_pytorch_tpu_torch.models.detectors.rcnn import GeneralizedRCNN
    from mega_pytorch_tpu_torch.tools import test_net

    rs = np.random.RandomState(17)
    kernels = _kernels()
    stem = next(k for k in kernels if k.__name__ == "stem_pool_packed")
    calls, stem_pools = [0], []
    forward_test, detect = GeneralizedRCNN.forward_test, bbox_aug.im_detect_bbox_aug

    def counted(self, *a):
        calls[0] += 1
        return forward_test(self, *a)

    def counted_frame(*a, **k):
        before = stem.launches
        out = detect(*a, **k)
        stem_pools.append(stem.launches - before)
        return out

    opts = ["TEST.BBOX_AUG.ENABLED", "True", "TEST.BBOX_AUG.H_FLIP", "True",
            "TEST.BBOX_AUG.SCALE_H_FLIP", "True", "TEST.BBOX_AUG.SCALES", str(TTA_SCALES),
            "TEST.BBOX_AUG.MAX_SIZE", "2000"]
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        _write_vid_tree(root, [TTA_FRAMES], [False], EVAL_FRAME, rs,
                        index="VID_val_frames.txt")
        _write_jpegs(root / "ILSVRC2015" / "Data" / "VID" / "val" / "v000",
                     _draw_frames(rs, TTA_FRAMES, EVAL_FRAME))
        for k in kernels:
            k.launches = 0
        GeneralizedRCNN.forward_test, bbox_aug.im_detect_bbox_aug = counted, counted_frame
        try:
            run = test_net.main(["--preset", "base_R_101", "--data-dir", tmp, "--output-dir",
                                 str(root / "out"), "--device", "cuda", "opts", *opts])
        finally:
            GeneralizedRCNN.forward_test, bbox_aug.im_detect_bbox_aug = forward_test, detect
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
    print(f"[tta] base_R_101 (bf16) through test_net.main, TEST.BBOX_AUG: the base size and "
          f"scales {TTA_SCALES}, each with its flip, MAX_SIZE 2000, {TTA_FRAMES} JPEG frames of "
          f"{h}x{w}: {calls[0]} detector runs ({TTA_RUNS} a frame expected), detections a "
          f"frame {counts} (cap {cap}), inside the image {inside}; launches {launches} "
          f"(expected {expect}); stem pools a frame {stem_pools}; AP50 "
          f"{run['result']['all']['map']:.4f} (random weights)")
    if calls[0] != TTA_RUNS * TTA_FRAMES or sorted(preds) != list(range(TTA_FRAMES)):
        _fail(f"tta: {calls[0]} detector runs over {sorted(preds)}")
    if max(counts) > cap or not inside:
        _fail("tta: detections beyond the cap or outside the image")
    if launches != expect or stem_pools != [TTA_RUNS] * TTA_FRAMES:
        _fail(f"tta: launches {launches} != {expect}, or not {TTA_RUNS} stem pools in "
              f"every frame ({stem_pools})")
    torch.cuda.empty_cache()


def phase_demo():
    """The frame-folder demo: DEMO_FRAMES JPEG frames of 720x1280 through
    ``tools/demo.py``'s ``main`` with the ``mega_R_101`` preset (bf16,
    608x1024 canvas, random weights from seed 0, s2d(4)-packed canvases):
    every frame annotated and written at the input size, the stem pool,
    "none" and "compute" launched, one detection a frame (the attention
    counts a multiple of the frames), and its detections bit for bit those
    of ``StreamingInferencer`` over the same frames with the same seeded
    model and preprocessor."""
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
    with tempfile.TemporaryDirectory() as tmp:
        folder, out_dir = Path(tmp) / "frames", Path(tmp) / "vis"
        _write_jpegs(folder, _draw_frames(rs, DEMO_FRAMES, EVAL_FRAME))
        for k in kernels:
            k.launches = 0
        run = demo.main(["--preset", "mega_R_101", "--input-folder", str(folder),
                         "--output-folder", str(out_dir), "--device", "cuda",
                         "--confidence-threshold", "0.05"])
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
    h, w = EVAL_FRAME
    packed = pack_factor("mega", (cfg.TPU.CANVAS_HEIGHT, cfg.TPU.CANVAS_WIDTH))
    print(f"[demo] mega_R_101 (bf16, packed s2d({packed})) over {DEMO_FRAMES} JPEG frames of "
          f"{h}x{w}: {len(written)} annotated frames written, sizes {sorted(sizes)}; "
          f"detections == StreamingInferencer's bit for bit {same} "
          f"({sum(len(p['boxes']) for p in preds.values())} boxes); launches {launches}")
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


def phase_gn():
    """Group norm: ``base_R_50`` with ``BottleneckWithGN`` / ``StemWithGN``
    (bf16, random weights from seed 0) on 2 s2d(4)-packed 608x1024 frames:
    its C4 map against the same weights in f32 on the canonical RGB frames
    (TF32 off) within RTOL_GN_MAX / RTOL_GN_MEAN, the f32 model's packed
    route against its canonical one within RTOL_GN_F32, no stem pool
    launch, ``forward_test`` finite; then ``build_resnet_c4`` of R-101 with
    NUM_GROUPS 32 and WIDTH_PER_GROUP 8 (the X-101-32x8d widths, frozen BN)
    on one packed frame: its C4 map and a body pass of epilogues."""
    import torch
    from mega_pytorch_tpu_torch.config import get_preset
    from mega_pytorch_tpu_torch.data.transforms import normalize_u8_frames, s2d_pack_frames
    from mega_pytorch_tpu_torch.models.backbone.resnet import build_resnet_c4
    from mega_pytorch_tpu_torch.models.detectors import build_detection_model
    from mega_pytorch_tpu_torch.ops.kernels.bottleneck_epilogue import (
        bottleneck_epilogue as epilogue,
    )

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
        launches = {k.__name__: k.launches for k in kernels}
        packed32 = models["float32"].backbone(x48)
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
          f"route: {launches_f32})")
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
    epilogue.launches = 0
    with torch.inference_mode():
        c4 = body(x48[:1])
    print(f"[gn] build_resnet_c4 R-101 32x8d (NUM_GROUPS 32, WIDTH_PER_GROUP 8, bf16, "
          f"frozen BN) on a packed {CANVAS[0]}x{CANVAS[1]} frame: C4 map {tuple(c4.shape)} "
          f"finite {bool(torch.isfinite(c4).all())}, bottleneck epilogues {epilogue.launches}")
    if tuple(c4.shape) != (1, CANVAS[0] // 16, CANVAS[1] // 16, 1024) or not bool(
            torch.isfinite(c4).all()):
        _fail("gn: the 32x8d C4 body's output is wrong")
    if epilogue.launches != EPI_C4:
        _fail(f"gn: the 32x8d C4 body launched {epilogue.launches} epilogues in a pass")
    del body
    torch.cuda.empty_cache()


def phase_native_loader():
    """Information only: whether the native JPEG loader builds on this
    machine (g++, libjpeg's jpeglib.h), and the reason if not. If it builds,
    ``load_batch`` of DEMO_FRAMES 720x1280 JPEG frames must equal
    ``load_frame`` frame by frame. Host code: a missing toolchain does not
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
        return
    except OSError as e:
        print(f"[loader] unavailable: {e}")
        return
    rs = np.random.RandomState(23)
    cfg = get_preset("mega_R_101")  # the demo's sizes: 600 / 1000 on the 608x1024 canvas
    args = (cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST)
    canvas = (cfg.TPU.CANVAS_HEIGHT, cfg.TPU.CANVAS_WIDTH)
    with tempfile.TemporaryDirectory() as tmp:
        paths = [str(p) for p in _write_jpegs(Path(tmp), _draw_frames(rs, DEMO_FRAMES,
                                                                     EVAL_FRAME))]
        batch, hws = native_loader.load_batch(paths, *args, [False] * len(paths), *canvas)
        frames = [native_loader.load_frame(p, *args, False, *canvas) for p in paths]
        pil = preprocess_image(decode_rgb(paths[0]), *args, False, *canvas)
    same = all(np.array_equal(batch[i], f) and tuple(hws[i]) == hw
               for i, (f, hw) in enumerate(frames))
    oh, ow = frames[0][1]
    diff = float(np.abs(batch[0][:oh, :ow] - pil.image[:oh, :ow]).mean())
    print(f"[loader] built; load_batch == load_frame frame by frame {same}; mean difference "
          f"of the first frame from the PIL-exact canvas {diff:.3f} levels")
    if not same:
        _fail("loader: load_batch differs from load_frame")


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


def phase_zoo():
    """The detector zoo at published widths, bf16, random weights from
    ``torch.Generator("cuda").manual_seed(0)``: R-50-FPN (body and FPN with
    the max-pool top block on two packed 800x1344 canvases: one stem pool
    launch), RetinaNet R-50-FPN (P3-P7, the head, inference per image), the
    mask and keypoint heads through ``CombinedROIHeads`` on P2, FBNet's
    default arch and head groups, ROIPool, DFConv2d and the deformable ROI
    pooling modules; the correctness of each at a reduced size on the card
    against the CPU."""
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

    with torch.inference_mode():
        # the zoo path once, counted from 0: every launch it makes
        for k in kernels:
            k.launches = 0
        feats = body(packed)
        pyramid = top(feats)
        fpn_launches = {k.__name__: k.launches for k in kernels}
        levels = p6p7([None, *body(packed)[1:]])
        logits, deltas = head(levels)
        anchors = retinanet.retinanet_anchors([tuple(f.shape[1:3]) for f in levels],
                                              device=dev)
        dets = [retinanet.retinanet_inference(anchors, [l[i] for l in logits],
                                              [d[i] for d in deltas], (im_h, im_w))
                for i in range(ZOO_FRAMES)]
        probs = heads.mask_probs(pyramid[0], det_boxes, det_labels)
        loss = heads.mask_losses(pyramid[0], sampled, gt_masks, matched)["loss_mask"]
        kp = heads.keypoint_logits(pyramid[0], det_boxes)
        t_out = trunk(rgb[:1])
        fb = [t_out] + [h(t_out) for h in fb_heads.values()]
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
        del feats, pyramid, levels, logits, deltas, dets, probs, kp, fb, gt_masks

        # the zoo's ops at full width
        c4_hw = (ZOO_CANVAS[0] // 16, ZOO_CANVAS[1] // 16)  # the C4 map: (50, 84)
        c8_hw = (ZOO_CANVAS[0] // 8, ZOO_CANVAS[1] // 8)  # P3: (100, 168)
        c4 = torch.randn(1, *c4_hw, 1024, generator=gen, device=dev).to(bf)
        rois300 = torch.from_numpy(_zoo_boxes(rs, 1, 300, im_h, im_w)).to(dev)
        ops = {f"roi_pool 300 ROIs 7x7 on {tuple(c4.shape)} bf16": roi_pool(c4, rois300,
                                                                          1 / 16.0)}
        del c4
        fmap = torch.randn(1, *c8_hw, 256, generator=gen, device=dev).to(bf)
        for modulated in (False, True):
            dconv = init_module_(DFConv2d(256, 256, with_modulated_dcn=modulated,
                                          deformable_groups=2, dtype=bf, device=dev), gen)
            dconv.offset.weight.normal_(0.0, 0.01, generator=gen)
            ops[f"DFConv2d {'v2' if modulated else 'v1'} 256->256, 2 groups, "
                f"{tuple(fmap.shape)} bf16"] = dconv(fmap)
        c4_256 = torch.randn(*c4_hw, 256, generator=gen, device=dev)
        for cls in (DeformRoIPoolingPack, ModulatedDeformRoIPoolingPack):
            pack = init_module_(cls(1 / 16.0, 7, 256, False, sample_per_part=4, trans_std=0.1,
                                    device=dev), gen)
            ops[f"{cls.__name__} 300 ROIs, out 7, on {tuple(c4_256.shape)}"] = pack(
                c4_256, rois300[0])
        print("[zoo] ops at full width: " + "; ".join(
            f"{name} {tuple(out.shape)}" for name, out in ops.items()))
        for name, out in ops.items():
            if not torch.isfinite(out).all():
                _fail(f"zoo: {name} is not finite")
        del fmap, c4_256, ops

    _zoo_correctness(dev)
    torch.cuda.empty_cache()


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


def _check_c2(dev, pickle_path):
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
    with open(pickle_path, "wb") as f:
        pickle.dump({"blobs": blobs}, f, protocol=2)
    load_c2_weights(str(pickle_path), model)
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
          f"{pickle_path.stat().st_size / 2**20:.0f} MB, loaded into mega_R_101 on the card: "
          f"{len(names)} backbone and res5 tensors of {loaded} loadable blobs, {len(wrong)} "
          f"unequal to their blobs; the stem on one packed {CANVAS[0]}x{CANVAS[1]} frame bit "
          f"for bit that of a model given the weights by state_dict: {same} (before the "
          f"load: {not differed})")
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


def _phase_classic_head(dev, pickle_path, kernels):
    """The base R-101 C4 body (res2-res5 from the pickle) on one packed
    608x1024 frame, then CLASSIC_ROIS proposals through the classic head and
    FastRCNNPredictor in bf16: one stem pool and one ROIAlign launch, finite
    outputs; the same modules in f32 at 128x192 on the card against the
    CPU."""
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
        launches = {k.__name__: k.launches for k in kernels}
    shapes = [tuple(t.shape) for t in out]
    want = [(1, CANVAS[0] // 16, CANVAS[1] // 16, 1024), (1, CLASSIC_ROIS, 7, 7, 2048),
            (1, CLASSIC_ROIS, 31), (1, CLASSIC_ROIS, 124)]
    finite = all(bool(torch.isfinite(t).all()) for t in out)
    print(f"[classic] base R-101 C4 body on one packed {CANVAS[0]}x{CANVAS[1]} frame, then "
          f"{CLASSIC_ROIS} proposals through ResNet50Conv5ROIFeatureExtractor (14x14 ROIAlign, "
          f"res5 with stride 2) and FastRCNNPredictor, bf16: outputs {shapes}, finite "
          f"{finite}; launches {launches}")
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


def _phase_flop_count(kernels):
    """``tools/profile_mfu.py``'s count: one MEGA lockstep step at MFU_SMALL
    with one lane counted on the CPU and on the card (equal totals), then
    the 12-lane MEGA step and one ``mega_R_101`` training iteration on the
    card, each counted after one warm-up step, with the launches of the
    counted step (as the path's own phases require)."""
    import torch
    from mega_pytorch_tpu_torch.tools import profile_mfu as pm

    counts = {}
    for dev in ("cpu", "cuda"):
        step, _ = pm.mega_step(1, MFU_SMALL, dev, "float32")
        counts[dev] = pm.count_flops(step)
        del step
    cpu_flops, card_flops = counts["cpu"]["flops"], counts["cuda"]["flops"]
    print(f"[flops] one MEGA lockstep step, 1 lane, {MFU_SMALL[0]}x{MFU_SMALL[1]}, f32: "
          f"{cpu_flops} FLOPs counted on the CPU, {card_flops} on the card (of which hand-"
          f"written kernels {counts['cpu']['kernel_flops']} / {counts['cuda']['kernel_flops']}: "
          f"the CPU runs attention's einsum path)")
    if cpu_flops != card_flops or not counts["cuda"]["kernel_flops"]:
        _fail(f"flops: the same step counts {cpu_flops} FLOPs on the CPU, {card_flops} on the "
              "card")
    for path, make, expect in (("mega step", lambda: pm.mega_step(LANES), PER_STEP["mega"]),
                               ("train", pm.train_step, PER_ITER_TRAIN)):
        step, _ = make()
        step()
        for k in kernels:
            k.launches = 0
        c = pm.count_flops(step)
        launches = {k.__name__: k.launches for k in kernels}
        print(f"[flops] {path}: {c['flops'] / 1e9:.1f} GFLOP a step, "
              f"{sum(c['kernel_flops'].values()) / 1e9:.2f} of them in hand-written kernels "
              f"{c['kernel_flops']}; launches of the counted step {launches}")
        if launches != expect or not c["flops"]:
            _fail(f"flops: {path} launched {launches} (want {expect})")
        del step
        torch.cuda.empty_cache()


def phase_classic_flops():
    """Detectron weights, the classic C4 head and the FLOP count (phase 17)."""
    import tempfile

    import torch

    dev = torch.device("cuda")
    kernels = _kernels()
    with tempfile.TemporaryDirectory() as tmp:
        pickle_path = Path(tmp) / "R-101.pkl"
        _check_c2(dev, pickle_path)
        torch.cuda.empty_cache()
        _phase_classic_head(dev, pickle_path, kernels)
    torch.cuda.empty_cache()
    _phase_flop_count(kernels)


def _main_path_cases(card):
    """(test, arguments) of each card test in MAIN_PATH_CASES over the
    product of its parametrize marks, kept where the case's filter holds."""
    import itertools

    cases = []
    for name, keep in MAIN_PATH_CASES:
        test = getattr(card, name)
        grids = []
        for mark in test.pytestmark:
            if mark.name == "parametrize":
                names = [a.strip() for a in mark.args[0].split(",")]
                grids.append([dict(zip(names, (v,) if len(names) == 1 else v))
                              for v in mark.args[1]])
        kept = [c for c in ({k: v for g in combo for k, v in g.items()}
                            for combo in itertools.product(*grids)) if keep(c)]
        if not kept:
            _fail(f"kernels: {name} has no case at the main path's shapes")
        cases += [(test, c) for c in kept]
    return cases


def phase_kernels(path_launches):
    """Each kernel's wrapper at the main path's shapes against its plain
    version, through the card tests' cases (phase 18); ``path_launches``:
    each kernel's launches in phase 5's run."""
    import torch

    torch.cuda.empty_cache()
    threads = torch.get_num_threads()
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_kernels_cuda as card

    torch.set_num_threads(threads)  # the test module pins two threads
    dev = torch.device("cuda")
    kernels = _kernels()
    checked = {k.__name__: [] for k in kernels}
    for test, case in _main_path_cases(card):
        label = test.__name__ + "[" + "-".join(
            str(v[0] if isinstance(v, tuple) else v) for v in case.values()) + "]"
        before = {k.__name__: k.launches for k in kernels}
        try:
            test(dev, **case)
        except AssertionError as e:
            _fail(f"kernels: {label}: {e!r}")
        torch.cuda.synchronize()
        for k in kernels:
            if k.launches != before[k.__name__]:
                checked[k.__name__].append(label)
        torch.cuda.empty_cache()
    for k in kernels:
        name = k.__name__
        print(f"[kernels] {name}: {path_launches[name]} launches in phase 5's run "
              f"({PER_STEP['mega'][name]} a step); against its plain version at the path's "
              f"shapes in {len(checked[name])} cases: {', '.join(checked[name])}")
        if not checked[name]:
            _fail(f"kernels: no case launched {name}")


def phase_ddp():
    """DistributedDataParallel on the card: a one-rank NCCL process group
    (``parallel/ddp.py:init_distributed`` with a ``file://`` store in a
    temporary directory) and ``tools/ddp_check.py``'s comparison: DDP_ITERS
    iterations of ``rdn_R_101`` (4 samples an iteration, the first three
    backward passes of each under ``no_sync``) through ``train_step`` on
    the wrapped model, against the same iterations through the plain step,
    run twice from the same calibrated state, samples and generator seeds
    (the second run shows the card's own spread) and once with the last
    sample left out (a planted fault); each tensor's update in both DDP runs
    within max(1e-5, 8x that spread), the fault above it; RDN's training
    launches every iteration."""
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
          f"{rec['ddp_losses']}, plain {rec['plain_losses']}; launches {launches}")
    if not rec["ok"]:
        _fail(f"ddp: the DDP step's updates differ from the plain step's by "
              f"{rec['err']:.3e} (bound {rec['bound']:.3e}, the planted fault "
              f"{rec['fault']:.3e}), or the ranks differ")
    if per_iter != METHOD_TRAIN["rdn"][2] or any(n % DDP_ITERS for n in launches.values()):
        _fail(f"ddp: launches {launches} over {DDP_ITERS} iterations")
    torch.cuda.empty_cache()


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

    name = timed("device", phase_device)

    import torch

    # the f32 checks hold sums against the CPU and the canonical stem
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    timed("build", phase_build)
    model, frames, gframes, outs = timed("stream", phase_stream)
    timed("determinism", phase_determinism, model, frames, gframes, outs)
    del model, frames, gframes, outs
    torch.cuda.empty_cache()
    path_launches = timed("lanes", phase_lanes)
    for phase, fn in (("methods", phase_methods), ("base", phase_base),
                      ("eval path", phase_eval_path), ("train", phase_train),
                      ("method training", phase_method_training), ("ddp", phase_ddp),
                      ("tta", phase_tta), ("demo", phase_demo), ("gn", phase_gn),
                      ("native loader", phase_native_loader), ("zoo", phase_zoo),
                      ("classic head and flop count", phase_classic_flops)):
        timed(phase, fn)
    timed("kernels", phase_kernels, path_launches)
    print(f"[result] phase seconds {json.dumps({k: round(v, 1) for k, v in seconds.items()})}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
