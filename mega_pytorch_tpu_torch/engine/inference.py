"""Streaming inference and evaluation (counterpart of
``mega_pytorch_tpu/engine/inference.py``).

``serve_step`` is one MEGA lane's step: the one-lane case of the lockstep step
(``batched_inference.make_lockstep_step``), so a single stream and L lockstep
lanes run one per-frame code path. Each step
  1. stacks the local and the global uint8 frame and normalizes them;
  2. runs ``precompute_pair`` (one backbone pass over both);
  3. resets the carry from the local frame (video start) or pushes it;
  4. applies the global frame to the global cache if this step has one;
  5. runs ``detect_key`` and keeps its carry (the memory pushes) only on an
     emitted frame.
``run_video`` schedules reset, global updates and emission over one video
the way the lockstep engine schedules one lane.

``StreamingInferencer`` is the serial engine, one video at a time and one
model method per call, as the JAX package's: it reads the f32 canvases of
``EvalPreprocessor._prep`` (unpacked, so the canonical 7x7 stem runs) and
owns all IO. Per video (frame_category 0) it fills the window with frame 0,
reads ahead (all_frame_interval - key_frame_location - 1) frames, and for
MEGA applies the video's initial global frames before the first detect;
then one detect per frame. ``compute_on_dataset`` dispatches as the JAX
one does: more than one lane of a streaming method goes to the lockstep
engine, everything else (the base method included) to the serial engine.
"""

from __future__ import annotations

import time
from typing import Iterator, NamedTuple

import numpy as np
import torch

from ..data.transforms import s2d_pack_frames


class StepOutput(NamedTuple):
    carry: object  # MEGACarry of one lane, without the lane dimension
    dets: object  # Detections, batch of 1
    emitted: bool


def serve_step(model, carry, frame, size, gframe, gsize, reset: bool,
               gmask: bool, emit: bool) -> StepOutput:
    """One lane step. carry: a one-lane MEGACarry without the lane dimension,
    or None before the first step; frame/gframe (H, W, C) uint8 tensors on
    the model's device (C = 48 or 12 for s2d(4)- or s2d(2)-packed frames), size/gsize (2,)
    f32 [h, w]."""
    from .batched_inference import make_lockstep_step

    dev = frame.device
    if carry is None:
        carries, reset = model.zero_carry(1, dev), True
    else:
        carries = _map(carry, lambda x: x[None])
    flags = torch.tensor([[reset], [gmask], [emit]], device=dev)
    carries, dets = make_lockstep_step(model)(
        carries, frame[None], size[None], gframe[None], gsize[None], *flags)
    return StepOutput(_map(carries, lambda x: x[0]), dets, emit)


def _map(carry, fn):
    return carry._make(tuple(fn(y) for y in x) if isinstance(x, tuple) else fn(x)
                       for x in carry)


def video_schedule(num_frames: int, warmup: int, global_size: int):
    """Per step: (local frame index, global frame index or None, reset, emit).

    The lockstep engine's lane feed for one video of ``num_frames`` frames:
    ``warmup + num_frames`` steps; local frame min(s, L-1); the first
    ``global_size`` steps each apply one of the video's initial global
    frames, and every emitting step after the first applies one more; the
    frame at step s is emitted (detected) from s = warmup on."""
    steps = []
    g = 0
    for s in range(warmup + num_frames):
        j = s - warmup
        gidx = None
        if s < global_size or j >= 1:
            gidx, g = g, g + 1
        steps.append((min(s, num_frames - 1), gidx, s == 0, j >= 0))
    return steps


def synthetic_video(rs: np.random.RandomState, num_frames: int, canvas_h: int,
                    canvas_w: int, global_size: int = 10):
    """Random uint8 video, s2d(4)-packed on the host: (frames (L, H/4, W/4,
    48), global frames drawn from them in the count ``run_video`` needs)."""
    frames = rs.randint(0, 256, (num_frames, canvas_h, canvas_w, 3), dtype="uint8")
    packed = s2d_pack_frames(frames, 4)
    gidx = rs.randint(0, num_frames, global_size + num_frames - 1)
    return packed, packed[gidx]


def run_video(model, frames: np.ndarray, global_frames: np.ndarray,
              sizes: np.ndarray | None = None,
              global_sizes: np.ndarray | None = None) -> Iterator[StepOutput]:
    """Stream one video through ``serve_step``; yields every step's output
    (warmup steps have ``emitted=False``).

    frames (L, H, W, C) uint8 and global_frames (Gn, H, W, C) uint8, with
    Gn = global_size + L - 1: the global updates in schedule order (see
    ``video_schedule``). sizes (L, 2) / global_sizes (Gn, 2) default to the
    full canvas (unpacked pixels)."""
    v = model.v
    warmup = v.all_frame_interval - v.key_frame_location - 1
    sched = video_schedule(len(frames), warmup, v.global_size)
    need = sum(g is not None for _, g, _, _ in sched)
    if len(global_frames) != need:
        raise ValueError(f"{len(frames)} frames need {need} global frames, "
                         f"got {len(global_frames)}")
    dev = next(model.parameters()).device
    pack = {48: 4, 12: 2, 3: 1}[frames.shape[-1]]  # s2d(4), s2d(2) or plain RGB
    canvas = np.array([frames.shape[1] * pack, frames.shape[2] * pack], np.float32)
    if sizes is None:
        sizes = np.tile(canvas, (len(frames), 1))
    if global_sizes is None:
        global_sizes = np.tile(canvas, (len(global_frames), 1))

    def on_device(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    carry = None
    for fidx, gidx, reset, emit in sched:
        frame, size = on_device(frames[fidx]), on_device(sizes[fidx])
        if gidx is None:  # ignored: gmask is off
            gframe, gsize = frame, size
        else:
            gframe, gsize = on_device(global_frames[gidx]), on_device(global_sizes[gidx])
        out = serve_step(model, carry, frame, size, gframe, gsize, reset,
                         gidx is not None, emit)
        carry = out.carry
        yield out


def _extract(dets, size, orig_hw) -> dict:
    """Padded Detections (numpy, batch of 1) → numpy dict in original image
    coordinates."""
    valid = np.asarray(dets.valid[0])
    boxes = np.asarray(dets.boxes[0])[valid]
    oh, ow = float(size[0]), float(size[1])
    h0, w0 = orig_hw
    boxes = boxes * np.array([w0 / ow, h0 / oh, w0 / ow, h0 / oh], np.float32)
    return {
        "boxes": boxes,
        "scores": np.asarray(dets.scores[0])[valid],
        "labels": np.asarray(dets.labels[0])[valid],
    }


class StreamingInferencer:
    """The serial engine: a per-method stateful runner of the model's
    streaming methods, one lane (the lane dimension is 1 throughout)."""

    def __init__(self, model, method: str, preprocessor, dataset):
        self.model, self.method = model, method
        self.prep = preprocessor
        self.dataset = dataset
        self.device = next(model.parameters()).device
        self.carry = None

    def _batch(self, images: np.ndarray, sizes: np.ndarray):
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        return dev(images), dev(sizes)

    def _frame_batch(self, key: str, sample: dict):
        return self._batch(sample[key], sample[key + "_size"])

    def _load_extra_frame(self, pattern: str, frame_id: int):
        p = self.prep._prep(self.dataset.load_frame(pattern, frame_id), flip=False)
        return self._batch(p.image[None], p.size[None])

    def _next_frame(self, sample: dict):
        """The frame entering the window after frame 0: the sample's
        reference frame (its frame + max_offset, clamped to the video)."""
        return self._frame_batch("ref" if "ref" in sample else "ref_l", sample)

    def _warmup(self, sample: dict):
        """Yields the read-ahead frames of a video's frame 0: frames 1, 2,
        ... clamped to the video's last."""
        v = self.model.v
        for i in range(1, v.all_frame_interval - v.key_frame_location):
            yield self._load_extra_frame(sample["pattern"], min(i, sample["seg_len"] - 1))

    @torch.inference_mode()
    def step(self, sample: dict):
        """One preprocessed sample → Detections (batch of 1) on the device."""
        m = self.model
        cur, sizes = self._frame_batch("cur", sample)
        if self.method == "base":
            return m.forward_test(cur, sizes)

        if self.method == "dff":
            if sample["is_key_frame"] or self.carry is None:
                self.carry = m.make_key(cur, sizes)
            return m.detect_non_key(self.carry, cur, sizes)

        if self.method in ("fgfa", "rdn"):
            if sample["frame_category"] == 0:
                self.carry = m.init_carry(m.precompute(cur, sizes), sizes)
                dets = None
                for nxt, nsizes in self._warmup(sample):
                    self.carry, dets = m.test_step(self.carry, nxt, nsizes)
                return m.detect_key(self.carry) if dets is None else dets
            nxt, nsizes = self._next_frame(sample)
            self.carry, dets = m.test_step(self.carry, nxt, nsizes)
            return dets

        if self.method == "mega":
            if sample["frame_category"] == 0:
                self.carry = m.init_carry(m.precompute(cur, sizes), sizes)
                for nxt, nsizes in self._warmup(sample):
                    self.carry = m.push_carry(self.carry, m.precompute(nxt, nsizes), nsizes)
            else:
                nxt, nsizes = self._next_frame(sample)
                self.carry = m.push_carry(self.carry, m.precompute(nxt, nsizes), nsizes)
            # global updates: global_size on frame 0, one on every later frame
            ref_g = sample.get("ref_g")
            for i in range(0 if ref_g is None else len(ref_g)):
                g, gsizes = self._batch(ref_g[i:i + 1], sample["ref_g_size"][i:i + 1])
                self.carry = m.update_global(self.carry, g, gsizes)
            self.carry, dets = m.detect_key(self.carry)
            return dets

        raise ValueError(self.method)


STREAMING_METHODS = ("mega", "rdn", "fgfa", "dff")


def compute_on_dataset(model, dataset, indices, preprocessor, method: str,
                       logger=None, log_period: int = 100, lanes: int = 1) -> dict:
    """Inference over ``indices`` (whole videos, ascending) → {dataset_idx:
    prediction dict in original image coordinates}.

    ``lanes`` > 1 for a streaming method runs the lockstep engine (the
    configuration its benchmarks measure); anything else, the base method
    included, runs the serial ``StreamingInferencer``."""
    from .batched_inference import _to_host, compute_on_dataset_lockstep

    model_method = model.v.method if hasattr(model, "v") else "base"
    if method != model_method:
        raise ValueError(f"method {method!r} but the model is {model_method!r}")
    if lanes > 1 and method in STREAMING_METHODS:
        return compute_on_dataset_lockstep(model, dataset, indices, preprocessor,
                                           lanes=lanes, logger=logger,
                                           log_period=log_period)
    runner = StreamingInferencer(model, method, preprocessor, dataset)
    results: dict = {}
    total = 0.0
    for n, idx in enumerate(indices):
        sample = preprocessor(dataset[idx])
        t0 = time.perf_counter()
        dets = _to_host(runner.step(sample))  # the copy waits for the device
        info = dataset.get_img_info(idx)
        results[idx] = _extract(dets, sample["cur_size"][0], (info["height"], info["width"]))
        total += time.perf_counter() - t0
        if logger and (n + 1) % log_period == 0:
            logger.info(f"inference {n + 1}/{len(indices)} ({total / (n + 1):.3f} s/img)")
    return results


def evaluate_predictions(dataset, predictions: dict, motion_iou_path: str | None = None,
                         logger=None, box_only: bool = False) -> dict:
    """VID AP50 (+ motion buckets), COCO/Cityscapes COCO-protocol AP, VOC 07
    mAP, or class-agnostic proposal recall (box_only), by dataset family."""
    from ..data.evaluation import evaluate

    return evaluate(dataset, predictions, box_only=box_only,
                    motion_iou_path=motion_iou_path, logger=logger)
