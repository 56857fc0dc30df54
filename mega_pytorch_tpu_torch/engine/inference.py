"""Streaming MEGA inference (counterpart of ``mega_pytorch_tpu/engine/inference.py``).

``serve_step`` is one lane's step: the one-lane case of the lockstep step
(``batched_inference.make_lockstep_step``), so a single stream and L lockstep
lanes run one per-frame code path. Each step
  1. stacks the local and the global uint8 frame and normalizes them;
  2. runs ``precompute_pair`` (one backbone pass over both);
  3. resets the carry from the local frame (video start) or pushes it;
  4. applies the global frame to the global cache if this step has one;
  5. runs ``detect_key`` and keeps its carry (the memory pushes) only on an
     emitted frame.
``run_video`` schedules reset, global updates and emission over one video
the way the lockstep engine schedules one lane. ``compute_on_dataset`` runs
whole videos of a dataset through the lockstep engine.
"""

from __future__ import annotations

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
    the model's device (C = 48 for s2d(4)-packed frames), size/gsize (2,)
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
    pack = {48: 4, 3: 1}[frames.shape[-1]]  # s2d(4)-packed or plain RGB
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


def compute_on_dataset(model, dataset, indices, preprocessor, method: str,
                       logger=None, log_period: int = 100, lanes: int = 1) -> dict:
    """Streaming inference over ``indices`` (whole videos, ascending) →
    {dataset_idx: prediction dict in original image coordinates}.

    MEGA runs through the lockstep engine with ``lanes`` lanes; one lane is
    the serial protocol (its detections equal the JAX serial engine's, which
    the JAX package's lockstep-versus-serial tests pin). The serial
    ``StreamingInferencer`` and the other methods are not ported yet
    (ROADMAP.md, Queue 1)."""
    if method != "mega":
        raise NotImplementedError(
            f"streaming {method!r} is not ported yet (ROADMAP.md, Queue 1)")
    from .batched_inference import compute_on_dataset_lockstep

    return compute_on_dataset_lockstep(model, dataset, indices, preprocessor,
                                       lanes=lanes, logger=logger,
                                       log_period=log_period)
