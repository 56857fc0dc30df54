"""Streaming MEGA inference, one video lane (counterpart of the per-lane step
``one_lane`` in ``mega_pytorch_tpu/engine/batched_inference.py``).

Each ``serve_step``:
  1. stacks the local and the global uint8 frame and normalizes them;
  2. runs ``precompute_pair`` (one backbone pass over both);
  3. resets the carry from the local frame (video start) or pushes it;
  4. applies the global frame to the global cache if this step has one;
  5. runs ``detect_key`` and keeps its carry (the memory pushes) only on an
     emitted frame.
``run_video`` schedules reset, global updates and emission over one video
the way the lockstep engine schedules one lane.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np
import torch

from ..data.transforms import normalize_u8_frames, s2d_pack_frames


class StepOutput(NamedTuple):
    carry: object  # MEGACarry
    dets: object  # Detections, batch of 1
    emitted: bool


@torch.inference_mode()
def serve_step(model, carry, frame, size, gframe, gsize, reset: bool,
               gmask: bool, emit: bool) -> StepOutput:
    """One lane step. frame/gframe (H, W, C) uint8 tensors on the model's
    device (C = 48 for s2d(4)-packed frames), size/gsize (2,) f32 [h, w]."""
    sizes = torch.stack([size, gsize]).float()
    both = normalize_u8_frames(torch.stack([frame, gframe]), sizes)
    entry, g_pooled, g_valid = model.precompute_pair(both, sizes)
    if reset or carry is None:
        carry = model.init_carry(entry, sizes[0])
    else:
        carry = model.push_carry(carry, entry, sizes[0])
    if gmask:
        carry = model.apply_global(carry, g_pooled, g_valid)
    new_carry, dets = model.detect_key(carry)
    if emit:
        carry = new_carry
    return StepOutput(carry, dets, emit)


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
