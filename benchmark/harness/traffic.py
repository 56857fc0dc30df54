"""Lockstep lane traffic drawn from the seed (the lane feed of the port's
``engine/batched_inference.py`` and ``engine/inference.py:video_schedule``,
copied so that the yardstick stays put).

Each lane plays synthetic videos back to back: lengths uniform in the
traffic's ``video_frames`` range, frame f of a video is frame
(offset + f) % pool of the pool of drawn canvases. A video of n frames
takes warmup + n steps (warmup = window - 1 - key slot); step s pushes
local frame min(s, n - 1), resets the lane at s = 0 and emits frame
s - warmup from s = warmup on. With globals (MEGA), the first
``global_size`` steps each apply one of the video's initial global frames,
and every emitting step after the first one more; global frames are drawn
uniformly from the video."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Video:
    start: int  # the lane step of its reset
    frames: int
    offset: int  # pool index of frame 0
    globals_: list = field(default_factory=list)  # global frame indices, schedule order

    def pool_index(self, frame: int, pool: int) -> int:
        return (self.offset + frame) % pool


@dataclass
class Lane:
    local: np.ndarray  # (steps,) pool index of the local frame
    gpool: np.ndarray  # (steps,) pool index of the global frame, -1 for none
    reset: np.ndarray  # (steps,) bool
    emit: np.ndarray  # (steps,) frame emitted, -1 for none
    video: np.ndarray  # (steps,) index into ``videos``
    videos: list


def video_schedule(frames: int, warmup: int, global_size: int, use_global: bool):
    """Per step of one video: (local frame, global slot or None, reset, emitted frame or None)."""
    steps, g = [], 0
    for s in range(warmup + frames):
        j = s - warmup
        gslot = None
        if use_global and (s < global_size or j >= 1):
            gslot, g = g, g + 1
        steps.append((min(s, frames - 1), gslot, s == 0, j if j >= 0 else None))
    return steps


def lane_rng(seed: int, lane: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 63, lane])


def make_lane(traffic: dict, seed: int, lane: int, steps: int, warmup: int,
              global_size: int) -> Lane:
    """Lane ``lane``'s first ``steps`` steps."""
    rng = lane_rng(seed, lane)
    lo, hi = traffic["video_frames"]
    pool = traffic["pool_frames"]
    use_global = global_size > 0
    cols = {k: [] for k in ("local", "gpool", "reset", "emit", "video")}
    videos = []
    while len(cols["local"]) < steps:
        n = int(rng.integers(lo, hi + 1))
        v = Video(start=len(cols["local"]), frames=n, offset=int(rng.integers(pool)))
        if use_global:
            v.globals_ = [int(x) for x in rng.integers(0, n, global_size + n - 1)]
        videos.append(v)
        for local, gslot, reset, emit in video_schedule(n, warmup, global_size, use_global):
            cols["local"].append(v.pool_index(local, pool))
            cols["gpool"].append(-1 if gslot is None else v.pool_index(v.globals_[gslot], pool))
            cols["reset"].append(reset)
            cols["emit"].append(-1 if emit is None else emit)
            cols["video"].append(len(videos) - 1)
    return Lane(local=np.array(cols["local"][:steps]), gpool=np.array(cols["gpool"][:steps]),
                reset=np.array(cols["reset"][:steps]), emit=np.array(cols["emit"][:steps]),
                video=np.array(cols["video"][:steps]), videos=videos)


def video_steps(video: Video, warmup: int, global_size: int):
    """The steps of ``video`` as frame indices: [(local, global frame or None,
    emitted frame or None)], for the reference."""
    out = []
    for local, gslot, _, emit in video_schedule(video.frames, warmup, global_size,
                                                global_size > 0):
        out.append((local, None if gslot is None else video.globals_[gslot], emit))
    return out
