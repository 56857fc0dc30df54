"""Lockstep multi-lane streaming for every streaming method (counterpart
of ``mega_pytorch_tpu/engine/batched_inference.py``).

L independent videos advance in lockstep through ONE per-step function over
stacked lane state — the configuration the JAX package's benches measure
(12 lanes for MEGA, 4 for the other methods) and its offline evaluation
runs. Every step, each lane (a) precomputes its incoming local frame and
either resets its carry from it (video start) or pushes it into the window;
(b) for MEGA, optionally applies one global-cache update; (c) detects at the
key slot, MEGA keeping the long-range memory pushes only on an emitted
frame. Reset, global update and emit are data: both alternatives are
computed and ``torch.where`` picks one per lane, so lanes never leave
lockstep and the step reads no lane mask on the host. A video of n frames
takes n + (window - 1 - key) steps; the warm-up steps' detections are
discarded, and MEGA's initial global updates are spread one per step over
the warm-up.

RDN and FGFA run MEGA's window protocol without the global cache or the
memory (``make_lockstep_step_windowed``). DFF runs the backbone only on key
frames, so its lanes are phase-aligned instead: each video starts on a
multiple of the key interval in its lane, every lane meets key frames on
the same engine step, and the engine alternates a key step (backbone, flow,
heads) and a non-key step (flow, heads) by a host counter.

Host IO runs ahead of the device: a producer thread assembles each step's
lane batch (decode, resize and canvas through the preprocessor, s2d(4) or
s2d(2) packing for MEGA and RDN, ``pack_factor``) with a thread pool into a
bounded queue, in pinned memory that the step copies to the card with
``non_blocking=True``. The
dataset is one of ``data/datasets/vid.py`` and the preprocessor
``data/loader.EvalPreprocessor``; the engine reads ``pattern``,
``frame_seg_len``, ``load_frame``, ``global_ref_ids`` (MEGA),
``key_interval`` (DFF, default 10), ``get_img_info``, ``image_set_index``
and ``_prep_u8``, so an in-memory stand-in with those serves too.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np
import torch

from ..data.transforms import normalize_u8_frames, s2d_pack_frames
from ..models.roi_heads.inference import Detections
from .inference import _extract


def _select(flags: torch.Tensor, a, b):
    """Per lane, ``a`` where ``flags`` (L,) is set, else ``b``, over carries
    (NamedTuples whose fields are tensors or tuples of tensors). A field that
    is the same tensor on both sides is kept as it is."""
    if isinstance(a, tuple):
        out = [_select(flags, x, y) for x, y in zip(a, b)]
        return a._make(out) if hasattr(a, "_make") else tuple(out)
    if a is b:
        return a
    return torch.where(flags.view(-1, *([1] * (a.dim() - 1))), a, b)


def make_lockstep_step(model) -> Callable:
    """One step over stacked lane state.

    step(carries, frames, sizes, gframes, gsizes, resets, gmasks, emits)
      → (carries, Detections)   [every leading dim = lanes]

    frames/gframes (L, H, W, C) uint8 (C = 48 / 12 for s2d(4) / s2d(2)
    canvases), sizes/gsizes (L, 2) f32 [h, w] in canvas pixels, resets/gmasks/emits (L,)
    bool, all on the model's device."""

    @torch.inference_mode()
    def step(carries, frames, sizes, gframes, gsizes, resets, gmasks, emits):
        # local and global frames are stacked before normalization, so the
        # pair reaches the one backbone pass without a copy
        both_sizes = torch.stack([sizes, gsizes], 1).float()  # (L, 2, 2)
        both = normalize_u8_frames(torch.stack([frames, gframes], 1), both_sizes)
        entry, g_pooled, g_valid = model.precompute_pair(both, both_sizes)
        cur = both_sizes[:, 0]
        carry = _select(resets, model.init_carry(entry, cur),
                        model.push_carry(carries, entry, cur))
        carry = _select(gmasks, model.apply_global(carry, g_pooled, g_valid), carry)
        new_carry, dets = model.detect_key(carry)
        # detect_key pushes the long-range memory; only an emitted frame
        # (not a warm-up step) keeps those pushes, as in the serial engine
        return _select(emits, new_carry, carry), dets

    return step


def make_lockstep_step_windowed(model) -> Callable:
    """RDN and FGFA: the window protocol with no global cache, and a
    detect_key without carry side effects, so no emit select.

    step(carries, frames, sizes, resets) → (carries, Detections)

    frames (L, H, W, C) uint8 (C = 48 / 12 for s2d(4) / s2d(2) canvases),
    sizes (L, 2), resets (L,) bool. ``carries`` None: every lane resets (the first
    step, where every lane starts a video)."""

    @torch.inference_mode()
    def step(carries, frames, sizes, resets):
        sizes = sizes.float()
        entry = model.precompute(normalize_u8_frames(frames, sizes), sizes)
        carry = model.init_carry(entry, sizes)
        if carries is not None:
            carry = _select(resets, carry, model.push_carry(carries, entry, sizes))
        return carry, model.detect_key(carry)

    return step


def make_lockstep_steps_dff(model) -> tuple[Callable, Callable]:
    """DFF's phase-aligned pair of steps, (key_step, nonkey_step):

    step(carries, frames, sizes) → (carries, Detections)

    The key step makes every lane's key from its frame and detects on it;
    the non-key step warps the lanes' keys to their frames. Plain RGB frames
    (L, H, W, 3) uint8, sizes (L, 2). The key step ignores ``carries`` (None
    on the first step)."""

    @torch.inference_mode()
    def key_step(carries, frames, sizes):
        sizes = sizes.float()
        images = normalize_u8_frames(frames, sizes)
        carry = model.make_key(images, sizes)
        return carry, model.detect_key(carry, images, sizes)

    @torch.inference_mode()
    def nonkey_step(carries, frames, sizes):
        sizes = sizes.float()
        images = normalize_u8_frames(frames, sizes)
        return carries, model.detect_non_key(carries, images, sizes)

    return key_step, nonkey_step


class _LaneFeed:
    """Per-engine-step host items for one lane over its queue of videos.

    Yields dicts: frame (H, W, C) canvas, size (2,), gframe, gsize,
    reset (bool), gmask (bool), emit (dataset idx or None), orig_hw."""

    def __init__(self, dataset, preprocessor, videos: list[list[int]],
                 warmup: int, use_global: bool = True, pack: int = 0):
        self.dataset = dataset
        self.prep = preprocessor
        self.videos = videos
        self.warmup = warmup
        self.use_global = use_global  # MEGA's global cache; RDN, FGFA have none
        self.pack = pack  # host-side s2d factor (0 = unpacked, 2 or 4)

    def _frame(self, pattern, fid):
        p = self.prep._prep_u8(self.dataset.load_frame(pattern, fid), flip=False)
        if self.pack:
            return s2d_pack_frames(p.image, self.pack), p.size
        return p.image, p.size

    def _globals(self, idx) -> list:
        return list(self.dataset.global_ref_ids(idx)) if self.use_global else []

    def __iter__(self) -> Iterator[dict]:
        last = None
        for idxs in self.videos:
            n = len(idxs)
            pattern = self.dataset.pattern[idxs[0]]
            seg_len = self.dataset.frame_seg_len[idxs[0]]
            init_globals = self._globals(idxs[0])
            if len(init_globals) > self.warmup + 1:
                raise ValueError("global_size must fit in the warm-up window "
                                 "for lockstep evaluation")
            for s in range(self.warmup + n):
                frame, size = self._frame(pattern, min(s, seg_len - 1))
                j = s - self.warmup
                if s < len(init_globals):
                    gid = init_globals[s]
                elif j >= 1:
                    gids = self._globals(idxs[j])
                    gid = gids[0] if gids else None
                else:
                    gid = None
                if gid is not None:
                    gframe, gsize = self._frame(pattern, gid)
                else:
                    gframe, gsize = frame, size  # ignored (gmask False)
                emit = idxs[j] if j >= 0 else None
                orig = None
                if emit is not None:
                    info = self.dataset.get_img_info(emit)
                    orig = (info["height"], info["width"])
                last = dict(frame=frame, size=size, gframe=gframe, gsize=gsize,
                            reset=s == 0, gmask=gid is not None, emit=emit,
                            orig_hw=orig)
                yield last
        # idle tail: repeat the last frame with no resets, updates or emissions
        while last is not None:
            yield dict(frame=last["frame"], size=last["size"], gframe=last["frame"],
                       gsize=last["size"], reset=False, gmask=False, emit=None,
                       orig_hw=None)


class _DFFLaneFeed:
    """Per-step host items for one DFF lane: each video starts on a multiple
    of the key interval in its lane (idle items pad the gap), so every lane
    meets key frames on the same engine step. Idle items repeat the previous
    frame and emit nothing (a key made from a stale frame is harmless: the
    next video's first frame is itself a key).

    Yields dicts: frame (H, W, 3) canvas, size (2,), emit (dataset idx or
    None), orig_hw."""

    def __init__(self, dataset, preprocessor, videos: list[list[int]],
                 key_interval: int):
        self.dataset = dataset
        self.prep = preprocessor
        self.videos = videos
        self.key_interval = key_interval

    def __iter__(self) -> Iterator[dict]:
        steps = 0
        last = None

        def idle():
            return dict(frame=last["frame"], size=last["size"], emit=None, orig_hw=None)

        for idxs in self.videos:
            pattern = self.dataset.pattern[idxs[0]]
            if last is not None:
                for _ in range((-steps) % self.key_interval):
                    steps += 1
                    yield idle()
            for j, idx in enumerate(idxs):
                p = self.prep._prep_u8(self.dataset.load_frame(pattern, j), flip=False)
                info = self.dataset.get_img_info(idx)
                last = dict(frame=p.image, size=p.size, emit=idx,
                            orig_hw=(info["height"], info["width"]))
                steps += 1
                yield last
        while last is not None:
            yield idle()


def _partition(videos: list[list[int]], lanes: int, warmup: int):
    """Greedy longest-first balance of per-lane total steps."""
    order = sorted(videos, key=len, reverse=True)
    bins: list[list[list[int]]] = [[] for _ in range(lanes)]
    loads = [0] * lanes
    for v in order:
        i = int(np.argmin(loads))
        bins[i].append(v)
        loads[i] += len(v) + warmup
    return [b for b in bins if b], max(loads) if loads else 0


def _partition_dff(videos: list[list[int]], lanes: int, key_interval: int):
    """Greedy longest-first balance of per-lane steps, the alignment padding
    included."""
    order = sorted(videos, key=len, reverse=True)
    bins: list[list[list[int]]] = [[] for _ in range(lanes)]
    loads = [0] * lanes
    for v in order:
        i = int(np.argmin(loads))
        pad = (-loads[i]) % key_interval if bins[i] else 0
        bins[i].append(v)
        loads[i] += pad + len(v)
    return [b for b in bins if b], max(loads) if loads else 0


def pack_factor(method: str, canvas_shape) -> int:
    """The host-side s2d factor of a canvas (H, W, ...), as the JAX engine
    picks it: MEGA and RDN pack s2d(4) when both sides are multiples of 4
    (the stem's 3x3 reformulation and the stem pool kernel), else s2d(2)
    when both are even (the stem's 4x4 reformulation), else nothing; FGFA's
    carry and DFF's flow net read plain frames (0)."""
    h, w = canvas_shape[0], canvas_shape[1]
    if method not in ("mega", "rdn"):
        return 0
    if h % 4 == 0 and w % 4 == 0:
        return 4
    return 2 if h % 2 == 0 and w % 2 == 0 else 0


def split_videos(dataset, indices) -> list[list[int]]:
    """Ascending ``indices`` (whole videos) → per-video index lists."""
    videos: list[list[int]] = []
    for i in indices:
        frame_id = int(dataset.image_set_index[i].split("/")[-1])
        if frame_id == 0 or not videos:
            videos.append([])
        videos[-1].append(i)
    return videos


def _to_host(dets: Detections) -> Detections:
    """One device→host copy of a step's detections, split into numpy."""
    packed = torch.cat([dets.boxes, dets.scores[..., None],
                        dets.labels[..., None].float(),
                        dets.valid[..., None].float()], -1).cpu().numpy()
    return Detections(packed[..., :4], packed[..., 4],
                      packed[..., 5].astype(np.int32), packed[..., 6] > 0.5)


# host item key → batch key, for the items each method's step reads
_FEED_KEYS = {
    "mega": ("frame", "size", "gframe", "gsize", "reset", "gmask"),
    "rdn": ("frame", "size", "reset"),
    "fgfa": ("frame", "size", "reset"),
    "dff": ("frame", "size"),
}


def compute_on_dataset_lockstep(model, dataset, indices, preprocessor,
                                lanes: int = 4, logger=None, log_period: int = 50,
                                prefetch_depth: int = 8, stats: dict | None = None) -> dict:
    """Lockstep multi-lane streaming over whole videos → {idx: prediction}
    in original image coordinates. Dispatches on ``model.v.method``: mega
    (window, memory and global cache), rdn and fgfa (window only), dff
    (phase-aligned key and non-key steps).

    ``stats``, where given, receives the host feed's timing: ``feed_s``, the
    producer's seconds per lane batch (decode, preprocess, pack, pin), and
    ``wait_s``, the seconds each step waited on the queue for its batch."""
    method = model.v.method
    if method not in _FEED_KEYS:
        raise NotImplementedError(f"lockstep {method!r} is not ported")
    dev = next(model.parameters()).device
    warmup = model.v.all_frame_interval - model.v.key_frame_location - 1
    key_int = int(getattr(dataset, "key_interval", 10))
    videos = split_videos(dataset, indices)

    # lanes must stack: group videos by canvas shape (portrait, landscape)
    groups: dict = {}
    for vid in videos:
        img = dataset.load_frame(dataset.pattern[vid[0]], 0)
        p = preprocessor._prep_u8(img, flip=False)
        groups.setdefault(p.image.shape, []).append(vid)

    if method == "dff":
        key_step, nonkey_step = make_lockstep_steps_dff(model)
    else:
        step = (make_lockstep_step if method == "mega"
                else make_lockstep_step_windowed)(model)
    keys = _FEED_KEYS[method]
    if stats is None:
        stats = {}
    stats.update(feed_s=[], wait_s=[])
    results: dict = {}
    t0 = time.time()
    done = 0
    for canvas_shape, group in groups.items():
        if method == "dff":
            bins, max_steps = _partition_dff(group, lanes, key_int)
            feeds = [iter(_DFFLaneFeed(dataset, preprocessor, b, key_int)) for b in bins]
        else:
            bins, max_steps = _partition(group, lanes, warmup)
            feeds = [iter(_LaneFeed(dataset, preprocessor, b, warmup, method == "mega",
                                    pack_factor(method, canvas_shape))) for b in bins]
        batches: queue.Queue = queue.Queue(maxsize=prefetch_depth)
        stop = threading.Event()
        with ThreadPoolExecutor(max_workers=min(16, 2 * len(bins))) as pool:
            producer = threading.Thread(
                target=_produce,
                args=(pool, feeds, keys, max_steps, dev, batches, stop, stats["feed_s"]),
                daemon=True)
            producer.start()
            try:
                # every lane resets (or makes a key) on its first step
                carries = model.zero_carry(len(bins), dev) if method == "mega" else None
                s = 0
                while True:
                    t_wait = time.perf_counter()
                    batch = batches.get()
                    stats["wait_s"].append(time.perf_counter() - t_wait)
                    if batch is None:
                        break
                    if isinstance(batch, BaseException):
                        raise batch
                    inputs = [batch[k + "s"].to(dev, non_blocking=True) for k in keys]
                    if method == "dff":
                        fn = key_step if s % key_int == 0 else nonkey_step
                        carries, dets = fn(carries, *inputs)
                    elif method == "mega":
                        carries, dets = step(carries, *inputs,
                                             batch["emit_mask"].to(dev, non_blocking=True))
                    else:
                        carries, dets = step(carries, *inputs)
                    s += 1
                    emits = batch["emits"]
                    if all(e is None for e in emits):
                        continue
                    host = _to_host(dets)
                    for lane, (e, orig) in enumerate(zip(emits, batch["origs"])):
                        if e is None:
                            continue
                        lane_dets = Detections(*(x[lane:lane + 1] for x in host))
                        results[e] = _extract(lane_dets, batch["sizes"][lane].numpy(),
                                              orig)
                        done += 1
                        if logger and done % log_period == 0:
                            logger.info(f"lockstep {method} inference {done}/"
                                        f"{len(indices)} ({done / (time.time() - t0):.1f} "
                                        f"fps)")
            finally:
                stop.set()
                while producer.is_alive():  # unblock a producer on a full queue
                    try:
                        batches.get(timeout=0.1)
                    except queue.Empty:
                        pass
                producer.join()
    return results


def _produce(pool, feeds, keys, steps: int, dev, batches: queue.Queue,
             stop: threading.Event, feed_s: list) -> None:
    """Producer thread: ``steps`` lane batches, then None; an exception is
    put on the queue for the consumer to raise. Each batch stacks the lanes'
    items under ``keys`` (item "frame" as batch "frames", ...); the seconds
    each batch took are appended to ``feed_s``. Returns early once ``stop``
    is set (the consumer stopped)."""
    pin = dev.type == "cuda"

    def host(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory() if pin else t

    try:
        for _ in range(steps):
            if stop.is_set():
                return
            t0 = time.perf_counter()
            items = list(pool.map(next, feeds))
            batch = {k + "s": host(np.stack([it[k] for it in items])) for k in keys}
            batch.update(
                emit_mask=host(np.array([it["emit"] is not None for it in items])),
                emits=[it["emit"] for it in items],
                origs=[it["orig_hw"] for it in items],
            )
            feed_s.append(time.perf_counter() - t0)
            batches.put(batch)
        batches.put(None)
    except Exception as exc:  # handed to the consumer, which raises it
        batches.put(exc)
