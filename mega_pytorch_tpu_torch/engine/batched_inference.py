"""Lockstep multi-lane MEGA streaming (counterpart of
``mega_pytorch_tpu/engine/batched_inference.py``, MEGA branch).

L independent videos advance in lockstep through ONE per-step function over
stacked lane state — the configuration the JAX package's bench measures
(12 lanes) and its offline evaluation runs. Every step, each lane (a)
precomputes its incoming local frame and either resets its carry from it
(video start) or pushes it into the window; (b) optionally applies one
global-cache update; (c) detects at the key slot, keeping the long-range
memory pushes only on an emitted frame. Reset, global update and emit are
data: both alternatives are computed and ``torch.where`` picks one per lane,
so lanes never leave lockstep and the step reads no lane mask on the host.
A video of n frames takes n + (window - 1 - key) steps; the warm-up steps'
detections are discarded, and the video's initial global updates are spread
one per step over the warm-up.

Host IO runs ahead of the device: a producer thread assembles each step's
lane batch (decode, resize and canvas through the preprocessor, s2d(4)
packing) with a thread pool into a bounded queue, in pinned memory that the
step copies to the card with ``non_blocking=True``. The dataset and the
preprocessor are duck-typed as in the JAX engine: ``pattern``,
``frame_seg_len``, ``load_frame``, ``global_ref_ids``, ``get_img_info``,
``image_set_index`` and ``_prep_u8``. Methods rdn, fgfa and dff are not
ported (ROADMAP.md, Queue 1).
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

    frames/gframes (L, H, W, C) uint8 (C = 48 for s2d(4)-packed canvases),
    sizes/gsizes (L, 2) f32 [h, w] in canvas pixels, resets/gmasks/emits (L,)
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


class _LaneFeed:
    """Per-engine-step host items for one lane over its queue of videos.

    Yields dicts: frame (H, W, C) canvas, size (2,), gframe, gsize,
    reset (bool), gmask (bool), emit (dataset idx or None), orig_hw."""

    def __init__(self, dataset, preprocessor, videos: list[list[int]],
                 warmup: int, pack: int = 0):
        self.dataset = dataset
        self.prep = preprocessor
        self.videos = videos
        self.warmup = warmup
        self.pack = pack  # host-side s2d factor (0 = unpacked, or 4)

    def _frame(self, pattern, fid):
        p = self.prep._prep_u8(self.dataset.load_frame(pattern, fid), flip=False)
        if self.pack:
            return s2d_pack_frames(p.image, self.pack), p.size
        return p.image, p.size

    def __iter__(self) -> Iterator[dict]:
        last = None
        for idxs in self.videos:
            n = len(idxs)
            pattern = self.dataset.pattern[idxs[0]]
            seg_len = self.dataset.frame_seg_len[idxs[0]]
            init_globals = list(self.dataset.global_ref_ids(idxs[0]))
            if len(init_globals) > self.warmup + 1:
                raise ValueError("global_size must fit in the warm-up window "
                                 "for lockstep evaluation")
            for s in range(self.warmup + n):
                frame, size = self._frame(pattern, min(s, seg_len - 1))
                j = s - self.warmup
                if s < len(init_globals):
                    gid = init_globals[s]
                elif j >= 1:
                    gids = list(self.dataset.global_ref_ids(idxs[j]))
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


def compute_on_dataset_lockstep(model, dataset, indices, preprocessor,
                                lanes: int = 4, logger=None, log_period: int = 50,
                                prefetch_depth: int = 8) -> dict:
    """Lockstep multi-lane streaming over whole videos → {idx: prediction}
    in original image coordinates. MEGA only."""
    v = model.v
    if v.method != "mega":
        raise NotImplementedError(
            f"lockstep {v.method!r} is not ported yet (ROADMAP.md, Queue 1)")
    dev = next(model.parameters()).device
    warmup = v.all_frame_interval - v.key_frame_location - 1
    videos = split_videos(dataset, indices)

    # lanes must stack: group videos by canvas shape (portrait, landscape)
    groups: dict = {}
    for vid in videos:
        img = dataset.load_frame(dataset.pattern[vid[0]], 0)
        p = preprocessor._prep_u8(img, flip=False)
        groups.setdefault(p.image.shape, []).append(vid)

    step = make_lockstep_step(model)
    results: dict = {}
    t0 = time.time()
    done = 0
    for canvas_shape, group in groups.items():
        bins, max_steps = _partition(group, lanes, warmup)
        # host-side s2d(4) packing: the stem runs its exact 3x3 reformulation
        # and the stem pool kernel; other canvases go unpacked
        pack = 4 if canvas_shape[0] % 4 == 0 and canvas_shape[1] % 4 == 0 else 0
        feeds = [iter(_LaneFeed(dataset, preprocessor, b, warmup, pack)) for b in bins]
        batches: queue.Queue = queue.Queue(maxsize=prefetch_depth)
        stop = threading.Event()
        with ThreadPoolExecutor(max_workers=min(16, 2 * len(bins))) as pool:
            producer = threading.Thread(
                target=_produce, args=(pool, feeds, max_steps, dev, batches, stop),
                daemon=True)
            producer.start()
            try:
                carries = model.zero_carry(len(bins), dev)  # every lane resets first
                while (batch := batches.get()) is not None:
                    if isinstance(batch, BaseException):
                        raise batch
                    on_dev = {k: batch[k].to(dev, non_blocking=True) for k in (
                        "frames", "sizes", "gframes", "gsizes", "resets", "gmasks",
                        "emit_mask")}
                    carries, dets = step(carries, on_dev["frames"], on_dev["sizes"],
                                         on_dev["gframes"], on_dev["gsizes"],
                                         on_dev["resets"], on_dev["gmasks"],
                                         on_dev["emit_mask"])
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
                            logger.info(f"lockstep inference {done}/{len(indices)} "
                                        f"({done / (time.time() - t0):.1f} fps)")
            finally:
                stop.set()
                while producer.is_alive():  # unblock a producer on a full queue
                    try:
                        batches.get(timeout=0.1)
                    except queue.Empty:
                        pass
                producer.join()
    return results


def _produce(pool, feeds, steps: int, dev, batches: queue.Queue,
             stop: threading.Event) -> None:
    """Producer thread: ``steps`` lane batches, then None; an exception is
    put on the queue for the consumer to raise. Returns early once ``stop``
    is set (the consumer stopped)."""
    pin = dev.type == "cuda"

    def host(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory() if pin else t

    try:
        for _ in range(steps):
            if stop.is_set():
                return
            items = list(pool.map(next, feeds))
            batches.put(dict(
                frames=host(np.stack([it["frame"] for it in items])),
                sizes=host(np.stack([it["size"] for it in items])),
                gframes=host(np.stack([it["gframe"] for it in items])),
                gsizes=host(np.stack([it["gsize"] for it in items])),
                resets=host(np.array([it["reset"] for it in items])),
                gmasks=host(np.array([it["gmask"] for it in items])),
                emit_mask=host(np.array([it["emit"] is not None for it in items])),
                emits=[it["emit"] for it in items],
                origs=[it["orig_hw"] for it in items],
            ))
        batches.put(None)
    except Exception as exc:  # handed to the consumer, which raises it
        batches.put(exc)
