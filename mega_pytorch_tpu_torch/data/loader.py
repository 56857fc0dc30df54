"""Sample preprocessing, threaded prefetch and training batches (counterpart
of ``mega_pytorch_tpu/data/loader.py``).

A dataset sample (uint8 frames + raw annotations) becomes fixed-shape numpy
arrays: every frame lands on its orientation canvas and ground truth is
padded to ``max_gt``; reference frames share the current frame's flip (the
reference's stateful-flip contract).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from ..models.detectors.rcnn import pad_gt
from ..utils.profiler import annotate
from .transforms import preprocess_image, preprocess_image_u8, transform_boxes


class TrainPreprocessor:
    """``rng`` (required) draws each sample's flip, as the training datasets
    need theirs for the references: a run's draws follow its seed."""

    def __init__(self, min_size: int = 600, max_size: int = 1000,
                 canvas_short: int = 608, canvas_long: int = 1024, max_gt: int = 32,
                 hflip_prob: float = 0.5, rng: np.random.RandomState | None = None):
        if rng is None:
            raise ValueError("the preprocessor draws its flips from rng: pass one")
        self.min_size, self.max_size = min_size, max_size
        self.canvas_short, self.canvas_long = canvas_short, canvas_long
        self.max_gt = max_gt
        self.hflip_prob = hflip_prob
        self.rng = rng

    def _prep(self, img, flip):
        """The f32 canvas (the serial engine's input)."""
        return preprocess_image(img, self.min_size, self.max_size, flip,
                                self.canvas_short, self.canvas_long)

    def _prep_u8(self, img, flip):
        """The uint8 canvas (the lockstep engine's input); ``normalize_u8_frames``
        on the device makes it the f32 canvas bit for bit."""
        return preprocess_image_u8(img, self.min_size, self.max_size, flip,
                                   self.canvas_short, self.canvas_long)

    def __call__(self, sample: dict) -> dict:
        """One dataset sample → arrays. Frame groups keyed like the sample
        ('cur' + any of 'ref'/'ref_l'/'ref_m'/'ref_g'), plus 'gt' and 'sizes'."""
        flip = self.rng.rand() < self.hflip_prob
        cur = sample["cur"]
        h0, w0 = cur.shape[:2]
        out: dict = {}
        p = self._prep(cur, flip)
        out["cur"] = p.image[None]
        out["cur_size"] = p.size[None]
        oh, ow = int(p.size[0]), int(p.size[1])

        gt = sample["gt"]
        boxes = transform_boxes(gt["boxes"], h0, w0, oh, ow, flip)
        out["gt"] = {k: v[None] for k, v in pad_gt(boxes, gt["labels"], self.max_gt).items()}

        for key in ("ref", "ref_l", "ref_m", "ref_g"):
            if key in sample and sample[key]:
                ims, szs = [], []
                for im in sample[key]:
                    q = self._prep(im, flip)
                    ims.append(q.image)
                    szs.append(q.size)
                out[key] = np.stack(ims)
                out[key + "_size"] = np.stack(szs)
        return out


class EvalPreprocessor(TrainPreprocessor):
    def __init__(self, **kw):
        kw.setdefault("hflip_prob", 0.0)
        # a private rng: with no flip its draws decide nothing
        kw.setdefault("rng", np.random.RandomState(0))
        super().__init__(**kw)

    def __call__(self, sample: dict) -> dict:
        out = super().__call__(sample)
        for k in ("frame_category", "seg_len", "pattern", "frame_id", "is_key_frame", "idx"):
            if k in sample:
                out[k] = sample[k]
        return out


def eval_preprocessor(cfg) -> EvalPreprocessor:
    """The config's test-time preprocessing: INPUT's test sizes on the TPU
    section's canvas."""
    return EvalPreprocessor(min_size=cfg.INPUT.MIN_SIZE_TEST, max_size=cfg.INPUT.MAX_SIZE_TEST,
                            canvas_short=cfg.TPU.CANVAS_HEIGHT,
                            canvas_long=cfg.TPU.CANVAS_WIDTH, max_gt=cfg.TPU.MAX_GT_BOXES)


def prefetch(iterator: Iterator, depth: int = 4) -> Iterator:
    """Run ``iterator`` in a background thread with a bounded queue (keeps
    the host busy while the card runs a step). An exception in the thread is
    raised in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except Exception as exc:  # handed to the consumer, which raises it
            q.put(exc)
        finally:
            q.put(end)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, Exception):
            raise item
        yield item


def train_batches(dataset, preprocessor: TrainPreprocessor, index_batches: Iterator,
                  prefetch_depth: int = 4) -> Iterator[list[dict]]:
    """Lists of preprocessed samples, one per index of each batch, made in a
    background thread, each batch's reading and preprocessing inside a
    ``feed`` span (``utils/profiler.py``)."""
    def gen():
        for idxs in index_batches:
            with annotate("feed", device=False):
                batch = [preprocessor(dataset[i]) for i in idxs]
            yield batch

    return prefetch(gen(), prefetch_depth)
