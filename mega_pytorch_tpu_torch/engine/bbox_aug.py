"""Test-time augmentation for boxes: several scales and horizontal flips
(counterpart of ``mega_pytorch_tpu/engine/bbox_aug.py``).

The single-frame detector runs at the base test size and at each extra
scale, each optionally flipped; every run's detections map back to the
original image and the union goes through one class-aware NMS with the
global detections cap. Image methods only: the video methods never use it.
Each run's f32 canvas goes to the detector packed as
``batched_inference.pack_factor`` says for the base detector: s2d(4), since
its sides are multiples of 16, so the stem runs its exact 3x3/1
reformulation and, under frozen BN, the ``stem_pool_packed`` kernel; the
JAX package feeds the plain canvas to the 7x7/2 form, which computes the
same function.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.transforms import preprocess_image, resize_hw
from ..ops.nms import nms
from .batched_inference import _to_host, pack_frames


def _ceil16(v: int) -> int:
    return -(-v // 16) * 16


def im_detect_bbox_aug(model, image: np.ndarray, scales: tuple, max_size: int,
                       canvas_short: int, canvas_long: int, hflip: bool = True,
                       scale_hflip: bool | None = None, nms_thresh: float = 0.5,
                       detections_per_img: int = 300) -> dict:
    """uint8 RGB image (H, W, 3) → merged {boxes, scores, labels} in its own
    coordinates.

    ``model`` is the base detector (``forward_test(images, sizes)``).
    ``scales[0]`` is the base test size, whose flipped run follows
    ``hflip``; the other scales are the TEST.BBOX_AUG.SCALES sweep, whose
    flipped runs follow ``scale_hflip`` (``None``: ``hflip`` for every
    scale). Each run's canvas fits its resized image, rounded up to 16 and
    at least ``canvas_short`` x ``canvas_long`` in its orientation."""
    h0, w0 = image.shape[:2]
    device = next(model.parameters()).device
    all_boxes, all_scores, all_labels = [], [], []

    def run(min_size: int, flip: bool):
        oh, ow = resize_hw(h0, w0, min_size, max_size)
        cs = max(_ceil16(min(oh, ow)), canvas_short)
        cl = max(_ceil16(max(oh, ow)), canvas_long)
        p = preprocess_image(image, min_size, max_size, flip, cs, cl)
        frames = pack_frames("base", p.image[None])
        with torch.inference_mode():
            dets = _to_host(model.forward_test(torch.from_numpy(frames).to(device),
                                               torch.from_numpy(p.size[None]).to(device)))
        valid = dets.valid[0]
        boxes = dets.boxes[0][valid]
        oh, ow = float(p.size[0]), float(p.size[1])
        if flip:
            boxes = np.stack([ow - boxes[:, 2] - 1.0, boxes[:, 1],
                              ow - boxes[:, 0] - 1.0, boxes[:, 3]], axis=1)
        all_boxes.append(boxes * np.array([w0 / ow, h0 / oh, w0 / ow, h0 / oh], np.float32))
        all_scores.append(dets.scores[0][valid])
        all_labels.append(dets.labels[0][valid])

    for i, s in enumerate(scales):
        run(int(s), False)
        if hflip if (i == 0 or scale_hflip is None) else scale_hflip:
            run(int(s), True)

    boxes = np.concatenate(all_boxes, axis=0)
    scores = np.concatenate(all_scores, axis=0)
    labels = np.concatenate(all_labels, axis=0)
    if len(boxes) == 0:
        return {"boxes": boxes, "scores": scores, "labels": labels}
    # class-aware merge: an offset per class keeps the classes apart
    offset = labels.astype(np.float32)[:, None] * 1e5
    with torch.inference_mode():
        keep_idx, keep_valid = nms(
            torch.from_numpy(boxes + offset)[None].to(device),
            torch.from_numpy(scores)[None].to(device),
            torch.ones((1, len(boxes)), dtype=torch.bool, device=device),
            nms_thresh, min(detections_per_img, len(boxes)))
    keep = keep_idx[0].cpu().numpy()[keep_valid[0].cpu().numpy()]
    return {"boxes": boxes[keep], "scores": scores[keep], "labels": labels[keep]}
