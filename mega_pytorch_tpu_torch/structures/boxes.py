"""Fixed-shape box sets and geometry (counterpart of
``mega_pytorch_tpu/structures/boxes.py``): padded (..., N, 4) xyxy tensors
with a validity mask, and the Detectron +1 (inclusive-corner) convention."""

from __future__ import annotations

from typing import NamedTuple

import torch

TO_REMOVE = 1.0


class Boxes(NamedTuple):
    boxes: torch.Tensor  # (..., N, 4) xyxy
    valid: torch.Tensor  # (..., N) bool
    fields: dict  # per-box tensors with the same leading dims


def area(boxes: torch.Tensor) -> torch.Tensor:
    w = boxes[..., 2] - boxes[..., 0] + TO_REMOVE
    h = boxes[..., 3] - boxes[..., 1] + TO_REMOVE
    return w * h


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, 4) x (..., N, 4) → (..., M, N) IoU, intersection clamped at 0."""
    area_a = area(a)
    area_b = area(b)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt + TO_REMOVE).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp_min(1e-12)


def clip_to_image(boxes: torch.Tensor, height, width) -> torch.Tensor:
    """Clamp into the image; ``height``/``width`` are scalars or tensors that
    broadcast against boxes[..., 0]."""
    hmax = height - TO_REMOVE
    wmax = width - TO_REMOVE

    def clamp(x, hi):
        return torch.minimum(x.clamp_min(0), torch.as_tensor(hi, dtype=x.dtype,
                                                             device=x.device))

    return torch.stack(
        [clamp(boxes[..., 0], wmax), clamp(boxes[..., 1], hmax),
         clamp(boxes[..., 2], wmax), clamp(boxes[..., 3], hmax)], dim=-1
    )


def small_box_mask(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    ws = boxes[..., 2] - boxes[..., 0] + TO_REMOVE
    hs = boxes[..., 3] - boxes[..., 1] + TO_REMOVE
    return (ws >= min_size) & (hs >= min_size)
