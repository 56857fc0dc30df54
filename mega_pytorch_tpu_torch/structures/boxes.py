"""Fixed-shape box sets and geometry (counterpart of
``mega_pytorch_tpu/structures/boxes.py``): padded (..., N, 4) xyxy tensors
with a validity mask, and the Detectron +1 (inclusive-corner) convention.
``Boxes`` stays a ``NamedTuple``, so that ``torch.where`` selects and
unpacking take it apart; its field methods return new sets."""

from __future__ import annotations

from typing import NamedTuple

import torch

TO_REMOVE = 1.0


class Boxes(NamedTuple):
    boxes: torch.Tensor  # (..., N, 4) xyxy
    valid: torch.Tensor  # (..., N) bool
    fields: dict  # per-box tensors with the same leading dims

    @property
    def num_boxes(self) -> int:
        return self.boxes.shape[-2]

    def add_field(self, name: str, value: torch.Tensor) -> "Boxes":
        return self._replace(fields={**self.fields, name: value})

    def get_field(self, name: str) -> torch.Tensor:
        return self.fields[name]

    def has_field(self, name: str) -> bool:
        return name in self.fields

    def take(self, idx: torch.Tensor, idx_valid: torch.Tensor | None = None) -> "Boxes":
        """The boxes and every field at ``idx`` of an (N, ...) set; valid
        also where ``idx_valid`` is, if given."""
        valid = self.valid[idx]
        if idx_valid is not None:
            valid = valid & idx_valid
        return Boxes(self.boxes[idx], valid, {k: v[idx] for k, v in self.fields.items()})


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


def hflip_boxes(boxes: torch.Tensor, width) -> torch.Tensor:
    """Horizontal flip in an image ``width`` wide: x' = width - x_opposite - 1."""
    x1 = width - boxes[..., 2] - TO_REMOVE
    x2 = width - boxes[..., 0] - TO_REMOVE
    return torch.stack([x1, boxes[..., 1], x2, boxes[..., 3]], dim=-1)


def resize_boxes(boxes: torch.Tensor, scale_x, scale_y) -> torch.Tensor:
    """Coordinates scaled by ``scale_x`` and ``scale_y``: scalars, or
    tensors whose (..., 4) stack broadcasts against ``boxes``."""
    sx, sy = (torch.as_tensor(s, dtype=boxes.dtype, device=boxes.device)
              for s in (scale_x, scale_y))
    return boxes * torch.stack(torch.broadcast_tensors(sx, sy, sx, sy), dim=-1)


def xywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    x, y, w, h = boxes.unbind(-1)
    return torch.stack([x, y, x + (w - TO_REMOVE).clamp_min(0),
                        y + (h - TO_REMOVE).clamp_min(0)], dim=-1)


def xyxy_to_xywh(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1, y1, x2 - x1 + TO_REMOVE, y2 - y1 + TO_REMOVE], dim=-1)


def cat_boxes(box_list: list[Boxes], fields: list[str] | None = None) -> Boxes:
    """(N, ...) sets joined along N, with ``fields`` (by default those that
    every set has, in the first set's order)."""
    if fields is None:
        fields = [f for f in box_list[0].fields if all(f in b.fields for b in box_list[1:])]
    return Boxes(torch.cat([b.boxes for b in box_list]),
                 torch.cat([b.valid for b in box_list]),
                 {f: torch.cat([b.fields[f] for b in box_list]) for f in fields})
