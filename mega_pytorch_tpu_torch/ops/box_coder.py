"""Detectron box decoding (counterpart of ``mega_pytorch_tpu/ops/box_coder.py``):
+1 widths, per-coordinate weights, size deltas clipped at log(1000/16), and
the "-1" on decoded x2/y2. Inference only: ``encode`` is not ported."""

from __future__ import annotations

import math

import torch

BBOX_XFORM_CLIP = math.log(1000.0 / 16)


class BoxCoder:
    def __init__(self, weights, bbox_xform_clip: float = BBOX_XFORM_CLIP):
        self.weights = weights
        self.bbox_xform_clip = bbox_xform_clip

    def decode(self, rel_codes: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """rel_codes (..., N, 4K), boxes (..., N, 4) → (..., N, 4K) xyxy."""
        boxes = boxes.to(rel_codes.dtype)
        widths = boxes[..., 2] - boxes[..., 0] + 1.0
        heights = boxes[..., 3] - boxes[..., 1] + 1.0
        ctr_x = boxes[..., 0] + 0.5 * widths
        ctr_y = boxes[..., 1] + 0.5 * heights

        wx, wy, ww, wh = self.weights
        dx = rel_codes[..., 0::4] / wx
        dy = rel_codes[..., 1::4] / wy
        dw = (rel_codes[..., 2::4] / ww).clamp_max(self.bbox_xform_clip)
        dh = (rel_codes[..., 3::4] / wh).clamp_max(self.bbox_xform_clip)

        pred_ctr_x = dx * widths[..., None] + ctr_x[..., None]
        pred_ctr_y = dy * heights[..., None] + ctr_y[..., None]
        pred_w = torch.exp(dw) * widths[..., None]
        pred_h = torch.exp(dh) * heights[..., None]

        x1 = pred_ctr_x - 0.5 * pred_w
        y1 = pred_ctr_y - 0.5 * pred_h
        x2 = pred_ctr_x + 0.5 * pred_w - 1.0
        y2 = pred_ctr_y + 0.5 * pred_h - 1.0
        out = torch.stack([x1, y1, x2, y2], dim=-1)
        return out.reshape(rel_codes.shape)
