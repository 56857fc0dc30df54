"""Anchor generation (copied numpy from ``mega_pytorch_tpu/models/rpn/anchors.py``):
Detectron cell anchors (ratio-major, then size) and (y, x, anchor) grid order,
and the anchors' visibility in an image (training)."""

from __future__ import annotations

import numpy as np
import torch


def _whctrs(anchor: np.ndarray):
    w = anchor[2] - anchor[0] + 1
    h = anchor[3] - anchor[1] + 1
    return w, h, anchor[0] + 0.5 * (w - 1), anchor[1] + 0.5 * (h - 1)


def _mkanchors(ws, hs, x_ctr, y_ctr):
    ws = ws[:, None]
    hs = hs[:, None]
    return np.hstack(
        [
            x_ctr - 0.5 * (ws - 1),
            y_ctr - 0.5 * (hs - 1),
            x_ctr + 0.5 * (ws - 1),
            y_ctr + 0.5 * (hs - 1),
        ]
    )


def generate_cell_anchors(
    stride: int = 16,
    sizes=(32, 64, 128, 256, 512),
    aspect_ratios=(0.5, 1.0, 2.0),
) -> np.ndarray:
    """(A, 4) base anchors. Order: ratio-major, then size (reference order)."""
    scales = np.array(sizes, dtype=np.float64) / stride
    ratios = np.array(aspect_ratios, dtype=np.float64)
    base = np.array([1, 1, stride, stride], dtype=np.float64) - 1

    w, h, x_ctr, y_ctr = _whctrs(base)
    size = w * h
    size_ratios = size / ratios
    ws = np.round(np.sqrt(size_ratios))
    hs = np.round(ws * ratios)
    ratio_anchors = _mkanchors(ws, hs, x_ctr, y_ctr)

    all_anchors = []
    for i in range(ratio_anchors.shape[0]):
        w, h, x_ctr, y_ctr = _whctrs(ratio_anchors[i])
        all_anchors.append(_mkanchors(w * scales, h * scales, x_ctr, y_ctr))
    return np.vstack(all_anchors).astype(np.float32)


def grid_anchors(
    feat_h: int, feat_w: int, stride: int, cell_anchors: np.ndarray
) -> np.ndarray:
    """(feat_h * feat_w * A, 4) anchors, (y, x, a) ordering."""
    shifts_x = np.arange(feat_w, dtype=np.float32) * stride
    shifts_y = np.arange(feat_h, dtype=np.float32) * stride
    sx, sy = np.meshgrid(shifts_x, shifts_y)  # (H, W), x varies fastest
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    anchors = shifts[:, None, :] + cell_anchors[None, :, :]
    return anchors.reshape(-1, 4)


def anchor_visibility(anchors, im_height, im_width, straddle_thresh: float = 0):
    """True for anchors (N, 4) within ``straddle_thresh`` of the image;
    ``im_height``/``im_width`` are scalars or tensors that broadcast against
    anchors[:, 0] (per-image sizes as (B, 1) give (B, N)). A negative
    threshold keeps every anchor."""
    if straddle_thresh < 0:
        return torch.ones(anchors.shape[0], dtype=torch.bool, device=anchors.device)
    return ((anchors[:, 0] >= -straddle_thresh) & (anchors[:, 1] >= -straddle_thresh)
            & (anchors[:, 2] < im_width + straddle_thresh)
            & (anchors[:, 3] < im_height + straddle_thresh))
