"""ROIAlign as two separable contractions (counterpart of
``mega_pytorch_tpu/ops/roi_align.py``), maskrcnn-benchmark semantics: no
half-pixel shift, ROI extents floored at 1, ``sampling_ratio=0`` meaning an
adaptive ceil(roi / pooled) grid per ROI (capped at ``max_grid``), taps
outside [-1, size] contributing zero, coordinates clamped at the edges:

    pooled[l, r, ph, pw, c] = sum_{h,w} Wy[l, r, ph, h] Wx[l, r, pw, w] feat[l, h, w, c]

over lanes l, each with its own map and ROIs. The first contraction's
(lanes, R, ph, W, C) f32 intermediate would reach 1.65 GB at 12 lanes x 300
ROIs of a 608x1024 canvas, so lanes are contracted in chunks that keep it
under ``MAX_INTERMEDIATE`` elements.
"""

from __future__ import annotations

import torch

MAX_INTERMEDIATE = 1 << 27  # f32 elements (512 MB) of the first contraction


def _axis_weights(start, size, num_bins: int, grid, axis_len: int, max_grid: int):
    """(R, num_bins, axis_len) f32 bin-average interpolation weights."""
    dev = start.device
    bin_size = size / num_bins
    iy = torch.arange(max_grid, dtype=torch.float32, device=dev)
    ph = torch.arange(num_bins, dtype=torch.float32, device=dev)
    gridf = grid.float()
    coord = (
        start[:, None, None]
        + ph[None, :, None] * bin_size[:, None, None]
        + (iy[None, None, :] + 0.5) * bin_size[:, None, None] / gridf[:, None, None]
    )  # (R, P, S)
    sample_ok = iy[None, None, :] < gridf[:, None, None]
    inside = (coord >= -1.0) & (coord <= axis_len)
    c = coord.clamp_min(0.0)
    low = torch.floor(c)
    at_edge = low >= axis_len - 1
    edge = torch.full_like(low, axis_len - 1)
    low = torch.where(at_edge, edge, low)
    high = torch.where(at_edge, edge, low + 1)
    l_frac = torch.where(at_edge, torch.zeros_like(c), c - low)
    h_frac = 1.0 - l_frac
    w_mask = (sample_ok & inside).float() / gridf[:, None, None]
    axis_idx = torch.arange(axis_len, dtype=torch.float32, device=dev)
    onehot_low = (low[..., None] == axis_idx).float()  # (R, P, S, L)
    onehot_high = (high[..., None] == axis_idx).float()
    w = (h_frac[..., None] * onehot_low + l_frac[..., None] * onehot_high) * w_mask[..., None]
    return w.sum(dim=2)


def roi_align(features: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
              pooled_height: int = 7, pooled_width: int = 7,
              sampling_ratio: int = 0, max_grid: int = 10) -> torch.Tensor:
    """features (L, H, W, C), one map per lane; rois (L, R, 4) xyxy in image
    coordinates → (L, R, pooled_height, pooled_width, C) f32."""
    lanes, h, w, c = features.shape
    r = rois.shape[1]
    rois = rois.float().reshape(lanes * r, 4)
    x1 = rois[:, 0] * spatial_scale
    y1 = rois[:, 1] * spatial_scale
    x2 = rois[:, 2] * spatial_scale
    y2 = rois[:, 3] * spatial_scale
    roi_w = (x2 - x1).clamp_min(1.0)
    roi_h = (y2 - y1).clamp_min(1.0)
    if sampling_ratio > 0:
        gh = torch.full(rois.shape[:1], sampling_ratio, dtype=torch.int32,
                        device=rois.device)
        gw = gh
        max_grid = sampling_ratio
    else:
        gh = torch.ceil(roi_h / pooled_height).int().clamp(1, max_grid)
        gw = torch.ceil(roi_w / pooled_width).int().clamp(1, max_grid)
    wy = _axis_weights(y1, roi_h, pooled_height, gh, h, max_grid)  # (L*R, PH, H)
    wx = _axis_weights(x1, roi_w, pooled_width, gw, w, max_grid)  # (L*R, PW, W)
    wy = wy.reshape(lanes, r, pooled_height, h)
    wx = wx.reshape(lanes, r, pooled_width, w)
    feat = features.float()
    out = torch.empty((lanes, r, pooled_height, pooled_width, c),
                      dtype=torch.float32, device=features.device)
    chunk = max(1, MAX_INTERMEDIATE // max(1, r * pooled_height * w * c))
    for l0 in range(0, lanes, chunk):
        sl = slice(l0, l0 + chunk)
        tmp = torch.einsum("lrph,lhwc->lrpwc", wy[sl], feat[sl])
        out[sl] = torch.einsum("lrqw,lrpwc->lrpqc", wx[sl], tmp)
    return out
