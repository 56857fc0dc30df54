"""ROIPool, quantised max pooling over ROI bins (counterpart of
``mega_pytorch_tpu/ops/roi_pool.py``), ``ROIPool_cuda.cu`` semantics: ROI
corners rounded half to even after scaling, bins of ``roi / pooled`` with
floor / ceil bounds nudged by 1e-4 towards the exact result, the max over
the integer pixels of each bin, 0 for an empty bin. A bin is read at no more
than ``max_bin`` strided candidate rows and columns (truncated to integers),
as in the JAX package: exact for ROIs up to ``max_bin * pooled`` feature
pixels, subsampled beyond.

A rectangle's maximum is the maximum over its rows of each row's maximum,
so each ROI is pooled in two gathers: its bins' candidate rows over the
whole map width, maxed over the rows, then the bins' candidate columns,
maxed over the columns. Both are exact (no arithmetic). The first one's
(R, PH, S, W, C) gather is made, and masked in place, in chunks of ROIs
that keep it under ``MAX_SCRATCH`` bytes: the JAX form's (R, PH, PW, S, S,
C) would take 15 GB at 300 ROIs on a 1024-channel C4 map.
"""

from __future__ import annotations

import torch

MAX_SCRATCH = 1 << 29  # bytes of the row gather, per chunk of ROIs
EPS = 1e-4


def _candidates(start, end, max_bin: int):
    """(R, P) bin bounds → (R, P, S) candidate pixels (float) and their
    validity: the bin's first ``max_bin`` pixels, or ``max_bin`` strided ones
    when it is longer."""
    ii = torch.arange(max_bin, dtype=torch.float32, device=start.device)
    step = ((end - start) / max_bin).clamp_min(1.0)
    coord = start[..., None] + ii * step[..., None]
    return coord, coord < end[..., None]


def roi_pool(features: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
             pooled_height: int = 7, pooled_width: int = 7,
             max_bin: int = 16) -> torch.Tensor:
    """features (L, H, W, C), one map per lane; rois (L, R, 4) xyxy in image
    coordinates → (L, R, pooled_height, pooled_width, C) in the features'
    dtype."""
    lanes, h, w, c = features.shape
    r = rois.shape[1]
    dev = features.device
    b = rois.float().reshape(lanes * r, 4)
    x1, y1, x2, y2 = (torch.round(b[:, i] * spatial_scale) for i in range(4))
    bin_w = (x2 - x1 + 1.0).clamp_min(1.0) / pooled_width
    bin_h = (y2 - y1 + 1.0).clamp_min(1.0) / pooled_height
    ph = torch.arange(pooled_height, dtype=torch.float32, device=dev)
    pw = torch.arange(pooled_width, dtype=torch.float32, device=dev)
    hstart = (torch.floor(ph * bin_h[:, None] + EPS) + y1[:, None]).clamp(0, h)
    hend = (torch.ceil((ph + 1) * bin_h[:, None] - EPS) + y1[:, None]).clamp(0, h)
    wstart = (torch.floor(pw * bin_w[:, None] + EPS) + x1[:, None]).clamp(0, w)
    wend = (torch.ceil((pw + 1) * bin_w[:, None] - EPS) + x1[:, None]).clamp(0, w)
    ys, y_ok = _candidates(hstart, hend, max_bin)  # (L*R, PH, S)
    xs, x_ok = _candidates(wstart, wend, max_bin)  # (L*R, PW, S)
    yi = ys.long().clamp(0, h - 1)
    xi = xs.long().clamp(0, w - 1)
    lane = torch.arange(lanes, device=dev).repeat_interleave(r)

    out = torch.empty((lanes * r, pooled_height, pooled_width, c), dtype=features.dtype,
                      device=dev)
    per_roi = pooled_height * max_bin * w * c * features.element_size()
    chunk = max(1, MAX_SCRATCH // per_roi)
    for r0 in range(0, lanes * r, chunk):
        sl = slice(r0, r0 + chunk)
        rows = features[lane[sl, None, None], yi[sl]]  # (n, PH, S, W, C)
        rows = rows.masked_fill_(~y_ok[sl, :, :, None, None], float("-inf")).amax(dim=2)
        n = rows.shape[0]
        cols = rows[torch.arange(n, device=dev)[:, None, None, None],
                    torch.arange(pooled_height, device=dev)[None, :, None, None],
                    xi[sl, None]]  # (n, PH, PW, S, C)
        cols = cols.masked_fill_(~x_ok[sl, None, :, :, None], float("-inf")).amax(dim=3)
        any_ok = y_ok[sl].any(-1)[:, :, None] & x_ok[sl].any(-1)[:, None, :]
        out[sl] = torch.where(any_ok[..., None], cols, torch.zeros_like(cols))
    return out.reshape(lanes, r, pooled_height, pooled_width, c)
