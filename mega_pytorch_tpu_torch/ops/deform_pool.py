"""Deformable position-sensitive ROI pooling (counterpart of
``mega_pytorch_tpu/ops/deform_pool.py``), with the semantics of
``deform_pool_kernel_cuda.cu`` (``DeformablePSROIPoolForwardKernel``):

- ROI corners are rounded, then scaled: start = round(x0) * scale - 0.5,
  end = (round(x1) + 1) * scale - 0.5, the extent at least 0.1;
- each of the out_size x out_size bins averages sample_per_part^2 bilinear
  samples; a sample outside [-0.5, dim - 0.5] is dropped from the count (0
  where none is left), an inside one is clamped into [0, dim - 1] and read
  at its floor and ceil taps;
- input channel (ctop * group_size + gh) * group_size + gw feeds output
  channel ctop at bin (ph, pw), gh = floor(ph * group_size / out_size);
- the (x, y) offset of a bin is read from the (R, classes * 2, part, part)
  map at floor(p / out_size * part_size), scaled by trans_std and the ROI
  extent.

A bin's S x S samples are the product of S columns and S rows, so the bin
is a sum of ``profile_y[h] * profile_x[w] * data[h, w]``: the per-sample
weights are summed into one row and one column profile per bin, and every
bin of a chunk of ROIs is one product of their outer products, (bins,
H * W), with the (H * W, C) map. Chunks keep the outer products under
``MAX_SCRATCH`` bytes.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_SCRATCH = 1 << 28  # bytes of the bins' (H * W) weights, per chunk of ROIs


def _bilinear_axis_weights(coord: torch.Tensor, axis_len: int) -> torch.Tensor:
    """(..., S) sample coordinates → (..., S, axis_len) weights of the taps
    floor(x) and ceil(x), 1 - d and d: an integral x gets its one tap at 1."""
    x1 = torch.floor(coord)
    x2 = torch.ceil(coord)
    d = coord - x1
    grid = torch.arange(axis_len, dtype=coord.dtype, device=coord.device)
    zero = coord.new_zeros(())
    w1 = torch.where(grid == x1[..., None], (1.0 - d)[..., None], zero)
    w2 = torch.where(grid == x2[..., None], d[..., None], zero)
    return w1 + w2


def deform_roi_pooling(data: torch.Tensor, rois: torch.Tensor, offset, spatial_scale: float,
                       out_size: int, out_channels: int, no_trans: bool,
                       group_size: int = 1, part_size: int | None = None,
                       sample_per_part: int = 4, trans_std: float = 0.0) -> torch.Tensor:
    """data (H, W, C) NHWC, one image; rois (R, 4) xyxy in image coordinates;
    offset (R, classes * 2, part, part) or None (``no_trans``) →
    (R, out_size, out_size, out_channels) f32."""
    h, w, c = data.shape
    r = rois.shape[0]
    p, s = out_size, sample_per_part
    part = out_size if part_size is None else part_size
    if c != out_channels * group_size * group_size:
        raise ValueError(f"data has {c} channels, not out_channels * group_size^2")
    dev = data.device
    f32 = torch.float32
    rois = rois.float()
    x0 = torch.round(rois[:, 0]) * spatial_scale - 0.5
    y0 = torch.round(rois[:, 1]) * spatial_scale - 0.5
    x1 = (torch.round(rois[:, 2]) + 1.0) * spatial_scale - 0.5
    y1 = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    roi_w = (x1 - x0).clamp_min(0.1)
    roi_h = (y1 - y0).clamp_min(0.1)
    bin_w, bin_h = roi_w / p, roi_h / p
    sub_w, sub_h = bin_w / s, bin_h / s

    if no_trans:
        classes = 1
        trans_x = trans_y = torch.zeros((r, 1, p, p), dtype=f32, device=dev)
    else:
        classes = offset.shape[1] // 2
        part_idx = torch.as_tensor(np.floor(np.arange(p) / p * part).astype(np.int64),
                                   device=dev)
        off = offset.reshape(r, classes, 2, part, part).float()
        off = off[:, :, :, part_idx][:, :, :, :, part_idx]  # (R, cls, 2, p, p)
        trans_x = off[:, :, 0] * trans_std
        trans_y = off[:, :, 1] * trans_std

    # sample coordinates (R, cls, PH, PW, S)
    ph = torch.arange(p, dtype=f32, device=dev)
    iw = torch.arange(s, dtype=f32, device=dev)
    wstart = (ph[None, :] * bin_w[:, None] + x0[:, None])[:, None, :]  # (R, 1, P)
    hstart = (ph[None, :] * bin_h[:, None] + y0[:, None])[:, None, :]
    sx = (wstart[:, :, None, :, None]
          + trans_x[..., None] * roi_w[:, None, None, None, None]
          + iw * sub_w[:, None, None, None, None])
    sy = (hstart[:, :, :, None, None]
          + trans_y[..., None] * roi_h[:, None, None, None, None]
          + iw * sub_h[:, None, None, None, None])
    vx = (sx >= -0.5) & (sx <= w - 0.5)
    vy = (sy >= -0.5) & (sy <= h - 0.5)
    sx = sx.clamp(0.0, w - 1.0)
    sy = sy.clamp(0.0, h - 1.0)
    wx = (_bilinear_axis_weights(sx, w) * vx[..., None]).sum(-2)  # (R, cls, PH, PW, W)
    wy = (_bilinear_axis_weights(sy, h) * vy[..., None]).sum(-2)  # (R, cls, PH, PW, H)
    cnt = vy.float().sum(-1) * vx.float().sum(-1)  # (R, cls, PH, PW)

    flat = data.float().reshape(h * w, c)
    bins = classes * p * p
    val = torch.empty((r, bins, c), dtype=f32, device=dev)
    chunk = max(1, MAX_SCRATCH // (bins * h * w * 4))
    wy, wx = wy.reshape(r, bins, h), wx.reshape(r, bins, w)
    for r0 in range(0, r, chunk):
        sl = slice(r0, r0 + chunk)
        outer = (wy[sl, :, :, None] * wx[sl, :, None, :]).reshape(-1, h * w)
        val[sl] = (outer @ flat).reshape(-1, bins, c)
    val = val.reshape(r, classes, p, p, c)
    pooled = torch.where(cnt[..., None] > 0, val / cnt.clamp_min(1.0)[..., None],
                         val.new_zeros(()))

    # position-sensitive channel of each output channel at each bin
    g = np.clip((np.arange(p) * group_size) // p, 0, group_size - 1)
    ct = np.arange(out_channels)
    chan = (ct[None, None, :] * group_size + g[:, None, None]) * group_size + g[None, :, None]
    chan = torch.as_tensor(chan, device=dev).expand(r, classes, p, p, out_channels)
    pooled = torch.gather(pooled, -1, chan)
    if classes == 1:
        return pooled[:, 0]
    # each output channel reads its class block's offsets
    cls_of = torch.as_tensor(np.arange(out_channels) // (out_channels // classes),
                             device=dev).expand(r, 1, p, p, out_channels)
    return torch.gather(pooled, 1, cls_of)[:, 0]
