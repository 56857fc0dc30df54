"""Bilinear flow warping (counterpart of ``mega_pytorch_tpu/ops/warp.py``).

The reference warps feature maps along optical flow with
``F.grid_sample(feats, grid, mode="bilinear", padding_mode="border")`` on the
grid ``(flow + identity) / ((size - 1) / 2) - 1`` and align_corners False,
which samples at ``x_src = (x + flow_x) * W / (W - 1) - 1/2`` (and likewise
in y) with the coordinates clamped into the map. ``warp_by_flow`` computes
those coordinates as the JAX package does and samples them through
``bilinear_sample``. Maps are NHWC with any leading dimensions (lanes,
frames). The gradients are JAX's, the border included (``_clip``); on CUDA
the gathers' backward adds with atomics, so they are not bit-reproducible
from run to run there.
"""

from __future__ import annotations

import torch


def _clip(x: torch.Tensor, hi: float) -> torch.Tensor:
    """``x`` clipped into [0, hi] as ``jnp.clip`` computes it, a maximum then
    a minimum, whose gradient is 1/2 at a coordinate exactly on a bound
    (``torch.clamp``'s is 1 there): the warp's gradient then equals JAX's
    on the border too."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_full((), hi))


def bilinear_sample(features: torch.Tensor, src_x: torch.Tensor,
                    src_y: torch.Tensor) -> torch.Tensor:
    """Border-clamped bilinear sample of (..., H, W, C) ``features`` at pixel
    coordinates ``src_x``, ``src_y`` (each (..., H, W)) → (..., H, W, C)."""
    *lead, h, w, c = features.shape
    src_x, src_y = _clip(src_x, w - 1.0), _clip(src_y, h - 1.0)
    x0, y0 = torch.floor(src_x), torch.floor(src_y)
    x1 = torch.clamp(x0 + 1, max=w - 1.0)
    y1 = torch.clamp(y0 + 1, max=h - 1.0)
    lx, ly = (src_x - x0)[..., None], (src_y - y0)[..., None]
    flat = features.reshape(-1, h * w, c)

    def tap(yi, xi):
        idx = (yi.long() * w + xi.long()).reshape(flat.shape[0], h * w, 1)
        return torch.gather(flat, 1, idx.expand(-1, -1, c)).reshape(*lead, h, w, c)

    top = tap(y0, x0) * (1 - lx) + tap(y0, x1) * lx
    bot = tap(y1, x0) * (1 - lx) + tap(y1, x1) * lx
    return top * (1 - ly) + bot * ly


def warp_by_flow(features: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp (..., H, W, C) ``features`` by (..., H, W, 2) ``flow``
    ((dx, dy) in pixels): output[y, x] samples features at
    ((x + dx) * W / (W - 1) - 1/2, (y + dy) * H / (H - 1) - 1/2),
    border-clamped bilinear. f32 in, f32 out."""
    h, w = features.shape[-3], features.shape[-2]
    dev = features.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    src_x = (xs + flow[..., 0]) * (w / (w - 1.0)) - 0.5
    src_y = (ys + flow[..., 1]) * (h / (h - 1.0)) - 0.5
    return bilinear_sample(features, src_x, src_y)
