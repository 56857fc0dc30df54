"""Deformable convolution v1 and v2 (counterpart of
``mega_pytorch_tpu/ops/deform_conv.py``; ``deform_conv_cuda.cu`` and the
modulated ``DFConv2d`` of ``layers/dcn``): kernel tap k samples the input
at ``p + p_k * dilation + dp_k(p)`` bilinearly, v2 scales the sample by the
mask m_k(p), and the samples contract with the tap's weights.

Each tap is one border-clamped bilinear sample of the whole map at absolute
pixel coordinates (``ops/warp.py:bilinear_sample``), then a (Cin, Cout)
product, as in the JAX package. Stride 1, same padding; f32.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..models.layers import Conv
from .warp import bilinear_sample


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                  mask: torch.Tensor | None = None, dilation: int = 1) -> torch.Tensor:
    """x (..., H, W, Cin); offsets (..., H, W, 2K) in torch order (channel 2t
    is tap t's dy, 2t + 1 its dx); weight (Cout, Cin, kh, kw); mask
    (..., H, W, K) or None → (..., H, W, Cout) f32."""
    cout, cin, kh, kw = weight.shape
    h, w = x.shape[-3], x.shape[-2]
    dev = x.device
    x = x.float()
    offsets = offsets.float()
    wt = weight.float().permute(2, 3, 1, 0)  # (kh, kw, Cin, Cout)
    grid_y = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    grid_x = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    out = x.new_zeros((*x.shape[:-1], cout))
    for t in range(kh * kw):
        dy = (t // kw - kh // 2) * dilation
        dx = (t % kw - kw // 2) * dilation
        sampled = bilinear_sample(x, grid_x + (offsets[..., 2 * t + 1] + dx),
                                  grid_y + (offsets[..., 2 * t] + dy))
        if mask is not None:
            sampled = sampled * mask[..., t:t + 1]
        out = out + sampled @ wt[t // kw, t % kw]
    return out


class DFConv2d(nn.Module):
    """Deformable conv layer: the ``offset`` conv (zero-initialised) predicts
    the offsets, and with ``with_modulated_dcn`` the v2 mask, 2 * sigmoid,
    for each of ``deformable_groups`` groups of input channels, whose
    contributions add. Its channels are group-major: (g, 2K), or (g, 3K)
    with the mask's K after the offsets. ``weight`` (Cout, Cin, k, k) is the
    flax module's own ``kernel`` (k, k, Cin, Cout), he-uniform. NHWC in,
    f32 NHWC out."""

    def __init__(self, in_channels, features, kernel_size=3, dilation=1,
                 with_modulated_dcn=False, deformable_groups=1, dtype=torch.float32,
                 device=None):
        super().__init__()
        if in_channels % deformable_groups:
            raise ValueError("in_channels must be a multiple of deformable_groups")
        k = kernel_size * kernel_size
        self.k, self.dilation, self.groups = k, dilation, deformable_groups
        self.modulated = with_modulated_dcn
        self.offset = Conv(in_channels, deformable_groups * (3 if with_modulated_dcn else 2) * k,
                           kernel_size, padding=dilation * (kernel_size // 2),
                           dilation=dilation, dtype=dtype, init_std=0.0, device=device)
        self.weight = nn.Parameter(torch.empty(features, in_channels, kernel_size,
                                               kernel_size, device=device))

    def init_weights(self, generator) -> None:
        limit = math.sqrt(6.0 / self.weight[0].numel())  # he_uniform, fan_in k * k * Cin
        self.weight.data.uniform_(-limit, limit, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        raw = self.offset(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).float()
        g, k = self.groups, self.k
        per = raw.reshape(*raw.shape[:-1], g, (3 if self.modulated else 2) * k)
        cg = x.shape[-1] // g
        out = 0
        for gi in range(g):
            mask = 2.0 * torch.sigmoid(per[..., gi, 2 * k:]) if self.modulated else None
            out = out + deform_conv2d(x[..., gi * cg:(gi + 1) * cg], per[..., gi, :2 * k],
                                      self.weight[:, gi * cg:(gi + 1) * cg], mask,
                                      self.dilation)
        return out
