"""Relation-attention position bias: plain PyTorch helpers.

Counterpart of ``mega_pytorch_tpu/ops/pallas/position_bias.py``. Its Pallas
kernel ``fused_position_bias`` (the standalone (g, N, M) log bias) is not on
the streaming path and is not ported yet; the flash attention kernel computes
the same position weight in-kernel (``csrc/relation_attention.cu``).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def bias_freq_scales(num_freq: int) -> list[float]:
    """The sinusoid frequency ladder 100 / 1000^(f/F), shared by the plain
    bias and the attention kernel's in-kernel bias."""
    log1000 = float(np.log(1000.0))
    return [
        100.0 * math.exp(-f * (1.0 / num_freq) * log1000)
        for f in range(num_freq)
    ]


def _geometry(r: torch.Tensor):
    """(w, h, cx, cy) with the +1 widths and the 1e-3 w/h clamp."""
    w = r[..., 2] - r[..., 0] + 1.0
    h = r[..., 3] - r[..., 1] + 1.0
    cx = 0.5 * (r[..., 0] + r[..., 2])
    cy = 0.5 * (r[..., 1] + r[..., 3])
    return w.clamp_min(1e-3), h.clamp_min(1e-3), cx, cy


def _log_ratios(rois: torch.Tensor, ref_rois: torch.Tensor):
    """(..., N, 4) x (..., M, 4) → 4 slabs (..., N, M) of pairwise geometry."""
    w, h, cx, cy = _geometry(rois)
    w_r, h_r, cx_r, cy_r = _geometry(ref_rois)
    dx = torch.log(((cx[..., :, None] - cx_r[..., None, :]) / w[..., :, None]).abs() + 1e-3)
    dy = torch.log(((cy[..., :, None] - cy_r[..., None, :]) / h[..., :, None]).abs() + 1e-3)
    dw = torch.log(w[..., :, None] / w_r[..., None, :])
    dh = torch.log(h[..., :, None] / h_r[..., None, :])
    return dx, dy, dw, dh


def reference_position_bias(
    rois: torch.Tensor,
    ref_rois: torch.Tensor,
    wg_kernel: torch.Tensor,
    wg_bias: torch.Tensor,
    embed_dim: int = 64,
    sin_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) → (..., g, N, M) log position bias.

    The sinusoids and Wg are rounded to ``sin_dtype`` before the contraction,
    which sums in f32 (bf16 is the inference default of the JAX package)."""
    num_freq = embed_dim // 8
    g = wg_kernel.shape[1]
    dx, dy, dw, dh = _log_ratios(rois.float(), ref_rois.float())
    pos = torch.stack([dx, dy, dw, dh], dim=-1)  # (..., N, M, 4)
    freqs = torch.tensor(bias_freq_scales(num_freq), dtype=torch.float32,
                         device=pos.device)
    div = pos[..., None] * freqs  # (..., N, M, 4, F)
    w4 = wg_kernel.float().reshape(4, 2, num_freq, g)

    def rounded(x):
        return x.to(sin_dtype).float()

    lead = div.shape[:-2]
    pw = (
        rounded(torch.sin(div)).reshape(*lead, 4 * num_freq)
        @ rounded(w4[:, 0]).reshape(4 * num_freq, g)
    ) + (
        rounded(torch.cos(div)).reshape(*lead, 4 * num_freq)
        @ rounded(w4[:, 1]).reshape(4 * num_freq, g)
    )
    pw = (pw + wg_bias.float()).clamp_min(0.0)
    return torch.log(pw + 1e-6).movedim(-1, -3)
