"""Relation attention for MEGA, inference (counterpart of
``mega_pytorch_tpu/models/roi_heads/attention.py``, ``RelationAttention``).

logits = (q.k + u.k) / sqrt(d) [+ log position weight], masked over invalid
refs; values are each ref's feature projected per group by ``Wv_kernel``
(g, feat, d), mixed back to ``feat`` columns. Every operand has a leading
lane dimension, which the kernels take as their batch (the JAX module runs
per lane under vmap). On a CUDA tensor every call launches the flash kernel:
mode "compute" when ``pos_rois`` is given, mode "input" with the log bias of
a ``pos_emb`` (log(relu(pos_emb . Wg + b) + 1e-6), a plain product), mode
"none" otherwise, whatever the number of refs. On a CPU tensor the einsum
path runs with the bf16-sinusoid position bias, as the JAX module does there.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ...ops.kernels.position_bias import (
    _log_ratios,
    bias_freq_scales,
    reference_position_bias,
)
from ...ops.kernels.relation_attention import (
    flash_relation_attention,
    flash_relation_attention_bias,
    flash_relation_attention_pos,
)
from ..layers import Dense

NEG_INF = -1e30


def position_embedding(rois: torch.Tensor, ref_rois: torch.Tensor,
                       feat_dim: int = 64) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) → (..., N, M, feat_dim) f32 sinusoidal
    embedding of the pairwise geometry, laid out (channel, sin|cos, freq) as
    the rows of ``Wg`` (the JAX ``position_embedding``)."""
    pos = torch.stack(_log_ratios(rois.float(), ref_rois.float()), -1)  # (..., N, M, 4)
    freqs = torch.tensor(bias_freq_scales(feat_dim // 8), dtype=torch.float32,
                         device=pos.device)
    div = pos[..., None] * freqs  # (..., N, M, 4, F)
    return torch.cat([torch.sin(div), torch.cos(div)], -1).flatten(-2)


class _Wg(nn.Module):
    """Position-weight projection kept in the flax layout: kernel (E, g)."""

    def __init__(self, embed_dim, groups, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(embed_dim, groups, device=device))
        self.bias = nn.Parameter(torch.zeros(groups, device=device))


class RelationAttention(nn.Module):
    def __init__(self, feat_dim=1024, embed_dim=64, groups=16, use_position=True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.feat_dim, self.embed_dim, self.groups = feat_dim, embed_dim, groups
        self.use_position, self.dtype = use_position, dtype
        d = feat_dim // groups
        self.Wq = Dense(feat_dim, feat_dim, dtype, device=device)
        self.Wk = Dense(feat_dim, feat_dim, dtype, device=device)
        self.u = nn.Parameter(torch.empty(groups, embed_dim, device=device))
        self.Wg = _Wg(embed_dim, groups, device) if use_position else None
        self.Wv_kernel = nn.Parameter(torch.empty(groups, feat_dim, d, device=device))
        self.Wv_bias = nn.Parameter(torch.zeros(feat_dim, device=device))

    def init_weights(self, generator) -> None:
        self.u.data.normal_(0.0, 0.01, generator=generator)
        if self.Wg is not None:
            self.Wg.kernel.data.normal_(0.0, 0.01, generator=generator)
            self.Wg.bias.data.zero_()
        self.Wv_kernel.data.normal_(0.0, 0.01, generator=generator)
        self.Wv_bias.data.zero_()

    def cast_weights_(self) -> None:
        self.u.data = self.u.data.to(self.dtype)
        self.Wv_kernel.data = self.Wv_kernel.data.to(self.dtype)

    def forward(self, roi_feat, ref_feat, ref_valid=None, pos_rois=None,
                pos_emb=None):
        """Lanes lead every operand: roi_feat (L, N, D), ref_feat (L, M, D),
        ref_valid (L, M) bool, and either pos_rois = (cur_rois (L, N, 4),
        ref_rois (L, M, 4)) or pos_emb (L, N, M, E) → (L, N, D) f32."""
        g = self.groups
        d = self.feat_dim // g
        dt = self.dtype
        lanes, m = ref_feat.shape[:2]
        q = self.Wq(roi_feat).reshape(lanes, -1, g, d).transpose(1, 2)  # (L, g, N, d)
        k = self.Wk(ref_feat).reshape(lanes, m, g, d).transpose(1, 2)  # (L, g, M, d)
        uk = torch.einsum("gd,lgmd->lgm", self.u.to(dt).float(), k.float())
        # per-group values: (L, g, M, d), f32 sums over dt operands
        v = torch.einsum("lmf,gfd->lgmd", ref_feat.to(dt).float(),
                         self.Wv_kernel.to(dt).float())
        if ref_valid is None:
            ref_valid = torch.ones((lanes, m), dtype=torch.bool, device=k.device)
        log_bias = None
        if self.use_position and pos_rois is None:
            if pos_emb is None:
                raise ValueError("use_position needs pos_rois or pos_emb")
            pw = (pos_emb.float() @ self.Wg.kernel.float() + self.Wg.bias.float())
            log_bias = torch.log(pw.clamp_min(0.0) + 1e-6).permute(0, 3, 1, 2)

        if roi_feat.device.type == "cuda":
            def bf16(x):
                return x.to(torch.bfloat16).contiguous()

            args = (bf16(q), bf16(k), bf16(v), uk.contiguous())
            valid = ref_valid.contiguous()
            if log_bias is not None:
                out = flash_relation_attention_bias(*args, log_bias.contiguous(), valid)
            elif self.use_position:
                out = flash_relation_attention_pos(
                    *args, pos_rois[0].float().contiguous(),
                    pos_rois[1].float().contiguous(),
                    self.Wg.kernel.float().contiguous(),
                    self.Wg.bias.float().contiguous(), valid,
                )
            else:
                out = flash_relation_attention(*args, valid)
            return out.transpose(1, 2).reshape(lanes, -1, self.feat_dim) + self.Wv_bias.float()

        aff = torch.einsum("lgnd,lgmd->lgnm", q.float(), k.float())
        aff = (aff + uk[:, :, None, :]) * (1.0 / math.sqrt(d))
        if self.use_position and log_bias is None:
            log_bias = reference_position_bias(
                pos_rois[0], pos_rois[1], self.Wg.kernel, self.Wg.bias,
                self.embed_dim, sin_dtype=torch.bfloat16,
            )
        if log_bias is not None:
            aff = log_bias + aff
        aff = torch.where(ref_valid[:, None, None, :], aff, torch.full_like(aff, NEG_INF))
        soft = torch.softmax(aff, dim=-1)
        # a lane with no valid ref attends to nothing: zeros, not a uniform softmax
        soft = torch.where(ref_valid.any(-1)[:, None, None, None], soft,
                           torch.zeros_like(soft))
        mixed = torch.einsum("lgnm,lgmd->lngd", soft.to(dt).float(), v.to(dt).float())
        return mixed.reshape(lanes, -1, self.feat_dim) + self.Wv_bias.float()
