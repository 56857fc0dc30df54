"""Relation attention for MEGA, inference (counterpart of
``mega_pytorch_tpu/models/roi_heads/attention.py``, ``RelationAttention``).

logits = (q.k + u.k) / sqrt(d) [+ log position weight], masked over invalid
refs; values are each ref's feature projected per group by ``Wv_kernel``
(g, feat, d), mixed back to ``feat`` columns. On a CUDA tensor every call
launches the flash kernel: mode "compute" when ``pos_rois`` is given, mode
"none" otherwise, whatever the number of refs. On a CPU tensor the einsum
path runs with the bf16-sinusoid position bias, as the JAX module does there.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ...ops.kernels.position_bias import reference_position_bias
from ...ops.kernels.relation_attention import (
    flash_relation_attention,
    flash_relation_attention_pos,
)
from ..layers import Dense

NEG_INF = -1e30


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

    def forward(self, roi_feat, ref_feat, ref_valid=None, pos_rois=None):
        """roi_feat (N, D), ref_feat (M, D), ref_valid (M,) bool,
        pos_rois = (cur_rois (N, 4), ref_rois (M, 4)) → (N, D) f32."""
        g = self.groups
        d = self.feat_dim // g
        dt = self.dtype
        m = ref_feat.shape[0]
        q = self.Wq(roi_feat).reshape(-1, g, d)
        k = self.Wk(ref_feat).reshape(-1, g, d)
        uk = torch.einsum("gd,mgd->gm", self.u.to(dt).float(), k.float())
        # per-group values: (M, g, d), f32 sums over dt operands
        v = torch.einsum("mf,gfd->mgd", ref_feat.to(dt).float(),
                         self.Wv_kernel.to(dt).float())
        if ref_valid is None:
            ref_valid = torch.ones((m,), dtype=torch.bool, device=k.device)
        if self.use_position and pos_rois is None:
            raise ValueError("use_position needs pos_rois (pos_emb is not ported)")

        if roi_feat.device.type == "cuda":
            qt = q.transpose(0, 1)[None].to(torch.bfloat16).contiguous()
            kt = k.transpose(0, 1)[None].to(torch.bfloat16).contiguous()
            vt = v.transpose(0, 1)[None].to(torch.bfloat16).contiguous()
            ukb = uk[None].contiguous()
            valid = ref_valid[None].contiguous()
            if self.use_position:
                out = flash_relation_attention_pos(
                    qt, kt, vt, ukb, pos_rois[0][None].float().contiguous(),
                    pos_rois[1][None].float().contiguous(),
                    self.Wg.kernel.float().contiguous(),
                    self.Wg.bias.float().contiguous(), valid,
                )
            else:
                out = flash_relation_attention(qt, kt, vt, ukb, valid)
            return out[0].transpose(0, 1).reshape(-1, self.feat_dim) + self.Wv_bias.float()

        aff = torch.einsum("ngd,mgd->gnm", q.float(), k.float())
        aff = (aff + uk[:, None, :]) * (1.0 / math.sqrt(d))
        if self.use_position:
            log_bias = reference_position_bias(
                pos_rois[0], pos_rois[1], self.Wg.kernel, self.Wg.bias,
                self.embed_dim, sin_dtype=torch.bfloat16,
            )
            aff = log_bias + aff
        aff = torch.where(ref_valid[None, None, :], aff, torch.full_like(aff, NEG_INF))
        soft = torch.softmax(aff, dim=2)
        if not bool(ref_valid.any()):
            soft = torch.zeros_like(soft)
        mixed = torch.einsum("gnm,mgd->ngd", soft.to(dt).float(), v.to(dt).float())
        return mixed.reshape(-1, self.feat_dim) + self.Wv_bias.float()
