"""RDN relation distillation, streaming inference (counterpart of
``mega_pytorch_tpu/models/roi_heads/vid_extractors.py``,
``RDNFeatureExtractor``): res5 on the map (+ the optional reduce), ROIAlign
and fc0 as the window entry, then the base attention stages of the key
frame's proposals over every cached ref and the advanced stage, which first
distills the top ``advanced_num`` refs of each frame against all refs and
then lets the key proposals attend to them. Every attention uses the
position weight and no ``u`` bias.

Stage i lives under ``fcs_{i}`` / ``attn_{i}``: with ``advanced_stage`` 0
there are ``base_stage`` of each, otherwise base + advanced fcs and base +
advanced + 1 attentions. Every tensor leads with the lane dimension.
``extract_train`` is not ported."""

from __future__ import annotations

import torch

from ..layers import Dense
from .attention import RelationAttention
from .mega_extractor import Res5Pooler, distill


class RDNFeatureExtractor(Res5Pooler):
    """res5 + ROIAlign + fcs_0 as the window entry; the relation stages."""

    def __init__(self, depth="R-101", reduce_channel=False, resolution=7,
                 spatial_scale=1.0 / 16, sampling_ratio=0, mlp_dim=1024,
                 dilation=2, stride_in_1x1=True, base_stage=2, advanced_stage=0,
                 base_num=75, advanced_num=15, embed_dim=64, groups=16,
                 dtype=torch.float32, device=None):
        super().__init__(depth, reduce_channel, resolution, spatial_scale,
                         sampling_ratio, dilation, stride_in_1x1, dtype, device)
        self.base_stage, self.advanced_stage = base_stage, advanced_stage
        self.base_num, self.advanced_num = base_num, advanced_num
        if advanced_stage == 0:
            n_fc = n_attn = base_stage
        else:
            n_fc = base_stage + advanced_stage
            n_attn = n_fc + 1
        for i in range(n_fc):
            setattr(self, f"fcs_{i}", Dense(self.flat_dim if i == 0 else mlp_dim,
                                            mlp_dim, dtype, device=device))
        for i in range(n_attn):
            setattr(self, f"attn_{i}", RelationAttention(
                mlp_dim, embed_dim, groups, True, dtype, device, use_u_bias=False))

    def fcs(self, i: int):
        return getattr(self, f"fcs_{i}")

    def attn(self, i: int) -> RelationAttention:
        return getattr(self, f"attn_{i}")

    def _fc(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.fcs(i)(x).float())

    def fc0(self, flat: torch.Tensor) -> torch.Tensor:
        return self._fc(0, flat)

    def precompute_ref(self, c4: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        """(L, H, W, 1024) C4 maps, one frame per lane → pooled fc0 features
        of rois (L, R, 4)."""
        return self.fc0(self.pool_flat(self.enhance_features(c4), rois))

    def extract_test(self, x, cur_rois, ref_rois, ref_valid, ref_feats):
        """x (L, K, D) key ROI features with fcs_0 applied, cur_rois (L, K, 4),
        the window's refs ref_rois (L, T*base_num, 4), ref_valid
        (L, T*base_num), ref_feats (L, T*base_num, D) fc0 features →
        (L, K, D)."""
        for i in range(self.base_stage):
            if i > 0:
                x = self._fc(i, x)
            x = x + self.attn(i)(x, ref_feats, ref_valid, pos_rois=(cur_rois, ref_rois))
        if self.advanced_stage == 0:
            return x
        # the top advanced_num refs of each frame, which relies on the RPN's
        # NMS emitting each frame's proposals in descending score order
        t = ref_feats.shape[1] // self.base_num
        refs_adv, rois_adv, valid_adv = (
            distill(a, t, self.base_num, self.advanced_num)
            for a in (ref_feats, ref_rois, ref_valid))
        for i in range(self.advanced_stage):
            j = self.base_stage + i
            att = self.attn(j)(refs_adv, ref_feats, ref_valid,
                               pos_rois=(rois_adv, ref_rois))
            refs_adv = self._fc(j, refs_adv + att)
        last = self.attn(self.base_stage + self.advanced_stage)
        return x + last(x, refs_adv, valid_adv, pos_rois=(cur_rois, rois_adv))
