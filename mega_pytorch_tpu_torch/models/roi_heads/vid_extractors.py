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
Serving (``extract_test``, fc0 applied when a frame enters the window) and
training (``extract_train``, one sample's frames pooled, the f32-sinusoid
bias of ``precise_bias``) share ``_stages``."""

from __future__ import annotations

import torch

from ...utils.profiler import annotate
from ..layers import Dense
from .attention import RelationAttention
from .mega_extractor import Res5Pooler, distill


class RDNFeatureExtractor(Res5Pooler):
    """res5 + ROIAlign + fcs_0 as the window entry; the relation stages."""

    def __init__(self, depth="R-101", reduce_channel=False, resolution=7,
                 spatial_scale=1.0 / 16, sampling_ratio=0, mlp_dim=1024,
                 dilation=2, stride_in_1x1=True, base_stage=2, advanced_stage=0,
                 base_num=75, advanced_num=15, embed_dim=64, groups=16,
                 dtype=torch.float32, device=None, norm="frozen_bn"):
        super().__init__(depth, reduce_channel, resolution, spatial_scale,
                         sampling_ratio, dilation, stride_in_1x1, dtype, device, norm)
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

    def _stages(self, x, x_refs, cur_rois, ref_rois, ref_valid,
                skip_first_fc: bool = False, precise: bool = False):
        """The base stages and the optional advanced stage. x (L, N, ·) the
        current ROIs' pooled features (each stage applies its fc first), or,
        with ``skip_first_fc``, features with fcs_0 applied; x_refs (L, M, D)
        fc0 features of the refs, M = T * base_num in frame blocks;
        cur_rois (L, N, 4), ref_rois (L, M, 4), ref_valid (L, M); ``precise``
        passes ``precise_bias`` to every attention → (L, N, D). Spans
        ``rdn_base`` (the base stages) and ``rdn_advanced`` (the
        distillation, the advanced stage and the last attention)."""
        with annotate("rdn_base"):
            for i in range(self.base_stage):
                if not (skip_first_fc and i == 0):
                    x = self._fc(i, x)
                x = x + self.attn(i)(x, x_refs, ref_valid, pos_rois=(cur_rois, ref_rois),
                                     precise_bias=precise)
        if self.advanced_stage == 0:
            return x
        with annotate("rdn_advanced"):
            # the top advanced_num refs of each frame, which relies on the RPN's
            # NMS emitting each frame's proposals in descending score order
            t = x_refs.shape[1] // self.base_num
            refs_adv, rois_adv, valid_adv = (
                distill(a, t, self.base_num, self.advanced_num)
                for a in (x_refs, ref_rois, ref_valid))
            for i in range(self.advanced_stage):
                j = self.base_stage + i
                att = self.attn(j)(refs_adv, x_refs, ref_valid, pos_rois=(rois_adv, ref_rois),
                                   precise_bias=precise)
                refs_adv = self._fc(j, refs_adv + att)
            last = self.attn(self.base_stage + self.advanced_stage)
            return x + last(x, refs_adv, valid_adv, pos_rois=(cur_rois, rois_adv),
                            precise_bias=precise)

    def extract_train(self, maps, key_rois, ref_rois, ref_valid):
        """One training sample: C4 maps (F, h, w, 1024), frame 0 the current
        one; its subsampled ROIs key_rois (N, 4); every frame's ref
        proposals ref_rois (F, base_num, 4) with validity (F, base_num) →
        (1, N, D) f32, one lane."""
        enhanced = self.enhance_features(maps)
        x = self.pool_flat(enhanced[:1], key_rois[None])
        x_refs = self.fc0(self.pool_flat(enhanced, ref_rois).reshape(1, -1, self.flat_dim))
        return self._stages(x, x_refs, key_rois[None], ref_rois.reshape(1, -1, 4),
                            ref_valid.reshape(1, -1), precise=True)

    def extract_test(self, x, cur_rois, ref_rois, ref_valid, ref_feats):
        """x (L, K, D) key ROI features with fcs_0 applied, cur_rois (L, K, 4),
        the window's refs ref_rois (L, T*base_num, 4), ref_valid
        (L, T*base_num), ref_feats (L, T*base_num, D) fc0 features →
        (L, K, D)."""
        return self._stages(x, ref_feats, cur_rois, ref_rois, ref_valid, skip_first_fc=True)
