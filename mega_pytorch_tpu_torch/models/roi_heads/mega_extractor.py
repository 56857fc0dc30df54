"""MEGA feature extractor, streaming inference (counterpart of
``mega_pytorch_tpu/models/roi_heads/mega_extractor.py``): dilated res5 +
1x1 reduce, ROIAlign + fc0, the merged global enhancement, the local/memory
attention stages with the long-range-memory pushes, and the global residual
stages. Every tensor has a leading lane dimension (the JAX module runs per
lane under vmap), so ROI sets concatenate along dim 1. ``extract_train`` is
not ported."""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ...ops.roi_align import roi_align
from ..backbone.resnet import ResNetRes5Head, nchw, nhwc
from ..layers import Conv, Dense
from .attention import RelationAttention


class RefSet(NamedTuple):
    rois: torch.Tensor  # (L, M, 4)
    feats: torch.Tensor  # (L, M, D)
    valid: torch.Tensor  # (L, M)


def cat_refs(a: RefSet, b: RefSet) -> RefSet:
    return RefSet(*(torch.cat([x, y], 1) for x, y in zip(a, b)))


class MEGAFeatureExtractor(nn.Module):
    def __init__(self, depth="R-101", reduce_channel=False, resolution=7,
                 spatial_scale=1.0 / 16, sampling_ratio=0, mlp_dim=1024,
                 dilation=2, stride_in_1x1=True, stage=3, base_num=75,
                 advanced_num=15, embed_dim=64, groups=16, global_enable=True,
                 global_res_stage=1, dtype=torch.float32, device=None):
        super().__init__()
        self.reduce_channel, self.resolution = reduce_channel, resolution
        self.spatial_scale, self.sampling_ratio = spatial_scale, sampling_ratio
        self.stage, self.base_num, self.advanced_num = stage, base_num, advanced_num
        self.global_enable, self.global_res_stage = global_enable, global_res_stage
        self.dtype = dtype
        self.head = ResNetRes5Head(depth, 1, dilation, stride_in_1x1, dtype, device)
        in_ch = 2048
        if reduce_channel:
            self.conv = Conv(2048, 256, 1, dtype=dtype, device=device)
            in_ch = 256
        flat = in_ch * resolution * resolution
        for i in range(stage):
            setattr(self, f"l_fcs_{i}", Dense(flat if i == 0 else mlp_dim, mlp_dim,
                                              dtype, device=device))
            setattr(self, f"l_attn_{i}", RelationAttention(
                mlp_dim, embed_dim, groups, True, dtype, device))
        if global_enable:
            for i in range(global_res_stage + 1):
                setattr(self, f"g_attn_{i}", RelationAttention(
                    mlp_dim, embed_dim, groups, False, dtype, device))

    def l_fcs(self, i: int) -> Dense:
        return getattr(self, f"l_fcs_{i}")

    def l_attn(self, i: int) -> RelationAttention:
        return getattr(self, f"l_attn_{i}")

    def g_attn(self, i: int) -> RelationAttention:
        return getattr(self, f"g_attn_{i}")

    def enhance_features(self, c4: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 1024) → (B, H, W, C) NHWC."""
        x = self.head(c4)
        if self.reduce_channel:
            x = nhwc(torch.relu(self.conv(nchw(x))))
        return x

    def pool_flat(self, feat_map: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        """(L, H, W, C) maps, (L, R, 4) rois → (L, R, res*res*C) f32, (h, w, c)
        order."""
        pooled = roi_align(feat_map.float(), rois, self.spatial_scale,
                           self.resolution, self.resolution, self.sampling_ratio)
        return pooled.flatten(2)

    def fc0(self, flat: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.l_fcs(0)(flat).float())

    def _distill(self, arr: torch.Tensor, frames: int) -> torch.Tensor:
        """(L, frames * base_num, ...) → the top advanced_num of each base_num
        block (score-ordered slots), (L, frames * advanced_num, ...)."""
        lanes, _, *rest = arr.shape
        blocks = arr.reshape(lanes, frames, self.base_num, *rest)
        return blocks[:, :, :self.advanced_num].reshape(
            lanes, frames * self.advanced_num, *rest)

    def update_lm(self, feats, g_feats, g_valid, index: int = 0):
        return feats + self.g_attn(index)(feats, g_feats, g_valid)

    def _local_attend(self, i, cur_rois, cur_feats, refs: RefSet, last: bool):
        att = self.l_attn(i)(cur_feats, refs.feats, refs.valid,
                             pos_rois=(cur_rois, refs.rois))
        feats = cur_feats + att
        if not last:
            feats = torch.relu(self.l_fcs(i + 1)(feats).float())
        return feats

    def precompute_ref(self, c4: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        """(L, H, W, 1024) C4 maps, one frame per lane → pooled fc0 features
        of rois (L, R, 4)."""
        return self.fc0(self.pool_flat(self.enhance_features(c4), rois))

    def extract_test(self, x, cur_rois, window: RefSet, lrm: tuple, g_feats, g_valid):
        """x (L, K, D) key ROI features, cur_rois (L, K, 4), window
        (L, T*base_num) refs, lrm per-stage RefSets, global cache
        (L, Gsize*base_num) → (x, per-stage RefSets pushed into the LRM this
        frame)."""
        t = window.rois.shape[1] // self.base_num
        if self.global_enable:
            # one merged global-enhance call for the key set and the window
            n_q = x.shape[1]
            both = self.update_lm(torch.cat([x, window.feats], 1), g_feats, g_valid)
            x, x_ref = both[:, :n_q], both[:, n_q:]
            x_ref_dis = self._distill(x_ref, t)
        else:
            x_ref = window.feats
            x_ref_dis = self._distill(window.feats, t)
        rois_dis = self._distill(window.rois, t)
        val_dis = self._distill(window.valid, t)
        n_key = cur_rois.shape[1]
        cur_rois_full = torch.cat([cur_rois, rois_dis], 1)
        feats = torch.cat([x, x_ref_dis], 1)

        pushes = []
        for i in range(self.stage):
            last = i == self.stage - 1
            if i == 0:
                refs = RefSet(window.rois, x_ref, window.valid)
                cur_r, push_n = cur_rois_full, self.base_num
            elif not last:
                refs = RefSet(rois_dis, feats[:, n_key:], val_dis)
                cur_r, push_n = cur_rois_full, self.advanced_num
            else:
                refs = RefSet(rois_dis, feats[:, n_key:], val_dis)
                cur_r, push_n = cur_rois, self.advanced_num
                feats = feats[:, :n_key]
            # the memory takes the OLDEST frame's refs, before this stage attends
            pushes.append(RefSet(*(a[:, :push_n] for a in refs)))
            refs = cat_refs(refs, lrm[i])
            feats = self._local_attend(i, cur_r, feats, refs, last)

        x = feats
        if self.global_enable:
            for i in range(self.global_res_stage):
                x = self.update_lm(x, g_feats, g_valid, index=i + 1)
        return x, tuple(pushes)
