"""MEGA feature extractor (counterpart of
``mega_pytorch_tpu/models/roi_heads/mega_extractor.py``): dilated res5 +
1x1 reduce, ROIAlign + fc0, the merged global enhancement, the local/memory
attention stages with the long-range-memory pushes, and the global residual
stages (streaming, ``extract_test``); the three training frame pools
(``extract_train``). Every tensor has a leading lane dimension (the JAX
module runs per lane under vmap), so ROI sets concatenate along dim 1."""

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


def distill(arr: torch.Tensor, frames: int, base_num: int,
            advanced_num: int) -> torch.Tensor:
    """(L, frames * base_num, ...) → the top ``advanced_num`` of each
    ``base_num`` block (score-ordered slots), (L, frames * advanced_num, ...)."""
    lanes, _, *rest = arr.shape
    blocks = arr.reshape(lanes, frames, base_num, *rest)
    return blocks[:, :, :advanced_num].reshape(lanes, frames * advanced_num, *rest)


class Res5Pooler(nn.Module):
    """What the video heads' extractors share: res5 on the whole C4 map
    (stride 1, dilated) with the optional 1x1 reduce, and ROIAlign of its
    output flattened in (h, w, c) order (``flat_dim`` columns)."""

    def __init__(self, depth, reduce_channel, resolution, spatial_scale,
                 sampling_ratio, dilation, stride_in_1x1, dtype, device, norm="frozen_bn"):
        super().__init__()
        self.reduce_channel, self.resolution = reduce_channel, resolution
        self.spatial_scale, self.sampling_ratio = spatial_scale, sampling_ratio
        self.dtype = dtype
        self.head = ResNetRes5Head(depth, 1, dilation, stride_in_1x1, dtype, device, norm)
        in_ch = 2048
        if reduce_channel:
            self.conv = Conv(2048, 256, 1, dtype=dtype, device=device)
            in_ch = 256
        self.flat_dim = in_ch * resolution * resolution

    def enhance_features(self, c4: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 1024) → (B, H, W, C) NHWC."""
        x = self.head(c4)
        if self.reduce_channel:
            x = nhwc(torch.relu(self.conv(nchw(x))))
        return x

    def pool_flat(self, feat_map: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        """(L, H, W, C) maps, (L, R, 4) rois → (L, R, res*res*C) in the compute
        dtype, which the fc that takes them casts to anyway, (h, w, c) order."""
        pooled = roi_align(feat_map, rois, self.spatial_scale, self.resolution,
                           self.resolution, self.sampling_ratio, out_dtype=self.dtype)
        return pooled.flatten(2)


class MEGAFeatureExtractor(Res5Pooler):
    def __init__(self, depth="R-101", reduce_channel=False, resolution=7,
                 spatial_scale=1.0 / 16, sampling_ratio=0, mlp_dim=1024,
                 dilation=2, stride_in_1x1=True, stage=3, base_num=75,
                 advanced_num=15, embed_dim=64, groups=16, global_enable=True,
                 global_res_stage=1, dtype=torch.float32, device=None, norm="frozen_bn"):
        super().__init__(depth, reduce_channel, resolution, spatial_scale,
                         sampling_ratio, dilation, stride_in_1x1, dtype, device, norm)
        self.stage, self.base_num, self.advanced_num = stage, base_num, advanced_num
        self.global_enable, self.global_res_stage = global_enable, global_res_stage
        for i in range(stage):
            setattr(self, f"l_fcs_{i}", Dense(self.flat_dim if i == 0 else mlp_dim,
                                              mlp_dim, dtype, device=device))
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

    def fc0(self, flat: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.l_fcs(0)(flat).float())

    def _distill(self, arr: torch.Tensor, frames: int) -> torch.Tensor:
        return distill(arr, frames, self.base_num, self.advanced_num)

    def update_lm(self, feats, g_feats, g_valid, index: int = 0):
        return feats + self.g_attn(index)(feats, g_feats, g_valid)

    def _local_attend(self, i, cur_rois, cur_feats, refs: RefSet, last: bool,
                      precise: bool = False):
        """One local/memory stage: attention, the residual and, unless
        ``last``, the next stage's fc; ``precise`` on the train paths (the
        f32-sinusoid bias, see ``RelationAttention``)."""
        att = self.l_attn(i)(cur_feats, refs.feats, refs.valid,
                             pos_rois=(cur_rois, refs.rois), precise_bias=precise)
        feats = cur_feats + att
        if not last:
            feats = torch.relu(self.l_fcs(i + 1)(feats).float())
        return feats

    # -- training -------------------------------------------------------------
    def extract_train(self, maps_l, maps_m, maps_g, key_rois, l_rois, l_valid,
                      m_rois, m_valid, g_rois, g_valid):
        """One training sample. C4 maps of the three frame pools (F, h, w,
        1024), cur first in ``maps_l``; the subsampled key ROIs of cur (N, 4);
        each pool's ref proposals (F, base_num, 4) with validity (F,
        base_num) → (1, N, D) f32 features of the key ROIs.

        The global pool is differentiable; the memory pool (its features,
        global enhancement and stage-wise self-enhancement, whose
        intermediate refs become the per-stage memories) runs without
        gradient; the local stack attends to [local refs + memory i] at
        stage i. Every position-bias stage takes ``precise_bias``."""
        def flat(x):  # (F, R, ...) → (1, F * R, ...): one lane
            return x.reshape(1, -1, *x.shape[2:])

        g_feats = g_val = None
        if self.global_enable:
            g_feats = self.fc0(flat(self.pool_flat(self.enhance_features(maps_g), g_rois)))
            g_val = flat(g_valid)

        with torch.no_grad():
            fm = m_rois.shape[0]
            x_m = self.fc0(flat(self.pool_flat(self.enhance_features(maps_m), m_rois)))
            if self.global_enable:
                x_m = self.update_lm(x_m, g_feats, g_val)
            m_rois_flat, m_val_flat = flat(m_rois), flat(m_valid)
            m_rois_dis = self._distill(m_rois_flat, fm)
            m_val_dis = self._distill(m_val_flat, fm)
            mem = [RefSet(m_rois_flat, x_m, m_val_flat)]
            feats = self._distill(x_m, fm)
            for i in range(self.stage - 1):
                feats = self._local_attend(i, m_rois_dis, feats, mem[i], last=False,
                                           precise=True)
                mem.append(RefSet(m_rois_dis, feats, m_val_dis))

        fl = l_rois.shape[0]
        enhanced_l = self.enhance_features(maps_l)
        x_key = self.fc0(self.pool_flat(enhanced_l[:1], key_rois[None]))
        x_l = self.fc0(flat(self.pool_flat(enhanced_l, l_rois)))
        n_key = key_rois.shape[0]
        if self.global_enable:
            # one merged call: update_lm is per-row
            both = self.update_lm(torch.cat([x_key, x_l], 1), g_feats, g_val)
            x_key, x_l = both[:, :n_key], both[:, n_key:]
        l_rois_flat, l_val_flat = flat(l_rois), flat(l_valid)
        rois_dis = self._distill(l_rois_flat, fl)
        val_dis = self._distill(l_val_flat, fl)
        cur_rois_full = torch.cat([key_rois[None], rois_dis], 1)
        feats = torch.cat([x_key, self._distill(x_l, fl)], 1)

        for i in range(self.stage):
            last = i == self.stage - 1
            cur_rois = cur_rois_full
            if i == 0:
                refs = RefSet(l_rois_flat, x_l, l_val_flat)
            else:
                refs = RefSet(rois_dis, feats[:, n_key:], val_dis)
                if last:
                    cur_rois, feats = key_rois[None], feats[:, :n_key]
            feats = self._local_attend(i, cur_rois, feats, cat_refs(refs, mem[i]),
                                       last=last, precise=True)

        x = feats
        if self.global_enable:
            for i in range(self.global_res_stage):
                x = self.update_lm(x, g_feats, g_val, index=i + 1)
        return x

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
