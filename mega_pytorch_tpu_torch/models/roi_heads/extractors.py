"""ROI box feature extractors of the single-frame heads (counterpart of
``mega_pytorch_tpu/models/roi_heads/extractors.py``). Maps and ROIs lead
with the lane dimension.

- ``ResNetConv52MLPFeatureExtractor``, the VID heads' extractor: res5 on
  the whole C4 map (stride 1, dilation 2), the optional 1x1 channel
  reduce, ROIAlign, then fc6 and fc7.
- ``ResNet50Conv5ROIFeatureExtractor``, maskrcnn-benchmark's classic C4
  box head (its default ``ROI_BOX_HEAD``): ROIAlign of 14x14 bins on the
  C4 map, then res5 with stride 2 on each ROI, (L, R, 7, 7, 2048). As in
  the JAX package, no detector builds it.
"""

from __future__ import annotations

import torch

from ...ops.roi_align import roi_align
from ..backbone.resnet import ResNetRes5Head
from ..layers import Dense
from .mega_extractor import Res5Pooler


class ResNetConv52MLPFeatureExtractor(Res5Pooler):
    def __init__(self, depth="R-50", reduce_channel=True, resolution=7,
                 spatial_scale=1.0 / 16, sampling_ratio=0, mlp_dim=1024,
                 dilation=2, stride_in_1x1=True, dtype=torch.float32, device=None,
                 norm="frozen_bn"):
        super().__init__(depth, reduce_channel, resolution, spatial_scale,
                         sampling_ratio, dilation, stride_in_1x1, dtype, device, norm)
        self.fc6 = Dense(self.flat_dim, mlp_dim, dtype, device=device)
        self.fc7 = Dense(mlp_dim, mlp_dim, dtype, device=device)

    def pool_and_fc(self, feat_map: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        """(L, H, W, C) maps, (L, R, 4) rois → (L, R, mlp_dim) f32."""
        x = torch.relu(self.fc6(self.pool_flat(feat_map, rois)))
        return torch.relu(self.fc7(x)).float()

    def forward(self, c4: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        """(L, H, W, 1024) C4 maps, (L, R, 4) rois → (L, R, mlp_dim) f32."""
        return self.pool_and_fc(self.enhance_features(c4), rois)


class ResNet50Conv5ROIFeatureExtractor(torch.nn.Module):
    """ROIAlign at ``resolution`` (14) bins, then res5 (``head``) with
    stride 2 on every ROI; NHWC in and out."""

    out_channels = 2048

    def __init__(self, depth="R-50", resolution=14, spatial_scale=1.0 / 16,
                 sampling_ratio=0, dilation=1, stride_in_1x1=True, dtype=torch.float32,
                 device=None, norm="frozen_bn"):
        super().__init__()
        self.resolution, self.spatial_scale = resolution, spatial_scale
        self.sampling_ratio, self.dtype = sampling_ratio, dtype
        self.head = ResNetRes5Head(depth, 2, dilation, stride_in_1x1, dtype, device, norm)

    def forward(self, c4: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        """(L, H, W, 1024) C4 maps, (L, R, 4) rois → (L, R, r/2, r/2, 2048) f32."""
        pooled = roi_align(c4.float(), rois, self.spatial_scale, self.resolution,
                           self.resolution, self.sampling_ratio)
        lanes, r = pooled.shape[:2]
        x = self.head(pooled.flatten(0, 1).to(self.dtype))
        return x.reshape(lanes, r, *x.shape[1:]).float()
