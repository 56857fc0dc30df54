"""ROI box feature extractor of the single-frame heads (counterpart of
``mega_pytorch_tpu/models/roi_heads/extractors.py``,
``ResNetConv52MLPFeatureExtractor``): res5 on the whole C4 map (stride 1,
dilation 2), the optional 1x1 channel reduce, ROIAlign, then fc6 and fc7.
Maps and ROIs lead with the lane dimension."""

from __future__ import annotations

import torch

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
