"""Box predictor (counterpart of ``mega_pytorch_tpu/models/roi_heads/predictors.py``)."""

from __future__ import annotations

import torch
from torch import nn

from ..layers import Dense


class FPNPredictor(nn.Module):
    """Linear class and box heads on flat ROI features."""

    def __init__(self, in_features=1024, num_classes=31, cls_agnostic_bbox_reg=False,
                 dtype=torch.float32, device=None):
        super().__init__()
        num_reg = 2 if cls_agnostic_bbox_reg else num_classes
        self.cls_score = Dense(in_features, num_classes, dtype, 0.01, device)
        self.bbox_pred = Dense(in_features, num_reg * 4, dtype, 0.001, device)

    def forward(self, x: torch.Tensor):
        """x (..., D) → logits (..., C) f32, deltas (..., 4C) f32."""
        return self.cls_score(x).float(), self.bbox_pred(x).float()
