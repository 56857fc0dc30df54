"""Mask and keypoint heads of the image detector zoo (counterpart of
``mega_pytorch_tpu/models/roi_heads/mask_head.py``; maskrcnn-benchmark's
``mask_head/`` and ``keypoint_head/``): extractors, predictors, losses and
inference. Feature maps (B, H, W, C) and ROIs (B, R, 4); each image is a
lane of ``roi_align``. Module names are the flax scopes'.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.roi_align import roi_align
from ..layers import Conv, ConvTranspose


class _PooledConvs(nn.Module):
    """ROIAlign at ``resolution``, then 3x3 convs with relu named
    ``{prefix}{i}`` from 1: (B, R, res, res, C) in the compute dtype."""

    def __init__(self, prefix, in_channels, layers, resolution, spatial_scale,
                 sampling_ratio, dtype, device):
        super().__init__()
        self.prefix, self.count = prefix, len(layers)
        self.resolution, self.spatial_scale = resolution, spatial_scale
        self.sampling_ratio = sampling_ratio
        for i, ch in enumerate(layers):
            setattr(self, f"{prefix}{i + 1}",
                    Conv(in_channels, ch, 3, padding=1, dtype=dtype, device=device))
            in_channels = ch
        self.out_channels = in_channels

    def forward(self, feat_map: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        res = self.resolution
        pooled = roi_align(feat_map, rois, self.spatial_scale, res, res, self.sampling_ratio)
        b, r = pooled.shape[:2]
        x = pooled.reshape(b * r, res, res, -1).permute(0, 3, 1, 2)
        for i in range(self.count):
            x = torch.relu(getattr(self, f"{self.prefix}{i + 1}")(x))
        return x.permute(0, 2, 3, 1).reshape(b, r, res, res, -1)


class MaskRCNNFPNFeatureExtractor(_PooledConvs):
    """Pool 14x14, then 4 3x3 convs ``mask_fcn1..4`` of 256."""

    def __init__(self, in_channels, resolution=14, spatial_scale=1.0 / 16,
                 sampling_ratio=0, layers=(256, 256, 256, 256), dtype=torch.float32,
                 device=None):
        super().__init__("mask_fcn", in_channels, layers, resolution, spatial_scale,
                         sampling_ratio, dtype, device)


class KeypointRCNNFeatureExtractor(_PooledConvs):
    """Pool 14x14, then 8 3x3 convs ``conv_fcn1..8`` of 512."""

    def __init__(self, in_channels, resolution=14, spatial_scale=1.0 / 16,
                 sampling_ratio=0, layers=(512,) * 8, dtype=torch.float32, device=None):
        super().__init__("conv_fcn", in_channels, layers, resolution, spatial_scale,
                         sampling_ratio, dtype, device)


class MaskRCNNC4Predictor(nn.Module):
    """``conv5_mask`` (2x2/2 transposed conv, relu), then the 1x1
    ``mask_fcn_logits``: (B, R, res, res, C) → (B, R, 2 res, 2 res,
    num_classes) f32."""

    def __init__(self, in_channels, num_classes=81, dim_reduced=256, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.conv5_mask = ConvTranspose(in_channels, dim_reduced, 2, stride=2, dtype=dtype,
                                        device=device)
        self.mask_fcn_logits = Conv(dim_reduced, num_classes, 1, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, r = x.shape[:2]
        y = x.reshape(b * r, *x.shape[2:]).permute(0, 3, 1, 2)
        y = self.mask_fcn_logits(torch.relu(self.conv5_mask(y)))
        return y.permute(0, 2, 3, 1).reshape(b, r, *y.shape[2:], -1).float()


class KeypointRCNNPredictor(nn.Module):
    """``kps_score_lowres`` (4x4/2 transposed conv, flax "SAME": padding 1,
    2x), then a 2x bilinear upsample in f32 (``jax.image.resize``, half-pixel
    centres): (B, R, res, res, C) → (B, R, 4 res, 4 res, K) f32."""

    def __init__(self, in_channels, num_keypoints=17, dtype=torch.float32, device=None):
        super().__init__()
        self.kps_score_lowres = ConvTranspose(in_channels, num_keypoints, 4, stride=2,
                                              dtype=dtype, device=device, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, r = x.shape[:2]
        y = self.kps_score_lowres(x.reshape(b * r, *x.shape[2:]).permute(0, 3, 1, 2))
        y = F.interpolate(y.float(), scale_factor=2, mode="bilinear", align_corners=False)
        return y.permute(0, 2, 3, 1).reshape(b, r, *y.shape[2:], -1)


def _own_class(mask_logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(B, R, S, S, C) logits at each ROI's label → (B, R, S, S)."""
    idx = labels.long()[:, :, None, None, None].expand(*mask_logits.shape[:4], 1)
    return torch.gather(mask_logits, -1, idx)[..., 0]


def maskrcnn_loss(mask_logits, mask_targets, labels, valid) -> torch.Tensor:
    """Binary cross-entropy of each positive ROI's own-class mask, averaged
    over its pixels, then over the positives: logits (B, R, S, S, C),
    targets (B, R, S, S), labels (B, R), valid (B, R) (positives only)."""
    sel = _own_class(mask_logits, labels)
    bce = -(mask_targets * F.logsigmoid(sel) + (1 - mask_targets) * F.logsigmoid(-sel))
    per_roi = bce.mean(dim=(-2, -1))
    return (per_roi * valid).sum() / valid.sum().clamp_min(1)


def maskrcnn_inference(mask_logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each detection's own-class mask probabilities (B, R, S, S)."""
    return torch.sigmoid(_own_class(mask_logits, labels))


def keypointrcnn_loss(kp_logits, kp_targets, kp_visible) -> torch.Tensor:
    """Spatial softmax cross-entropy at the visible keypoints: logits
    (B, R, S, S, K), targets (B, R, K) heatmap indices in [0, S * S),
    visible (B, R, K)."""
    b, r, s, _, k = kp_logits.shape
    flat = kp_logits.reshape(b, r, s * s, k).transpose(2, 3)  # (B, R, K, S*S)
    logp = F.log_softmax(flat, dim=-1)
    ce = -torch.gather(logp, -1, kp_targets.long()[..., None])[..., 0]
    return (ce * kp_visible).sum() / kp_visible.sum().clamp_min(1)


def keypointrcnn_inference(kp_logits: torch.Tensor, rois: torch.Tensor):
    """Each heatmap's first maximum → image (x, y) in its ROI: (B, R, K, 2)
    and the maxima (B, R, K)."""
    b, r, s, _, k = kp_logits.shape
    flat = kp_logits.reshape(b, r, s * s, k)
    scores, idx = flat.amax(dim=2), flat.argmax(dim=2)
    ys = (idx // s).float() + 0.5
    xs = (idx % s).float() + 0.5
    w = rois[..., 2] - rois[..., 0] + 1.0
    h = rois[..., 3] - rois[..., 1] + 1.0
    x_img = rois[..., 0:1] + xs / s * w[..., None]
    y_img = rois[..., 1:2] + ys / s * h[..., None]
    return torch.stack([x_img, y_img], dim=-1), scores
