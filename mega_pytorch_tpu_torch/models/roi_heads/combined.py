"""Mask and keypoint branches beside the box head (counterpart of
``mega_pytorch_tpu/models/roi_heads/combined.py``; maskrcnn-benchmark's
``roi_heads.py`` behind MODEL.MASK_ON / KEYPOINT_ON, image detectors only).

Ground truth arrives as dense per-instance binary masks (rasterised once,
``structures/segmentation.py``), and each ROI's target is ROIAlign of its
matched instance's mask at ``sampling_ratio`` 2, thresholded at 0.5, as in
the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.roi_align import roi_align
from .mask_head import (
    KeypointRCNNFeatureExtractor,
    KeypointRCNNPredictor,
    MaskRCNNC4Predictor,
    MaskRCNNFPNFeatureExtractor,
    maskrcnn_inference,
    maskrcnn_loss,
)
from .subsample import SampledRois


def mask_targets_from_dense(gt_masks: torch.Tensor, matched_gt: torch.Tensor,
                            rois: torch.Tensor, mask_size: int = 28,
                            mask_scale: float = 1.0) -> torch.Tensor:
    """One image: instance masks (G, Hm, Wm), each ROI's matched instance
    (R,), ROIs (R, 4) in image coordinates (the masks at ``mask_scale`` of
    them) → (R, mask_size, mask_size) binary f32 targets. Every ROI is its
    own lane of ``roi_align``, over its instance's mask."""
    sel = gt_masks[matched_gt.long()][..., None].float()  # (R, Hm, Wm, 1)
    pooled = roi_align(sel, rois[:, None], mask_scale, mask_size, mask_size,
                       sampling_ratio=2)
    return (pooled[:, 0, ..., 0] > 0.5).float()


class CombinedROIHeads(nn.Module):
    """The mask branch (``mask``, ``mask_predictor``) and the keypoint branch
    (``keypoint``, ``keypoint_predictor``) over one feature map (B, H, W,
    ``in_channels``) and the box branch's ROIs (B, R, 4)."""

    def __init__(self, in_channels, mask_on=False, keypoint_on=False, num_classes=81,
                 num_keypoints=17, mask_resolution=14, spatial_scale=1.0 / 16,
                 dtype=torch.float32, device=None):
        super().__init__()
        if mask_on:
            self.mask = MaskRCNNFPNFeatureExtractor(
                in_channels, mask_resolution, spatial_scale, dtype=dtype, device=device)
            self.mask_predictor = MaskRCNNC4Predictor(
                self.mask.out_channels, num_classes, dtype=dtype, device=device)
        if keypoint_on:
            self.keypoint = KeypointRCNNFeatureExtractor(
                in_channels, spatial_scale=spatial_scale, dtype=dtype, device=device)
            self.keypoint_predictor = KeypointRCNNPredictor(
                self.keypoint.out_channels, num_keypoints, dtype=dtype, device=device)

    def mask_logits(self, feat_map: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        """→ (B, R, 2 res, 2 res, num_classes) f32."""
        return self.mask_predictor(self.mask(feat_map, rois))

    def mask_losses(self, feat_map: torch.Tensor, rois: SampledRois, gt_masks: torch.Tensor,
                    matched_gt: torch.Tensor, mask_scale: float = 1.0) -> dict:
        """Sampled ROIs, instance masks (B, G, Hm, Wm) and each ROI's matched
        instance (B, R) → {"loss_mask"} over the positive ROIs."""
        logits = self.mask_logits(feat_map, rois.boxes)
        size = logits.shape[2]
        targets = torch.stack([
            mask_targets_from_dense(m, i, r, size, mask_scale)
            for m, i, r in zip(gt_masks, matched_gt, rois.boxes)])
        positives = rois.valid & (rois.labels > 0)
        return {"loss_mask": maskrcnn_loss(logits, targets, rois.labels, positives)}

    def mask_probs(self, feat_map, det_boxes, det_labels) -> torch.Tensor:
        """Each detection's own-class mask probabilities (B, R, S, S)."""
        return maskrcnn_inference(self.mask_logits(feat_map, det_boxes), det_labels)

    def keypoint_logits(self, feat_map, rois) -> torch.Tensor:
        """→ (B, R, 56, 56, num_keypoints) f32 heatmaps."""
        return self.keypoint_predictor(self.keypoint(feat_map, rois))
