"""Training-time proposal subsampling and the Fast R-CNN losses (counterpart
of ``mega_pytorch_tpu/models/roi_heads/subsample.py``): IoU matcher (0.5 /
0.5, no low-quality matches), per-proposal class labels (0 background, -1
ignore), (10, 10, 5, 5) regression targets, balanced 128 @ 0.25 sampling,
then cross-entropy and per-class smooth-L1 (beta 1) over the sampled count.

Shapes stay static: each image always gives exactly ``batch_size_per_image``
slots, the sampled proposals first in an order set by uniform tiebreaks (a
stable descending sort of sampled * 2 + tiebreak, as ``lax.top_k``), with a
slot-validity mask."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ...ops.box_coder import BoxCoder
from ...ops.losses import smooth_l1_loss
from ...structures.boxes import box_iou
from ..matcher import BELOW_LOW_THRESHOLD, match
from ..sampler import balanced_sample


class SampledRois(NamedTuple):
    boxes: torch.Tensor  # (B, S, 4)
    valid: torch.Tensor  # (B, S) bool
    labels: torch.Tensor  # (B, S) int64: 0 background, >= 1 class
    reg_targets: torch.Tensor  # (B, S, 4)


def subsample_proposals(prop_boxes, prop_valid, gt_boxes, gt_labels, gt_valid,
                        generator: torch.Generator | None = None,
                        bbox_reg_weights=(10.0, 10.0, 5.0, 5.0),
                        batch_size_per_image: int = 128, positive_fraction: float = 0.25,
                        fg_iou: float = 0.5, bg_iou: float = 0.5,
                        uniforms: tuple | None = None) -> SampledRois:
    """prop_boxes (B, K, 4), prop_valid (B, K), gt_* (B, G, ...) →
    ``SampledRois`` of (B, batch_size_per_image) slots. The random draws, the
    sampler's (B, 2, K) uniforms and the (B, K) tiebreaks, come from
    ``generator`` unless ``uniforms`` gives the pair."""
    iou = box_iou(gt_boxes, prop_boxes)  # (B, G, K)
    iou = torch.where(prop_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    matched = match(iou, gt_valid, fg_iou, bg_iou, allow_low_quality_matches=False)
    idx = matched.clamp_min(0)
    labels = torch.where(matched >= 0, torch.gather(gt_labels.long(), 1, idx),
                         torch.where(matched == BELOW_LOW_THRESHOLD,
                                     torch.zeros_like(idx), torch.full_like(idx, -1)))
    labels = torch.where(prop_valid, labels, torch.full_like(labels, -1))
    matched_gt = torch.gather(gt_boxes, 1, idx[..., None].expand(-1, -1, 4))
    reg_targets = BoxCoder(bbox_reg_weights).encode(matched_gt, prop_boxes)

    sample_u, tiebreak = (None, None) if uniforms is None else uniforms
    pos_mask, neg_mask = balanced_sample(labels, batch_size_per_image, positive_fraction,
                                         generator, sample_u)
    sampled = pos_mask | neg_mask
    if tiebreak is None:
        tiebreak = torch.rand(sampled.shape, generator=generator, device=sampled.device)
    priority = sampled.float() * 2.0 + tiebreak
    slot = torch.sort(priority, dim=-1, descending=True, stable=True).indices
    slot = slot[:, :batch_size_per_image]
    slot_valid = torch.gather(sampled, 1, slot)
    slot_labels = torch.gather(labels, 1, slot)
    return SampledRois(
        torch.gather(prop_boxes, 1, slot[..., None].expand(-1, -1, 4)),
        slot_valid,
        torch.where(slot_valid, slot_labels, torch.zeros_like(slot_labels)),
        torch.gather(reg_targets, 1, slot[..., None].expand(-1, -1, 4)),
    )


def fastrcnn_loss(class_logits: torch.Tensor, box_regression: torch.Tensor,
                  rois: SampledRois, cls_agnostic_bbox_reg: bool = False):
    """class_logits (B, S, C), box_regression (B, S, 4C) → (classification,
    box) losses, each over the count of sampled slots."""
    num_sampled = rois.valid.sum().clamp_min(1)
    logp = F.log_softmax(class_logits, dim=-1)
    ce = -torch.gather(logp, -1, rois.labels[..., None])[..., 0]
    classification_loss = (ce * rois.valid).sum() / num_sampled
    if cls_agnostic_bbox_reg:
        reg = box_regression[..., 4:8]
    else:
        idx = rois.labels[..., None] * 4 + torch.arange(4, device=rois.labels.device)
        reg = torch.gather(box_regression, -1, idx)
    pos = rois.valid & (rois.labels > 0)
    sl1 = smooth_l1_loss(reg, rois.reg_targets, beta=1.0)
    box_loss = (sl1.sum(-1) * pos).sum() / num_sampled
    return classification_loss, box_loss
