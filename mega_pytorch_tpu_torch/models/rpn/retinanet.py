"""RetinaNet head, anchors, loss and inference (counterpart of
``mega_pytorch_tpu/models/rpn/retinanet.py``; maskrcnn-benchmark's
``rpn/retinanet/{retinanet,loss,inference}.py``): shared 4-conv class and
box towers over P3..P7, 3 octave scales x 3 ratios of anchors a cell, the
focal loss (alpha 0.25, gamma 2) and smooth-L1 (beta 0.11, weight 4) with a
0.5 / 0.4 matcher that promotes low-quality matches, and per level top-k,
score threshold, then class-aware NMS.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ...ops.box_coder import BoxCoder
from ...ops.losses import sigmoid_focal_loss, smooth_l1_loss
from ...ops.nms import nms
from ...structures.boxes import box_iou, clip_to_image
from ..backbone.resnet import nchw
from ..layers import Conv
from ..matcher import BELOW_LOW_THRESHOLD, match
from .anchors import generate_cell_anchors, grid_anchors

RETINA_CODER = BoxCoder(weights=(10.0, 10.0, 5.0, 5.0))


class RetinaNetHead(nn.Module):
    """``cls_tower_{i}`` and ``bbox_tower_{i}`` (3x3, relu) shared by every
    level, then ``cls_logits`` (A * C, bias at the prior probability) and
    ``bbox_pred`` (A * 4); kernels normal(0.01). NHWC levels → per level
    (B, H * W * A, C) logits and (B, H * W * A, 4) deltas in f32, in flax's
    NHWC order: anchor-minor within a cell."""

    def __init__(self, in_channels=256, num_classes=80, num_anchors=9, num_convs=4,
                 channels=256, prior_prob=0.01, dtype=torch.float32, device=None):
        super().__init__()
        self.num_classes, self.num_convs = num_classes, num_convs
        kw = dict(padding=1, dtype=dtype, init_std=0.01, device=device)
        for name in ("cls_tower", "bbox_tower"):
            for i in range(num_convs):
                setattr(self, f"{name}_{i}",
                        Conv(in_channels if i == 0 else channels, channels, 3, **kw))
        self.cls_logits = Conv(channels, num_anchors * num_classes, 3,
                               bias_init=-math.log((1 - prior_prob) / prior_prob), **kw)
        self.bbox_pred = Conv(channels, num_anchors * 4, 3, **kw)

    def forward(self, features: Sequence[torch.Tensor]):
        logits, bbox = [], []
        for f in features:
            t = u = nchw(f)
            for i in range(self.num_convs):
                t = torch.relu(getattr(self, f"cls_tower_{i}")(t))
                u = torch.relu(getattr(self, f"bbox_tower_{i}")(u))
            b = f.shape[0]
            logits.append(self.cls_logits(t).permute(0, 2, 3, 1).reshape(
                b, -1, self.num_classes).float())
            bbox.append(self.bbox_pred(u).permute(0, 2, 3, 1).reshape(b, -1, 4).float())
        return logits, bbox


def retinanet_anchors(shapes: Sequence[tuple[int, int]], sizes=(32, 64, 128, 256, 512),
                      strides=(8, 16, 32, 64, 128), ratios=(0.5, 1.0, 2.0),
                      octave: float = 2.0, scales_per_octave: int = 3,
                      device=None) -> list[torch.Tensor]:
    """Per level (H * W * A, 4) anchors with octave scales
    (``anchor_generator.py:146-166``)."""
    out = []
    for (h, w), size, stride in zip(shapes, sizes, strides):
        per_level = tuple(size * octave ** (i / scales_per_octave)
                          for i in range(scales_per_octave))
        cell = generate_cell_anchors(stride, per_level, ratios)
        out.append(torch.as_tensor(grid_anchors(h, w, stride, cell), device=device))
    return out


def retinanet_loss(anchors, logits, bbox_reg, gt_boxes, gt_labels, gt_valid,
                   fg_iou: float = 0.5, bg_iou: float = 0.4, alpha: float = 0.25,
                   gamma: float = 2.0, beta: float = 0.11, reg_weight: float = 4.0):
    """One image: anchors (A, 4) of every level, logits (A, C), bbox_reg
    (A, 4), padded ground truth (G, 4) / (G,) / (G,) → (focal loss,
    smooth-L1 loss), each over the number of positives (at least 1)."""
    matched = match(box_iou(gt_boxes, anchors), gt_valid, fg_iou, bg_iou,
                    allow_low_quality_matches=True)
    idx = matched.clamp_min(0)
    labels = torch.where(matched >= 0, gt_labels[idx].long(),
                         torch.where(matched == BELOW_LOW_THRESHOLD, 0, -1))
    pos = labels > 0
    num_pos = pos.sum().clamp_min(1)
    cls_loss = sigmoid_focal_loss(logits, labels, gamma, alpha).sum() / num_pos
    targets = RETINA_CODER.encode(gt_boxes[idx], anchors)
    reg = smooth_l1_loss(bbox_reg, targets, beta=beta)
    reg_loss = (reg.sum(-1) * pos).sum() / num_pos * reg_weight
    return cls_loss, reg_loss


def retinanet_inference(anchors_per_level, logits_per_level, bbox_per_level, im_size,
                        pre_nms_top_n: int = 1000, score_thresh: float = 0.05,
                        nms_thresh: float = 0.4, detections_per_img: int = 100):
    """One image: per level the ``pre_nms_top_n`` best (anchor, class)
    scores (ties in index order, as ``lax.top_k``: a stable descending
    sort), decoded and clipped to ``im_size`` (h, w), scores at or below
    ``score_thresh`` zeroed; then greedy NMS over every level with boxes
    offset by 1e5 * label, so classes never suppress each other →
    (boxes (D, 4), scores (D,), labels (D,), valid (D,))."""
    boxes_all, scores_all, labels_all = [], [], []
    for anchors, logits, deltas in zip(anchors_per_level, logits_per_level,
                                       bbox_per_level):
        num_classes = logits.shape[-1]
        probs = torch.sigmoid(logits).reshape(-1)
        k = min(pre_nms_top_n, probs.shape[0])
        top_p, top_i = torch.sort(probs, descending=True, stable=True)
        top_p, top_i = top_p[:k], top_i[:k]
        anchor_idx = top_i // num_classes
        decoded = RETINA_CODER.decode(deltas[anchor_idx], anchors[anchor_idx])
        boxes_all.append(clip_to_image(decoded, im_size[0], im_size[1]))
        scores_all.append(torch.where(top_p > score_thresh, top_p, top_p.new_zeros(())))
        labels_all.append(top_i % num_classes + 1)
    boxes = torch.cat(boxes_all)
    scores = torch.cat(scores_all)
    labels = torch.cat(labels_all)
    offsets = labels.float()[:, None] * 1e5
    keep_idx, keep_valid = nms((boxes + offsets)[None], scores[None], (scores > 0)[None],
                               nms_thresh, detections_per_img)
    keep_idx, keep_valid = keep_idx[0], keep_valid[0]
    return (boxes[keep_idx], torch.where(keep_valid, scores[keep_idx], scores.new_zeros(())),
            labels[keep_idx], keep_valid)
