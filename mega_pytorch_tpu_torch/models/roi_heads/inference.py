"""Detection post-processing with fixed shapes (counterpart of
``mega_pytorch_tpu/models/roi_heads/inference.py``): softmax → per-class
decode (weights 10, 10, 5, 5) → clip → score strictly above the threshold →
per-class NMS, all foreground classes in one batched call → global top
``detections_per_img``."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...ops.box_coder import BoxCoder
from ...ops.nms import nms
from ...structures.boxes import clip_to_image


class Detections(NamedTuple):
    boxes: torch.Tensor  # (B, D, 4)
    scores: torch.Tensor  # (B, D)
    labels: torch.Tensor  # (B, D) int32, 1..C-1
    valid: torch.Tensor  # (B, D) bool


def _postprocess_one(class_logits, box_regression, prop_boxes, prop_valid, im_size,
                     coder, score_thresh, nms_thresh, detections_per_img,
                     per_class_keep):
    num_classes = class_logits.shape[-1]
    probs = torch.softmax(class_logits, dim=-1)  # (K, C)
    decoded = coder.decode(box_regression, prop_boxes).reshape(-1, num_classes, 4)
    decoded = clip_to_image(decoded, im_size[0], im_size[1])
    cls_boxes = decoded[:, 1:].transpose(0, 1).contiguous()  # (C-1, K, 4)
    cls_scores = probs[:, 1:].T.contiguous()  # (C-1, K)
    cls_valid = (cls_scores > score_thresh) & prop_valid[None, :]
    _, keep_valid, (kept_boxes, kept_scores) = nms(
        cls_boxes, cls_scores, cls_valid, nms_thresh, per_class_keep,
        extras=(cls_scores,), return_boxes=True,
    )
    labels = torch.arange(1, num_classes, dtype=torch.int32,
                          device=class_logits.device)[:, None].expand_as(keep_valid)
    flat_boxes = kept_boxes.reshape(-1, 4)
    flat_scores = torch.where(keep_valid.reshape(-1), kept_scores.reshape(-1),
                              torch.full_like(kept_scores.reshape(-1), -1.0))
    flat_labels = labels.reshape(-1)
    k = min(detections_per_img, flat_scores.shape[0])
    # stable descending sort: ties resolve low index first, as lax.top_k does
    top_scores, top_idx = torch.sort(flat_scores, descending=True, stable=True)
    top_scores, top_idx = top_scores[:k], top_idx[:k]
    return (flat_boxes[top_idx], top_scores.clamp_min(0.0), flat_labels[top_idx],
            top_scores > 0)


def postprocess_detections(class_logits, box_regression, prop_boxes, prop_valid,
                           im_sizes, bbox_reg_weights=(10.0, 10.0, 5.0, 5.0),
                           score_thresh=0.001, nms_thresh=0.5,
                           detections_per_img=300, per_class_keep=None) -> Detections:
    """class_logits (B, K, C), box_regression (B, K, 4C), prop_boxes
    (B, K, 4), prop_valid (B, K), im_sizes (B, 2) (h, w)."""
    coder = BoxCoder(bbox_reg_weights)
    if per_class_keep is None:
        per_class_keep = min(prop_boxes.shape[1], detections_per_img)
    outs = [
        _postprocess_one(class_logits[i], box_regression[i], prop_boxes[i],
                         prop_valid[i], im_sizes[i], coder, score_thresh,
                         nms_thresh, detections_per_img, per_class_keep)
        for i in range(class_logits.shape[0])
    ]
    return Detections(*(torch.stack(parts) for parts in zip(*outs)))
