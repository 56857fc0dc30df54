"""Detection post-processing with fixed shapes (counterpart of
``mega_pytorch_tpu/models/roi_heads/inference.py``): softmax → per-class
decode (weights 10, 10, 5, 5) → clip → score strictly above the threshold →
per-class NMS, all images' foreground classes in one batched call → each
image's top ``detections_per_img``."""

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


def postprocess_detections(class_logits, box_regression, prop_boxes, prop_valid,
                           im_sizes, bbox_reg_weights=(10.0, 10.0, 5.0, 5.0),
                           score_thresh=0.001, nms_thresh=0.5,
                           detections_per_img=300, per_class_keep=None) -> Detections:
    """class_logits (B, K, C), box_regression (B, K, 4C), prop_boxes
    (B, K, 4), prop_valid (B, K), im_sizes (B, 2) (h, w).

    The images' foreground classes go through ONE batched NMS over B*(C-1)
    rows, so a step pays its NMS rounds (each a host synchronisation) once,
    however many images (lanes) it holds; the keep sets are those of a
    per-image call."""
    coder = BoxCoder(bbox_reg_weights)
    b, k, num_classes = class_logits.shape
    if per_class_keep is None:
        per_class_keep = min(k, detections_per_img)
    probs = torch.softmax(class_logits, dim=-1)  # (B, K, C)
    decoded = coder.decode(box_regression, prop_boxes).reshape(b, k, num_classes, 4)
    decoded = clip_to_image(decoded, im_sizes[:, None, None, 0],
                            im_sizes[:, None, None, 1])
    rows = b * (num_classes - 1)
    cls_boxes = decoded[:, :, 1:].transpose(1, 2).reshape(rows, k, 4)
    cls_scores = probs[:, :, 1:].transpose(1, 2).reshape(rows, k)
    cls_valid = (cls_scores > score_thresh) & prop_valid.repeat_interleave(
        num_classes - 1, dim=0)
    _, keep_valid, (kept_boxes, kept_scores) = nms(
        cls_boxes, cls_scores, cls_valid, nms_thresh, per_class_keep,
        extras=(cls_scores,), return_boxes=True,
    )
    labels = torch.arange(1, num_classes, dtype=torch.int32,
                          device=class_logits.device)[:, None]
    flat_labels = labels.expand(num_classes - 1, per_class_keep).reshape(1, -1)
    flat_boxes = kept_boxes.reshape(b, -1, 4)
    flat_scores = torch.where(keep_valid, kept_scores,
                              torch.full_like(kept_scores, -1.0)).reshape(b, -1)
    top = min(detections_per_img, flat_scores.shape[1])
    # stable descending sort: ties resolve low index first, as lax.top_k does
    top_scores, top_idx = torch.sort(flat_scores, dim=-1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :top], top_idx[:, :top]
    return Detections(
        torch.gather(flat_boxes, 1, top_idx[..., None].expand(-1, -1, 4)),
        top_scores.clamp_min(0.0),
        torch.gather(flat_labels.expand(b, -1), 1, top_idx),
        top_scores > 0,
    )
