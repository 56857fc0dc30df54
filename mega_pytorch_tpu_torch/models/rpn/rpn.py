"""Region Proposal Network (counterpart of
``mega_pytorch_tpu/models/rpn/rpn.py``): head, fixed-shape proposals
(sigmoid → top-k → decode → clip → min-size mask → presorted NMS), and the
training side: ground truth appended to the proposals, and the loss (IoU
matcher 0.7 / 0.3 with low-quality matches, balanced 256 @ 0.5 sampling,
BCE + smooth-L1 over the sampled count)."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.box_coder import BoxCoder
from ...ops.losses import smooth_l1_loss
from ...ops.nms import nms
from ...structures.boxes import Boxes, box_iou, clip_to_image, small_box_mask
from ...utils.profiler import annotate
from ..backbone.resnet import nchw, nhwc
from ..layers import Conv
from ..matcher import BELOW_LOW_THRESHOLD, BETWEEN_THRESHOLDS, match
from ..sampler import balanced_sample
from .anchors import anchor_visibility

RPN_BOX_CODER = BoxCoder(weights=(1.0, 1.0, 1.0, 1.0))


class RPNHead(nn.Module):
    """Shared 3x3 conv + 1x1 objectness / box-delta convs."""

    def __init__(self, in_channels, num_anchors, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, init_std=0.01, device=device)
        self.conv = Conv(in_channels, in_channels, 3, padding=1, **kw)
        self.cls_logits = Conv(in_channels, num_anchors, 1, **kw)
        self.bbox_pred = Conv(in_channels, num_anchors * 4, 1, **kw)

    def forward(self, x: torch.Tensor):
        """x (B, H, W, C) → objectness (B, H*W*A) f32, deltas (B, H*W*A, 4) f32,
        flattened in (y, x, a) order."""
        t = torch.relu(self.conv(nchw(x)))
        b = x.shape[0]
        objectness = nhwc(self.cls_logits(t)).reshape(b, -1).float()
        deltas = nhwc(self.bbox_pred(t)).reshape(b, -1, 4).float()
        return objectness, deltas


class RPNSizes(NamedTuple):
    pre_nms_top_n: int
    post_nms_top_n: int
    nms_thresh: float
    min_size: float


def rpn_postprocess(objectness, box_deltas, anchors, im_sizes, sizes: RPNSizes) -> Boxes:
    """(B, N) logits, (B, N, 4) deltas, (N, 4) anchors, (B, 2) sizes →
    Boxes with (B, post_nms_top_n, ...) tensors and an "objectness" field."""
    with annotate("rpn_postprocess"):
        n = objectness.shape[1]
        scores = torch.sigmoid(objectness)
        k = min(sizes.pre_nms_top_n, n)
        # stable descending sort: ties resolve low index first, as lax.top_k does
        top_scores, top_idx = torch.sort(scores, dim=-1, descending=True, stable=True)
        top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
        decoded = RPN_BOX_CODER.decode(box_deltas, anchors[None].expand_as(box_deltas))
        proposals = torch.gather(decoded, 1, top_idx[..., None].expand(-1, -1, 4))
        proposals = clip_to_image(proposals, im_sizes[:, 0:1], im_sizes[:, 1:2])
        valid = small_box_mask(proposals, sizes.min_size)
        _, keep_valid, (kept_boxes, kept_scores) = nms(
            proposals, top_scores, valid, sizes.nms_thresh, sizes.post_nms_top_n,
            extras=(top_scores,), return_boxes=True, presorted=True,
        )
        return Boxes(kept_boxes, keep_valid, {"objectness": kept_scores})


def shared_ref_key_postprocess(objectness, box_deltas, anchors, im_sizes,
                               ref_sizes: RPNSizes, key_sizes: RPNSizes):
    """(ref, key, is_prefix): when the two proposal budgets differ only in
    post_nms_top_n, the ref set IS the first ref_post slots of the key set
    (one sort and one NMS); otherwise two independent passes."""
    key_props = rpn_postprocess(objectness, box_deltas, anchors, im_sizes, key_sizes)
    if (
        ref_sizes.pre_nms_top_n == key_sizes.pre_nms_top_n
        and ref_sizes.nms_thresh == key_sizes.nms_thresh
        and ref_sizes.min_size == key_sizes.min_size
        and ref_sizes.post_nms_top_n <= key_sizes.post_nms_top_n
    ):
        r = ref_sizes.post_nms_top_n
        ref_props = Boxes(
            key_props.boxes[:, :r], key_props.valid[:, :r],
            {k: v[:, :r] for k, v in key_props.fields.items()},
        )
        return ref_props, key_props, True
    ref_props = rpn_postprocess(objectness, box_deltas, anchors, im_sizes, ref_sizes)
    return ref_props, key_props, False


# -- training -------------------------------------------------------------------

def add_gt_proposals(proposals: Boxes, gt_boxes: torch.Tensor,
                     gt_valid: torch.Tensor) -> Boxes:
    """Append the padded ground truth as extra slots with objectness 1:
    proposals (B, K, ...), gt_boxes (B, G, 4), gt_valid (B, G)."""
    obj = proposals.fields["objectness"]
    return Boxes(
        torch.cat([proposals.boxes, gt_boxes.to(proposals.boxes.dtype)], 1),
        torch.cat([proposals.valid, gt_valid], 1),
        {"objectness": torch.cat([obj, torch.ones(gt_boxes.shape[:2], dtype=obj.dtype,
                                                  device=obj.device)], 1)},
    )


def rpn_targets(anchors, gt_boxes, gt_valid, im_sizes, fg_iou: float, bg_iou: float,
                straddle_thresh: float):
    """anchors (N, 4), ground truth (B, G, ...), image sizes (B, 2) → labels
    (B, N) in {-1, 0, 1} and (B, N, 4) regression targets: the matcher with
    low-quality matches, anchors outside the image and between the
    thresholds ignored."""
    matched = match(box_iou(gt_boxes, anchors), gt_valid, fg_iou, bg_iou,
                    allow_low_quality_matches=True)  # (B, N)
    one, zero, ignore = (torch.full_like(matched, v, dtype=torch.float32)
                         for v in (1.0, 0.0, -1.0))
    labels = torch.where(matched >= 0, one,
                         torch.where(matched == BELOW_LOW_THRESHOLD, zero, ignore))
    visible = anchor_visibility(anchors, im_sizes[:, 0:1], im_sizes[:, 1:2],
                                straddle_thresh)
    labels = torch.where(visible, labels, ignore)
    labels = torch.where(matched == BETWEEN_THRESHOLDS, ignore, labels)
    idx = matched.clamp_min(0)[..., None].expand(-1, -1, 4)
    matched_gt = torch.gather(gt_boxes, 1, idx)
    return labels, RPN_BOX_CODER.encode(matched_gt, anchors[None].expand_as(matched_gt))


def rpn_loss(anchors, objectness, box_deltas, gt_boxes, gt_valid, im_sizes,
             generator: torch.Generator | None = None, batch_size_per_image: int = 256,
             positive_fraction: float = 0.5, fg_iou: float = 0.7, bg_iou: float = 0.3,
             straddle_thresh: float = 0.0, uniforms: torch.Tensor | None = None):
    """Batched RPN losses → (objectness_loss, box_loss): the balanced sample
    of each image (its (2, N) uniforms drawn from ``generator``, or the
    (B, 2, N) ``uniforms`` given), the mean BCE over the sampled anchors, and
    the smooth-L1 (beta 1/9) of the positives over the sampled count."""
    labels, reg_targets = rpn_targets(anchors, gt_boxes, gt_valid, im_sizes, fg_iou,
                                      bg_iou, straddle_thresh)
    pos_mask, neg_mask = balanced_sample(labels, batch_size_per_image, positive_fraction,
                                         generator, uniforms)
    sampled = pos_mask | neg_mask
    num_sampled = sampled.sum().clamp_min(1)
    sl1 = smooth_l1_loss(box_deltas, reg_targets, beta=1.0 / 9)
    box_loss = (sl1.sum(-1) * pos_mask).sum() / num_sampled
    bce = -(labels * F.logsigmoid(objectness) + (1.0 - labels) * F.logsigmoid(-objectness))
    objectness_loss = (bce * sampled).sum() / num_sampled
    return objectness_loss, box_loss
