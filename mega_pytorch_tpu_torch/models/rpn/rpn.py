"""Region Proposal Network, inference (counterpart of
``mega_pytorch_tpu/models/rpn/rpn.py``): head, and fixed-shape proposals
(sigmoid → top-k → decode → clip → min-size mask → presorted NMS)."""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ...ops.box_coder import BoxCoder
from ...ops.nms import nms
from ...structures.boxes import Boxes, clip_to_image, small_box_mask
from ..backbone.resnet import nchw, nhwc
from ..layers import Conv

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
