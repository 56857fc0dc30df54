"""Single-frame Faster R-CNN, inference (counterpart of
``mega_pytorch_tpu/models/detectors/rcnn.py``, the ``base`` VID method), and
what every detector of the port shares.

``RCNNBase`` holds the ResNet C4 backbone, the RPN head, a ROI feature
extractor and the box predictor, under the flax scopes' names; it draws
seeded weights, casts them to the compute dtype once, and keeps the anchors
of each feature-map size. ``GeneralizedRCNN.forward_test`` is the base
detector: backbone → RPN (6000 → 300 proposals) → res5 on the map, ROIAlign,
fc6 / fc7 → predictor → per-class NMS. DFF and FGFA run the same heads on
their aggregated maps (``detect_heads``). Frames lead with the lane (or
batch) dimension; ``forward_train`` is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..backbone.resnet import ResNetC4
from ..roi_heads.extractors import ResNetConv52MLPFeatureExtractor
from ..roi_heads.inference import Detections, postprocess_detections
from ..roi_heads.predictors import FPNPredictor
from ..rpn.anchors import generate_cell_anchors, grid_anchors
from ..rpn.rpn import RPNHead, RPNSizes, rpn_postprocess


@dataclass(frozen=True)
class RCNNConfig:
    """Static detection hyperparameters (the JAX ``RCNNConfig`` defaults;
    training-only fields are not ported)."""

    depth: str = "R-50"
    num_classes: int = 31
    compute_dtype: str = "float32"
    stride_in_1x1: bool = True
    anchor_sizes: tuple = (64, 128, 256, 512)
    aspect_ratios: tuple = (0.5, 1.0, 2.0)
    anchor_stride: int = 16
    pre_nms_top_n_test: int = 6000
    post_nms_top_n_test: int = 300
    ref_pre_nms_top_n: int = 6000
    ref_post_nms_top_n: int = 75
    rpn_nms_thresh: float = 0.7
    rpn_min_size: float = 0.0
    reduce_channel: bool = True
    mlp_dim: int = 1024
    pooler_resolution: int = 7
    pooler_scale: float = 1.0 / 16
    pooler_sampling_ratio: int = 0
    res5_dilation: int = 2
    bbox_reg_weights: tuple = (10.0, 10.0, 5.0, 5.0)
    cls_agnostic_bbox_reg: bool = False
    score_thresh: float = 0.001
    nms_thresh: float = 0.5
    detections_per_img: int = 300

    @property
    def num_anchors_per_cell(self) -> int:
        return len(self.anchor_sizes) * len(self.aspect_ratios)

    def extractor_kwargs(self) -> dict:
        """The ROI feature extractors' shared hyperparameters."""
        return dict(depth=self.depth, reduce_channel=self.reduce_channel,
                    resolution=self.pooler_resolution, spatial_scale=self.pooler_scale,
                    sampling_ratio=self.pooler_sampling_ratio, mlp_dim=self.mlp_dim,
                    dilation=self.res5_dilation, stride_in_1x1=self.stride_in_1x1)


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class RCNNBase(nn.Module):
    """Backbone, RPN head, ``make_extractor(dtype)`` and predictor, registered
    in that order (the order ``init_weights`` draws them in)."""

    def __init__(self, c: RCNNConfig, make_extractor, device=None):
        super().__init__()
        self.c = c
        dtype = DTYPES[c.compute_dtype]
        self.dtype = dtype
        self.backbone = ResNetC4(c.depth, c.stride_in_1x1, dtype, device)
        self.rpn = RPNHead(1024, c.num_anchors_per_cell, dtype, device)
        self.extractor = make_extractor(dtype)
        self.predictor = FPNPredictor(c.mlp_dim, c.num_classes,
                                      c.cls_agnostic_bbox_reg, dtype, device)
        self._anchor_cache: dict = {}

    # -- weights ------------------------------------------------------------
    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded initialisation with the flax initialisers' distributions;
        frozen BN keeps its identity statistics."""
        for m in self.modules():
            if hasattr(m, "init_weights") and m is not self:
                m.init_weights(generator)

    @torch.no_grad()
    def cast_weights_(self) -> None:
        """Store conv/dense weights in the compute dtype (once, not per call)."""
        for m in self.modules():
            if hasattr(m, "cast_weights_") and m is not self:
                m.cast_weights_()

    # -- helpers --------------------------------------------------------------
    def _anchors(self, feat_h: int, feat_w: int, device) -> torch.Tensor:
        key = (feat_h, feat_w, str(device))
        if key not in self._anchor_cache:
            cell = generate_cell_anchors(self.c.anchor_stride, self.c.anchor_sizes,
                                         self.c.aspect_ratios)
            self._anchor_cache[key] = torch.as_tensor(
                grid_anchors(feat_h, feat_w, self.c.anchor_stride, cell), device=device)
        return self._anchor_cache[key]

    def _ref_sizes(self) -> RPNSizes:
        c = self.c
        return RPNSizes(c.ref_pre_nms_top_n, c.ref_post_nms_top_n,
                        c.rpn_nms_thresh, c.rpn_min_size)

    def _key_sizes(self) -> RPNSizes:
        c = self.c
        return RPNSizes(c.pre_nms_top_n_test, c.post_nms_top_n_test,
                        c.rpn_nms_thresh, c.rpn_min_size)

    def _postprocess(self, class_logits, box_reg, rois, valid, sizes) -> Detections:
        c = self.c
        return postprocess_detections(
            class_logits, box_reg, rois, valid, sizes,
            bbox_reg_weights=c.bbox_reg_weights, score_thresh=c.score_thresh,
            nms_thresh=c.nms_thresh, detections_per_img=c.detections_per_img,
        )


def seeded_flagship(model: RCNNBase, device, generator, lanes: int):
    """``model`` with weights drawn on ``device`` from ``generator`` (seed 0
    if None) and cast to its compute dtype, in eval mode; ``lanes``, the
    lockstep lane count it is built for, sizes nothing in the weights and is
    kept as ``model.lanes`` for the engines."""
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    model.init_weights(generator)
    model.cast_weights_()
    model.lanes = lanes
    return model.eval().requires_grad_(False)


class GeneralizedRCNN(RCNNBase):
    """The single-frame detector: frames (L, H, W, C), normalized, plain RGB
    or s2d(4)-packed (C = 48, through ``stem_pool_packed``)."""

    def __init__(self, c: RCNNConfig, device=None):
        super().__init__(c, lambda dtype: ResNetConv52MLPFeatureExtractor(
            **c.extractor_kwargs(), dtype=dtype, device=device), device)

    def detect_heads(self, feats: torch.Tensor, sizes: torch.Tensor) -> Detections:
        """C4 maps (L, h, w, 1024) and image sizes (L, 2) → Detections (L, ...):
        key-budget proposals, the box head and the detection post-processing."""
        objectness, deltas = self.rpn(feats)
        anchors = self._anchors(feats.shape[1], feats.shape[2], feats.device)
        props = rpn_postprocess(objectness, deltas, anchors, sizes, self._key_sizes())
        class_logits, box_reg = self.predictor(self.extractor(feats, props.boxes))
        return self._postprocess(class_logits, box_reg, props.boxes, props.valid, sizes)

    def forward_test(self, images: torch.Tensor, sizes: torch.Tensor) -> Detections:
        return self.detect_heads(self.backbone(images), sizes)
