"""Single-frame Faster R-CNN (counterpart of
``mega_pytorch_tpu/models/detectors/rcnn.py``, the ``base`` VID method), and
what every detector of the port shares.

``RCNNBase`` holds the ResNet C4 backbone, the RPN head, a ROI feature
extractor and the box predictor, under the flax scopes' names; it draws
seeded weights, casts them to the compute dtype once (inference; training
keeps f32 master weights, which the layers cast per call), and keeps the
anchors of each feature-map size. ``GeneralizedRCNN.forward_test`` is the
base detector: backbone → RPN (6000 → 300 proposals) → res5 on the map,
ROIAlign, fc6 / fc7 → predictor → per-class NMS. DFF and FGFA run the same
heads on their aggregated maps (``detect_heads``). ``forward_train`` gives
the four losses (RPN, then the box head on 128 subsampled ROIs). Frames lead
with the lane (or batch) dimension.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..backbone.resnet import ResNetC4
from ..roi_heads.extractors import ResNetConv52MLPFeatureExtractor
from ..roi_heads.inference import Detections, postprocess_detections
from ..roi_heads.predictors import FPNPredictor
from ..roi_heads.subsample import fastrcnn_loss, subsample_proposals
from ..rpn.anchors import generate_cell_anchors, grid_anchors
from ..rpn.rpn import RPNHead, RPNSizes, add_gt_proposals, rpn_loss, rpn_postprocess


@dataclass(frozen=True)
class RCNNConfig:
    """Static detection hyperparameters (the JAX ``RCNNConfig`` defaults,
    the reference's VID recipe)."""

    depth: str = "R-50"
    num_classes: int = 31
    compute_dtype: str = "float32"
    freeze_at: int = 2
    stride_in_1x1: bool = True
    # anchors / RPN
    anchor_sizes: tuple = (64, 128, 256, 512)
    aspect_ratios: tuple = (0.5, 1.0, 2.0)
    anchor_stride: int = 16
    straddle_thresh: float = 0.0
    rpn_fg_iou: float = 0.7
    rpn_bg_iou: float = 0.3
    rpn_batch_size: int = 256
    rpn_positive_fraction: float = 0.5
    pre_nms_top_n_train: int = 6000
    pre_nms_top_n_test: int = 6000
    post_nms_top_n_train: int = 300
    post_nms_top_n_test: int = 300
    ref_pre_nms_top_n: int = 6000
    ref_post_nms_top_n: int = 75
    rpn_nms_thresh: float = 0.7
    rpn_min_size: float = 0.0
    # ROI head
    reduce_channel: bool = True
    mlp_dim: int = 1024
    pooler_resolution: int = 7
    pooler_scale: float = 1.0 / 16
    pooler_sampling_ratio: int = 0
    res5_dilation: int = 2
    roi_batch_size: int = 128
    roi_positive_fraction: float = 0.25
    roi_fg_iou: float = 0.5
    roi_bg_iou: float = 0.5
    bbox_reg_weights: tuple = (10.0, 10.0, 5.0, 5.0)
    cls_agnostic_bbox_reg: bool = False
    # test
    score_thresh: float = 0.001
    nms_thresh: float = 0.5
    detections_per_img: int = 300
    # padding
    max_gt_boxes: int = 32

    @classmethod
    def from_cfg(cls, cfg) -> "RCNNConfig":
        """The config tree's values (``config.defaults`` keys)."""
        if cfg.MODEL.RESNETS.TRANS_FUNC.endswith("WithGN"):
            raise NotImplementedError("group-norm ResNets are not ported")
        return cls(
            depth="-".join(cfg.MODEL.BACKBONE.CONV_BODY.split("-")[:2]),
            num_classes=cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES,
            compute_dtype=cfg.TPU.COMPUTE_DTYPE,
            freeze_at=cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT,
            stride_in_1x1=cfg.MODEL.RESNETS.STRIDE_IN_1X1,
            anchor_sizes=tuple(cfg.MODEL.RPN.ANCHOR_SIZES),
            aspect_ratios=tuple(cfg.MODEL.RPN.ASPECT_RATIOS),
            anchor_stride=cfg.MODEL.RPN.ANCHOR_STRIDE[0],
            straddle_thresh=cfg.MODEL.RPN.STRADDLE_THRESH,
            rpn_fg_iou=cfg.MODEL.RPN.FG_IOU_THRESHOLD,
            rpn_bg_iou=cfg.MODEL.RPN.BG_IOU_THRESHOLD,
            rpn_batch_size=cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE,
            rpn_positive_fraction=cfg.MODEL.RPN.POSITIVE_FRACTION,
            pre_nms_top_n_train=cfg.MODEL.RPN.PRE_NMS_TOP_N_TRAIN,
            pre_nms_top_n_test=cfg.MODEL.RPN.PRE_NMS_TOP_N_TEST,
            post_nms_top_n_train=cfg.MODEL.RPN.POST_NMS_TOP_N_TRAIN,
            post_nms_top_n_test=cfg.MODEL.RPN.POST_NMS_TOP_N_TEST,
            ref_pre_nms_top_n=cfg.MODEL.VID.RPN.REF_PRE_NMS_TOP_N,
            ref_post_nms_top_n=cfg.MODEL.VID.RPN.REF_POST_NMS_TOP_N,
            rpn_nms_thresh=cfg.MODEL.RPN.NMS_THRESH,
            rpn_min_size=cfg.MODEL.RPN.MIN_SIZE,
            reduce_channel=cfg.MODEL.VID.ROI_BOX_HEAD.REDUCE_CHANNEL,
            mlp_dim=cfg.MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM,
            pooler_resolution=cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION,
            pooler_scale=cfg.MODEL.ROI_BOX_HEAD.POOLER_SCALES[0],
            pooler_sampling_ratio=cfg.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO,
            res5_dilation=cfg.MODEL.RESNETS.RES5_DILATION,
            roi_batch_size=cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE,
            roi_positive_fraction=cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION,
            roi_fg_iou=cfg.MODEL.ROI_HEADS.FG_IOU_THRESHOLD,
            roi_bg_iou=cfg.MODEL.ROI_HEADS.BG_IOU_THRESHOLD,
            bbox_reg_weights=tuple(cfg.MODEL.ROI_HEADS.BBOX_REG_WEIGHTS),
            cls_agnostic_bbox_reg=cfg.MODEL.CLS_AGNOSTIC_BBOX_REG,
            score_thresh=cfg.MODEL.ROI_HEADS.SCORE_THRESH,
            nms_thresh=cfg.MODEL.ROI_HEADS.NMS,
            detections_per_img=cfg.MODEL.ROI_HEADS.DETECTIONS_PER_IMG,
            max_gt_boxes=cfg.TPU.MAX_GT_BOXES,
        )

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

    # -- training -------------------------------------------------------------
    def forward(self, inputs, gt: dict, generator: torch.Generator | None = None) -> dict:
        """Training: ``forward_train`` (the JAX ``__call__(train=True)``).
        ``DistributedDataParallel`` reduces the gradients of calls made
        through its own ``__call__``, so training calls the model, never
        ``forward_train`` directly."""
        return self.forward_train(inputs, gt, generator)

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

    def _key_sizes(self, train: bool = False) -> RPNSizes:
        c = self.c
        if train:
            return RPNSizes(c.pre_nms_top_n_train, c.post_nms_top_n_train,
                            c.rpn_nms_thresh, c.rpn_min_size)
        return RPNSizes(c.pre_nms_top_n_test, c.post_nms_top_n_test,
                        c.rpn_nms_thresh, c.rpn_min_size)

    def _train_rois(self, objectness, deltas, anchors, sizes, gt: dict, generator):
        """The RPN losses of B frames ((B, A) objectness, (B, A, 4) deltas,
        sizes (B, 2), ground truth gt["boxes"/"labels"/"valid"] (B, G, ...))
        and their subsampled ROIs: training proposals from the detached RPN
        outputs (the JAX package's stop_gradient), the ground truth appended,
        ``roi_batch_size`` slots sampled. Random draws, RPN first, from
        ``generator``. Returns (losses, SampledRois)."""
        c = self.c
        loss_obj, loss_box = rpn_loss(
            anchors, objectness, deltas, gt["boxes"], gt["valid"], sizes, generator,
            c.rpn_batch_size, c.rpn_positive_fraction, c.rpn_fg_iou, c.rpn_bg_iou,
            c.straddle_thresh)
        props = rpn_postprocess(objectness.detach(), deltas.detach(), anchors, sizes,
                                self._key_sizes(train=True))
        props = add_gt_proposals(props, gt["boxes"], gt["valid"])
        rois = subsample_proposals(
            props.boxes, props.valid, gt["boxes"], gt["labels"], gt["valid"], generator,
            c.bbox_reg_weights, c.roi_batch_size, c.roi_positive_fraction, c.roi_fg_iou,
            c.roi_bg_iou)
        return {"loss_objectness": loss_obj, "loss_rpn_box_reg": loss_box}, rois

    def _box_losses(self, x, rois) -> dict:
        """The predictor on ROI features x (B, S, D) and the Fast R-CNN
        losses of the sampled slots."""
        class_logits, box_reg = self.predictor(x)
        loss_cls, loss_box = fastrcnn_loss(class_logits, box_reg, rois,
                                           self.c.cls_agnostic_bbox_reg)
        return {"loss_classifier": loss_cls, "loss_box_reg": loss_box}

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


def seeded_training(model: RCNNBase, device, generator) -> RCNNBase:
    """``model`` for training: weights drawn on ``device`` from ``generator``
    (seed 0 if None) and kept in f32 (the layers cast them to the compute
    dtype per call, as flax does), the backbone frozen below
    ``c.freeze_at``, in train mode. FrozenBN statistics are buffers."""
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    model.init_weights(generator)
    model.backbone.freeze_(model.c.freeze_at)
    return model.train()


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

    def detect_heads_train(self, feats: torch.Tensor, sizes: torch.Tensor, gt: dict,
                           generator: torch.Generator | None = None) -> dict:
        """C4 maps (B, h, w, 1024) with image sizes (B, 2) and their padded
        ground truth → the four losses: RPN, 128 subsampled ROIs through the
        box head, Fast R-CNN. DFF and FGFA run it on their warped maps."""
        objectness, deltas = self.rpn(feats)
        anchors = self._anchors(feats.shape[1], feats.shape[2], feats.device)
        losses, rois = self._train_rois(objectness, deltas, anchors, sizes, gt, generator)
        return dict(losses, **self._box_losses(self.extractor(feats, rois.boxes), rois))

    def forward_train(self, batch, gt: dict, generator: torch.Generator | None = None) -> dict:
        """batch = (normalized RGB frames (B, H, W, 3), sizes (B, 2)) and
        their padded ground truth → the four losses."""
        images, sizes = batch
        return self.detect_heads_train(self.backbone(images), sizes, gt, generator)


def pad_gt(boxes: np.ndarray, labels: np.ndarray, max_gt: int = 32) -> dict:
    """Pad one image's ground truth to static shapes (host-side helper)."""
    g = min(len(boxes), max_gt)
    out_boxes = np.zeros((max_gt, 4), np.float32)
    out_labels = np.zeros((max_gt,), np.int32)
    out_valid = np.zeros((max_gt,), bool)
    out_boxes[:g] = boxes[:g]
    out_labels[:g] = labels[:g]
    out_valid[:g] = True
    return {"boxes": out_boxes, "labels": out_labels, "valid": out_valid}
