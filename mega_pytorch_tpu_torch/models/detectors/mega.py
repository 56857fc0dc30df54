"""MEGA streaming detector, inference (counterpart of
``mega_pytorch_tpu/models/detectors/mega.py`` and the streaming parts of
``rdn.py``/``rcnn.py``).

Every method works on L video lanes at once (the JAX package vmaps its
per-lane methods; here the lane is a leading dimension of every tensor).
Per step, ``precompute_pair`` runs ONE backbone/RPN/res5 pass over the 2L
stacked (local, global) frames and yields each lane's window entry (ref and
key proposals with their fc0 ROI features) and global cache entry; the RPN
post-processing runs once over the L local and once over the L global
frames. ``detect_key`` runs no convolution: the merged global enhancement,
three local/memory attention stages, the predictor and the detection
post-processing. The streaming state is an explicit ``MEGACarry`` of ring
buffers with the newest frame last; pushes build new tensors rather than
rolling in place, as the JAX package does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import nn

from ..backbone.resnet import ResNetC4
from ..roi_heads.inference import postprocess_detections
from ..roi_heads.mega_extractor import MEGAFeatureExtractor, RefSet
from ..roi_heads.predictors import FPNPredictor
from ..rpn.anchors import generate_cell_anchors, grid_anchors
from ..rpn.rpn import RPNHead, RPNSizes, rpn_postprocess, shared_ref_key_postprocess


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


@dataclass(frozen=True)
class VidConfig:
    """Static video-method hyperparameters (the JAX ``VidConfig`` defaults
    that streaming MEGA reads)."""

    method: str = "rdn"
    base_stage: int = 2
    embed_dim: int = 64
    groups: int = 16
    all_frame_interval: int = 37
    key_frame_location: int = 18
    ratio: float = 0.2
    memory_size: int = 25
    global_enable: bool = True
    global_size: int = 10
    global_res_stage: int = 1


class MEGACarry(NamedTuple):
    """Streaming state of L lanes; window buffers hold the newest frame last."""

    rois: torch.Tensor  # (L, T, 75, 4) ref proposals
    roi_valid: torch.Tensor  # (L, T, 75)
    feats: torch.Tensor  # (L, T, 75, D) fc0 features
    key_rois: torch.Tensor  # (L, T, K, 4)
    key_valid: torch.Tensor  # (L, T, K)
    key_feats: torch.Tensor  # (L, T, K, D)
    sizes: torch.Tensor  # (L, T, 2)
    mem_rois: tuple  # per stage (L, S, n_i, 4), n_0 = 75, else advanced_num
    mem_feats: tuple  # per stage (L, S, n_i, D)
    mem_valid: tuple  # per stage (L, S, n_i)
    g_feats: torch.Tensor  # (L, Gsize, 75, D)
    g_valid: torch.Tensor  # (L, Gsize, 75)


def _push(buf: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Per lane, drop the oldest slot and append ``new`` as the newest."""
    return torch.cat([buf[:, 1:], new[:, None]], 1)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class GeneralizedRCNNMEGA(nn.Module):
    def __init__(self, c: RCNNConfig, v: VidConfig, device=None):
        super().__init__()
        self.c, self.v = c, v
        dtype = _DTYPES[c.compute_dtype]
        self.dtype = dtype
        self.backbone = ResNetC4(c.depth, c.stride_in_1x1, dtype, device)
        self.rpn = RPNHead(1024, c.num_anchors_per_cell, dtype, device)
        self.extractor = MEGAFeatureExtractor(
            depth=c.depth, reduce_channel=c.reduce_channel,
            resolution=c.pooler_resolution, spatial_scale=c.pooler_scale,
            sampling_ratio=c.pooler_sampling_ratio, mlp_dim=c.mlp_dim,
            dilation=c.res5_dilation, stride_in_1x1=c.stride_in_1x1,
            stage=v.base_stage, base_num=c.ref_post_nms_top_n,
            advanced_num=int(c.ref_post_nms_top_n * v.ratio),
            embed_dim=v.embed_dim, groups=v.groups,
            global_enable=v.global_enable, global_res_stage=v.global_res_stage,
            dtype=dtype, device=device,
        )
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

    def _entry(self, enhanced, objectness, deltas, anchors, sizes):
        """Window entries of L frames: (L, H, W, C) maps, (L, A) objectness."""
        ext = self.extractor
        ref_props, key_props, prefix = shared_ref_key_postprocess(
            objectness, deltas, anchors, sizes, self._ref_sizes(), self._key_sizes())
        key_feats = ext.fc0(ext.pool_flat(enhanced, key_props.boxes))
        if prefix:
            ref_feats = key_feats[:, : self.c.ref_post_nms_top_n]
        else:
            ref_feats = ext.fc0(ext.pool_flat(enhanced, ref_props.boxes))
        return {
            "rois": ref_props.boxes, "roi_valid": ref_props.valid,
            "feats": ref_feats,
            "key_rois": key_props.boxes, "key_valid": key_props.valid,
            "key_feats": key_feats,
        }

    def _shapes(self) -> dict:
        """Per-lane (shape, dtype) of every carry field."""
        c, v = self.c, self.v
        t, s, g = v.all_frame_interval, v.memory_size, v.global_size
        bn, kn, d = c.ref_post_nms_top_n, c.post_nms_top_n_test, c.mlp_dim
        mem_n = [bn] + [int(bn * v.ratio)] * (v.base_stage - 1)
        f32, b8 = torch.float32, torch.bool
        return dict(
            rois=((t, bn, 4), f32), roi_valid=((t, bn), b8), feats=((t, bn, d), f32),
            key_rois=((t, kn, 4), f32), key_valid=((t, kn), b8),
            key_feats=((t, kn, d), f32), sizes=((t, 2), f32),
            mem_rois=tuple(((s, n, 4), f32) for n in mem_n),
            mem_feats=tuple(((s, n, d), f32) for n in mem_n),
            mem_valid=tuple(((s, n), b8) for n in mem_n),
            g_feats=((g, bn, d), f32), g_valid=((g, bn), b8),
        )

    # -- streaming ------------------------------------------------------------
    def precompute(self, images: torch.Tensor, sizes: torch.Tensor) -> dict:
        """Normalized frames (L, H, W, C), one per lane → their window entries."""
        feats = self.backbone(images)
        objectness, deltas = self.rpn(feats)
        anchors = self._anchors(feats.shape[1], feats.shape[2], feats.device)
        enhanced = self.extractor.enhance_features(feats)
        return self._entry(enhanced, objectness, deltas, anchors, sizes)

    def precompute_global(self, images: torch.Tensor, sizes: torch.Tensor):
        """Normalized global frames (L, H, W, C) → (fc0 features (L, 75, D),
        validity (L, 75)) of their 75 ref proposals."""
        feats = self.backbone(images)
        objectness, deltas = self.rpn(feats)
        anchors = self._anchors(feats.shape[1], feats.shape[2], feats.device)
        props = rpn_postprocess(objectness, deltas, anchors, sizes, self._ref_sizes())
        return self.extractor.precompute_ref(feats, props.boxes), props.valid

    def precompute_pair(self, images: torch.Tensor, sizes: torch.Tensor):
        """Stacked normalized pairs (L, 2, H, W, C) — [:, 0] local, [:, 1]
        global — with sizes (L, 2, 2) through ONE backbone/RPN/res5 pass over
        the 2L frames → (entry, g_pooled (L, 75, D), g_valid (L, 75))."""
        lanes = images.shape[0]
        feats = self.backbone(images.flatten(0, 1))  # (2L, H', W', 1024)
        objectness, deltas = self.rpn(feats)
        anchors = self._anchors(feats.shape[1], feats.shape[2], feats.device)
        enhanced = self.extractor.enhance_features(feats).unflatten(0, (lanes, 2))
        objectness = objectness.unflatten(0, (lanes, 2))
        deltas = deltas.unflatten(0, (lanes, 2))
        entry = self._entry(enhanced[:, 0], objectness[:, 0], deltas[:, 0], anchors,
                            sizes[:, 0])
        g_props = rpn_postprocess(objectness[:, 1], deltas[:, 1], anchors, sizes[:, 1],
                                  self._ref_sizes())
        ext = self.extractor
        g_pooled = ext.fc0(ext.pool_flat(enhanced[:, 1], g_props.boxes))
        return entry, g_pooled, g_props.valid

    def apply_global(self, carry: MEGACarry, pooled, valid) -> MEGACarry:
        return carry._replace(g_feats=_push(carry.g_feats, pooled),
                              g_valid=_push(carry.g_valid, valid))

    def zero_carry(self, lanes: int, device) -> MEGACarry:
        """All-zero carries of ``lanes`` lanes, as zero-stride views: the
        state before a lane's first step (which resets it), and the empty
        memory and global cache of a fresh carry. Every push and select
        builds new tensors, so nothing writes to these views."""
        def zeros(spec):
            if isinstance(spec[1], torch.dtype):
                shape, dtype = spec
                return torch.zeros((), dtype=dtype, device=device).expand(lanes, *shape)
            return tuple(zeros(x) for x in spec)  # per-stage fields

        return MEGACarry(**{k: zeros(x) for k, x in self._shapes().items()})

    def init_carry(self, entry: dict, size: torch.Tensor) -> MEGACarry:
        """Fresh carries whose window holds each lane's ``entry`` in every
        slot (broadcast views of ``entry``), with empty memory and global
        cache."""
        t = self.v.all_frame_interval

        def tile(a):
            return a[:, None].expand(a.shape[0], t, *a.shape[1:])

        return self.zero_carry(size.shape[0], size.device)._replace(
            rois=tile(entry["rois"]), roi_valid=tile(entry["roi_valid"]),
            feats=tile(entry["feats"]), key_rois=tile(entry["key_rois"]),
            key_valid=tile(entry["key_valid"]), key_feats=tile(entry["key_feats"]),
            sizes=tile(size),
        )

    def push_carry(self, carry: MEGACarry, entry: dict, size) -> MEGACarry:
        return carry._replace(
            rois=_push(carry.rois, entry["rois"]),
            roi_valid=_push(carry.roi_valid, entry["roi_valid"]),
            feats=_push(carry.feats, entry["feats"]),
            key_rois=_push(carry.key_rois, entry["key_rois"]),
            key_valid=_push(carry.key_valid, entry["key_valid"]),
            key_feats=_push(carry.key_feats, entry["key_feats"]),
            sizes=_push(carry.sizes, size),
        )

    def update_global(self, carry: MEGACarry, images, sizes) -> MEGACarry:
        pooled, valid = self.precompute_global(images, sizes)
        return self.apply_global(carry, pooled, valid)

    def detect_key(self, carry: MEGACarry):
        """Detect at every lane's key slot → (carry with the LRM pushes,
        Detections (L, ...))."""
        c, v = self.c, self.v
        k = v.key_frame_location
        key_rois, key_valid = carry.key_rois[:, k], carry.key_valid[:, k]

        def refs(rois, feats, valid):
            return RefSet(rois.flatten(1, 2), feats.flatten(1, 2), valid.flatten(1, 2))

        window = refs(carry.rois, carry.feats, carry.roi_valid)
        lrm = tuple(refs(carry.mem_rois[i], carry.mem_feats[i], carry.mem_valid[i])
                    for i in range(v.base_stage))
        x, pushes = self.extractor.extract_test(
            carry.key_feats[:, k], key_rois, window, lrm,
            carry.g_feats.flatten(1, 2), carry.g_valid.flatten(1, 2),
        )
        carry = carry._replace(
            mem_rois=tuple(_push(carry.mem_rois[i], p.rois) for i, p in enumerate(pushes)),
            mem_feats=tuple(_push(carry.mem_feats[i], p.feats) for i, p in enumerate(pushes)),
            mem_valid=tuple(_push(carry.mem_valid[i], p.valid) for i, p in enumerate(pushes)),
        )
        class_logits, box_reg = self.predictor(x)
        dets = postprocess_detections(
            class_logits, box_reg, key_rois, key_valid, carry.sizes[:, k],
            bbox_reg_weights=c.bbox_reg_weights, score_thresh=c.score_thresh,
            nms_thresh=c.nms_thresh, detections_per_img=c.detections_per_img,
        )
        return carry, dets

    def test_step(self, carry: MEGACarry, pairs: torch.Tensor, sizes: torch.Tensor):
        """Steady state: push each pair's local frame, apply its global frame,
        detect at the key slot. pairs (L, 2, H, W, C), sizes (L, 2, 2)."""
        entry, g_pooled, g_valid = self.precompute_pair(pairs, sizes)
        carry = self.push_carry(carry, entry, sizes[:, 0])
        carry = self.apply_global(carry, g_pooled, g_valid)
        return self.detect_key(carry)


def build_mega_flagship(canvas_h: int, canvas_w: int, device="cuda",
                        generator: torch.Generator | None = None, lanes: int = 1):
    """MEGA R-101 C4 in bf16 as the JAX ``build_mega_flagship`` configures it
    (3 stages, window 25 with the key at slot 12), its weights drawn on
    ``device`` from ``generator``. Frames arrive s2d(4)-packed
    (canvas_h/4, canvas_w/4, 48). Returns the model in eval mode.

    ``lanes`` is the lockstep lane count it is built for (the JAX package's
    ``batch``; 12 in its bench): it sizes nothing in the weights, which serve
    any lane count, and is kept as ``model.lanes`` for the engines."""
    if canvas_h % 16 or canvas_w % 16:
        raise ValueError("canvas sides must be multiples of 16")
    c = RCNNConfig(depth="R-101", compute_dtype="bfloat16")
    v = VidConfig(method="mega", base_stage=3, all_frame_interval=25,
                  key_frame_location=12)
    model = GeneralizedRCNNMEGA(c, v, device=device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    model.init_weights(generator)
    model.cast_weights_()
    model.lanes = lanes
    return model.eval().requires_grad_(False)
