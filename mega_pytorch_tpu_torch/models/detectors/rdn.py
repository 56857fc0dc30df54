"""RDN streaming detector (counterpart of
``mega_pytorch_tpu/models/detectors/rdn.py``): inference, the window
protocol it shares with MEGA, and ``forward_train`` on one sample's frames.

A window of ``all_frame_interval`` frames (37) holds, per frame, its 75 ref
proposals and 300 key proposals with their fc0 ROI features, computed once
when the frame enters (``precompute``); ``detect_key`` runs no convolution:
the key slot's proposals (slot ``key_frame_location``, 18) attend to every
cached ref through the base stages and the advanced stage, then the
predictor and the detection post-processing. Every method works on L lanes
at once, the lane leading every tensor; the state is an explicit carry of
ring buffers with the newest frame last, and pushes build new tensors, as
the JAX package does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..roi_heads.inference import Detections
from ..roi_heads.vid_extractors import RDNFeatureExtractor
from ...utils.profiler import annotate
from ..rpn.rpn import rpn_postprocess, shared_ref_key_postprocess
from .rcnn import RCNNBase, RCNNConfig


@dataclass(frozen=True)
class VidConfig:
    """Static video-method hyperparameters (the JAX ``VidConfig`` defaults
    that streaming inference reads)."""

    method: str = "rdn"
    base_stage: int = 2
    advanced_stage: int = 0
    embed_dim: int = 64
    groups: int = 16
    ref_num: int = 2
    all_frame_interval: int = 37
    key_frame_location: int = 18
    ratio: float = 0.2
    memory_size: int = 25
    global_enable: bool = True
    global_size: int = 10
    global_res_stage: int = 1

    @classmethod
    def from_cfg(cls, cfg) -> "VidConfig":
        """``MODEL.VID.*`` of the config tree, as the JAX ``VidConfig`` reads
        it, for the fields inference uses."""
        v = cfg.MODEL.VID
        method = v.METHOD
        node = {"rdn": v.RDN, "mega": v.MEGA, "fgfa": v.FGFA, "dff": v.DFF}.get(method)
        att = v.ROI_BOX_HEAD.ATTENTION
        kw = dict(method=method, base_stage=att.STAGE, advanced_stage=att.ADVANCED_STAGE,
                  embed_dim=att.EMBED_DIM, groups=att.GROUP)
        if method in ("rdn", "fgfa"):
            kw.update(ref_num=node.REF_NUM)
        if method in ("rdn", "fgfa", "mega"):
            kw.update(all_frame_interval=node.ALL_FRAME_INTERVAL,
                      key_frame_location=node.KEY_FRAME_LOCATION)
        if method in ("rdn", "mega"):
            kw.update(ratio=node.RATIO)
        if method == "mega":
            kw.update(memory_size=v.MEGA.MEMORY.SIZE, global_enable=v.MEGA.GLOBAL.ENABLE,
                      global_size=v.MEGA.GLOBAL.SIZE,
                      global_res_stage=v.MEGA.GLOBAL.RES_STAGE)
        return cls(**kw)


class RDNCarry(NamedTuple):
    """Window of L lanes; buffers hold the newest frame last."""

    rois: torch.Tensor  # (L, T, 75, 4) ref proposals
    roi_valid: torch.Tensor  # (L, T, 75)
    feats: torch.Tensor  # (L, T, 75, D) fc0 features
    key_rois: torch.Tensor  # (L, T, K, 4)
    key_valid: torch.Tensor  # (L, T, K)
    key_feats: torch.Tensor  # (L, T, K, D)
    sizes: torch.Tensor  # (L, T, 2)


def push(buf: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Per lane, drop the oldest slot and append ``new`` as the newest."""
    return torch.cat([buf[:, 1:], new[:, None]], 1)


_WINDOW = ("rois", "roi_valid", "feats", "key_rois", "key_valid", "key_feats")


class WindowedRCNN(RCNNBase):
    """The window protocol of RDN and MEGA: window entries of each frame,
    the carry's shapes, and its reset and push. ``carry_type`` is the carry
    NamedTuple, whose fields ``_shapes`` gives per lane."""

    carry_type = RDNCarry

    def __init__(self, c: RCNNConfig, v: VidConfig, make_extractor, device=None):
        super().__init__(c, make_extractor, device)
        self.v = v

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

    def _ref_proposals(self, feats: torch.Tensor, sizes: torch.Tensor):
        """Training: the ref proposals (``ref_post_nms_top_n`` of each frame)
        of C4 maps (F, h, w, 1024), from the detached RPN outputs."""
        objectness, deltas = self.rpn(feats)
        anchors = self._anchors(feats.shape[1], feats.shape[2], feats.device)
        return rpn_postprocess(objectness.detach(), deltas.detach(), anchors, sizes,
                               self._ref_sizes())

    def precompute(self, images: torch.Tensor, sizes: torch.Tensor) -> dict:
        """Normalized frames (L, H, W, C), one per lane → their window entries."""
        with annotate("precompute"):
            feats = self.backbone(images)
            objectness, deltas = self.rpn(feats)
            anchors = self._anchors(feats.shape[1], feats.shape[2], feats.device)
            enhanced = self.extractor.enhance_features(feats)
            return self._entry(enhanced, objectness, deltas, anchors, sizes)

    def _shapes(self) -> dict:
        """Per-lane (shape, dtype) of every carry field."""
        c = self.c
        t, bn, kn, d = (self.v.all_frame_interval, c.ref_post_nms_top_n,
                        c.post_nms_top_n_test, c.mlp_dim)
        f32, b8 = torch.float32, torch.bool
        return dict(
            rois=((t, bn, 4), f32), roi_valid=((t, bn), b8), feats=((t, bn, d), f32),
            key_rois=((t, kn, 4), f32), key_valid=((t, kn), b8),
            key_feats=((t, kn, d), f32), sizes=((t, 2), f32),
        )

    def zero_carry(self, lanes: int, device):
        """All-zero carries of ``lanes`` lanes, as zero-stride views: the
        state before a lane's first step (which resets it), and the empty
        memory and global cache of a fresh MEGA carry. Every push and select
        builds new tensors, so nothing writes to these views."""
        def zeros(spec):
            if isinstance(spec[1], torch.dtype):
                shape, dtype = spec
                return torch.zeros((), dtype=dtype, device=device).expand(lanes, *shape)
            return tuple(zeros(x) for x in spec)  # per-stage fields

        return self.carry_type(**{k: zeros(x) for k, x in self._shapes().items()})

    def init_carry(self, entry: dict, size: torch.Tensor):
        """Fresh carries whose window holds each lane's ``entry`` in every
        slot (broadcast views of ``entry``); every other field is empty."""
        t = self.v.all_frame_interval

        def tile(a):
            return a[:, None].expand(a.shape[0], t, *a.shape[1:])

        return self.zero_carry(size.shape[0], size.device)._replace(
            sizes=tile(size), **{k: tile(entry[k]) for k in _WINDOW})

    def push_carry(self, carry, entry: dict, size):
        return carry._replace(sizes=push(carry.sizes, size),
                              **{k: push(getattr(carry, k), entry[k]) for k in _WINDOW})


class GeneralizedRCNNRDN(WindowedRCNN):
    def __init__(self, c: RCNNConfig, v: VidConfig, device=None):
        super().__init__(c, v, lambda dtype: RDNFeatureExtractor(
            **c.extractor_kwargs(), base_stage=v.base_stage,
            advanced_stage=v.advanced_stage, base_num=c.ref_post_nms_top_n,
            advanced_num=int(c.ref_post_nms_top_n * v.ratio), embed_dim=v.embed_dim,
            groups=v.groups, dtype=dtype, device=device), device)

    def forward_train(self, batch, gt: dict, generator: torch.Generator | None = None) -> dict:
        """batch = (normalized RGB frames (1 + ref_num, H, W, 3), cur first,
        sizes (1 + ref_num, 2)) and cur's padded ground truth (leading dim 1)
        → the four losses. The key RPN (losses, 300 training proposals, 128
        of them subsampled) runs on cur; every frame, cur included, gives its
        75 ref proposals from the detached RPN outputs; every frame's map
        carries gradient into res5 and the backbone."""
        images, sizes = batch
        feats = self.backbone(images)
        objectness, deltas = self.rpn(feats[:1])
        anchors = self._anchors(feats.shape[1], feats.shape[2], feats.device)
        losses, rois = self._train_rois(objectness, deltas, anchors, sizes[:1], gt, generator)
        refs = self._ref_proposals(feats, sizes)
        x = self.extractor.extract_train(feats, rois.boxes[0], refs.boxes, refs.valid)
        return dict(losses, **self._box_losses(x, rois))

    def detect_key(self, carry: RDNCarry) -> Detections:
        """Detect at every lane's key slot over all the window's refs →
        Detections (L, ...)."""
        with annotate("detect_key"):
            k = self.v.key_frame_location
            key_rois, key_valid = carry.key_rois[:, k], carry.key_valid[:, k]
            x = self.extractor.extract_test(
                carry.key_feats[:, k], key_rois, carry.rois.flatten(1, 2),
                carry.roi_valid.flatten(1, 2), carry.feats.flatten(1, 2))
            class_logits, box_reg = self.predictor(x)
            return self._postprocess(class_logits, box_reg, key_rois, key_valid,
                                     carry.sizes[:, k])

    def test_step(self, carry: RDNCarry, images: torch.Tensor, sizes: torch.Tensor):
        """Steady state: push each lane's frame, detect at the key slot."""
        carry = self.push_carry(carry, self.precompute(images, sizes), sizes)
        return carry, self.detect_key(carry)
