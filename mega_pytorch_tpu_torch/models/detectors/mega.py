"""MEGA streaming detector (counterpart of
``mega_pytorch_tpu/models/detectors/mega.py`` and the streaming parts of
``rdn.py``/``rcnn.py``); ``forward_train`` takes one training sample's
local, memory and global frame pools.

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

from typing import NamedTuple

import torch

from ..roi_heads.mega_extractor import MEGAFeatureExtractor, RefSet
from ..rpn.rpn import rpn_postprocess
from .rcnn import RCNNConfig, seeded_flagship
from .rdn import VidConfig, WindowedRCNN, push

__all__ = ["GeneralizedRCNNMEGA", "MEGACarry", "RCNNConfig", "VidConfig",
           "build_mega_flagship"]


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


class GeneralizedRCNNMEGA(WindowedRCNN):
    carry_type = MEGACarry

    def __init__(self, c: RCNNConfig, v: VidConfig, device=None):
        super().__init__(c, v, lambda dtype: MEGAFeatureExtractor(
            **c.extractor_kwargs(), stage=v.base_stage, base_num=c.ref_post_nms_top_n,
            advanced_num=int(c.ref_post_nms_top_n * v.ratio), embed_dim=v.embed_dim,
            groups=v.groups, global_enable=v.global_enable,
            global_res_stage=v.global_res_stage, dtype=dtype, device=device), device)

    def _shapes(self) -> dict:
        """Per-lane (shape, dtype) of every carry field."""
        c, v = self.c, self.v
        s, g = v.memory_size, v.global_size
        bn, d = c.ref_post_nms_top_n, c.mlp_dim
        mem_n = [bn] + [int(bn * v.ratio)] * (v.base_stage - 1)
        f32, b8 = torch.float32, torch.bool
        return dict(
            super()._shapes(),
            mem_rois=tuple(((s, n, 4), f32) for n in mem_n),
            mem_feats=tuple(((s, n, d), f32) for n in mem_n),
            mem_valid=tuple(((s, n), b8) for n in mem_n),
            g_feats=((g, bn, d), f32), g_valid=((g, bn), b8),
        )

    # -- streaming ------------------------------------------------------------
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
        return carry._replace(g_feats=push(carry.g_feats, pooled),
                              g_valid=push(carry.g_valid, valid))

    def update_global(self, carry: MEGACarry, images, sizes) -> MEGACarry:
        pooled, valid = self.precompute_global(images, sizes)
        return self.apply_global(carry, pooled, valid)

    def detect_key(self, carry: MEGACarry):
        """Detect at every lane's key slot → (carry with the LRM pushes,
        Detections (L, ...))."""
        v = self.v
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
            mem_rois=tuple(push(carry.mem_rois[i], p.rois) for i, p in enumerate(pushes)),
            mem_feats=tuple(push(carry.mem_feats[i], p.feats) for i, p in enumerate(pushes)),
            mem_valid=tuple(push(carry.mem_valid[i], p.valid) for i, p in enumerate(pushes)),
        )
        class_logits, box_reg = self.predictor(x)
        return carry, self._postprocess(class_logits, box_reg, key_rois, key_valid,
                                        carry.sizes[:, k])

    # -- training -------------------------------------------------------------
    def forward_train(self, batch: dict, gt: dict,
                      generator: torch.Generator | None = None) -> dict:
        """One sample's three frame pools, batch["local"] (cur first, then
        the local refs), batch["memory"] and batch["global"], each a pair of
        normalized RGB frames (F, H, W, 3) and sizes (F, 2), and cur's padded
        ground truth (leading dim 1) → the four losses.

        The key RPN (losses and 300 training proposals, 128 of them
        subsampled) runs on cur; every frame gives its 75 ref proposals from
        the detached RPN outputs; the memory pool runs without gradient
        (the JAX package's stop_gradient on its maps)."""
        imgs_l, sizes_l = batch["local"]
        imgs_m, sizes_m = batch["memory"]
        imgs_g, sizes_g = batch["global"]
        feats_l = self.backbone(imgs_l)
        feats_g = self.backbone(imgs_g)
        with torch.no_grad():
            feats_m = self.backbone(imgs_m)
            m_props = self._ref_proposals(feats_m, sizes_m)
            g_props = self._ref_proposals(feats_g, sizes_g)
        objectness, deltas = self.rpn(feats_l)
        anchors = self._anchors(feats_l.shape[1], feats_l.shape[2], feats_l.device)
        losses, rois = self._train_rois(objectness[:1], deltas[:1], anchors, sizes_l[:1],
                                        gt, generator)
        l_props = rpn_postprocess(objectness.detach(), deltas.detach(), anchors, sizes_l,
                                  self._ref_sizes())
        x = self.extractor.extract_train(
            feats_l, feats_m, feats_g, rois.boxes[0], l_props.boxes, l_props.valid,
            m_props.boxes, m_props.valid, g_props.boxes, g_props.valid)
        return dict(losses, **self._box_losses(x, rois))

    def test_step(self, carry: MEGACarry, pairs: torch.Tensor, sizes: torch.Tensor):
        """Steady state: push each pair's local frame, apply its global frame,
        detect at the key slot. pairs (L, 2, H, W, C), sizes (L, 2, 2)."""
        entry, g_pooled, g_valid = self.precompute_pair(pairs, sizes)
        carry = self.push_carry(carry, entry, sizes[:, 0])
        carry = self.apply_global(carry, g_pooled, g_valid)
        return self.detect_key(carry)


def build_mega_flagship(canvas_h: int, canvas_w: int, device="cuda",
                        generator: torch.Generator | None = None, lanes: int = 1,
                        compute_dtype: str = "bfloat16"):
    """MEGA R-101 C4 in bf16 as the JAX ``build_mega_flagship`` configures it
    (3 stages, window 25 with the key at slot 12), its weights drawn on
    ``device`` from ``generator``. Frames arrive s2d(4)-packed
    (canvas_h/4, canvas_w/4, 48). Returns the model in eval mode.

    ``lanes`` is the lockstep lane count it is built for (the JAX package's
    ``batch``; 12 in its bench): it sizes nothing in the weights, which serve
    any lane count, and is kept as ``model.lanes`` for the engines.
    ``compute_dtype`` "float32" builds the same model in f32 (the MFU tool
    counts a step's FLOPs on the CPU so)."""
    if canvas_h % 16 or canvas_w % 16:
        raise ValueError("canvas sides must be multiples of 16")
    c = RCNNConfig(depth="R-101", compute_dtype=compute_dtype)
    v = VidConfig(method="mega", base_stage=3, all_frame_interval=25,
                  key_frame_location=12)
    return seeded_flagship(GeneralizedRCNNMEGA(c, v, device=device), device,
                           generator, lanes)
