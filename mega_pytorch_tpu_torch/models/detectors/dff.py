"""DFF streaming detector (counterpart of
``mega_pytorch_tpu/models/detectors/dff.py``, Deep Feature Flow):
inference, and ``forward_train`` on a (cur, ref) pair.

A key frame runs the backbone and keeps its normalized image and C4 map
(``make_key``); every frame, the key frame included, runs FlowNetS on the
(frame / 255, key / 255) pair, warps the key map along the flow, multiplies
it by the predicted scale map and runs the single-frame heads on the result
(``detect_non_key``). The engine decides which frames are keys. Every
tensor leads with the lane dimension.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...ops.warp import warp_by_flow
from ...utils.profiler import annotate
from ..backbone.flownet import FlowNetS
from ..roi_heads.inference import Detections
from .rcnn import GeneralizedRCNN, RCNNConfig
from .rdn import VidConfig


class DFFCarry(NamedTuple):
    key_image: torch.Tensor  # (L, H, W, 3) normalized key frame
    key_feats: torch.Tensor  # (L, h, w, 1024) its C4 map
    key_size: torch.Tensor  # (L, 2)


class GeneralizedRCNNDFF(GeneralizedRCNN):
    """The single-frame detector plus FlowNetS (with the scale branch for
    method "dff", without it for FGFA, which subclasses this)."""

    def __init__(self, c: RCNNConfig, v: VidConfig, device=None):
        super().__init__(c, device)
        self.v = v
        self.flownet = FlowNetS(v.method, self.dtype, device)

    def flow_and_scale(self, img_cur: torch.Tensor, img_ref: torch.Tensor):
        """Normalized frame pairs (B, H, W, 3) → the flownet's output for
        (cur / 255, ref / 255): flow (B, h, w, 2) (and the scale map)."""
        return self.flownet(torch.cat([img_cur / 255.0, img_ref / 255.0], -1))

    def warped_features(self, img_cur, img_ref, feats_ref) -> torch.Tensor:
        """The ref maps warped to the current frames, times the scale map, f32."""
        flow, scale_map = self.flow_and_scale(img_cur, img_ref)
        warped = warp_by_flow(feats_ref.float(), flow.float())
        return warped * scale_map.float()

    def forward_train(self, batch, gt: dict, generator: torch.Generator | None = None) -> dict:
        """batch = (normalized RGB frames (2, H, W, 3), [cur, ref], sizes
        (2, 2)) and cur's padded ground truth → the four losses: the backbone
        on the ref frame only, its map warped to cur and scaled, the
        single-frame heads on the result. Gradients reach FlowNetS through
        the warp and the scale map."""
        images, sizes = batch
        img_cur, img_ref = images[:1], images[1:2]
        feats = self.warped_features(img_cur, img_ref, self.backbone(img_ref))
        return self.detect_heads_train(feats, sizes[:1], gt, generator)

    def make_key(self, images: torch.Tensor, sizes: torch.Tensor) -> DFFCarry:
        """Normalized frames (L, H, W, 3) and sizes (L, 2) → each lane's key."""
        return DFFCarry(key_image=images, key_feats=self.backbone(images),
                        key_size=sizes)

    def detect_non_key(self, carry: DFFCarry, images: torch.Tensor,
                       sizes: torch.Tensor) -> Detections:
        feats = self.warped_features(images, carry.key_image, carry.key_feats)
        return self.detect_heads(feats, sizes)

    def detect_key(self, carry: DFFCarry, images, sizes) -> Detections:
        """A key frame still warps: the flow from a frame to itself is near
        zero, not zero, as the reference computes it unconditionally."""
        with annotate("detect_key"):
            return self.detect_non_key(carry, images, sizes)
