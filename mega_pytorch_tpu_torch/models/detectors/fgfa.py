"""FGFA streaming detector (counterpart of
``mega_pytorch_tpu/models/detectors/fgfa.py``, Flow-Guided Feature
Aggregation): inference, and ``forward_train`` on one sample's frames.

A window of ``all_frame_interval`` frames (19) caches, per frame, its
normalized image and its C4 map with the map's embedding (1024 + 2048
channels, the embedding computed on the unwarped map as the frame enters).
Every step FlowNetS runs on (key frame, cached frame) for all T frames, all
T cached maps and embeddings are warped to the key frame (slot
``key_frame_location``, 9) together, per-pixel cosine weights against the
key's warped embedding are softmaxed over the frames, and the weighted sum
of the warped maps goes through the single-frame heads. Every tensor leads
with the lane dimension; pushes build new tensors, as the JAX package does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...ops.warp import warp_by_flow
from ...utils.profiler import annotate
from ..backbone.flownet import EmbedNet
from ..roi_heads.inference import Detections
from .dff import GeneralizedRCNNDFF
from .rcnn import RCNNConfig
from .rdn import VidConfig, push


class FGFACarry(NamedTuple):
    images: torch.Tensor  # (L, T, H, W, 3) normalized frames
    features: torch.Tensor  # (L, T, h, w, 1024 + 2048) [C4 map ; embedding] f32
    sizes: torch.Tensor  # (L, T, 2)


def cosine_weights(embed_refs: torch.Tensor, embed_cur: torch.Tensor) -> torch.Tensor:
    """Per-pixel cosine similarity over the last axis, kept as size 1."""
    norm_r = torch.linalg.vector_norm(embed_refs, dim=-1, keepdim=True) + 1e-10
    norm_c = torch.linalg.vector_norm(embed_cur, dim=-1, keepdim=True) + 1e-10
    sim = (embed_refs * embed_cur).sum(-1, keepdim=True)
    return sim / (norm_r * norm_c)


class GeneralizedRCNNFGFA(GeneralizedRCNNDFF):
    def __init__(self, c: RCNNConfig, v: VidConfig, device=None):
        super().__init__(c, v, device)
        self.embednet = EmbedNet(self.dtype, device)

    def flow(self, img_cur: torch.Tensor, img_ref: torch.Tensor) -> torch.Tensor:
        return self.flow_and_scale(img_cur, img_ref).float()

    def forward_train(self, batch, gt: dict, generator: torch.Generator | None = None) -> dict:
        """batch = (normalized RGB frames (1 + ref_num, H, W, 3), cur first,
        sizes) and cur's padded ground truth → the four losses: every frame's
        map (f32), each ref's map warped along the flow of (cur, ref), the
        embedding net on [cur map, warped refs], cosine weights against cur's
        embedding softmaxed over the refs, and the heads on the weighted sum
        of the warped refs (cur's own map is not among them, as in the
        reference)."""
        images, sizes = batch
        n = images.shape[0] - 1
        feats = self.backbone(images).float()
        flow = self.flow(images[:1].expand(n, -1, -1, -1), images[1:])
        warped = warp_by_flow(feats[1:], flow)
        embeds = self.embednet(torch.cat([feats[:1], warped])).float()
        weights = torch.softmax(cosine_weights(embeds[1:], embeds[:1]), dim=0)
        agg = (weights * warped).sum(0, keepdim=True)
        return self.detect_heads_train(agg, sizes[:1], gt, generator)

    def precompute(self, images: torch.Tensor, sizes: torch.Tensor):
        """Normalized frames (L, H, W, 3) → window entries (image, [map ;
        embedding])."""
        with annotate("precompute"):
            feats = self.backbone(images)
            embeds = self.embednet(feats).float()
            return images, torch.cat([feats.float(), embeds], -1)

    def init_carry(self, entry, size: torch.Tensor) -> FGFACarry:
        """Fresh carries whose window holds each lane's entry in every slot
        (broadcast views)."""
        t = self.v.all_frame_interval

        def tile(a):
            return a[:, None].expand(a.shape[0], t, *a.shape[1:])

        img, fe = entry
        return FGFACarry(images=tile(img), features=tile(fe), sizes=tile(size))

    def push_carry(self, carry: FGFACarry, entry, size) -> FGFACarry:
        img, fe = entry
        return FGFACarry(images=push(carry.images, img),
                         features=push(carry.features, fe),
                         sizes=push(carry.sizes, size))

    def detect_key(self, carry: FGFACarry) -> Detections:
        """Detect at every lane's key slot → Detections (L, ...)."""
        with annotate("detect_key"):
            lanes, t = carry.images.shape[:2]
            k = self.v.key_frame_location
            cur = carry.images[:, k:k + 1].expand_as(carry.images)
            flow = self.flow(cur.flatten(0, 1), carry.images.flatten(0, 1))
            warped = warp_by_flow(carry.features.flatten(0, 1), flow).unflatten(0, (lanes, t))
            feats, embeds = warped[..., :1024], warped[..., 1024:]
            weights = torch.softmax(cosine_weights(embeds, embeds[:, k:k + 1]), dim=1)
            agg = (weights * feats).sum(1)
            return self.detect_heads(agg, carry.sizes[:, k])

    def test_step(self, carry: FGFACarry, images: torch.Tensor, sizes: torch.Tensor):
        carry = self.push_carry(carry, self.precompute(images, sizes), sizes)
        return carry, self.detect_key(carry)
