"""FPN backbones (counterpart of ``mega_pytorch_tpu/models/backbone/fpn.py``;
maskrcnn-benchmark's ``fpn.py`` and the R-*-FPN bodies of ``backbone.py``):
a ResNet body that returns every stage's map (C2..C5), then lateral 1x1
convolutions, a top-down nearest 2x upsample and 3x3 output convolutions,
with ``LastLevelMaxPool`` (Faster / Mask R-CNN) or ``LastLevelP6P7``
(RetinaNet) on top. Module names are the flax scopes'. NHWC in and out;
the convolutions run on NCHW views.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv
from .resnet import STAGE_SPECS, ResNetStage, Stem, nchw, nhwc


class ResNetFPNBody(nn.Module):
    """Stem (on RGB, s2d(2)- or s2d(4)-packed frames: ``resnet.Stem``) and
    stages ``layer1..4`` → [C2, C3, C4, C5] NHWC. Outputs of the stem
    (``freeze_at`` >= 1) and of ``layer{i}`` (``freeze_at`` >= i + 1) are
    detached, as the JAX body stops their gradients."""

    def __init__(self, depth="R-50", freeze_at=2, stride_in_1x1=True,
                 res2_out_channels=256, stem_out_channels=64, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.freeze_at = freeze_at
        self.stem = Stem(stem_out_channels, dtype, device)
        in_ch = stem_out_channels
        self.out_channels = []
        for stage_idx, count in enumerate(STAGE_SPECS[depth], start=1):
            factor = 2 ** (stage_idx - 1)
            out_ch = res2_out_channels * factor
            setattr(self, f"layer{stage_idx}", ResNetStage(
                count, in_ch, 64 * factor, out_ch, 1 if stage_idx == 1 else 2,
                stride_in_1x1, 1, dtype, device))
            self.out_channels.append(out_ch)
            in_ch = out_ch

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        y = self.stem(x)
        if self.freeze_at >= 1:
            y = y.detach()
        outs = []
        for stage_idx in range(1, 5):
            y = getattr(self, f"layer{stage_idx}")(y)
            if self.freeze_at >= stage_idx + 1:
                y = y.detach()
            outs.append(nhwc(y))
        return outs


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x of an NCHW map (``F.interpolate(scale_factor=2)``)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class FPN(nn.Module):
    """Lateral + top-down pyramid. ``in_channels`` gives each input's width;
    a leading None stands for an input the caller leaves out (RetinaNet's
    [None, C3, C4, C5]) and shifts the level names by one: ``fpn_inner2..5``
    / ``fpn_layer2..5`` for [C2..C5], ``..3..5`` for [None, C3, C4, C5].
    ``top_block`` "maxpool" appends a stride-2 subsample of the last level
    (flax ``max_pool((1, 1), strides=(2, 2))``), "p6p7" two 3x3/2 convs
    ``p6`` and ``p7`` (relu between) from the last input (C5,
    ``p6p7_in_from_c5``) or the last level, "none" nothing."""

    def __init__(self, out_channels=256, top_block="maxpool", p6p7_in_from_c5=True,
                 in_channels: Sequence[int | None] = (256, 512, 1024, 2048),
                 dtype=torch.float32, device=None):
        super().__init__()
        if top_block not in ("maxpool", "p6p7", "none"):
            raise ValueError(f"unknown top block {top_block!r}")
        self.top_block, self.from_c5 = top_block, p6p7_in_from_c5
        widths = [c for c in in_channels if c is not None]
        self.offset = len(in_channels) - len(widths) + 2
        self.levels = len(widths)
        kw = dict(dtype=dtype, device=device)
        for i, c in enumerate(widths):
            setattr(self, f"fpn_inner{self.offset + i}", Conv(c, out_channels, 1, **kw))
            setattr(self, f"fpn_layer{self.offset + i}",
                    Conv(out_channels, out_channels, 3, padding=1, **kw))
        if top_block == "p6p7":
            src = widths[-1] if p6p7_in_from_c5 else out_channels
            self.p6 = Conv(src, out_channels, 3, stride=2, padding=1, **kw)
            self.p7 = Conv(out_channels, out_channels, 3, stride=2, padding=1, **kw)

    def forward(self, inputs: Sequence[torch.Tensor | None]) -> list[torch.Tensor]:
        """NHWC maps (None where ``in_channels`` has None) → NHWC levels."""
        feats = [nchw(f) for f in inputs if f is not None]
        top = self.offset + self.levels - 1
        inner = getattr(self, f"fpn_inner{top}")(feats[-1])
        results = [getattr(self, f"fpn_layer{top}")(inner)]
        for i in range(self.levels - 2, -1, -1):
            lateral = getattr(self, f"fpn_inner{self.offset + i}")(feats[i])
            inner = lateral + upsample2x(inner)
            results.insert(0, getattr(self, f"fpn_layer{self.offset + i}")(inner))
        if self.top_block == "maxpool":
            results.append(results[-1][:, :, ::2, ::2])
        elif self.top_block == "p6p7":
            p6 = self.p6(feats[-1] if self.from_c5 else results[-1])
            results.extend([p6, self.p7(torch.relu(p6))])
        return [nhwc(r) for r in results]
