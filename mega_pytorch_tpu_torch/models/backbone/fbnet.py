"""FBNet mobile backbone and head stage groups (counterpart of
``mega_pytorch_tpu/models/backbone/fbnet.py``; maskrcnn-benchmark's
``fbnet.py``, ``fbnet_builder.py`` and ``fbnet_modeldef.py``). An arch is a
table of [expansion t, channels c, repeats n, stride s] stages of inverted
residual blocks (1x1 expand, depthwise kxk, 1x1 project; each conv followed
by flax's ``GroupNorm(num_groups=1)``, eps 1e-6, and relu but the last;
residual when stride 1 keeps the width; a negative stride upsamples by
nearest neighbour before the depthwise conv), split into the trunk and the
rpn / bbox / mask head groups. Module names are the flax scopes' (``first``,
``first_bn``, ``block_{i}`` with ``pw``, ``pw_bn``, ``dw``, ``dw_bn``,
``pwl``, ``pwl_bn``). NHWC in and out; the norms return f32, as flax's do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import DTYPES, Conv, GroupNorm
from .resnet import nchw, nhwc

# [t, c, n, s] stage tables, the reference's arch zoo (fbnet_modeldef.py);
# "kernels" (optional) gives the depthwise kernel of each block of a stage,
# else the arch's "kernel"
MODEL_ARCH = {
    "default": {
        "first": [32, 2],
        "stages": [
            [[1, 16, 1, 1]],
            [[6, 24, 2, 2]],
            [[6, 32, 3, 2]],
            [[6, 64, 4, 2], [6, 96, 3, 1]],
            [[4, 160, 1, 2], [6, 160, 2, 1], [6, 240, 1, 1]],
            [[6, 96, 3, 1]],
            [[4, 160, 1, 1], [6, 160, 3, 1], [3, 80, 1, -2]],
        ],
        "backbone": [0, 1, 2, 3],
        "rpn": [5],
        "bbox": [4],
        "mask": [6],
        "kernel": 3,
    },
    "xirb16d_dsmask": {
        "first": [16, 2],
        "stages": [
            [[1, 16, 1, 1]],
            [[6, 32, 2, 2]],
            [[6, 48, 3, 2]],
            [[6, 96, 4, 2], [6, 128, 3, 1]],
            [[4, 128, 1, 2], [6, 128, 2, 1], [6, 160, 1, 1]],
            [[4, 128, 1, 2], [6, 128, 2, 1], [6, 128, 1, -2], [3, 64, 1, -2]],
            [[6, 128, 3, 1]],
        ],
        "backbone": [0, 1, 2, 3],
        "rpn": [6],
        "bbox": [4],
        "mask": [5],
        "kernel": 3,
    },
    "mobilenet_v2": {
        "first": [32, 2],
        "stages": [
            [[1, 16, 1, 1]],
            [[6, 24, 2, 2]],
            [[6, 32, 3, 2]],
            [[6, 64, 4, 2], [6, 96, 3, 1]],
            [[6, 160, 3, 1], [6, 320, 1, 1]],
        ],
        "backbone": [0, 1, 2, 3],
        "bbox": [4],
        "kernel": 3,
    },
    "cham_v1a": {
        "first": [32, 2],
        "stages": [
            [[1, 24, 1, 1]],
            [[4, 48, 2, 2]],
            [[7, 64, 5, 2]],
            [[12, 56, 7, 2], [8, 88, 5, 1]],
            [[7, 152, 4, 2], [10, 104, 1, 1]],
            [[8, 88, 3, 1]],
        ],
        "kernels": [
            [3],
            [7] * 2,
            [3] * 5,
            [5] * 7 + [3] * 5,
            [3] * 5,
            [3] * 3,
        ],
        "backbone": [0, 1, 2, 3],
        "rpn": [5],
        "bbox": [4],
        "kernel": 3,
    },
    "cham_v2": {
        "first": [32, 2],
        "stages": [
            [[1, 24, 1, 1]],
            [[8, 32, 4, 2]],
            [[5, 48, 6, 2]],
            [[9, 56, 3, 2], [6, 56, 6, 1]],
            [[2, 160, 6, 2], [6, 112, 1, 1]],
            [[6, 56, 1, 1]],
        ],
        "kernels": [
            [3],
            [5] * 4,
            [7] * 6,
            [5] * 3 + [3] * 6,
            [3] * 7,
            [3],
        ],
        "backbone": [0, 1, 2, 3],
        "rpn": [5],
        "bbox": [4],
        "kernel": 3,
    },
}


def add_archs(archs: dict) -> None:
    for name, spec in archs.items():
        assert name not in MODEL_ARCH, f"Duplicated model name {name}"
        MODEL_ARCH[name] = spec


def _scale_channels(c: int, scale: float, divisor: int = 1) -> int:
    c = int(c * scale)
    return max(divisor, (c + divisor // 2) // divisor * divisor)


def _norm(features, device):
    return GroupNorm(features, torch.float32, device, num_groups=1, eps=1e-6)


class IRFBlock(nn.Module):
    """Inverted residual: 1x1 expand (none when ``expansion`` is 1), depthwise
    kxk (``groups=mid``), 1x1 project. NCHW in and out."""

    def __init__(self, in_channels, out_channels, expansion, stride, kernel=3,
                 dtype=torch.float32, device=None):
        super().__init__()
        mid = in_channels * expansion
        kw = dict(bias=False, dtype=dtype, device=device)
        self.expansion, self.stride = expansion, stride
        self.residual = stride == 1 and in_channels == out_channels
        if expansion != 1:
            self.pw = Conv(in_channels, mid, 1, **kw)
            self.pw_bn = _norm(mid, device)
        self.dw = Conv(mid, mid, kernel, stride=max(stride, 1), padding=kernel // 2,
                       groups=mid, **kw)
        self.dw_bn = _norm(mid, device)
        self.pwl = Conv(mid, out_channels, 1, **kw)
        self.pwl_bn = _norm(out_channels, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        if self.expansion != 1:
            y = torch.relu(self.pw_bn(self.pw(y)))
        if self.stride < 0:
            y = F.interpolate(y, scale_factor=-self.stride, mode="nearest")
        y = torch.relu(self.dw_bn(self.dw(y)))
        y = self.pwl_bn(self.pwl(y))
        return y + x if self.residual else y


class FBNetTrunk(nn.Module):
    """The ``first`` conv (3x3, images; none when ``in_channels`` is given)
    and the blocks of the arch's ``stage_group``."""

    def __init__(self, arch="default", width_scale=1.0, width_divisor=1,
                 stage_group="backbone", in_channels: int | None = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        spec = MODEL_ARCH[arch]
        kw = dict(dtype=dtype, device=device)
        if in_channels is None:
            c_first, s_first = spec["first"]
            c_first = _scale_channels(c_first, width_scale, width_divisor)
            self.first = Conv(3, c_first, 3, stride=s_first, padding=1, bias=False, **kw)
            self.first_bn = _norm(c_first, device)
            in_channels = c_first
        else:
            self.first = None
        blocks = []
        for stage_idx in spec[stage_group]:
            stage_kernels = spec.get("kernels", [None] * len(spec["stages"]))[stage_idx]
            k_pos = 0
            for t, c, n, s in spec["stages"][stage_idx]:
                c = _scale_channels(c, width_scale, width_divisor)
                for i in range(n):
                    kernel = (stage_kernels[k_pos] if stage_kernels is not None
                              else spec.get("kernel", 3))
                    blocks.append(IRFBlock(in_channels, c, t, s if i == 0 else 1, kernel,
                                           **kw))
                    in_channels = c
                    k_pos += 1
        for i, block in enumerate(blocks):
            setattr(self, f"block_{i}", block)
        self.num_blocks, self.out_channels = len(blocks), in_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = nchw(x)
        if self.first is not None:
            y = torch.relu(self.first_bn(self.first(y)))
        for i in range(self.num_blocks):
            y = getattr(self, f"block_{i}")(y)
        return nhwc(y)


def build_fbnet_backbone(cfg, device=None) -> FBNetTrunk:
    """``MODEL.FBNET`` → the trunk (``backbone.py``'s ``add_conv_body``);
    weights not drawn (``init_weights`` of each module)."""
    f = cfg.MODEL.FBNET
    return FBNetTrunk(f.ARCH, f.SCALE_FACTOR, f.WIDTH_DIVISOR, "backbone",
                      dtype=DTYPES[cfg.TPU.COMPUTE_DTYPE], device=device)


def build_fbnet_head(cfg, group: str, in_channels: int, device=None) -> FBNetTrunk:
    """The ``rpn`` / ``bbox`` / ``mask`` stage group on ``in_channels``."""
    f = cfg.MODEL.FBNET
    return FBNetTrunk(f.ARCH, f.SCALE_FACTOR, f.WIDTH_DIVISOR, group, in_channels,
                      dtype=DTYPES[cfg.TPU.COMPUTE_DTYPE], device=device)
