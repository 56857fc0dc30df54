"""FlowNetS and FGFA's embedding net (counterpart of
``mega_pytorch_tpu/models/backbone/flownet.py``), inference.

FlowNetS takes two frames stacked on the channels (6 channels, each frame
scaled to [0, 1]), average-pools them 2x, runs a 6-level encoder (leaky ReLU
0.1) and a 4-level decoder whose transposed convolutions are cropped to the
skip connection's size (``_crop_like``), and predicts flow at stride 16 of
the input, after a last ceil-mode 2x average pool, scaled by 2.5. With
method "dff" a zero-initialised 1x1 convolution ``Convolution5_scale`` adds a
1024-channel scale map (+1). Module names are the flax scopes'. NHWC in and
out; the convolutions run on NCHW views.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.profiler import annotate
from ..layers import Conv, ConvTranspose, leaky_relu
from .resnet import nchw, nhwc


def _avgpool2_ceil(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 average pool of NCHW ``x`` in ceil mode: a window cut by the
    border averages its valid cells only."""
    return F.avg_pool2d(x, 2, 2, ceil_mode=True)


def _crop_like(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The reference's ``crop_like``: rows and columns [1 : size + 1] of
    NCHW ``x`` where its size differs from ``target``'s."""
    th, tw = target.shape[-2:]
    if x.shape[-2:] == target.shape[-2:]:
        return x
    return x[:, :, 1:th + 1, 1:tw + 1]


# encoder: (name, in, out, kernel, stride)
_ENCODER = (("flow_conv1", 6, 64, 7, 2), ("conv2", 64, 128, 5, 2),
            ("conv3", 128, 256, 5, 2), ("conv3_1", 256, 256, 3, 1),
            ("conv4", 256, 512, 3, 2), ("conv4_1", 512, 512, 3, 1),
            ("conv5", 512, 512, 3, 2), ("conv5_1", 512, 512, 3, 1),
            ("conv6", 512, 1024, 3, 2), ("conv6_1", 1024, 1024, 3, 1))
# decoder levels: (flow conv, its input channels, flow upsampler, deconv,
# deconv's output channels, encoder output the level joins)
_DECODER = (("Convolution1", 1024, "upsample_flow6to5", "deconv5", 512, "conv5_1"),
            ("Convolution2", 1026, "upsample_flow5to4", "deconv4", 256, "conv4_1"),
            ("Convolution3", 770, "upsample_flow4to3", "deconv3", 128, "conv3_1"),
            ("Convolution4", 386, "upsample_flow3to2", "deconv2", 64, "conv2"))


class FlowNetS(nn.Module):
    def __init__(self, method="fgfa", dtype=torch.float32, device=None):
        super().__init__()
        self.method = method
        for name, cin, cout, k, s in _ENCODER:
            setattr(self, name, Conv(cin, cout, k, stride=s, padding=k // 2,
                                     dtype=dtype, device=device))
        for flow_conv, cin, up, deconv, dout, _ in _DECODER:
            setattr(self, flow_conv, Conv(cin, 2, 3, padding=1, dtype=dtype,
                                          device=device))
            setattr(self, up, ConvTranspose(2, 2, 4, 2, dtype, device))
            setattr(self, deconv, ConvTranspose(cin, dout, 4, 2, dtype, device))
        self.Convolution5 = Conv(194, 2, 3, padding=1, dtype=dtype, device=device)
        if method == "dff":
            self.Convolution5_scale = Conv(194, 1024, 1, bias=False, dtype=dtype,
                                           init_std=0.0, device=device)

    def forward(self, x: torch.Tensor):
        """x (B, H, W, 6), two frames in [0, 1] → flow (B, H/16, W/16, 2)
        (and, for "dff", the scale map (B, H/16, W/16, 1024)), NHWC."""
        with annotate("flownet"):
            y = _avgpool2_ceil(nchw(x))
            skips = {}
            for name, *_ in _ENCODER:
                y = leaky_relu(getattr(self, name)(y))
                skips[name] = y
            for flow_conv, _, up, deconv, _, skip in _DECODER:
                target = skips[skip]
                flow = getattr(self, flow_conv)(y)
                up_flow = _crop_like(getattr(self, up)(flow), target)
                d = leaky_relu(_crop_like(getattr(self, deconv)(y), target))
                y = torch.cat([target, d, up_flow], 1)
            y = _avgpool2_ceil(y)
            flow = nhwc(self.Convolution5(y) * 2.5)
            if self.method == "dff":
                return flow, nhwc(self.Convolution5_scale(y) + 1.0)
            return flow


class EmbedNet(nn.Module):
    """FGFA's embedding: 1x1 1024→512, 3x3 512→512, 1x1 512→2048, ReLU
    between. NHWC in and out."""

    def __init__(self, dtype=torch.float32, device=None):
        super().__init__()
        self.embed_conv1 = Conv(1024, 512, 1, dtype=dtype, device=device)
        self.embed_conv2 = Conv(512, 512, 3, padding=1, dtype=dtype, device=device)
        self.embed_conv3 = Conv(512, 2048, 1, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.embed_conv1(nchw(x)))
        y = torch.relu(self.embed_conv2(y))
        return nhwc(self.embed_conv3(y))
