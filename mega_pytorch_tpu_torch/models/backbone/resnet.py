"""ResNet C4 backbone and dilated res5 head (counterpart of
``mega_pytorch_tpu/models/backbone/resnet.py``): frozen-BN bottlenecks with
the stride on the first 1x1 (``stride_in_1x1``), module names equal to the
flax scopes (``layer3.22.conv2``, ``stem.conv1``).

Public functions take and return NHWC; inside, convolutions run on NCHW
views of channels_last memory. Frozen stages need no stop-gradient: the port
runs inference only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.kernels.stem_pool import stem_pool_packed
from ..layers import Conv, FrozenBatchNorm2d, lecun_normal_

STAGE_SPECS = {
    "R-14": (1, 1, 1, 1),
    "R-50": (3, 4, 6, 3),
    "R-101": (3, 4, 23, 3),
    "R-152": (3, 8, 36, 3),
}


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor → NCHW view (channels_last memory when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW tensor → NHWC view (contiguous when x is channels_last)."""
    return x.permute(0, 2, 3, 1)


class Bottleneck(nn.Module):
    def __init__(self, in_channels, bottleneck_channels, out_channels, stride=1,
                 stride_in_1x1=True, dilation=1, dtype=torch.float32,
                 device=None):
        super().__init__()
        stride = 1 if dilation > 1 else stride
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        kw = dict(bias=False, dtype=dtype, device=device)
        if in_channels != out_channels:
            down_stride = stride if dilation == 1 else 1
            self.downsample_conv = Conv(in_channels, out_channels, 1,
                                        stride=down_stride, **kw)
            self.downsample_bn = FrozenBatchNorm2d(out_channels, dtype, device)
        else:
            self.downsample_conv = None
        self.conv1 = Conv(in_channels, bottleneck_channels, 1, stride=s1, **kw)
        self.bn1 = FrozenBatchNorm2d(bottleneck_channels, dtype, device)
        self.conv2 = Conv(bottleneck_channels, bottleneck_channels, 3, stride=s3,
                          padding=dilation, dilation=dilation, **kw)
        self.bn2 = FrozenBatchNorm2d(bottleneck_channels, dtype, device)
        self.conv3 = Conv(bottleneck_channels, out_channels, 1, **kw)
        self.bn3 = FrozenBatchNorm2d(out_channels, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return torch.relu(out + identity)


def s2d4_stem_kernel(w7: torch.Tensor) -> torch.Tensor:
    """Canonical stem kernel (O, C, 7, 7) → the exact space-to-depth-4
    equivalent (4O, 16C, 3, 3): output block (a', b') holds stem-conv output
    (2t+a', 2u+b'), input channel (a*4+b)*C+c is pixel (4p+a, 4q+b, c)."""
    o, c = w7.shape[0], w7.shape[1]
    w3 = torch.zeros((4 * o, 16 * c, 3, 3), dtype=w7.dtype, device=w7.device)
    for ap in range(2):
        for u in range(7):
            du, a = divmod(2 * ap - 3 + u, 4)
            for bp in range(2):
                for v in range(7):
                    dv, b = divmod(2 * bp - 3 + v, 4)
                    w3[(ap * 2 + bp) * o:(ap * 2 + bp + 1) * o,
                       (a * 4 + b) * c:(a * 4 + b + 1) * c,
                       du + 1, dv + 1] = w7[:, :, u, v]
    return w3


class _StemConv1(nn.Module):
    """Holds the canonical (O, 3, 7, 7) stem kernel at ``stem.conv1.weight``."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, 3, 7, 7, device=device))


class Stem(nn.Module):
    """7x7/2 conv + frozen BN + relu + 3x3/2 maxpool.

    A 48-channel s2d(4)-packed input runs the exact 3x3/1 reformulation and
    the ``stem_pool_packed`` kernel; a 3-channel input runs the canonical
    form. The packed kernel and the BN affine are derived from the canonical
    parameters once, at initialisation and whenever weights are loaded."""

    def __init__(self, out_channels=64, dtype=torch.float32, device=None):
        super().__init__()
        self.out_channels, self.dtype = out_channels, dtype
        self.conv1 = _StemConv1(out_channels, device)
        self.bn1 = FrozenBatchNorm2d(out_channels, dtype, device)
        self.register_buffer("w3", torch.empty(0, device=device), persistent=False)
        self.register_buffer("scale4", torch.empty(0, device=device), persistent=False)
        self.register_buffer("shift4", torch.empty(0, device=device), persistent=False)
        self.register_load_state_dict_post_hook(lambda m, _keys: m.refresh())

    def init_weights(self, generator) -> None:
        lecun_normal_(self.conv1.weight.data, 7 * 7 * 3, generator)
        self.refresh()

    @torch.no_grad()
    def refresh(self) -> None:
        w7 = self.conv1.weight.detach().float()
        self.w3 = s2d4_stem_kernel(w7).to(self.dtype).contiguous(
            memory_format=torch.channels_last)
        scale, shift = self.bn1.affine_f32()
        self.scale4 = scale.float().repeat(4).contiguous()
        self.shift4 = shift.float().repeat(4).contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NHWC in, NCHW out
        dt = self.dtype
        if x.shape[-1] == 48:
            y = F.conv2d(nchw(x.to(dt)), self.w3, padding=1)  # (N, 4O, T, U)
            pooled = stem_pool_packed(nhwc(y), self.scale4, self.shift4,
                                      self.out_channels)
            return nchw(pooled)
        y = F.conv2d(nchw(x.to(dt)), self.conv1.weight.to(dt), stride=2, padding=3)
        y = torch.relu(self.bn1(y))
        return F.max_pool2d(y, 3, stride=2, padding=1)


class ResNetStage(nn.Sequential):
    """Bottlenecks named "0", "1", ...; the first carries stride/projection."""

    def __init__(self, block_count, in_channels, bottleneck_channels,
                 out_channels, first_stride, stride_in_1x1=True, dilation=1,
                 dtype=torch.float32, device=None):
        blocks = []
        for i in range(block_count):
            blocks.append(Bottleneck(
                in_channels if i == 0 else out_channels, bottleneck_channels,
                out_channels, first_stride if i == 0 else 1, stride_in_1x1,
                dilation, dtype, device,
            ))
        super().__init__(*blocks)


class ResNetC4(nn.Module):
    """Stem + stages 1..3: NHWC frames → NHWC C4 map (stride 16, 1024 ch)."""

    def __init__(self, depth="R-50", stride_in_1x1=True, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.stem = Stem(64, dtype, device)
        in_ch = 64
        for stage_idx, count in enumerate(STAGE_SPECS[depth][:3], start=1):
            factor = 2 ** (stage_idx - 1)
            out_ch = 256 * factor
            setattr(self, f"layer{stage_idx}", ResNetStage(
                count, in_ch, 64 * factor, out_ch,
                1 if stage_idx == 1 else 2, stride_in_1x1, 1, dtype, device,
            ))
            in_ch = out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.stem(x)
        y = self.layer3(self.layer2(self.layer1(y)))
        return nhwc(y)


class ResNetRes5Head(nn.Module):
    """Stage 5 as ``layer4``; the VID heads run it on the whole C4 map with
    ``stride_init=1`` and dilation 2. NHWC in and out."""

    def __init__(self, depth="R-50", stride_init=1, dilation=2,
                 stride_in_1x1=True, dtype=torch.float32, device=None):
        super().__init__()
        self.layer4 = ResNetStage(STAGE_SPECS[depth][3], 1024, 512, 2048,
                                  stride_init, stride_in_1x1, dilation, dtype,
                                  device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nhwc(self.layer4(nchw(x)))
