"""ResNet C4 backbone and dilated res5 head (counterpart of
``mega_pytorch_tpu/models/backbone/resnet.py``): frozen-BN bottlenecks with
the stride on the first 1x1 (``stride_in_1x1``), module names equal to the
flax scopes (``layer3.22.conv2``, ``stem.conv1``).

Public functions take and return NHWC; inside, convolutions run on NCHW
views of channels_last memory. In training, the stages below
``FREEZE_CONV_BODY_AT`` are frozen by ``requires_grad_(False)`` (``freeze_``),
which gives what the JAX package's stop_gradient after them gives.

``norm`` is "frozen_bn" (the ``*WithFixedBatchNorm`` variants) or "gn"
(``*WithGN``: ``GroupNorm`` with 32 groups, trainable); ``num_groups`` and
``width_per_group`` set the grouped 3x3 convolutions and the bottleneck
widths (ResNeXt), ``res2_out_channels`` and ``stem_out_channels`` the
stages' and the stem's widths, as in the JAX package. ``build_resnet_c4``
and ``build_res5_head`` read them from the config.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.kernels.bottleneck_epilogue import bottleneck_epilogue
from ...ops.kernels.stem_pool import stem_pool_packed
from ...utils.profiler import annotate
from ..layers import DTYPES, Conv, FrozenBatchNorm2d, GroupNorm, lecun_normal_

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


def make_norm(kind: str, features: int, dtype=torch.float32, device=None) -> nn.Module:
    """FrozenBN (the default) or GroupNorm-32 (``kind`` "gn"), the JAX
    package's ``make_norm``."""
    if kind == "gn":
        return GroupNorm(features, dtype, device)
    return FrozenBatchNorm2d(features, dtype, device)


def norm_of(cfg) -> str:
    """The config's norm: "gn" for the ``*WithGN`` transformation."""
    return "gn" if cfg.MODEL.RESNETS.TRANS_FUNC.endswith("WithGN") else "frozen_bn"


class Bottleneck(nn.Module):
    """conv1 (1x1) → conv2 (3x3, grouped, dilated) → conv3 (1x1), each with
    its norm, relu between, the identity or the downsample (1x1 conv and
    norm) added before the last relu.

    Under frozen BN, in eval mode and in a compute dtype narrower than f32
    (bf16, as served), the block runs folded: each convolution with weights
    ``W * scale`` (the f32 product rounded to the compute dtype once) and no
    bias, then one ``bottleneck_epilogue`` pass, ``relu(a + shift)``, the
    last one ``relu(a + shift3 + shift_down + r)`` with the identity or the
    folded downsample's output as ``r``. The folded weights and f32 shifts
    are buffers outside the state dict, made when the weights are cast
    (``cast_weights_``) or loaded in eval mode and on each return to eval
    mode; train mode drops them and runs the unfolded convolutions and
    norms, whose weights take the gradients. GN blocks and f32 blocks
    always run unfolded: in f32 the fold saves no rounding, and the f32
    models are the form the port is held to the JAX package in, op for op
    (the fold's reordered f32 roundings alone move a tiny MEGA's carried
    boxes by 1.3e-3 px against its 1e-3 px parity bound)."""

    FOLDED = ("w1", "w2", "w3", "w_down", "shift1", "shift2", "shift3")

    def __init__(self, in_channels, bottleneck_channels, out_channels, stride=1,
                 stride_in_1x1=True, dilation=1, dtype=torch.float32,
                 device=None, num_groups=1, norm="frozen_bn"):
        super().__init__()
        self.folds = norm != "gn" and dtype != torch.float32
        stride = 1 if dilation > 1 else stride
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        kw = dict(bias=False, dtype=dtype, device=device)
        if in_channels != out_channels:
            down_stride = stride if dilation == 1 else 1
            self.downsample_conv = Conv(in_channels, out_channels, 1,
                                        stride=down_stride, **kw)
            self.downsample_bn = make_norm(norm, out_channels, dtype, device)
        else:
            self.downsample_conv = None
        self.conv1 = Conv(in_channels, bottleneck_channels, 1, stride=s1, **kw)
        self.bn1 = make_norm(norm, bottleneck_channels, dtype, device)
        self.conv2 = Conv(bottleneck_channels, bottleneck_channels, 3, stride=s3,
                          padding=dilation, dilation=dilation, groups=num_groups, **kw)
        self.bn2 = make_norm(norm, bottleneck_channels, dtype, device)
        self.conv3 = Conv(bottleneck_channels, out_channels, 1, **kw)
        self.bn3 = make_norm(norm, out_channels, dtype, device)
        if self.folds:
            for name in self.FOLDED:
                self.register_buffer(name, torch.empty(0, device=device), persistent=False)
            self.register_load_state_dict_post_hook(
                lambda m, _keys: m._drop() if m.training else m._fold())

    @torch.no_grad()
    def _fold(self) -> None:
        def fold(conv, bn):
            scale, shift = bn.affine_f32()
            w = conv.weight.float() * scale.float().view(-1, 1, 1, 1)
            return w.to(conv.dtype).contiguous(memory_format=torch.channels_last), shift.float()

        self.w1, self.shift1 = fold(self.conv1, self.bn1)
        self.w2, self.shift2 = fold(self.conv2, self.bn2)
        self.w3, self.shift3 = fold(self.conv3, self.bn3)
        if self.downsample_conv is not None:
            self.w_down, shift_down = fold(self.downsample_conv, self.downsample_bn)
            self.shift3 = self.shift3 + shift_down

    def _drop(self) -> None:
        for name in self.FOLDED:
            setattr(self, name, self.w1.new_empty(0))

    def cast_weights_(self) -> None:
        """Fold from the weights as they are before the convolutions store
        theirs in the compute dtype (``modules()`` reaches the block first),
        so each folded weight is rounded once."""
        if self.folds:
            self._fold()

    def train(self, mode: bool = True):
        super().train(mode)
        if self.folds:
            if mode:
                self._drop()  # training changes the weights
            elif self.w1.numel() == 0:
                self._fold()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        if self.folds and not self.training:
            return self._forward_folded(x)
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return torch.relu(out + identity)

    def _forward_folded(self, x: torch.Tensor) -> torch.Tensor:
        identity = x.to(self.conv3.dtype).contiguous(memory_format=torch.channels_last)
        if self.downsample_conv is not None:
            identity = self.downsample_conv(x, self.w_down)
        out = bottleneck_epilogue(self.conv1(x, self.w1), self.shift1)
        out = bottleneck_epilogue(self.conv2(out, self.w2), self.shift2)
        return bottleneck_epilogue(self.conv3(out, self.w3), self.shift3, identity)


# 7x7 kernel offset u (padding 3, stride 2) → (4-tap offset d, input phase a)
# of the s2d(2) form: 2i + u - 3 = 2(i + d - 2) + a
_S2D_TAPS = {0: (0, 1), 1: (1, 0), 2: (1, 1), 3: (2, 0), 4: (2, 1),
             5: (3, 0), 6: (3, 1)}


def s2d_stem_kernel(w7: torch.Tensor) -> torch.Tensor:
    """Canonical stem kernel (O, C, 7, 7) → the exact space-to-depth-2
    equivalent (O, 4C, 4, 4) of a 4x4/1 conv with padding (2, 1) on both
    axes: input channel (a*2 + b)*C + c is pixel (2p + a, 2q + b, c); the
    (d=0, a=0) tap never occurs and stays zero."""
    o, c = w7.shape[0], w7.shape[1]
    w4 = torch.zeros((o, 4 * c, 4, 4), dtype=w7.dtype, device=w7.device)
    for u in range(7):
        du, a = _S2D_TAPS[u]
        for v in range(7):
            dv, b = _S2D_TAPS[v]
            w4[:, (a * 2 + b) * c:(a * 2 + b + 1) * c, du, dv] = w7[:, :, u, v]
    return w4


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
    """7x7/2 conv + norm + relu + 3x3/2 maxpool.

    A 48-channel s2d(4)-packed input runs the exact 3x3/1 reformulation and,
    under frozen BN, the ``stem_pool_packed`` kernel; under group norm the
    packed output is unpacked to the stem conv's map and takes the norm,
    relu and maxpool of the canonical form (GN's statistics are not a
    per-channel affine, so no kernel, as in the JAX package); a 12-channel
    s2d(2)-packed input the exact 4x4/1 reformulation, then the norm, relu
    and the maxpool as the canonical form (no kernel, as in the JAX
    package); a 3-channel input the canonical form. The packed kernels and
    the BN affine are derived from the canonical parameters once, at
    initialisation and whenever weights are loaded."""

    def __init__(self, out_channels=64, dtype=torch.float32, device=None, norm="frozen_bn"):
        super().__init__()
        self.out_channels, self.dtype, self.norm = out_channels, dtype, norm
        self.conv1 = _StemConv1(out_channels, device)
        self.bn1 = make_norm(norm, out_channels, dtype, device)
        self.register_buffer("w3", torch.empty(0, device=device), persistent=False)
        self.register_buffer("w4", torch.empty(0, device=device), persistent=False)
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
        self.w4 = s2d_stem_kernel(w7).to(self.dtype).contiguous(
            memory_format=torch.channels_last)
        if self.norm != "gn":
            scale, shift = self.bn1.affine_f32()
            self.scale4 = scale.float().repeat(4).contiguous()
            self.shift4 = shift.float().repeat(4).contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NHWC in, NCHW out
        dt = self.dtype
        if x.shape[-1] == 48:
            y = F.conv2d(nchw(x.to(dt)), self.w3, padding=1)  # (N, 4O, T, U)
            if self.norm != "gn":
                pooled = stem_pool_packed(nhwc(y), self.scale4, self.shift4,
                                          self.out_channels)
                return nchw(pooled)
            # channel (a' * 2 + b') * O + o holds stem output (2t + a', 2u + b', o)
            n, _, t, u = y.shape
            y = y.reshape(n, 2, 2, self.out_channels, t, u).permute(0, 3, 4, 1, 5, 2)
            y = y.reshape(n, self.out_channels, 2 * t, 2 * u)
        elif x.shape[-1] == 12:  # (left, right, top, bottom) = (2, 1, 2, 1)
            y = F.conv2d(F.pad(nchw(x.to(dt)), (2, 1, 2, 1)), self.w4)
        else:
            y = F.conv2d(nchw(x.to(dt)), self.conv1.weight.to(dt), stride=2, padding=3)
        y = torch.relu(self.bn1(y))
        return F.max_pool2d(y, 3, stride=2, padding=1)


class ResNetStage(nn.Sequential):
    """Bottlenecks named "0", "1", ...; the first carries stride/projection."""

    def __init__(self, block_count, in_channels, bottleneck_channels,
                 out_channels, first_stride, stride_in_1x1=True, dilation=1,
                 dtype=torch.float32, device=None, num_groups=1, norm="frozen_bn"):
        blocks = []
        for i in range(block_count):
            blocks.append(Bottleneck(
                in_channels if i == 0 else out_channels, bottleneck_channels,
                out_channels, first_stride if i == 0 else 1, stride_in_1x1,
                dilation, dtype, device, num_groups, norm,
            ))
        super().__init__(*blocks)


class ResNetC4(nn.Module):
    """Stem + stages 1..3: NHWC frames → NHWC C4 map (stride 16,
    ``4 * res2_out_channels`` channels: 1024)."""

    def __init__(self, depth="R-50", stride_in_1x1=True, dtype=torch.float32,
                 device=None, norm="frozen_bn", num_groups=1, width_per_group=64,
                 res2_out_channels=256, stem_out_channels=64):
        super().__init__()
        self.stem = Stem(stem_out_channels, dtype, device, norm)
        in_ch = stem_out_channels
        for stage_idx, count in enumerate(STAGE_SPECS[depth][:3], start=1):
            factor = 2 ** (stage_idx - 1)
            out_ch = res2_out_channels * factor
            setattr(self, f"layer{stage_idx}", ResNetStage(
                count, in_ch, num_groups * width_per_group * factor, out_ch,
                1 if stage_idx == 1 else 2, stride_in_1x1, 1, dtype, device,
                num_groups, norm,
            ))
            in_ch = out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with annotate("backbone"):
            y = self.stem(x)
            y = self.layer3(self.layer2(self.layer1(y)))
            return nhwc(y)

    def freeze_(self, freeze_at: int) -> None:
        """Training: the stem (``freeze_at`` >= 1) and each ``layer{i}`` with
        ``freeze_at`` >= i + 1 take no gradient (``FREEZE_CONV_BODY_AT``)."""
        stages = [self.stem] + [getattr(self, f"layer{i}") for i in (1, 2, 3)]
        for module in stages[:freeze_at]:
            module.requires_grad_(False)


class ResNetRes5Head(nn.Module):
    """Stage 5 as ``layer4``; the VID heads run it on the whole C4 map with
    ``stride_init=1`` and dilation 2. NHWC in and out."""

    def __init__(self, depth="R-50", stride_init=1, dilation=2,
                 stride_in_1x1=True, dtype=torch.float32, device=None,
                 norm="frozen_bn", num_groups=1, width_per_group=64,
                 res2_out_channels=256):
        super().__init__()
        self.out_channels = res2_out_channels * 8
        self.layer4 = ResNetStage(STAGE_SPECS[depth][3], res2_out_channels * 4,
                                  num_groups * width_per_group * 8, self.out_channels,
                                  stride_init, stride_in_1x1, dilation, dtype,
                                  device, num_groups, norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with annotate("res5"):
            return nhwc(self.layer4(nchw(x)))


def depth_of(cfg) -> str:
    """The config's depth: "R-50-C4" → "R-50"."""
    return "-".join(cfg.MODEL.BACKBONE.CONV_BODY.split("-")[:2])


def build_resnet_c4(cfg, device=None) -> ResNetC4:
    """The config's C4 body (the JAX ``build_resnet_c4``): depth, norm,
    groups and widths from ``MODEL.RESNETS``, the compute dtype from
    ``TPU.COMPUTE_DTYPE``; weights not drawn (``init_weights`` of each
    module, as ``RCNNBase.init_weights`` does), frozen below
    ``FREEZE_CONV_BODY_AT`` only when the caller trains (``freeze_``)."""
    r = cfg.MODEL.RESNETS
    return ResNetC4(depth_of(cfg), r.STRIDE_IN_1X1, DTYPES[cfg.TPU.COMPUTE_DTYPE], device,
                    norm_of(cfg), r.NUM_GROUPS, r.WIDTH_PER_GROUP, r.RES2_OUT_CHANNELS,
                    r.STEM_OUT_CHANNELS)


def build_res5_head(cfg, stride_init: int = 1, device=None) -> ResNetRes5Head:
    """The config's res5 head (the JAX ``build_res5_head``)."""
    r = cfg.MODEL.RESNETS
    return ResNetRes5Head(depth_of(cfg), stride_init, r.RES5_DILATION, r.STRIDE_IN_1X1,
                          DTYPES[cfg.TPU.COMPUTE_DTYPE], device, norm_of(cfg),
                          r.NUM_GROUPS, r.WIDTH_PER_GROUP, r.RES2_OUT_CHANNELS)
