"""Shared layers (counterpart of ``mega_pytorch_tpu/models/layers.py``) and
the port's stand-ins for flax ``nn.Conv`` / ``nn.Dense``.

Parameters are stored in f32 under PyTorch's names (``weight`` OIHW or
(out, in), ``bias``); ``dtype`` is the compute dtype, as in flax: inputs and
weights are cast to it and the layer returns it. ``cast_weights_`` stores the
weights in the compute dtype once, so a bf16 model does not cast per call.
Convolutions take and return NCHW tensors; the port keeps them in
``channels_last`` memory, so the NHWC views the public functions hand out
are free.

Norms: ``FrozenBatchNorm2d`` (buffers) and ``GroupNorm`` (trainable).

Initialisation follows the flax initialisers: ``init_std=None`` is
lecun-normal (variance 1/fan_in, truncated at two standard deviations),
``init_std=0.0`` zeros, otherwise normal(init_std); biases start at zero
(a ``Conv``'s at ``bias_init``: flax's ``constant``).

Also here: the ``DeformRoIPooling*`` modules of the detector zoo.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.deform_pool import deform_roi_pooling

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}  # TPU.COMPUTE_DTYPE
GN_GROUPS, GN_EPS = 32, 1e-5  # MODEL.GROUP_NORM's defaults, as the JAX make_norm fixes them


def lecun_normal_(w: torch.Tensor, fan_in: int, generator) -> torch.Tensor:
    # flax truncated_normal: std corrected for the truncation at +-2 sigma
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


@torch.no_grad()
def init_module_(module: nn.Module, generator, cast: bool = False) -> nn.Module:
    """Seeded initialisation of every submodule with an ``init_weights`` (the
    flax initialisers' distributions), with ``cast`` the weights stored in
    the compute dtype; returns the module in eval mode without gradients.
    For modules that are not detectors (``RCNNBase`` has its own walk)."""
    for m in module.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(generator)
    if cast:
        for m in module.modules():
            if hasattr(m, "cast_weights_"):
                m.cast_weights_()
    return module.eval().requires_grad_(False)


class _Weighted(nn.Module):
    init_std: float | None
    bias_init = 0.0

    def init_weights(self, generator) -> None:
        w = self.weight.data
        if self.init_std is None:
            lecun_normal_(w, w[0].numel(), generator)
        elif self.init_std == 0.0:
            w.zero_()
        else:
            w.normal_(0.0, self.init_std, generator=generator)
        if self.bias is not None:
            self.bias.data.fill_(self.bias_init)

    def cast_weights_(self) -> None:
        w = self.weight.data.to(self.dtype)
        if w.dim() == 4:
            w = w.contiguous(memory_format=torch.channels_last)
        self.weight.data = w
        if self.bias is not None:
            self.bias.data = self.bias.data.to(self.dtype)


class Conv(_Weighted):
    """flax ``nn.Conv``; ``groups`` is its ``feature_group_count`` (weight
    (out, in / groups, k, k))."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, padding=0, dilation=1,
                 bias=True, dtype=torch.float32, init_std=None, device=None, groups=1,
                 bias_init=0.0):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch // groups, kernel, kernel, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_ch, device=device))
                     if bias else None)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups = groups
        self.dtype, self.init_std, self.bias_init = dtype, init_std, bias_init

    def forward(self, x: torch.Tensor, weight: torch.Tensor | None = None) -> torch.Tensor:
        """``weight``: in place of the stored one (a bottleneck's folded
        weight, of the same shape)."""
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        weight = self.weight if weight is None else weight
        return F.conv2d(x.to(dt), weight.to(dt), bias, self.stride,
                        self.padding, self.dilation, self.groups)


class ConvTranspose(_Weighted):
    """flax ``nn.ConvTranspose(transpose_kernel=True)``: the gradient of a
    convolution. ``padding=0`` is flax's "VALID", output (in - 1) * stride +
    kernel; flax's "SAME" pads the dilated input by (k + s - 2) / 2 a side
    when s <= k - 1, which is ``padding = (k - s) / 2`` here (k=4, s=2:
    padding 1, output 2 * in). The weight is ``conv_transpose2d``'s (in,
    out, k, k); its ``w[0].numel()`` is flax's fan-in (out * k * k) for the
    (k, k, out, in) kernel."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, dtype=torch.float32,
                 device=None, padding=0):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(in_ch, out_ch, kernel, kernel, device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device))
        self.stride, self.padding = stride, padding
        self.dtype, self.init_std = dtype, None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                                  self.stride, self.padding)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.leaky_relu(x, negative_slope=0.1)`` (FlowNetS)."""
    return F.leaky_relu(x, 0.1)


class Dense(_Weighted):
    def __init__(self, in_features, out_features, dtype=torch.float32,
                 init_std=None, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))
        self.dtype, self.init_std = dtype, init_std

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class FrozenBatchNorm2d(nn.Module):
    """``x * scale + shift`` with ``scale = weight / sqrt(running_var)`` (no
    eps) and ``shift = bias - running_mean * scale``, computed in f32 and
    cast to the compute dtype once, when the buffers are set or loaded.
    Applies to NCHW tensors."""

    def __init__(self, features: int, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("weight", torch.ones(features, device=device))
        self.register_buffer("bias", torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))
        self.register_buffer("scale", torch.empty(0, device=device), persistent=False)
        self.register_buffer("shift", torch.empty(0, device=device), persistent=False)
        self.refresh()
        self.register_load_state_dict_post_hook(lambda m, _keys: m.refresh())

    def affine_f32(self) -> tuple[torch.Tensor, torch.Tensor]:
        scale = self.weight / torch.sqrt(self.running_var)
        return scale, self.bias - self.running_mean * scale

    def refresh(self) -> None:
        scale, shift = self.affine_f32()
        self.scale = scale.to(self.dtype)
        self.shift = shift.to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.view(-1, 1, 1) + self.shift.view(-1, 1, 1)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups, epsilon)``, by default the ResNets'
    32 groups and 1e-5 (FBNet's: 1 group and flax's default 1e-6): per
    sample, the channels in ``num_groups`` groups, each normalised over its
    channels and every position, then a trainable per-channel ``weight``
    (flax's ``scale``) and ``bias``. Statistics and the affine in f32, the
    result in ``dtype``. Applies to NCHW tensors (any number of trailing
    axes)."""

    def __init__(self, features: int, dtype=torch.float32, device=None,
                 num_groups: int = GN_GROUPS, eps: float = GN_EPS):
        super().__init__()
        self.dtype, self.num_groups, self.eps = dtype, num_groups, eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight.float(),
                         self.bias.float(), self.eps).to(self.dtype)
        if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
            # CUDA's group_norm returns NCHW memory; the port's NHWC views
            # (and the ROIAlign kernel) need channels_last
            y = y.contiguous(memory_format=torch.channels_last)
        return y


class DeformRoIPooling(nn.Module):
    """Deformable position-sensitive ROI pooling (``deform_pool_module.py``
    ``DeformRoIPooling``): ``ops.deform_pool.deform_roi_pooling`` with the
    offsets the caller passes, ignored with ``no_trans``. No parameters."""

    def __init__(self, spatial_scale, out_size, out_channels, no_trans, group_size=1,
                 part_size=None, sample_per_part=4, trans_std=0.0):
        super().__init__()
        self.out_size, self.no_trans = out_size, no_trans
        self.pool_args = (spatial_scale, out_size, out_channels)
        self.pool_kw = dict(group_size=group_size, part_size=part_size,
                            sample_per_part=sample_per_part, trans_std=trans_std)

    def _pool(self, data, rois, offset):
        """One pass, without offsets where ``offset`` is None."""
        return deform_roi_pooling(data, rois, offset, *self.pool_args, offset is None,
                                  **self.pool_kw)

    def forward(self, data, rois, offset=None):
        return self._pool(data, rois, None if self.no_trans else offset)


class DeformRoIPoolingPack(DeformRoIPooling):
    """``DeformRoIPoolingPack``: a pass without offsets feeds the offset MLP
    ``offset_fc0..2`` (its last layer zero-initialised, so the module starts
    as plain PS-ROI pooling), whose (R, 2, p, p) offsets drive a deformable
    second pass. data (H, W, C) NHWC, rois (R, 4) → (R, p, p, out_channels)
    f32; the MLP reads the first pass flattened in (h, w, c) order, as the
    JAX module does."""

    def __init__(self, spatial_scale, out_size, out_channels, no_trans, group_size=1,
                 part_size=None, sample_per_part=4, trans_std=0.0,
                 deform_fc_channels=1024, device=None):
        super().__init__(spatial_scale, out_size, out_channels, no_trans, group_size,
                         part_size, sample_per_part, trans_std)
        if not no_trans:
            p, fc = out_size, deform_fc_channels
            self.offset_fc0 = Dense(p * p * out_channels, fc, device=device)
            self.offset_fc1 = Dense(fc, fc, device=device)
            self.offset_fc2 = Dense(fc, p * p * 2, init_std=0.0, device=device)

    def _offsets(self, flat):
        p = self.out_size
        x = torch.relu(self.offset_fc1(torch.relu(self.offset_fc0(flat))))
        return self.offset_fc2(x).reshape(-1, 2, p, p)

    def forward(self, data, rois):
        first = self._pool(data, rois, None)
        if self.no_trans:
            return first
        return self._pool(data, rois, self._offsets(first.reshape(first.shape[0], -1)))


class ModulatedDeformRoIPoolingPack(DeformRoIPoolingPack):
    """``ModulatedDeformRoIPoolingPack``: ``DeformRoIPoolingPack`` times a
    sigmoid mask from the MLP ``mask_fc0..1`` on the first pass (its last
    layer zero-initialised: the mask starts at 0.5)."""

    def __init__(self, spatial_scale, out_size, out_channels, no_trans, group_size=1,
                 part_size=None, sample_per_part=4, trans_std=0.0,
                 deform_fc_channels=1024, device=None):
        super().__init__(spatial_scale, out_size, out_channels, no_trans, group_size,
                         part_size, sample_per_part, trans_std, deform_fc_channels, device)
        if not no_trans:
            p = out_size
            self.mask_fc0 = Dense(p * p * out_channels, deform_fc_channels, device=device)
            self.mask_fc1 = Dense(deform_fc_channels, p * p, init_std=0.0, device=device)

    def forward(self, data, rois):
        first = self._pool(data, rois, None)
        if self.no_trans:
            return first
        p = self.out_size
        flat = first.reshape(first.shape[0], -1)
        mask = torch.sigmoid(self.mask_fc1(torch.relu(self.mask_fc0(flat))))
        return self._pool(data, rois, self._offsets(flat)) * mask.reshape(-1, p, p, 1)
