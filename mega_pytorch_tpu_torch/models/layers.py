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
``init_std=0.0`` zeros, otherwise normal(init_std); biases start at zero.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}  # TPU.COMPUTE_DTYPE
GN_GROUPS, GN_EPS = 32, 1e-5  # MODEL.GROUP_NORM's defaults, as the JAX make_norm fixes them


def lecun_normal_(w: torch.Tensor, fan_in: int, generator) -> torch.Tensor:
    # flax truncated_normal: std corrected for the truncation at +-2 sigma
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class _Weighted(nn.Module):
    init_std: float | None

    def init_weights(self, generator) -> None:
        w = self.weight.data
        if self.init_std is None:
            lecun_normal_(w, w[0].numel(), generator)
        elif self.init_std == 0.0:
            w.zero_()
        else:
            w.normal_(0.0, self.init_std, generator=generator)
        if self.bias is not None:
            self.bias.data.zero_()

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
                 bias=True, dtype=torch.float32, init_std=None, device=None, groups=1):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch // groups, kernel, kernel, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_ch, device=device))
                     if bias else None)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups = groups
        self.dtype, self.init_std = dtype, init_std

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                        self.padding, self.dilation, self.groups)


class ConvTranspose(_Weighted):
    """flax ``nn.ConvTranspose(transpose_kernel=True, padding="VALID")``:
    the gradient of a convolution, output (in - 1) * stride + kernel. The
    weight is ``conv_transpose2d``'s (in, out, k, k); its ``w[0].numel()`` is
    flax's fan-in (out * k * k) for the (k, k, out, in) kernel."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(in_ch, out_ch, kernel, kernel, device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device))
        self.stride, self.dtype, self.init_std = stride, dtype, None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                                  self.stride)


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
    """flax ``nn.GroupNorm(num_groups=32, epsilon=1e-5)``: per sample, the
    channels in 32 groups, each normalised over its channels and
    every position, then a trainable per-channel ``weight`` (flax's
    ``scale``) and ``bias``. Statistics and the affine in f32, the result in
    the compute dtype. Applies to NCHW tensors (any number of trailing
    axes)."""

    def __init__(self, features: int, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), GN_GROUPS, self.weight.float(), self.bias.float(),
                            GN_EPS).to(self.dtype)
