"""Shared layers (counterpart of ``mega_pytorch_tpu/models/layers.py``) and
the port's stand-ins for flax ``nn.Conv`` / ``nn.Dense``.

Parameters are stored in f32 under PyTorch's names (``weight`` OIHW or
(out, in), ``bias``); ``dtype`` is the compute dtype, as in flax: inputs and
weights are cast to it and the layer returns it. ``cast_weights_`` stores the
weights in the compute dtype once, so a bf16 model does not cast per call.
Convolutions take and return NCHW tensors; the port keeps them in
``channels_last`` memory, so the NHWC views the public functions hand out
are free.

Initialisation follows the flax initialisers: ``init_std=None`` is
lecun-normal (variance 1/fan_in, truncated at two standard deviations),
otherwise normal(init_std); biases start at zero.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


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
    def __init__(self, in_ch, out_ch, kernel, stride=1, padding=0, dilation=1,
                 bias=True, dtype=torch.float32, init_std=None, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch, kernel, kernel, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_ch, device=device))
                     if bias else None)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.dtype, self.init_std = dtype, init_std

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                        self.padding, self.dilation)


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
