"""Bottleneck epilogue: ``y = relu(a + shift (+ r))``, the elementwise tail of
a frozen-BN bottleneck convolution whose BN scale is folded into its
weights (``models/backbone/resnet.py:Bottleneck``).

``a`` is the convolution's output, ``r`` the block's identity or its
downsample's output (on the last convolution only), ``shift`` the f32
per-channel BN shift (the last pass's holds the downsample's too). The sums
run in f32, ``a + shift`` first, and are rounded once to ``a``'s dtype.

The CUDA kernel is ``csrc/bottleneck_epilogue.cu``: one pass over NHWC
memory, 16-byte loads and stores, bound by reading ``a`` and ``r`` once and
writing ``y`` once. It replaces no TPU kernel (XLA fuses the JAX package's
FrozenBN, relu and residual add into its convolutions); it stands where the
plain forward ran three or four elementwise passes a convolution.
"""

from __future__ import annotations

import torch

from .build import check_launch, load_library

KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def bottleneck_epilogue_reference(a: torch.Tensor, shift: torch.Tensor,
                                  residual: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version on (N, C, H, W) maps: f32 sums, relu, one rounding."""
    y = a.float() + shift.float().view(-1, 1, 1)
    if residual is not None:
        y = y + residual.float()
    return torch.relu(y).to(a.dtype)


def check_kernel_operands(a: torch.Tensor, shift: torch.Tensor,
                          residual: torch.Tensor | None) -> None:
    """What the kernel takes: (N, C, H, W) bf16 or f32 CUDA maps in
    channels_last memory whose channel rows are whole 16-byte vectors (C a
    multiple of 8 in bf16, 4 in f32) and start 16-byte aligned, a residual
    of the same shape, dtype and layout, a contiguous f32 (C,) shift on the
    same device, nothing that requires grad."""
    if a.dim() != 4:
        raise ValueError(f"a must be (N, C, H, W), got {tuple(a.shape)}")
    if a.device.type != "cuda" or a.dtype not in KERNEL_DTYPES:
        raise ValueError(f"the kernel takes bf16 or f32 CUDA maps, got {a.dtype} on {a.device}")
    if not a.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("a must be channels_last (NHWC memory)")
    c = a.shape[1]
    per_vector = 16 // a.element_size()
    if c % per_vector or c // per_vector > 1024:
        raise ValueError(f"the kernel takes channels in whole 16-byte vectors (a multiple of "
                         f"{per_vector} up to {1024 * per_vector} for {a.dtype}), got {c}")
    if (shift.device != a.device or shift.dtype != torch.float32 or shift.shape != (c,)
            or not shift.is_contiguous()):
        raise ValueError(f"shift must be a contiguous f32 ({c},) on {a.device}")
    if residual is not None and (
            residual.shape != a.shape or residual.dtype != a.dtype
            or residual.device != a.device
            or not residual.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"the residual must match a ({tuple(a.shape)} {a.dtype} "
                         f"channels_last), got {tuple(residual.shape)} {residual.dtype}")
    if any(t is not None and t.data_ptr() % 16 for t in (a, residual)):
        raise ValueError("the maps must be 16-byte aligned")
    if a.requires_grad or (residual is not None and residual.requires_grad):
        raise ValueError("bottleneck_epilogue is inference-only (input requires grad)")


def _launch(a, shift, residual, lib=None):
    """One launch on checked operands → y like ``a`` (channels_last)."""
    y = torch.empty_like(a)
    lib = load_library().lib if lib is None else lib
    status = lib.bottleneck_epilogue_launch(
        a.data_ptr(), None if residual is None else residual.data_ptr(), shift.data_ptr(),
        y.data_ptr(), a.numel(), a.shape[1], int(a.dtype == torch.bfloat16),
        torch.cuda.current_stream(a.device).cuda_stream)
    check_launch(status, "bottleneck_epilogue")
    return y


def bottleneck_epilogue(a: torch.Tensor, shift: torch.Tensor,
                        residual: torch.Tensor | None = None) -> torch.Tensor:
    """``relu(a + shift (+ residual))`` on (N, C, H, W) maps. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (counted in
    ``bottleneck_epilogue.launches``), which raises on what it does not
    take."""
    if a.device.type == "cpu":
        return bottleneck_epilogue_reference(a, shift, residual)
    check_kernel_operands(a, shift, residual)
    y = _launch(a, shift, residual)
    bottleneck_epilogue.launches += 1
    return y


bottleneck_epilogue.launches = 0
