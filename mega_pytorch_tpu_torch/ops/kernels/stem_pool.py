"""Stem epilogue: frozen-BN affine + relu + packed 3x3/2 maxpool.

Counterpart of ``mega_pytorch_tpu/ops/pallas/stem_pool.py``
(``stem_pool_packed``), unfolded layout only. The CUDA kernel is
``csrc/stem_pool.cu``: it replaces the Pallas ``_kernel``, is bound by one
read of ``y`` and a quarter-size write, and runs one thread per 8 output
channels with 16-byte loads (see the source note there).

Input ``y`` (N, T, U, 4*O) holds phase block (a'*2 + b')*O for stem-conv
output position (2t+a', 2u+b'); the output (N, T, U, O) is the exact pad-1
maxpool with -inf borders of relu(y*scale + shift), computed in f32 and
rounded once to y's dtype.
"""

from __future__ import annotations

import torch

from .build import check_launch, load_library


def stem_pool_packed_reference(
    y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, out_ch: int
) -> torch.Tensor:
    """Plain PyTorch version: two-op affine, relu, shifted-max chain."""
    n, t, u, _ = y.shape
    z = y.float() * scale.float()
    z = (z + shift.float()).clamp_min(0.0).reshape(n, t, u, 2, 2, out_ch)
    neg = torch.finfo(torch.float32).min
    prev_r = torch.cat([torch.full_like(z[:, :1, :, 1], neg), z[:, :-1, :, 1]], 1)
    r = torch.maximum(torch.maximum(z[:, :, :, 0], z[:, :, :, 1]), prev_r)
    prev_c = torch.cat([torch.full_like(r[:, :, :1, 1], neg), r[:, :, :-1, 1]], 2)
    out = torch.maximum(torch.maximum(r[..., 0, :], r[..., 1, :]), prev_c)
    return out.to(y.dtype)


def stem_pool_packed(
    y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, out_ch: int
) -> torch.Tensor:
    """(N, T, U, 4*O) → (N, T, U, O). A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel (counted in ``stem_pool_packed.launches``)."""
    if y.requires_grad or scale.requires_grad or shift.requires_grad:
        raise ValueError("stem_pool_packed is inference-only (input requires grad)")
    if y.dim() != 4 or y.shape[-1] != 4 * out_ch:
        raise ValueError(f"y must be (N, T, U, 4*{out_ch}), got {tuple(y.shape)}")
    if y.device.type == "cpu":
        return stem_pool_packed_reference(y, scale, shift, out_ch)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    if y.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"y must be bf16 or f32, got {y.dtype}")
    if not y.is_contiguous():
        raise ValueError("y must be contiguous (N, T, U, 4*O); permute the "
                         "channels_last conv output, do not copy it")
    if out_ch % 8:
        raise ValueError("out_ch must be a multiple of 8")
    for name, p in (("scale", scale), ("shift", shift)):
        if (p.device != y.device or p.dtype != torch.float32
                or p.shape != (4 * out_ch,) or not p.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous f32 (4*O,) on {y.device}")
    n, t, u, _ = y.shape
    out = torch.empty((n, t, u, out_ch), dtype=y.dtype, device=y.device)
    lib = load_library().lib
    status = lib.stem_pool_packed_launch(
        y.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
        n, t, u, out_ch, int(y.dtype == torch.bfloat16),
        torch.cuda.current_stream(y.device).cuda_stream,
    )
    check_launch(status, "stem_pool_packed")
    stem_pool_packed.launches += 1
    return out


stem_pool_packed.launches = 0
