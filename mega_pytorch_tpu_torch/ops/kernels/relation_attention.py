"""Flash relation attention (forward): modes "none", "compute" and "input".

Counterpart of ``mega_pytorch_tpu/ops/pallas/relation_attention.py``:
``flash_relation_attention`` replaces ``fused_relation_attention`` with no
bias (``_fused_fwd_batched`` bias_mode "none");
``flash_relation_attention_pos`` replaces ``fused_relation_attention_pos``
(bias_mode "compute": the position weight evaluated inside the kernel); and
``flash_relation_attention_bias`` replaces ``fused_relation_attention`` with a
precomputed log bias (bias_mode "input"). All three launch
``csrc/relation_attention.cu``: modes "none" and "input" its tensor-core
kernel, one block per (lane, group, 64 query rows); mode "compute" its
CUDA-core kernel, which shares each tile's position weight across the groups
(bound, design and numerics in its source note).

Layouts are the JAX package's: q (B, g, N, d), k and v (B, g, M, d), uk
(B, g, M), valid (B, M), rois (B, N, 4), ref_rois (B, M, 4), Wg (E, g),
bias (B, g, N, M).
The kernel takes g = 16, d = 64 and E = 64 (the MEGA configuration).
"""

from __future__ import annotations

import math

import torch

from .build import check_launch, load_library
from .position_bias import EMBED_DIM, GROUPS, kernel_params, reference_position_bias

NEG_INF = -1e30
HEAD_DIM = 64
REF_TILE = 64  # refs per tile of the kernels' online softmax
MODE_NONE, MODE_COMPUTE, MODE_INPUT = 0, 1, 2


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and compute on in f32 (a bf16 product is exact in f32,
    so f32 matmuls of rounded operands equal bf16 matmuls with f32 sums)."""
    return x.to(torch.bfloat16).float()


def reference_relation_attention(q, k, v, uk, bias, valid):
    """Plain version: (B, g, N, d) output with bf16 QK/PV operands, f32 sums.

    bias: (B, g, N, M) additive log bias, or None."""
    d = q.shape[-1]
    aff = _bf16(q) @ _bf16(k).transpose(-1, -2)
    aff = (aff + uk.float()[..., None, :]) * (1.0 / math.sqrt(d))
    if bias is not None:
        aff = aff + bias
    keep = valid[:, None, None, :]
    aff = torch.where(keep, aff, torch.full_like(aff, NEG_INF))
    soft = torch.softmax(aff, dim=-1)
    soft = torch.where(valid.any(-1)[:, None, None, None], soft, torch.zeros_like(soft))
    return _bf16(soft) @ _bf16(v)


def reference_relation_attention_tiled(q, k, v, uk, bias, valid):
    """The plain version in the kernels' order of rounding: refs in tiles of
    ``REF_TILE`` under the online softmax, p = exp(s - running max) rounded to
    bf16 before PV and normalised by the f32 sum at the end, as the Pallas
    kernel does. ``reference_relation_attention`` rounds the normalised
    softmax instead; where a few refs carry a row's weight the two differ by
    up to 2^-7 max|v| (two roundings to bf16, unit roundoff 2^-8 each)."""
    d = q.shape[-1]
    s = _bf16(q) @ _bf16(k).transpose(-1, -2)
    s = (s + uk.float()[..., None, :]) * (1.0 / math.sqrt(d))
    if bias is not None:
        s = s + bias
    keep = valid[:, None, None, :]
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    run_max = torch.full(q.shape[:-1], NEG_INF, device=q.device)
    run_sum = torch.zeros(q.shape[:-1], device=q.device)
    acc = torch.zeros(q.shape, device=q.device)
    for m0 in range(0, s.shape[-1], REF_TILE):
        st = s[..., m0:m0 + REF_TILE]
        new_max = torch.maximum(run_max, st.amax(-1))
        alpha = torch.exp(run_max - new_max)
        p = torch.where(keep[..., m0:m0 + REF_TILE], torch.exp(st - new_max[..., None]),
                        torch.zeros_like(st))
        run_sum = run_sum * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _bf16(p) @ _bf16(v[..., m0:m0 + REF_TILE, :])
        run_max = new_max
    pos = run_sum > 0
    return torch.where(pos[..., None], acc / torch.where(pos, run_sum, 1.0)[..., None],
                       torch.zeros_like(acc))


def reference_relation_attention_pos(q, k, v, uk, rois, ref_rois, wg_kernel,
                                     wg_bias, valid, sin_dtype=torch.float32):
    """Plain version of mode "compute": the log position bias materialised by
    ``reference_position_bias`` and added to the logits."""
    bias = reference_position_bias(rois, ref_rois, wg_kernel, wg_bias,
                                   EMBED_DIM, sin_dtype=sin_dtype)
    return reference_relation_attention(q, k, v, uk, bias, valid)


def _check(q, k, v, uk, valid, extra=()):
    """Raise on operands the kernel does not take."""
    b, g, n, d = q.shape
    m = k.shape[2]
    if (g, d) != (GROUPS, HEAD_DIM):
        raise ValueError(f"kernel takes g={GROUPS}, d={HEAD_DIM}; got {g}, {d}")
    want = {
        "k": (k, (b, g, m, d), torch.bfloat16),
        "v": (v, (b, g, m, d), torch.bfloat16),
        "uk": (uk, (b, g, m), torch.float32),
        "valid": (valid, (b, m), torch.bool),
    }
    if q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise ValueError("q must be contiguous bf16 (B, g, N, d)")
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    for t in (k, v, uk, valid, *extra):
        if t.device != q.device:
            raise ValueError("all operands must be on one device")
    # the kernels copy q, k and v rows in 16-byte pieces
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _check_bias(q, k, bias):
    """Raise on a mode "input" bias the kernel does not take."""
    b, g, n, _ = q.shape
    shape = (b, g, n, k.shape[2])
    if tuple(bias.shape) != shape or bias.dtype != torch.float32 or not bias.is_contiguous():
        raise ValueError(f"bias must be contiguous f32 {shape}, got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    if bias.data_ptr() % 8:  # copied in 8-byte pairs
        raise ValueError("bias must start on an 8-byte boundary")


def _launch(q, k, v, uk, valid, mode, rois=None, refs=None, params=None,
            bias=None):
    """Launch in ``mode``; the operands a mode does not read pass as null."""
    b, _, n, _ = q.shape
    m = k.shape[2]
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lib = load_library().lib

    def ptr(t):
        return None if t is None else t.data_ptr()

    status = lib.relation_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), uk.data_ptr(),
        valid.data_ptr(), ptr(rois), ptr(refs), ptr(params), ptr(bias),
        out.data_ptr(), b, n, m, mode,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch(status, "relation_attention")
    return out


def flash_relation_attention(q, k, v, uk, valid):
    """Mode "none": (B, g, N, d) f32. CPU tensors take the plain version;
    CUDA tensors launch the kernel (``flash_relation_attention.launches``)."""
    if any(t.requires_grad for t in (q, k, v, uk, valid)):
        raise ValueError("relation attention kernels are inference-only")
    if q.device.type == "cpu":
        return reference_relation_attention(q, k, v, uk, None, valid)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v, uk, valid)
    out = _launch(q, k, v, uk, valid, MODE_NONE)
    flash_relation_attention.launches += 1
    return out


def flash_relation_attention_pos(q, k, v, uk, rois, ref_rois, wg_kernel,
                                 wg_bias, valid):
    """Mode "compute": position weight evaluated in-kernel. CPU tensors take
    the plain version (f32 sinusoids); CUDA tensors launch the kernel
    (``flash_relation_attention_pos.launches``)."""
    extra = (rois, ref_rois, wg_kernel, wg_bias)
    if any(t.requires_grad for t in (q, k, v, uk, valid, *extra)):
        raise ValueError("relation attention kernels are inference-only")
    if q.device.type == "cpu":
        return reference_relation_attention_pos(q, k, v, uk, *extra, valid)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v, uk, valid, extra)
    b, _, n, _ = q.shape
    m = k.shape[2]
    for name, t, shape in (("rois", rois, (b, n, 4)), ("ref_rois", ref_rois, (b, m, 4)),
                           ("wg_kernel", wg_kernel, (EMBED_DIM, GROUPS)),
                           ("wg_bias", wg_bias, (GROUPS,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous f32 {shape}")
    out = _launch(q, k, v, uk, valid, MODE_COMPUTE, rois, ref_rois,
                  kernel_params(wg_kernel, wg_bias))
    flash_relation_attention_pos.launches += 1
    return out


def flash_relation_attention_bias(q, k, v, uk, bias, valid):
    """Mode "input": the (B, g, N, M) f32 log bias added to the scaled logits
    before masking and the running max. CPU tensors take the plain version;
    CUDA tensors launch the kernel (``flash_relation_attention_bias.launches``)."""
    if any(t.requires_grad for t in (q, k, v, uk, bias, valid)):
        raise ValueError("relation attention kernels are inference-only")
    if q.device.type == "cpu":
        return reference_relation_attention(q, k, v, uk, bias, valid)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v, uk, valid, (bias,))
    _check_bias(q, k, bias)
    out = _launch(q, k, v, uk, valid, MODE_INPUT, bias=bias)
    flash_relation_attention_bias.launches += 1
    return out


flash_relation_attention.launches = 0
flash_relation_attention_pos.launches = 0
flash_relation_attention_bias.launches = 0
