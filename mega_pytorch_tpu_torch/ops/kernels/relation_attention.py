"""Flash relation attention (forward): modes "none", "compute" and "input".

Counterpart of ``mega_pytorch_tpu/ops/pallas/relation_attention.py``:
``flash_relation_attention`` replaces ``fused_relation_attention`` with no
bias (``_fused_fwd_batched`` bias_mode "none");
``flash_relation_attention_pos`` replaces ``fused_relation_attention_pos``
(bias_mode "compute": the position weight evaluated inside the kernel); and
``flash_relation_attention_bias`` replaces ``fused_relation_attention`` with a
precomputed log bias (bias_mode "input"). All three launch
``csrc/relation_attention.cu`` on the tensor cores: modes "none" and "input"
one block per (lane, group, 64 query rows); mode "compute" one block per
(lane, 2 groups, 64 query rows), eight of them a cluster that evaluates
each tile's dx/dy sinusoids once for all 16 groups, with the dw/dh term
through the separable factors of ``wh_factors`` (bound, design and
numerics in its source note). ``reference_relation_attention_pos_tiled`` is
mode "compute" in the kernel's arithmetic; ``reference_relation_attention_pos``
(f32 sinusoids, additive log bias) is the loose yardstick.

Layouts are the JAX package's: q (B, g, N, d), k and v (B, g, M, d), uk
(B, g, M), valid (B, M), rois (B, N, 4), ref_rois (B, M, 4), Wg (E, g),
bias (B, g, N, M).
The kernel takes g = 16, d = 64 and E = 64 (the MEGA configuration).

The wrappers are forward-only and raise on an operand that requires grad;
``RelationAttentionFunction`` gives modes "none" and "input" a gradient,
recomputed through ``reference_relation_attention`` (the JAX package's
``_vjp_bwd``), and ``RelationAttentionPosFunction`` gives mode "compute"
one, recomputed through ``reference_relation_attention_pos`` with bf16
sinusoids (the JAX package's ``_pos_vjp_bwd``).
"""

from __future__ import annotations

import math

import torch

from .build import check_launch, load_library
from .position_bias import (
    EMBED_DIM,
    GROUPS,
    _geometry,
    bias_freq_scales,
    kernel_params,
    reference_position_bias,
)

NEG_INF = -1e30
HEAD_DIM = 64
REF_TILE = 64  # refs per tile of the kernels' online softmax
MODE_NONE, MODE_COMPUTE, MODE_INPUT = 0, 1, 2
TWO_PI = 6.283185307179586


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and compute on in f32 (a bf16 product is exact in f32,
    so f32 matmuls of rounded operands equal bf16 matmuls with f32 sums)."""
    return x.to(torch.bfloat16).float()


def _masked_logits(q, k, uk, valid, bias=None):
    """(q.k + uk) / sqrt(d) with bf16 operands (+ the log bias), -1e30 on
    invalid refs."""
    s = _bf16(q) @ _bf16(k).transpose(-1, -2)
    s = (s + uk.float()[..., None, :]) * (1.0 / math.sqrt(q.shape[-1]))
    if bias is not None:
        s = s + bias
    return torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))


def reference_relation_attention(q, k, v, uk, bias, valid):
    """Plain version: (B, g, N, d) output with bf16 QK/PV operands, f32 sums.

    bias: (B, g, N, M) additive log bias, or None."""
    aff = _masked_logits(q, k, uk, valid, bias)
    soft = torch.softmax(aff, dim=-1)
    soft = torch.where(valid.any(-1)[:, None, None, None], soft, torch.zeros_like(soft))
    return _bf16(soft) @ _bf16(v)


def _online_softmax_pv(s, keep, v, weight=None):
    """softmax(s) . v in the kernels' order: refs in tiles of ``REF_TILE``,
    p = exp(s - running max) (times ``weight``, mode "compute") rounded to
    bf16 before PV, the f32 sum of p normalising at the end; rows whose sum
    is 0 give zeros."""
    run_max = torch.full(s.shape[:-1], NEG_INF, device=s.device)
    run_sum = torch.zeros(s.shape[:-1], device=s.device)
    acc = torch.zeros((*s.shape[:-1], v.shape[-1]), device=s.device)
    for m0 in range(0, s.shape[-1], REF_TILE):
        st = s[..., m0:m0 + REF_TILE]
        new_max = torch.maximum(run_max, st.amax(-1))
        alpha = torch.exp(run_max - new_max)
        e = torch.exp(st - new_max[..., None])
        if weight is not None:
            e = e * weight[..., m0:m0 + REF_TILE]
        p = torch.where(keep[..., m0:m0 + REF_TILE], e, torch.zeros_like(st))
        run_sum = run_sum * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _bf16(p) @ _bf16(v[..., m0:m0 + REF_TILE, :])
        run_max = new_max
    pos = run_sum > 0
    return torch.where(pos[..., None], acc / torch.where(pos, run_sum, 1.0)[..., None],
                       torch.zeros_like(acc))


def reference_relation_attention_tiled(q, k, v, uk, bias, valid):
    """The plain version in the kernels' order of rounding: refs in tiles of
    ``REF_TILE`` under the online softmax, p = exp(s - running max) rounded to
    bf16 before PV and normalised by the f32 sum at the end, as the Pallas
    kernel does. ``reference_relation_attention`` rounds the normalised
    softmax instead; where a few refs carry a row's weight the two differ by
    up to 2^-7 max|v| (two roundings to bf16, unit roundoff 2^-8 each)."""
    return _online_softmax_pv(_masked_logits(q, k, uk, valid, bias),
                              valid[:, None, None, :], v)


def _sincos_reduced(x):
    """sin and cos after the kernel's f32 reduction to [-pi, pi]
    (``posw::sincos_reduced``): r = x - round(x / 2pi) * 2pi, each step
    rounded to f32 as written."""
    r = x - torch.round(x * (1.0 / TWO_PI)) * TWO_PI
    return torch.sin(r), torch.cos(r)


def wh_factors(rois, ref_rois, wg_kernel, dtype=torch.float16):
    """The separable dw/dh factors of mode "compute" (the JAX package's
    ``_wh_factors``, with the kernel's sinusoids).

    The dw/dh angle is f * (log w_n - log w_m), so by angle addition its
    sine and cosine terms are rank-2 products of per-row and per-ref
    sinusoids; folding Wg's dw/dh rows into the ref side makes their whole
    contribution ``S[n] . T[g, :, m]``, a K=32 contraction per group.

    rois (..., N, 4), ref_rois (..., M, 4), wg_kernel (E, g). Returns S
    (..., N, 32) f32, columns (sin, cos) of f log w then of f log h, and T
    (..., g, 32, M) in ``dtype`` (folded in f32, then rounded; fp16 as the
    kernel keeps it, bf16 as the JAX package), rows (alpha, beta) of dw then
    of dh with alpha = ws cos b + wc sin b and beta = wc cos b - ws sin b."""
    nf = EMBED_DIM // 8
    freqs = torch.tensor(bias_freq_scales(nf), dtype=torch.float32, device=rois.device)

    def log_wh(r):
        w, h, _, _ = _geometry(r.float())
        return torch.log(w), torch.log(h)

    rows = [_sincos_reduced(lg[..., None] * freqs) for lg in log_wh(rois)]
    s = torch.cat([t for sc in rows for t in sc], dim=-1)  # (..., N, 4F)
    wt = wg_kernel.float().T[..., None]  # (g, E, 1)
    parts = []
    for c, lg in zip((2, 3), log_wh(ref_rois)):  # dw, dh
        ws = wt[:, c * 2 * nf:c * 2 * nf + nf]  # (g, F, 1): the sine rows
        wc = wt[:, c * 2 * nf + nf:(c + 1) * 2 * nf]  # the cosine rows
        sin_b, cos_b = (x.transpose(-1, -2)[..., None, :, :]  # (..., 1, F, M)
                        for x in _sincos_reduced(lg[..., None] * freqs))
        parts += [ws * cos_b + wc * sin_b, wc * cos_b - ws * sin_b]
    t = torch.cat(parts, dim=-2)  # (..., g, 4F, M)
    return s, t.to(dtype)


def position_weight_tiled(rois, ref_rois, wg_kernel, wg_bias, sin_dtype=torch.float32,
                          wh_dtype=torch.float16):
    """(B, g, N, M) position weight pw = relu(.) + 1e-6 in mode "compute"'s
    arithmetic: the dx/dy sinusoids and Wg in ``sin_dtype`` with f32 sums
    (float32: the kernel's hi/lo bf16 products carry ~15 bits, and the
    Pallas kernel in interpret mode is f32; bfloat16: the Pallas kernel's
    MXU on the TPU), the dw/dh term as S . T from ``wh_factors`` with both
    rounded to ``wh_dtype`` (float16: the kernel; bfloat16: the Pallas
    kernel), the dx/dy quotient by the reciprocal width."""
    nf = EMBED_DIM // 8
    w, h, cx, cy = _geometry(rois.float())
    _, _, cx_r, cy_r = _geometry(ref_rois.float())
    dx = torch.log(((cx[..., :, None] - cx_r[..., None, :]) * (1.0 / w)[..., :, None]).abs()
                   + 1e-3)
    dy = torch.log(((cy[..., :, None] - cy_r[..., None, :]) * (1.0 / h)[..., :, None]).abs()
                   + 1e-3)
    freqs = torch.tensor(bias_freq_scales(nf), dtype=torch.float32, device=rois.device)
    feats = torch.cat([t for d in (dx, dy) for t in _sincos_reduced(d[..., None] * freqs)],
                      dim=-1)  # (B, N, M, 4F): Wg's dx/dy row order
    part = (feats.to(sin_dtype).float()
            @ wg_kernel[:4 * nf].to(sin_dtype).float())  # (B, N, M, g)
    s, t = wh_factors(rois, ref_rois, wg_kernel, wh_dtype)
    c_wh = s.to(wh_dtype).float()[:, None] @ t.float()  # (B, g, N, M)
    pw = part.movedim(-1, 1) + c_wh + wg_bias.float()[:, None, None]
    return pw.clamp_min(0.0) + 1e-6


def reference_relation_attention_pos_tiled(q, k, v, uk, rois, ref_rois, wg_kernel,
                                           wg_bias, valid, sin_dtype=torch.float32,
                                           wh_dtype=torch.float16):
    """Mode "compute" in the kernel's arithmetic: ``position_weight_tiled``
    multiplied into exp(s - running max of the qk logits) over tiles of
    ``REF_TILE`` refs, p * pw rounded to bf16 before PV, the f32 sum of
    p * pw normalising at the end (the Pallas kernel's multiplicative form)."""
    pw = position_weight_tiled(rois, ref_rois, wg_kernel, wg_bias, sin_dtype, wh_dtype)
    return _online_softmax_pv(_masked_logits(q, k, uk, valid), valid[:, None, None, :], v,
                              weight=pw)


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
            bias=None, lib=None):
    """Launch in ``mode``; the operands a mode does not read pass as null.
    ``lib``: the kernel library (default: the package's own)."""
    b, _, n, _ = q.shape
    m = k.shape[2]
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lib = load_library().lib if lib is None else lib

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


# -- gradients ---------------------------------------------------------------------
# The counterpart of the JAX package's custom_vjp (``_vjp_fwd`` / ``_vjp_bwd``):
# the forward launches the kernel on the detached operands; the backward
# recomputes the plain version under autograd from the saved operands (the
# (B, g, N, M) logits are materialised there, which training's ref counts
# afford) and returns each gradient in its operand's dtype.

def _recompute_grads(grad_out, q, k, v, uk, bias, valid):
    """Gradients of q, k, v, uk (and the bias, unless None) from autograd
    through the plain version."""
    with torch.enable_grad():
        diff = [t.detach().requires_grad_() for t in (q, k, v, uk, bias) if t is not None]
        out = reference_relation_attention(*diff[:4], diff[4] if bias is not None else None,
                                           valid)
        return torch.autograd.grad(out, diff, grad_out)


class RelationAttentionFunction(torch.autograd.Function):
    """Modes "none" and "input" with a gradient: ``apply(q, k, v, uk, bias,
    valid, launch)``, ``launch`` the forward: ``flash_relation_attention``
    with ``bias`` None, else ``flash_relation_attention_bias`` (a CPU test
    passes the tiled plain version). Gradients for q, k, v, uk and the log
    bias (None without one)."""

    @staticmethod
    def forward(ctx, q, k, v, uk, bias, valid, launch):
        ctx.save_for_backward(q, k, v, uk, bias, valid)
        operands = [t.detach() for t in (q, k, v, uk, bias) if t is not None]
        return launch(*operands, valid)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, uk, bias, valid = ctx.saved_tensors
        grads = _recompute_grads(grad_out, q, k, v, uk, bias, valid)
        return (*grads[:4], grads[4] if bias is not None else None, None, None)


def _recompute_pos_grads(grad_out, q, k, v, uk, rois, ref_rois, wg_kernel, wg_bias, valid):
    """Gradients of q, k, v, uk, rois, ref_rois, Wg's kernel and bias from
    autograd through the plain mode "compute": the log bias of
    ``reference_position_bias`` with its bf16 sinusoids, added to the
    logits, as the JAX package's ``_pos_vjp_bwd`` recomputes it."""
    with torch.enable_grad():
        diff = [t.detach().requires_grad_()
                for t in (q, k, v, uk, rois, ref_rois, wg_kernel, wg_bias)]
        out = reference_relation_attention_pos(*diff, valid, sin_dtype=torch.bfloat16)
        return torch.autograd.grad(out, diff, grad_out)


class RelationAttentionPosFunction(torch.autograd.Function):
    """Mode "compute" with a gradient: ``apply(q, k, v, uk, rois, ref_rois,
    wg_kernel, wg_bias, valid, launch)``, ``launch`` the forward
    (``flash_relation_attention_pos``; a CPU test passes the tiled plain
    version). The backward materialises the (B, g, N, M) bias and logits:
    the bf16 sinusoids of the JAX package's ``custom_vjp`` make dWg noisy
    where pw sits at its relu floor, so training takes mode "input" with
    the f32-sinusoid bias instead (``RelationAttention(precise_bias=True)``)."""

    @staticmethod
    def forward(ctx, q, k, v, uk, rois, ref_rois, wg_kernel, wg_bias, valid, launch):
        ops = (q, k, v, uk, rois, ref_rois, wg_kernel, wg_bias)
        ctx.save_for_backward(*ops, valid)
        return launch(*(t.detach() for t in ops), valid)

    @staticmethod
    def backward(ctx, grad_out):
        *ops, valid = ctx.saved_tensors
        return (*_recompute_pos_grads(grad_out, *ops, valid), None, None)
