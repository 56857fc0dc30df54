"""Relation-attention position bias (counterpart of
``mega_pytorch_tpu/ops/pallas/position_bias.py``).

``fused_position_bias`` replaces the Pallas kernel of the same name: the
standalone (g, N, M) log bias, launched from ``csrc/position_bias.cu`` on a
CUDA tensor (design and bound in its source note). The flash attention
kernel's mode "compute" computes the same position weight in-kernel; both
kernels take the box geometry, the frequency ladder and Wg's row order from
``csrc/position_weight.cuh`` and their parameters as the block
``kernel_params`` packs (where their arithmetic differs: the header's note).
The entry runs as a PyTorch operator (``ops/kernels/operators.py``) counted
by ``position_bias_flops``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .build import check_launch, load_library
from .operators import kernel_op

GROUPS, EMBED_DIM = 16, 64  # the kernels' g and E (the MEGA configuration)


def bias_freq_scales(num_freq: int) -> list[float]:
    """The sinusoid frequency ladder 100 / 1000^(f/F), shared by the plain
    bias and the attention kernel's in-kernel bias."""
    log1000 = float(np.log(1000.0))
    return [
        100.0 * math.exp(-f * (1.0 / num_freq) * log1000)
        for f in range(num_freq)
    ]


def _geometry(r: torch.Tensor):
    """(w, h, cx, cy) with the +1 widths and the 1e-3 w/h clamp."""
    w = r[..., 2] - r[..., 0] + 1.0
    h = r[..., 3] - r[..., 1] + 1.0
    cx = 0.5 * (r[..., 0] + r[..., 2])
    cy = 0.5 * (r[..., 1] + r[..., 3])
    return w.clamp_min(1e-3), h.clamp_min(1e-3), cx, cy


def _log_ratios(rois: torch.Tensor, ref_rois: torch.Tensor):
    """(..., N, 4) x (..., M, 4) → 4 slabs (..., N, M) of pairwise geometry."""
    w, h, cx, cy = _geometry(rois)
    w_r, h_r, cx_r, cy_r = _geometry(ref_rois)
    dx = torch.log(((cx[..., :, None] - cx_r[..., None, :]) / w[..., :, None]).abs() + 1e-3)
    dy = torch.log(((cy[..., :, None] - cy_r[..., None, :]) / h[..., :, None]).abs() + 1e-3)
    dw = torch.log(w[..., :, None] / w_r[..., None, :])
    dh = torch.log(h[..., :, None] / h_r[..., None, :])
    return dx, dy, dw, dh


def reference_position_bias(
    rois: torch.Tensor,
    ref_rois: torch.Tensor,
    wg_kernel: torch.Tensor,
    wg_bias: torch.Tensor,
    embed_dim: int = 64,
    sin_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) → (..., g, N, M) log position bias.

    The sinusoids and Wg are rounded to ``sin_dtype`` before the contraction,
    which sums in f32 (bf16 is the inference default of the JAX package)."""
    num_freq = embed_dim // 8
    g = wg_kernel.shape[1]
    dx, dy, dw, dh = _log_ratios(rois.float(), ref_rois.float())
    pos = torch.stack([dx, dy, dw, dh], dim=-1)  # (..., N, M, 4)
    freqs = torch.tensor(bias_freq_scales(num_freq), dtype=torch.float32,
                         device=pos.device)
    div = pos[..., None] * freqs  # (..., N, M, 4, F)
    w4 = wg_kernel.float().reshape(4, 2, num_freq, g)

    def rounded(x):
        return x.to(sin_dtype).float()

    lead = div.shape[:-2]
    pw = (
        rounded(torch.sin(div)).reshape(*lead, 4 * num_freq)
        @ rounded(w4[:, 0]).reshape(4 * num_freq, g)
    ) + (
        rounded(torch.cos(div)).reshape(*lead, 4 * num_freq)
        @ rounded(w4[:, 1]).reshape(4 * num_freq, g)
    )
    pw = (pw + wg_bias.float()).clamp_min(0.0)
    return torch.log(pw + 1e-6).movedim(-1, -3)


_FREQS: dict[torch.device, torch.Tensor] = {}


def kernel_params(wg_kernel: torch.Tensor, wg_bias: torch.Tensor) -> torch.Tensor:
    """The kernels' f32 parameter block: Wg (E, g) row-major, its bias (g,),
    then the sinusoid frequencies (kept per device)."""
    dev = wg_kernel.device
    if dev not in _FREQS:
        _FREQS[dev] = torch.tensor(bias_freq_scales(EMBED_DIM // 8),
                                   dtype=torch.float32, device=dev)
    return torch.cat([wg_kernel.reshape(-1), wg_bias, _FREQS[dev]])


def position_bias_flops(rois_shape, refs_shape, wg_shape) -> int:
    """FLOPs of ``fused_position_bias``: the Wg contraction of each pair's
    E-wide embedding, N*M*E*g multiply-adds."""
    e, g = wg_shape
    return 2 * rois_shape[0] * refs_shape[0] * e * g


def position_bias_special(rois_shape, refs_shape, wg_shape) -> dict:
    """E sines and cosines and 4 logs (dx, dy, dw, dh) a pair, and the log
    of each of the g weights."""
    pairs = rois_shape[0] * refs_shape[0]
    e, g = wg_shape
    return {"sin_cos": pairs * e, "exp": 0, "log": pairs * (4 + g)}


def _position_bias_impl(rois, ref_rois, wg_kernel, wg_bias, embed_dim):
    args = (rois, ref_rois, wg_kernel, wg_bias)
    if rois.device.type == "cpu":
        return reference_position_bias(*args, embed_dim, sin_dtype=torch.float32)
    if embed_dim != EMBED_DIM:
        raise ValueError(f"the kernel takes embed_dim={EMBED_DIM}, got {embed_dim}")
    n, m = rois.shape[0], ref_rois.shape[0]
    for name, t, shape in (("rois", rois, (n, 4)), ("ref_rois", ref_rois, (m, 4)),
                           ("wg_kernel", wg_kernel, (EMBED_DIM, GROUPS)),
                           ("wg_bias", wg_bias, (GROUPS,))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != rois.device):
            raise ValueError(f"{name} must be a contiguous f32 {shape} on {rois.device}")
    out = torch.empty((GROUPS, n, m), dtype=torch.float32, device=rois.device)
    _launch(rois, ref_rois, kernel_params(wg_kernel, wg_bias), out)
    fused_position_bias.launches += 1
    return out


_position_bias_op = kernel_op(
    "position_bias", "(Tensor rois, Tensor ref_rois, Tensor wg_kernel, Tensor wg_bias, "
    "int embed_dim) -> Tensor", _position_bias_impl,
    lambda rois, refs, wg, *_: position_bias_flops(rois, refs, wg),
    lambda rois, refs, wg, *_: position_bias_special(rois, refs, wg))


def fused_position_bias(rois, ref_rois, wg_kernel, wg_bias, embed_dim: int = 64):
    """(N, 4) x (M, 4) → (g, N, M) f32 log position bias, f32 throughout.

    CPU tensors take the plain version (f32 sinusoids); CUDA tensors launch
    the kernel (``fused_position_bias.launches``), which takes g = 16 and
    embed_dim = 64. The operator ``position_bias``, counted by
    ``position_bias_flops``."""
    args = (rois, ref_rois, wg_kernel, wg_bias)
    if any(t.requires_grad for t in args):
        raise ValueError("fused_position_bias is inference-only")
    if rois.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rois.device}")
    return _position_bias_op(*args, embed_dim)


def _launch(rois, ref_rois, params, out, lib=None):
    """Write the (g, N, M) log bias into ``out``. ``lib``: the kernel library
    (default: the package's own)."""
    lib = load_library().lib if lib is None else lib
    status = lib.position_bias_launch(
        rois.data_ptr(), ref_rois.data_ptr(), params.data_ptr(), out.data_ptr(),
        rois.shape[0], ref_rois.shape[0], torch.cuda.current_stream(rois.device).cuda_stream,
    )
    check_launch(status, "position_bias")


fused_position_bias.launches = 0
