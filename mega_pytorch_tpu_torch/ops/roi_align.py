"""ROIAlign (counterpart of ``mega_pytorch_tpu/ops/roi_align.py``),
maskrcnn-benchmark semantics: no half-pixel shift, ROI extents floored at 1,
``sampling_ratio=0`` meaning an adaptive ceil(roi / pooled) grid per ROI
(capped at ``max_grid``), taps outside [-1, size] contributing zero,
coordinates clamped at the edges:

    pooled[l, r, ph, pw, c] = sum_{h,w} Wy[l, r, ph, h] Wx[l, r, pw, w] feat[l, h, w, c]

over lanes l, each with its own map and ROIs, accumulated in f32 and
rounded once to ``out_dtype``.

On CUDA tensors ``roi_align`` launches one hand-written gather kernel,
``csrc/roi_align.cu``, once a call (counted in ``roi_align.launches``). It
replaces no TPU kernel: the JAX package's ROIAlign is plain JAX, and the
kernel stands where the plain version's dense weights and einsums ran at a
few percent of the card. It is
bound by its output bytes; it reads the map as stored (f32 or bf16) and
builds each ROI's taps in shared memory (design in its source note). A call
whose features or ROIs require grad goes through ``ROIAlignFunction``,
whose backward is autograd through the plain version.

On CPU tensors the plain version, ``roi_align_reference``: two separable
contractions over dense per-axis weights. The first contraction's (lanes,
R, ph, W, C) f32 intermediate would reach 1.65 GB at 12 lanes x 300 ROIs of
a 608x1024 canvas, so lanes are contracted in chunks that keep it under
``MAX_INTERMEDIATE`` elements.

The entry is the operator ``torch.ops.mega_pytorch_tpu_torch.roi_align``
(``ops/kernels/operators.py``) with a count of 0 FLOPs: a weighted gather
is no work of the model's FLOP count, on the card or on the CPU.
"""

from __future__ import annotations

import torch

from ..utils.profiler import annotate
from .kernels.build import check_launch, load_library
from .kernels.operators import kernel_op

MAX_INTERMEDIATE = 1 << 27  # f32 elements (512 MB) of the first contraction
KERNEL_DTYPES = (torch.float32, torch.bfloat16)  # the kernel's maps and outputs


def _axis_weights(start, size, num_bins: int, grid, axis_len: int, max_grid: int):
    """(R, num_bins, axis_len) f32 bin-average interpolation weights."""
    dev = start.device
    bin_size = size / num_bins
    iy = torch.arange(max_grid, dtype=torch.float32, device=dev)
    ph = torch.arange(num_bins, dtype=torch.float32, device=dev)
    gridf = grid.float()
    coord = (
        start[:, None, None]
        + ph[None, :, None] * bin_size[:, None, None]
        + (iy[None, None, :] + 0.5) * bin_size[:, None, None] / gridf[:, None, None]
    )  # (R, P, S)
    sample_ok = iy[None, None, :] < gridf[:, None, None]
    inside = (coord >= -1.0) & (coord <= axis_len)
    c = coord.clamp_min(0.0)
    low = torch.floor(c)
    at_edge = low >= axis_len - 1
    edge = torch.full_like(low, axis_len - 1)
    low = torch.where(at_edge, edge, low)
    high = torch.where(at_edge, edge, low + 1)
    l_frac = torch.where(at_edge, torch.zeros_like(c), c - low)
    h_frac = 1.0 - l_frac
    w_mask = (sample_ok & inside).float() / gridf[:, None, None]
    axis_idx = torch.arange(axis_len, dtype=torch.float32, device=dev)
    onehot_low = (low[..., None] == axis_idx).float()  # (R, P, S, L)
    onehot_high = (high[..., None] == axis_idx).float()
    w = (h_frac[..., None] * onehot_low + l_frac[..., None] * onehot_high) * w_mask[..., None]
    return w.sum(dim=2)


def roi_align_reference(features: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
                        pooled_height: int = 7, pooled_width: int = 7,
                        sampling_ratio: int = 0, max_grid: int = 10,
                        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version: features (L, H, W, C), rois (L, R, 4) → (L, R,
    pooled_height, pooled_width, C), the f32 sums cast to ``out_dtype``."""
    lanes, h, w, c = features.shape
    r = rois.shape[1]
    rois = rois.float().reshape(lanes * r, 4)
    x1 = rois[:, 0] * spatial_scale
    y1 = rois[:, 1] * spatial_scale
    x2 = rois[:, 2] * spatial_scale
    y2 = rois[:, 3] * spatial_scale
    roi_w = (x2 - x1).clamp_min(1.0)
    roi_h = (y2 - y1).clamp_min(1.0)
    if sampling_ratio > 0:
        gh = torch.full(rois.shape[:1], sampling_ratio, dtype=torch.int32,
                        device=rois.device)
        gw = gh
        max_grid = sampling_ratio
    else:
        gh = torch.ceil(roi_h / pooled_height).int().clamp(1, max_grid)
        gw = torch.ceil(roi_w / pooled_width).int().clamp(1, max_grid)
    wy = _axis_weights(y1, roi_h, pooled_height, gh, h, max_grid)  # (L*R, PH, H)
    wx = _axis_weights(x1, roi_w, pooled_width, gw, w, max_grid)  # (L*R, PW, W)
    wy = wy.reshape(lanes, r, pooled_height, h)
    wx = wx.reshape(lanes, r, pooled_width, w)
    feat = features.float()
    out = torch.empty((lanes, r, pooled_height, pooled_width, c),
                      dtype=torch.float32, device=features.device)
    chunk = max(1, MAX_INTERMEDIATE // max(1, r * pooled_height * w * c))
    for l0 in range(0, lanes, chunk):
        sl = slice(l0, l0 + chunk)
        tmp = torch.einsum("lrph,lhwc->lrpwc", wy[sl], feat[sl])
        out[sl] = torch.einsum("lrqw,lrpwc->lrpqc", wx[sl], tmp)
    return out.to(out_dtype)


def _check(features: torch.Tensor, rois: torch.Tensor) -> None:
    """Shapes both versions take: (L, H, W, C) maps and (L, R, 4) ROIs."""
    if features.dim() != 4:
        raise ValueError(f"features must be (L, H, W, C), got {tuple(features.shape)}")
    if rois.dim() != 3 or rois.shape[0] != features.shape[0] or rois.shape[2] != 4:
        raise ValueError(f"rois must be (L, R, 4) with L = {features.shape[0]}, got "
                         f"{tuple(rois.shape)}")


def check_kernel_operands(features: torch.Tensor, rois: torch.Tensor,
                          out_dtype: torch.dtype) -> None:
    """What the kernel takes beyond ``_check``: a CUDA map of f32 or bf16
    whose channels are contiguous (channel stride 1, any other strides),
    ROIs on its device, an f32 or bf16 output."""
    if features.shape[-1] > 1 and features.stride(-1) != 1:
        raise ValueError(f"features must be channel-last (channel stride 1), got strides "
                         f"{features.stride()}")
    if features.dtype not in KERNEL_DTYPES or out_dtype not in KERNEL_DTYPES:
        raise ValueError(f"the kernel takes f32 or bf16 maps and outputs, got "
                         f"{features.dtype} -> {out_dtype}")
    if features.device.type != "cuda" or rois.device != features.device:
        raise ValueError(f"the kernel takes CUDA tensors on one device, got "
                         f"{features.device} and {rois.device}")


def _launch(features, rois, spatial_scale, pooled_height, pooled_width, sampling_ratio,
            max_grid, out_dtype):
    """One launch on checked operands → (L, R, PH, PW, C) ``out_dtype``."""
    lanes, h, w, c = features.shape
    r = rois.shape[1]
    rois = rois.float().contiguous()
    out = torch.empty((lanes, r, pooled_height, pooled_width, c), dtype=out_dtype,
                      device=features.device)
    s_lane, s_row, s_col, _ = features.stride()
    bf16 = torch.bfloat16
    status = load_library().lib.roi_align_launch(
        features.data_ptr(), rois.data_ptr(), out.data_ptr(), lanes, r, h, w, c, s_lane,
        s_row, s_col, pooled_height, pooled_width, spatial_scale,
        sampling_ratio, max_grid, int(features.dtype == bf16), int(out_dtype == bf16),
        torch.cuda.current_stream(features.device).cuda_stream)
    check_launch(status, "roi_align")
    return out


def _impl(features, rois, spatial_scale, pooled_height, pooled_width, sampling_ratio,
          max_grid, out_dtype):
    args = (spatial_scale, pooled_height, pooled_width, sampling_ratio, max_grid, out_dtype)
    if features.device.type == "cpu":
        return roi_align_reference(features, rois, *args)
    check_kernel_operands(features, rois, out_dtype)
    out = _launch(features, rois, *args)
    roi_align.launches += 1
    return out


_op = kernel_op(
    "roi_align", "(Tensor features, Tensor rois, float spatial_scale, int pooled_height, "
    "int pooled_width, int sampling_ratio, int max_grid, ScalarType out_dtype) -> Tensor",
    _impl, lambda *_: 0, lambda *_: {"sin_cos": 0, "exp": 0, "log": 0})


class ROIAlignFunction(torch.autograd.Function):
    """``roi_align`` with a gradient: ``apply(features, rois, spatial_scale,
    pooled_height, pooled_width, sampling_ratio, max_grid, out_dtype)``. The
    forward is the kernel on the detached operands; the backward recomputes
    the plain version under autograd (its dense weights, and the transpose
    of its contractions) and returns the gradients of the features and of
    the ROIs that require them."""

    @staticmethod
    def forward(ctx, features, rois, *args):
        ctx.save_for_backward(features, rois)
        ctx.args = args
        return _op(features.detach(), rois.detach(), *args)

    @staticmethod
    def backward(ctx, grad_out):
        features, rois = ctx.saved_tensors
        with torch.enable_grad():
            diff = [t.detach().requires_grad_(need)
                    for t, need in zip((features, rois), ctx.needs_input_grad[:2])]
            out = roi_align_reference(*diff, *ctx.args)
            wanted = [t for t in diff if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return (*(next(grads) if t.requires_grad else None for t in diff),
                *(None,) * len(ctx.args))


def roi_align(features: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
              pooled_height: int = 7, pooled_width: int = 7,
              sampling_ratio: int = 0, max_grid: int = 10,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """features (L, H, W, C), one map per lane; rois (L, R, 4) xyxy in image
    coordinates → (L, R, pooled_height, pooled_width, C) in ``out_dtype``,
    summed in f32 and rounded once (a caller passes its consumer's compute
    dtype). CPU tensors take the plain version; CUDA tensors launch the
    kernel, through ``ROIAlignFunction`` where an operand requires grad."""
    with annotate("roi_align"):
        _check(features, rois)
        args = (float(spatial_scale), int(pooled_height), int(pooled_width),
                int(sampling_ratio), int(max_grid), out_dtype)
        if features.requires_grad or rois.requires_grad:
            if features.device.type == "cpu":
                return roi_align_reference(features, rois, *args)
            return ROIAlignFunction.apply(features, rois, *args)
        return _op(features, rois, *args)


roi_align.launches = 0


def roi_align_batched(features: torch.Tensor, rois: torch.Tensor, batch_idx: torch.Tensor,
                      spatial_scale: float, pooled_height: int = 7, pooled_width: int = 7,
                      sampling_ratio: int = 0, max_grid: int = 10) -> torch.Tensor:
    """ROIAlign of rois (R, 4) on the maps features (B, H, W, C) that
    ``batch_idx`` (R,) names: the reference Pooler's ``[batch_idx | box]``
    ROI format → (R, pooled_height, pooled_width, C) f32. As in the JAX
    package, every map pools every ROI and each ROI's own is picked."""
    args = (spatial_scale, pooled_height, pooled_width, sampling_ratio, max_grid)
    b, r = features.shape[0], rois.shape[0]
    if b == 1:
        return roi_align(features, rois[None], *args)[0]
    per_map = roi_align(features, rois.expand(b, r, 4), *args)  # (B, R, ph, pw, C)
    return per_map[batch_idx.long(), torch.arange(r, device=rois.device)]
