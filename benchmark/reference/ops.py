"""The reference's operations: products at a stated precision, frozen batch
norm with optional calibration, anchors, box coding, greedy NMS and
ROIAlign (maskrcnn-benchmark semantics), frame normalisation."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3 value
PIXEL_MEAN_BGR = (102.9801, 115.9465, 122.7717)
BBOX_XFORM_CLIP = math.log(1000.0 / 16)


class Precision:
    """How the products round their operands: "float32" leaves them (TF32
    must be off, which ``float32_matmul`` sees to), "float8" rounds each
    operand of every convolution, linear layer and attention product to
    float8 e4m3 with one scale per tensor (its largest magnitude at 448),
    the control that stands for computing one precision below bfloat16.

    ``calibrate``, when set, is a dict that FrozenBN layers fill with the
    per-channel mean and variance of their inputs before applying them."""

    def __init__(self, mode: str = "float32", calibrate: dict | None = None):
        if mode not in ("float32", "float8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode
        self.calibrate = calibrate

    def q(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.mode == "float32":
            return x
        scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    def conv(self, x, w, b=None, stride=1, padding=0, dilation=1):
        return F.conv2d(self.q(x), self.q(w), None if b is None else b.float(),
                        stride, padding, dilation)

    def conv_t(self, x, w, b, stride=2):
        return F.conv_transpose2d(self.q(x), self.q(w), b.float(), stride)

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), None if b is None else b.float())

    def einsum(self, eq: str, a, b):
        return torch.einsum(eq, self.q(a), self.q(b))


class float32_matmul:
    """Context: TF32 off for matrix products and convolutions, restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def frozen_bn(x: torch.Tensor, P: dict, name: str, prec: Precision) -> torch.Tensor:
    """x * weight / sqrt(var) + (bias - mean * scale) on NCHW x. Under
    calibration the statistics of x are recorded (and used) first."""
    if prec.calibrate is not None:
        xf = x.float()
        prec.calibrate[name + ".running_mean"] = xf.mean((0, 2, 3))
        prec.calibrate[name + ".running_var"] = xf.var((0, 2, 3)).clamp_min(1e-5)
        mean = prec.calibrate[name + ".running_mean"]
        var = prec.calibrate[name + ".running_var"]
    else:
        mean, var = P[name + ".running_mean"], P[name + ".running_var"]
    scale = P[name + ".weight"] / torch.sqrt(var)
    shift = P[name + ".bias"] - mean * scale
    return x * scale[:, None, None] + shift[:, None, None]


def normalize_frames(frames: torch.Tensor, sizes) -> torch.Tensor:
    """uint8 RGB canvases (N, H, W, 3) → BGR, mean subtracted, zero outside
    each frame's (h, w) image, f32 NCHW."""
    x = frames.flip(-1).float() - torch.tensor(PIXEL_MEAN_BGR, device=frames.device)
    h, w = frames.shape[1], frames.shape[2]
    ys = torch.arange(h, device=frames.device)
    xs = torch.arange(w, device=frames.device)
    oh = torch.as_tensor(sizes, device=frames.device, dtype=torch.float32)[:, 0]
    ow = torch.as_tensor(sizes, device=frames.device, dtype=torch.float32)[:, 1]
    mask = (ys[None, :, None] < oh[:, None, None]) & (xs[None, None, :] < ow[:, None, None])
    return (x * mask[..., None]).permute(0, 3, 1, 2).contiguous()


# -- anchors and boxes ---------------------------------------------------------

def cell_anchors(stride: int, sizes, ratios) -> np.ndarray:
    """Detectron's (A, 4) cell anchors, ratio-major then size."""
    base = np.array([0, 0, stride - 1, stride - 1], np.float64)
    w, h = base[2] - base[0] + 1, base[3] - base[1] + 1
    cx, cy = base[0] + 0.5 * (w - 1), base[1] + 0.5 * (h - 1)
    out = []
    for r in ratios:
        ws = np.round(np.sqrt(w * h / r))
        hs = np.round(ws * r)
        for s in sizes:
            sw, sh = ws * s / stride, hs * s / stride
            out.append([cx - 0.5 * (sw - 1), cy - 0.5 * (sh - 1),
                        cx + 0.5 * (sw - 1), cy + 0.5 * (sh - 1)])
    return np.array(out, np.float32)


def grid_anchors(fh: int, fw: int, stride: int, cell: np.ndarray) -> np.ndarray:
    """(fh * fw * A, 4) anchors in (y, x, a) order."""
    sx, sy = np.meshgrid(np.arange(fw, dtype=np.float32) * stride,
                         np.arange(fh, dtype=np.float32) * stride)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], 1)
    return (shifts[:, None] + cell[None]).reshape(-1, 4)


def decode(deltas: torch.Tensor, boxes: torch.Tensor, weights) -> torch.Tensor:
    """Detectron decoding: deltas (..., 4K) against boxes (..., 4), +1 widths,
    size deltas clipped at log(1000/16), the "-1" on x2, y2."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    wx, wy, ww, wh = weights
    d = deltas.reshape(*deltas.shape[:-1], -1, 4)
    dx, dy = d[..., 0] / wx, d[..., 1] / wy
    dw = (d[..., 2] / ww).clamp_max(BBOX_XFORM_CLIP)
    dh = (d[..., 3] / wh).clamp_max(BBOX_XFORM_CLIP)
    pcx, pcy = dx * w[..., None] + cx[..., None], dy * h[..., None] + cy[..., None]
    pw, ph = torch.exp(dw) * w[..., None], torch.exp(dh) * h[..., None]
    out = torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                       pcx + 0.5 * pw - 1.0, pcy + 0.5 * ph - 1.0], -1)
    return out.reshape(deltas.shape)


def clip_boxes(boxes: torch.Tensor, h: float, w: float) -> torch.Tensor:
    x = boxes.reshape(*boxes.shape[:-1], -1, 4)
    lim = torch.tensor([w - 1.0, h - 1.0, w - 1.0, h - 1.0], device=boxes.device)
    return torch.minimum(x.clamp_min(0.0), lim).reshape(boxes.shape)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, 4) x (N, 4) → (M, N), the +1 convention."""
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt + 1).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter).clamp_min(1e-12)


def greedy_nms(boxes: torch.Tensor, thresh: float, max_keep: int) -> list[int]:
    """Indices kept by greedy NMS over boxes already in rank order: a box is
    dropped when its IoU with a kept one exceeds ``thresh``; stops after
    ``max_keep``."""
    over = (iou(boxes, boxes) > thresh).cpu().numpy()
    suppressed = np.zeros(len(over), bool)
    keep = []
    for i in range(len(over)):
        if suppressed[i]:
            continue
        keep.append(i)
        if len(keep) == max_keep:
            break
        suppressed |= over[i]
    return keep


def roi_align(fmap: torch.Tensor, rois: torch.Tensor, scale: float, res: int = 7,
              max_grid: int = 10, chunk: int = 32) -> torch.Tensor:
    """maskrcnn-benchmark ROIAlign (no half-pixel shift, extents floored at
    1, an adaptive ceil(extent / res) grid a bin) of an NCHW map (1, C, H,
    W) at rois (R, 4) → (R, res, res, C), by bilinear sampling: samples
    below -1 or past the map add zero, others clamp to it. ``max_grid``
    must cover ceil(largest extent / res)."""
    _, c, h, w = fmap.shape
    r = rois.float() * scale
    x1, y1 = r[:, 0], r[:, 1]
    rw = (r[:, 2] - x1).clamp_min(1.0)
    rh = (r[:, 3] - y1).clamp_min(1.0)
    gw = torch.ceil(rw / res).clamp(1, max_grid)
    gh = torch.ceil(rh / res).clamp(1, max_grid)
    if len(rois):  # sample no more grid points than the largest ROI needs
        max_grid = int(torch.maximum(gw.max(), gh.max()))
    g = torch.arange(max_grid, device=rois.device, dtype=torch.float32)
    b = torch.arange(res, device=rois.device, dtype=torch.float32)

    def coords(start, extent, grid):  # (R, res, G) sample coordinates and weights
        pos = (start[:, None, None] + b[None, :, None] * (extent / res)[:, None, None]
               + (g[None, None, :] + 0.5) * (extent / res / grid)[:, None, None])
        ok = g[None, None, :] < grid[:, None, None]
        return pos, ok

    ys, oky = coords(y1, rh, gh)
    xs, okx = coords(x1, rw, gw)
    inside_y = oky & (ys >= -1.0) & (ys <= h)
    inside_x = okx & (xs >= -1.0) & (xs <= w)
    out = []
    for s in range(0, len(rois), chunk):
        sl = slice(s, s + chunk)
        n = ys[sl].shape[0]
        yy = ys[sl].clamp(0, h - 1).reshape(n, res * max_grid)
        xx = xs[sl].clamp(0, w - 1).reshape(n, res * max_grid)
        grid = torch.stack([
            (xx[:, None, :] / (w - 1) * 2 - 1).expand(n, res * max_grid, res * max_grid),
            (yy[:, :, None] / (h - 1) * 2 - 1).expand(n, res * max_grid, res * max_grid)],
            -1)
        grid = grid.reshape(1, n * res * max_grid, res * max_grid, 2)
        smp = F.grid_sample(fmap.float(), grid, mode="bilinear", padding_mode="border",
                            align_corners=True)  # (1, C, n*res*G, res*G)
        smp = smp.reshape(c, n, res, max_grid, res, max_grid)
        wgt = (inside_y[sl][:, :, :, None, None] & inside_x[sl][:, None, None, :, :]).float()
        wgt = wgt / (gh[sl] * gw[sl])[:, None, None, None, None]
        # a weighted sum, not a product: ROIAlign is no work of the model's FLOP count
        out.append((smp * wgt[None]).sum((3, 5)).permute(1, 2, 3, 0))
    return torch.cat(out)
