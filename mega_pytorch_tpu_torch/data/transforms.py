"""Host preprocessing, frame packing and normalization (counterpart of
``mega_pytorch_tpu/data/transforms.py``).

Frames are ``(H, W, 3)`` uint8 RGB numpy arrays. The resize is
``resize_bilinear_u8``, PIL's BILINEAR resample rewritten in numpy and equal
to it bit for bit, so the port needs no PIL on the path: the shortest side
goes to ``min_size`` with the longest capped at ``max_size`` (the
maskrcnn-benchmark rule), an optional horizontal flip follows the resize,
and the frame lands on an orientation-dependent fixed canvas. The f32 canvas
(``preprocess_image``, BGR255 mean-subtracted) feeds the serial engine; the
uint8 canvas (``preprocess_image_u8``) feeds the lockstep engine, which
normalizes on the card with ``normalize_u8_frames``. The s2d packing is
host numpy.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

PIXEL_MEAN_BGR = np.array([102.9801, 115.9465, 122.7717], np.float32)

# PIL's fixed-point resample (libImaging/Resample.c): 8-bit images use
# 32 - 8 - 2 = 22 fractional bits, and every sum starts from one half
_PRECISION_BITS = 22


class Preprocessed(NamedTuple):
    image: np.ndarray  # (H, W, 3) canvas, float32 or uint8
    size: np.ndarray  # (2,) float32 true (h, w) after resize
    scale: float  # resize scale applied (for mapping boxes back)


def resize_hw(h: int, w: int, min_size: int, max_size: int) -> tuple[int, int]:
    """Target (h, w) under the shortest/longest side rule."""
    size = min_size
    if max_size is not None:
        min_orig = min(h, w)
        max_orig = max(h, w)
        if max_orig / min_orig * size > max_size:
            size = int(round(max_size * min_orig / max_orig))
    if h < w:
        oh, ow = size, int(size * w / h)
    else:
        ow, oh = size, int(size * h / w)
    return oh, ow


def canvas_for(h: int, w: int, canvas_short: int = 608, canvas_long: int = 1024):
    """Orientation-dependent fixed canvas: landscape (short, long), portrait
    (long, short). Square images use the landscape canvas."""
    if h <= w:
        return canvas_short, canvas_long
    return canvas_long, canvas_short


@functools.lru_cache(maxsize=64)
def _bilinear_taps(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """PIL's ``precompute_coeffs`` with the triangle filter, then
    ``normalize_coeffs_8bpc``: (first input index (out,), int32 weights
    (out, ksize)); taps past an output's count weigh 0. The loops keep C's
    order of double operations, so the weights round as PIL's do."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int32)
    one = float(1 << _PRECISION_BITS)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = []
        ww = 0.0
        for x in range(xmax):
            t = abs((x + xmin - center + 0.5) * ss)
            w = 1.0 - t if t < 1.0 else 0.0
            k.append(w)
            ww += w
        for x, w in enumerate(k):
            if ww != 0.0:
                w /= ww
            # C's (int) cast truncates toward zero
            weights[xx, x] = math.trunc(-0.5 + w * one if w < 0 else 0.5 + w * one)
        first[xx] = xmin
    return first, weights


def _resample_rows(a: np.ndarray, out_size: int) -> np.ndarray:
    """One fixed-point pass along axis 0 of a uint8 (N, M) array: per output
    row, the weighted sum of its taps in int32 from ``1 << 21``, shifted
    right by 22 and clipped to 0..255. Rows are gathered whole, so each tap
    is a contiguous copy."""
    first, weights = _bilinear_taps(a.shape[0], out_size)
    last = a.shape[0] - 1
    acc = np.full((out_size, a.shape[1]), 1 << (_PRECISION_BITS - 1), np.int32)
    tap = np.empty_like(acc)
    for t in range(weights.shape[1]):
        idx = np.minimum(first + t, last)  # a clamped tap weighs 0
        np.multiply(a[idx], weights[:, t, None], out=tap)
        acc += tap
    acc >>= _PRECISION_BITS
    return np.clip(acc, 0, 255).astype(np.uint8)


def resize_bilinear_u8(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """``PIL.Image.fromarray(img).resize((ow, oh), Image.BILINEAR)`` bit for
    bit, on a uint8 (H, W, C) array: the horizontal pass, then the vertical
    pass, each only where its side changes (a pass of equal size would be
    the identity); the identity size returns a copy. The sums fit in int32:
    the weights of an output sum to about 2^22, times at most 255."""
    h, w, c = img.shape
    if (oh, ow) == (h, w):
        return img.copy()
    out = img
    if ow != w:  # columns as rows: (W, H * C)
        cols = np.ascontiguousarray(img.transpose(1, 0, 2)).reshape(w, h * c)
        out = _resample_rows(cols, ow).reshape(ow, h, c).transpose(1, 0, 2)
    if oh != h:
        out = _resample_rows(np.ascontiguousarray(out).reshape(h, ow * c), oh)
    return np.ascontiguousarray(out).reshape(oh, ow, c)


def _resized(img: np.ndarray, min_size: int, max_size: int, flip: bool):
    h0, w0 = img.shape[:2]
    oh, ow = resize_hw(h0, w0, min_size, max_size)
    arr = resize_bilinear_u8(img, oh, ow)
    if flip:
        arr = arr[:, ::-1]
    return arr, h0, w0, oh, ow


def preprocess_image(img: np.ndarray, min_size: int, max_size: int, flip: bool,
                     canvas_short: int = 608, canvas_long: int = 1024,
                     pixel_mean: np.ndarray = PIXEL_MEAN_BGR) -> Preprocessed:
    """uint8 RGB frame (H, W, 3) → BGR255 mean-subtracted f32 canvas, the
    padding zero."""
    arr, h0, w0, oh, ow = _resized(img, min_size, max_size, flip)
    arr = arr.astype(np.float32)[:, :, ::-1] - pixel_mean
    ch, cw = canvas_for(h0, w0, canvas_short, canvas_long)
    canvas = np.zeros((ch, cw, 3), np.float32)
    canvas[:oh, :ow] = arr
    return Preprocessed(image=canvas, size=np.array([oh, ow], np.float32),
                        scale=oh / h0)


def preprocess_image_u8(img: np.ndarray, min_size: int, max_size: int, flip: bool,
                        canvas_short: int = 608, canvas_long: int = 1024
                        ) -> Preprocessed:
    """Like ``preprocess_image`` but the canvas stays uint8 RGB (4x smaller
    on the wire); ``normalize_u8_frames`` finishes it on the device, bit for
    bit the f32 canvas (uint8 → f32 is exact)."""
    arr, h0, w0, oh, ow = _resized(img, min_size, max_size, flip)
    ch, cw = canvas_for(h0, w0, canvas_short, canvas_long)
    canvas = np.zeros((ch, cw, 3), np.uint8)
    canvas[:oh, :ow] = arr
    return Preprocessed(image=canvas, size=np.array([oh, ow], np.float32),
                        scale=oh / h0)


def transform_boxes(boxes: np.ndarray, h0: int, w0: int, oh: int, ow: int,
                    flip: bool) -> np.ndarray:
    """Apply the same resize/flip to xyxy boxes (BoxList.resize/transpose)."""
    if len(boxes) == 0:
        return boxes.reshape(0, 4)
    out = boxes.astype(np.float32).copy()
    sx, sy = ow / w0, oh / h0
    out[:, 0::2] *= sx
    out[:, 1::2] *= sy
    if flip:
        x1 = ow - out[:, 2] - 1.0
        x2 = ow - out[:, 0] - 1.0
        out[:, 0], out[:, 2] = x1, x2
    return out


def s2d_pack_frames(frames: np.ndarray, factor: int = 2) -> np.ndarray:
    """Host space-to-depth(factor): (..., H, W, 3) uint8 → (..., H/f, W/f, 3f²)
    with channel (a*f + b)*3 + c holding input pixel (f*p + a, f*q + b, c)."""
    f = factor
    *lead, h, w, c = frames.shape
    out = frames.reshape(*lead, h // f, f, w // f, f, c)
    out = np.moveaxis(out, -4, -3)  # (..., H/f, W/f, f, f, c)
    return np.ascontiguousarray(out).reshape(*lead, h // f, w // f, f * f * c)


# packed-channel index of the BGR-flipped channel: group g keeps its phase,
# the RGB triple inside it flips
_S2D_BGR_PERM = {
    f: tuple(g * 3 + (2 - c) for g in range(f * f) for c in range(3))
    for f in (2, 4)
}


def normalize_u8_frames(frames: torch.Tensor, sizes: torch.Tensor,
                        pixel_mean=None) -> torch.Tensor:
    """uint8 RGB canvas → BGR255 mean-subtracted f32 with the padded region
    zeroed. frames (..., H, W, 3), or s2d(f)-packed (..., H/f, W/f, 3f²) with
    f in {2, 4}, where the pad mask is evaluated per packed phase.
    sizes (..., 2) [oh, ow] on the same device."""
    dev = frames.device
    mean = torch.as_tensor(
        PIXEL_MEAN_BGR if pixel_mean is None else pixel_mean,
        dtype=torch.float32, device=dev,
    )
    h, w = frames.shape[-3], frames.shape[-2]
    lead = frames.shape[:-3]
    oh = sizes[..., 0:1].float()
    ow = sizes[..., 1:2].float()
    iy = torch.arange(h, dtype=torch.float32, device=dev)
    ix = torch.arange(w, dtype=torch.float32, device=dev)
    nc = frames.shape[-1]
    if nc in (12, 48):
        f = 2 if nc == 12 else 4
        perm = torch.tensor(_S2D_BGR_PERM[f], device=dev)
        x = frames[..., perm].float() - mean.repeat(f * f)
        a = torch.tensor([ch // (3 * f) for ch in range(nc)], dtype=torch.float32,
                         device=dev)
        b = torch.tensor([(ch // 3) % f for ch in range(nc)], dtype=torch.float32,
                         device=dev)
        mask_y = (f * iy[None, :, None] + a[None, None, :]) < oh[..., None]
        mask_x = (f * ix[None, :, None] + b[None, None, :]) < ow[..., None]
        mask = mask_y.reshape(*lead, h, 1, nc) & mask_x.reshape(*lead, 1, w, nc)
        return torch.where(mask, x, torch.zeros((), device=dev))
    x = frames.flip(-1).float() - mean
    mask_y = iy[None, :] < oh
    mask_x = ix[None, :] < ow
    mask = mask_y.reshape(*lead, h, 1, 1) & mask_x.reshape(*lead, 1, w, 1)
    return torch.where(mask, x, torch.zeros((), device=dev))
