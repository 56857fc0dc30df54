"""Frame packing and normalization (counterpart of
``mega_pytorch_tpu/data/transforms.py``): the host-side s2d packing is
copied numpy; ``normalize_u8_frames`` runs on the frames' device."""

from __future__ import annotations

import numpy as np
import torch

PIXEL_MEAN_BGR = np.array([102.9801, 115.9465, 122.7717], np.float32)


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
