"""Seeded weights and frames, made on the device in a few large draws.

Weights follow the flax initialisers (``reference/params.py``): one
truncated normal for every lecun-normal tensor, one normal for the rest,
each slice scaled to its tensor's deviation, rounded to the served dtype
and kept as float32 (so the program and the reference hold the same
values). FrozenBN statistics are then calibrated on two seeded frames by
the reference, the stand-in for pretrained statistics: under identity
statistics random R-101 weights drive the activations to thousands, the
RPN's deltas clip every box to the image and every score saturates."""

from __future__ import annotations

import math

import torch

from ..reference import vid
from ..reference.ops import float32_matmul, normalize_frames
from ..reference.params import CONST, LECUN, param_spec

SERVED = {"bfloat16": torch.bfloat16, "float32": torch.float32}
TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated at +-2


def draw_weights(c: dict, gen: torch.Generator, device) -> dict:
    spec = param_spec(c)
    served = SERVED[c["compute_dtype"]]
    groups = {kind: [s for s in spec if s[2][0] == kind] for kind in (LECUN, "normal")}
    out = {}
    for kind, items in groups.items():
        total = sum(math.prod(shape) for _, shape, _ in items)
        buf = torch.empty(total, device=device)
        if kind == LECUN:
            torch.nn.init.trunc_normal_(buf, 0.0, 1.0, -2.0, 2.0, generator=gen)
        else:
            buf.normal_(0.0, 1.0, generator=gen)
        pos = 0
        for name, shape, (_, arg) in items:
            n = math.prod(shape)
            std = math.sqrt(1.0 / arg) / TRUNC_STD if kind == LECUN else arg
            out[name] = (buf[pos:pos + n] * std).to(served).float().reshape(shape)
            pos += n
    for name, shape, (kind, value) in spec:
        if kind == CONST:
            out[name] = torch.full(shape, value, device=device)
    return out


def draw_frames(count: int, canvas, gen: torch.Generator, device) -> torch.Tensor:
    """(count, H, W, 3) uint8 RGB canvases."""
    return torch.randint(0, 256, (count, *canvas, 3), generator=gen, device=device,
                         dtype=torch.uint8)


def calibrated_weights(c: dict, seed: int, device, image_size) -> dict:
    """The configuration's weights from ``seed`` (the drivers pass the
    configuration's ``weights_seed``: one model for every run) with
    calibrated FrozenBN statistics (two seeded frames, the reference in
    float32)."""
    gen = torch.Generator(device).manual_seed(seed % 2 ** 63)
    P = draw_weights(c, gen, device)
    frames = draw_frames(2, c["canvas"], gen, device)
    with torch.no_grad(), float32_matmul():
        stats = vid.calibrate(normalize_frames(frames, [image_size] * 2), P, c)
    P.update(stats)
    return P
