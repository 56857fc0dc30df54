"""The work of one lockstep step of a configuration: ``FlopCounterMode`` over
the plain reference's lane-step at the cell's shapes, times the lanes.
Convolutions, linear layers and the attention products count; ROIAlign,
NMS and elementwise passes do not. The count depends on the shapes alone."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import vid
from ..reference.ops import Precision
from ..reference.vid import Entry


class _WholeRun:
    """Stands in for FlopCounterMode's module tracker: no modules here."""

    parents = {"Global"}

    def __enter__(self):
        return self

    def __exit__(self, *args):
        return None


def count(fn) -> int:
    counter = FlopCounterMode(display=False)
    counter.mod_tracker = _WholeRun()
    with counter:
        fn()
    return int(counter.get_total_flops())


def lane_step(c: dict, P: dict, image_size, device):
    """A callable running the reference's work of one lane-step on seeded
    inputs: MEGA the local and the global frame, then the key's detection
    over a full window, memory and global cache; FGFA the new frame, then
    the key's detection over its window."""
    gen = torch.Generator(device).manual_seed(0)
    h, w = c["canvas"]
    prec = Precision()
    img = torch.randn((1, 3, h, w), generator=gen, device=device) * 50

    if c["method"] == "mega":
        a = c["attention"]
        bn = c["ref_post_nms_top_n"]
        an = int(bn * c["ratio"])
        d = c["mlp_dim"]

        def rand_entry(n):
            xy = torch.rand((n, 2), generator=gen, device=device) * (w / 2)
            boxes = torch.cat([xy, xy + 32 + torch.rand((n, 2), generator=gen, device=device)
                               * (w / 2)], 1)
            return Entry(boxes, torch.ones(n, dtype=torch.bool, device=device),
                         torch.rand((n, d), generator=gen, device=device))

        window = [rand_entry(c["post_nms_top_n_test"]) for _ in range(c["all_frame_interval"])]
        memory = [[(e.rois, e.feats, e.valid) for e in
                   (rand_entry(n) for _ in range(c["memory_size"]))]
                  for n in [bn] + [an] * (a["stages"] - 1)]
        glob = [(e.feats, e.valid) for e in (rand_entry(bn) for _ in range(c["global_size"]))]

        def run():
            vid.mega_frame(img, image_size, P, c, prec)
            vid.mega_frame(img, image_size, P, c, prec, key=False)
            vid.mega_detect(window[c["key_frame_location"]], window, memory, glob,
                            image_size, P, c, prec)
        return run

    t = c["all_frame_interval"]
    entry = vid.fgfa_frame(img, P, c, prec)

    def run():
        vid.fgfa_frame(img, P, c, prec)
        vid.fgfa_detect([img] * t, [entry] * t, image_size, P, c, prec)
    return run


def step_flops(c: dict, P: dict, image_size, lanes: int, device) -> int:
    fn = lane_step(c, P, image_size, device)
    with torch.no_grad():
        return lanes * count(fn)
