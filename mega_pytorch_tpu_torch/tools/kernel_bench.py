"""The relation-attention kernels' flagship operands, a lane-by-lane call of
a plain version, and an alternating CUDA-event timer, shared by
``chip_smoke.py`` and ``tools/kernel_ab.py`` so that the two check and time
the same inputs the same way."""

from __future__ import annotations

import statistics

import torch

CANVAS = (608, 1024)  # the flagship's (height, width)


def attention_inputs(gen, b, n, m, dev, canvas=CANVAS):
    """q, k, v (bf16), uk at the scale of q.k, 80 % valid refs, and boxes of
    16-316 pixels on the canvas for rois and refs, with Wg and its bias, all
    drawn from ``gen`` in a fixed order."""
    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def boxes(count):
        ctr = torch.rand(b, count, 2, generator=gen, device=dev) * torch.tensor(
            [canvas[1], canvas[0]], device=dev)
        wh = 16 + torch.rand(b, count, 2, generator=gen, device=dev) * 300
        return torch.cat([ctr - wh / 2, ctr + wh / 2], -1).contiguous()

    bf = torch.bfloat16
    return dict(
        q=randn(b, 16, n, 64).to(bf), k=randn(b, 16, m, 64).to(bf),
        v=randn(b, 16, m, 64).to(bf), uk=randn(b, 16, m, scale=8.0),  # as q.k
        valid=torch.rand(b, m, generator=gen, device=dev) > 0.2,
        rois=boxes(n), refs=boxes(m),
        wk=randn(64, 16, scale=0.05),
        wb=torch.rand(16, generator=gen, device=dev) * 0.1,
    )


def per_lane(fn, args, b):
    """fn over each lane of a B-lane call's arguments, concatenated (the
    plain versions at 12 lanes would hold several GB at once)."""
    def lane(t, i):
        return t[i:i + 1] if t.dim() > 1 and t.shape[0] == b else t
    return torch.cat([fn(*[lane(t, i) for t in args]) for i in range(b)])


def time_alternating(fns, repeats, inner=10):
    """Median ms per call of each function: CUDA events around ``inner``
    back-to-back calls, after one warm-up call of each, the functions taking
    turns in an order that reverses every repeat."""
    def once(fn):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / inner

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    order = list(range(len(fns)))
    for i in range(repeats):
        for j in (order if i % 2 == 0 else order[::-1]):
            times[j].append(once(fns[j]))
    return [statistics.median(t) for t in times]
