"""The yardstick's counts: the reference step's FLOPs against closed forms,
and the kernels' operations and least times against the figures of the
port's kernel table (PERF.md)."""

from __future__ import annotations

import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_tiny import tiny_cell  # noqa: E402
from benchmark.harness import bounds, flops  # noqa: E402
from benchmark.harness.weights import calibrated_weights  # noqa: E402
from benchmark.reference import vid  # noqa: E402
from benchmark.reference.ops import Precision  # noqa: E402
from benchmark.reference.vid import STAGES  # noqa: E402


def _conv_flops(c, h, w):
    """Closed form of the C4 body's and res5's convolutions on an (h, w) frame:
    2 * Cin * Cout * k * k * Hout * Wout each."""
    total = 0

    def conv(cin, cout, k, hh, ww):
        return 2 * cin * cout * k * k * hh * ww

    hh, ww = (h + 1) // 2, (w + 1) // 2
    total += conv(3, 64, 7, hh, ww)
    hh, ww = (hh + 1) // 2, (ww + 1) // 2
    cin = 64
    for i, blocks in enumerate(STAGES[c["depth"]]):
        mid, cout = 64 * 2 ** i, 256 * 2 ** i
        if 0 < i < 3:
            hh, ww = (hh + 1) // 2, (ww + 1) // 2
        for b in range(blocks):
            src = cin if b == 0 else cout
            if b == 0:
                total += conv(cin, cout, 1, hh, ww)
            total += conv(src, mid, 1, hh, ww) + conv(mid, mid, 3, hh, ww) \
                + conv(mid, cout, 1, hh, ww)
        cin = cout
    return total, (hh, ww)


def test_reference_counts_equal_closed_forms():
    cell = tiny_cell("mega")
    c = cell.config
    P = calibrated_weights(c, 5, "cpu", (60, 90))
    h, w = c["canvas"]
    img = torch.randn(1, 3, h, w)
    prec = Precision()

    def body():
        vid.res5(vid.backbone(img, P, c, prec), P, "extractor", c, prec)
    body_flops, (fh, fw) = _conv_flops(c, h, w)
    assert flops.count(body) == body_flops

    n, m, d, g, e = 7, 11, c["mlp_dim"], c["attention"]["groups"], c["attention"]["embed_dim"]
    x, ref = torch.rand(n, d), torch.rand(m, d)
    rois = torch.tensor([[0.0, 0.0, 20.0, 30.0]]).repeat(n, 1) + torch.arange(n)[:, None]
    refs = torch.tensor([[5.0, 5.0, 40.0, 25.0]]).repeat(m, 1) + torch.arange(m)[:, None]
    valid = torch.ones(m, dtype=torch.bool)

    def attn():
        vid.attention(x, ref, valid, P, "extractor.l_attn_0", prec, pos=(rois, refs))
    closed = (2 * n * d * d + 2 * m * d * d  # Wq, Wk
              + 2 * m * d * d  # the per-group values
              + 2 * g * m * (d // g)  # u . k
              + bounds.attention_flops(n, m, d, g, e, position=True))  # q.k, p.v, Wg
    assert flops.count(attn) == closed

    step = flops.step_flops(c, P, (60, 90), 2, "cpu")
    assert step == flops.step_flops(c, P, (60, 90), 2, "cpu") and step % 2 == 0
    assert step > 2 * 2 * body_flops


@pytest.mark.parametrize("n,m,position,gflop", [(2175, 750, False, 6.68), (300, 750, False, 0.92),
                                                (675, 3750, True, 15.55), (675, 750, True, 3.11),
                                                (300, 750, True, 1.38)])
def test_attention_operations_match_the_kernel_table(n, m, position, gflop):
    assert math.isclose(bounds.attention_flops(n, m, position=position) / 1e9, gflop,
                        abs_tol=0.005)


@pytest.mark.parametrize("lanes,n,m,position,ms", [(1, 2175, 750, False, 0.0068),
                                                   (1, 675, 3750, True, 0.0303),
                                                   (12, 675, 3750, True, 0.3632),
                                                   (12, 675, 750, True, 0.0726),
                                                   (12, 300, 750, True, 0.0323)])
def test_attention_bounds_match_the_kernel_table(lanes, n, m, position, ms):
    got = bounds.attention_bound_s(lanes, n, m, position=position) * 1e3
    assert math.isclose(got, ms, rel_tol=0.01), got


@pytest.mark.parametrize("frames,ms", [(2, 0.0149), (24, 0.1784)])
def test_stem_pool_bound_matches_the_kernel_table(frames, ms):
    assert math.isclose(bounds.stem_pool_bound_s(frames, 152, 256) * 1e3, ms, rel_tol=0.01)
