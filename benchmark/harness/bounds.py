"""The card's peaks and each hand-written kernel's least time (from the
port's ``chip_smoke.py`` ``_bound`` / ``_attention_bound`` and the peaks of
its PERF.md, copied so the yardstick stays put).

A bound is the larger of the bytes over the memory rate and the
operations over their peak rate, each kind on its own units: tensor-core
bf16 FLOPs, f32 operations on the CUDA cores, special functions on the
special function units. Each operand is read once and the output written
once."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet at 700 W; special functions issue at 16 a clock
# per SM (CUDA programming guide, compute capability 9.0), 132 SMs at 1.98 GHz
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
SFU_OPS = 132 * 16 * 1.98e9


def bound_s(nbytes: float, bf16_flops: float = 0.0, f32_ops: float = 0.0,
            sfu_ops: float = 0.0) -> float:
    return max(nbytes / HBM_BYTES_PER_S, bf16_flops / BF16_FLOPS, f32_ops / F32_FLOPS,
               sfu_ops / SFU_OPS)


def attention_flops(n: int, m: int, dim: int = 1024, groups: int = 16,
                    embed: int = 64, position: bool = False) -> int:
    """FLOPs of one lane's attention call: q.k and p.v (2 * N * M * dim each);
    with the position weight, the Wg contraction of each pair's embedding."""
    flops = 2 * 2 * n * m * dim
    if position:
        flops += 2 * n * m * embed * groups
    return flops


def attention_bound_s(lanes: int, n: int, m: int, dim: int = 1024, groups: int = 16,
                      embed: int = 64, position: bool = False) -> float:
    """One launch over ``lanes`` lanes: q, k, v bf16, uk f32 (g, M), valid
    (M bytes), with the position weight the rois and refs f32 and Wg; the f32
    output; per (pair, group) the scale, mask, max and sum in f32 (and pw's
    add, relu, + 1e-6 and product), an exp; per pair in mode "compute" the
    2 logs and 32 sinusoids of dx/dy."""
    d = dim // groups
    pairs = lanes * n * m
    nbytes = lanes * (2 * (n + 2 * m) * dim + 4 * groups * m + m) + lanes * n * dim * 4
    f32, sfu = pairs * groups * 4, pairs * groups
    flops = pairs * groups * 4 * d
    if position:
        nbytes += lanes * (n + m) * 16 + (embed * groups + groups) * 4
        flops += pairs * groups * 2 * 2 * 32
        f32 += pairs * groups * 4
        sfu += pairs * 34
    return bound_s(nbytes, flops, f32, sfu)


def stem_pool_bound_s(frames: int, rows: int, cols: int, out_ch: int = 64,
                      elem: int = 2) -> float:
    """One launch over ``frames`` packed stem-conv outputs (rows, cols,
    4 * out_ch): read once, the pooled (rows, cols, out_ch) written once,
    the f32 scale and shift."""
    nbytes = frames * rows * cols * out_ch * 5 * elem + 2 * 4 * out_ch * 4
    return bound_s(nbytes)
