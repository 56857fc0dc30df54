"""The whole step's share of the card's bf16 peak: the FLOPs of one step of
the plain reference at the cell's shapes (``harness/flops.py``) over the
plain window's seconds a step, against 989 TFLOP/s, in percent."""

from benchmark.harness.bounds import BF16_FLOPS


def read(ctx):
    step_s = ctx["window"]["wall_s"] / ctx["window"]["steps"]
    return 100.0 * ctx["step_flops"] / step_s / BF16_FLOPS
