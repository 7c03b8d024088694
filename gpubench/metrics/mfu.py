"""Whole step: the counted operations of the window's force evaluations
per second of the traced window, over the dense bf16 peak (989 TFLOP/s)
of each card the cell uses, the one yardstick of every configuration."""

from gpubench.peaks import BF16_FLOPS


def read(ctx):
    if ctx.evals == 0:
        return None
    return 100.0 * ctx.work["flops"] * ctx.evals / ctx.trace.window_s / (BF16_FLOPS * ctx.chips)
