"""Device: the share of the traced window in which no operation ran on a
card, from the union of its operations' intervals, averaged over the cards
the cell uses."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.busy_s > 0 else None
