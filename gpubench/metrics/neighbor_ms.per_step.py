"""Neighbor build: device time of the operations launched inside
``bench.rebuild`` (the skin check and the builds it lets through), per MD
step of the window."""


def read(ctx):
    s = ctx.trace.by_span.get("bench.rebuild", 0.0)
    return 1e3 * s / ctx.steps if s > 0 else None
