"""Potential and model glue: device time inside ``bench.force`` that is not
the program's own kernels (PyTorch's and cuBLAS's operations), per MD step
of the window."""


def read(ctx):
    s = ctx.trace.by_span.get("bench.force", 0.0) - ctx.trace.own_by_span.get("bench.force", 0.0)
    return 1e3 * s / ctx.steps if s > 0 else None
