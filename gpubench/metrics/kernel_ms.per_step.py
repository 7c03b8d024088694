"""Kernels: device time of the program's own kernels (``trace.is_library``
false), per MD step of the window."""


def read(ctx):
    return 1e3 * ctx.trace.own_s / ctx.steps if ctx.trace.own_s > 0 else None
