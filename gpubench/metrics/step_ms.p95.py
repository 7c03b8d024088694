"""MD driver: the 95th percentile of the host time between successive
returns of the skin check, one a step (the step's one host read), within
the window's episodes; at least 100 of them (two episodes give 118), so
that five lie beyond it, which a traced window of the cells it lists
always holds."""

import statistics


def read(ctx):
    if len(ctx.step_s) < 100:
        return None
    return 1e3 * statistics.quantiles(ctx.step_s, n=20)[-1]
