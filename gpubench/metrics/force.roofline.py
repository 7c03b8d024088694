"""Force evaluation: the least time the counted work of the window's force
evaluations needs (``peaks.least_seconds`` of ``counts/<family>.py``'s
operations and bytes on real edges, products at the policy's rate) on
one card, over the device time of the operations launched inside
``bench.force``, summed over the cards."""

from gpubench.peaks import least_seconds


def read(ctx):
    dev = ctx.trace.by_span.get("bench.force", 0.0)
    if dev <= 0 or ctx.evals == 0:
        return None
    w = ctx.work
    least = least_seconds(w["flops"] * ctx.evals, w["products"] * ctx.evals,
                          w["bytes"] * ctx.evals, ctx.policy)
    return 100.0 * least / dev
