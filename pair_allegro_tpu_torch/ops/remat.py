"""Recompute in the backward (counterpart of ``jax.checkpoint``)."""

from __future__ import annotations

from torch.utils.checkpoint import checkpoint


def rematerialized(fn, on: bool):
    """``fn`` run under a non-reentrant ``torch.utils.checkpoint`` when
    ``on``: its activations are not kept, and its forward runs again in
    the backward.  The models draw no random numbers, so no generator state
    is stashed."""
    if not on:
        return fn

    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)

    return run
