"""Kernel-layout weights derived from a parameter tree's own leaves.

The kernels take their weights in layouts of their own (p-major mix rows,
transposes, folded matrices).  Those copies are made from the tree's leaves
and kept until a leaf is replaced or updated in place: an entry remembers
each leaf by a weak reference and its ``_version`` counter, which every
in-place operation advances.  So a steady MD run pays no launches for them,
and a training step or an edit of the tree is never stale.  The copies are
made without autograd; gradients reach the leaves through the autograd
Functions, which take the leaves themselves as inputs.  The other builds'
layouts are properties of the cached object, one per build (``layout`` /
``packed`` / ``packed_x3`` of K1Weights, ``prologue`` of K6Weights): the
bf16 and one-pass builds' pair-packed copies and the bf16x3 build's hi / lo
copies, each made at its build's first launch, so they are replaced with
the object when a leaf changes.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Callable

import torch


class DerivedCache:
    """Values derived from tensors, rebuilt when any of them is replaced or
    updated in place; at most ``maxsize`` entries, least recently used
    first out."""

    def __init__(self, maxsize: int = 64):
        self.maxsize = maxsize
        self.builds = 0  # values made since the process started
        self._entries: OrderedDict = OrderedDict()

    def get(self, tag, leaves, make: Callable):
        leaves = tuple(leaves)
        key = (tag, tuple(id(t) for t in leaves))
        versions = tuple(t._version for t in leaves)
        hit = self._entries.get(key)
        if hit is not None:
            refs, seen, value = hit
            if seen == versions and all(r() is t for r, t in zip(refs, leaves)):
                self._entries.move_to_end(key)
                return value
        with torch.no_grad():
            value = make()
        self.builds += 1
        self._entries[key] = (tuple(weakref.ref(t) for t in leaves), versions, value)
        self._entries.move_to_end(key)
        while len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)
        return value


LAYOUTS = DerivedCache()
