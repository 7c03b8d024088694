"""Model families: one module per family, named by a configuration file's
``family``, with ``model_config``, ``tree_shapes``, ``make_tree`` and
``make_engine``."""

from __future__ import annotations

import math

import torch


def _walk(node, visit):
    if isinstance(node, dict):
        return {k: _walk(v, visit) for k, v in node.items()}
    if isinstance(node, list):
        return [_walk(v, visit) for v in node]
    return visit(node)


def n_leaves(shapes) -> int:
    """The numbers in a tree of shapes (weights and constants)."""
    total = [0]
    _walk(shapes, lambda s: total.__setitem__(0, total[0] + (s[1] if isinstance(s[0], str)
                                                            else math.prod(s))))
    return total[0]


def leaves_from_seed(shapes, seed: int, device, dtype):
    """The tree of ``shapes`` as tensors on ``device``: every weight leaf (a
    tuple of sizes) a view of one unit-normal draw of a ``torch.Generator``
    seeded with ``seed`` on that device, in the tree's order; ("zeros", n)
    and ("ones", n) leaves constant."""
    sizes = []
    _walk(shapes, lambda s: sizes.append(math.prod(s)) if not isinstance(s[0], str) else None)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    offset = [0]

    def leaf(s):
        if isinstance(s[0], str):
            fill = torch.zeros if s[0] == "zeros" else torch.ones
            return fill(s[1], device=device, dtype=dtype)
        n = math.prod(s)
        out = flat[offset[0]:offset[0] + n].view(s)
        offset[0] += n
        return out

    return _walk(shapes, leaf)
