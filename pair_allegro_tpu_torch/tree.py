"""Parameter trees: nested dicts and lists of tensors, as the model inits
and ``checkpoint`` build them."""

from __future__ import annotations


def leaves(tree) -> list:
    """The tensors of a tree of dicts and lists, in the tree's order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` applied to every tensor of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)
