"""Nested-dict trees in the reference's leaf order.

``jax.tree_util`` flattens a dict by its sorted keys, at every level.  The
port's parameter trees in the reference's layout, optimizer states and
training checkpoints are nested dicts walked in that order, so a leaf's
index is the same in both packages.  Anything that is not a dict is a
leaf.
"""
from __future__ import annotations

from typing import Any, Callable

Tree = Any


def leaves(tree: Tree) -> list:
    """The leaves of ``tree``, dict keys sorted at every level."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``."""
    if isinstance(tree, dict):
        out = {k: map(fn, tree[k], *(r[k] for r in rest))
               for k in sorted(tree)}
        return {k: out[k] for k in tree}     # visited sorted, kept in order
    return fn(tree, *rest)


def unflatten(template: Tree, values: list) -> Tree:
    """A tree of ``template``'s structure holding ``values`` in leaf
    order."""
    it = iter(values)
    out = map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more values than the template has leaves")
    return out
