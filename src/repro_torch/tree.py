"""Nested dicts of tensors, the port's parameter and optimizer-state trees.

The JAX package keeps its state in pytrees of dicts; JAX visits a dict's
keys in sorted order and names a leaf by the keys on its path. These helpers
do the same for the port's nested dicts, so that sums over leaves run in the
JAX package's order and checkpoint keys come out equal.
"""

from __future__ import annotations

from typing import Callable, Iterator


def tree_map(fn: Callable, tree, *rest):
    """``fn`` on every leaf of ``tree`` (and the matching leaves of ``rest``,
    which have the same keys), keeping the keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_items(tree, prefix: tuple = ()) -> Iterator[tuple[tuple, object]]:
    """``(path, leaf)`` for every leaf, keys sorted as JAX flattens a dict."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_leaves(tree) -> list:
    """The leaves in JAX's order."""
    return [leaf for _, leaf in tree_items(tree)]
