"""Parameter trees: nested dicts, lists and tuples (named ones included,
so a ``QTensor`` leaf maps over its values and scale) of tensors — the
port's stand-in for ``jax.tree_util``."""
from __future__ import annotations


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)
