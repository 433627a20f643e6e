# Nested-dict parameter trees: the small part of jax.tree_util the port
# needs (no counterpart file in the JAX package, which uses jax.tree_util).
# A tree is a dict whose values are trees or leaves; lists and tuples are
# leaves.

from __future__ import annotations

__all__ = ["tree_map", "tree_leaves"]


def tree_map(function, tree):
    """A tree of the same shape with function(leaf) at every leaf."""
    if isinstance(tree, dict):
        return {key: tree_map(function, value)
                for key, value in tree.items()}
    return function(tree)


def tree_leaves(tree) -> list:
    """The leaves in insertion order."""
    if isinstance(tree, dict):
        leaves = []
        for value in tree.values():
            leaves.extend(tree_leaves(value))
        return leaves
    return [tree]
