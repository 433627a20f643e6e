# Nested-dict parameter trees: the small part of jax.tree_util the port
# needs (no counterpart file in the JAX package, which uses jax.tree_util).
# A tree is a dict or a list whose entries are trees or leaves (the
# YOLOv8 tree keeps its repeated blocks in lists, as jax.tree_util
# walks them); tuples are leaves.  A Sharded leaf (parallel/mesh.py)
# counts as the node of its distinct blocks: tree_leaves lists each block
# once and tree_map rebuilds the Sharded around the mapped blocks, so an
# optimizer's elementwise update runs on the shards as they lie.

from __future__ import annotations

__all__ = ["tree_map", "tree_leaves"]


def _is_sharded(node) -> bool:
    return hasattr(node, "unique") and hasattr(node, "sharding")


def tree_map(function, tree):
    """A tree of the same shape with function(leaf) at every leaf."""
    if isinstance(tree, dict):
        return {key: tree_map(function, value)
                for key, value in tree.items()}
    if isinstance(tree, list):
        return [tree_map(function, value) for value in tree]
    if _is_sharded(tree):
        return tree.map(function)
    return function(tree)


def tree_leaves(tree) -> list:
    """The leaves in insertion order."""
    if isinstance(tree, (dict, list)):
        leaves = []
        for value in (tree.values() if isinstance(tree, dict) else tree):
            leaves.extend(tree_leaves(value))
        return leaves
    if _is_sharded(tree):
        return tree.unique()
    return [tree]
