# Nested-dict parameter trees: the small part of jax.tree_util the port
# needs (no counterpart file in the JAX package, which uses jax.tree_util).
# A tree is a dict or a list whose entries are trees or leaves (the
# YOLOv8 tree keeps its repeated blocks in lists, as jax.tree_util
# walks them); tuples are leaves.  A Sharded leaf (parallel/mesh.py)
# counts as the node of its distinct blocks: tree_leaves lists each block
# once and tree_map rebuilds the Sharded around the mapped blocks, so an
# optimizer's elementwise update runs on the shards as they lie.
# flatten_tensors / rebuild_tensors take any nesting of dicts, tuples,
# lists and object grids apart into its distinct tensors and put it back
# together: a torch.autograd.Function takes and returns flat tensors.

from __future__ import annotations

import numpy as np
import torch

__all__ = ["tree_map", "tree_leaves", "flatten_tensors", "rebuild_tensors"]


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


class _Slot:
    """A tensor's place in flatten_tensors' list."""

    def __init__(self, index: int):
        self.index = index


def flatten_tensors(node, tensors: list, places: dict | None = None):
    """`node` (dicts, tuples, lists and numpy object grids of tensors)
    with each tensor replaced by its place in `tensors`, to which each
    distinct tensor is appended once (`places`: id -> place, shared
    between calls that fill one list)."""
    places = {} if places is None else places
    if isinstance(node, torch.Tensor):
        if id(node) not in places:
            places[id(node)] = len(tensors)
            tensors.append(node)
        return _Slot(places[id(node)])
    if isinstance(node, dict):
        return {key: flatten_tensors(value, tensors, places)
                for key, value in node.items()}
    if isinstance(node, (tuple, list)):
        return type(node)(flatten_tensors(value, tensors, places)
                          for value in node)
    if isinstance(node, np.ndarray):
        out = np.empty(node.shape, dtype=object)
        for index, value in np.ndenumerate(node):
            out[index] = flatten_tensors(value, tensors, places)
        return out
    return node


def rebuild_tensors(template, tensors):
    """flatten_tensors' `node` again, with tensors[i] at place i."""
    if isinstance(template, _Slot):
        return tensors[template.index]
    if isinstance(template, dict):
        return {key: rebuild_tensors(value, tensors)
                for key, value in template.items()}
    if isinstance(template, (tuple, list)):
        return type(template)(rebuild_tensors(value, tensors)
                              for value in template)
    if isinstance(template, np.ndarray):
        out = np.empty(template.shape, dtype=object)
        for index, value in np.ndenumerate(template):
            out[index] = rebuild_tensors(value, tensors)
        return out
    return template


def tensor_place(template, index) -> int | None:
    """The place in `tensors` of the tensor at `index` of a flattened
    object grid (None where the grid holds no tensor)."""
    slot = template[index]
    return slot.index if isinstance(slot, _Slot) else None
