# Parameters of the JAX package -> the port's parameters.
#
# No counterpart in the JAX package.  Both packages keep one parameter
# tree: nested dicts with the same keys and the same layouts (dense
# weights (in, out), conv weights (C_out, C_in, K), layers stacked on a
# leading (L, ...) axis, which the port's asr.py indexes as the JAX code
# scans).  So the bridge only moves leaves: a tree of numpy arrays, as
# `jax.tree_util.tree_map(np.asarray, params)` gives it, becomes a tree
# of tensors on `device`.  The tests use it so that both packages compute
# on the same weights.

from __future__ import annotations

import numpy as np
import torch

from ..utils.tree import tree_map

__all__ = ["params_from_numpy", "params_to_numpy"]


def _leaf_to_tensor(leaf, dtype, device) -> torch.Tensor:
    array = np.asarray(leaf)
    if array.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 (from a JAX array): the same 16 bits
        tensor = torch.from_numpy(array.view(np.uint16).copy()).view(
            torch.bfloat16)
    else:
        tensor = torch.from_numpy(np.array(array))
    if dtype is not None and tensor.is_floating_point():
        tensor = tensor.to(dtype)
    return tensor.to(device)


def params_from_numpy(tree: dict, device="cpu", dtype=None) -> dict:
    """A tree of numpy arrays -> a tree of tensors on `device`; dtype
    (a name or torch.dtype) casts every floating-point leaf."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return tree_map(lambda leaf: _leaf_to_tensor(leaf, dtype, device),
                    tree)


def params_to_numpy(tree: dict) -> dict:
    """A tree of tensors -> a tree of numpy arrays on the host (bf16
    leaves become float32: numpy has no bfloat16)."""
    def to_numpy(tensor):
        tensor = tensor.detach().cpu()
        if tensor.dtype == torch.bfloat16:
            tensor = tensor.float()
        return tensor.numpy()

    return tree_map(to_numpy, tree)
