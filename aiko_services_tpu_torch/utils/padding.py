# Shape-bucketing helpers shared by the pipeline engine and the models
# (utils so models/ need not import pipeline/).  Counterpart of
# aiko_services_tpu/utils/padding.py: pad_axis_to pads torch tensors with
# torch and numpy arrays with numpy.  Bucketing bounds
# jit's shape-keyed compilation cache for ragged streaming inputs: pad
# variable axes up to O(log(max_len)) bucket sizes instead of compiling one
# program per observed length.  No reference counterpart -- the reference
# never compiles anything (SURVEY.md 7 "hard parts": recompilation control).

from __future__ import annotations

import logging

import numpy as np
import torch

__all__ = ["bucket_length", "pad_axis_to"]

_LOGGER = logging.getLogger("aiko.padding")


def bucket_length(length: int, minimum: int = 16,
                  buckets: list | None = None) -> int:
    """Smallest allowed padded length >= length.

    With explicit buckets, pick the first bucket that fits; lengths beyond
    the last bucket fall back to power-of-two growth (never truncate).
    Otherwise round up to a power of two, floored at `minimum`.
    """
    if buckets:
        for bucket in buckets:
            if length <= bucket:
                return int(bucket)
        _LOGGER.warning(
            "length %d exceeds largest bucket %d; growing power-of-two",
            length, buckets[-1])
        minimum = int(buckets[-1])
    padded = max(int(minimum), 1)
    while padded < length:
        padded *= 2
    return padded


def pad_axis_to(array, axis: int, target: int, pad_value=0):
    """Pad `axis` up to `target` with pad_value; no-op when already there.
    Refuses to shrink -- silent truncation loses frame data."""
    current = array.shape[axis]
    if current == target:
        return array
    if current > target:
        raise ValueError(
            f"pad_axis_to cannot shrink axis {axis} from {current} to "
            f"{target}")
    if isinstance(array, torch.Tensor):
        axis %= array.ndim
        # F.pad lists (before, after) pairs from the LAST axis backwards
        widths = [0, 0] * (array.ndim - axis)
        widths[-1] = target - current
        return torch.nn.functional.pad(array, widths, value=pad_value)
    widths = [(0, 0)] * array.ndim
    widths[axis] = (0, target - current)
    return np.pad(np.asarray(array), widths, constant_values=pad_value)
