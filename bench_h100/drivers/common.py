"""Helpers the drivers share."""

from __future__ import annotations

import gc

import numpy as np


def percentile(values, q: float) -> float:
    """The q-th percentile (linear between the closest ranks)."""
    if len(values) == 0:
        return float("nan")
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def sample_indices(rng, count: int, must: list, want: int) -> list:
    """`want` indices of range(count) drawn by `rng`, holding `must`."""
    chosen = list(dict.fromkeys(must))
    for index in rng.permutation(count):
        if len(chosen) >= want:
            break
        if int(index) not in chosen:
            chosen.append(int(index))
    return chosen


def peak_bytes(device: str) -> int:
    if device == "cpu":
        return 0
    import torch
    return torch.cuda.max_memory_allocated()


def release(device: str) -> None:
    """Free what the program held once its objects are dropped."""
    gc.collect()
    if device != "cpu":
        import torch
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
