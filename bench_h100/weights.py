"""Seeded weights drawn on the card in a few large calls.

The benchmark makes the weights and hands the same tensors to the
program and to the plain reference.  The tree's layout (which leaves,
their shapes) is the program's, read from its initializer on the meta
device, where nothing is drawn; the values come from one CUDA generator
seeded with --seed: one flat buffer in the served dtype filled with
N(0, 1) in chunks, each leaf a view of it, scaled by a rule on its
path."""

from __future__ import annotations

import math

import numpy as np
import torch

_CHUNK = 1 << 30                 # elements a normal_ call fills


def leaves(tree: dict, path: tuple = ()):
    """(path, leaf) of a nested dict of tensors, in insertion order."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from leaves(value, path + (key,))
        else:
            yield path + (key,), value


def set_leaf(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def draw(shapes: dict, scale_of, seed: int, device, dtype) -> dict:
    """A tree shaped like `shapes` (meta tensors) filled from a generator
    on `device` seeded with `seed`.  scale_of(path, shape) returns how
    to turn N(0, 1) draws into the leaf: a float (multiply), ("one",
    s) for 1 + s N(0, 1), or ("fill", tensor) to copy a fixed table."""
    items = list(leaves(shapes))
    total = sum(leaf.numel() for _, leaf in items)
    generator = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(total, dtype=dtype, device=device)
    for start in range(0, total, _CHUNK):
        flat[start:start + _CHUNK].normal_(generator=generator)
    tree: dict = {}
    offset = 0
    for path, leaf in items:
        view = flat[offset:offset + leaf.numel()].view(leaf.shape)
        offset += leaf.numel()
        rule = scale_of(path, tuple(leaf.shape))
        if isinstance(rule, tuple) and rule[0] == "one":
            view.mul_(rule[1]).add_(1.0)
        elif isinstance(rule, tuple) and rule[0] == "fill":
            view.copy_(rule[1])
        else:
            view.mul_(float(rule))
        set_leaf(tree, path, view)
    return tree


def sinusoids(length: int, channels: int) -> torch.Tensor:
    """Whisper's fixed audio positions: sin then cos of log-spaced
    timescales, (length, channels)."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return torch.from_numpy(np.concatenate(
        [np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32))


def whisper_scale(path: tuple, shape: tuple):
    """Draw rules of the Whisper tree (models/asr.py's layout)."""
    name = path[-1]
    if name == "scale":
        return ("one", 0.1)
    if name == "b":
        return 0.02
    if path[0] == "enc_positions":
        return ("fill", sinusoids(*shape))
    if path[0] == "dec_positions":
        return 0.01
    if path[0] == "token_embed":
        return 0.02
    if path[0] in ("conv1", "conv2"):
        return 1.0 / math.sqrt(shape[1] * shape[2])   # (out, in, k)
    return 1.0 / math.sqrt(shape[-2])                  # (..., in, out)


def transformer_scale(path: tuple, shape: tuple):
    """Draw rules of the decoder-only tree (models/transformer.py's
    layout, with the untied lm_head (vocab, d))."""
    if path[-1] == "scale":
        return ("one", 0.1)
    if path[0] == "embed":
        return 0.02
    if path[0] == "lm_head":
        return 1.0 / math.sqrt(shape[-1])
    return 1.0 / math.sqrt(shape[-2])
