# Image synthesis helpers.
#
# Counterpart of the synthesis part of aiko_services_tpu/elements/image_io.py
# (synthesize_image, synthesize_image_on_device); the file, resize and
# overlay elements of that module are not ported yet.  The host image is
# the JAX package's numpy code, bit for bit.  The on-device image cannot
# reproduce jax.random's bits: it draws from a torch.Generator seeded with
# the same seed on the device the caller names (deterministic per seed and
# device, different numbers from the JAX package's).

from __future__ import annotations

import numpy as np
import torch

from ..ops.device import resolve_device

__all__ = ["synthesize_image", "synthesize_image_on_device"]


def synthesize_image(shape, seed: int) -> np.ndarray:
    """Deterministic random image (C, H, W) f32 in [0, 1]."""
    rng = np.random.default_rng(int(seed))
    return rng.random(tuple(int(size) for size in shape),
                      dtype=np.float32)


def synthesize_image_on_device(shape, seed: int,
                               device="cuda") -> torch.Tensor:
    """Deterministic random image (C, H, W) f32 in [0, 1) drawn on
    `device` from a generator seeded with `seed`."""
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(int(seed))
    return torch.rand(tuple(int(size) for size in shape),
                      generator=generator, device=device)
