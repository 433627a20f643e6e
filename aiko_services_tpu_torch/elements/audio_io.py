# Audio synthesis helpers.
#
# Counterpart of the synthesis part of aiko_services_tpu/elements/audio_io.py
# (SAMPLE_RATE, synthesize_tone, synthesize_tone_on_device); the file and
# device elements of that module are not ported yet.  The host tone is the
# JAX package's numpy code, bit for bit; the on-device tone computes the
# same formula in f32 on the device the caller names.

from __future__ import annotations

import numpy as np
import torch

from ..ops.device import resolve_device

__all__ = ["SAMPLE_RATE", "synthesize_tone", "synthesize_tone_on_device"]

SAMPLE_RATE = 16000  # reference audio_io.py:455-460: 16 kHz


def synthesize_tone(frequency: float, seconds: float,
                    sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    return np.sin(2 * np.pi * frequency * t).astype(np.float32)


def synthesize_tone_on_device(frequency, seconds: float,
                              sample_rate: int = SAMPLE_RATE,
                              device="cuda") -> torch.Tensor:
    """sin(2 pi f t) synthesized on `device` in f32: (samples,) for one
    frequency, (B, samples) for a (B,) sequence of frequencies."""
    device = resolve_device(device)
    t = torch.arange(int(seconds * sample_rate), dtype=torch.float32,
                     device=device) / sample_rate
    frequency = torch.as_tensor(frequency, dtype=torch.float32,
                                device=device)
    return torch.sin(2 * np.pi * frequency[..., None] * t)
