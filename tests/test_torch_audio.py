# The port's log-mel frontend (ops/audio.py) against the JAX package's
# on the CPU, on the same numpy audio.  Tolerance atol 1e-4 on the
# log-mel (a log10 of power sums, scaled by 1/4; the two take the DFT's
# cancellation-heavy sums in another order).

import numpy as np
import pytest
import torch

from aiko_services_tpu.ops import audio as jax_audio
from aiko_services_tpu_torch.ops import audio as torch_audio


def _audio(shape, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / 16000.0
    tone = np.sin(2 * np.pi * 440.0 * t)
    noise = rng.normal(0, 0.1, shape)
    return (tone + noise).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 4000), (3, 1, 1600), (4001,)])
def test_log_mel_matches_jax(shape):
    audio = _audio(shape)
    expected = np.asarray(jax_audio.log_mel_spectrogram(audio))
    actual = torch_audio.log_mel_spectrogram(torch.from_numpy(audio))
    assert actual.shape == expected.shape
    np.testing.assert_allclose(actual.numpy(), expected, atol=1e-4,
                               rtol=0)


def test_filterbank_and_basis_are_the_jax_packages():
    np.testing.assert_array_equal(torch_audio.mel_filterbank(),
                                  jax_audio.mel_filterbank())
    for ours, theirs in zip(torch_audio.dft_basis(400),
                            jax_audio.dft_basis(400)):
        np.testing.assert_array_equal(ours, theirs)
