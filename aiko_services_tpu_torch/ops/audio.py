# Audio feature ops: log-mel spectrogram in PyTorch.
#
# Counterpart of aiko_services_tpu/ops/audio.py.  The STFT is one strided
# convolution with the windowed real-DFT basis (_stft_kernel), as there.
# The JAX package runs that convolution at Precision.HIGHEST; a float32
# convolution on the card goes through cuDNN in TF32 by default, which
# keeps about three decimal digits, so TF32 is switched off around it.
#
# dft_basis, _stft_kernel and mel_filterbank are numpy, copied unchanged.

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .device import counted_flags

__all__ = ["mel_filterbank", "log_mel_spectrogram", "dft_basis",
           "full_f32_convolution", "SAMPLE_RATE", "N_FFT", "HOP_LENGTH",
           "N_MELS"]

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
N_MELS = 80


def _hz_to_mel(frequency):
    return 2595.0 * np.log10(1.0 + np.asarray(frequency) / 700.0)


def _mel_to_hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def dft_basis(n_fft: int) -> tuple:
    """rfft as real matmul bases: (cos, -sin), each (n_fft, bins) --
    the rfft convention e^{-i angle}."""
    n_freqs = n_fft // 2 + 1
    angles = (2.0 * np.pi / n_fft) * np.outer(np.arange(n_fft),
                                              np.arange(n_freqs))
    return (np.cos(angles).astype(np.float32),
            (-np.sin(angles)).astype(np.float32))


@functools.lru_cache(maxsize=8)
def _stft_kernel(n_fft: int) -> np.ndarray:
    """Windowed real-DFT basis as a conv kernel (n_fft, 1, n_fft+2):
    framing, windowing and the DFT as ONE strided convolution."""
    cos_m, sin_m = dft_basis(n_fft)
    window = np.hanning(n_fft).astype(np.float32)[:, None]
    basis = np.concatenate([cos_m, sin_m], axis=1)
    return (window * basis)[:, None, :]            # (W, I=1, O=2*n_freqs)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sample_rate: int = SAMPLE_RATE, n_fft: int = N_FFT,
                   n_mels: int = N_MELS) -> np.ndarray:
    """(n_mels, n_fft//2 + 1) triangular slaney-style filterbank."""
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sample_rate / 2, n_freqs)
    mel_points = np.linspace(_hz_to_mel(0.0), _hz_to_mel(sample_rate / 2),
                             n_mels + 2)
    hz_points = _mel_to_hz(mel_points)
    bank = np.zeros((n_mels, n_freqs), np.float32)
    for index in range(n_mels):
        lower, center, upper = hz_points[index:index + 3]
        up_slope = (fft_freqs - lower) / max(center - lower, 1e-10)
        down_slope = (upper - fft_freqs) / max(upper - center, 1e-10)
        bank[index] = np.maximum(0.0, np.minimum(up_slope, down_slope))
        # slaney area normalization
        enorm = 2.0 / (upper - lower)
        bank[index] *= enorm
    return bank


def _set_cudnn_tf32(allow) -> None:
    torch.backends.cudnn.allow_tf32 = allow


# cuDNN float32 convolutions in full float32 (TF32 off) for the duration
# of a scope; the flag is process-wide, so the scopes of all threads
# share one count (device.counted_flags)
full_f32_convolution = counted_flags(
    lambda: torch.backends.cudnn.allow_tf32, _set_cudnn_tf32, False)


def log_mel_spectrogram(waveform, sample_rate: int = SAMPLE_RATE,
                        n_fft: int = N_FFT, hop_length: int = HOP_LENGTH,
                        n_mels: int = N_MELS):
    """waveform (..., samples) f32 tensor -> log-mel (..., n_mels, frames)
    on the waveform's device.

    Whisper-style: hann window, magnitude^2, mel projection, log10 clamped
    to 8 decades below each example's peak, scaled to roughly [-1, 1].
    """
    waveform = torch.as_tensor(waveform, dtype=torch.float32)
    device = waveform.device
    pad = n_fft // 2
    lead_shape = waveform.shape[:-1]
    # reflect padding (numpy's "reflect": the edge sample is not repeated)
    padded = F.pad(waveform.reshape(-1, 1, waveform.shape[-1]), (pad, pad),
                   mode="reflect")
    weight = torch.from_numpy(
        np.ascontiguousarray(_stft_kernel(n_fft).transpose(2, 1, 0))).to(
            device)                                # (O, I=1, W)
    with full_f32_convolution():
        spectrum = F.conv1d(padded, weight, stride=hop_length)  # (N, O, T)
    n_freqs = n_fft // 2 + 1
    real, imag = spectrum[:, :n_freqs], spectrum[:, n_freqs:]
    power = real * real + imag * imag                           # (N, F, T)
    power = power.reshape(lead_shape + power.shape[1:])
    bank = torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels)).to(
        device)
    mel = torch.einsum("...ft,mf->...mt", power, bank)
    log_mel = torch.log10(torch.clamp(mel, min=1e-10))
    log_mel = torch.maximum(
        log_mel, torch.amax(log_mel, dim=(-2, -1), keepdim=True) - 8.0)
    return (log_mel + 4.0) / 4.0
