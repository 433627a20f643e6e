# Text-to-speech: characters -> mel -> Griffin-Lim -> waveform.
#
# Counterpart of aiko_services_tpu/models/tts.py: byte-level characters,
# an embedding, static-duration upsampling (frames_per_char) with a sine
# phase feature, a stack of residual 1-D convolutions, a mel head, the
# mel-to-linear projection through the filterbank's pseudo-inverse (the
# same numpy constant as there) and Griffin-Lim phase recovery with the
# STFT and its inverse as real DFT matmuls.  Same parameter tree (the
# convolutions stacked on a leading axis), run eagerly on the device the
# tensors lie on: the JAX package's lax.fori_loop of round trips is a
# Python loop here.  The JAX package runs its DFT products at
# Precision.HIGHEST; here they are float32 matmuls, which PyTorch keeps
# out of TF32 unless a caller allows it, and the float32 convolutions run
# with cuDNN's TF32 switched off (full_f32_convolution).  No Pallas
# kernel there, none here.

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.audio import dft_basis, full_f32_convolution, mel_filterbank
from ..ops.device import resolve_device
from .layers import dense, init_dense
from .optim import apply_updates, value_and_grad

__all__ = ["TTSConfig", "init_tts_params", "synthesize_mel", "griffin_lim",
           "synthesize", "encode_chars", "make_tts_train_step"]


@dataclass(frozen=True)
class TTSConfig:
    vocab_size: int = 256          # byte-level characters
    d_model: int = 256
    n_conv_layers: int = 4
    kernel_size: int = 5
    n_mels: int = 80
    sample_rate: int = 16000
    n_fft: int = 400
    hop: int = 200                 # 12.5 ms
    frames_per_char: int = 6       # ~75 ms per character
    griffin_lim_iters: int = 30
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def encode_chars(text: str, max_len: int | None = None) -> np.ndarray:
    """Byte-level character ids (1, L) int32; optionally padded/truncated
    to max_len with zeros (id 0 = padding/silence)."""
    ids = np.frombuffer(text.encode("utf-8", "replace"),
                        np.uint8).astype(np.int32)
    if max_len is not None:
        ids = ids[:max_len]
        ids = np.pad(ids, (0, max_len - len(ids)))
    return ids[None]


def init_tts_params(config: TTSConfig, generator: torch.Generator,
                    device="cuda") -> dict:
    """Random parameters drawn on the CPU from `generator` (the JAX
    package's distributions, not its numbers: embedding N(0, 0.02^2),
    conv weights N(0, 1/(d_model * kernel_size)), zero biases), stacked
    convolutions (n_conv_layers, kernel, d_model, d_model), cast to
    config.dtype and placed on `device`."""
    device = resolve_device(device)
    dtype = config.torch_dtype
    d = config.d_model
    embed = torch.randn((config.vocab_size, d), generator=generator) * 0.02
    conv_w = torch.randn(
        (config.n_conv_layers, config.kernel_size, d, d),
        generator=generator) / np.sqrt(d * config.kernel_size)
    return {
        "embed": {"w": embed.to(device=device, dtype=dtype)},
        "convs": {"w": conv_w.to(device=device, dtype=dtype),
                  "b": torch.zeros((config.n_conv_layers, d), dtype=dtype,
                                   device=device)},
        "mel_out": init_dense(generator, d, config.n_mels, dtype,
                              device=device),
    }


def _conv1d_same(h, weight):
    """h (B, T, C) NWC, weight (K, I, O) WIO, stride 1, "SAME" (K odd:
    (K - 1) / 2 on each side) -> (B, T, O)."""
    out_weight = weight.permute(2, 1, 0)                     # -> OIK
    pad = (weight.shape[0] - 1) // 2
    x = h.transpose(1, 2)
    if h.dtype == torch.float32:
        with full_f32_convolution():
            out = F.conv1d(x, out_weight, padding=pad)
    else:
        out = F.conv1d(x, out_weight, padding=pad)
    return out.transpose(1, 2)


def synthesize_mel(params: dict, config: TTSConfig, chars):
    """chars (B, L) int -> mel (B, n_mels, L * frames_per_char)."""
    table = params["embed"]["w"]
    h = table[chars.long().clamp(0, table.shape[0] - 1)]      # (B, L, D)
    h = torch.repeat_interleave(h, config.frames_per_char, dim=1)
    # position-within-char phase feature
    phase = (torch.arange(config.frames_per_char, dtype=torch.float32,
                          device=h.device)
             / config.frames_per_char).repeat(chars.shape[1])
    h = h + torch.sin(2 * math.pi * phase)[None, :, None].to(h.dtype)
    for weight, bias in zip(params["convs"]["w"], params["convs"]["b"]):
        h = h + torch.tanh(_conv1d_same(h, weight) + bias)   # residual
    mel = dense(params["mel_out"], h)                        # (B, T, n_mels)
    return mel.transpose(1, 2)


def _frame(signal, n_fft: int, hop: int):
    """(B, S) -> (B, frames, n_fft) windows at hop offsets, frames = 1 +
    (S - n_fft) // hop (a strided view)."""
    return signal.unfold(-1, n_fft, hop)


def _dft_matrices(n_fft: int, device):
    """The rfft's real matmul bases (cos, -sin), each (n_fft, bins)."""
    cos_m, sin_m = dft_basis(n_fft)
    return (torch.from_numpy(cos_m).to(device),
            torch.from_numpy(sin_m).to(device))


def _irfft_weights(n_fft: int, device):
    """Hermitian bin weights of the real inverse over n_fft: DC and
    Nyquist count once, interior bins twice."""
    bins = n_fft // 2 + 1
    weights = np.full((bins,), 2.0, np.float32)
    weights[0] = 1.0
    if n_fft % 2 == 0:
        weights[-1] = 1.0
    return torch.from_numpy(weights / n_fft).to(device)


def _stft_ri(signal, n_fft: int, hop: int, window, cos_m, sin_m):
    """(B, S) -> (real, imag) each (B, frames, bins), as f32 matmuls."""
    frames = _frame(signal, n_fft, hop) * window
    return frames @ cos_m, frames @ sin_m


def _window_norm(window_np: np.ndarray, hop: int, n_frames: int,
                 length: int, device):
    """Overlap-add normalization for the window: a numpy constant of the
    window and the shapes."""
    n_fft = window_np.shape[0]
    window_sq = np.asarray(window_np, np.float32) ** 2
    total = np.zeros((length,), np.float32)
    for frame in range(n_frames):
        total[frame * hop:frame * hop + n_fft] += window_sq
    return torch.from_numpy(np.maximum(total, 1e-8)).to(device)


def _overlap_add(frames, n_fft: int, hop: int, length: int):
    """(B, F, n_fft) windowed frames -> (B, length), each frame added at
    its hop offset (F.fold sums the overlaps)."""
    batch, n_frames, _ = frames.shape
    span = (n_frames - 1) * hop + n_fft
    signal = F.fold(frames.transpose(1, 2), output_size=(1, span),
                    kernel_size=(1, n_fft), stride=(1, hop))
    return signal.reshape(batch, span)[:, :length]


def _istft_ri(real, imag, n_fft: int, hop: int, window, length: int,
              cos_m, sin_m, weights, norm):
    """Inverse of _stft_ri plus the windowed overlap-add, divided by the
    window normalization `norm` (_window_norm of the same window):
    x[n] = sum_k w_k (real_k cos - imag_k sin)(angle)."""
    frames = ((real * weights) @ cos_m.T
              + (imag * weights) @ sin_m.T) * window
    return _overlap_add(frames, n_fft, hop, length) / norm[None, :]


def griffin_lim(magnitude, config: TTSConfig):
    """Phase recovery: magnitude (B, n_fft//2+1, T) f32 -> waveform (B,
    S): griffin_lim_iters ISTFT/STFT round trips from zero phase, the
    phase carried as a real angle."""
    n_fft, hop = config.n_fft, config.hop
    device = magnitude.device
    magnitude = magnitude.transpose(1, 2)                    # (B, T, bins)
    frames = magnitude.shape[1]
    length = (frames - 1) * hop + n_fft
    window_np = np.hanning(n_fft).astype(np.float32)
    window = torch.from_numpy(window_np).to(device)
    cos_m, sin_m = _dft_matrices(n_fft, device)
    weights = _irfft_weights(n_fft, device)
    norm = _window_norm(window_np, hop, frames, length, device)
    angles = torch.zeros_like(magnitude)

    def inverse(angles):
        return _istft_ri(magnitude * torch.cos(angles),
                         magnitude * torch.sin(angles), n_fft, hop, window,
                         length, cos_m, sin_m, weights, norm)

    for _ in range(config.griffin_lim_iters):
        real, imag = _stft_ri(inverse(angles), n_fft, hop, window, cos_m,
                              sin_m)
        # atan2 at signed zeros as jnp.arctan2: atan2(+-0, x < 0) = +-pi
        angles = torch.atan2(imag, real)
    return inverse(angles)


def make_tts_train_step(config: TTSConfig, optimizer):
    """Returns train_step(params, opt_state, chars, target_mel) ->
    (params, opt_state, loss): the f32 mel-regression MSE through the
    synthesis net.  The update is written into params and opt_state in
    place (the JAX step donates both)."""

    def loss_fn(params, chars, target_mel):
        mel = synthesize_mel(params, config, chars)
        return torch.mean((mel.float() - target_mel.float()) ** 2)

    def train_step(params, opt_state, chars, target_mel):
        loss, grads = value_and_grad(loss_fn, params, chars, target_mel)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        del grads
        apply_updates(params, updates)
        return params, opt_state, loss

    return train_step


@torch.no_grad()
def synthesize(params: dict, config: TTSConfig, chars):
    """chars (B, L) int -> waveform (B, S) f32 in [-1, 1]: mel, the
    filterbank's pseudo-inverse (a numpy constant), magnitude,
    Griffin-Lim, peak normalization."""
    mel = synthesize_mel(params, config, chars)
    filterbank = mel_filterbank(sample_rate=config.sample_rate,
                                n_fft=config.n_fft, n_mels=config.n_mels)
    inverse = torch.from_numpy(np.linalg.pinv(np.asarray(filterbank)).astype(
        np.float32)).to(mel.device)                          # (bins, n_mels)
    energy = torch.exp(mel.float())                          # log-mel -> mel
    linear = torch.clamp_min(torch.einsum("bmt,fm->bft", energy, inverse),
                             0.0)
    waveform = griffin_lim(torch.sqrt(linear + 1e-8), config)
    peak = torch.amax(torch.abs(waveform), dim=-1, keepdim=True)
    return (waveform / torch.clamp_min(peak, 1e-6)).float()
