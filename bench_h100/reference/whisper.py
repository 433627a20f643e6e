"""Plain Whisper-style speech recognizer in float32.

The model the port serves (models/asr.py's description): a log-mel front
end (Hann window of 400 samples, hop 160, reflect padding, power
spectrum, 80 triangular mel filters on the 2595 log10(1 + f/700) scale
with area normalization, log10 clamped at 1e-10 and at 8 decades below
each example's peak, then (x + 4) / 4); a stem of two width-3
convolutions (stride 1, then 2, "same" padding with the lower half
first) with tanh GELUs; audio positions added; pre-norm encoder layers
(layer norm without bias, eps 1e-5; attention without biases; a GELU
MLP); a final norm.  The decoder: token and learned positions, causal
self-attention, cross-attention over the encoder's output, the MLP, a
final norm, logits against the token table.  Weights arrive as the
benchmark's tree (the program's layout); every product runs in f32."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import matmul

N_FFT, HOP = 400, 160


def mel_filters(sample_rate: int, n_fft: int, n_mels: int) -> np.ndarray:
    """(n_mels, n_fft // 2 + 1) triangles between n_mels + 2 points
    spaced evenly on the 2595 log10(1 + f / 700) scale, each scaled by
    2 / (its upper edge - its lower edge)."""
    freqs = np.linspace(0.0, sample_rate / 2, n_fft // 2 + 1)
    top = 2595.0 * math.log10(1.0 + (sample_rate / 2) / 700.0)
    edges = 700.0 * (10.0 ** (np.linspace(0.0, top, n_mels + 2) / 2595.0)
                     - 1.0)
    bank = np.zeros((n_mels, freqs.size), np.float64)
    for m in range(n_mels):
        low, mid, high = edges[m], edges[m + 1], edges[m + 2]
        rising = (freqs - low) / max(mid - low, 1e-10)
        falling = (high - freqs) / max(high - mid, 1e-10)
        bank[m] = np.clip(np.minimum(rising, falling), 0.0, None) \
            * 2.0 / (high - low)
    return bank.astype(np.float32)


def log_mel(audio: torch.Tensor, n_mels: int, sample_rate: int = 16000):
    """audio (B, samples) f32 -> (B, n_mels, samples // 160 + 1)."""
    window = torch.hann_window(N_FFT, periodic=False, dtype=torch.float64,
                               device=audio.device).float()
    spectrum = torch.stft(audio.float(), N_FFT, HOP, window=window,
                          center=True, pad_mode="reflect",
                          return_complex=True)
    power = spectrum.real ** 2 + spectrum.imag ** 2      # (B, bins, T)
    bank = torch.from_numpy(mel_filters(sample_rate, N_FFT, n_mels)).to(
        audio.device)
    mel = torch.einsum("mf,bft->bmt", bank, power)
    logged = torch.log10(mel.clamp(min=1e-10))
    peak = logged.amax(dim=(1, 2), keepdim=True)
    return (torch.maximum(logged, peak - 8.0) + 4.0) / 4.0


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _norm(scale, x, eps: float = 1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale.float()


def _conv(w, b, x, stride: int, precision):
    """x (B, T, C_in), w (C_out, C_in, 3): 'same' padding, lower half
    first, as a matmul over the three taps."""
    length = x.shape[1]
    out_len = -(-length // stride)
    total = max((out_len - 1) * stride + 3 - length, 0)
    padded = F.pad(x, (0, 0, total // 2, total - total // 2))
    taps = torch.stack([padded[:, tap:tap + stride * (out_len - 1) + 1:
                               stride] for tap in range(3)], dim=2)
    weight = w.float().permute(2, 1, 0).reshape(3 * w.shape[1], w.shape[0])
    return matmul(taps.reshape(x.shape[0], out_len, -1), weight,
                  precision) + b.float()


def _heads(x, n_heads: int):
    batch, length, width = x.shape
    return x.view(batch, length, n_heads, width // n_heads).transpose(1, 2)


def _attention(weights: dict, x, memory, n_heads: int, causal: bool,
               precision):
    q = _heads(matmul(x, weights["wq"]["w"], precision), n_heads)
    k = _heads(matmul(memory, weights["wk"]["w"], precision), n_heads)
    v = _heads(matmul(memory, weights["wv"]["w"], precision), n_heads)
    scores = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if causal:
        length = scores.shape[-1]
        mask = torch.ones(length, length, dtype=torch.bool,
                          device=x.device).triu(1)
        scores = scores.masked_fill(mask, float("-inf"))
    out = torch.softmax(scores, dim=-1) @ v
    merged = out.transpose(1, 2).reshape(x.shape[0], x.shape[1], -1)
    return matmul(merged, weights["wo"]["w"], precision)


def _layer(stacked: dict, index: int) -> dict:
    if isinstance(stacked, dict):
        return {key: _layer(value, index) for key, value in stacked.items()}
    return stacked[index]


def _mlp(mlp: dict, x, precision):
    return matmul(_gelu(matmul(x, mlp["w1"]["w"], precision)),
                  mlp["w2"]["w"], precision)


def encode(params: dict, config: dict, mel, precision=None):
    """mel (B, n_mels, T) -> the encoder's output (B, frames, d)."""
    heads = config["encoder_attention_heads"]
    x = mel.float().transpose(1, 2)
    x = _gelu(_conv(params["conv1"]["w"], params["conv1"]["b"], x, 1,
                    precision))
    x = _gelu(_conv(params["conv2"]["w"], params["conv2"]["b"], x, 2,
                    precision))
    x = x[:, :config["max_source_positions"]]
    x = x + params["enc_positions"][:x.shape[1]].float()
    for index in range(config["encoder_layers"]):
        layer = _layer(params["enc_layers"], index)
        normed = _norm(layer["attn_norm"]["scale"], x)
        x = x + _attention(layer["attn"], normed, normed, heads, False,
                           precision)
        x = x + _mlp(layer["mlp"], _norm(layer["mlp_norm"]["scale"], x),
                     precision)
    return _norm(params["enc_norm"]["scale"], x)


def decoder_logits(params: dict, config: dict, tokens, memory,
                   precision=None):
    """tokens (B, T) + the encoder's output -> logits (B, T, vocab) f32,
    each position attending to itself and the positions before it."""
    heads = config["decoder_attention_heads"]
    table = params["token_embed"]["w"]
    h = table[tokens.long()].float() \
        + params["dec_positions"][:tokens.shape[1]].float()
    for index in range(config["decoder_layers"]):
        layer = _layer(params["dec_layers"], index)
        normed = _norm(layer["self_norm"]["scale"], h)
        h = h + _attention(layer["self"], normed, normed, heads, True,
                           precision)
        h = h + _attention(layer["cross"],
                           _norm(layer["cross_norm"]["scale"], h), memory,
                           heads, False, precision)
        h = h + _mlp(layer["mlp"], _norm(layer["mlp_norm"]["scale"], h),
                     precision)
    h = _norm(params["dec_norm"]["scale"], h)
    return matmul(h, table.t(), precision)
