"""The yardstick's arithmetic: published peaks, the operations and bytes
of each hand-written kernel, and the FLOPs of a whole step.  Kept here,
apart from the program, so that a change to the program cannot change
how it is measured."""

from __future__ import annotations

# NVIDIA H100 SXM5 data sheet, dense rates without sparsity, at the full
# 700 W power limit.  A card with a lower power.limit runs slower under
# load; run.py prints the limit beside every result.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def visible_pairs(q_len: int, k_len: int, causal: bool,
                  q_offset: int = 0) -> int:
    """(query, key) pairs the mask keeps: the work a causal kernel must
    do for these inputs."""
    if not causal:
        return q_len * k_len
    diagonal = q_offset + k_len - q_len
    return int(sum(min(k_len, max(0, row + diagonal + 1))
                   for row in range(q_len)))


def bound_seconds(moved: int, operations: int) -> float:
    """The least time the card could take: each input read once and each
    output written once at the memory rate, or the operations at the
    bf16 peak, whichever is longer."""
    return max(moved / PEAK_BYTES, operations / PEAK_BF16_FLOPS)


def attention_forward_cost(heads: int, q_len: int, k_len: int, dim: int,
                           causal: bool, element_bytes: int = 2) -> tuple:
    """(bytes, operations) of one forward attention launch over `heads`
    (batch x heads) independent problems: q, k, v read and o written in
    the element type, the f32 logsumexp written; QK^T and PV over the
    visible pairs."""
    pairs = visible_pairs(q_len, k_len, causal)
    moved = heads * ((2 * q_len + 2 * k_len) * dim * element_bytes
                     + q_len * 4)
    return moved, heads * pairs * dim * 4


def whisper_transcribe_flops(config: dict, rows: int, frames: int,
                             samples: int, tokens: int) -> int:
    """FLOPs of one greedy transcription of `rows` windows: the STFT
    (a real DFT per frame), the mel projection, the two stem
    convolutions, the encoder over `frames` positions (non-causal), the
    cross-attention K/V once, and `tokens` cached decode steps, each
    attending to the positions written so far and to the encoder's
    output, with the head over the vocabulary."""
    d = config["d_model"]
    mels = config["num_mel_bins"]
    ff = config["encoder_ffn_dim"]
    dec_ff = config["decoder_ffn_dim"]
    vocab = config["vocab_size"]
    enc_layers = config["encoder_layers"]
    dec_layers = config["decoder_layers"]
    n_fft, hop = 400, 160
    stft_frames = samples // hop + 1
    bins = n_fft // 2 + 1
    front = stft_frames * (2 * n_fft * 2 * bins + 2 * bins * mels)
    stem = 2 * stft_frames * 3 * mels * d + 2 * frames * 3 * d * d
    encoder = enc_layers * (2 * frames * 4 * d * d + 4 * frames * frames * d
                            + 2 * frames * 2 * d * ff)
    cross_kv = dec_layers * 2 * frames * 2 * d * d
    per_step = 0
    for index in range(tokens):
        per_step += dec_layers * (
            2 * 4 * d * d                       # self q, k, v, o
            + 4 * (index + 1) * d               # self attention
            + 2 * 2 * d * d                     # cross q, o
            + 4 * frames * d                    # cross attention
            + 2 * 2 * d * dec_ff)               # MLP
        per_step += 2 * d * vocab               # the head
    return rows * (front + stem + encoder + cross_kv + per_step)
