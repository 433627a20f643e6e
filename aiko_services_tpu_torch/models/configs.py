# Reference-scale model configurations: the Whisper presets.
#
# Counterpart of aiko_services_tpu/models/configs.py (the ASR part; the
# LM and detector presets come with their models).  Whisper ladder shapes
# (reference speech_elements.py:186-192: tiny 39M ... small 244M);
# multilingual vocab 51865.  Special token ids keep the AsrConfig defaults
# (sot 1 / eot 2) so natively trained checkpoints decode unchanged.

from __future__ import annotations

from .asr import AsrConfig

__all__ = ["WHISPER_TINY", "WHISPER_SMALL", "asr_flops_per_example"]

WHISPER_TINY = AsrConfig(
    n_mels=80, d_model=384, enc_layers=4, dec_layers=4, n_heads=6,
    vocab_size=51865, max_frames=1500, max_text_len=448, dtype="bfloat16")

WHISPER_SMALL = AsrConfig(
    n_mels=80, d_model=768, enc_layers=12, dec_layers=12, n_heads=12,
    vocab_size=51865, max_frames=1500, max_text_len=448, dtype="bfloat16")


def asr_flops_per_example(config: AsrConfig, n_frames: int,
                          n_tokens: int) -> float:
    """Encoder over n_frames mel positions + decoder over n_tokens with
    cross-attention; 2*weight-size per matmul, plus attention terms."""
    d = config.d_model
    attn = 8 * d * d
    mlp = 2 * d * (4 * d) * 2
    enc_layer = (attn + mlp) * n_frames + 4 * n_frames * n_frames * d
    dec_layer = ((2 * attn + mlp) * n_tokens
                 + 4 * n_tokens * n_tokens * d
                 + 4 * n_tokens * n_frames * d)
    head = 2 * d * config.vocab_size * n_tokens
    return (config.enc_layers * enc_layer
            + config.dec_layers * dec_layer + head)
