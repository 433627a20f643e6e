# Reference-scale model configurations: the LM and Whisper presets.
#
# Counterpart of aiko_services_tpu/models/configs.py (the LM and ASR
# parts; the detector presets come with the detector).  Llama shapes from
# the reference's LLM seat (Llama-3-8B via Ollama) and the Llama-3.2-1B
# architecture; Whisper ladder shapes (reference speech_elements.py:186-192:
# tiny 39M ... small 244M); multilingual vocab 51865.  Special token ids
# keep the AsrConfig defaults (sot 1 / eot 2) so natively trained
# checkpoints decode unchanged.

from __future__ import annotations

from .asr import AsrConfig
from .transformer import TransformerConfig

__all__ = ["LLAMA3_8B", "LLAMA32_1B", "LM_TOY", "WHISPER_TINY",
           "WHISPER_SMALL", "transformer_flops_per_token",
           "asr_flops_per_example"]

# Llama-3-8B architecture
LLAMA3_8B = TransformerConfig(
    vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
    n_kv_heads=8, d_ff=14336, max_seq_len=8192, rope_theta=500000.0,
    dtype="bfloat16")

# Llama-3.2-1B architecture (tied embeddings)
LLAMA32_1B = TransformerConfig(
    vocab_size=128256, d_model=2048, n_layers=16, n_heads=32,
    n_kv_heads=8, d_ff=8192, max_seq_len=8192, rope_theta=500000.0,
    dtype="bfloat16")

# small config for hermetic tests / CPU runs
LM_TOY = TransformerConfig(
    vocab_size=4096, d_model=256, n_layers=4, n_heads=8, n_kv_heads=4,
    d_ff=768, max_seq_len=512, dtype="float32")

WHISPER_TINY = AsrConfig(
    n_mels=80, d_model=384, enc_layers=4, dec_layers=4, n_heads=6,
    vocab_size=51865, max_frames=1500, max_text_len=448, dtype="bfloat16")

WHISPER_SMALL = AsrConfig(
    n_mels=80, d_model=768, enc_layers=12, dec_layers=12, n_heads=12,
    vocab_size=51865, max_frames=1500, max_text_len=448, dtype="bfloat16")


def transformer_flops_per_token(config: TransformerConfig,
                                seq_len: int | None = None) -> float:
    """Forward FLOPs per token: 2*params for the matmuls plus the
    attention score/value terms (2 * 2 * L * d per token when seq_len is
    given -- the quadratic part)."""
    d, ff = config.d_model, config.d_ff
    hd = config.head_dim
    attn_proj = 2 * d * (config.n_heads * hd          # wq
                         + 2 * config.n_kv_heads * hd  # wk, wv
                         + config.n_heads * hd)        # wo
    mlp = 2 * d * ff * 3                               # gate, up, down
    per_layer = attn_proj + mlp
    if seq_len:
        per_layer += 2 * 2 * seq_len * d               # qk^T and att@v
    head = 2 * d * config.vocab_size                   # logits
    return config.n_layers * per_layer + head


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
