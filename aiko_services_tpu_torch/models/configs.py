# Reference-scale model configurations: the LM, Whisper and detector
# presets.
#
# Counterpart of aiko_services_tpu/models/configs.py.  Llama shapes from
# the reference's LLM seat (Llama-3-8B via Ollama) and the Llama-3.2-1B
# architecture; Whisper ladder shapes (reference speech_elements.py:186-192:
# tiny 39M ... small 244M); multilingual vocab 51865.  Special token ids
# keep the AsrConfig defaults (sot 1 / eot 2) so natively trained
# checkpoints decode unchanged.

from __future__ import annotations

from .asr import AsrConfig
from .detector import DetectorConfig
from .transformer import TransformerConfig

__all__ = ["LLAMA3_8B", "LLAMA32_1B", "LM_TOY", "WHISPER_TINY",
           "WHISPER_SMALL", "YOLOV8N_SHAPE", "DETECTOR_TOY",
           "transformer_flops_per_token", "asr_flops_per_example",
           "detector_flops_per_image", "tts_flops_per_example"]

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

# YOLOv8-n operating shape: 640x640 input, 80 classes (reference
# yolo.py:51-87 runs YOLOv8 on webcam frames)
YOLOV8N_SHAPE = DetectorConfig(
    n_classes=80, base_channels=16, image_size=640, stride=16,
    max_detections=300, score_threshold=0.25, dtype="bfloat16")

DETECTOR_TOY = DetectorConfig(
    n_classes=16, base_channels=8, image_size=64, max_detections=8,
    dtype="float32")


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


def tts_flops_per_example(config, n_chars: int) -> float:
    """chars -> waveform FLOPs: the conv stack over the upsampled frames,
    the mel head and Griffin-Lim's STFT/ISTFT pair per iteration as DFT
    matmuls (tts.synthesize)."""
    frames = n_chars * config.frames_per_char
    d = config.d_model
    conv = config.n_conv_layers * 2 * config.kernel_size * d * d * frames
    mel_head = 2 * d * config.n_mels * frames
    bins = config.n_fft // 2 + 1
    griffin = (config.griffin_lim_iters
               * 2 * 2 * frames * config.n_fft * bins)
    return conv + mel_head + griffin


def detector_flops_per_image(config: DetectorConfig) -> float:
    """Conv backbone FLOPs: 2 * k*k * C_in * C_out * H_out * W_out summed
    over the backbone's 7 3x3 conv stages + the 1x1 head
    (detector.init_detector_params)."""
    c = config.base_channels
    size = config.image_size
    stages = [  # (c_in, c_out, stride) mirroring init_detector_params
        (3, c, 2), (c, c * 2, 2), (c * 2, c * 2, 1), (c * 2, c * 4, 2),
        (c * 4, c * 4, 1), (c * 4, c * 8, 2), (c * 8, c * 8, 1),
    ]
    total = 0.0
    h = size
    for c_in, c_out, stride in stages:
        h = h // stride
        total += 2 * 9 * c_in * c_out * h * h
    total += 2 * 1 * (c * 8) * (5 + config.n_classes) * h * h  # 1x1 head
    return total
