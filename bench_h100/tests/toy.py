"""Toy cells for the CPU tests: test-only configuration, traffic and
cell files written into a directory, beside a benchmark dictionary that
names them.  No toy file is a cell of BENCHMARK.json."""

from __future__ import annotations

import json
from pathlib import Path

WHISPER = {
    "source": "test-only", "model_type": "whisper", "d_model": 64,
    "encoder_layers": 2, "decoder_layers": 2,
    "encoder_attention_heads": 4, "decoder_attention_heads": 4,
    "encoder_ffn_dim": 256, "decoder_ffn_dim": 256, "num_mel_bins": 80,
    "vocab_size": 512, "max_source_positions": 100,
    "max_target_positions": 32, "torch_dtype": "float32", "reduced": [],
    "assumed": {"sample_rate": 16000, "sot_token": 1, "eot_token": 2}}
DECODER = {
    "source": "test-only", "model_type": "mistral", "hidden_size": 64,
    "intermediate_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
    "vocab_size": 256, "max_position_embeddings": 512,
    "rope_theta": 10000.0, "rms_norm_eps": 1e-5, "sliding_window": None,
    "tie_word_embeddings": False, "torch_dtype": "float32", "reduced": []}
TONES = {"generator": "closed_loop_audio", "streams": 4, "rows": 2,
         "seconds_audio": 2.0, "sample_rate": 16000, "pool_frames": 3,
         "tones_per_row": 2, "freq_hz": [200.0, 2000.0], "noise": 0.01}
CHAT = {"generator": "open_loop", "rate_per_s": 12.0, "shape_seed": 5,
        "prompt_tokens": {"median": 24, "sigma": 0.8, "min": 4, "max": 60},
        "output_tokens": {"median": 8, "sigma": 0.5, "min": 2, "max": 12}}
SPEECH_CELL = {"driver": "pipeline_speech", "max_tokens": 6,
               "micro_batch": 2, "micro_batch_wait_ms": 60000,
               "check_rows": 8, "check_block": 4, "max_logit_gap": 1e-3}
ENGINE_CELL = {"driver": "engine_open_loop", "decode_slots": 4,
               "kv_block_size": 8, "max_context": 80, "resident_requests": 2,
               "check_tokens": 80,
               "mean_logit_gap": 1e-5}
BENCHMARK = {
    "workloads": [
        {"name": "toy_whisper.tones", "config": "toy_whisper",
         "traffic": "toy_tones", "chips": 1},
        {"name": "toy_decoder.chat", "config": "toy_decoder",
         "traffic": "toy_chat", "chips": 1}],
    "end_to_end": [
        {"name": "audio_s_per_s", "unit": "s/s",
         "workloads": ["toy_whisper.tones"]},
        {"name": "ttft_p95_ms", "unit": "ms",
         "workloads": ["toy_decoder.chat"]},
        {"name": "itl_p90_ms", "unit": "ms",
         "workloads": ["toy_decoder.chat"]},
        {"name": "setup_s", "unit": "s"}],
    "per_layer": [
        {"name": "frame_latency_p95_ms.transcribe", "unit": "ms",
         "moves": "audio_s_per_s", "workloads": ["toy_whisper.tones"]},
        {"name": "mfu.transcribe", "unit": "%", "moves": "audio_s_per_s",
         "workloads": ["toy_whisper.tones"]},
        {"name": "engine_step_ms.serve", "unit": "ms",
         "moves": "itl_p90_ms", "workloads": ["toy_decoder.chat"]},
        {"name": "queue_wait_p95_ms.serve", "unit": "ms",
         "moves": "ttft_p95_ms", "workloads": ["toy_decoder.chat"]}]}


def write(directory: Path) -> dict:
    """The toy files under `directory`; returns the benchmark dict."""
    files = {
        "configs/toy_whisper.json": WHISPER,
        "configs/toy_decoder.json": DECODER,
        "traffic/toy_tones.json": TONES,
        "traffic/toy_chat.json": CHAT,
        "workloads/toy_whisper.tones.json": SPEECH_CELL,
        "workloads/toy_decoder.chat.json": ENGINE_CELL}
    for name, content in files.items():
        path = Path(directory) / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(content))
    return json.loads(json.dumps(BENCHMARK))
