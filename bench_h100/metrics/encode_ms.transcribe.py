"""The speech element's encoder, device milliseconds per coalesced group:
the mean over the window's asr.encode program spans (models/asr.py
encode_audio: the stem and the encoder layers, K1 among them), timed by
CUDA events on the pipeline thread's stream."""

from bench_h100.metrics._spans import mean_device_ms


def read(record):
    return mean_device_ms(record, "asr.encode")
