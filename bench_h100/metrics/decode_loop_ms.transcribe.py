"""The speech element's greedy decode loop, device milliseconds per
coalesced group: the mean over the window's asr.decode program spans
(models/asr.py transcribe: every max_tokens step, its cached self- and
cross-attention, projections and head), timed by CUDA events."""

from bench_h100.metrics._spans import mean_device_ms


def read(record):
    return mean_device_ms(record, "asr.decode")
