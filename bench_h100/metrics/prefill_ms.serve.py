"""The decode engine's monolithic prefill, device milliseconds per
request: the mean over the window's engine.prefill program spans
(decode/engine.py _admit: paged_prefill through the first token's
readback), timed by CUDA events on the engine's stream."""

from bench_h100.metrics._spans import mean_device_ms


def read(record):
    return mean_device_ms(record, "engine.prefill")
