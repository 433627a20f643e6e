"""The decode engine's captured decode step, device milliseconds: the
mean over the window's engine.decode program spans (decode/engine.py
_plain_step, from building the write rows to reading the tokens back),
timed by CUDA events on the engine's stream."""

from bench_h100.metrics._spans import mean_device_ms


def read(record):
    return mean_device_ms(record, "engine.decode")
