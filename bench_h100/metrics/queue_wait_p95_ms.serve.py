"""Admission wait, 95th percentile: from when each of the window's
requests was due to the start of the engine step that admitted it (the
step that returned its first token: prefill is monolithic), host
clock."""

from bench_h100.metrics._shared import p95_ms


def read(record):
    return p95_ms(record.get("queue_wait_s"))
