"""Frame latency, 95th percentile: create_frame to the response on the
stream's queue, over every frame of the window (host clock)."""

from bench_h100.metrics._shared import p95_ms


def read(record):
    return p95_ms(record.get("frame_latency_s"))
