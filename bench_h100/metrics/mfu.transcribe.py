"""The transcription's share of the card's bf16 peak: the FLOPs
of every window completed (front end, stem, encoder, cross K/V, the
decode steps over the positions written so far, the head) over the
window."""

from bench_h100.metrics._shared import mfu


def read(record):
    return mfu(record)
