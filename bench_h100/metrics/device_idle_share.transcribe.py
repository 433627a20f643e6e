"""Per cent of the traced window in which the card ran no kernel, copy or
set (one minus the union of their intervals)."""

from bench_h100.metrics._shared import idle_share


def read(record):
    return idle_share(record)
