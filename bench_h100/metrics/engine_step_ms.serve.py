"""Milliseconds per engine step: the benchmark's span around each
DecodeEngine.step() that ended in the window, their total over their
count (host clock)."""


def read(record):
    steps = record.get("step_s")
    if not steps:
        return None
    return 1e3 * sum(steps) / len(steps)
