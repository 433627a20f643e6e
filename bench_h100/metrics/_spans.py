"""Arithmetic the readers of the port's program spans share (this file
names no metric).

The port records program spans (aiko_services_tpu_torch/observe/trace.py,
the process-wide tracer PROGRAM) while a torch.profiler records, so once
a traced window has closed the recorder holds that window's spans: the
speech element's asr.* phases, the decode engine's engine.* spans and
its queue:engine intervals, each with perf_counter start and end and,
for a device span, the device milliseconds of its CUDA events.
`window_spans(record)` takes them once per run -- from
record["program_spans"] where the cell's `drivers/` module put them,
else from the recorder: the spans that end after the previous run's
harvest in this process -- and keeps them in the record for the run's
other readers.
A program without the recorder gives None, and so does every reader."""

from __future__ import annotations

import time

_harvested_at = None      # perf_counter of this process's last harvest


def window_spans(record: dict) -> list | None:
    """The traced window's program spans (ProgramSpan dicts), or None
    where the program records none."""
    global _harvested_at
    if "program_spans" in record:
        return record["program_spans"]
    try:
        from aiko_services_tpu_torch.observe import trace
    except ImportError:
        return None
    tracer = getattr(trace, "PROGRAM", None)
    if tracer is None:
        return None
    harvest = time.perf_counter()
    spans = tracer.collect(since=_harvested_at)
    _harvested_at = harvest
    record["program_spans"] = spans
    return spans


def mean_device_ms(record: dict, name: str) -> float | None:
    """Mean device milliseconds of the window's spans named `name`."""
    times = [span["device_ms"] for span in window_spans(record) or []
             if span["name"] == name]
    if not times or None in times:
        return None
    return sum(times) / len(times)
