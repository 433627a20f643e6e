"""Reading torch.profiler's trace of the measured window: the device's
busy time as the union of its kernel, copy and set intervals (kernels
that overlap are counted once), device time by kernel name, and the
idle gaps with what the host was doing during each."""

from __future__ import annotations

from collections import defaultdict

import numpy as np

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"
ATTRIBUTED_GAPS = 2000            # the longest gaps named by host activity
NAME_CHARS = 120


def merged(intervals: list) -> list:
    """Union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def read_profile(profile) -> dict:
    """The trace's record: window_s and busy_s (seconds; busy averaged
    over the cards that ran anything), kernel_s and kernel_count by
    name, and the breakdown (the ten device operations that took most
    time, and idle time by the host activity that covered each gap)."""
    import torch
    window = None
    device = []
    host = []
    for event in profile.profiler.kineto_results.events():
        on_device = event.device_type() == torch.autograd.DeviceType.CUDA
        if on_device and not _annotation(event):
            device.append((event.name(), event.start_ns(), event.end_ns(),
                           event.device_index()))
        elif not on_device:
            if event.name() == WINDOW:
                window = (event.start_ns(), event.end_ns())
            elif event.end_ns() > event.start_ns():
                host.append((event.name(), event.start_ns(),
                             event.end_ns()))
    if window is None:
        raise RuntimeError("the trace holds no bench.window span")
    low, high = window
    window_s = (high - low) / 1e9
    kernel_s: dict = defaultdict(float)
    kernel_count: dict = defaultdict(int)
    by_card: dict = defaultdict(list)
    for name, start, end, card in device:
        start, end = max(start, low), min(end, high)
        if end <= start:
            continue
        kernel_s[name] += (end - start) / 1e9
        kernel_count[name] += 1
        by_card[card].append((start, end))
    busy = {card: merged(spans) for card, spans in by_card.items()}
    busy_s = (sum(sum(end - start for start, end in spans)
                  for spans in busy.values()) / max(len(busy), 1) / 1e9)
    first_card = min(busy) if busy else None
    gaps = _gaps(busy.get(first_card, []), low, high)
    return {
        "window_s": window_s,
        "busy_s": busy_s,
        "kernel_s": dict(kernel_s),
        "kernel_count": dict(kernel_count),
        "breakdown": {
            "device_ops": [[_short(name), seconds] for name, seconds in
                           sorted(kernel_s.items(),
                                  key=lambda item: -item[1])[:10]],
            "idle_gaps": _idle_by_host(gaps, host),
        },
    }


def _annotation(event) -> bool:
    """A record_function span mirrored on the device's timeline (not
    work the device did)."""
    kind = getattr(event, "activity_type", None)
    if kind is not None:
        return kind() not in DEVICE_KINDS
    flag = getattr(event, "is_user_annotation", None)
    if flag is not None and flag():
        return True
    return event.name().startswith("bench.")


def _gaps(spans: list, low: int, high: int) -> list:
    gaps = []
    cursor = low
    for start, end in spans:
        if start > cursor:
            gaps.append((cursor, start))
        cursor = max(cursor, end)
    if high > cursor:
        gaps.append((cursor, high))
    return gaps


def _idle_by_host(gaps: list, host: list) -> list:
    """Idle seconds by the name of the shortest host span that covers
    the whole gap, for the longest gaps; the rest summed as one row."""
    if not gaps:
        return []
    gaps = sorted(gaps, key=lambda gap: gap[0] - gap[1])
    named, rest = gaps[:ATTRIBUTED_GAPS], gaps[ATTRIBUTED_GAPS:]
    starts = np.array([start for _, start, _ in host], dtype=np.int64)
    ends = np.array([end for _, _, end in host], dtype=np.int64)
    lengths = ends - starts
    totals: dict = defaultdict(float)
    for gap_start, gap_end in named:
        covering = np.flatnonzero((starts <= gap_start) & (ends >= gap_end))
        if covering.size:
            label = host[covering[np.argmin(lengths[covering])]][0]
        else:
            label = "(no host span covers the gap)"
        totals[_short(label)] += (gap_end - gap_start) / 1e9
    if rest:
        totals[f"({len(rest)} shorter gaps)"] += sum(
            end - start for start, end in rest) / 1e9
    return [[label, seconds] for label, seconds in
            sorted(totals.items(), key=lambda item: -item[1])[:10]]


def kernel_seconds(record: dict, fragment: str) -> float:
    """Device seconds of the kernels whose name holds `fragment`."""
    return sum(value for name, value in record["kernel_s"].items()
               if fragment in name)
