"""Arithmetic the per-layer readers share (this file names no metric)."""

from __future__ import annotations

import numpy as np

from bench_h100 import roofline
from bench_h100.trace import kernel_seconds

COSTS = {"flash_forward_kernel": roofline.attention_forward_cost}


def p95_ms(values) -> float | None:
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), 95)) * 1e3


def idle_share(record: dict) -> float | None:
    """Per cent of the traced window in which the card ran nothing."""
    if record["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])


def roofline_share(record: dict, kernel: str, cases: str) -> float | None:
    """Per cent of the kernel's device time that its bound accounts for:
    the bound of each launch (roofline.bound_seconds over its bytes and
    operations) times the launches the program counted, over the
    kernel's time by name in the trace."""
    seconds = kernel_seconds(record, kernel)
    if seconds <= 0:
        return None
    least = 0.0
    for case in record.get(cases, []):
        moved, operations = COSTS[kernel](
            case["heads"], case["q_len"], case["k_len"], case["dim"],
            case["causal"])
        least += case["launches"] * roofline.bound_seconds(moved, operations)
    if least <= 0:
        return None
    return 100.0 * least / seconds


def mfu(record: dict, cards: int = 1) -> float | None:
    """Per cent of the cards' bf16 peak: the model's FLOPs for the work
    the window completed over the window."""
    if record.get("model_flops", 0) <= 0:
        return None
    return 100.0 * record["model_flops"] / (
        record["host_window_s"] * cards * roofline.PEAK_BF16_FLOPS)
