# UTC time helpers (capability parity with reference
# src/aiko_services/main/utilities/utc_iso8601.py:63-92).

from __future__ import annotations

import time
from datetime import datetime, timezone

__all__ = ["epoch_now", "epoch_to_iso", "iso_to_epoch", "monotonic"]


def epoch_now() -> float:
    return time.time()


def monotonic() -> float:
    return time.monotonic()


def epoch_to_iso(epoch: float) -> str:
    return datetime.fromtimestamp(epoch, tz=timezone.utc).isoformat(
        timespec="milliseconds")


def iso_to_epoch(text: str) -> float:
    return datetime.fromisoformat(text).timestamp()
