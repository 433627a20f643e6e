# Contention-diagnosing lock.
#
# Capability parity with the reference's named Lock wrapper (reference:
# src/aiko_services/main/utilities/lock.py:17-27), which logs WHO holds a
# lock when acquisition contends instead of blocking silently -- the
# poor-thread's deadlock diagnostic.  Here acquisition first tries
# non-blocking; on contention it logs the named holder (and how long it
# has held), then keeps waiting in `warn_seconds` slices, logging again
# each time a slice elapses without acquisition.

from __future__ import annotations

import threading
import time

from .logger import get_logger

__all__ = ["DiagnosticLock"]

_LOGGER = get_logger("lock")


class DiagnosticLock:
    """threading.Lock drop-in (context-manager + acquire/release) that
    names itself and reports contention with holder attribution."""

    def __init__(self, name: str, warn_seconds: float = 1.0):
        self.name = name
        self.warn_seconds = float(warn_seconds)
        self._lock = threading.Lock()
        # (holder thread name, monotonic acquire time) -- a single
        # attribute so readers see a consistent snapshot (CPython
        # attribute assignment is atomic); None = unheld
        self._held: tuple[str, float] | None = None
        self.contentions = 0  # observable in tests/diagnostics

    def _describe_holder(self) -> str:
        held = self._held
        if held is None:
            return "(just released)"
        holder, since = held
        return f"{holder} for {time.monotonic() - since:.3f} s"

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._lock.acquire(blocking=False):
            self._held = (threading.current_thread().name,
                          time.monotonic())
            return True
        if not blocking:
            return False
        self.contentions += 1
        waiter = threading.current_thread().name
        deadline = (None if timeout is None or timeout < 0
                    else time.monotonic() + timeout)
        while True:
            _LOGGER.warning("lock %s: contended -- held by %s (waiter: %s)",
                            self.name, self._describe_holder(), waiter)
            if deadline is None:
                slice_timeout = self.warn_seconds
            else:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                slice_timeout = min(self.warn_seconds, remaining)
            if self._lock.acquire(timeout=slice_timeout):
                self._held = (waiter, time.monotonic())
                return True

    def release(self) -> None:
        self._held = None
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        held = self._held
        holder = held[0] if held else "unheld"
        return f"DiagnosticLock({self.name}, {holder})"
