# Timer-based lease (capability parity with reference
# src/aiko_services/main/lease.py:31-83): fires an expiry handler unless
# extended; optionally auto-extends at 80% of the lease period.  Building
# block for stream lifetimes, EC share subscriptions, and lifecycle
# handshakes.

from __future__ import annotations

import hashlib

from ..utils import monotonic

__all__ = ["Lease", "jitter_fraction", "DEFAULT_TIMER_JITTER"]

# default spread for jittered lease timers: up to +10% of the period
DEFAULT_TIMER_JITTER = 0.1


def jitter_fraction(seed, lease_uuid,
                    spread: float = DEFAULT_TIMER_JITTER,
                    salt: str = "lease") -> float:
    """Deterministic per-lease fraction in [0, spread) for the Lease
    `jitter` parameter: a pure hash of (salt, seed, uuid), so runs
    under the same fault-harness seed reproduce the exact timer
    schedule while a burst of leases still spreads out (no
    thundering-herd lockstep).  ONE definition, shared by the pipeline
    stream leases and the serving gateway's stream records."""
    digest = hashlib.blake2b(
        f"{salt}:{seed}:{lease_uuid}".encode(), digest_size=8).digest()
    return (int.from_bytes(digest, "big") / float(1 << 64)) * spread


class Lease:
    def __init__(self, event_engine, lease_time: float, lease_uuid,
                 lease_expired_handler=None, lease_extend_handler=None,
                 automatic_extend: bool = False, jitter: float = 0.0):
        self.event_engine = event_engine
        self.lease_time = lease_time
        self.lease_uuid = lease_uuid
        self.lease_expired_handler = lease_expired_handler
        self.lease_extend_handler = lease_extend_handler
        self.automatic_extend = automatic_extend
        self._expired = False
        self._terminated = False
        self._deadline = monotonic() + lease_time
        if automatic_extend:
            # Extend at 0.8 x period so the lease never lapses while alive
            # (reference lease.py:33,54-56).
            self._timer_period = lease_time * 0.8
            self._timer = self._automatic_extend_timer
        else:
            self._timer_period = lease_time
            self._timer = self._expiry_timer
        # `jitter` stretches the TIMER PERIOD (never the deadline) by a
        # caller-chosen fraction: thousands of leases created in one
        # burst must not run their expiry checks in lockstep every
        # period (a thundering herd on the event loop).  The deadline
        # math is untouched, so expiry semantics only shift by at most
        # one jittered period -- callers pass a DETERMINISTIC fraction
        # (e.g. hashed from the lease uuid + harness seed) so runs
        # reproduce exactly.
        if jitter > 0.0:
            self._timer_period *= 1.0 + jitter
        event_engine.add_timer_handler(self._timer, self._timer_period)

    def _automatic_extend_timer(self) -> None:
        if self._terminated:
            return
        self.extend()
        if self.lease_extend_handler:
            self.lease_extend_handler(self.lease_time, self.lease_uuid)

    def _expiry_timer(self) -> None:
        if self._terminated:
            return
        if monotonic() >= self._deadline:
            self._expired = True
            self.terminate()
            if self.lease_expired_handler:
                self.lease_expired_handler(self.lease_uuid)

    def extend(self, lease_time: float | None = None) -> None:
        if lease_time is not None:
            self.lease_time = lease_time
        self._deadline = monotonic() + self.lease_time

    @property
    def expired(self) -> bool:
        return self._expired

    def terminate(self) -> None:
        if not self._terminated:
            self._terminated = True
            self.event_engine.remove_timer_handler(self._timer)
