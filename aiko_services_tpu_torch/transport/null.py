# Null transport: every operation no-ops (capability parity with the
# reference "Castaway" null object, reference:
# src/aiko_services/main/message/castaway.py:9-44).  Enables fully
# transport-less single-process pipeline runs.

from __future__ import annotations

from .base import Transport

__all__ = ["NullTransport"]


class NullTransport(Transport):
    def connect(self) -> None:
        pass

    def disconnect(self, send_lwt: bool = False) -> None:
        pass

    def publish(self, topic, payload, retain=False) -> None:
        pass

    def subscribe(self, topic) -> None:
        pass

    def unsubscribe(self, topic) -> None:
        pass

    def set_last_will_and_testament(self, topic, payload, retain=False):
        pass

    @property
    def connected(self) -> bool:
        return False
