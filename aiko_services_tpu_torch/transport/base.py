# Transport abstraction for the control plane.
#
# Capability parity with the reference Message ABC (reference:
# src/aiko_services/main/message/message.py:11-46): publish / subscribe /
# unsubscribe / last-will-and-testament over hierarchical topics with MQTT
# wildcard semantics ('+' single level, '#' multi-level tail).  The data
# plane never rides this interface -- tensors stay on device -- so payloads
# are small strings/bytes.

from __future__ import annotations

from abc import ABC, abstractmethod

__all__ = ["Transport", "topic_matches"]


def topic_matches(pattern: str, topic: str) -> bool:
    """MQTT-style topic filter match (reference process.py:334-350)."""
    if pattern == topic:
        return True
    pattern_parts = pattern.split("/")
    topic_parts = topic.split("/")
    for index, part in enumerate(pattern_parts):
        if part == "#":
            return True
        if index >= len(topic_parts):
            return False
        if part == "+":
            continue
        if part != topic_parts[index]:
            return False
    return len(pattern_parts) == len(topic_parts)


class Transport(ABC):
    """Connection to a pub/sub broker.

    on_message(topic: str, payload: str) is invoked on the transport's
    dispatch thread; implementations must never run user code inline with
    publish().  The runtime re-queues every delivery onto the event loop.
    """

    def __init__(self, on_message=None):
        self.on_message = on_message

    @abstractmethod
    def connect(self) -> None: ...

    @abstractmethod
    def disconnect(self, send_lwt: bool = False) -> None: ...

    @abstractmethod
    def publish(self, topic: str, payload, retain: bool = False) -> None: ...

    @abstractmethod
    def subscribe(self, topic: str) -> None: ...

    @abstractmethod
    def unsubscribe(self, topic: str) -> None: ...

    @abstractmethod
    def set_last_will_and_testament(
        self, topic: str, payload, retain: bool = False) -> None: ...

    def clear_last_will_and_testament(self, topic: str) -> None:
        """Remove a previously-set will.  Transports with a single will per
        connection (MQTT) clear it entirely; the loopback broker supports
        one will per topic."""


    @property
    @abstractmethod
    def connected(self) -> bool: ...
