# Logging: console always; distributed log publishing is layered on by the
# runtime -- every Service owns a get_service_logger() logger whose
# RingBufferHandler is given a "{topic_path}/log" publish sink when the
# transport connects (runtime/service.py), giving capability parity with the
# reference's LoggingHandlerMQTT ring-buffer design (reference:
# src/aiko_services/main/utilities/logger.py:98-172) without binding the
# utility layer to any transport.  AIKO_LOG_DISTRIBUTED=false disables
# publishing (reference AIKO_LOG_MQTT, logger.py:127).

from __future__ import annotations

import logging
import os
from collections import deque

__all__ = ["get_logger", "get_service_logger", "dispose_service_logger",
           "distributed_logging_enabled", "RingBufferHandler",
           "DEFAULT_LOG_FORMAT"]

DEFAULT_LOG_FORMAT = "%(asctime)s %(levelname)-7s %(name)s: %(message)s"


def get_logger(name: str, level: str | None = None) -> logging.Logger:
    """Per-subsystem logger; level from AIKO_LOG_LEVEL_<NAME> then
    AIKO_LOG_LEVEL then INFO (reference logger.py:98-118)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(DEFAULT_LOG_FORMAT))
        logger.addHandler(handler)
        logger.propagate = False
    env_level = (level
                 or os.environ.get(f"AIKO_LOG_LEVEL_{name.upper()}")
                 or os.environ.get("AIKO_LOG_LEVEL")
                 or "INFO")
    logger.setLevel(env_level.upper())
    return logger


def distributed_logging_enabled() -> bool:
    """AIKO_LOG_DISTRIBUTED=false|0|off turns off per-service /log topic
    publishing (reference AIKO_LOG_MQTT gate, logger.py:127)."""
    value = os.environ.get("AIKO_LOG_DISTRIBUTED", "true").lower()
    return value not in ("false", "0", "off")


def get_service_logger(topic_path: str, capacity: int = 128):
    """(logger, ring_handler) pair for one service instance.

    The logger is named "aiko.service.{topic_path}" (unique per service:
    process ids are unique per OS process, service ids per Process).
    Console output always; the ring handler buffers records until the
    runtime attaches the /log publish sink at TRANSPORT connect, flushing
    the backlog first.  ring_handler is None when distributed logging is
    disabled.
    """
    logger = logging.getLogger(f"aiko.service.{topic_path}")
    ring = None
    if not logger.handlers:
        console = logging.StreamHandler()
        console.setFormatter(logging.Formatter(DEFAULT_LOG_FORMAT))
        logger.addHandler(console)
        logger.propagate = False
        if distributed_logging_enabled():
            ring = RingBufferHandler(capacity)
            logger.addHandler(ring)
    else:
        for handler in logger.handlers:
            if isinstance(handler, RingBufferHandler):
                ring = handler
    env_level = (os.environ.get("AIKO_LOG_LEVEL") or "INFO")
    logger.setLevel(env_level.upper())
    return logger, ring


def dispose_service_logger(logger: logging.Logger) -> None:
    """Release a get_service_logger() logger when its service stops:
    logging.getLogger instances live forever in the manager dict, so a
    process that churns services must reclaim handlers + ring buffers."""
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()
    logging.Logger.manager.loggerDict.pop(logger.name, None)


class RingBufferHandler(logging.Handler):
    """Buffers records until a sink is attached, then streams through it.

    The runtime attaches a sink that publishes to the service's /log topic
    once the transport connects, flushing the buffered backlog first --
    the same connect-then-flush behavior as the reference's MQTT handler
    (reference logger.py:137-145), transport-agnostic here.
    """

    def __init__(self, capacity: int = 128):
        super().__init__()
        self._ring = deque(maxlen=capacity)
        self._sink = None
        self.setFormatter(logging.Formatter(DEFAULT_LOG_FORMAT))

    def attach_sink(self, sink) -> None:
        self._sink = sink
        while self._ring:
            self._emit_to_sink(self._ring.popleft())

    def detach_sink(self) -> None:
        self._sink = None

    def _emit_to_sink(self, text: str) -> None:
        try:
            self._sink(text)
        except Exception:  # logging must never take the process down
            pass

    def emit(self, record: logging.LogRecord) -> None:
        text = self.format(record)
        if self._sink is None:
            self._ring.append(text)
        else:
            self._emit_to_sink(text)
