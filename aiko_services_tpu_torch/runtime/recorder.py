# Recorder: aggregate distributed log AND metrics topics for
# observability.
#
# Capability parity with the reference Recorder (reference:
# src/aiko_services/main/recorder.py:50-96): subscribes to a log-topic
# wildcard (default "{namespace}/+/+/+/log"), keeps an LRU of per-topic
# ring buffers, and republishes counts through its ECProducer so dashboards
# can watch live.
#
# Beyond the reference: the Recorder also consumes the telemetry plane --
# pipelines publish "(metrics source snapshot)" on their
# "{topic_path}/metrics" topic (observe.PipelineTelemetry); the Recorder
# keeps the LATEST snapshot per source and merges them associatively into
# one fleet view (observe.merge_snapshots), so a dashboard or operator
# asks ONE service for cluster-wide counters/histograms.
#
# Fault-tolerance plane: pipelines dead-letter error-released frames on
# "{topic_path}/dead_letter" (inputs descriptor + diagnostic + trace id,
# pipeline.py _dead_letter); the Recorder keeps a bounded ring of parsed
# dead letters so operators inspect WHAT failed, WHERE, and under WHICH
# trace without grepping logs.

from __future__ import annotations

from collections import deque

from ..observe.metrics import merge_snapshots, parse_metrics_payload
from ..utils import LRUCache, generate, get_logger, parse
from .actor import Actor
from .share import ECProducer

__all__ = ["Recorder"]

_LOGGER = get_logger("recorder")
SERVICE_PROTOCOL_RECORDER = "recorder:0"
RING_SIZE = 128          # reference logger ring, utilities/logger.py:137
TOPIC_CACHE_SIZE = 64
METRICS_CACHE_SIZE = 64  # latest snapshot per publishing service


class Recorder(Actor):
    def __init__(self, process, name: str = "recorder",
                 log_topic_pattern: str | None = None,
                 metrics_topic_pattern: str | None = None,
                 dead_letter_topic_pattern: str | None = None,
                 ring_size: int = RING_SIZE):
        super().__init__(process, name,
                         protocol=SERVICE_PROTOCOL_RECORDER)
        self.log_topic_pattern = (
            log_topic_pattern or f"{process.namespace}/+/+/+/log")
        self.metrics_topic_pattern = (
            metrics_topic_pattern or f"{process.namespace}/+/+/+/metrics")
        self.dead_letter_topic_pattern = (
            dead_letter_topic_pattern
            or f"{process.namespace}/+/+/+/dead_letter")
        self.ring_size = ring_size
        self.topic_rings = LRUCache(TOPIC_CACHE_SIZE)
        self.metrics_snapshots = LRUCache(METRICS_CACHE_SIZE)
        self.dead_letter_ring = deque(maxlen=ring_size)
        self.share.update({"topic_count": 0, "record_count": 0,
                           "metrics_source_count": 0,
                           "metrics_update_count": 0,
                           "dead_letter_count": 0})
        self._record_count = 0
        self._metrics_update_count = 0
        self._dead_letter_count = 0
        self.add_message_handler(self._log_handler, self.log_topic_pattern)
        self.add_message_handler(self._metrics_handler,
                                 self.metrics_topic_pattern)
        self.add_message_handler(self._dead_letter_handler,
                                 self.dead_letter_topic_pattern)

    def _log_handler(self, topic: str, payload: str) -> None:
        ring = self.topic_rings.get(topic)
        if ring is None:
            ring = deque(maxlen=self.ring_size)
            self.topic_rings.put(topic, ring)
            self.ec_producer.update("topic_count", len(self.topic_rings))
        ring.append(payload)
        self._record_count += 1
        if self._record_count % 16 == 0:  # rate-limit EC chatter
            self.ec_producer.update("record_count", self._record_count)

    def _metrics_handler(self, topic: str, payload: str) -> None:
        decoded = parse_metrics_payload(payload)
        if decoded is None:
            _LOGGER.debug("undecodable metrics payload on %s", topic)
            return
        source, snapshot = decoded
        new_source = self.metrics_snapshots.get(source) is None
        self.metrics_snapshots.put(source, snapshot)
        self._metrics_update_count += 1
        if new_source:
            self.ec_producer.update("metrics_source_count",
                                    len(self.metrics_snapshots))
        if self._metrics_update_count % 16 == 0:  # rate-limit EC chatter
            self.ec_producer.update("metrics_update_count",
                                    self._metrics_update_count)

    def _dead_letter_handler(self, topic: str, payload: str) -> None:
        """One failed frame's evidence: (dead_letter meta descriptor)
        from a pipeline's fault-tolerance layer.  Stored parsed (topic,
        meta, inputs-descriptor) so dead_letters() is directly
        inspectable; every dead letter counts even when the ring
        evicts."""
        try:
            command, parameters = parse(
                payload if isinstance(payload, str) else str(payload))
        except ValueError:
            _LOGGER.debug("undecodable dead letter on %s", topic)
            return
        if command != "dead_letter" or not parameters:
            return
        meta = parameters[0] if isinstance(parameters[0], dict) else {}
        descriptor = (parameters[1] if len(parameters) > 1
                      and isinstance(parameters[1], dict) else {})
        self.dead_letter_ring.append((topic, meta, descriptor))
        self._dead_letter_count += 1
        self.ec_producer.update("dead_letter_count",
                                self._dead_letter_count)

    def records(self, topic: str) -> list:
        ring = self.topic_rings.get(topic)
        return list(ring) if ring is not None else []

    def topics(self) -> list:
        return list(self.topic_rings.keys())

    # -- telemetry views ---------------------------------------------------

    def dead_letters(self) -> list:
        """Newest-last (topic, meta, inputs-descriptor) tuples from the
        fleet's dead-letter topics."""
        return list(self.dead_letter_ring)

    def deadletters(self, response_topic, count="64") -> None:
        """Wire query for the dead-letter ring: `(deadletters
        response_topic [count])` on /in answers with the Storage-style
        paged shape -- "(item_count N)" then N "(item <json>)" records,
        each {"index", "topic", "meta", "descriptor"} -- the surface
        `aiko deadletter ls|replay` drains after a recovered outage.
        Indexes are ring positions (newest last), stable between ls and
        replay as long as no new dead letter lands between the two."""
        try:
            count = int(float(count))
        except (TypeError, ValueError):
            count = 64
        entries = list(self.dead_letter_ring)
        first = max(0, len(entries) - count)
        publish = self.process.publish
        import json
        publish(response_topic,
                generate("item_count", [len(entries) - first]))
        for index in range(first, len(entries)):
            topic, meta, descriptor = entries[index]
            publish(response_topic, generate("item", [json.dumps(
                {"index": index, "topic": topic, "meta": meta,
                 "descriptor": descriptor})]))

    def metrics_sources(self) -> list:
        return list(self.metrics_snapshots.keys())

    def metrics_for(self, source: str) -> dict | None:
        return self.metrics_snapshots.get(source)

    def merged_metrics(self) -> dict:
        """One fleet-wide snapshot: every source's latest, merged
        (counters add, histograms add bucket-wise)."""
        merged = {"counters": {}, "gauges": {}, "histograms": {}}
        for source in self.metrics_snapshots.keys():
            snapshot = self.metrics_snapshots.get(source)
            if snapshot:
                merged = merge_snapshots(merged, snapshot)
        return merged

    def stop(self) -> None:
        # flush the FINAL record/metrics counts: the modulo-16 rate
        # limit otherwise leaves the last published value stale by up
        # to 15 records
        self.ec_producer.update("record_count", self._record_count)
        self.ec_producer.update("metrics_update_count",
                                self._metrics_update_count)
        self.remove_message_handler(self._log_handler,
                                    self.log_topic_pattern)
        self.remove_message_handler(self._metrics_handler,
                                    self.metrics_topic_pattern)
        self.remove_message_handler(self._dead_letter_handler,
                                    self.dead_letter_topic_pattern)
        super().stop()
