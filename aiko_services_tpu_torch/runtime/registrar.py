# Registrar: the service-discovery directory with primary election.
#
# Capability parity with the reference registrar (reference:
# src/aiko_services/main/registrar.py:34-357): election via the retained
# bootstrap topic "{namespace}/service/registrar" (start -> primary_search ->
# primary | secondary, promotion after a search timeout, failover when the
# primary's LWT "(primary absent)" fires); a service table fed by "(add ...)"
# / "(remove ...)" commands; death reaping from "(absent)" state notices;
# "(share response_topic filter...)" queries; and a bounded history ring.
#
# Split-brain fix (SURVEY.md section 7 hard part 6): the reference admits a
# multi-secondary election bug (reference registrar.py:54-55); here a primary
# that sees another primary's retained announcement with an EARLIER timestamp
# deterministically demotes itself.
#
# The election machine itself is extracted as RetainedElection so OTHER
# singletons ride the same proven protocol: the serving gateway's
# hot-standby pair (serve/journal.py HA mode) elects its primary over a
# retained "{namespace}/gateway/{group}" topic with exactly this state
# machine -- one election implementation, one set of split-brain and
# failover semantics, two consumers.

from __future__ import annotations

from collections import deque

from ..utils import generate, parse, parse_float, get_logger, epoch_now
from .actor import Actor
from .service import (
    ServiceFields, ServiceFilter, Services, SERVICE_PROTOCOL_REGISTRAR)
from .share import ECProducer

__all__ = ["Registrar", "RetainedElection"]

_LOGGER = get_logger("registrar")
_HISTORY_RING_SIZE = 4096  # reference registrar.py:128-129
DEFAULT_SEARCH_TIMEOUT = 2.0  # reference registrar.py:139-141


class RetainedElection:
    """Primary election over ONE retained bootstrap topic (the
    registrar protocol, reference registrar.py:139-226):

      start -> primary_search    subscribe, wait `search_timeout` for a
                                 retained "(primary found ...)"
      primary_search -> primary  nothing found: promote, set the LWT
                                 "(primary absent)" (retained), announce
      primary_search/secondary   a found record for ANOTHER topic path:
        -> secondary             stand by
      secondary -> primary_search a "(primary absent)" (the primary's
                                 LWT fired, or a clean handover):
                                 re-run the search at half timeout
      primary -> secondary       a found record with an EARLIER
                                 timestamp: deterministic demotion
                                 (split-brain fix); ties break on the
                                 LOWER topic path

    The owner supplies `announce()` (publish the retained found record
    -- its payload format is the owner's), and optional on_promote /
    on_demote / on_state callbacks.  All transitions run on the
    process event-loop thread (handlers + timers)."""

    def __init__(self, process, boot_topic: str, topic_path: str,
                 announce, search_timeout: float = DEFAULT_SEARCH_TIMEOUT,
                 on_promote=None, on_demote=None, on_state=None,
                 absent_payload: str = "(primary absent)"):
        self.process = process
        self.boot_topic = boot_topic
        self.topic_path = topic_path
        self.search_timeout = search_timeout
        self.absent_payload = absent_payload
        self._announce = announce
        self._on_promote = on_promote
        self._on_demote = on_demote
        self._on_state = on_state
        self.state = "start"
        self.time_started = epoch_now()
        self._stopped = False
        process.add_message_handler(self._boot_handler, boot_topic)
        self._transition("primary_search")
        process.event.add_timer_handler(
            self._search_timer, self.search_timeout)

    def _transition(self, state: str) -> None:
        self.state = state
        if self._on_state is not None:
            self._on_state(state)
        _LOGGER.debug("%s: election state -> %s", self.topic_path, state)

    def _search_timer(self) -> None:
        self.process.event.remove_timer_handler(self._search_timer)
        if self.state == "primary_search" and not self._stopped:
            self._promote()

    def _boot_handler(self, topic: str, payload: str) -> None:
        try:
            command, parameters = parse(payload)
        except ValueError:
            return
        if command != "primary" or not parameters:
            return
        if parameters[0] == "found":
            found_topic = parameters[1] if len(parameters) > 1 else ""
            found_time = parse_float(
                parameters[3] if len(parameters) > 3 else "0")
            if found_topic == self.topic_path:
                return
            if self.state == "primary":
                loses_tie = (found_time == self.time_started
                             and found_topic < self.topic_path)
                if found_time and (found_time < self.time_started
                                   or loses_tie):
                    _LOGGER.warning(
                        "%s: older primary %s found, demoting",
                        self.topic_path, found_topic)
                    self._demote()
                else:
                    # re-assert: we are the older primary
                    self._announce()
            elif self.state in ("primary_search", "secondary"):
                self._transition("secondary")
        elif parameters[0] == "absent":
            if self.state == "secondary":
                self._transition("primary_search")
                self.process.event.add_timer_handler(
                    self._search_timer, self.search_timeout * 0.5)

    def _promote(self) -> None:
        self.time_started = epoch_now()
        self._transition("primary")
        self.process.transport.set_last_will_and_testament(
            self.boot_topic, self.absent_payload, retain=True)
        if self._on_promote is not None:
            self._on_promote()
        self._announce()

    def _demote(self) -> None:
        self._transition("secondary")
        self.process.transport.clear_last_will_and_testament(
            self.boot_topic)
        if self._on_demote is not None:
            self._on_demote()

    def stop(self) -> None:
        self._stopped = True
        if self.state == "primary":
            # clean handover: clear the retained announcement so the
            # surviving secondary re-elects without waiting on an LWT
            self.process.publish(self.boot_topic, self.absent_payload,
                                 retain=True)
        self.process.remove_message_handler(self._boot_handler,
                                            self.boot_topic)


class Registrar(Actor):
    def __init__(self, process, name: str = "registrar",
                 search_timeout: float = DEFAULT_SEARCH_TIMEOUT):
        super().__init__(process, name,
                         protocol=SERVICE_PROTOCOL_REGISTRAR)
        self.search_timeout = search_timeout
        self.command_aliases["share"] = "share_query"
        self.services_table = Services()
        # control-plane accounting (bench `control_plane` block):
        # registration qps is the registrar's share of the ceiling
        from ..observe.metrics import get_registry
        self._m_adds = get_registry().counter("registrar.adds")
        self._m_removes = get_registry().counter("registrar.removes")
        self.history_ring: deque = deque(maxlen=_HISTORY_RING_SIZE)
        self.share.update({
            "state": "start",
            "service_count": 0,
            "time_started": repr(epoch_now()),
        })

        self._boot_topic = process.topic_path_registrar_boot
        self._state_pattern = f"{process.namespace}/+/+/+/state"
        self.election = RetainedElection(
            process, self._boot_topic, self.topic_path,
            announce=lambda: process.announce_registrar(self.topic_path),
            search_timeout=search_timeout,
            on_promote=self._on_promote, on_demote=self._on_demote,
            on_state=self._on_state)

    # -- election (RetainedElection drives the transitions) ----------------

    @property
    def state(self) -> str:
        return self.election.state

    @property
    def time_started(self) -> float:
        return self.election.time_started

    def _on_state(self, state: str) -> None:
        if self.ec_producer:
            self.ec_producer.update("state", state)
        _LOGGER.debug("%s: state -> %s", self.topic_path, state)

    def _on_promote(self) -> None:
        if self.ec_producer:
            self.ec_producer.update("time_started",
                                    repr(self.time_started))
        self.process.add_message_handler(
            self._service_state_handler, self._state_pattern)

    def _on_demote(self) -> None:
        self.process.remove_message_handler(
            self._service_state_handler, self._state_pattern)
        self.services_table = Services()
        self._update_service_count()

    # -- service table commands (arrive via actor mailbox on /in) ----------

    def add(self, topic_path, name, protocol, transport, owner, tags=None):
        if self.state != "primary":
            return
        fields = ServiceFields(topic_path, name, protocol, transport, owner,
                               tags if isinstance(tags, list) else [tags])
        self.services_table.add_service(fields)
        self.history_ring.append(("add", fields, epoch_now()))
        self._m_adds.inc()
        self._update_service_count()
        self.publish_out("add", fields.to_parameters())

    def remove(self, topic_path):
        if self.state != "primary":
            return
        removed = self.services_table.remove_service(topic_path)
        for fields in removed:
            self.history_ring.append(("remove", fields, epoch_now()))
            self._m_removes.inc()
            self.publish_out("remove", [fields.topic_path])
        if removed:
            self._update_service_count()

    def share_query(self, response_topic, topic_paths="*", name="*",
                    protocol="*", transport="*", owner="*", tags="*"):
        service_filter = ServiceFilter(topic_paths, name, protocol,
                                       transport, owner, tags)
        matches = self.services_table.filter_services(service_filter)
        publish = self.process.publish
        publish(response_topic, generate("item_count", [len(matches)]))
        for fields in matches:
            publish(response_topic, generate("add", fields.to_parameters()))
        publish(response_topic, generate("sync", [self.topic_path]))

    def history(self, response_topic, count="16"):
        count = int(parse_float(count, 16))
        entries = list(self.history_ring)[-count:]
        publish = self.process.publish
        publish(response_topic, generate("item_count", [len(entries)]))
        for command, fields, timestamp in entries:
            publish(response_topic,
                    generate("history",
                             [command, repr(timestamp)]
                             + fields.to_parameters()))

    # -- death reaping -----------------------------------------------------

    def _service_state_handler(self, topic: str, payload: str) -> None:
        try:
            command, _ = parse(payload)
        except ValueError:
            return
        if command != "absent":
            return
        service_topic_path = topic.rsplit("/state", 1)[0]
        self.remove(service_topic_path)

    def _update_service_count(self) -> None:
        # COALESCED share update: a 1,000-service bring-up used to emit
        # ~1,000 per-registration share publishes per lease; stage()
        # folds the storm into one delta per drained mailbox burst
        # (publish count is O(ticks), asserted by tests/test_scale.py)
        if self.ec_producer:
            self.ec_producer.stage(
                "service_count", len(self.services_table))

    def stop(self) -> None:
        was_primary = self.state == "primary"
        self.election.stop()
        if was_primary:
            self.process.remove_message_handler(
                self._service_state_handler, self._state_pattern)
        super().stop()
