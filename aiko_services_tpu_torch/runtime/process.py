# Process runtime: one control-plane endpoint with services, message
# routing, and registrar discovery.
#
# Capability parity with the reference process runtime (reference:
# src/aiko_services/main/process.py:76-350): topic root
# "{namespace}/{hostname}/{process_id}", process liveness via LWT "(absent)"
# on "{root}/0/state", a message-handler table with MQTT wildcard matching,
# every inbound message pumped through the event engine onto the single
# application thread, and the registrar bootstrap handshake over the retained
# topic "{namespace}/service/registrar".
#
# Design departure: Process is instantiable (the reference uses an
# import-time singleton, reference main/__init__.py:72) so N virtual
# processes can share one OS process in hermetic tests -- each gets a unique
# synthetic process_id.  A module-level default process preserves the
# convenient singleton usage.

from __future__ import annotations

import itertools
import os
import threading

from ..transport import create_transport
from ..utils import (
    generate, parse, get_hostname, get_namespace, get_logger, epoch_now)
from ..transport.trie import TopicTrie
from .connection import Connection, ConnectionState
from .event import EventEngine
from .service import ServiceFields

__all__ = ["Process", "default_process", "REGISTRAR_BOOT_VERSION"]

_LOGGER = get_logger("process")
_PROCESS_SEQUENCE = itertools.count()

REGISTRAR_BOOT_VERSION = "2"


class Process:
    def __init__(self, namespace: str = None, transport_kind: str = None,
                 process_id: str = None, transport_kwargs: dict = None):
        self.namespace = namespace or get_namespace()
        self.hostname = get_hostname()
        if process_id is None:
            # unique even when many Processes share one OS process
            sequence = next(_PROCESS_SEQUENCE)
            process_id = (str(os.getpid()) if sequence == 0
                          else f"{os.getpid()}-{sequence}")
        self.process_id = str(process_id)
        self.topic_path_process = (
            f"{self.namespace}/{self.hostname}/{self.process_id}")
        self.topic_path_registrar_boot = (
            f"{self.namespace}/service/registrar")

        self.event = EventEngine(name=f"process-{self.process_id}")
        self.connection = Connection()
        self.registrar: dict | None = None  # {topic_path, version, timestamp}

        self._services: dict[int, object] = {}
        self._service_sequence = itertools.count(1)
        self._message_handlers: dict[str, list] = {}
        # trie-indexed dispatch (transport/trie.py): each inbound
        # message walks the topic's levels once instead of scanning
        # every registered pattern -- the per-message cost that used to
        # grow with every service/stream this process hosts.  The
        # per-pattern sequence number reproduces the historical dict
        # insertion order across handlers of different patterns
        self._handler_trie = TopicTrie()
        self._handler_sequence = itertools.count()
        self._handler_order: dict[str, int] = {}
        self._handlers_lock = threading.Lock()
        self._pending_registrations: list = []

        from ..utils import get_transport_configuration
        self.transport_kind = (
            transport_kind or get_transport_configuration()["kind"])
        self.transport = create_transport(
            self.transport_kind, self._on_transport_message,
            **(transport_kwargs or {}))
        self.event.add_queue_handler(self._message_queue_handler, ["message"])

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Connect the transport and begin registrar discovery; does not
        block (use run() to also own the event loop)."""
        self.transport.set_last_will_and_testament(
            f"{self.topic_path_process}/0/state", "(absent)", retain=True)
        self.connection.update_state(ConnectionState.NETWORK)
        self.transport.connect()
        self.connection.update_state(ConnectionState.TRANSPORT)
        self.add_message_handler(
            self._registrar_boot_handler, self.topic_path_registrar_boot)
        self.publish(f"{self.topic_path_process}/0/state", "(present)",
                     retain=True)

    def run(self, in_thread: bool = False):
        self.start()
        if in_thread:
            return self.event.loop_in_thread()
        self.event.loop()
        return None

    def terminate(self) -> None:
        for service in list(self._services.values()):
            try:
                service.stop()
            except Exception:
                _LOGGER.exception("Service stop failed")
        self.publish(f"{self.topic_path_process}/0/state", "(absent)",
                     retain=True)
        self.transport.disconnect(send_lwt=False)
        self.connection.update_state(ConnectionState.NONE)
        self.event.terminate()

    def crash(self) -> None:
        """Abnormal death for the chaos harness (faults.py
        process_kill / registrar_kill): NO service stop, NO clean
        "(absent)" publish -- the transport severs (every registered
        last-will fires, exactly as a broker reacts to a dead TCP
        session) and the event loop halts mid-flight.  Survivors must
        recover from the LWTs alone: the registrar reaps the services,
        a gateway standby's election fires, journaled streams replay."""
        _LOGGER.warning("%s: injected crash", self.topic_path_process)
        transport = self.transport
        sever = getattr(transport, "sever", None)
        if sever is not None:
            sever()
        else:
            transport.disconnect(send_lwt=True)
        self.connection.update_state(ConnectionState.NONE)
        self.event.terminate()

    def rejoin(self) -> None:
        """After a healed broker partition: reassert liveness (the
        retained "(present)" the partition's LWT overwrote) and
        re-register every service -- the registrar reaped them from
        the "(absent)" notices while we were gone."""
        self.publish(f"{self.topic_path_process}/0/state", "(present)",
                     retain=True)
        if (self.registrar
                and self.connection.is_connected(ConnectionState.REGISTRAR)):
            for service in list(self._services.values()):
                self._register_service(service.service_fields())
        else:
            # no primary in view: the bootstrap handshake re-registers
            # everything when the next "(primary found ...)" arrives
            self._pending_registrations = list(self._services.values())

    # -- services ----------------------------------------------------------

    def add_service(self, service) -> None:
        service.service_id = next(self._service_sequence)
        service.topic_path = (
            f"{self.topic_path_process}/{service.service_id}")
        self._services[service.service_id] = service
        if self.connection.is_connected(ConnectionState.REGISTRAR):
            self._register_service(service.service_fields())
        else:
            self._pending_registrations.append(service)

    def remove_service(self, service) -> None:
        self._services.pop(service.service_id, None)
        if service in self._pending_registrations:
            self._pending_registrations.remove(service)
        if (self.registrar
                and self.connection.is_connected(ConnectionState.TRANSPORT)):
            self.publish(
                f"{self.registrar['topic_path']}/in",
                generate("remove", [service.topic_path]))

    def services(self) -> list:
        return list(self._services.values())

    def _register_service(self, fields: ServiceFields) -> None:
        self.publish(f"{self.registrar['topic_path']}/in",
                     generate("add", fields.to_parameters()))

    # -- messaging ---------------------------------------------------------

    def publish(self, topic: str, payload, retain: bool = False) -> None:
        self.transport.publish(topic, payload, retain)

    def add_message_handler(self, handler, topic: str) -> None:
        with self._handlers_lock:
            first = topic not in self._message_handlers
            self._message_handlers.setdefault(topic, []).append(handler)
            if first:
                self._handler_trie.add(topic, topic)
                self._handler_order[topic] = next(self._handler_sequence)
        if first:
            self.transport.subscribe(topic)

    def remove_message_handler(self, handler, topic: str) -> None:
        last = False
        with self._handlers_lock:
            handlers = self._message_handlers.get(topic, [])
            if handler in handlers:
                handlers.remove(handler)
            if not handlers and topic in self._message_handlers:
                del self._message_handlers[topic]
                self._handler_trie.discard(topic, topic)
                self._handler_order.pop(topic, None)
                last = True
        if last:
            self.transport.unsubscribe(topic)

    def _on_transport_message(self, topic: str, payload: str) -> None:
        # transport dispatch thread -> event-loop thread
        # (reference process.py:247-251)
        self.event.queue_put((topic, payload), "message")

    def _message_queue_handler(self, item) -> None:
        topic, payload = item
        with self._handlers_lock:
            patterns = self._handler_trie.match(topic)
            patterns.sort(key=lambda pattern: self._handler_order.get(
                pattern, 0))
            matched = [handler
                       for pattern in patterns
                       for handler in self._message_handlers.get(
                           pattern, ())]
        for handler in matched:
            try:
                handler(topic, payload)
            except Exception:
                # one failing handler must not starve the others
                import traceback
                _LOGGER.error("Message handler %r failed on %s:\n%s",
                              handler, topic, traceback.format_exc())

    # -- registrar handshake (reference process.py:276-314) ----------------

    def _registrar_boot_handler(self, topic: str, payload: str) -> None:
        try:
            command, parameters = parse(payload)
        except ValueError as error:
            _LOGGER.warning("Bad registrar bootstrap payload dropped: %s",
                            error)
            return
        if command != "primary":
            return
        if parameters and parameters[0] == "found":
            self.registrar = {
                "topic_path": parameters[1],
                "version": parameters[2] if len(parameters) > 2 else "",
                "timestamp": parameters[3] if len(parameters) > 3 else "",
            }
            self.connection.update_state(ConnectionState.REGISTRAR)
            pending, self._pending_registrations = (
                self._pending_registrations, [])
            for service in pending:
                self._register_service(service.service_fields())
        elif parameters and parameters[0] == "absent":
            self.registrar = None
            if self.connection.is_connected(ConnectionState.TRANSPORT):
                self.connection.update_state(ConnectionState.TRANSPORT)
            # services will re-register when a new primary appears
            self._pending_registrations = list(self._services.values())

    def announce_registrar(self, topic_path: str) -> None:
        """Publish the retained registrar-found bootstrap record (called by
        a Registrar service that won the election)."""
        self.publish(
            self.topic_path_registrar_boot,
            generate("primary",
                     ["found", topic_path, REGISTRAR_BOOT_VERSION,
                      repr(epoch_now())]),
            retain=True)


_default_process: Process | None = None
_default_lock = threading.Lock()


def default_process() -> Process:
    global _default_process
    with _default_lock:
        if _default_process is None:
            _default_process = Process()
        return _default_process
