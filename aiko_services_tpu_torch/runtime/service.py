# Service layer: discoverable units inside a Process.
#
# Capability parity with the reference service layer (reference:
# src/aiko_services/main/service.py:99-583): every service owns the topic
# quintet {topic_path}/control,in,log,out,state; ServiceProtocol names a
# capability URL + version; ServiceFilter matches on topic/name/protocol/
# transport/owner/tags; the Services container is a two-level dict
# {process_topic -> {service_id -> fields}} with filtered queries.
#
# Design departure: plain classes and explicit registration instead of the
# reference's composition engine (compose_instance "FrankensteinClass",
# reference component.py:50-123) -- SURVEY.md section 7 calls for ABCs.

from __future__ import annotations

from ..utils import get_logger, get_service_logger, dispose_service_logger
from .connection import ConnectionState

__all__ = [
    "ServiceProtocol", "ServiceFields", "ServiceFilter", "ServiceTags",
    "ServiceTopicPath", "Services", "Service",
    "PROTOCOL_PREFIX", "SERVICE_PROTOCOL_REGISTRAR",
    "SERVICE_PROTOCOL_PIPELINE", "SERVICE_PROTOCOL_ACTOR",
]

_LOGGER = get_logger("service")

PROTOCOL_PREFIX = "github.com/aiko_services_tpu/protocol"
SERVICE_PROTOCOL_REGISTRAR = f"{PROTOCOL_PREFIX}/registrar:2"
SERVICE_PROTOCOL_ACTOR = f"{PROTOCOL_PREFIX}/actor:0"
SERVICE_PROTOCOL_PIPELINE = f"{PROTOCOL_PREFIX}/pipeline:0"


class ServiceProtocol:
    """Capability URL "prefix/name:version" (reference service.py:105-138)."""

    def __init__(self, url_prefix: str, name: str, version):
        self.url_prefix = url_prefix
        self.name = name
        self.version = str(version)

    def __str__(self):
        return f"{self.url_prefix}/{self.name}:{self.version}"

    @staticmethod
    def name_version(protocol: str) -> tuple[str, str]:
        tail = protocol.rsplit("/", 1)[-1]
        if ":" in tail:
            name, version = tail.split(":", 1)
            return name, version
        return tail, ""


class ServiceTags:
    """Tags are "key=value" strings (reference service.py:236-252)."""

    @staticmethod
    def get_tag_value(key: str, tags) -> str | None:
        prefix = f"{key}="
        for tag in tags or ():
            if tag.startswith(prefix):
                return tag[len(prefix):]
        return None

    @staticmethod
    def match(required, tags) -> bool:
        if required in ("*", None) or required == []:
            return True
        return all(tag in (tags or ()) for tag in required)


class ServiceTopicPath:
    """Parse "{namespace}/{hostname}/{process_id}/{service_id}"
    (reference service.py:254-330)."""

    def __init__(self, namespace, hostname, process_id, service_id):
        self.namespace = namespace
        self.hostname = hostname
        self.process_id = str(process_id)
        self.service_id = str(service_id)

    @classmethod
    def parse(cls, topic_path: str) -> "ServiceTopicPath | None":
        parts = topic_path.split("/")
        if len(parts) == 4:
            return cls(*parts)
        return None

    @property
    def process_topic_path(self) -> str:
        return f"{self.namespace}/{self.hostname}/{self.process_id}"

    def terse(self) -> str:
        return f"{self.hostname}/{self.process_id}/{self.service_id}"

    def __str__(self):
        return (f"{self.namespace}/{self.hostname}/"
                f"{self.process_id}/{self.service_id}")


class ServiceFields:
    """Registrar record for one service (reference service.py:150-210)."""

    __slots__ = ("topic_path", "name", "protocol", "transport", "owner",
                 "tags")

    def __init__(self, topic_path, name, protocol, transport="loopback",
                 owner="", tags=None):
        self.topic_path = topic_path
        self.name = name
        self.protocol = protocol
        self.transport = transport
        self.owner = owner
        self.tags = list(tags or [])

    def to_parameters(self) -> list:
        return [self.topic_path, self.name, self.protocol, self.transport,
                self.owner, self.tags]

    @classmethod
    def from_parameters(cls, parameters) -> "ServiceFields":
        topic_path, name, protocol, transport, owner = parameters[:5]
        tags = parameters[5] if len(parameters) > 5 else []
        if isinstance(tags, str):
            tags = [tags]
        return cls(topic_path, name, protocol, transport, owner, tags)

    def __repr__(self):
        return (f"ServiceFields({self.topic_path}, {self.name}, "
                f"{self.protocol}, {self.transport}, {self.owner}, "
                f"{self.tags})")


def _field_match(required, actual) -> bool:
    if required in ("*", None):
        return True
    if isinstance(required, str) and ("*" in required or "?" in required):
        import fnmatch
        return fnmatch.fnmatchcase(str(actual), required)
    return required == actual


class ServiceFilter:
    """Wildcard service query (reference service.py:212-234)."""

    def __init__(self, topic_paths="*", name="*", protocol="*",
                 transport="*", owner="*", tags="*"):
        self.topic_paths = topic_paths
        self.name = name
        self.protocol = protocol
        self.transport = transport
        self.owner = owner
        self.tags = tags

    @classmethod
    def from_parameters(cls, parameters) -> "ServiceFilter":
        fields = list(parameters) + ["*"] * (6 - len(parameters))
        return cls(*fields[:6])

    def to_parameters(self) -> list:
        return [self.topic_paths, self.name, self.protocol, self.transport,
                self.owner, self.tags]

    def matches(self, fields: ServiceFields) -> bool:
        if self.topic_paths not in ("*", None):
            topic_paths = (self.topic_paths
                           if isinstance(self.topic_paths, (list, tuple))
                           else [self.topic_paths])
            if fields.topic_path not in topic_paths:
                return False
        return (_field_match(self.name, fields.name)
                and _field_match(self.protocol, fields.protocol)
                and _field_match(self.transport, fields.transport)
                and _field_match(self.owner, fields.owner)
                and ServiceTags.match(self.tags, fields.tags))

    def __repr__(self):
        return f"ServiceFilter({self.to_parameters()})"


class Services:
    """Two-level registry {process_topic -> {service_id -> ServiceFields}}
    (reference service.py:354-490)."""

    def __init__(self):
        self._services: dict[str, dict[str, ServiceFields]] = {}
        self._count = 0

    def add_service(self, fields: ServiceFields) -> None:
        topic = ServiceTopicPath.parse(fields.topic_path)
        if topic is None:
            raise ValueError(f"Bad service topic path: {fields.topic_path}")
        process = self._services.setdefault(topic.process_topic_path, {})
        if topic.service_id not in process:
            self._count += 1
        process[topic.service_id] = fields

    def remove_service(self, topic_path: str) -> list[ServiceFields]:
        """Remove one service; service_id 0 purges the whole process
        (reference registrar.py:334-357)."""
        topic = ServiceTopicPath.parse(topic_path)
        if topic is None:
            return []
        process = self._services.get(topic.process_topic_path)
        if process is None:
            return []
        removed = []
        if topic.service_id == "0":
            removed = list(process.values())
            self._count -= len(process)
            del self._services[topic.process_topic_path]
        elif topic.service_id in process:
            removed = [process.pop(topic.service_id)]
            self._count -= 1
            if not process:
                del self._services[topic.process_topic_path]
        return removed

    def get_service(self, topic_path: str) -> ServiceFields | None:
        topic = ServiceTopicPath.parse(topic_path)
        if topic is None:
            return None
        return self._services.get(
            topic.process_topic_path, {}).get(topic.service_id)

    def filter_services(self, service_filter: ServiceFilter) -> list:
        return [fields
                for process in self._services.values()
                for fields in process.values()
                if service_filter.matches(fields)]

    def __len__(self):
        return self._count

    def __iter__(self):
        for process in self._services.values():
            yield from process.values()


class Service:
    """A discoverable unit inside a Process.

    Owns the topic quintet and registers itself with its process (which
    forwards the registration to the Registrar once discovered).
    """

    def __init__(self, process, name: str, protocol: str = None,
                 tags=None, owner: str = ""):
        self.process = process
        self.name = name
        self.protocol = protocol or SERVICE_PROTOCOL_ACTOR
        self.tags = list(tags or [])
        self.owner = owner
        self.service_id = None      # assigned by process.add_service
        self.topic_path = None
        process.add_service(self)
        # distributed logging (reference logger.py:127-172, process.py:103-
        # 114): records buffer in a ring until the transport connects, then
        # stream to {topic_path}/log; a Recorder or dashboard subscribes
        self.logger, self._log_ring = get_service_logger(self.topic_path)
        import threading
        self._log_tls = threading.local()  # per-thread recursion guard
        if self._log_ring is not None:
            process.connection.add_handler(self._log_connection_handler)

    # topic quintet (reference service.py:535-551)
    @property
    def topic_control(self):
        return f"{self.topic_path}/control"

    @property
    def topic_in(self):
        return f"{self.topic_path}/in"

    @property
    def topic_log(self):
        return f"{self.topic_path}/log"

    @property
    def topic_out(self):
        return f"{self.topic_path}/out"

    @property
    def topic_state(self):
        return f"{self.topic_path}/state"

    def service_fields(self) -> ServiceFields:
        return ServiceFields(
            topic_path=self.topic_path, name=self.name,
            protocol=self.protocol, transport=self.process.transport_kind,
            owner=self.owner, tags=self.tags)

    # -- distributed logging ----------------------------------------------

    def _log_connection_handler(self, connection, state) -> None:
        if connection.is_connected(ConnectionState.TRANSPORT):
            self._log_ring.attach_sink(self._publish_log_record)
        else:
            self._log_ring.detach_sink()

    def _publish_log_record(self, text: str) -> None:
        # per-thread guard: a transport that logs DURING publish must not
        # recurse, while concurrent logging from other threads still flows
        if getattr(self._log_tls, "publishing", False):
            return
        self._log_tls.publishing = True
        try:
            self.process.publish(self.topic_log, text)
        finally:
            self._log_tls.publishing = False

    def add_tags(self, tags) -> None:
        for tag in tags:
            if tag not in self.tags:
                self.tags.append(tag)

    def add_message_handler(self, handler, topic: str,
                            binary: bool = False) -> None:
        self.process.add_message_handler(handler, topic)

    def remove_message_handler(self, handler, topic: str) -> None:
        self.process.remove_message_handler(handler, topic)

    def stop(self) -> None:
        if self._log_ring is not None:
            self.process.connection.remove_handler(
                self._log_connection_handler)
            self._log_ring.detach_sink()
        dispose_service_logger(self.logger)
        self.process.remove_service(self)
