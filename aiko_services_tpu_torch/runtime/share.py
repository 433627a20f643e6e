# Eventually-consistent state sharing.
#
# Capability parity with the reference EC layer (reference:
# src/aiko_services/main/share.py:153-656): an ECProducer exposes a
# service's "share" dictionary over its control topic with commands
# (add/update/remove name value) and leased "(share response_topic
# lease_time filter)" subscriptions; full sync is "(item_count N)" + N x
# "(add name value)" + "(sync ...)"; an ECConsumer mirrors a remote share
# into a local dict with an auto-extending lease; ServicesCache mirrors the
# registrar's service table and notifies filtered handlers on changes.
#
# Share keys may be dotted "a.b" for one level of nesting (reference
# share.py:115-119 allows <= 2 levels).

from __future__ import annotations

import itertools

from ..utils import generate, parse_number, get_logger
from .connection import ConnectionState
from .lease import Lease
from .service import ServiceFields, ServiceFilter, Services

__all__ = ["ECProducer", "ECConsumer", "ServicesCache",
           "services_cache_create_singleton"]

_LOGGER = get_logger("share")
_EC_COMMANDS = frozenset(("add", "update", "remove", "share"))
DEFAULT_LEASE_TIME = 300.0  # seconds (reference share.py:86)


_SHARE_COUNTERS = None


def _share_counters():
    """(publishes, delta_publishes, updates_coalesced) resolved ONCE
    from the process-global registry -- stage() rides stream-churn
    storms, so the per-update cost must stay a plain int add (the
    counters feed the bench `control_plane` block)."""
    global _SHARE_COUNTERS
    if _SHARE_COUNTERS is None:
        from ..observe.metrics import get_registry
        registry = get_registry()
        _SHARE_COUNTERS = (registry.counter("share.publishes"),
                           registry.counter("share.delta_publishes"),
                           registry.counter("share.updates_coalesced"))
    return _SHARE_COUNTERS


def _get_nested(share: dict, name: str):
    if "." in name:
        head, tail = name.split(".", 1)
        value = share.get(head)
        if isinstance(value, dict):
            return value.get(tail)
        return None
    return share.get(name)


def _set_nested(share: dict, name: str, value) -> None:
    if "." in name:
        head, tail = name.split(".", 1)
        share.setdefault(head, {})[tail] = value
    else:
        share[name] = value


def _remove_nested(share: dict, name: str) -> None:
    if "." in name:
        head, tail = name.split(".", 1)
        if isinstance(share.get(head), dict):
            share[head].pop(tail, None)
    else:
        share.pop(name, None)


def _flatten(share: dict) -> list[tuple[str, object]]:
    items = []
    for key, value in share.items():
        if isinstance(value, dict):
            for sub_key, sub_value in value.items():
                items.append((f"{key}.{sub_key}", sub_value))
        else:
            items.append((key, value))
    return items


class ECProducer:
    def __init__(self, service, share: dict = None):
        self.service = service
        self.share = share if share is not None else getattr(
            service, "share", {})
        self._leases: dict[str, Lease] = {}  # response_topic -> Lease
        self._change_handlers: list = []
        # coalesced publishing (stage/flush_staged): a burst of staged
        # updates within one event-loop tick folds into ONE `(delta
        # {...})` payload per lease -- the control-plane publish count
        # becomes O(ticks), not O(updates).  `_last_flushed` shadows
        # published SCALAR values so an unchanged re-stage publishes
        # nothing at all
        self._staged: dict = {}
        self._forced: set = set()
        self._last_flushed: dict = {}
        self._flush_scheduled = False
        # every Actor auto-creates a producer (reference actor.py:199-205);
        # an explicit later ECProducer(service) replaces it cleanly
        previous = getattr(service, "ec_producer", None)
        if previous is not None:
            previous.terminate()
        service.ec_producer = self
        service.add_tags(["ec=true"])
        # services opt into change notifications (e.g. Actor's live
        # log_level hook) by defining _ec_change_hook
        hook = getattr(service, "_ec_change_hook", None)
        if hook is not None:
            self.add_change_handler(hook)

    def handles(self, command: str) -> bool:
        return command in _EC_COMMANDS

    def add_change_handler(self, handler) -> None:
        """handler(command, name, value) on every local or remote change."""
        self._change_handlers.append(handler)

    # -- remote commands arriving on the control topic ---------------------

    def handle(self, command: str, parameters) -> None:
        if command == "share":
            self._handle_share(parameters)
        elif command in ("add", "update") and len(parameters) >= 2:
            self.update(parameters[0], parameters[1])
        elif command == "remove" and parameters:
            self.remove(parameters[0])

    def _handle_share(self, parameters) -> None:
        if not parameters:
            return
        response_topic = parameters[0]
        lease_time = parse_number(
            parameters[1] if len(parameters) > 1 else None,
            DEFAULT_LEASE_TIME)
        lease = self._leases.get(response_topic)
        if lease is not None:
            lease.extend(lease_time)
        else:
            self._leases[response_topic] = Lease(
                self.service.process.event, lease_time, response_topic,
                lease_expired_handler=self._lease_expired)
            self._publish_full_sync(response_topic)

    def _lease_expired(self, response_topic) -> None:
        self._leases.pop(response_topic, None)

    def _publish_full_sync(self, response_topic: str) -> None:
        publish = self.service.process.publish
        items = _flatten(self.share)
        publish(response_topic, generate("item_count", [len(items)]))
        for name, value in items:
            publish(response_topic, generate("add", [name, value]))
        publish(response_topic,
                generate("sync", [self.service.topic_state]))
        _share_counters()[0].inc(len(items) + 2)

    # -- local API ---------------------------------------------------------

    def get(self, name: str):
        return _get_nested(self.share, name)

    def update(self, name: str, value) -> None:
        _set_nested(self.share, name, value)
        # an immediate update SUPERSEDES any pending staged value for
        # the same key: a deferred delta flush must not later overwrite
        # this broadcast with a stale value, and the unchanged-scalar
        # suppression must judge future stages against THIS value
        self._staged.pop(name, None)
        if isinstance(value, (int, float, str, bool)):
            self._last_flushed[name] = value
        else:
            self._last_flushed.pop(name, None)
        self._broadcast("update", name, value)

    def remove(self, name: str) -> None:
        _remove_nested(self.share, name)
        self._staged.pop(name, None)   # a staged write must not resurrect it
        # forget the published shadow too: re-staging the key with its
        # pre-remove value must publish (consumers dropped the key)
        self._last_flushed.pop(name, None)
        self._broadcast("remove", name, None)

    def stage(self, name: str, value, force: bool = False) -> None:
        """Coalesced update: the local share (and change handlers) see
        the value NOW; the lease publishes fold into one delta payload
        per event-loop tick (flush rides the owning actor's mailbox, so
        a registration/stream-churn storm drains before the flush
        runs).  Use for high-churn keys (service_count, load gauges,
        telemetry summaries); update() stays the immediate path.
        `force` publishes the key even when its scalar value is
        unchanged -- heartbeat keys that refresh a consumer's
        staleness clock (ECConsumer.last_update) must hit the wire."""
        _set_nested(self.share, name, value)
        self._staged[name] = value
        if force:
            self._forced.add(name)
        _share_counters()[2].inc()
        for handler in self._change_handlers:
            handler("update", name, value)
        self._schedule_flush()

    def _schedule_flush(self) -> None:
        if self._flush_scheduled:
            return
        self._flush_scheduled = True
        post = getattr(self.service, "post_message", None)
        if post is not None:
            # the flush message queues BEHIND whatever churn is already
            # in the mailbox: one delta per drained burst
            post("_ec_flush_staged", [])
        else:
            event = self.service.process.event

            def fire():
                event.remove_timer_handler(fire)
                self.flush_staged()

            event.add_timer_handler(fire, 0.005)

    def flush_staged(self) -> None:
        self._flush_scheduled = False
        staged, self._staged = self._staged, {}
        forced, self._forced = self._forced, set()
        if not staged:
            return
        payload_dict = {}
        for name, value in staged.items():
            if (name not in forced
                    and isinstance(value, (int, float, str, bool))
                    and name in self._last_flushed
                    and self._last_flushed.get(name) == value):
                continue   # unchanged scalar: nothing to sync
            payload_dict[name] = value
            if isinstance(value, (int, float, str, bool)):
                self._last_flushed[name] = value
        if not payload_dict or not self._leases:
            return
        publish = self.service.process.publish
        payload = generate("delta", [payload_dict])
        publishes, delta_publishes, _ = _share_counters()
        for response_topic in list(self._leases):
            publish(response_topic, payload)
            publishes.inc()
        delta_publishes.inc()

    def _broadcast(self, command: str, name: str, value) -> None:
        publish = self.service.process.publish
        parameters = [name] if value is None else [name, value]
        payload = generate(command, parameters)
        publishes = _share_counters()[0]
        for response_topic in list(self._leases):
            publish(response_topic, payload)
            publishes.inc()
        for handler in self._change_handlers:
            handler(command, name, value)

    def terminate(self) -> None:
        for lease in self._leases.values():
            lease.terminate()
        self._leases.clear()
        self._staged.clear()


class ECConsumer:
    _ids = itertools.count()

    def __init__(self, process, cache: dict, producer_topic_path: str,
                 filter_expression: str = "*",
                 lease_time: float = DEFAULT_LEASE_TIME):
        self.process = process
        self.cache = cache
        self.producer_topic_path = producer_topic_path
        self.filter_expression = filter_expression
        self.lease_time = lease_time
        self.synced = False
        # monotonic timestamp of the LAST producer message (add/update/
        # remove/sync): consumers that must distinguish "live mirror"
        # from "stale snapshot of a wedged producer" (the serving
        # gateway's replica load view) age entries against this
        self.last_update: float | None = None
        self._expected_items = None
        self._change_handlers: list = []
        self.consumer_id = next(self._ids)
        self.response_topic = (
            f"{process.topic_path_process}/0/ec/{self.consumer_id}")
        process.add_message_handler(self._response_handler,
                                    self.response_topic)
        self._lease = Lease(
            process.event, lease_time, self.response_topic,
            lease_extend_handler=self._extend_share,
            automatic_extend=True)
        self._send_share_request()

    def add_change_handler(self, handler) -> None:
        self._change_handlers.append(handler)

    def _send_share_request(self) -> None:
        self.process.publish(
            f"{self.producer_topic_path}/control",
            generate("share", [self.response_topic, self.lease_time,
                               self.filter_expression]))

    def _extend_share(self, lease_time, lease_uuid) -> None:
        self._send_share_request()

    def _response_handler(self, topic: str, payload: str) -> None:
        from ..utils import parse, monotonic
        command, parameters = parse(payload)
        self.last_update = monotonic()
        if command == "item_count" and parameters:
            self._expected_items = parse_number(parameters[0], 0)
        elif command in ("add", "update") and len(parameters) >= 2:
            _set_nested(self.cache, parameters[0], parameters[1])
            self._notify(command, parameters[0], parameters[1])
        elif command == "delta" and parameters:
            # coalesced producer flush: one payload, many keys --
            # mirrored per key so change handlers see ordinary updates
            changes = parameters[0]
            if isinstance(changes, dict):
                for name, value in changes.items():
                    _set_nested(self.cache, name, value)
                    self._notify("update", name, value)
        elif command == "remove" and parameters:
            _remove_nested(self.cache, parameters[0])
            self._notify(command, parameters[0], None)
        elif command == "sync":
            self.synced = True
            self._notify("sync", None, None)

    def _notify(self, command, name, value) -> None:
        for handler in list(self._change_handlers):
            handler(self, command, name, value)

    def terminate(self) -> None:
        self._lease.terminate()
        self.process.remove_message_handler(self._response_handler,
                                            self.response_topic)


class ServicesCache:
    """Live mirror of the registrar's service table
    (reference share.py:477-637)."""

    def __init__(self, process):
        self.process = process
        self.services = Services()
        self.state = "empty"  # empty -> loading -> ready
        self._handlers: list[tuple[ServiceFilter, object]] = []
        self._registrar_topic = None
        self._response_topic = (
            f"{process.topic_path_process}/0/services_cache")
        process.connection.add_handler(self._connection_handler)

    def add_handler(self, handler, service_filter: ServiceFilter) -> None:
        """handler(command, ServiceFields) for "add"/"remove" events matching
        the filter; existing matches replay as "add" immediately."""
        self._handlers.append((service_filter, handler))
        for fields in self.services.filter_services(service_filter):
            handler("add", fields)

    def remove_handler(self, handler) -> None:
        self._handlers = [
            (service_filter, existing)
            for service_filter, existing in list(self._handlers)
            if existing is not handler]

    def _connection_handler(self, connection, state) -> None:
        if (state == ConnectionState.REGISTRAR
                and self.process.registrar is not None):
            registrar_topic = self.process.registrar["topic_path"]
            if registrar_topic == self._registrar_topic:
                return
            self._detach_handlers()
            self._registrar_topic = registrar_topic
            self.state = "loading"
            self.process.add_message_handler(
                self._event_handler, f"{registrar_topic}/out")
            self.process.add_message_handler(
                self._response_handler, self._response_topic)
            self.process.publish(
                f"{registrar_topic}/in",
                generate("share",
                         [self._response_topic, "*", "*", "*", "*", "*",
                          "*"]))
        elif state < ConnectionState.REGISTRAR:
            self._detach_handlers()
            self.state = "empty"
            self.services = Services()

    def _detach_handlers(self) -> None:
        """Unhook the previous registrar's topics (failover must not leave
        stale or duplicate subscriptions)."""
        if self._registrar_topic is not None:
            self.process.remove_message_handler(
                self._event_handler, f"{self._registrar_topic}/out")
            self.process.remove_message_handler(
                self._response_handler, self._response_topic)
            self._registrar_topic = None

    def _response_handler(self, topic: str, payload: str) -> None:
        from ..utils import parse
        command, parameters = parse(payload)
        if command == "add" and parameters:
            fields = ServiceFields.from_parameters(parameters)
            self.services.add_service(fields)
            self._notify("add", fields)
        elif command == "sync":
            self.state = "ready"

    def _event_handler(self, topic: str, payload: str) -> None:
        from ..utils import parse
        command, parameters = parse(payload)
        if command == "add" and parameters:
            fields = ServiceFields.from_parameters(parameters)
            self.services.add_service(fields)
            self._notify("add", fields)
        elif command == "remove" and parameters:
            for fields in self.services.remove_service(parameters[0]):
                self._notify("remove", fields)

    def _notify(self, command: str, fields: ServiceFields) -> None:
        # copy: handlers may remove themselves while being notified
        for service_filter, handler in list(self._handlers):
            if service_filter.matches(fields):
                handler(command, fields)


def services_cache_create_singleton(process) -> ServicesCache:
    """One shared registrar mirror per Process (reference
    share.py:639-656): repeated do_command/do_request/remote-element use
    must not accumulate one full cache (plus registrar subscriptions)
    per call.  Stored ON the process so the cache's lifetime is exactly
    the process's (no global registry pinning terminated processes)."""
    cache = getattr(process, "_services_cache_singleton", None)
    if cache is None:
        cache = ServicesCache(process)
        process._services_cache_singleton = cache
    return cache
