# In-process loopback broker: the hermetic default transport.
#
# The reference framework required a live mosquitto broker for every test and
# offered only a no-op "Castaway" fallback (reference:
# src/aiko_services/main/message/castaway.py:9-44) -- SURVEY.md section 4
# identifies the missing in-memory broker as the key testing gap.  This
# broker provides real MQTT semantics in-process: wildcard subscriptions,
# retained messages, and last-will-and-testament delivery on unclean
# disconnect, with deliveries dispatched from a dedicated broker thread so
# publish() never runs subscriber code inline (mirroring the paho network
# thread boundary, reference mqtt.py:125-127).

from __future__ import annotations

import itertools
import os
import queue
import threading
import time
import zlib

from .base import Transport, topic_matches
from .trie import TopicTrie

__all__ = ["LoopbackBroker", "LoopbackTransport", "get_broker", "reset_brokers"]

_BROKERS: dict[str, "LoopbackBroker"] = {}
_BROKERS_LOCK = threading.Lock()


def get_broker(name: str = "default") -> "LoopbackBroker":
    with _BROKERS_LOCK:
        broker = _BROKERS.get(name)
        if broker is None:
            broker = _BROKERS[name] = LoopbackBroker(name)
        return broker


def reset_brokers() -> None:
    """Tear down all brokers (test isolation)."""
    with _BROKERS_LOCK:
        brokers = list(_BROKERS.values())
        _BROKERS.clear()
    for broker in brokers:
        broker.shutdown()


class LoopbackBroker:
    """In-process broker with a topic-trie subscription index.

    Matching: a publish routes through a broker-side TopicTrie mapping
    each subscription pattern to its clients -- one trie walk per
    message instead of scanning every client's whole pattern set
    (`match_mode="linear"` keeps the historical O(clients x patterns)
    scan as the bench A/B arm; delivery semantics are identical: same
    messages, same per-topic order).  Clients with zero matching
    subscriptions are never woken (`broker.fanout_avoided`).

    Sharded dispatch: `shards` (or AIKO_BROKER_SHARDS) runs N dispatch
    workers with topic-hashed queues -- the SAME topic always lands on
    the SAME worker, so per-topic delivery order (and therefore the
    bit-identity discipline that rides per-stream order) is preserved
    while unrelated topics stop convoying each other.  Default 1: one
    thread, exactly the historical global ordering."""

    def __init__(self, name: str = "default", shards: int | None = None,
                 match_mode: str | None = None):
        self.name = name
        self._lock = threading.Lock()
        self._clients: list[LoopbackTransport] = []
        self._trie = TopicTrie()
        self._retained: dict[str, str] = {}
        self.match_mode = (match_mode
                           or os.environ.get("AIKO_BROKER_MATCH", "trie"))
        if shards is None:
            try:
                shards = int(os.environ.get("AIKO_BROKER_SHARDS", "1"))
            except ValueError:
                shards = 1
        self._shards = max(1, shards)
        self._alive = True
        # instruments resolved once (observe/metrics.py global
        # registry): the per-message cost is int adds + one bisect
        from ..observe.metrics import get_registry
        registry = get_registry()
        self._m_messages = registry.counter("broker.messages")
        self._m_delivered = registry.counter("broker.fanout_delivered")
        self._m_avoided = registry.counter("broker.fanout_avoided")
        self._m_match = registry.histogram("broker.match_s")
        # WAN fault plane (faults.py link_latency/link_loss/link_jitter):
        # fired-injection evidence the chaos arms reconcile against
        self._m_link_delays = registry.counter("faults.link_delays")
        self._m_link_drops = registry.counter("faults.link_drops")
        self._queues = [queue.Queue() for _ in range(self._shards)]
        self._threads = [
            threading.Thread(
                target=self._dispatch_loop, args=(shard_queue,),
                name=f"loopback-{name}-{index}", daemon=True)
            for index, shard_queue in enumerate(self._queues)]
        for thread in self._threads:
            thread.start()

    def _shard_of(self, topic: str) -> int:
        if self._shards == 1:
            return 0
        return zlib.crc32(topic.encode("utf-8")) % self._shards

    # -- client management -------------------------------------------------

    def attach(self, client: "LoopbackTransport") -> None:
        with self._lock:
            if client not in self._clients:
                self._clients.append(client)
                for pattern in client.subscription_snapshot():
                    self._trie.add(pattern, client)

    def detach(self, client: "LoopbackTransport", send_lwt: bool) -> None:
        with self._lock:
            if client in self._clients:
                self._clients.remove(client)
                self._trie.remove_value(client)
        if send_lwt:
            for topic, (payload, retain) in list(client.wills.items()):
                self.publish(topic, payload, retain=retain)

    def subscribe_client(self, client: "LoopbackTransport",
                         pattern: str) -> None:
        with self._lock:
            if client in self._clients:
                self._trie.add(pattern, client)

    def unsubscribe_client(self, client: "LoopbackTransport",
                           pattern: str) -> None:
        with self._lock:
            self._trie.discard(pattern, client)

    # -- pub/sub -----------------------------------------------------------

    def publish(self, topic: str, payload, retain: bool = False,
                origin=None) -> None:
        """`origin` is the WAN fault plane's provenance tag -- a
        (region, publish ordinal, client name) triple a chaos-labeled
        transport attaches so cross-region deliveries can consult the
        seeded link_latency/link_loss/link_jitter points at fan-out.
        None (every production publish) costs one is-None check."""
        payload = _to_text(payload)
        if retain:
            with self._lock:
                if payload == "":
                    self._retained.pop(topic, None)  # MQTT clears on empty
                else:
                    self._retained[topic] = payload
        self._queues[self._shard_of(topic)].put(
            ("publish", topic, payload, origin))

    def deliver_retained(self, client: "LoopbackTransport",
                         pattern: str) -> None:
        with self._lock:
            matches = [(topic, payload)
                       for topic, payload in self._retained.items()
                       if topic_matches(pattern, topic)]
        for topic, payload in matches:
            # retained replays shard by TOPIC too, so they order
            # consistently against live publishes on the same topic
            self._queues[self._shard_of(topic)].put(
                ("retained", topic, payload, client))

    def retained(self, topic: str):
        with self._lock:
            return self._retained.get(topic)

    # -- dispatch threads --------------------------------------------------

    def _dispatch_loop(self, shard_queue: queue.Queue) -> None:
        while True:
            item = shard_queue.get()
            if item is None:
                return
            if item[0] == "publish":
                _, topic, payload, origin = item
                matched = self._match_clients(topic)
                for client in matched:
                    if not client._connected:
                        continue
                    if origin is not None and not self._link_admits(
                            origin, client):
                        continue
                    client._deliver(topic, payload)
            else:  # retained delivery to one client
                _, topic, payload, client = item
                client._deliver(topic, payload)

    def _link_admits(self, origin, client) -> bool:
        """WAN fault plane: should this delivery cross its region link
        now, and after how long?  Consulted per (publish, subscriber)
        pair only when the publisher carried an `origin` tag AND the
        subscriber declares a different `chaos_region`; intra-region
        (or unlabeled) deliveries never reach the injector.  The draw
        keys on (link, subscriber, publish ordinal), so firing is
        identical across runs regardless of shard-thread timing.  A
        fired link_latency/link_jitter sleeps ON the dispatch shard --
        deliveries over one topic's shard serialize behind the slow
        link, which is exactly the convoy a congested WAN path
        creates."""
        src_region, publish_seq, _publisher = origin
        dst_region = client.chaos_region
        if dst_region is None or dst_region == src_region:
            return True
        from ..faults import get_injector
        injector = get_injector()
        if injector is None:
            return True
        scope = client.chaos_name or str(client.client_id)
        if injector.link_drop(src_region, dst_region,
                              frame_id=publish_seq, scope=scope):
            self._m_link_drops.inc()
            return False
        delay = injector.link_delay(src_region, dst_region,
                                    frame_id=publish_seq, scope=scope)
        if delay > 0:
            self._m_link_delays.inc()
            time.sleep(delay)
        return True

    def _match_clients(self, topic: str) -> list:
        """The clients this message must wake.  Trie-mode order is
        deterministic (client_id); per-client per-topic order -- the
        contract bit-identity rides on -- is identical in both modes,
        cross-client interleaving was never guaranteed."""
        start = time.perf_counter()
        if self.match_mode == "linear":
            # A/B reference arm: the historical per-client linear scan
            with self._lock:
                clients = list(self._clients)
            matched = [client for client in clients
                       if client._subscription_match_linear(topic)]
            total = len(clients)
        else:
            with self._lock:
                matched = self._trie.match(topic)
                total = len(self._clients)
            matched.sort(key=lambda client: client.client_id)
        self._m_match.record(time.perf_counter() - start)
        self._m_messages.inc()
        self._m_delivered.inc(len(matched))
        self._m_avoided.inc(total - len(matched))
        return matched

    def drain(self, timeout: float = 5.0) -> None:
        """Block until every queued delivery has been dispatched (tests)."""
        events = []
        for shard_queue in self._queues:
            done = threading.Event()
            events.append(done)
            shard_queue.put(("retained", None, None, _Sentinel(done)))
        deadline = time.monotonic() + timeout
        for done in events:
            done.wait(max(0.0, deadline - time.monotonic()))

    def shutdown(self) -> None:
        if self._alive:
            self._alive = False
            for shard_queue in self._queues:
                shard_queue.put(None)
            for thread in self._threads:
                thread.join(timeout=2)


class _Sentinel:
    def __init__(self, event):
        self._event = event

    def _deliver(self, topic, payload):
        self._event.set()


def _to_text(payload) -> str:
    if payload is None:
        return ""
    if isinstance(payload, bytes):
        return payload.decode("latin-1")
    return str(payload)


class LoopbackTransport(Transport):
    _ids = itertools.count()

    def __init__(self, on_message=None, broker: str = "default"):
        super().__init__(on_message)
        self._broker_name = broker
        self._broker: LoopbackBroker | None = None
        self._subscriptions: set[str] = set()
        self._lock = threading.Lock()
        self._connected = False
        self.client_id = next(self._ids)
        # Unlike MQTT's single will per connection, the loopback broker
        # supports one will PER TOPIC so a process-liveness will and a
        # registrar-election will can coexist in one process.
        self.wills: dict[str, tuple[str, bool]] = {}
        # chaos harness: name this client under the seeded
        # `broker_partition` fault point (faults.py).  None (the
        # default) costs one attribute check per publish
        self.chaos_name: str | None = None
        # WAN fault plane: the region this client lives in.  None (the
        # default) keeps every publish on the partition-only fast
        # path; set, each publish carries an (region, ordinal, name)
        # origin tag and consults the seeded `region_partition` point
        # with this client's OWN publish ordinal -- so one spec severs
        # every client in a region deterministically (faults.py)
        self.chaos_region: str | None = None
        self._publish_seq = 0
        self._partitioned = False
        self.partition_dropped = 0   # publishes lost to a partition

    def connect(self) -> None:
        self._broker = get_broker(self._broker_name)
        self._broker.attach(self)
        self._connected = True
        with self._lock:
            patterns = list(self._subscriptions)
        for pattern in patterns:
            self._broker.deliver_retained(self, pattern)

    def disconnect(self, send_lwt: bool = False) -> None:
        if self._broker is not None:
            self._broker.detach(self, send_lwt)
        self._connected = False

    def sever(self) -> None:
        """Abnormal death: drop off the broker WITHOUT a clean
        disconnect, firing every registered last-will (exactly what a
        real broker does when a client's TCP session dies).  Tests use
        this to crash a replica process mid-stream -- the registrar
        reaps it from the LWT "(absent)" notice and discovery-driven
        consumers (ServicesCache, the serving gateway) must converge."""
        self.disconnect(send_lwt=True)

    def partition(self) -> None:
        """Broker partition: traffic drops in BOTH directions and the
        broker -- having lost the client past its keepalive -- fires
        the last-wills, exactly the >1.5x-keepalive cutoff shape a
        real broker applies.  Unlike sever(), the CLIENT keeps its
        subscriptions and wills, so heal() restores service (and the
        process layer re-registers, Process.rejoin())."""
        if self._partitioned:
            return
        self._partitioned = True
        if self._broker is not None:
            self._broker.detach(self, send_lwt=True)

    def heal(self) -> None:
        """End a partition: re-attach to the broker and replay retained
        messages for every subscription (the reconnect contract)."""
        if not self._partitioned:
            return
        self._partitioned = False
        if self._broker is not None and self._connected:
            self._broker.attach(self)
            with self._lock:
                patterns = list(self._subscriptions)
            for pattern in patterns:
                self._broker.deliver_retained(self, pattern)

    @property
    def partitioned(self) -> bool:
        return self._partitioned

    def publish(self, topic: str, payload, retain: bool = False) -> None:
        if self._broker is None:
            raise RuntimeError("LoopbackTransport not connected")
        if self.chaos_name is not None and not self._partitioned:
            self._consult_partition_point()
        origin = None
        if self.chaos_region is not None:
            seq = self._publish_seq
            self._publish_seq += 1
            if not self._partitioned:
                self._consult_region_point(seq)
            origin = (self.chaos_region, seq,
                      self.chaos_name or str(self.client_id))
        if self._partitioned:
            # a partitioned client's publishes die on the wire (QoS 0
            # semantics); the counter is the reconcile evidence
            self.partition_dropped += 1
            return
        self._broker.publish(topic, payload, retain, origin=origin)

    def _consult_partition_point(self) -> None:
        """Seeded chaos: one `broker_partition` draw per publish
        (faults.py; frame=k partitions on this client's k-th publish,
        ms= schedules the heal)."""
        from ..faults import get_injector
        injector = get_injector()
        if injector is None:
            return
        duration = injector.broker_partition(self.chaos_name)
        if duration == 0.0:
            return
        self.partition()
        if duration > 0:
            timer = threading.Timer(duration, self.heal)
            timer.daemon = True
            timer.start()

    def _consult_region_point(self, seq: int) -> None:
        """Seeded chaos: one `region_partition` draw per publish for a
        region-labeled client (faults.py; node= the region, frame=k
        severs at THIS client's k-th publish so the whole region dies
        as a unit, ms= schedules the heal)."""
        from ..faults import get_injector
        injector = get_injector()
        if injector is None:
            return
        duration = injector.region_partition(
            self.chaos_region, frame_id=seq,
            scope=self.chaos_name or str(self.client_id))
        if duration == 0.0:
            return
        self.partition()
        if duration > 0:
            timer = threading.Timer(duration, self.heal)
            timer.daemon = True
            timer.start()

    def subscribe(self, topic: str) -> None:
        with self._lock:
            if topic in self._subscriptions:
                return
            self._subscriptions.add(topic)
        if self._broker is not None and self._connected:
            # broker-side routing index: only attached clients index
            # (subscribe_client checks membership, so a partitioned
            # client's new patterns wait for heal()'s re-attach)
            self._broker.subscribe_client(self, topic)
            self._broker.deliver_retained(self, topic)

    def unsubscribe(self, topic: str) -> None:
        with self._lock:
            self._subscriptions.discard(topic)
        if self._broker is not None:
            self._broker.unsubscribe_client(self, topic)

    def subscription_snapshot(self) -> list[str]:
        with self._lock:
            return list(self._subscriptions)

    def set_last_will_and_testament(
            self, topic: str, payload, retain: bool = False) -> None:
        self.wills[topic] = (_to_text(payload), retain)

    def clear_last_will_and_testament(self, topic: str) -> None:
        self.wills.pop(topic, None)

    @property
    def connected(self) -> bool:
        return self._connected

    # -- broker-side delivery (broker dispatch thread) ---------------------
    #
    # Routing moved broker-side: the broker's TopicTrie picks the
    # matched clients and calls _deliver directly, so subscribed-set
    # scans no longer ride the per-message hot path at all.

    def _subscription_match_linear(self, topic: str) -> bool:
        """The historical O(patterns) scan -- kept as the broker's
        `match_mode="linear"` A/B reference arm."""
        if not self._connected:
            return False
        with self._lock:
            return any(topic_matches(pattern, topic)
                       for pattern in self._subscriptions)

    def _deliver(self, topic: str, payload: str) -> None:
        if self.on_message is not None:
            try:
                self.on_message(topic, payload)
            except Exception:  # broker thread must survive handler errors
                import traceback
                traceback.print_exc()
