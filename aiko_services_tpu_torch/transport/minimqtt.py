# Self-contained MQTT 3.1.1 over stdlib sockets: a paho-compatible
# client plus a tiny embedded broker.
#
# Why: the reference deploys over a real MQTT broker (reference:
# src/aiko_services/main/message/mqtt.py:65-289 -- paho client, LWT set
# before CONNECT, retained service announcements, wildcard
# subscriptions), but neither paho-mqtt nor mosquitto exist in this
# image, so until round 4 the MQTT transport had only ever executed
# against an in-repo fake.  This module closes that gap with the wire
# protocol itself: CONNECT (with will), CONNACK, PUBLISH (QoS 0, QoS 1
# acknowledged), SUBSCRIBE/SUBACK (+ retained replay), UNSUBSCRIBE,
# PINGREQ/PINGRESP, DISCONNECT, and broker-side will delivery on
# abnormal socket loss.
#
# The `Client` class exposes the paho v2 callback surface MqttTransport
# already speaks (transport/mqtt.py), so the SAME transport code runs
# over real TCP by assigning `transport.mqtt._paho = minimqtt`.

from __future__ import annotations

import os as _os
import socket
import struct
import threading
import time as _time

from ..observe.metrics import get_registry
from ..utils import get_logger
from .base import topic_matches
from .trie import TopicTrie

__all__ = ["CallbackAPIVersion", "Client", "MiniMqttBroker"]

_LOGGER = get_logger("minimqtt")

CONNECT, CONNACK, PUBLISH, PUBACK = 1, 2, 3, 4
SUBSCRIBE, SUBACK, UNSUBSCRIBE, UNSUBACK = 8, 9, 10, 11
PINGREQ, PINGRESP, DISCONNECT = 12, 13, 14


class CallbackAPIVersion:  # paho-compatible constant
    VERSION2 = 2


# -- wire encoding -----------------------------------------------------------

def _encode_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        digit = value % 128
        value //= 128
        out.append(digit | (0x80 if value else 0))
        if not value:
            return bytes(out)


def _encode_string(text) -> bytes:
    data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
    return struct.pack(">H", len(data)) + data


def _packet(packet_type: int, flags: int, body: bytes) -> bytes:
    return (bytes([(packet_type << 4) | flags])
            + _encode_varint(len(body)) + body)


def _read_exact(sock, count: int) -> bytes | None:
    data = b""
    while len(data) < count:
        chunk = sock.recv(count - len(data))
        if not chunk:
            return None
        data += chunk
    return data


def _read_packet(sock):
    """(type, flags, body) or None on EOF."""
    first = _read_exact(sock, 1)
    if first is None:
        return None
    length, shift = 0, 0
    while True:
        byte = _read_exact(sock, 1)
        if byte is None:
            return None
        length |= (byte[0] & 0x7F) << shift
        if not byte[0] & 0x80:
            break
        shift += 7
    body = _read_exact(sock, length) if length else b""
    if body is None:
        return None
    return first[0] >> 4, first[0] & 0x0F, body


class _Reader:
    """Cursor over a packet body."""

    def __init__(self, body: bytes):
        self.body = body
        self.at = 0

    def u16(self) -> int:
        value = struct.unpack_from(">H", self.body, self.at)[0]
        self.at += 2
        return value

    def chunk(self, count: int) -> bytes:
        data = self.body[self.at:self.at + count]
        self.at += count
        return data

    def string(self) -> bytes:
        return self.chunk(self.u16())

    @property
    def rest(self) -> bytes:
        return self.body[self.at:]


# -- embedded broker ---------------------------------------------------------

class _Session:
    def __init__(self, sock, address):
        self.sock = sock
        self.address = address
        self.client_id = ""
        self.filters: list[str] = []
        self.will = None            # (topic, payload bytes, retain)
        self.clean_close = False
        self.will_sent = False
        self.write_lock = threading.Lock()

    def send(self, data: bytes) -> bool:
        try:
            with self.write_lock:
                self.sock.sendall(data)
            return True
        except OSError:
            return False


class MiniMqttBroker:
    """Minimal in-process MQTT 3.1.1 broker: one thread per client,
    retained store, wildcard routing, will delivery on abnormal loss.
    Not a production broker -- it exists so the transport stack can be
    exercised over REAL sockets in images without mosquitto."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._server = socket.create_server((host, port))
        self.host = host
        self.port = self._server.getsockname()[1]
        self.retained: dict[str, bytes] = {}
        self._sessions: list[_Session] = []
        self._lock = threading.Lock()
        # trie-indexed routing (transport/trie.py): one walk over the
        # topic's levels per publish instead of every session's whole
        # filter list; AIKO_BROKER_MATCH=linear keeps the historical
        # scan as the A/B reference arm (same instruments either way)
        self._trie = TopicTrie()
        self.match_mode = _os.environ.get("AIKO_BROKER_MATCH", "trie")
        registry = get_registry()
        self._m_messages = registry.counter("broker.messages")
        self._m_delivered = registry.counter("broker.fanout_delivered")
        self._m_avoided = registry.counter("broker.fanout_avoided")
        self._m_match = registry.histogram("broker.match_s")
        self._running = True
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="minimqtt-broker", daemon=True)
        self._accept_thread.start()

    def stop(self) -> None:
        self._running = False
        try:
            self._server.close()
        except OSError:
            pass
        with self._lock:
            sessions = list(self._sessions)
        for session in sessions:
            try:
                session.sock.close()
            except OSError:
                pass

    def drop_client(self, client_id: str) -> None:
        """Abort a client's socket WITHOUT a DISCONNECT (test hook for
        abnormal loss); the will publishes synchronously before
        returning."""
        with self._lock:
            session = next((s for s in self._sessions
                            if s.client_id == client_id), None)
        if session is None:
            return
        self._publish_will(session)
        try:
            session.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    # -- internals --

    def _accept_loop(self) -> None:
        while self._running:
            try:
                sock, address = self._server.accept()
            except OSError:
                return
            session = _Session(sock, address)
            with self._lock:
                self._sessions.append(session)
            threading.Thread(target=self._serve, args=(session,),
                             name="minimqtt-session", daemon=True).start()

    def _serve(self, session: _Session) -> None:
        try:
            while True:
                packet = _read_packet(session.sock)
                if packet is None:
                    break
                if not self._handle(session, *packet):
                    break
        except OSError:
            pass
        finally:
            if not session.clean_close:
                self._publish_will(session)
            with self._lock:
                if session in self._sessions:
                    self._sessions.remove(session)
                self._trie.remove_value(session)
            try:
                session.sock.close()
            except OSError:
                pass

    def _handle(self, session: _Session, packet_type: int, flags: int,
                body: bytes) -> bool:
        reader = _Reader(body)
        if packet_type == CONNECT:
            reader.string()                      # protocol name
            reader.chunk(1)                      # protocol level
            connect_flags = reader.chunk(1)[0]
            reader.u16()                         # keepalive
            session.client_id = reader.string().decode("utf-8", "replace")
            if connect_flags & 0x04:             # will flag
                will_topic = reader.string().decode("utf-8", "replace")
                will_payload = reader.string()
                session.will = (will_topic, will_payload,
                                bool(connect_flags & 0x20))
            if connect_flags & 0x80:
                reader.string()                  # username
            if connect_flags & 0x40:
                reader.string()                  # password
            session.send(_packet(CONNACK, 0, b"\x00\x00"))
        elif packet_type == PUBLISH:
            qos = (flags >> 1) & 0x03
            retain = bool(flags & 0x01)
            topic = reader.string().decode("utf-8", "replace")
            if qos:
                packet_id = reader.u16()
                session.send(_packet(PUBACK, 0,
                                     struct.pack(">H", packet_id)))
            payload = reader.rest
            self._route(topic, payload, retain)
        elif packet_type == SUBSCRIBE:
            packet_id = reader.u16()
            granted = bytearray()
            new_filters = []
            while reader.at < len(body):
                topic_filter = reader.string().decode("utf-8", "replace")
                reader.chunk(1)                  # requested qos
                if topic_filter not in session.filters:
                    session.filters.append(topic_filter)
                    with self._lock:
                        self._trie.add(topic_filter, session)
                new_filters.append(topic_filter)
                granted.append(0x00)
            session.send(_packet(SUBACK, 0,
                                 struct.pack(">H", packet_id) + granted))
            # retained replay AFTER SUBACK (3.1.1 normative behavior)
            for topic, payload in list(self.retained.items()):
                if any(topic_matches(f, topic) for f in new_filters):
                    session.send(self._publish_packet(topic, payload,
                                                      retain=True))
        elif packet_type == UNSUBSCRIBE:
            packet_id = reader.u16()
            while reader.at < len(body):
                topic_filter = reader.string().decode("utf-8", "replace")
                if topic_filter in session.filters:
                    session.filters.remove(topic_filter)
                    with self._lock:
                        self._trie.discard(topic_filter, session)
            session.send(_packet(UNSUBACK, 0,
                                 struct.pack(">H", packet_id)))
        elif packet_type == PINGREQ:
            session.send(_packet(PINGRESP, 0, b""))
        elif packet_type == DISCONNECT:
            session.clean_close = True           # will discarded
            return False
        return True

    @staticmethod
    def _publish_packet(topic: str, payload: bytes,
                        retain: bool = False) -> bytes:
        return _packet(PUBLISH, 0x01 if retain else 0x00,
                       _encode_string(topic) + payload)

    def _route(self, topic: str, payload: bytes, retain: bool) -> None:
        if retain:
            if payload:
                self.retained[topic] = payload
            else:
                self.retained.pop(topic, None)  # empty payload clears
        start = _time.perf_counter()
        if self.match_mode == "linear":
            with self._lock:
                sessions = list(self._sessions)
                total = len(sessions)
            matched = [session for session in sessions
                       if any(topic_matches(f, topic)
                              for f in session.filters)]
        else:
            with self._lock:
                matched = self._trie.match(topic)
                total = len(self._sessions)
            matched.sort(key=id)   # deterministic within one route
        self._m_match.record(_time.perf_counter() - start)
        self._m_messages.inc()
        self._m_delivered.inc(len(matched))
        self._m_avoided.inc(total - len(matched))
        packet = self._publish_packet(topic, payload)
        for session in matched:
            session.send(packet)

    def _publish_will(self, session: _Session) -> None:
        if session.will is None or session.will_sent:
            return
        session.will_sent = True
        topic, payload, retain = session.will
        self._route(topic, payload, retain)


# -- paho-compatible client --------------------------------------------------

class _Message:
    __slots__ = ("topic", "payload")

    def __init__(self, topic: str, payload: bytes):
        self.topic = topic
        self.payload = payload


class Client:
    """paho-v2-compatible subset speaking real MQTT 3.1.1 over a
    socket: exactly the surface transport/mqtt.py uses, plus flush()
    (a PINGREQ round-trip -- everything written before it has been
    processed by the broker, and every self-delivery it triggered has
    been dispatched, because the reader handles those PUBLISHes before
    the PINGRESP on the same TCP stream)."""

    _counter = 0
    _counter_lock = threading.Lock()

    def __init__(self, callback_api_version=CallbackAPIVersion.VERSION2):
        with Client._counter_lock:
            Client._counter += 1
            self._client_id = f"minimqtt-{Client._counter}"
        self.on_connect = None
        self.on_disconnect = None
        self.on_message = None
        self._username = None
        self._password = None
        self._will = None
        self._sock = None
        self._thread = None
        self._connected = threading.Event()
        # ping accounting: flush() must wait for ITS OWN PINGREQ's
        # response, not any PINGRESP (a keepalive ping answered just
        # after flush starts must not satisfy the barrier), so pings
        # are counted and flush waits for acked >= the count it
        # observed at send time; PINGRESPs arrive in request order
        self._ping_cond = threading.Condition()
        self._ping_sent = 0
        self._ping_acked = 0
        self._ping_gen = 0  # bumped per connection loss: aborts waiters
        self._packet_id = 0
        self._write_lock = threading.Lock()
        self._host = None
        self._port = None
        self._keepalive = 60
        self._closing = False
        # offline publish queue: during a broker outage publishes park
        # here and replay on reconnect (after resubscription), instead
        # of silently vanishing with rc=4.  BOUNDED -- a long outage
        # under steady publish load must not grow memory without limit
        # -- drop-OLDEST (the stalest state update is the least
        # valuable), every drop counted on `mqtt.offline_dropped` so
        # queued == replayed + dropped + len(pending) reconciles
        import os as _os
        try:
            self._offline_max = int(
                _os.environ.get("AIKO_MQTT_OFFLINE_MAX", 256))
        except ValueError:
            self._offline_max = 256
        self._offline: list = []      # (topic, payload bytes, retain)
        self._offline_lock = threading.Lock()

    # paho surface ----------------------------------------------------------

    def username_pw_set(self, username, password=None) -> None:
        self._username = username
        self._password = password

    def tls_set(self) -> None:
        raise NotImplementedError(
            "minimqtt has no TLS; install paho-mqtt for TLS brokers")

    def will_set(self, topic, payload=None, retain=False) -> None:
        data = (payload.encode("utf-8") if isinstance(payload, str)
                else bytes(payload or b""))
        self._will = (topic, data, retain)

    def connect_async(self, host, port, keepalive=60) -> None:
        self._host, self._port = host, int(port)
        self._keepalive = max(int(keepalive), 5)

    def loop_start(self) -> None:
        if self._thread is not None:
            return
        self._closing = False
        self._thread = threading.Thread(
            target=self._network_loop, name="minimqtt-client", daemon=True)
        self._thread.start()

    def loop_stop(self) -> None:
        self._closing = True
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        thread, self._thread = self._thread, None
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=2.0)

    def disconnect(self) -> None:
        self._closing = True   # a deliberate disconnect stops reconnects
        sock = self._sock
        if sock is not None and self._connected.is_set():
            try:
                with self._write_lock:
                    sock.sendall(_packet(DISCONNECT, 0, b""))
            except OSError:
                pass
        self._connected.clear()
        if self.on_disconnect is not None:
            self.on_disconnect(self, None, None, 0, None)

    def publish(self, topic, payload=None, retain=False) -> int:
        data = (payload.encode("utf-8") if isinstance(payload, str)
                else bytes(payload or b""))
        if not self._connected.is_set() and not self._closing:
            self._offline_enqueue(topic, data, retain)
            return 0
        flags = 0x01 if retain else 0x00
        packet = _packet(PUBLISH, flags, _encode_string(topic) + data)
        result = self._send(packet)
        if result == 0:
            metrics = get_registry()
            metrics.counter("mqtt.publish_count").inc()
            metrics.counter("mqtt.publish_bytes").inc(len(packet))
        elif not self._closing:
            # the socket died under us (outage starting): park it with
            # the offline queue rather than dropping one message on the
            # disconnect boundary
            self._offline_enqueue(topic, data, retain)
            result = 0
        return result

    def _offline_enqueue(self, topic, data: bytes, retain: bool) -> None:
        if self._offline_max <= 0:
            get_registry().counter("mqtt.offline_dropped").inc()
            return
        with self._offline_lock:
            self._offline.append((topic, data, retain))
            dropped = len(self._offline) - self._offline_max
            if dropped > 0:
                del self._offline[:dropped]
            else:
                dropped = 0
        metrics = get_registry()
        metrics.counter("mqtt.offline_queued").inc()
        if dropped:
            metrics.counter("mqtt.offline_dropped").inc(dropped)

    def _offline_flush(self) -> None:
        """Replay parked publishes after a reconnect -- called AFTER
        on_connect so subscriptions are restored first and replayed
        state lands on a fully resubscribed session."""
        with self._offline_lock:
            pending, self._offline = self._offline, []
        if not pending:
            return
        replayed = 0
        for index, (topic, data, retain) in enumerate(pending):
            flags = 0x01 if retain else 0x00
            packet = _packet(PUBLISH, flags, _encode_string(topic) + data)
            if self._send(packet) == 0:
                replayed += 1
            else:
                # connection died again mid-flush: re-park the rest in
                # order (ahead of anything queued meanwhile)
                with self._offline_lock:
                    self._offline = pending[index:] + self._offline
                break
        if replayed:
            metrics = get_registry()
            metrics.counter("mqtt.offline_replayed").inc(replayed)
            metrics.counter("mqtt.publish_count").inc(replayed)

    def subscribe(self, topic) -> int:
        self._packet_id = (self._packet_id % 0xFFFF) + 1
        body = (struct.pack(">H", self._packet_id)
                + _encode_string(topic) + b"\x00")
        return self._send(_packet(SUBSCRIBE, 0x02, body))

    def unsubscribe(self, topic) -> int:
        self._packet_id = (self._packet_id % 0xFFFF) + 1
        body = struct.pack(">H", self._packet_id) + _encode_string(topic)
        return self._send(_packet(UNSUBSCRIBE, 0x02, body))

    # extras ----------------------------------------------------------------

    def flush(self, timeout: float = 5.0) -> bool:
        """PINGREQ round-trip: barrier over everything this client sent
        AND every delivery the broker wrote to this socket before the
        PINGRESP.  Waits for the response to THIS flush's own PINGREQ
        (counted, not an any-ping event): a PINGRESP answering an
        earlier keepalive ping cannot release the barrier early."""
        with self._ping_cond:
            generation = self._ping_gen
            self._ping_sent += 1
            target = self._ping_sent
        if self._send(_packet(PINGREQ, 0, b"")) != 0:
            with self._ping_cond:
                # roll the phantom count back: a ping that never hit
                # the wire gets no PINGRESP, and (unlike the keepalive
                # path, whose send failure is followed by the read
                # loop's connection-loss resync) nothing else would
                # ever clear the deficit -- every later flush() would
                # time out until the next disconnect
                if self._ping_gen == generation:
                    self._ping_sent -= 1
            return False
        deadline = _time.monotonic() + timeout
        with self._ping_cond:
            while (self._ping_acked < target
                   and self._ping_gen == generation):
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    return False
                self._ping_cond.wait(remaining)
            # a connection loss resyncs acked=sent, which would satisfy
            # the count -- the generation check keeps a voided barrier
            # from reporting success
            return self._ping_gen == generation

    # internals -------------------------------------------------------------

    def _send(self, data: bytes) -> int:
        """Write a packet; SOFT-fails like paho (returns a non-zero rc
        instead of raising) -- the runtime publishes state from paths
        that never expected transport exceptions, and the reconnect
        loop replays subscriptions once the broker returns."""
        sock = self._sock
        if sock is None:
            return 4                             # MQTT_ERR_NO_CONN
        try:
            with self._write_lock:
                sock.sendall(data)
            return 0
        except OSError as error:
            _LOGGER.debug("minimqtt send failed: %s", error)
            return 4

    def _connect_body(self) -> bytes:
        connect_flags = 0x02                     # clean session
        tail = _encode_string(self._client_id)
        if self._will is not None:
            topic, payload, retain = self._will
            connect_flags |= 0x04 | (0x20 if retain else 0)
            tail += _encode_string(topic)
            tail += struct.pack(">H", len(payload)) + payload
        if self._username is not None:
            connect_flags |= 0x80
            tail += _encode_string(self._username)
            if self._password is not None:
                connect_flags |= 0x40
                tail += _encode_string(self._password)
        # advertise the REAL keepalive: a hardcoded 60 here with a
        # client pinging at self._keepalive/2 lets a real broker's
        # 1.5x-keepalive idle cutoff (90 s) fire before the first ping
        # whenever keepalive > 90
        return (_encode_string("MQTT") + bytes([4, connect_flags])
                + struct.pack(">H", min(self._keepalive, 0xFFFF)) + tail)

    def _network_loop(self) -> None:
        """Connect / read / keepalive / reconnect, paho-style: recv
        timeouts at keepalive/2 drive PINGREQ so a real broker's
        1.5x-keepalive idle cutoff never fires on a healthy client, and
        a lost connection retries with backoff, replaying on_connect
        (which resubscribes) when the broker returns."""
        backoff = 0.5
        while not self._closing:
            try:
                sock = socket.create_connection(
                    (self._host, self._port), timeout=5.0)
                sock.settimeout(self._keepalive / 2.0)
                self._sock = sock
                with self._write_lock:
                    sock.sendall(_packet(CONNECT, 0, self._connect_body()))
                backoff = 0.5
                self._read_until_closed(sock)
            except OSError as error:
                if not self._closing:
                    _LOGGER.debug("minimqtt connect failed: %s", error)
            was_connected = self._connected.is_set()
            if was_connected and not self._closing:
                # abnormal loss about to retry: the reconnect rate is
                # the first thing to look at on a flapping deployment
                get_registry().counter("mqtt.reconnects").inc()
            self._connected.clear()
            with self._ping_cond:
                # outstanding pings died with the socket: resync the
                # counters and wake flush() waiters so they fail fast
                # instead of timing out on a response that cannot come
                self._ping_gen += 1
                self._ping_acked = self._ping_sent
                self._ping_cond.notify_all()
            if self._closing:
                return
            if was_connected and self.on_disconnect is not None:
                self.on_disconnect(self, None, None, 1, None)
            _time.sleep(backoff)
            backoff = min(backoff * 2, 8.0)

    def _send_keepalive_ping(self) -> None:
        """Counted keepalive PINGREQ, with the same rollback as flush():
        a ping that never hit the wire gets no PINGRESP, so the count
        must not stand.  The read loop's connection-loss resync USUALLY
        covers a failed send, but a transient failure on a socket that
        then recovers would otherwise leave flush() waiters one
        PINGRESP short forever."""
        with self._ping_cond:
            self._ping_sent += 1
            generation = self._ping_gen
        if self._send(_packet(PINGREQ, 0, b"")) != 0:
            with self._ping_cond:
                if self._ping_gen == generation:
                    self._ping_sent -= 1

    def _read_until_closed(self, sock) -> None:
        while not self._closing:
            try:
                packet = _read_packet(sock)
            except socket.timeout:
                self._send_keepalive_ping()
                continue
            if packet is None:
                return
            packet_type, _flags_unused, body = packet
            if packet_type == CONNACK:
                # replay the parked backlog BEFORE opening the direct
                # publish path: a fresh publish racing the flush could
                # otherwise hit the wire first and have a STALE parked
                # retained value replayed over it.  Publishers during
                # the first drain still park (not yet connected); the
                # second drain picks those up after the gate opens
                self._offline_flush()
                self._connected.set()
                self._offline_flush()
                get_registry().counter("mqtt.connects").inc()
                if self.on_connect is not None:
                    self.on_connect(self, None, None, 0, None)
            elif packet_type == PUBLISH:
                metrics = get_registry()
                metrics.counter("mqtt.receive_count").inc()
                metrics.counter("mqtt.receive_bytes").inc(len(body))
                reader = _Reader(body)
                topic = reader.string().decode("utf-8", "replace")
                if self.on_message is not None:
                    self.on_message(self, None,
                                    _Message(topic, reader.rest))
            elif packet_type == PINGRESP:
                with self._ping_cond:
                    self._ping_acked += 1
                    self._ping_cond.notify_all()
            # PUBACK/SUBACK/UNSUBACK: fire-and-forget acks
