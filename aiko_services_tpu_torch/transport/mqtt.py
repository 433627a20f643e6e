# MQTT transport: paho-mqtt when installed, the in-repo MQTT 3.1.1
# client (transport/minimqtt.py, real sockets) otherwise.
#
# Capability parity with the reference MQTT transport (reference:
# src/aiko_services/main/message/mqtt.py:65-289): background network thread,
# LWT set before connect, TLS + username/password (TLS requires paho),
# wildcard subscriptions, bounded waits for connect.  With neither paho
# nor a broker host configured, the loopback broker remains the default
# transport.

from __future__ import annotations

import threading

from .base import Transport
from ..utils import get_mqtt_configuration, get_logger

__all__ = ["MqttTransport", "mqtt_available"]

try:
    import paho.mqtt.client as _paho
    _PAHO_ERROR = None
except ImportError as _error:
    # self-contained fallback: the same wire protocol over stdlib
    # sockets -- MQTT deployment no longer needs the dependency
    from . import minimqtt as _paho
    _PAHO_ERROR = _error

_LOGGER = get_logger("mqtt")
_CONNECT_TIMEOUT_SECONDS = 10.0


def mqtt_available() -> bool:
    """True when an MQTT client implementation is available -- always,
    since the in-repo minimqtt fallback ships with the package."""
    return True


def paho_available() -> bool:
    """True when the real paho-mqtt is importable (required for TLS
    brokers; the minimqtt fallback raises on tls_set)."""
    return _PAHO_ERROR is None


class MqttTransport(Transport):
    def __init__(self, on_message=None, configuration: dict | None = None):
        super().__init__(on_message)
        self._configuration = configuration or get_mqtt_configuration()
        self._connected_event = threading.Event()
        self._subscriptions: set[str] = set()
        self._lock = threading.Lock()
        self.lwt_topic = None
        self.lwt_payload = None
        self.lwt_retain = False
        self._client = None

    def _build_client(self):
        client = _paho.Client(
            callback_api_version=_paho.CallbackAPIVersion.VERSION2)
        client.on_connect = self._on_connect
        client.on_disconnect = self._on_disconnect
        client.on_message = self._on_message
        configuration = self._configuration
        if configuration.get("username"):
            client.username_pw_set(
                configuration["username"], configuration.get("password"))
        if configuration.get("tls"):
            client.tls_set()
        if self.lwt_topic is not None:
            client.will_set(
                self.lwt_topic, self.lwt_payload, retain=self.lwt_retain)
        return client

    def connect(self) -> None:
        self._client = self._build_client()
        configuration = self._configuration
        self._client.connect_async(
            configuration["host"], configuration["port"], keepalive=60)
        self._client.loop_start()  # paho network thread
        if not self._connected_event.wait(_CONNECT_TIMEOUT_SECONDS):
            raise TimeoutError(
                f"MQTT connect timed out: {configuration['host']}:"
                f"{configuration['port']}")

    def disconnect(self, send_lwt: bool = False) -> None:
        if self._client is None:
            return
        if send_lwt and self.lwt_topic is not None:
            self._client.publish(
                self.lwt_topic, self.lwt_payload, retain=self.lwt_retain)
        self._client.disconnect()
        self._client.loop_stop()
        self._connected_event.clear()

    def publish(self, topic, payload, retain=False) -> None:
        self._client.publish(topic, payload, retain=retain)

    def subscribe(self, topic) -> None:
        with self._lock:
            self._subscriptions.add(topic)
        if self._connected_event.is_set():
            self._client.subscribe(topic)

    def unsubscribe(self, topic) -> None:
        with self._lock:
            self._subscriptions.discard(topic)
        if self._connected_event.is_set():
            self._client.unsubscribe(topic)

    def set_last_will_and_testament(self, topic, payload, retain=False):
        # Changing the LWT requires a reconnect cycle (MQTT protocol level;
        # the reference does the same disconnect/reconnect dance,
        # reference mqtt.py:192-201).
        self.lwt_topic = topic
        self.lwt_payload = payload
        self.lwt_retain = retain
        if self._client is not None and self._connected_event.is_set():
            self.disconnect()
            self.connect()

    def clear_last_will_and_testament(self, topic: str) -> None:
        # MQTT supports a single will per connection
        if self.lwt_topic == topic:
            self.lwt_topic = None
            self.lwt_payload = None
            if self._client is not None and self._connected_event.is_set():
                self.disconnect()
                self.connect()

    @property
    def connected(self) -> bool:
        return self._connected_event.is_set()

    # -- paho callbacks (network thread) -----------------------------------

    def _on_connect(self, client, userdata, flags, reason_code, properties):
        with self._lock:
            patterns = list(self._subscriptions)
        for pattern in patterns:
            client.subscribe(pattern)
        self._connected_event.set()

    def _on_disconnect(self, client, userdata, flags, reason_code,
                       properties):
        self._connected_event.clear()

    def _on_message(self, client, userdata, message):
        if self.on_message is not None:
            try:
                payload = message.payload.decode("latin-1")
                self.on_message(message.topic, payload)
            except Exception:
                _LOGGER.exception("on_message handler failed")
