# Environment configuration.
#
# Capability parity with the reference configuration module (reference:
# src/aiko_services/main/utilities/configuration.py:91-186): namespace, host
# identity, and transport endpoint come from AIKO_* environment variables with
# sane localhost defaults.  The TPU framework adds mesh/topology variables and
# defaults the transport to the in-process loopback broker so broker-less
# hermetic runs are the default rather than a fallback.

from __future__ import annotations

import os
import socket

__all__ = [
    "get_namespace", "get_hostname", "get_pid", "get_transport_configuration",
    "get_mqtt_configuration", "get_bool_env", "truthy", "probe_tcp",
    "get_mqtt_host",
    "BootstrapResponder",
]

DEFAULT_NAMESPACE = "aiko"
BOOTSTRAP_PORT = 4149  # reference configuration.py:168 (UDP MCU bootstrap)


def get_namespace() -> str:
    return os.environ.get("AIKO_NAMESPACE", DEFAULT_NAMESPACE)


def get_hostname() -> str:
    hostname = os.environ.get("AIKO_HOSTNAME")
    if hostname:
        return hostname
    return socket.gethostname().split(".")[0].lower()


def get_pid() -> str:
    return str(os.getpid())


def truthy(value) -> bool:
    """Normalize wire/share/env boolean forms: EC updates and S-expr
    payloads deliver strings ("true"/"false"), Python code passes bools."""
    if isinstance(value, str):
        return value.strip().lower() in ("1", "true", "yes", "on", "all")
    return bool(value)


def get_bool_env(name: str, default: bool = False) -> bool:
    value = os.environ.get(name)
    if value is None:
        return default
    return truthy(value)


def get_mqtt_configuration(port: int | None = None) -> dict:
    """MQTT endpoint settings (reference configuration.py:101-114).

    AIKO_MQTT_HOST names a broker directly (no probe -- tests and fixed
    deployments).  Otherwise, when AIKO_MQTT_HOSTS lists candidates, the
    first one answering a TCP connect probe wins (reference
    configuration.py:121-139); nothing reachable falls back to
    localhost.  `port` pins the probe/endpoint port (default
    AIKO_MQTT_PORT)."""
    if port is None:
        port = int(os.environ.get("AIKO_MQTT_PORT", "1883"))
    host = os.environ.get("AIKO_MQTT_HOST")
    if not host and os.environ.get("AIKO_MQTT_HOSTS"):
        host = get_mqtt_host(port=int(port))
    return {
        "host": host or "localhost",
        "port": int(port),
        "transport": os.environ.get("AIKO_MQTT_TRANSPORT", "tcp"),
        "username": os.environ.get("AIKO_USERNAME"),
        "password": os.environ.get("AIKO_PASSWORD"),
        "tls": get_bool_env("AIKO_MQTT_TLS"),
    }


def probe_tcp(host: str, port: int, timeout: float = 0.5) -> bool:
    """True when a TCP connect to host:port succeeds within timeout (the
    reference's broker-reachability probe, configuration.py:121-139)."""
    try:
        with socket.create_connection((host, int(port)), timeout=timeout):
            return True
    except OSError:
        return False


def get_mqtt_host(candidates: list | None = None,
                  port: int | None = None,
                  timeout: float = 0.5) -> str | None:
    """First REACHABLE broker host: AIKO_MQTT_HOST, then the comma list
    AIKO_MQTT_HOSTS, then localhost -- each verified with a TCP connect
    probe (reference configuration.py:121-139).  None when nothing
    answers (callers fall back to the loopback broker)."""
    if port is None:
        port = int(os.environ.get("AIKO_MQTT_PORT", "1883"))
    if candidates is None:
        candidates = []
        primary = os.environ.get("AIKO_MQTT_HOST")
        if primary:
            candidates.append(primary)
        extra = os.environ.get("AIKO_MQTT_HOSTS", "")
        candidates += [h.strip() for h in extra.split(",") if h.strip()]
        candidates.append("localhost")
    for host in candidates:
        if probe_tcp(host, port, timeout):
            return host
    return None


class BootstrapResponder:
    """UDP bootstrap responder for MCU-class devices (reference
    configuration.py:168-186): microcontrollers that cannot run discovery
    broadcast a datagram on BOOTSTRAP_PORT and receive the namespace +
    broker endpoint back, e.g. b"boot?" -> b"(boot aiko localhost 1883)".
    """

    def __init__(self, port: int = BOOTSTRAP_PORT,
                 mqtt_host: str | None = None, mqtt_port: int | None = None):
        import threading
        if mqtt_port is None:
            mqtt_port = int(os.environ.get("AIKO_MQTT_PORT", "1883"))
        if mqtt_host is None:
            # shared resolution ladder, probing on the PINNED port
            mqtt_host = get_mqtt_configuration(port=int(mqtt_port))["host"]
        self.mqtt_host = mqtt_host
        self.mqtt_port = int(mqtt_port)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        # no SO_REUSEADDR: a second responder on the port must fail
        # loudly (EADDRINUSE), not silently split datagram delivery
        self._sock.bind(("0.0.0.0", int(port)))
        self._sock.settimeout(1.0)
        self.port = self._sock.getsockname()[1]
        self._alive = True
        self._thread = threading.Thread(
            target=self._serve, name="aiko_bootstrap", daemon=True)
        self._thread.start()

    def _serve(self):
        while self._alive:
            try:
                _, address = self._sock.recvfrom(512)
            except socket.timeout:
                continue
            except OSError:
                return
            reply = (f"(boot {get_namespace()} {self.mqtt_host} "
                     f"{self.mqtt_port})")
            try:
                self._sock.sendto(reply.encode("utf-8"), address)
            except OSError:
                pass

    def close(self):
        self._alive = False
        try:
            self._sock.close()
        except OSError:
            pass


def get_transport_configuration() -> dict:
    """Which control-plane transport to use.

    AIKO_TRANSPORT = loopback (default) | mqtt | null.  The loopback broker
    gives full pub/sub + retained + LWT semantics in-process, so the whole
    control plane runs hermetically; MQTT is opt-in when a real broker and
    paho-mqtt are available.
    """
    return {
        "kind": os.environ.get("AIKO_TRANSPORT", "loopback"),
        "mqtt": get_mqtt_configuration(),
    }
