# Network diagnostics (capability parity with reference
# src/aiko_services/main/utilities/network.py:8-21: psutil scan of
# listening TCP/UDP ports).

from __future__ import annotations

__all__ = ["get_network_ports_listen"]


def get_network_ports_listen() -> list[tuple[str, int, str]]:
    """[(ip, port, protocol)] for listening TCP and bound UDP sockets."""
    try:
        import psutil
    except ImportError:  # psutil optional: degrade to empty diagnostics
        return []
    results = []
    for connection in psutil.net_connections(kind="inet"):
        if connection.status == psutil.CONN_LISTEN:
            protocol = "tcp"
        elif connection.status == psutil.CONN_NONE and connection.laddr:
            protocol = "udp"
        else:
            continue
        if connection.laddr:
            results.append((connection.laddr.ip, connection.laddr.port,
                            protocol))
    return sorted(set(results))
