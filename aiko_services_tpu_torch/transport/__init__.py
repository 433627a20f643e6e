from .base import Transport, topic_matches                    # noqa: F401
from .trie import TopicTrie                                   # noqa: F401
from .loopback import (                                       # noqa: F401
    LoopbackBroker, LoopbackTransport, get_broker, reset_brokers)
from .null import NullTransport                               # noqa: F401
from .mqtt import MqttTransport, mqtt_available               # noqa: F401


def create_transport(kind: str = None, on_message=None, **kwargs):
    """Transport factory honoring AIKO_TRANSPORT (loopback|mqtt|null)."""
    from ..utils import get_transport_configuration
    if kind is None:
        kind = get_transport_configuration()["kind"]
    if kind == "loopback":
        return LoopbackTransport(on_message, **kwargs)
    if kind == "mqtt":
        return MqttTransport(on_message, **kwargs)
    if kind == "null":
        return NullTransport(on_message)
    raise ValueError(f"Unknown transport kind: {kind}")
