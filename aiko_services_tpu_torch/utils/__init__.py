from .sexpr import (                                        # noqa: F401
    generate, parse, parse_list_to_dict, parse_int, parse_float,
    parse_number, ParseError)
from .graph import Graph, Node, GraphError                  # noqa: F401
from .config import (                                       # noqa: F401
    get_namespace, get_hostname, get_pid, get_transport_configuration,
    get_mqtt_configuration, get_bool_env, truthy, probe_tcp, get_mqtt_host,
    BootstrapResponder)
from .lock import DiagnosticLock                            # noqa: F401
from .lru_cache import LRUCache                             # noqa: F401
from .timeutil import (                                     # noqa: F401
    epoch_now, epoch_to_iso, iso_to_epoch, monotonic)
from .logger import (get_logger, get_service_logger,        # noqa: F401
                     dispose_service_logger,
                     distributed_logging_enabled, RingBufferHandler)
from .importer import load_module                           # noqa: F401
from .padding import bucket_length, pad_axis_to             # noqa: F401,E402
from .network import get_network_ports_listen               # noqa: F401,E402
