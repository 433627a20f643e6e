from .event import EventEngine, Mailbox                       # noqa: F401
from .lease import Lease                                      # noqa: F401
from .connection import Connection, ConnectionState           # noqa: F401
from .service import (                                        # noqa: F401
    Service, ServiceProtocol, ServiceFields, ServiceFilter, ServiceTags,
    ServiceTopicPath, Services, PROTOCOL_PREFIX,
    SERVICE_PROTOCOL_REGISTRAR, SERVICE_PROTOCOL_PIPELINE,
    SERVICE_PROTOCOL_ACTOR)
from .process import Process, default_process                 # noqa: F401
from .actor import Actor, ActorMessage, ActorTopic            # noqa: F401
from .proxy import (                                        # noqa: F401
    make_proxy, get_public_methods, RemoteProxy, TracingProxy,
    trace_all_methods)
from .share import (                                          # noqa: F401
    ECProducer, ECConsumer, ServicesCache,
    services_cache_create_singleton)
from .registrar import Registrar, RetainedElection            # noqa: F401
from .state import StateMachine, StateMachineError            # noqa: F401
from .process_manager import ProcessManager                   # noqa: F401
from .compile_cache import (                                  # noqa: F401
    cache_stats, compile_cache_dir, disable_compile_cache,
    enable_compile_cache)
from .lifecycle import LifeCycleManager, LifeCycleClient      # noqa: F401
from .storage import (                                        # noqa: F401
    KeyValueStore, Storage, do_command, do_request)
from .recorder import Recorder                                # noqa: F401
