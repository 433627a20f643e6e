# serve/: the serving tier -- a Gateway actor fronting a pool of
# pipeline replicas with admission control (per-priority token buckets,
# SLO-aware shedding), least-loaded routing (power-of-two-choices over
# registrar-discovered replicas' EC load gauges), bounded backpressure
# with `(throttle ...)` signals to DataSources, mid-stream failover
# that replays un-acknowledged frames on replica death, crash
# consistency (journal.py): a write-ahead journal of routing state plus
# hot-standby election so a gateway crash re-pins every stream
# exactly-once, prefill/decode disaggregation (disagg.py): the gateway
# splits the pool by replica role, routes prompts through a prefill
# pool, and forwards the KV handoff to the stream's pinned decode
# replica, and federation (federation.py): gateway groups sharing one
# fleet, streams assigned by rendezvous hash.
#
# Counterpart of aiko_services_tpu/serve/, host code throughout.  Not
# ported yet (ROADMAP Queue A item 1): autoscale.py (the elastic fleet)
# and autopilot.py (the SLO autopilot); the gateway refuses both.

from .policy import AdmissionPolicy, TokenBucket          # noqa: F401
from .journal import (                                    # noqa: F401
    GatewayJournal, JournalPolicy)
from .disagg import (                                     # noqa: F401
    DISAGG_GRAMMAR, DisaggPolicy)
from .federation import (                                 # noqa: F401
    FEDERATION_GRAMMAR, FederationPolicy, FederationRouter,
    assign_group)
from .gateway import Gateway, SERVICE_PROTOCOL_GATEWAY    # noqa: F401
