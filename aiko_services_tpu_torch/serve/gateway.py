# Gateway: the serving tier in front of a pool of pipeline replicas.
#
# The ROADMAP north star is heavy traffic from millions of users; until
# this subsystem, every client talked straight to ONE Pipeline actor,
# `process_frame` admitted without limit, and overload meant unbounded
# queue growth until the micro-batch scheduler drowned.  The Gateway
# closes that gap with the load-shedding / least-loaded-routing designs
# of datacenter inference frontends (Orca-style continuous-batching
# routers, Clockwork's SLO-aware admission):
#
#   admission   per-priority token buckets gate STREAM creation; an
#               over-budget or unplaceable stream gets a typed
#               `(overloaded ...)` reply, never silent queue growth
#   routing     power-of-two-choices over live load gauges picks the
#               least-loaded healthy replica; a stream PINS to its
#               replica for its lifetime (stateful elements, ordered
#               frames)
#   backpressure a bounded priority queue parks frames when the pinned
#               replica saturates; past the high-water mark the gateway
#               sends `(throttle stream rate)` so DataSources slow
#               generation (PipelineElement.throttle_frame_generation);
#               a full queue sheds the LOWEST-priority parked frame
#   failover    replica death (discovery remove, or the seeded
#               `replica_kill` fault point) migrates its streams to
#               another replica and replays every un-acknowledged frame
#               from the stream cursor -- zero lost frames, duplicate
#               responses deduped, so outputs match an unfaulted run
#               bit for bit
#
# Replicas come from two sources: `attach_replica(pipeline)` wires an
# in-process Pipeline directly (responses hand off as Python objects,
# no codec -- the bench/test fast path), and `discover(...)` watches
# the registrar through the shared ServicesCache, mirroring each
# replica's EC share (`inflight` / `queue_depth`, refreshed by
# Pipeline._update_stream_share and the periodic telemetry summary)
# through an ECConsumer whose `last_update` age gates trust in the
# view (a wedged replica's stale share must not keep attracting
# streams).
#
# The wire surface mirrors the Pipeline protocol (create_stream /
# process_frame / destroy_stream), so pointing an existing client at a
# gateway topic instead of a pipeline topic is a config change, not a
# code change.

# The port's own copy of aiko_services_tpu/serve/gateway.py (host only,
# jax-free there too), with one difference: the elastic fleet
# (`autoscale=`, `replica_factory=`, enable_autoscale) and the SLO
# autopilot (`autopilot=`) raise NotImplementedError naming ROADMAP Queue
# A item 1, where tune/, serve/autoscale.py and serve/autopilot.py are
# ported; the hooks only they drive (the autoscaler's spawn and floor
# callbacks, the autopilot's start/stop and journal replay) come with
# them.

from __future__ import annotations

import json
import time

from ..faults import create_injector, get_injector
from ..observe import GatewayTelemetry
from ..observe.trace import attach_trace_context, make_trace_context
from ..pipeline.pipeline import DEFAULT_GRACE_TIME
from ..pipeline.tensors import decode_frame_data, encode_frame_data
from ..runtime import Actor, Lease, RetainedElection, ServiceFilter
from ..runtime.service import PROTOCOL_PREFIX, SERVICE_PROTOCOL_PIPELINE
from ..utils import (
    epoch_now, generate, get_logger, parse, parse_float, parse_int)
from .journal import GatewayJournal, JournalPolicy
from .policy import AdmissionPolicy

__all__ = ["Gateway", "SERVICE_PROTOCOL_GATEWAY"]

_LOGGER = get_logger("gateway")

SERVICE_PROTOCOL_GATEWAY = f"{PROTOCOL_PREFIX}/gateway:0"
# completion-rate estimator: SLO shedding stays off until this many
# completions have been observed (a cold estimate would shed blindly)
_RATE_WINDOW = 64
_RATE_WARMUP = 8


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not yet ported to the torch port (ROADMAP Queue A "
        f"item 1: tune/, serve/autoscale.py and serve/autopilot.py)")


class _LocalResponder:
    """queue_response shim handed to an in-process replica's stream:
    successful frames hand off to the gateway mailbox as live Python
    objects (no tensor codec on the fast path).  Error/drop releases
    ride the stream's topic_response instead -- the pipeline engine
    only notifies queue responders on success.

    Responses ride the CONTROL mailbox: under overload the `in`
    mailbox holds thousands of queued submissions, and a slot-freeing
    release parked behind them would starve every replica (with FIFO
    ordering goodput collapses).  The actor layer's control-preempts-data
    rule is exactly this priority."""

    __slots__ = ("gateway",)

    def __init__(self, gateway):
        self.gateway = gateway

    def put(self, item) -> None:
        from ..runtime import ActorTopic
        stream, frame, outputs = item
        self.gateway.post_message("process_frame_response", [
            {"stream_id": stream.stream_id, "frame_id": frame.frame_id},
            outputs], actor_topic=ActorTopic.CONTROL)


class _Replica:
    __slots__ = ("topic_path", "name", "pipeline", "consumer", "cache",
                 "outstanding", "streams", "dead", "saturated",
                 "below_since", "routed", "draining", "warm", "role")

    def __init__(self, topic_path: str, name: str, pipeline=None,
                 consumer=None, cache=None, warm: bool = False,
                 role: str = "decode"):
        self.topic_path = topic_path
        self.name = name
        self.pipeline = pipeline      # local direct attach (else None)
        self.consumer = consumer      # ECConsumer for discovered replicas
        self.cache = cache if cache is not None else {}
        self.outstanding = 0          # gateway-routed frames in flight
        self.streams: set[str] = set()
        self.dead = False
        self.draining = False         # scale-down: no NEW placements
        self.warm = warm              # warm-started (hand-off + cache)
        self.role = role              # disagg pool: prefill | decode
        self.saturated = False
        self.below_since: float | None = None
        self.routed = 0

    def pool_role(self) -> str:
        """Which disagg pool this replica serves: the attach-time role
        for local replicas; for discovered ones the EC share's `role`
        key (published by prefill-pool pipelines), so pool membership
        rides the ordinary discovery plane."""
        if self.pipeline is not None or self.consumer is None:
            return self.role
        return str(self.cache.get("role") or self.role)

    def reported_inflight(self) -> int:
        """The replica's OWN load claim: live for local replicas, the
        EC share mirror for discovered ones."""
        if self.pipeline is not None:
            return int(self.pipeline.load()["inflight"])
        return parse_int(self.cache.get("inflight", 0), 0)

    def prefix_heads(self) -> set:
        """Chain-head digests this replica's prefix cache holds --
        live from the pipeline share for local replicas, the EC
        mirror for discovered ones (elements/ml.py publishes the
        comma-joined summary on change).  Empty when the replica runs
        without a prefix cache."""
        if self.pipeline is not None:
            raw = self.pipeline.share.get("prefix_heads", "")
        else:
            raw = self.cache.get("prefix_heads", "")
        return {head for head in str(raw or "").split(",") if head}

    def reported_queue_depth(self) -> int:
        if self.pipeline is not None:
            return int(self.pipeline.load()["queue_depth"])
        return parse_int(self.cache.get("queue_depth", 0), 0)

    def score(self) -> int:
        """Routing load: the gateway's instant view of what it routed,
        or the replica's own claim when other clients load it too --
        max, never sum (the gateway's frames appear in both)."""
        return max(self.outstanding, self.reported_inflight())

    def fresh(self, now: float, stale_after: float) -> bool:
        if self.consumer is None:
            return True   # local: the load read IS the live value
        last_update = self.consumer.last_update
        return (last_update is not None
                and (stale_after <= 0
                     or now - last_update <= stale_after))

    def note_load(self, now: float, policy: AdmissionPolicy) -> None:
        """Refresh the hysteresis state machine after an outstanding
        change: saturation latches at the cap and only clears after the
        replica sits at/below HALF the cap for `hysteresis` seconds --
        a flapping replica must not oscillate in and out of stream
        placement."""
        cap = policy.max_inflight
        if self.outstanding >= cap:
            self.saturated = True
            self.below_since = None
        elif self.saturated:
            if self.outstanding <= max(1, cap // 2):
                if self.below_since is None:
                    self.below_since = now
                elif now - self.below_since >= policy.hysteresis_s:
                    self.saturated = False
                    self.below_since = None
            else:
                self.below_since = None

    def placeable(self, now: float, policy: AdmissionPolicy) -> bool:
        self.note_load(now, policy)
        return (not self.dead
                and not self.draining
                and not self.saturated
                and self.fresh(now, policy.stale_after_s))

    def has_capacity(self, policy: AdmissionPolicy) -> bool:
        return not self.dead and self.outstanding < policy.max_inflight


class _GatewayStream:
    __slots__ = ("stream_id", "priority", "slo_ms", "parameters",
                 "grace_time", "replica", "queue_response",
                 "topic_response", "throttle", "inflight", "delivered",
                 "delivered_floor", "cursor", "parked", "throttled",
                 "lease", "prefill_created", "keeper", "traces",
                 "dispatch_s", "restore_hint", "tenant")

    def __init__(self, stream_id: str, priority: int, slo_ms: float,
                 parameters: dict, grace_time: float, replica: _Replica,
                 queue_response=None, topic_response=None, throttle=None):
        self.stream_id = stream_id
        self.priority = priority
        self.slo_ms = slo_ms
        self.parameters = parameters
        self.grace_time = grace_time
        self.replica = replica
        self.queue_response = queue_response
        self.topic_response = topic_response
        self.throttle = throttle      # local source rate-cap callable
        # frame_id -> [frame_data, submitted_s, seq]: retained until the
        # response arrives so replica death can replay from the cursor
        self.inflight: dict[int, list] = {}
        # exactly-once dedupe: every id <= delivered_floor has been
        # delivered (the CONTIGUOUS prefix collapses into one int -- the
        # journaled high-water mark), `delivered` holds the sparse ids
        # above it
        self.delivered: set[int] = set()
        self.delivered_floor = -1
        self.cursor = 0
        self.parked = 0               # this stream's parked-queue entries
        self.throttled = False
        self.lease: Lease | None = None
        # prefill replicas that already hold this stream (disagg hop 1
        # creates lazily on first dispatch to each prefill replica)
        self.prefill_created: set[str] = set()
        # checkpoint keeper name this stream's restore hints carry:
        # the gateway policy's keeper, or the journaled one after a
        # takeover -- "checkpoint locations ride the gateway journal"
        self.keeper: str | None = None
        # one-shot warm-restore hint for ADOPTED streams (cross-group
        # journal adoption rebuilds a stream with EMPTY inflight, so
        # _migrate_streams has no frame to attach the restore hint to):
        # the next dispatched frame carries it, then it clears --
        # the adopting decode replica restores the checkpointed KV and
        # re-decodes only the post-snapshot tail instead of
        # cold re-prefilling
        self.restore_hint: dict | None = None
        # multi-tenant admission: the tenant this stream declared (""
        # = untenanted), driving per-tenant buckets and SLO counters
        self.tenant: str = ""
        # fleet tracing (telemetry-gated; both stay empty with
        # telemetry off): the gateway-owned ROOT trace per in-flight
        # frame, and each frame's first-dispatch perf_counter stamp
        # (admit-wait span boundary + decode-stage decomposition)
        self.traces: dict[int, object] = {}
        self.dispatch_s: dict[int, float] = {}

    def is_delivered(self, frame_id: int) -> bool:
        return (frame_id <= self.delivered_floor
                or frame_id in self.delivered)


class Gateway(Actor):
    def __init__(self, process, name: str = "gateway", policy=None,
                 router_seed: int = 0, faults=None, telemetry: bool = True,
                 metrics_interval: float = 10.0, autoscale=None,
                 replica_factory=None, journal=None, ha=None,
                 disagg=None, checkpoint=None, federation=None,
                 prefix=None, autopilot=None):
        if autoscale is not None or replica_factory is not None:
            raise _not_ported("the elastic fleet (autoscale=, "
                              "replica_factory=, serve/autoscale.py)")
        if autopilot is not None:
            raise _not_ported("the SLO autopilot (autopilot=, "
                              "serve/autopilot.py)")
        super().__init__(process, name, protocol=SERVICE_PROTOCOL_GATEWAY)
        # construction-time validation through the shared
        # directive-grammar core (analyze/grammar.py): a typo'd policy
        # fails HERE with the lint rule code, exactly as `aiko lint`
        # would report it offline -- never silently admits everything
        try:
            self.policy = AdmissionPolicy.parse(policy)
        except ValueError as error:
            code = ("AIKO404" if getattr(error, "kind", "") == "unknown"
                    else "AIKO403")
            raise ValueError(
                f"{code}: gateway admission policy rejected: "
                f"{error}") from None
        # prefill/decode disaggregation (serve/disagg.py): with a
        # disagg policy set, streams pin to the DECODE pool and every
        # dispatchable frame takes a prefill hop through the
        # least-loaded prefill replica first; the handoff rides the
        # frame data to the pinned decode replica, which adopts the
        # prompt's KV blocks instead of re-prefilling
        try:
            from .disagg import DisaggPolicy
            self.disagg = (DisaggPolicy.parse(disagg)
                           if disagg is not None else None)
            if self.disagg is not None and self.disagg.role is not None:
                raise ValueError(
                    "a gateway disagg spec must not pin role= (the "
                    "gateway fronts both pools)")
        except ValueError as error:
            code = ("AIKO404" if getattr(error, "kind", "") == "unknown"
                    else "AIKO408")
            raise ValueError(
                f"{code}: gateway disagg policy rejected: "
                f"{error}") from None
        # warm KV failover (decode/checkpoint.py): with a checkpoint
        # policy set, a dead decode replica's replayed frames carry a
        # RESTORE hint (the keeper name) so the survivor adopts each
        # stream's checkpointed decode state instead of re-prefilling,
        # and the replay wave is PACED at recovery_rate streams/s so
        # survivors' live decode is not convoyed by the recovery storm
        try:
            from ..decode.checkpoint import CheckpointPolicy
            self.checkpoint = (CheckpointPolicy.parse(checkpoint)
                               if checkpoint is not None else None)
            if self.checkpoint is not None:
                self.checkpoint.validate_gateway()
        except ValueError as error:
            code = ("AIKO404" if getattr(error, "kind", "") == "unknown"
                    else "AIKO409")
            raise ValueError(
                f"{code}: gateway checkpoint policy rejected: "
                f"{error}") from None
        # federated tier (serve/federation.py): with a federation spec
        # set, this gateway owns exactly the streams whose id hashes to
        # its group (rendezvous over the full group set) and sheds the
        # rest with the typed reason "wrong_group" -- a misrouted
        # client fails fast instead of splitting a stream across
        # groups.  None (the default) = single-group tier, behavior
        # identical to every pre-federation deployment
        try:
            from .federation import FederationPolicy
            self.federation = (FederationPolicy.parse(federation)
                               if federation is not None else None)
        except ValueError as error:
            code = ("AIKO404" if getattr(error, "kind", "") == "unknown"
                    else "AIKO410")
            raise ValueError(
                f"{code}: gateway federation policy rejected: "
                f"{error}") from None
        # prefix-affinity routing (decode/prefix.py): with a prefix
        # policy set, a hinted stream's placement biases the
        # power-of-two-choices sample toward replicas whose mirrored
        # chain-head summary already holds the stream's prefix
        # (score - affinity_weight), and -- when a checkpoint keeper
        # is ALSO configured -- streams carry the keeper name so a
        # cold replica pre-warms from the cross-replica prefix store.
        # None (or prefix_cache=off) = pre-prefix routing, bit for bit
        try:
            from ..decode.prefix import PrefixPolicy
            self.prefix = (PrefixPolicy.parse(prefix)
                           if prefix is not None else None)
            if self.prefix is not None:
                self.prefix.validate_gateway()
                if not self.prefix.enabled:
                    self.prefix = None
        except ValueError as error:
            code = ("AIKO404" if getattr(error, "kind", "") == "unknown"
                    else "AIKO411")
            raise ValueError(
                f"{code}: gateway prefix policy rejected: "
                f"{error}") from None
        self.federation_group = None
        if self.federation is not None and self.federation.groups:
            self.federation_group = (self.federation.group
                                     or (str(ha) if ha else None) or name)
            if self.federation_group not in self.federation.groups:
                raise ValueError(
                    f"AIKO410: gateway federation policy rejected: this "
                    f"gateway's group {self.federation_group!r} (from "
                    f"ha/name) is not in groups="
                    f"{','.join(self.federation.groups)}; set group= "
                    f"explicitly")
        # stream_id -> {"ids": [frame ids], "hint": restore hint}:
        # failover replays deferred by recovery pacing -- in inflight,
        # neither dispatched nor parked.  The hint is FROZEN at
        # failover time so the paced wave keeps _restore_hint's
        # drain/prefill-pool guards
        self._paced_frames: dict[str, dict] = {}
        # region-aware degradation (serve/federation.py): federation
        # groups known DEAD (a severed region, a lost HA pair).
        # Placement audit and journal adoption both consult this set,
        # so a lost region's streams remap onto the survivors (each
        # survivor adopting exactly its rendezvous share) while every
        # other stream keeps its pin
        self._lost_groups: set[str] = set()
        # lost group -> its (foreign) journal mirror, warmed at
        # note_group_lost so the retained backend has replayed by
        # adoption time
        self._foreign_journals: dict = {}
        self.replicas: dict[str, _Replica] = {}
        self.streams: dict[str, _GatewayStream] = {}
        # parked frames: (priority, seq, stream_id, frame_id), dispatched
        # min-first (highest priority, oldest), shed max-first.  Bounded
        # by policy.queue_capacity, so linear scans stay cheap
        self._parked: list[tuple] = []
        self._depth_priorities: set[int] = set()
        self._seq = 0
        import random
        self._rng = random.Random(router_seed)
        self.faults = (create_injector(faults) if isinstance(faults, str)
                       else (faults if faults is not None
                             else get_injector()))
        self.telemetry = GatewayTelemetry(
            self, enabled=telemetry, interval=metrics_interval)
        self._completions: list[float] = []
        self._throttle_on = False
        self._services_cache = None
        self._discovery_handler = None
        # -- crash consistency (serve/journal.py): a journaled gateway
        # rebuilds pins/cursors/dedupe floors after a crash; an HA
        # group member additionally runs the registrar-style retained
        # election and takes over when the primary's LWT fires
        self.ha_group = str(ha) if ha else None
        if self.ha_group and journal is None:
            journal = ""          # HA implies journaled (retained mirror)
        try:
            self.journal_policy = (JournalPolicy.parse(journal)
                                   if journal is not None else None)
        except ValueError as error:
            code = ("AIKO404" if getattr(error, "kind", "") == "unknown"
                    else "AIKO407")
            raise ValueError(
                f"{code}: gateway journal policy rejected: "
                f"{error}") from None
        self.journal: GatewayJournal | None = None
        self.election: RetainedElection | None = None
        self.role = "single"
        self._journal_dirty: set[str] = set()
        self._journal_forgotten: set[str] = set()
        # ids THIS incarnation has journaled whose forget has not yet
        # flushed: self-adoption must never treat them as crash
        # orphans (under churn, the replay_timeout recovery can race
        # the forget flush and resurrect just-destroyed streams)
        self._journal_session: set[str] = set()
        self._buckets_dirty = False
        self._journal_timer = None
        self._takeover_started: float | None = None
        if self.journal_policy is not None:
            root = (f"{process.namespace}/gateway/"
                    f"{self.ha_group or name}/journal")
            self.journal = GatewayJournal(self.journal_policy, process,
                                          root)
        self.share.update({
            "policy": self.policy.spec,
            "replica_count": 0,
            "stream_count": 0,
            "role": self.role,
        })
        if self.federation_group is not None:
            # discovery surface: clients resolving the tier can read
            # each gateway's group off its EC share
            self.share["federation_group"] = self.federation_group
            self.share["federation_groups"] = ",".join(
                self.federation.groups)
        self._ha_was_secondary = False
        if self.ha_group:
            self.role = "standby"

            def note_state(state):
                if state == "secondary":
                    self._ha_was_secondary = True

            self.election = RetainedElection(
                process, f"{process.namespace}/gateway/{self.ha_group}",
                self.topic_path, announce=self._announce_primary,
                search_timeout=self.journal_policy.search_timeout_s,
                on_promote=self._ha_promote, on_demote=self._ha_demote,
                on_state=note_state)
            self.share["role"] = self.role
        elif self.journal is not None:
            # restarted single gateway: adopt whatever the previous
            # incarnation journaled, once replicas have had
            # `replay_timeout` to (re)attach or be rediscovered
            self._start_journal_tick()
            self.post_message_later(
                "_journal_recover", [],
                self.journal_policy.replay_timeout_s)

    def _post_message(self, actor_topic: str, command: str,
                      parameters) -> None:
        # replica releases preempt queued client submissions (see
        # _LocalResponder): without this, an overload backlog in the
        # `in` mailbox starves every replica of slot-freeing responses
        if command in ("process_frame_response", "_release_dead_letter",
                       "_replica_lost",
                       "_paced_replay"):
            # _paced_replay rides CONTROL too: recovery waves fire
            # exactly when the `in` mailbox is deepest, and a wave
            # parked behind queued submissions would defeat the pacing
            from ..runtime import ActorTopic
            actor_topic = ActorTopic.CONTROL
        super()._post_message(actor_topic, command, parameters)

    # -- replica pool ------------------------------------------------------

    def attach_replica(self, pipeline, warm: bool = False,
                       role: str | None = None) -> None:
        """Wire an in-process Pipeline as a replica (the bench/test fast
        path: frame data and responses hand off as live objects).
        `warm` marks a warm-started replica (sibling weight hand-off +
        persistent compile cache) for the pool telemetry; `role` pins
        the disagg pool (defaults to the pipeline's own `role` share
        key -- set by a `disagg: "role=prefill"` definition parameter
        -- else the decode pool)."""
        if role is None:
            role = str(pipeline.share.get("role") or "decode")
        replica = _Replica(pipeline.topic_path, pipeline.name,
                          pipeline=pipeline, warm=warm, role=role)
        self._add_replica(replica)

    # -- elastic fleet (serve/autoscale.py drives these) -------------------

    def enable_autoscale(self, policy, factory=None) -> None:
        """Attach the load-driven autoscaler: not ported yet."""
        raise _not_ported("the elastic fleet (enable_autoscale, "
                          "serve/autoscale.py)")

    # -- crash consistency: journal + hot-standby election ------------------
    #
    # The journal records ROUTING state (pins, cursors, delivered
    # floors, bucket levels), never frame payloads: after a takeover
    # the client replays its un-acked frame DATA and the journaled
    # dedupe floor guarantees exactly-once, exactly as replica
    # failover's cursor replay does.  Batched per `interval` tick --
    # the crash window is one tick, and anything younger is covered by
    # the client-side replay.

    def _announce_primary(self) -> None:
        self.process.publish(
            f"{self.process.namespace}/gateway/{self.ha_group}",
            generate("primary", ["found", self.topic_path, "1",
                                 repr(self.election.time_started)]),
            retain=True)

    def _ha_promote(self) -> None:
        """Election won (cold start, or the primary's LWT fired): adopt
        the journal, re-pin every live journaled stream through the
        shared _migrate_streams path, start journaling."""
        was_standby = self.role == "standby"
        self.role = "primary"
        self.share["role"] = self.role
        if self.ec_producer is not None:
            self.ec_producer.update("role", self.role)
        started = time.monotonic()
        adopted = self._adopt_journal()
        self._start_journal_tick()
        takeover_ms = (time.monotonic() - started) * 1000.0
        if was_standby and self._ha_was_secondary:
            # promotion after standing by = a real takeover (a cold
            # start that never saw a primary is just a boot); the
            # histogram records promote -> streams re-pinned
            self.telemetry.record_takeover(takeover_ms)
        _LOGGER.warning(
            "%s: promoted to HA primary (%s); adopted %d journaled "
            "stream(s) in %.1f ms", self.name, self.ha_group, adopted,
            takeover_ms)
        self._update_share()

    def _ha_demote(self) -> None:
        """An older primary exists (split-brain resolution): stop
        journaling; existing streams keep serving but new clients will
        follow the retained announcement to the real primary."""
        self.role = "standby"
        self.share["role"] = self.role
        if self.ec_producer is not None:
            self.ec_producer.update("role", self.role)
        self._stop_journal_tick()
        _LOGGER.warning("%s: demoted to HA standby (%s)", self.name,
                        self.ha_group)

    def _start_journal_tick(self) -> None:
        if self.journal is None or self._journal_timer is not None:
            return
        interval = self.journal_policy.interval_s
        if interval > 0:
            self._journal_timer = self._journal_tick
            self.process.event.add_timer_handler(self._journal_timer,
                                                 interval)
        else:
            # interval=0: synchronous journaling (every mark flushes) --
            # the deterministic mode chaos tests pin the crash window
            # shut with
            self._journal_timer = None

    def _stop_journal_tick(self) -> None:
        if self._journal_timer is not None:
            self.process.event.remove_timer_handler(self._journal_timer)
            self._journal_timer = None

    def _mark_journal(self, stream: _GatewayStream) -> None:
        if self.journal is None or self.role == "standby":
            return
        self._journal_dirty.add(stream.stream_id)
        self._journal_session.add(stream.stream_id)
        if self.journal_policy.interval_s <= 0:
            self._journal_tick()

    def _journal_forget(self, stream_id: str) -> None:
        if self.journal is None or self.role == "standby":
            return
        self._journal_dirty.discard(stream_id)
        self._journal_forgotten.add(stream_id)
        if self.journal_policy.interval_s <= 0:
            self._journal_tick()

    def _journal_tick(self) -> None:
        """One batched flush: serialize every dirty stream still
        alive, delete the forgotten, refresh bucket levels."""
        if self.journal is None or self.role == "standby":
            return
        if (not self._journal_dirty and not self._journal_forgotten
                and not self._buckets_dirty):
            return
        records = {}
        for stream_id in list(self._journal_dirty):
            stream = self.streams.get(stream_id)
            if stream is not None:
                records[stream_id] = self._journal_record(stream)
        forgotten = self._journal_forgotten
        buckets = self._bucket_levels() if self._buckets_dirty else None
        self._journal_dirty = set()
        self._journal_forgotten = set()
        self._buckets_dirty = False
        written = self.journal.write(records, forgotten, buckets)
        # flushed forgets are really gone from the backend -- their ids
        # can no longer be mistaken for crash orphans, so the session
        # set stays bounded by live + pending-forget streams
        self._journal_session.difference_update(forgotten)
        if written:
            self.telemetry.journal_appends.inc(written)
        self.telemetry.journal_entries.set(self.journal.entry_count())

    def journal_flush(self) -> None:
        """Force a journal tick NOW (deterministic tests/benches pin
        the crash window shut before injecting a kill)."""
        self._journal_tick()

    def _journal_record(self, stream: _GatewayStream) -> dict:
        parameters = stream.parameters
        try:
            json.dumps(parameters)
        except (TypeError, ValueError):
            # non-JSON-able local parameters: journal the stream's
            # identity/cursor anyway (the pin survives; the new primary
            # serves with replica-side parameters)
            parameters = {}
        record = {
            "stream_id": stream.stream_id,
            "priority": stream.priority,
            "slo_ms": stream.slo_ms,
            "parameters": parameters,
            "grace_time": stream.grace_time,
            "topic_response": stream.topic_response or "",
            "replica": (stream.replica.topic_path
                        if stream.replica is not None else ""),
            "cursor": stream.cursor,
            "delivered_upto": stream.delivered_floor,
            "expires_at": epoch_now() + max(stream.grace_time, 0.0),
        }
        if stream.keeper:
            # checkpoint LOCATION rides the journal: a promoted
            # standby's failovers restore from the same keeper
            record["keeper"] = stream.keeper
        return record

    def _bucket_levels(self) -> dict:
        return {str(priority): round(bucket.tokens, 6)
                for priority, bucket
                in list(self.policy.buckets.items())}

    def _journal_recover(self) -> None:
        """Mailbox continuation of the restart path (non-HA journaled
        gateway): adopt after `replay_timeout` gave replicas time to
        re-attach/rediscover."""
        if self.role == "single":
            adopted = self._adopt_journal()
            if adopted:
                _LOGGER.warning(
                    "%s: restart recovery adopted %d journaled "
                    "stream(s)", self.name, adopted)

    def _journal_recover_retry(self) -> None:
        """Deferred adoption retry: the pool was empty at promote/
        restart time (full-outage cold start)."""
        if self.journal is not None and self.role != "standby":
            adopted = self._adopt_journal()
            if adopted:
                _LOGGER.warning(
                    "%s: deferred recovery adopted %d journaled "
                    "stream(s)", self.name, adopted)

    def recover_now(self) -> int:
        """Synchronous journal adoption (deterministic tests)."""
        return self._adopt_journal()

    def _adopt_journal(self) -> int:
        """Rebuild gateway state from the journal: recreate each live
        stream (cursor + dedupe floor restored), group them under
        per-old-replica ghost pins, then run the SHARED zero-loss
        migration path -- destroy on the old replica (fencing a
        survivor that still serves the stream), re-pin on the current
        pool, replay handled by client resubmission against the
        restored floor.  Expired entries are dropped, never re-pinned
        (journal.replay purges them)."""
        if self.journal is None:
            return 0
        records, buckets, dropped = self.journal.replay()
        if self._journal_session:
            # an entry THIS incarnation wrote is not a crash orphan:
            # it is either a live stream (skipped below anyway) or a
            # just-destroyed one whose forget has not flushed yet --
            # adopting it would resurrect a deliberately torn-down
            # stream
            records = [record for record in records
                       if str(record.get("stream_id", ""))
                       not in self._journal_session]
        if dropped:
            self.telemetry.journal_dropped_stale.inc(dropped)
        if records and not any(not replica.dead for replica
                               in list(self.replicas.values())):
            # cold start after a FULL outage: the pool is empty because
            # rediscovery is still in flight, and adopting now would
            # hard-fail (and forget) every journaled stream.  Wait one
            # replay_timeout and try again -- record expiry bounds the
            # retries, so a fleet that never comes back converges to an
            # empty journal instead of looping forever
            self._adopt_buckets(buckets)
            _LOGGER.warning(
                "%s: %d journaled stream(s) but no live replicas yet; "
                "deferring adoption", self.name, len(records))
            self.post_message_later(
                "_journal_recover_retry", [],
                max(self.journal_policy.replay_timeout_s, 0.05))
            return 0
        adopted = self._adopt_records(records)
        self._adopt_buckets(buckets)
        if adopted:
            self.telemetry.journal_replayed.inc(adopted)
            self._update_share()
            self._journal_tick()
        return adopted

    def _adopt_records(self, records) -> int:
        """The shared record-adoption core: rebuild each journaled
        stream (cursor + dedupe floor restored), group them under
        per-old-replica ghost pins, then run the zero-loss migration
        path.  Used by _adopt_journal (own crash/takeover) and
        _adopt_group_ready (a LOST federation group's streams)."""
        ghosts: dict[str, _Replica] = {}
        adopted = 0
        for record in records:
            stream_id = str(record.get("stream_id", ""))
            if not stream_id or stream_id in self.streams:
                continue
            old_topic = str(record.get("replica", "") or "")
            ghost = ghosts.get(old_topic)
            if ghost is None:
                ghost = ghosts[old_topic] = _Replica(
                    old_topic, f"journal:{old_topic or 'unpinned'}")
                ghost.dead = True
                live = self.replicas.get(old_topic)
                if live is not None and live.pipeline is not None:
                    # the old pin is a DIRECT-attached survivor: route
                    # the fencing destroy through the same mailbox the
                    # re-pin create uses, so the two cannot reorder
                    ghost.pipeline = live.pipeline
            try:
                grace_time = float(record.get("grace_time",
                                              DEFAULT_GRACE_TIME))
            except (TypeError, ValueError):
                grace_time = DEFAULT_GRACE_TIME
            parameters = dict(record.get("parameters") or {})
            stream = _GatewayStream(
                stream_id, parse_int(record.get("priority", 0), 0),
                parse_float(record.get("slo_ms", 0.0), 0.0),
                parameters, grace_time, ghost,
                topic_response=(record.get("topic_response") or None))
            stream.tenant = str(parameters.get("tenant", "") or "")
            stream.cursor = parse_int(record.get("cursor", 0), 0)
            stream.delivered_floor = parse_int(
                record.get("delivered_upto", -1), -1)
            stream.keeper = (str(record.get("keeper"))
                             if record.get("keeper") else
                             (self.checkpoint.keeper
                              if self.checkpoint is not None
                              and self.checkpoint.keeper else None))
            stream.lease = Lease(
                self.process.event, grace_time, stream_id,
                lease_expired_handler=self._stream_lease_expired,
                jitter=self._lease_jitter(stream_id))
            self.streams[stream_id] = stream
            ghost.streams.add(stream_id)
            adopted += 1
            self._journal_dirty.add(stream_id)  # re-journal the new pin
        for ghost in ghosts.values():
            self._migrate_streams(ghost)
        return adopted

    # -- region-aware degradation (cross-group adoption) -------------------

    def note_group_lost(self, group) -> None:
        """Another federation group is DEAD (its region severed, its
        HA pair gone).  Mark it lost -- placement audit now routes its
        streams here when the rendezvous says so -- and warm the lost
        group's journal mirror so that, one replay_timeout later,
        _adopt_group_ready can rebuild OUR share of its streams with
        warm-restore hints.  Composes journal failover + warm
        checkpoints + federation: the journal names each stream's
        keeper, the keeper holds its KV snapshot, and the rendezvous
        decides which survivor adopts it."""
        group = str(group)
        if (self.federation_group is None
                or group == self.federation_group
                or group in self._lost_groups):
            return
        if group not in self.federation.groups:
            _LOGGER.warning("%s: note_group_lost(%s): unknown group",
                            self.name, group)
            return
        self._lost_groups.add(group)
        self.share["federation_lost"] = ",".join(sorted(self._lost_groups))
        _LOGGER.warning("%s: federation group %s marked lost",
                        self.name, group)
        if self.journal_policy is None:
            # no journal machinery: placement still remaps NEW streams,
            # but the lost group's live streams cannot be adopted
            self._update_share()
            return
        if group not in self._foreign_journals:
            # constructing the retained-backend journal SUBSCRIBES to
            # the lost group's journal root now, so its mirror has
            # warmed by the time adoption fires (sqlite backends read
            # the shared path directly and need no warm-up)
            root = f"{self.process.namespace}/gateway/{group}/journal"
            self._foreign_journals[group] = GatewayJournal(
                self.journal_policy, self.process, root)
        self.post_message_later(
            "_adopt_group_ready", [group],
            max(self.journal_policy.replay_timeout_s, 0.05))
        self._update_share()

    def note_group_healed(self, group) -> None:
        """The lost group is back: stop treating it as dead for
        placement.  Streams the survivors already adopted STAY adopted
        (their records were purged from the healed group's journal at
        adoption, so it cannot re-pin them); only un-adopted streams
        and new admissions flow back."""
        group = str(group)
        if group not in self._lost_groups:
            return
        self._lost_groups.discard(group)
        self.share["federation_lost"] = ",".join(sorted(self._lost_groups))
        journal = self._foreign_journals.pop(group, None)
        if journal is not None:
            journal.stop()
        _LOGGER.warning("%s: federation group %s healed",
                        self.name, group)
        self._update_share()

    def adopt_group_now(self, group) -> int:
        """Synchronous cross-group adoption (deterministic tests: the
        caller drained the broker, so the foreign mirror is warm)."""
        return self._adopt_group_ready(group)

    def _adopt_group_ready(self, group) -> int:
        """Mailbox continuation of note_group_lost: replay the lost
        group's journal and adopt exactly OUR rendezvous share of its
        live streams -- every survivor runs this same filter, so each
        stream is adopted exactly once, by the group the region-aware
        placement law names.  Adopted records are purged from the
        foreign journal so a healed group cannot re-pin them."""
        group = str(group)
        if group not in self._lost_groups:
            return 0                  # healed before adoption fired
        journal = self._foreign_journals.get(group)
        if journal is None or self.federation is None:
            return 0
        records, _buckets, dropped = journal.replay()
        if dropped:
            self.telemetry.journal_dropped_stale.inc(dropped)
        mine = []
        for record in records:
            stream_id = str(record.get("stream_id", ""))
            if not stream_id or stream_id in self.streams:
                continue
            parameters = record.get("parameters") or {}
            region = (str(parameters["region"])
                      if isinstance(parameters, dict)
                      and parameters.get("region") is not None else None)
            try:
                owner = self.federation.owner_of(
                    stream_id, region=region, lost=self._lost_groups)
            except ValueError:
                continue
            if owner == self.federation_group:
                mine.append(record)
        if not mine:
            return 0
        if not any(not replica.dead
                   for replica in list(self.replicas.values())):
            # the pool is empty (the outage took our replicas too):
            # retry like the cold-start path; record expiry bounds it
            self.post_message_later(
                "_adopt_group_ready", [group],
                max(self.journal_policy.replay_timeout_s, 0.05))
            return 0
        adopted = self._adopt_records(mine)
        if adopted:
            self.telemetry.region_migrations.inc(adopted)
            self._update_share()
            self._journal_tick()     # the new pins ride OUR journal...
            journal.write({}, [str(record.get("stream_id"))
                               for record in mine])
            _LOGGER.warning(
                "%s: adopted %d stream(s) from lost group %s",
                self.name, adopted, group)
        return adopted

    def _adopt_buckets(self, levels: dict) -> None:
        """Restore admission-bucket token levels: a rate-limited client
        must not refill its budget by crashing the gateway."""
        for key, tokens in (levels or {}).items():
            bucket = self.policy.buckets.get(parse_int(key, -1))
            if bucket is None:
                continue
            bucket.tokens = min(bucket.burst,
                                max(0.0, parse_float(tokens, 0.0)))
            bucket.updated = None

    def discover(self, service_filter: ServiceFilter = None,
                 **filter_kwargs) -> None:
        """Watch the registrar (via the process's shared ServicesCache)
        for pipeline services matching `service_filter`; matches become
        replicas, removals trigger failover.  Each discovered replica's
        EC share is mirrored through an ECConsumer -- its `inflight` /
        `queue_depth` keys are the load gauges routing reads, and the
        mirror's age gates trust (policy `stale_after`)."""
        from ..runtime.share import services_cache_create_singleton
        if service_filter is None:
            filter_kwargs.setdefault(
                "protocol", SERVICE_PROTOCOL_PIPELINE)
            service_filter = ServiceFilter(**filter_kwargs)
        if self._services_cache is None:
            self._services_cache = services_cache_create_singleton(
                self.process)

        def handler(command, fields):
            if command == "add":
                self._replica_discovered(fields)
            elif command == "remove":
                self.post_message("_replica_lost", [fields.topic_path,
                                                    "discovery_remove"])

        self._discovery_handler = handler
        self._services_cache.add_handler(handler, service_filter)

    def _replica_discovered(self, fields) -> None:
        if fields.topic_path in self.replicas:
            return
        from ..runtime.share import ECConsumer
        cache: dict = {}
        consumer = ECConsumer(self.process, cache, fields.topic_path)
        replica = _Replica(fields.topic_path, fields.name,
                          consumer=consumer, cache=cache)
        # liveness watch on the replica's PROCESS state topic: the LWT
        # "(absent)" reaches us directly, registrar or no registrar.
        # Discovery-remove alone has a hole the chaos harness exposed:
        # a replica that dies DURING a registrar failover never
        # re-registered with the new primary, so no remove ever fires
        # -- its pinned streams would hang until stale_after.  The
        # retained "(absent)" closes it (a late subscriber still sees
        # the death).
        self.process.add_message_handler(
            self._replica_state_handler,
            self._replica_state_topic(fields.topic_path))
        self._add_replica(replica)

    @staticmethod
    def _replica_state_topic(topic_path: str) -> str:
        """{ns}/{host}/{pid}/{service_id} -> the owning process's
        liveness topic {ns}/{host}/{pid}/0/state."""
        return f"{topic_path.rsplit('/', 1)[0]}/0/state"

    def _replica_state_handler(self, topic: str, payload: str) -> None:
        try:
            command, _ = parse(payload)
        except ValueError:
            return
        if command != "absent":
            return
        process_root = topic.rsplit("/0/state", 1)[0]
        for topic_path, replica in list(self.replicas.items()):
            if (replica.consumer is not None
                    and topic_path.rsplit("/", 1)[0] == process_root):
                self.post_message("_replica_lost",
                                  [topic_path, "process_absent"])

    def _add_replica(self, replica: _Replica) -> None:
        self.replicas[replica.topic_path] = replica
        # dead-letter reuse: a replica's dead-letter topic is the release path
        # for frames it dropped/errored -- the gateway frees the slot
        # instead of waiting out a deadline
        self.process.add_message_handler(
            self._dead_letter_handler,
            f"{replica.topic_path}/dead_letter")
        self._update_share()
        _LOGGER.info("%s: replica %s (%s) joined", self.name,
                     replica.name, replica.topic_path)

    def _replica_lost(self, topic_path, reason) -> None:
        replica = self.replicas.get(str(topic_path))
        if replica is not None:
            self._replica_dead(replica, str(reason))

    def _replica_dead(self, replica: _Replica, reason: str) -> None:
        """Replica death: fence it (destroy its streams so a zombie
        stops computing), then migrate every pinned stream to another
        replica and replay the un-acknowledged frames from the stream
        cursor.  Frames the zombie already answered are deduped by the
        per-stream `delivered` set, so clients observe exactly-once.

        Only ever runs as a mailbox continuation (_replica_lost): an
        injected replica_kill marks the replica dead inline but DEFERS
        this cleanup, so it never reenters a dispatch or drain loop
        mid-iteration.  Removal from self.replicas is the
        exactly-once latch (replica.dead alone is set early by the
        fault path)."""
        if self.replicas.pop(replica.topic_path, None) is None:
            return  # already failed over (e.g. kill then discovery remove)
        replica.dead = True
        self._detach_replica(replica)
        self.telemetry.replica_deaths.inc()
        _LOGGER.warning("%s: replica %s died (%s); failing over %d "
                        "streams", self.name, replica.name, reason,
                        len(replica.streams))
        self._migrate_streams(replica)
        self._recover_prefill_frames(replica.topic_path)
        self._update_share()
        # frames that parked while the replica was dying (dispatch saw
        # replica.dead before this cleanup ran) have no response left to
        # trigger a drain -- kick it now that streams are re-pinned
        self._drain_parked()

    def drain_replica(self, topic_path: str,
                      reason: str = "scale_down"):
        """Graceful retirement (the autoscaler's low-watermark path):
        leave the pool, stop attracting placements, and re-pin every
        pinned stream through the SAME zero-loss migration the death
        path uses -- destroy on the old replica, replay un-acked frames
        from the stream cursor on the new one, duplicates deduped.  The
        replica object is returned so the caller can retire the backing
        process after its in-flight responses settle; returns None when
        the topic is not in the pool."""
        replica = self.replicas.pop(str(topic_path), None)
        if replica is None:
            return None
        replica.draining = True
        self._detach_replica(replica)
        _LOGGER.info("%s: draining replica %s (%s); migrating %d "
                     "streams", self.name, replica.name, reason,
                     len(replica.streams))
        self._migrate_streams(replica)
        self._recover_prefill_frames(replica.topic_path,
                                     redispatch=False)
        self._update_share()
        self._drain_parked()
        return replica

    def _detach_replica(self, replica: _Replica) -> None:
        self.process.remove_message_handler(
            self._dead_letter_handler,
            f"{replica.topic_path}/dead_letter")
        if replica.consumer is not None:
            self.process.remove_message_handler(
                self._replica_state_handler,
                self._replica_state_topic(replica.topic_path))
            replica.consumer.terminate()

    def _migrate_streams(self, replica: _Replica) -> None:
        """Re-pin every stream pinned to `replica` and replay its
        un-acknowledged frames -- the zero-loss path shared by failover
        (replica death) and drain (scale-down).  The replica must
        already be out of self.replicas so placement cannot choose it.

        Warm failover (decode/checkpoint.py): when a checkpoint keeper
        is known, each replayed frame carries a RESTORE hint so the
        new replica adopts the stream's checkpointed decode state
        instead of re-prefilling.  Recovery-storm pacing: past the
        first `recovery_rate`-sized wave, a stream's replay defers to
        a scheduled `_paced_replay` at 1/recovery_rate spacing -- the
        survivors' LIVE decode slots keep their cadence while the
        re-admission wave (and its cold re-prefill fallbacks, bounded
        per tick by the replicas' chunked prefill) trickles in."""
        for stream_id in list(replica.streams):
            self._send_destroy(replica, stream_id)
        replay_start = time.perf_counter()
        replayed_frames = 0
        now = time.monotonic()
        # pacing protects survivors from a CRASH recovery storm; a
        # graceful drain migrates at full speed (nothing crashed, the
        # drained replica's work is finishing, survivors were sized
        # for the load) -- mirroring _restore_hint's drain bypass
        rate = (self.checkpoint.recovery_rate
                if self.checkpoint is not None
                and not replica.draining else 0.0)
        immediate = max(int(rate), 1)
        migrated = 0
        paced_streams = 0
        paced_frames = 0
        for stream_id in list(replica.streams):
            replica.streams.discard(stream_id)
            stream = self.streams.get(stream_id)
            if stream is None:
                continue
            # placement preference order, but failover NEVER fails a
            # stream while ANY live replica exists: a survivor that is
            # momentarily saturated (or stale) still gets the stream
            # pinned -- its frames park and drain as slots free, which
            # is exactly what the bounded queue is for.  Only an empty
            # pool hard-fails
            target = self._place(now) or self._any_replica()
            if target is None:
                self._fail_stream(stream, "no_replica_for_failover")
                continue
            self.telemetry.failovers.inc()
            stream.replica = target
            target.streams.add(stream_id)
            self._mark_journal(stream)   # the pin moved
            first = (min(stream.inflight) if stream.inflight
                     else stream.cursor)
            self._send_create(target, stream, first_frame_id=first)
            hint = self._restore_hint(stream, replica)
            # replay in frame order; capacity overflow parks (original
            # seq keeps the parked entries draining in order).  Frames
            # that were still PARKED at death are already queued -- they
            # drain to the new replica through the re-pin above
            parked_ids = {item[3] for item in list(self._parked)
                          if item[2] == stream_id}
            already_paced = stream_id in self._paced_frames
            replay_ids = []
            for frame_id in sorted(stream.inflight):
                if frame_id in parked_ids:
                    continue
                entry = stream.inflight[frame_id]
                if len(entry) > 3:
                    # mid-prefill-hop on a LIVE prefill replica: its
                    # response re-dispatches through _prefill_done to
                    # the NEW pin -- replaying here would double-send
                    continue
                replay_ids.append(frame_id)
            if already_paced:
                # a SECOND failover while this stream's replay wave is
                # still scheduled: MERGE the new replay ids (frames
                # dispatched after the first failover) into the
                # pending wave -- _paced_replay reads stream.replica
                # at fire time, so everything lands on the new pin;
                # replaying here too would double-dispatch
                pending = self._paced_frames[stream_id]
                pending["ids"] = sorted(set(pending["ids"])
                                        | set(replay_ids))
                pending["hint"] = hint
                continue
            if not replay_ids and hint is not None:
                # nothing in flight to carry the hint (adopted-journal
                # streams rebuild with EMPTY inflight): arm the
                # one-shot stream hint instead, so the next dispatched
                # frame -- the client's resubmission against the
                # restored dedupe floor -- warm-restores on the new
                # replica (see _send_frame)
                stream.restore_hint = hint
            migrated += 1
            if rate > 0 and migrated > immediate and replay_ids:
                self._paced_frames[stream_id] = {"ids": replay_ids,
                                                 "hint": hint}
                self.telemetry.recovery_paced.inc()
                self.telemetry.recovery_paced_pending.set(
                    len(self._paced_frames))
                paced_streams += 1
                paced_frames += len(replay_ids)
                self.post_message_later(
                    "_paced_replay", [stream_id],
                    (migrated - immediate) / rate)
                continue
            replayed_frames += len(replay_ids)
            self._replay_frames(stream, replay_ids, hint)
        if migrated:
            # failover replay wave on the merged fleet timeline: how
            # long re-pinning + replaying this replica's streams took
            # (paced streams were re-pinned here but replay in their
            # own scheduled paced_replay: waves)
            self.telemetry.record_replay(
                time.perf_counter() - replay_start,
                streams=migrated - paced_streams,
                frames=replayed_frames,
                paced_streams=paced_streams,
                paced_frames=paced_frames)

    def _restore_hint(self, stream: _GatewayStream,
                      dead: _Replica) -> dict | None:
        """The warm-failover hint a replayed frame carries: the keeper
        name the new DECODE replica restores the stream's checkpointed
        slots from.  None (cold replay) when no keeper is known, when
        the dead replica was a prefill-pool member (it held no decode
        state), or on a graceful drain's own migration (the drained
        replica finished its work; there is nothing to restore)."""
        keeper = stream.keeper or (
            self.checkpoint.keeper if self.checkpoint is not None
            else None)
        if not keeper or dead.draining:
            return None
        if dead.pool_role() == "prefill":
            return None
        return {"keeper": keeper}

    def _replay_frames(self, stream: _GatewayStream, frame_ids,
                       hint: dict | None) -> None:
        target = stream.replica
        for frame_id in frame_ids:
            entry = stream.inflight.get(frame_id)
            if entry is None or stream.is_delivered(frame_id):
                continue
            if (target is not None
                    and target.has_capacity(self.policy)
                    and stream.parked == 0):
                data = None
                if hint is not None:
                    data = dict(entry[0])
                    restore = dict(hint)
                    trace = stream.traces.get(frame_id)
                    if trace is not None:
                        # the restore HINT carries the trace context
                        # too: the survivor's warm restore parents
                        # under the frame's gateway root even though
                        # the hint was frozen at failover time
                        restore["trace_context"] = make_trace_context(
                            trace)
                    data["restore"] = restore
                self._send_frame(target, stream, frame_id, entry,
                                 data=data)
            else:
                # parked frames replay the ORIGINAL data when they
                # drain (the keeper snapshot may expire while parked):
                # degraded to a re-prefill, never lost
                self._park(stream, frame_id, entry[2])

    def _paced_replay(self, stream_id) -> None:
        """Scheduled continuation of a paced failover wave: dispatch
        one migrated stream's replayed frames now.  Reads the CURRENT
        pin, so a second failover (or drain) between scheduling and
        firing lands the frames on the right replica; the restore hint
        was frozen by _restore_hint at failover time, so its
        drain/prefill-pool guards still hold."""
        pending = self._paced_frames.pop(str(stream_id), None)
        self.telemetry.recovery_paced_pending.set(
            len(self._paced_frames))
        stream = self.streams.get(str(stream_id))
        if not pending or not pending["ids"] or stream is None:
            return
        if stream.replica is None:
            return
        paced_start = time.perf_counter()
        self._replay_frames(stream, pending["ids"], pending["hint"])
        self.telemetry.record_replay(
            time.perf_counter() - paced_start, streams=1,
            frames=len(pending["ids"]), paced=True)

    # -- placement ---------------------------------------------------------

    def _place(self, now: float,
               prefix_hint: str | None = None) -> _Replica | None:
        """Power-of-two-choices over the placeable DECODE pool: sample
        two, route to the lower load score.  Deterministic under the
        `router_seed` RNG.  Streams only ever pin to decode-role
        replicas -- a prefill replica holds no slot state to pin to.

        With a prefix policy armed and a `prefix_hint` (chain-head
        digest) on the stream, replicas already holding that head JOIN
        the sampled pair -- affinity must not depend on the RNG
        happening to draw the holder -- and the comparison subtracts
        `affinity_weight` from a holder's load score, so a warm
        replica wins ties and modest load gaps but a SATURATED holder
        still loses (placeable() filtered it out entirely, or its raw
        load dwarfs the discount): affinity degrades to plain
        balancing, never to a hot spot."""
        candidates = [replica for replica in list(self.replicas.values())
                      if replica.placeable(now, self.policy)
                      and replica.pool_role() != "prefill"]
        if not candidates:
            return None
        affinity = self.prefix is not None and bool(prefix_hint)
        if len(candidates) == 1:
            chosen = candidates[0]
        elif affinity:
            pool = self._rng.sample(candidates, 2)
            pool += [replica for replica in candidates
                     if replica not in pool
                     and prefix_hint in replica.prefix_heads()]
            weight = self.prefix.affinity_weight

            def adjusted(replica: _Replica) -> float:
                discount = (weight if prefix_hint
                            in replica.prefix_heads() else 0.0)
                return replica.score() - discount

            chosen = min(pool, key=adjusted)
        else:
            first, second = self._rng.sample(candidates, 2)
            chosen = first if first.score() <= second.score() else second
        if affinity:
            if prefix_hint in chosen.prefix_heads():
                self.telemetry.affinity_hits.inc()
            else:
                self.telemetry.affinity_misses.inc()
        return chosen

    def _place_prefill(self, now: float) -> _Replica | None:
        """Least-loaded prefill replica with dispatch capacity, or None
        (pool empty/saturated -- the frame goes straight to its decode
        replica and prefills locally; disaggregation degrades to
        colocation, never to a stall)."""
        candidates = [replica for replica in list(self.replicas.values())
                      if replica.pool_role() == "prefill"
                      and not replica.dead and not replica.draining
                      and replica.fresh(now, self.policy.stale_after_s)
                      and replica.has_capacity(self.policy)]
        if not candidates:
            return None
        return min(candidates, key=lambda replica: replica.score())

    def _any_replica(self) -> _Replica | None:
        """Least-loaded LIVE decode replica ignoring saturation/
        staleness: the failover fallback (availability beats load
        hygiene when the alternative is destroying a stream)."""
        candidates = [replica for replica in list(self.replicas.values())
                      if not replica.dead
                      and replica.pool_role() != "prefill"]
        if not candidates:
            return None
        return min(candidates, key=lambda replica: replica.score())

    # -- client surface (pipeline-protocol parity) -------------------------

    def submit_stream(self, stream_id, parameters=None, queue_response=None,
                      throttle=None,
                      grace_time: float = DEFAULT_GRACE_TIME) -> None:
        """Thread-safe local entry: posts through the gateway mailbox
        (decisions surface on `queue_response` and the counters)."""
        self.post_message("create_stream", [
            stream_id, parameters or {}, grace_time, None, queue_response,
            throttle])

    def submit_frame(self, stream_id, frame_data,
                     frame_id=None) -> None:
        stream_dict = {"stream_id": stream_id}
        if frame_id is not None:
            stream_dict["frame_id"] = frame_id
        self.post_message("process_frame", [stream_dict, frame_data])

    def create_stream(self, stream_id, parameters=None,
                      grace_time=DEFAULT_GRACE_TIME, topic_response=None,
                      queue_response=None, throttle=None) -> None:
        stream_id = str(stream_id)
        admit_start = time.perf_counter()
        try:
            if isinstance(parameters, str):   # wire call: JSON-encoded
                parameters = json.loads(parameters) if parameters else {}
            if isinstance(grace_time, str):
                grace_time = float(grace_time)
        except ValueError as error:
            _LOGGER.warning("%s: bad create_stream arguments: %s",
                            self.name, error)
            return
        parameters = dict(parameters or {})
        priority = parse_int(parameters.get("priority", 0), 0)
        slo_ms = parse_float(parameters.get("slo_ms", 0.0), 0.0)
        if stream_id in self.streams:
            self._reject_stream(stream_id, "duplicate_stream_id",
                                topic_response, queue_response)
            return
        region = (str(parameters["region"])
                  if parameters.get("region") is not None else None)
        if self.federation_group is not None:
            # federated tier: region-aware placement audit (client
            # region affinity first, rendezvous over the SURVIVING
            # groups as fallback) -- a stream that hashes to ANOTHER
            # live group sheds wrong_group before the token bucket (a
            # misrouted client must not burn this group's admission
            # budget)
            if (self.federation.owner_of(stream_id, region=region,
                                         lost=self._lost_groups)
                    != self.federation_group):
                self._reject_stream(stream_id, "wrong_group",
                                    topic_response, queue_response)
                return
            if region is not None:
                # degradation evidence: did the declared region
                # affinity land in-region, or did a region loss push
                # the stream cross-region?
                if self.federation.region_of(
                        self.federation_group) == region:
                    self.telemetry.region_affinity_hits.inc()
                else:
                    self.telemetry.region_affinity_misses.inc()
        now = time.monotonic()
        tenant = str(parameters.get("tenant", "") or "")
        bucket = self.policy.bucket_for(priority)
        if bucket is not None:
            taken = bucket.try_take(now)
            self._buckets_dirty = self.journal is not None
            if not taken:
                self._reject_stream(stream_id, "rate_limited",
                                    topic_response, queue_response)
                return
        tenant_bucket = self.policy.tenant_bucket_for(tenant)
        if tenant_bucket is not None:
            # multi-tenant isolation: each tenant burns its OWN budget
            # -- one tenant's storm exhausts its bucket and sheds
            # rate_limited_tenant, with zero draw on any other
            # tenant's tokens (the isolation proof rides this)
            taken = tenant_bucket.try_take(now)
            self._buckets_dirty = self.journal is not None
            if not taken:
                self._reject_stream(stream_id, "rate_limited_tenant",
                                    topic_response, queue_response)
                return
        # prefix-affinity: the client's chain-head digest (computed
        # with decode/prefix.py prefix_head over the shared preamble)
        # rides the create parameters; replicas mirroring that head
        # win placement ties (see _place)
        prefix_hint = (str(parameters.get("prefix_hint") or "")
                       if self.prefix is not None else "")
        replica = self._place(now, prefix_hint=prefix_hint or None)
        if replica is None:
            self._reject_stream(stream_id, "no_replica",
                                topic_response, queue_response)
            return
        if (self.policy.frame_deadline_s > 0
                and "frame_deadline" not in parameters):
            # frame-deadline machinery: the REPLICA releases wedged frames by
            # dead-letter, which frees the gateway slot (see
            # _dead_letter_handler) -- no second deadline layer here
            parameters["frame_deadline"] = self.policy.frame_deadline_s
        if self.disagg is not None and "adopt_timeout" not in parameters:
            # the disagg policy's fetch bound reaches the DECODE
            # replica as a stream parameter (same mechanism as
            # frame_deadline): LMGenerate reads it per stream, so one
            # gateway knob governs the whole fleet's adopt fallback
            parameters["adopt_timeout"] = self.disagg.adopt_timeout_s
        if (self.prefix is not None and self.checkpoint is not None
                and self.checkpoint.keeper
                and "prefix_keeper" not in parameters):
            # prefix + checkpoint together turn the keeper into a
            # cross-replica prefix store: the replica pre-warms cold
            # prompts from it and exports finished chains back
            # (elements/ml.py _prewarm_prefix / _export_prefix)
            parameters["prefix_keeper"] = self.checkpoint.keeper
        stream = _GatewayStream(
            stream_id, priority, slo_ms, parameters, grace_time, replica,
            queue_response=queue_response, topic_response=topic_response,
            throttle=throttle)
        stream.tenant = tenant
        if self.checkpoint is not None and self.checkpoint.keeper:
            stream.keeper = self.checkpoint.keeper
        stream.lease = Lease(
            self.process.event, grace_time, stream_id,
            lease_expired_handler=self._stream_lease_expired,
            jitter=self._lease_jitter(stream_id))
        self.streams[stream_id] = stream
        replica.streams.add(stream_id)
        self.telemetry.admitted.inc()
        # decomposition: admission processing (bucket take + placement)
        # is the stream's one-time `admit` share
        self.telemetry.record_stage(
            stream_id, "admit", time.perf_counter() - admit_start)
        self._mark_journal(stream)
        self._send_create(replica, stream)
        if self._throttle_on:
            # admitted INTO an active overload: this source starts
            # capped like everyone else, not at full rate
            stream.throttled = True
            self.telemetry.throttled.inc()
            self._send_throttle(stream, self.policy.throttle_rate)
        self._update_share()

    def _lease_jitter(self, stream_id: str) -> float:
        from ..runtime.lease import jitter_fraction
        seed = self.faults.seed if self.faults is not None else 0
        return jitter_fraction(seed, stream_id, salt="gw-lease")

    def _stream_lease_expired(self, stream_id) -> None:
        _LOGGER.info("%s: stream %s lease expired", self.name, stream_id)
        self.destroy_stream(stream_id)

    def _reject_stream(self, stream_id, reason, topic_response,
                       queue_response) -> None:
        """Typed shed: the caller learns WHY, immediately -- never
        silent queue growth (Clockwork-style admission)."""
        self.telemetry.shed_streams.inc()
        self.telemetry.record_shed_stream(stream_id, reason)
        _LOGGER.info("%s: stream %s shed (%s)", self.name, stream_id,
                     reason)
        if topic_response:
            self.process.publish(
                topic_response,
                generate("overloaded", [stream_id, "", reason]))
        if queue_response is not None:
            queue_response.put(
                (stream_id, None, {"reason": reason}, "overloaded"))

    def process_frame(self, stream_dict, frame_data=None) -> None:
        try:
            if isinstance(stream_dict, str):
                stream_dict = json.loads(stream_dict)
            if isinstance(frame_data, str):
                frame_data = decode_frame_data(frame_data)
        except (ValueError, KeyError) as error:
            _LOGGER.warning("%s: undecodable frame dropped: %s",
                            self.name, error)
            return
        stream_id = str(stream_dict.get("stream_id", ""))
        stream = self.streams.get(stream_id)
        if stream is None:
            _LOGGER.debug("%s: frame for unknown stream %s dropped",
                          self.name, stream_id)
            return
        if stream.lease is not None:
            stream.lease.extend()
        frame_id = stream_dict.get("frame_id")
        frame_id = (stream.cursor if frame_id is None else int(frame_id))
        if frame_id >= stream.cursor:
            stream.cursor = frame_id + 1
        if stream.is_delivered(frame_id) or frame_id in stream.inflight:
            self.telemetry.duplicates.inc()
            return
        # SLO-aware shed: when the estimated queue wait already blows
        # the stream's declared SLO, rejecting NOW beats serving late
        if stream.slo_ms > 0 and self._parked:
            rate = self._completion_rate()
            if rate is not None:
                est_wait_ms = len(self._parked) / rate * 1000.0
                if est_wait_ms > stream.slo_ms:
                    self._shed_frame(stream, frame_id, "slo")
                    return
        seq = self._seq = self._seq + 1
        entry = [frame_data or {}, time.monotonic(), seq]
        stream.inflight[frame_id] = entry
        # root-span ownership: the gateway mints the frame's fleet-wide
        # trace here, at admission -- every replica that later serves
        # this frame CONTINUES the same trace (context rides the wire
        # in _send_frame).  None with telemetry off: zero trace bytes
        trace = self.telemetry.frame_begin(stream_id, frame_id)
        if trace is not None:
            stream.traces[frame_id] = trace
        self._mark_journal(stream)
        replica = stream.replica
        dispatchable = (replica is not None
                        and replica.has_capacity(self.policy)
                        and stream.parked == 0)
        if dispatchable and self.disagg is not None:
            # disaggregated hop 1: the least-loaded prefill replica
            # computes the prompt and returns a KV handoff; hop 2
            # (_prefill_done) forwards it to the pinned decode replica.
            # No prefill capacity -> straight to decode (local prefill)
            prefill = self._place_prefill(time.monotonic())
            if prefill is not None:
                if prefill.topic_path not in stream.prefill_created:
                    # the stream pins to its DECODE replica; a prefill
                    # replica only needs enough stream state to run
                    # prompt frames, created on first use
                    stream.prefill_created.add(prefill.topic_path)
                    self._send_create(prefill, stream)
                entry.append(("prefill", prefill.topic_path))
                self.telemetry.prefill_routed.inc()
                self._send_frame(prefill, stream, frame_id, entry)
                return
        if dispatchable:
            self._send_frame(replica, stream, frame_id, entry)
        else:
            self._park(stream, frame_id, seq)

    def destroy_stream(self, stream_id) -> None:
        stream_id = str(stream_id)
        stream = self.streams.pop(stream_id, None)
        if stream is None:
            return
        if stream.lease is not None:
            stream.lease.terminate()
            stream.lease = None
        parked_ids = {item[3] for item in list(self._parked)
                      if item[2] == stream_id}
        # paced failover replays that never fired behave like parked
        # entries: in inflight, but no replica slot was ever taken.
        # Dropping the cohort entry here is what keeps the later
        # scheduled _paced_replay a no-op (its pop finds nothing) --
        # a destroyed stream must never leak a replay dispatch
        paced = self._paced_frames.pop(stream_id, None)
        if paced is not None:
            parked_ids |= set(paced["ids"])
            self.telemetry.recovery_paced_pending.set(
                len(self._paced_frames))
        if stream.parked:
            self._parked = [item for item in list(self._parked)
                            if item[2] != stream_id]
            stream.parked = 0
            self._note_queue_depth()
        replica = stream.replica
        # frames mid-prefill-hop hold a PREFILL replica's slot, not the
        # pinned decode replica's -- release each where it was sent
        staged = 0
        for frame_id, entry in stream.inflight.items():
            if frame_id in parked_ids or len(entry) <= 3:
                continue
            staged += 1
            prefill = self.replicas.get(entry[3][1])
            if prefill is not None:
                prefill.outstanding = max(0, prefill.outstanding - 1)
                prefill.note_load(time.monotonic(), self.policy)
        if replica is not None:
            replica.streams.discard(stream_id)
            # only DISPATCHED frames hold replica slots: parked entries
            # never incremented outstanding
            replica.outstanding = max(
                0, replica.outstanding - (sum(
                    1 for frame_id in stream.inflight
                    if frame_id not in parked_ids) - staged))
            replica.note_load(time.monotonic(), self.policy)
            self._send_destroy(replica, stream_id)
        for topic_path in stream.prefill_created:
            prefill = self.replicas.get(topic_path)
            if prefill is not None:
                self._send_destroy(prefill, stream_id)
        for trace in stream.traces.values():
            # frames still open at destroy: finish their root spans so
            # the admission wait they DID accrue still exports
            self.telemetry.frame_done(trace, status="destroyed")
        stream.traces.clear()
        stream.dispatch_s.clear()
        self.telemetry.forget_stream(stream_id)
        stream.inflight.clear()
        self._journal_forget(stream_id)
        self._update_share()
        self._drain_parked()

    # -- replica dispatch --------------------------------------------------

    def _send_create(self, replica: _Replica, stream: _GatewayStream,
                     first_frame_id: int = 0) -> None:
        if replica.pipeline is not None:
            replica.pipeline.post_message("create_stream", [
                stream.stream_id, dict(stream.parameters),
                stream.grace_time, self.topic_in,
                _LocalResponder(self), None, first_frame_id])
        else:
            # positional wire call: queue_response/graph_path ride as
            # None placeholders (the codec renders them as empty lists;
            # the pipeline coerces falsy back to None) so
            # first_frame_id -- the failover cursor -- arrives intact
            self.process.publish(
                f"{replica.topic_path}/in",
                generate("create_stream", [
                    stream.stream_id,
                    json.dumps(stream.parameters).encode("ascii"),
                    stream.grace_time, self.topic_in, None, None,
                    first_frame_id]))

    def _send_destroy(self, replica: _Replica, stream_id: str) -> None:
        if replica.pipeline is not None:
            replica.pipeline.post_message("destroy_stream", [stream_id])
        elif replica.topic_path:
            self.process.publish(
                f"{replica.topic_path}/in",
                generate("destroy_stream", [stream_id]))

    def _send_frame(self, replica: _Replica, stream: _GatewayStream,
                    frame_id: int, entry: list, data=None) -> None:
        """Route one frame to `replica`, consulting the seeded
        `replica_kill` fault point first (one consult per ROUTED frame:
        frame=k kills the replica on its k-th routed frame).  `data`
        overrides the wire payload (the disagg decode hop sends the
        original frame data MERGED with the prefill handoff; entry[0]
        stays the original so failover replay restarts from scratch)."""
        if (self.faults is not None and not replica.dead
                and self.faults.replica_kill(replica.name)):
            _LOGGER.warning(
                "%s: injected replica_kill fired on %s (frame %s/%s)",
                self.name, replica.name, stream.stream_id, frame_id)
            # fence NOW (no further dispatch picks this replica) but
            # defer the failover to its own mailbox turn: running it
            # inline would reenter _drain_parked / the replay loop
            # mid-iteration (stale snapshot removes, double dispatch).
            # The un-dispatched frame stays in stream.inflight; the
            # deferred replay re-routes it with everything else
            replica.dead = True
            self.post_message("_replica_lost", [
                replica.topic_path, "injected replica_kill"])
            return
        if (stream.restore_hint is not None and data is None
                and replica.pool_role() != "prefill"):
            # one-shot warm-restore for an ADOPTED stream: its journal
            # rebuild had no inflight frames to replay, so the FIRST
            # frame dispatched after adoption (the client's
            # resubmission) carries the restore hint -- the decode
            # replica adopts the checkpointed KV and re-decodes only
            # the post-snapshot tail instead of cold re-prefilling
            data = dict(entry[0])
            restore = dict(stream.restore_hint)
            adopt_trace = stream.traces.get(frame_id)
            if adopt_trace is not None:
                restore["trace_context"] = make_trace_context(
                    adopt_trace)
            data["restore"] = restore
            stream.restore_hint = None
        route_start = time.perf_counter()
        replica.outstanding += 1
        replica.routed += 1
        replica.note_load(time.monotonic(), self.policy)
        self.telemetry.routed.inc()
        self.telemetry.record_replica_routed(replica.name)
        payload = entry[0] if data is None else data
        trace = stream.traces.get(frame_id)
        if trace is not None:
            if frame_id not in stream.dispatch_s:
                # FIRST dispatch closes the admit-wait span (submit ->
                # dispatch, parked wait included); re-dispatches (disagg
                # hop 2, failover replay) extend the same trace without
                # a second admission
                wait_s = self.telemetry.record_admit_wait(trace)
                self.telemetry.record_stage(stream.stream_id, "queue",
                                            wait_s)
            stream.dispatch_s[frame_id] = route_start
            self.telemetry.record_route(trace, route_start,
                                        replica.name,
                                        pool=replica.pool_role())
            self.telemetry.record_stage(
                stream.stream_id, "route",
                time.perf_counter() - route_start)
            # propagation: the trace context rides the frame data (a
            # COPY -- entry[0] stays pristine for replay byte-equality)
            # so the replica continues the gateway's trace
            payload = attach_trace_context(payload,
                                           make_trace_context(trace))
        if replica.pipeline is not None:
            replica.pipeline.post_message("process_frame", [
                {"stream_id": stream.stream_id, "frame_id": frame_id},
                payload])
        else:
            self.process.publish(
                f"{replica.topic_path}/in",
                generate("process_frame", [
                    {"stream_id": stream.stream_id, "frame_id": frame_id},
                    encode_frame_data(payload).encode("ascii")]))

    # -- parked queue / backpressure ---------------------------------------

    def _park(self, stream: _GatewayStream, frame_id: int,
              seq: int) -> None:
        policy = self.policy
        if policy.queue_capacity <= 0:
            self._shed_frame(stream, frame_id, "queue_disabled")
            return
        if len(self._parked) >= policy.queue_capacity:
            # full: the LOWEST-priority (then newest) parked entry goes
            # first; if the incoming frame IS lowest, shed it directly
            worst = max(self._parked)
            incoming = (stream.priority, seq, stream.stream_id, frame_id)
            if incoming[:2] >= worst[:2]:
                self._shed_frame(stream, frame_id, "queue_full")
                return
            self._parked.remove(worst)
            victim = self.streams.get(worst[2])
            if victim is not None:
                victim.parked = max(0, victim.parked - 1)
                self._shed_frame(victim, worst[3], "queue_full")
        self._parked.append(
            (stream.priority, seq, stream.stream_id, frame_id))
        stream.parked += 1
        self._note_queue_depth()
        self._update_backpressure()

    def _shed_frame(self, stream: _GatewayStream, frame_id: int,
                    reason: str) -> None:
        stream.inflight.pop(frame_id, None)
        stream.dispatch_s.pop(frame_id, None)
        trace = stream.traces.pop(frame_id, None)
        if trace is not None:
            self.telemetry.record_shed_span(trace, reason)
            self.telemetry.frame_done(trace, status="shed")
        else:
            # pre-admission sheds (SLO estimate) fire before the frame
            # trace exists: a global gateway-lane instant instead
            self.telemetry.record_shed_stream(stream.stream_id, reason)
        self.telemetry.shed_frames.inc()
        if stream.topic_response:
            self.process.publish(
                stream.topic_response,
                generate("overloaded",
                         [stream.stream_id, frame_id, reason]))
        if stream.queue_response is not None:
            stream.queue_response.put(
                (stream.stream_id, frame_id, {"reason": reason}, "shed"))

    def _drain_parked(self) -> None:
        """Dispatch parked frames whose pinned replica has capacity,
        highest-priority-oldest first.  Per-stream order is preserved:
        entries carry monotonically increasing seqs and a stream's
        frames never skip the queue while older siblings wait.

        Always falls through to the watermark check, even when the
        queue is already empty: destroy_stream/_fail_stream can empty
        the queue without any dispatch, and a latched throttle-on with
        capped sources would otherwise never observe the low-water
        crossing that lifts the caps."""
        progress = bool(self._parked)
        while progress and self._parked:
            progress = False
            for item in sorted(self._parked):
                if item not in self._parked:
                    continue  # removed by an earlier pass over the snapshot
                priority, seq, stream_id, frame_id = item
                stream = self.streams.get(stream_id)
                if stream is None:
                    self._parked.remove(item)
                    progress = True
                    continue
                entry = stream.inflight.get(frame_id)
                if entry is None:
                    self._parked.remove(item)
                    stream.parked = max(0, stream.parked - 1)
                    progress = True
                    continue
                # only the stream's OLDEST parked frame may dispatch
                oldest = min(
                    (other for other in list(self._parked)
                     if other[2] == stream_id),
                    default=item)
                if oldest != item:
                    continue
                replica = stream.replica
                if replica is None or not replica.has_capacity(
                        self.policy):
                    continue
                self._parked.remove(item)
                stream.parked = max(0, stream.parked - 1)
                self._send_frame(replica, stream, frame_id, entry)
                progress = True
        self._note_queue_depth()
        self._update_backpressure()

    def _note_queue_depth(self) -> None:
        self.telemetry.parked.set(len(self._parked))
        if self.telemetry.enabled:
            depths: dict[int, int] = {}
            for priority, _, _, _ in list(self._parked):
                depths[priority] = depths.get(priority, 0) + 1
            # zero-fill priorities reported before: a drained priority
            # must read 0, not its last nonzero value, in the snapshot
            for priority in self._depth_priorities - set(depths):
                depths[priority] = 0
            self._depth_priorities |= set(depths)
            self.telemetry.record_queue_depths(depths)

    def _update_backpressure(self) -> None:
        """Throttle hysteresis over queue occupancy: past the
        high-water mark every active stream's source is asked to slow
        to `throttle_rate`; once the queue drains below the low-water
        mark the cap is lifted (rate 0)."""
        policy = self.policy
        capacity = policy.queue_capacity
        if capacity <= 0:
            return
        occupancy = len(self._parked) / capacity
        if not self._throttle_on and occupancy >= policy.throttle_high:
            self._throttle_on = True
            self._signal_throttle(policy.throttle_rate)
        elif self._throttle_on and occupancy <= policy.throttle_low:
            self._throttle_on = False
            self._signal_throttle(0.0)

    def _signal_throttle(self, rate: float) -> None:
        self.telemetry.record_throttle_span(rate)
        counter = (self.telemetry.throttled if rate > 0
                   else self.telemetry.unthrottled)
        for stream in list(self.streams.values()):
            throttling = rate > 0
            if stream.throttled == throttling:
                continue
            stream.throttled = throttling
            counter.inc()
            self._send_throttle(stream, rate)

    def _send_throttle(self, stream: _GatewayStream, rate: float) -> None:
        if stream.throttle is not None:
            try:
                stream.throttle(stream.stream_id, rate)
            except Exception:   # a client callback must not kill us
                _LOGGER.exception("%s: throttle callback failed",
                                  self.name)
        # the wire form: sources subscribed to the gateway /out (or
        # a fronted pipeline's own throttle command) slow down
        self.publish_out("throttle", [stream.stream_id, rate])

    # -- responses ---------------------------------------------------------

    def process_frame_response(self, stream_dict, frame_data=None) -> None:
        """A replica answered (success via the local responder or the
        wire; error/drop via the stream's topic_response notice)."""
        try:
            if isinstance(stream_dict, str):
                stream_dict = json.loads(stream_dict)
        except ValueError as error:
            _LOGGER.warning("%s: undecodable frame response dropped: %s",
                            self.name, error)
            return
        stream_id = str(stream_dict.get("stream_id", ""))
        stream = self.streams.get(stream_id)
        if stream is None:
            return
        frame_id = int(stream_dict.get("frame_id", 0))
        event = stream_dict.get("event")
        if isinstance(frame_data, str):
            try:
                frame_data = decode_frame_data(frame_data)
            except (ValueError, KeyError):
                event = event or "error"
                frame_data = {}
        self._frame_done(stream, frame_id, frame_data or {}, event)

    def _dead_letter_handler(self, topic: str, payload: str) -> None:
        """A replica dead-lettered a frame: release the slot as
        an error.  Runs on the process message pump; route through the
        mailbox to keep actor ordering."""
        try:
            command, parameters = parse(payload)
        except ValueError:
            return
        if command != "dead_letter" or not parameters:
            return
        meta = parameters[0] if isinstance(parameters[0], dict) else {}
        from ..runtime import ActorTopic
        # a dead-letter frees a replica slot: preempt queued submissions
        self.post_message("_release_dead_letter", [
            meta.get("stream_id", ""), meta.get("frame_id", -1),
            meta.get("reason", "dead_letter")],
            actor_topic=ActorTopic.CONTROL)

    def _release_dead_letter(self, stream_id, frame_id, reason) -> None:
        stream = self.streams.get(str(stream_id))
        if stream is None:
            return
        try:
            frame_id = int(frame_id)
        except (TypeError, ValueError):
            return
        self._frame_done(stream, frame_id, {"reason": str(reason)},
                         event="error")

    def _frame_done(self, stream: _GatewayStream, frame_id: int,
                    outputs: dict, event=None) -> None:
        staged = stream.inflight.get(frame_id)
        if (staged is not None and len(staged) > 3
                and not stream.is_delivered(frame_id)):
            # disaggregated hop 1 answered: forward to the decode pool
            # instead of completing the frame
            self._prefill_done(stream, frame_id, staged, outputs, event)
            return
        entry = stream.inflight.pop(frame_id, None)
        if entry is None or stream.is_delivered(frame_id):
            self.telemetry.duplicates.inc()
            return
        trace = stream.traces.pop(frame_id, None)
        dispatched_s = stream.dispatch_s.pop(frame_id, None)
        if dispatched_s is not None:
            # decomposition: pinned-replica service time (dispatch ->
            # response) is the stream's `decode` share -- the prefill
            # hop's share was credited by _prefill_done
            self.telemetry.record_stage(
                stream.stream_id, "decode",
                time.perf_counter() - dispatched_s)
        emit_start = (time.perf_counter() if trace is not None else 0.0)
        stream.delivered.add(frame_id)
        # collapse the contiguous delivered prefix into the floor: the
        # dedupe state a long-lived stream keeps is one int + the
        # sparse out-of-order tail, and the floor is what the crash
        # journal persists as the exactly-once high-water mark
        while stream.delivered_floor + 1 in stream.delivered:
            stream.delivered_floor += 1
            stream.delivered.discard(stream.delivered_floor)
        if len(stream.delivered) > 8192:
            # bounded backstop for pathologically sparse delivery: ids
            # far below the cursor can no longer recur
            floor = stream.cursor - 4096
            stream.delivered = {fid for fid in stream.delivered
                                if fid >= floor}
        self._mark_journal(stream)
        replica = stream.replica
        if replica is not None:
            replica.outstanding = max(0, replica.outstanding - 1)
            replica.note_load(time.monotonic(), self.policy)
        now = time.monotonic()
        if event:
            self.telemetry.released.inc()
            status = "error" if event == "error" else "dropped"
        else:
            self.telemetry.completed.inc()
            self.telemetry.latency.record(now - entry[1])
            if stream.slo_ms > 0:
                # per-priority (and per-tenant) SLO attainment:
                # completed frames judged against the stream's
                # declared end-to-end budget
                self.telemetry.record_slo(
                    stream.priority,
                    (now - entry[1]) * 1000.0 <= stream.slo_ms,
                    tenant=stream.tenant or None)
            self._completions.append(now)
            if len(self._completions) > _RATE_WINDOW:
                del self._completions[:len(self._completions)
                                      - _RATE_WINDOW]
            status = "ok"
        if stream.queue_response is not None:
            stream.queue_response.put(
                (stream.stream_id, frame_id, outputs, status))
        elif stream.topic_response:
            reply = {"stream_id": stream.stream_id, "frame_id": frame_id}
            if event:
                reply["event"] = event
                self.process.publish(
                    stream.topic_response,
                    generate("process_frame_response", [reply]))
            else:
                self.process.publish(
                    stream.topic_response,
                    generate("process_frame_response", [
                        reply,
                        encode_frame_data(outputs).encode("ascii")]))
        if trace is not None:
            self.telemetry.record_stage(
                stream.stream_id, "emit",
                time.perf_counter() - emit_start)
            self.telemetry.frame_done(trace, status=status)
        self._drain_parked()

    def _prefill_done(self, stream: _GatewayStream, frame_id: int,
                      entry: list, outputs, event=None) -> None:
        """Hop 2 of the disaggregated path: the prefill replica
        answered -- release its slot and forward the frame to the
        pinned decode replica with the KV handoff merged into the
        payload.  A prefill error/drop (or a response without a
        handoff) degrades to the direct dispatch: the decode replica
        prefills locally, the stream never notices."""
        stage_topic = entry[3][1]
        del entry[3:]               # back to the plain replay shape
        dispatched_s = stream.dispatch_s.get(frame_id)
        if dispatched_s is not None:
            # decomposition: the disagg hop-1 share (dispatch ->
            # prefill response); hop 2's dispatch re-stamps below
            self.telemetry.record_stage(
                stream.stream_id, "prefill",
                time.perf_counter() - dispatched_s)
        prefill = self.replicas.get(stage_topic)
        if prefill is not None:
            prefill.outstanding = max(0, prefill.outstanding - 1)
            prefill.note_load(time.monotonic(), self.policy)
        handoff = None
        if not event and isinstance(outputs, dict):
            handoff = outputs.get("handoff")
        if handoff is not None:
            self.telemetry.kv_migrations.inc()
        else:
            self.telemetry.prefill_fallbacks.inc()
        replica = stream.replica
        if (replica is not None and replica.has_capacity(self.policy)
                and stream.parked == 0):
            data = entry[0]
            if handoff is not None:
                data = dict(entry[0])
                data["handoff"] = handoff
            self._send_frame(replica, stream, frame_id, entry,
                             data=data)
        else:
            # parks replay the ORIGINAL frame data when they drain (the
            # handoff's transfer keys may expire while parked); the
            # decode replica prefills locally -- degraded, never lost
            self._park(stream, frame_id, entry[2])

    def _recover_prefill_frames(self, topic_path: str,
                                redispatch: bool = True) -> None:
        """A prefill replica left the pool with frames mid-hop: those
        frames belong to streams pinned to DECODE replicas, so stream
        migration never sees them.  On replica DEATH (redispatch=True)
        each is sent directly to its pinned decode replica (local
        re-prefill) -- the disagg analogue of failover replay, zero
        frames lost.  On a graceful DRAIN the frames are left in
        flight: the draining replica keeps serving through its linger
        window and its handoff responses forward normally; a
        re-dispatch here would race them -- the stale prefill response
        would arrive against a de-staged entry and be DELIVERED to the
        client as the frame's final output."""
        for stream in list(self.streams.values()):
            # a restarted prefill process must get a fresh create
            stream.prefill_created.discard(topic_path)
            if not redispatch:
                continue
            for frame_id, entry in list(stream.inflight.items()):
                if len(entry) <= 3 or entry[3][1] != topic_path:
                    continue
                del entry[3:]
                self.telemetry.prefill_fallbacks.inc()
                replica = stream.replica
                if (replica is not None
                        and replica.has_capacity(self.policy)
                        and stream.parked == 0):
                    self._send_frame(replica, stream, frame_id, entry)
                else:
                    self._park(stream, frame_id, entry[2])

    def _completion_rate(self) -> float | None:
        """Completions/sec over the recent window (None until warm):
        the denominator of the SLO queue-wait estimate."""
        if len(self._completions) < _RATE_WARMUP:
            return None
        window = self._completions[-1] - self._completions[0]
        if window <= 0:
            return None
        return (len(self._completions) - 1) / window

    def _fail_stream(self, stream: _GatewayStream, reason: str) -> None:
        _LOGGER.error("%s: stream %s failed (%s); releasing %d in-flight"
                      " frames", self.name, stream.stream_id, reason,
                      len(stream.inflight))
        for frame_id in sorted(stream.inflight):
            self.telemetry.released.inc()
            if stream.queue_response is not None:
                stream.queue_response.put(
                    (stream.stream_id, frame_id, {"reason": reason},
                     "error"))
            elif stream.topic_response:
                self.process.publish(
                    stream.topic_response,
                    generate("process_frame_response", [
                        {"stream_id": stream.stream_id,
                         "frame_id": frame_id, "event": "error"}]))
        for trace in stream.traces.values():
            self.telemetry.frame_done(trace, status="error")
        stream.traces.clear()
        stream.dispatch_s.clear()
        self.telemetry.forget_stream(stream.stream_id)
        stream.inflight.clear()
        if self._paced_frames.pop(stream.stream_id, None) is not None:
            self.telemetry.recovery_paced_pending.set(
                len(self._paced_frames))
        if stream.parked:
            self._parked = [item for item in list(self._parked)
                            if item[2] != stream.stream_id]
            stream.parked = 0
            self._note_queue_depth()
        if stream.lease is not None:
            stream.lease.terminate()
            stream.lease = None
        self.streams.pop(stream.stream_id, None)
        self._journal_forget(stream.stream_id)
        self._update_share()

    # -- live reconfiguration ------------------------------------------------
    #
    # Every setter mutates the RUNNING configuration in place -- no
    # restart, no stream disruption, no recompile (the JAX package's
    # autopilot applies its deltas through these).

    def set_bucket_rate(self, priority, rate, burst=None) -> None:
        """Live-retune (or create) one admission token bucket.  The
        current token level is preserved (clamped to a shrunk burst):
        a rate change must not refund or confiscate in-flight budget."""
        from .policy import TokenBucket
        priority = int(priority)
        rate = max(float(rate), 1e-9)
        bucket = self.policy.buckets.get(priority)
        if bucket is None:
            self.policy.buckets[priority] = TokenBucket(
                rate, float(burst) if burst else max(rate, 1.0))
        else:
            bucket.rate = rate
            if burst:
                bucket.burst = float(burst)
                bucket.tokens = min(bucket.tokens, bucket.burst)
        if self.journal is not None and self.role != "standby":
            self._buckets_dirty = True

    def set_replica_parameter(self, element_name, name, value) -> int:
        """Broadcast one element-parameter change to every live
        replica: direct-attached pipelines take the in-process call,
        wire replicas get `(set_element_parameter ...)` on their `in`
        topic.  Parameters like micro_batch / checkpoint_every are
        re-read per batch flush / checkpoint tick, so the new value
        takes effect on the next frame without a restart."""
        updated = 0
        for replica in list(self.replicas.values()):
            if replica.dead or replica.draining:
                continue
            if replica.pipeline is not None:
                try:
                    replica.pipeline.set_element_parameter(
                        element_name, name, value)
                    updated += 1
                except Exception as error:
                    _LOGGER.warning(
                        "%s: set %s.%s on %s failed: %s", self.name,
                        element_name, name, replica.name, error)
            else:
                self.process.publish(
                    f"{replica.topic_path}/in",
                    generate("set_element_parameter",
                             [str(element_name), str(name),
                              str(value)]))
                updated += 1
        return updated

    # -- observability -----------------------------------------------------

    def publish_trace(self, topic_response) -> None:
        """Wire query (`aiko trace collect`): publish this gateway's
        self-describing Perfetto document, so a collector harvests the
        fleet's per-process artifacts without filesystem access.  The
        reply shape lives in observe/collector.py (shared with
        Pipeline)."""
        from ..observe import publish_trace_document
        publish_trace_document(self.process, self.telemetry,
                               self.topic_path, topic_response)

    def pool_snapshot(self) -> dict:
        """Per-replica pool view (replica topic, state, load gauges,
        warm/cold) -- rendered by `aiko system status` and the
        dashboard's `pool:` row; rides the periodic telemetry summary
        into the EC share so remote observers see it."""
        pool = {}
        for replica in list(self.replicas.values()):
            pool[replica.name] = {
                "topic": replica.topic_path,
                "state": "draining" if replica.draining else "live",
                "outstanding": replica.outstanding,
                "inflight": replica.reported_inflight(),
                "queue_depth": replica.reported_queue_depth(),
                "streams": len(replica.streams),
                "warm": replica.warm,
                "role": replica.pool_role(),
            }
        return pool

    def _update_share(self) -> None:
        self.telemetry.replicas.set(len(self.replicas))
        self.telemetry.pool_size.set(len(self.replicas))
        if self.ec_producer is not None:
            # staged: a stream-churn storm (create/destroy per frame at
            # O(10k) streams) folds its share refreshes into one delta
            # per drained mailbox burst, and unchanged scalars
            # (replica_count, role) drop out of the payload entirely
            self.ec_producer.stage("replica_count", len(self.replicas))
            self.ec_producer.stage("stream_count", len(self.streams))
            self.ec_producer.stage("role", self.role)

    def stop(self) -> None:
        if not hasattr(self, "election"):
            # construction raised before wiring completed (a rejected
            # policy spec): process teardown finds nothing to stop --
            # every constructor raise precedes the election attribute
            return
        self.telemetry.stop()
        for stream_id in list(self.streams):
            self.destroy_stream(stream_id)
        for journal in list(self._foreign_journals.values()):
            journal.stop()
        self._foreign_journals.clear()
        if self.journal is not None:
            # a CLEAN stop clears the journal (every stream destroyed
            # above was forgotten): a later restart must not re-pin
            # streams this incarnation deliberately tore down
            self._journal_tick()
            self._stop_journal_tick()
            self.journal.stop()
            self.journal = None
        if self.election is not None:
            # clean handover LAST: the retained "(primary absent)" lets
            # a standby promote without waiting on our LWT, and it must
            # not fire until teardown has settled the journal -- a
            # standby racing our destroy loop could otherwise adopt
            # records we are mid-way through forgetting
            self.election.stop()
            self.election = None
        for replica in list(self.replicas.values()):
            self._detach_replica(replica)
        self.replicas.clear()
        if (self._services_cache is not None
                and self._discovery_handler is not None):
            self._services_cache.remove_handler(self._discovery_handler)
            self._discovery_handler = None
        super().stop()
