# Elastic replica fleet: load-driven autoscaling with warm-start
# replicas.
#
# The gateway (serve/gateway.py) routes over a replica pool but, until
# this controller, the pool was FIXED: a 2x load swing either shed
# traffic forever or wasted idle cards.  The AutoScaler closes the loop
# the lifecycle layer (runtime/lifecycle.py, runtime/process_manager.py)
# was built for:
#
#   signal    the per-replica load gauges the gateway already mirrors --
#             `outstanding` routed frames per replica plus the parked
#             queue depth -- folded into one fleet utilization number
#             (demand / (live replicas x max_inflight))
#   decide    high watermark -> spawn a replica; low watermark -> drain
#             one; a cooldown between decisions stops flapping, and a
#             min/max band bounds the pool
#   spawn     a ReplicaFactory brings the replica up OFF the gateway's
#             event loop; warm start = a live sibling streams its
#             initialized params over the transfer plane
#             (Pipeline.export_weights / import_weights) AND the
#             kernel build cache (runtime/compile_cache.py) hands it
#             the CUDA libraries the fleet already built with nvcc, so
#             time-to-healthy is hand-off + library load, not an nvcc
#             build per kernel source
#   drain     scale-down re-pins the victim's streams and replays
#             cursors through the gateway's zero-loss failover path
#             (Gateway.drain_replica -> _migrate_streams): bit-identical
#             to an unscaled run, never a dropped frame
#
# The policy parses through the shared directive-grammar core
# (analyze/grammar.py), so a typo'd spec fails construction with the
# same AIKO406/AIKO404 codes `aiko lint` reports offline.
#
# The port's copy of aiko_services_tpu/serve/autoscale.py: the same
# policy, controller and factories; a replica's spawn info also counts
# its CUDA-graph captures (runtime/compile_cache.py says why those are
# reported, not required to be zero), and ProcessReplicaFactory runs
# `python -m aiko_services_tpu_torch pipeline` under a ProcessManager.

from __future__ import annotations

import threading
import time

from ..analyze.grammar import DirectiveGrammar, Field
from ..runtime.lease import Lease
from ..utils import get_logger

__all__ = ["AUTOSCALE_GRAMMAR", "AutoScaler", "InProcessReplicaFactory",
           "ProcessReplicaFactory", "ScalePolicy"]

_LOGGER = get_logger("autoscale")

DEFAULT_MIN_REPLICAS = 1
DEFAULT_MAX_REPLICAS = 2
DEFAULT_HIGH_WATER = 0.75
DEFAULT_LOW_WATER = 0.2
DEFAULT_COOLDOWN_S = 5.0
DEFAULT_DRAIN_TIMEOUT_S = 2.0
DEFAULT_INTERVAL_S = 0.5
DEFAULT_SPAWN_TIMEOUT_S = 300.0

# Grammar (gateway parameter `autoscale`, same directive style as the
# admission policy and fault spec):
#
#   policy    := directive (";" directive)*
#   directive := "min_replicas=" int    pool floor (repaired even inside
#                                       the cooldown window)
#              | "max_replicas=" int    pool ceiling
#              | "high_water=" float    fleet utilization that triggers
#                                       a spawn (demand / capacity)
#              | "low_water=" float     utilization that triggers a
#                                       drain-then-retire
#              | "cooldown=" float      seconds between scale decisions
#              | "drain_timeout=" float seconds a drained replica's
#                                       backing process lingers (its
#                                       in-flight responses settle;
#                                       replay covers the rest)
#              | "interval=" float      controller evaluation period
#              | "spawn_timeout=" float seconds before a spawn that
#                                       never became healthy is written
#                                       off (frees its pool slot)
#              | "warm_start=" flag     hand off sibling weights to new
#                                       replicas (default on)
#
# Example: "min_replicas=1;max_replicas=4;high_water=0.8;cooldown=10"
AUTOSCALE_GRAMMAR = DirectiveGrammar(
    "autoscale policy",
    options={
        "min_replicas": Field("int", minimum=0),
        "max_replicas": Field("int", minimum=1),
        "high_water": Field("float", minimum=0.0),
        "low_water": Field("float", minimum=0.0),
        "cooldown": Field("float", minimum=0.0),
        "drain_timeout": Field("float", minimum=0.0),
        "interval": Field("float", minimum=0.01),
        "spawn_timeout": Field("float", minimum=0.0),
        "warm_start": Field("flag"),
    })


class ScalePolicy:
    __slots__ = ("min_replicas", "max_replicas", "high_water",
                 "low_water", "cooldown_s", "drain_timeout_s",
                 "interval_s", "spawn_timeout_s", "warm_start", "spec")

    def __init__(self):
        self.min_replicas = DEFAULT_MIN_REPLICAS
        self.max_replicas = DEFAULT_MAX_REPLICAS
        self.high_water = DEFAULT_HIGH_WATER
        self.low_water = DEFAULT_LOW_WATER
        self.cooldown_s = DEFAULT_COOLDOWN_S
        self.drain_timeout_s = DEFAULT_DRAIN_TIMEOUT_S
        self.interval_s = DEFAULT_INTERVAL_S
        self.spawn_timeout_s = DEFAULT_SPAWN_TIMEOUT_S
        self.warm_start = True
        self.spec = ""

    @classmethod
    def parse(cls, spec) -> "ScalePolicy":
        """Parse a spec (directive string, dict of the same keys, or
        None for all defaults); cross-field constraints fail here so
        construction and offline lint stay one check."""
        policy = cls()
        if spec is None or spec == "":
            return policy
        if isinstance(spec, ScalePolicy):
            return spec
        parsed = AUTOSCALE_GRAMMAR.parse(spec)
        if not isinstance(spec, dict):
            policy.spec = str(spec)
        attributes = {
            "min_replicas": "min_replicas",
            "max_replicas": "max_replicas",
            "high_water": "high_water",
            "low_water": "low_water",
            "cooldown": "cooldown_s",
            "drain_timeout": "drain_timeout_s",
            "interval": "interval_s",
            "spawn_timeout": "spawn_timeout_s",
            "warm_start": "warm_start",
        }
        for key, value in parsed.options.items():
            setattr(policy, attributes[key], value)
        if policy.min_replicas > policy.max_replicas:
            raise ValueError(
                f"min_replicas {policy.min_replicas} must not exceed "
                f"max_replicas {policy.max_replicas}")
        if policy.low_water >= policy.high_water:
            raise ValueError(
                f"low_water {policy.low_water} must be below "
                f"high_water {policy.high_water} (equal watermarks "
                f"oscillate)")
        return policy

    def __repr__(self):
        return (f"ScalePolicy(replicas=[{self.min_replicas}, "
                f"{self.max_replicas}], water=[{self.low_water}, "
                f"{self.high_water}], cooldown={self.cooldown_s})")


class AutoScaler:
    """The gateway-owned controller: a periodic tick on the gateway's
    event loop (the same single-threaded scheduler that runs its
    mailbox, so every read of gateway state here is race-free) compares
    fleet utilization against the watermarks and drives the factory."""

    def __init__(self, gateway, policy=None, factory=None):
        try:
            self.policy = ScalePolicy.parse(policy)
        except ValueError as error:
            code = ("AIKO404" if getattr(error, "kind", "") == "unknown"
                    else "AIKO406")
            raise ValueError(
                f"{code}: autoscale policy rejected: {error}") from None
        self.gateway = gateway
        self.factory = factory
        self.pending = 0                  # spawns decided, not yet healthy
        self.spawns: list[dict] = []      # completed bring-up records
        self.draining: dict = {}          # topic_path -> retiring replica
        self._draining_handles: dict = {} # topic_path -> factory handle
        self._pending_spawns: dict = {}   # name -> decision record
        self._handles: dict = {}          # topic_path -> factory handle
        self._retiring: list[Lease] = []
        self._last_scale = 0.0
        self._below_low_since: float | None = None
        self._sequence = 0
        self._stopped = False
        # disaggregated fleets (gateway `disagg` policy + a factory
        # DICT {role: factory}): the two pools scale INDEPENDENTLY --
        # prefill on queue pressure, decode on slot occupancy -- each
        # with its own watermark state and per-pool floor
        self.disagg = getattr(gateway, "disagg", None)
        self._pool_state = {
            role: {"last_scale": 0.0, "below_low_since": None}
            for role in ("prefill", "decode")}
        self._pending_roles = {"prefill": 0, "decode": 0}
        self._handle_roles: dict = {}     # topic_path -> pool role
        self._last_prefill_fallbacks = 0
        gateway.process.event.add_timer_handler(
            self._tick, self.policy.interval_s)

    def _factory_for(self, role: str | None):
        if isinstance(self.factory, dict):
            return self.factory.get(role or "decode")
        # a single factory serves the one-pool (non-disagg) fleet and
        # the decode pool; it cannot spawn prefill replicas
        return self.factory if role in (None, "decode") else None

    # -- the control loop --------------------------------------------------

    def utilization(self) -> float | None:
        """Fleet demand / fleet capacity over LIVE (non-draining)
        replicas: routed frames in flight plus the gateway's parked
        queue, against pool_size x max_inflight.  None when there is
        neither capacity nor demand (an empty idle pool makes no
        decision); an empty pool WITH demand reads as infinite."""
        live = self._live()
        demand = (sum(replica.outstanding for replica in live)
                  + len(self.gateway._parked))
        capacity = len(live) * self.gateway.policy.max_inflight
        if capacity <= 0:
            return None if demand == 0 else float("inf")
        return demand / capacity

    def pool_utilization(self, role: str) -> float | None:
        """One disagg pool's scale signal.  The DECODE pool reads slot
        occupancy (routed frames + the parked queue over capacity),
        like the one-pool fleet.  The PREFILL pool reads QUEUE
        pressure: frames in flight at prefill replicas, frames queued
        inside them, and frames that fell back to local prefill since
        the last tick (demand the pool was too small to even see) --
        prefill work is one bounded kernel per frame, so waiting, not
        occupancy, is what blows TTFT."""
        live = self._live(role)
        if role == "prefill":
            fallbacks = self.gateway.telemetry.prefill_fallbacks.value
            delta = max(0, fallbacks - self._last_prefill_fallbacks)
            self._last_prefill_fallbacks = fallbacks
            demand = sum(replica.outstanding
                         + replica.reported_queue_depth()
                         for replica in live) + delta
        else:
            demand = (sum(replica.outstanding for replica in live)
                      + len(self.gateway._parked))
        capacity = len(live) * self.gateway.policy.max_inflight
        if capacity <= 0:
            return None if demand == 0 else float("inf")
        return demand / capacity

    def _live(self, role: str | None = None) -> list:
        return [replica for replica in self.gateway.replicas.values()
                if not replica.dead and not replica.draining
                and (role is None or replica.pool_role() == role)]

    def _tick(self) -> None:
        if self._stopped:
            return
        now = time.monotonic()
        if self.disagg is not None and isinstance(self.factory, dict):
            for role in ("decode", "prefill"):
                self._tick_pool(role, now)
            return
        live = self._live()
        size = len(live) + self.pending
        can_spawn = self.factory is not None
        if size < self.policy.min_replicas and can_spawn:
            # pool-floor repair ignores the cooldown: a death that drops
            # the fleet below min must heal now, not a cooldown later
            self._scale_up(now, live)
            return
        utilization = self.utilization()
        if utilization is None:
            return
        in_cooldown = now - self._last_scale < self.policy.cooldown_s
        if utilization > self.policy.low_water:
            self._below_low_since = None
        elif self._below_low_since is None:
            self._below_low_since = now
        if (utilization >= self.policy.high_water
                and size < self.policy.max_replicas
                and can_spawn
                and self.pending == 0 and not in_cooldown):
            self._scale_up(now, live)
        elif (self._below_low_since is not None
                # scale up fast, scale DOWN slow: one transiently idle
                # tick (a rejection storm between session retries reads
                # as zero demand) must not drain a replica the next
                # tick will need -- the low watermark has to hold for a
                # full cooldown window continuously
                and now - self._below_low_since >= self.policy.cooldown_s
                and len(live) > self.policy.min_replicas
                and self.pending == 0 and not in_cooldown):
            self._scale_down(now, live)
            self._below_low_since = None

    def _tick_pool(self, role: str, now: float) -> None:
        """One disagg pool's watermark pass: the same scale-up-fast /
        scale-down-slow state machine as the one-pool fleet, evaluated
        against THIS pool's signal, floor, and cooldown."""
        live = self._live(role)
        state = self._pool_state[role]
        pending = self._pending_roles[role]
        size = len(live) + pending
        floor = self.disagg.floor(role, self.policy.min_replicas)
        can_spawn = self._factory_for(role) is not None
        if size < floor and can_spawn:
            self._scale_up(now, live, role=role)
            return
        utilization = self.pool_utilization(role)
        if utilization is None:
            return
        in_cooldown = now - state["last_scale"] < self.policy.cooldown_s
        if utilization > self.policy.low_water:
            state["below_low_since"] = None
        elif state["below_low_since"] is None:
            state["below_low_since"] = now
        if (utilization >= self.policy.high_water
                and size < self.policy.max_replicas
                and can_spawn
                and pending == 0 and not in_cooldown):
            self._scale_up(now, live, role=role)
        elif (state["below_low_since"] is not None
                and now - state["below_low_since"]
                >= self.policy.cooldown_s
                and len(live) > floor
                and pending == 0 and not in_cooldown):
            self._scale_down(now, live, role=role)
            state["below_low_since"] = None

    # -- scale up ----------------------------------------------------------

    def _scale_up(self, now: float, live: list,
                  role: str | None = None) -> None:
        self._last_scale = now
        if role is not None:
            self._pool_state[role]["last_scale"] = now
        self._sequence += 1
        pool_tag = f"-{role}" if role is not None else ""
        name = f"{self.gateway.name}{pool_tag}-r{self._sequence}"
        warm_source = None
        if self.policy.warm_start:
            # warm-start from a SAME-POOL sibling: a prefill replica's
            # params are the right hand-off for a prefill spawn
            source = next((replica for replica in live
                           if replica.pipeline is not None), None)
            if source is not None:
                # hand the factory the SIBLING, not the exported tree:
                # export_weights copies every state leaf to host, and
                # this tick runs on the gateway's event loop at peak
                # overload -- the copy belongs on the spawn thread
                warm_source = source.pipeline
        warm = warm_source is not None
        self.pending += 1
        if role is not None:
            self._pending_roles[role] += 1
        self.gateway.telemetry.scale_ups.inc()
        record = self._pending_spawns[name] = {
            "decided": now, "warm": warm, "role": role}
        if self.policy.spawn_timeout_s > 0:
            # a spawn that never becomes healthy (child crashed during
            # bring-up, bad definition) must not hold its pool slot
            # forever -- `pending` gates every future scale decision
            record["lease"] = Lease(
                self.gateway.process.event, self.policy.spawn_timeout_s,
                name, lease_expired_handler=self._spawn_expired)
        _LOGGER.info("%s: scale UP -> spawning %s (%s%s)",
                     self.gateway.name, name,
                     "warm" if warm else "cold",
                     f", pool {role}" if role is not None else "")

        def ready(handle, info=None):
            # factory thread -> gateway CONTROL mailbox (see
            # Gateway._autoscale_ready)
            self.gateway.post_message("_autoscale_ready",
                                      [handle, info or {"name": name}])

        try:
            self._factory_for(role).spawn(name, warm_source=warm_source,
                                          ready=ready)
        except Exception as error:
            self._close_pending(name)
            _LOGGER.exception("%s: spawn %s failed to launch: %s",
                              self.gateway.name, name, error)

    def _close_pending(self, name: str):
        """Pop a pending-spawn record, stop its timeout lease, and free
        its pool slot; None when the name is not pending."""
        record = self._pending_spawns.pop(name, None)
        if record is None:
            return None
        lease = record.pop("lease", None)
        if lease is not None:
            lease.terminate()
        self.pending = max(0, self.pending - 1)
        role = record.get("role")
        if role is not None:
            self._pending_roles[role] = max(
                0, self._pending_roles[role] - 1)
        return record

    def _spawn_expired(self, name) -> None:
        if self._close_pending(str(name)) is not None:
            _LOGGER.error("%s: spawn %s never became healthy within "
                          "%.0f s; writing it off", self.gateway.name,
                          name, self.policy.spawn_timeout_s)

    def spawn_finished(self, handle, info: dict) -> None:
        """Mailbox continuation: the factory's bring-up finished (or
        failed).  In-process handles attach here; discovered (OS
        process) replicas attach through gateway.discover() and close
        their clock in note_replica_added instead."""
        name = str(info.get("name", ""))
        if info.get("error") or handle is None:
            self._close_pending(name)
            _LOGGER.error("%s: spawn %s failed: %s", self.gateway.name,
                          name, info.get("error", "no handle"))
            return
        record = self._pending_spawns.get(name)
        if record is None:
            # already written off (spawn_timeout lapsed and the slot
            # was re-planned): attaching this late arrival would push
            # the pool past max_replicas -- retire it instead
            _LOGGER.warning("%s: spawn %s finished after being written "
                            "off; retiring it", self.gateway.name, name)
            try:
                if self.factory is not None:
                    self._retire_handle(handle)
            except Exception:
                _LOGGER.exception("%s: late-spawn retire failed",
                                  self.gateway.name)
            return
        record.update({key: value for key, value in info.items()
                       if key != "name"})
        if "imported_elements" in info:
            # the factory resolves the hand-off now: a failed export
            # downgrades the spawn to cold, truthfully
            record["warm"] = bool(info["imported_elements"])
        pipeline = getattr(handle, "pipeline", None)
        if pipeline is None:
            # a handle the gateway cannot attach: close the books so
            # `pending` cannot wedge every future scale-up
            self._close_pending(name)
            _LOGGER.error("%s: spawn %s returned a handle without a "
                          ".pipeline; dropped", self.gateway.name, name)
            return
        self._handles[pipeline.topic_path] = handle
        self._handle_roles[pipeline.topic_path] = record.get("role")
        self.gateway.attach_replica(
            pipeline, warm=bool(record and record.get("warm")),
            role=record.get("role"))
        if name in self._pending_spawns:
            # attach ran note_replica_added synchronously; the record
            # still pending means the pipeline's name does not match
            # the spawn name (a callable definition ignoring `name`) --
            # close the books rather than wedging the controller
            self._close_pending(name)
            _LOGGER.warning("%s: spawn %s attached as %r (name "
                            "mismatch); bring-up stats dropped",
                            self.gateway.name, name, pipeline.name)

    def note_replica_added(self, replica) -> None:
        """Called from Gateway._add_replica for EVERY join: when the
        name matches a pending spawn, the time-to-healthy clock stops
        here -- the replica is attached and placeable."""
        record = self._close_pending(replica.name)
        if record is None:
            return
        replica.warm = bool(record.get("warm"))
        if replica.topic_path not in self._handles:
            # discovered (OS process) replica: the factory retires it
            # by NAME through its process manager
            self._handles[replica.topic_path] = replica.name
            self._handle_roles[replica.topic_path] = record.get("role")
        elapsed_ms = (time.monotonic() - record["decided"]) * 1000.0
        self.gateway.telemetry.record_spawn(elapsed_ms, replica.warm)
        entry = {"name": replica.name, "warm": replica.warm,
                 "time_to_healthy_ms": round(elapsed_ms, 2)}
        for key in ("cache_hits", "cache_misses", "cache_captures",
                    "imported_elements"):
            if key in record:
                entry[key] = record[key]
        self.spawns.append(entry)
        _LOGGER.info("%s: replica %s healthy in %.0f ms (%s)",
                     self.gateway.name, replica.name, elapsed_ms,
                     "warm" if replica.warm else "cold")

    def _retire_handle(self, handle, role: str | None = None) -> None:
        """Retire a handle through the owning factory; with a factory
        dict and no known role, every factory is offered the handle
        (retire is a tolerant no-op on a handle it never spawned)."""
        factory = self._factory_for(role)
        if factory is not None:
            factory.retire(handle)
            return
        if isinstance(self.factory, dict):
            for candidate in self.factory.values():
                candidate.retire(handle)

    # -- scale down --------------------------------------------------------

    def _scale_down(self, now: float, live: list,
                    role: str | None = None) -> None:
        if self.factory is not None:
            # only retire replicas this controller OWNS: draining a
            # discovered/manually-attached replica would leave its
            # process running detached forever (it never rejoins -- the
            # registrar entry predates the drain, so discovery fires no
            # new "add").  With no factory at all the pool is operator-
            # managed and a pure drain is exactly what was asked for
            candidates = [replica for replica in live
                          if replica.topic_path in self._handles]
        else:
            candidates = live
        if not candidates:
            return
        victim = min(candidates,
                     key=lambda replica: (replica.outstanding,
                                          len(replica.streams),
                                          replica.topic_path))
        self._last_scale = now
        if role is not None:
            self._pool_state[role]["last_scale"] = now
        replica = self.gateway.drain_replica(victim.topic_path,
                                             "low watermark")
        if replica is None:
            return
        self.gateway.telemetry.scale_downs.inc()
        handle = self._handles.pop(replica.topic_path, None)
        if handle is None:
            # not factory-owned (manually attached / discovered without
            # a spawn record): draining it out of the pool is all the
            # controller may do
            return
        # visible in pool_snapshot as state "draining" until retirement
        self.draining[replica.topic_path] = replica
        self._draining_handles[replica.topic_path] = handle
        if self.policy.drain_timeout_s <= 0:
            self._retire(replica.topic_path, handle, None)
            return
        # linger: responses already computed on the victim settle (and
        # dedupe against the replay) before the process goes away
        lease = Lease(
            self.gateway.process.event, self.policy.drain_timeout_s,
            replica.topic_path,
            lease_expired_handler=lambda _uuid: self._retire(
                replica.topic_path, handle, lease))
        self._retiring.append(lease)

    def _retire(self, topic_path, handle, lease) -> None:
        self.draining.pop(topic_path, None)
        self._draining_handles.pop(topic_path, None)
        if lease is not None and lease in self._retiring:
            self._retiring.remove(lease)  # fired: stop tracking it
        try:
            self._retire_handle(handle,
                                self._handle_roles.pop(topic_path, None))
        except Exception:
            _LOGGER.exception("%s: replica retire failed",
                              self.gateway.name)

    def stop(self) -> None:
        self._stopped = True
        self.gateway.process.event.remove_timer_handler(self._tick)
        for record in list(self._pending_spawns.values()):
            lease = record.pop("lease", None)
            if lease is not None:
                lease.terminate()
        self._pending_spawns.clear()
        for lease in list(self._retiring):
            lease.terminate()
        self._retiring.clear()
        # drains caught mid-linger: their backing processes still
        # belong to the factory -- retire NOW or nobody ever will
        for topic_path, handle in list(self._draining_handles.items()):
            self._retire(topic_path, handle, None)
        self.draining.clear()
        # factory-owned LIVE replicas die with their controller too: a
        # stopped gateway must not strand the fleet it spawned
        if self.factory is not None:
            for topic_path, handle in list(self._handles.items()):
                try:
                    self._retire_handle(
                        handle, self._handle_roles.get(topic_path))
                except Exception:
                    _LOGGER.exception("%s: replica retire failed",
                                      self.gateway.name)
        self._handles.clear()
        self._handle_roles.clear()


class _SpawnHandle:
    __slots__ = ("name", "process", "pipeline")

    def __init__(self, name, process, pipeline):
        self.name = name
        self.process = process
        self.pipeline = pipeline


def _resolve_exports(warm_source):
    """Factory-side half of the hand-off, run on the SPAWN thread
    (export_weights copies every state leaf to host -- never on the
    gateway's event loop): a live sibling Pipeline, an already-exported
    descriptor tree, or None."""
    if warm_source is None:
        return None
    if isinstance(warm_source, dict):
        return warm_source
    return warm_source.export_weights()


class InProcessReplicaFactory:
    """Replicas as in-process Pipelines, each on its own virtual
    Process (threaded, shared loopback broker) -- the bench/test
    topology, and the warm-start proof surface: the spawn thread
    enables the kernel build cache, imports the sibling's weights over
    the transfer plane, and probes one warmup frame so "healthy" means
    "served a frame", with the build cache's hit/miss/capture delta for
    the whole bring-up recorded into the spawn info."""

    def __init__(self, definition, transport: str = "loopback",
                 warmup=None, compile_cache: str | None = None,
                 probe_timeout: float = 120.0):
        # definition: dict template (name overridden per spawn) or a
        # callable name -> definition dict
        self._definition = definition
        self.transport = transport
        self.warmup = warmup            # frame_data dict for the probe
        self.compile_cache = compile_cache
        self.probe_timeout = probe_timeout

    def definition_for(self, name: str) -> dict:
        if callable(self._definition):
            return self._definition(name)
        definition = dict(self._definition)
        definition["name"] = name
        return definition

    def spawn(self, name: str, warm_source=None, ready=None):
        thread = threading.Thread(
            target=self._bring_up, args=(name, warm_source, ready),
            name=f"autoscale-spawn-{name}", daemon=True)
        thread.start()
        return thread

    def _bring_up(self, name, warm_source, ready) -> None:
        process = None
        try:
            from ..pipeline import create_pipeline
            from ..runtime import Process
            from ..runtime.compile_cache import (
                enable_compile_cache, thread_cache_delta,
                thread_cache_snapshot)
            if self.compile_cache:
                enable_compile_cache(self.compile_cache)
            try:
                warm_exports = _resolve_exports(warm_source)
            except Exception:
                _LOGGER.exception("replica %s: sibling weight export "
                                  "failed; bringing up cold", name)
                warm_exports = None
            # compile accounting is scoped to THIS bring-up's threads
            # (the spawn thread and the new replica's event loop):
            # sibling replicas in the same OS process may compile
            # concurrently, and their traffic must not pollute the
            # warm-start proof
            before = thread_cache_snapshot()
            process = Process(transport_kind=self.transport)
            pipeline = create_pipeline(process,
                                       self.definition_for(name))
            imported = []
            if warm_exports:
                try:
                    imported = pipeline.import_weights(warm_exports)
                except Exception:
                    # a failed hand-off (expired transfer keys, drained
                    # sibling) downgrades to a COLD start, like the
                    # OS-process path -- a scale-up at peak overload
                    # must still add capacity
                    _LOGGER.exception("replica %s: weight import "
                                      "failed; continuing cold", name)
                    imported = []
            loop_thread = process.run(in_thread=True)
            if self.warmup is not None:
                self._probe(pipeline)
            delta = thread_cache_delta(
                before, thread_cache_snapshot(),
                {threading.get_ident(),
                 getattr(loop_thread, "ident", None)})
            info = {
                "name": name,
                "cache_hits": delta["hits"],
                "cache_misses": delta["misses"],
                "cache_captures": delta["captures"],
                "imported_elements": imported,
            }
            ready(_SpawnHandle(name, process, pipeline), info)
        except Exception as error:
            _LOGGER.exception("replica %s bring-up failed", name)
            if process is not None:
                try:  # never leak a half-built replica's event loop
                    process.terminate()
                except Exception:
                    pass
            if ready is not None:
                ready(None, {"name": name, "error": str(error)})

    def _probe(self, pipeline) -> None:
        """One warmup frame through a private stream: forces setup and
        the first kernel loads (build-cache hits for libraries the fleet
        built) so the
        replica joins the pool serving-ready, and time-to-healthy
        measures first-frame readiness, not object construction."""
        import queue as queue_module
        responses = queue_module.Queue()
        stream_id = f"_warmup_{pipeline.name}"
        stream = pipeline.create_stream(stream_id,
                                        queue_response=responses,
                                        grace_time=self.probe_timeout)
        pipeline.create_frame(stream, dict(self.warmup))
        responses.get(timeout=self.probe_timeout)
        pipeline.destroy_stream(stream_id)

    def retire(self, handle) -> None:
        if isinstance(handle, _SpawnHandle):
            handle.process.terminate()


class ProcessReplicaFactory:
    """OS-process replicas driven through runtime.ProcessManager: spawn()
    starts `python -m aiko_services_tpu_torch pipeline <definition>
    --name <name>` under the replica's name, with an env OVERLAY (merged
    over os.environ by ProcessManager) that carries the kernel
    build-cache directory (AIKO_COMPILE_CACHE) and -- when a sibling
    exported weights -- an AIKO_WARM_WEIGHTS descriptor file the child
    imports over the transfer plane before serving.  The child's output
    goes to `log_dir`/<name>.log when a directory is given.  The gateway
    attaches the replica when registrar discovery sees it
    (gateway.discover), which closes the autoscaler's time-to-healthy
    clock; retire() is ProcessManager.kill (SIGTERM, then SIGKILL after
    its grace).

    The JAX factory drives a LifeCycleManager, which waits for a
    LifeCycleClient handshake; a `pipeline` child never makes one, so
    the port spawns the child directly."""

    def __init__(self, process_manager, definition_path: str,
                 transport: str | None = None, env: dict | None = None,
                 compile_cache: str | None = None,
                 log_dir: str | None = None):
        self.process_manager = process_manager
        self.definition_path = str(definition_path)
        self.transport = transport
        self.env = dict(env or {})
        self.compile_cache = compile_cache
        self.log_dir = log_dir
        self._spawned: set = set()    # names of the live children

    def spawn(self, name: str, warm_source=None, ready=None):
        # launched off-thread: the sibling weight export (device-to-
        # host copy of the whole parameter set) must not run on the
        # gateway's event loop, which is where the autoscaler tick
        # calls spawn()
        thread = threading.Thread(
            target=self._launch, args=(name, warm_source),
            name=f"autoscale-launch-{name}", daemon=True)
        thread.start()
        return thread

    def _launch(self, name: str, warm_source) -> None:
        import json
        import os
        import subprocess
        import sys
        import tempfile
        env = dict(self.env)
        if self.compile_cache:
            env["AIKO_COMPILE_CACHE"] = str(self.compile_cache)
        try:
            warm_exports = _resolve_exports(warm_source)
        except Exception:
            _LOGGER.exception("replica %s: sibling weight export "
                              "failed; spawning cold", name)
            warm_exports = None
        if warm_exports:
            handoff = tempfile.NamedTemporaryFile(
                "w", prefix=f"aiko_warm_{name}_", suffix=".json",
                delete=False)
            json.dump(warm_exports, handoff)
            handoff.close()
            # the CHILD unlinks the file after a successful import
            # (cli.py); it only lives this long so a crashed child can
            # be respawned against the same descriptors
            env["AIKO_WARM_WEIGHTS"] = handoff.name
        arguments = ["-m", "aiko_services_tpu_torch", "pipeline",
                     self.definition_path, "--name", name]
        if self.transport:
            arguments += ["--transport", self.transport]
        streams: dict = {}
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            log = open(os.path.join(self.log_dir, f"{name}.log"), "ab")
            streams = {"stdout": log, "stderr": subprocess.STDOUT}
        try:
            self.process_manager.spawn(name, sys.executable, arguments,
                                       use_interpreter=False, env=env,
                                       **streams)
        finally:
            if streams:
                streams["stdout"].close()   # the child holds its copy
        self._spawned.add(name)
        # no ready() here: the replica becomes healthy when registrar
        # discovery attaches it (AutoScaler.note_replica_added)

    def retire(self, handle) -> None:
        name = str(getattr(handle, "name", handle))
        if name in self._spawned:
            self._spawned.discard(name)
            self.process_manager.kill(name)
