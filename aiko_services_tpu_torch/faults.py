# Deterministic fault injection: the measurement substrate for the
# stream fault-tolerance layer.
#
# At the ROADMAP scale (heavy traffic from millions of users) transient
# faults are the steady state, so the retry/dead-letter/circuit-breaker
# machinery in pipeline.py and transfer.py needs a way to be PROVEN, not
# just reasoned about.  This module provides seeded, deterministic
# injection points the engine and the transfer plane consult:
#
#   element_raise    one element call fails (as if process_frame raised)
#   fetch_drop       a transfer-plane fetch attempt dies with a socket
#                    error before dialing
#   reply_blackhole  a process_frame_response for a node is swallowed
#                    (a dead RemoteElement / lost reply)
#   dispatch_delay   extra host latency before an element dispatch
#   connection_drop  an MQTT connection is severed abnormally (consumed
#                    by tests driving the embedded broker)
#   replica_kill     a serving-gateway replica dies abnormally (consumed
#                    by the gateway per routed frame: node= targets the
#                    replica by name, frame=k kills it on the k-th frame
#                    routed to it)
#
# Process-scoped points (the chaos harness: whole processes die, the
# broker partitions -- exercised by `bench.py` `chaos` and
# tests/test_chaos.py):
#
#   process_kill     a whole process dies abnormally: ProcessManager
#                    consults it once per monitor poll per OS child
#                    (node= the process id) and kills the match; chaos
#                    harnesses consult it per tick for VIRTUAL
#                    processes and crash them via Process.crash() /
#                    LoopbackTransport.sever() (LWT fires, no clean
#                    shutdown)
#   broker_partition a client's path to the broker drops BOTH ways for
#                    ms= milliseconds: LoopbackTransport consults it
#                    per publish when `chaos_name` is set (partition +
#                    scheduled heal; ms=0 partitions until heal() is
#                    called manually)
#   registrar_kill   the registrar primary dies abnormally (harness-
#                    consulted like process_kill, but named so a chaos
#                    plan reads as intent: the election/reap path is
#                    the thing under test)
#   transfer_stall   a transfer-plane SERVER answers one accepted
#                    connection only after ms= of silence (a wedged
#                    keeper/producer): the client's socket timeout --
#                    adopt_timeout on the KV-migration paths -- must
#                    bound the caller and degrade to re-prefill
#
# WAN-shaped points (the region fault plane, riding the same seeded
# broker machinery -- exercised by the federated chaos arms and
# tests/test_region.py).  Links are DIRECTED (region, region) pairs,
# written src=us:dst=eu (or node=us>eu); these points default to
# times=-1 because a link's latency/loss is a property of the link,
# not a one-shot event:
#
#   link_latency     every cross-region delivery over the (src, dst)
#                    link is delayed ms= milliseconds (consulted by
#                    the loopback broker at fan-out when publisher and
#                    subscriber carry different `chaos_region`s)
#   link_jitter      adds a DETERMINISTIC extra 0..ms= delay per
#                    delivery, hashed from (seed, link, subscriber,
#                    publish ordinal) -- WAN variance without losing
#                    bit-reproducibility
#   link_loss        cross-region deliveries over the link are dropped
#                    (rate= for lossy links, frame=k for targeted
#                    drops); loss is delivery-side, so an intra-region
#                    subscriber still hears the publish
#   region_partition a whole REGION is severed at once: every client
#                    whose `chaos_region` matches node= partitions
#                    from the broker (both directions, LWT fires) at
#                    its frame=k-th publish, each client consuming its
#                    OWN publish ordinal so one spec severs every
#                    group in the region deterministically; ms=
#                    schedules the heal exactly like broker_partition
#
# Determinism contract: rate-based selection hashes (seed, point, node,
# frame_id) -- the SAME frames are poisoned on every run with the same
# seed, independent of call order, thread timing, or how many other
# injection points fired.  Count-based directives (frame=k, times=n)
# consume deterministically in call order within one injector.
#
# Spec grammar (pipeline parameter `faults` or the AIKO_FAULTS env var):
#
#   spec      := directive (";" directive)*
#   directive := "seed=" int
#              | point (":" key "=" value)*
#   point     := element_raise | fetch_drop | reply_blackhole
#              | dispatch_delay | connection_drop | replica_kill
#              | process_kill | broker_partition | registrar_kill
#              | link_latency | link_loss | link_jitter
#              | region_partition
#   keys      := node=<name> frame=<int> rate=<float 0..1>
#                times=<int, -1 = unlimited> ms=<float>
#                once=<1: each selected frame fails at most once>
#                src=<region> dst=<region>   (link_* points only: the
#                directed link; equivalent to node=<src>><dst>)
#
# Examples:
#   "seed=7;element_raise:node=asr:frame=3:times=1"   transient: frame 3
#                                                     fails once, retries
#                                                     succeed
#   "seed=7;element_raise:node=detector:rate=0.01:once=1"
#                                                     transient 1% faults
#   "seed=7;element_raise:node=detector:rate=0.01:times=-1"
#                                                     permanent 1% faults
#   "fetch_drop:times=1"                              first fetch attempt
#                                                     dies; retry survives
#   "reply_blackhole:node=remote_add:times=1;dispatch_delay:ms=5:rate=0.1"
#
# Cost contract: a pipeline without a spec holds injector None and every
# hot-path hook is one `is not None` check; the bench A/B (bench.py
# --faults) proves the disabled path stays off the hot path.

from __future__ import annotations

import hashlib
import os
import threading

from .analyze.grammar import DirectiveGrammar, Field

__all__ = ["FaultInjector", "FAULTS_GRAMMAR", "create_injector",
           "get_injector", "link_name", "reset_injector"]

_POINTS = ("element_raise", "fetch_drop", "reply_blackhole",
           "dispatch_delay", "connection_drop", "replica_kill",
           "process_kill", "broker_partition", "registrar_kill",
           "transfer_stall", "link_latency", "link_loss",
           "link_jitter", "region_partition")

# WAN points describe standing conditions (a link HAS latency, a
# severed region STAYS severed for every member), so their rules
# default to times=-1 instead of the one-shot default.
_CONTINUOUS_POINTS = frozenset(
    ("link_latency", "link_loss", "link_jitter", "region_partition"))
_LINK_POINTS = frozenset(("link_latency", "link_loss", "link_jitter"))

# The spec grammar above as a declarative table over the shared
# directive-grammar core (analyze/grammar.py): parse and offline lint
# (`aiko lint` AIKO402) validate through the SAME definition, so the
# two can never drift.
_RULE_FIELDS = {
    "node": Field("str"),
    "frame": Field("int", minimum=0),
    "rate": Field("float", minimum=0.0, maximum=1.0),
    "times": Field("int", minimum=-1),
    "ms": Field("float", minimum=0.0),
    "once": Field("flag"),
}
_LINK_FIELDS = dict(_RULE_FIELDS,
                    src=Field("str"), dst=Field("str"))
FAULTS_GRAMMAR = DirectiveGrammar(
    "faults",
    options={"seed": Field("int")},
    heads={point: (_LINK_FIELDS if point in _LINK_POINTS
                   else _RULE_FIELDS)
           for point in _POINTS},
    unknown_head_message="unknown fault point")


def link_name(src, dst) -> str:
    """The canonical node name for a directed (src, dst) region link:
    `us>eu`.  Specs may write src=us:dst=eu or node=us>eu -- both
    normalize here so selection state is shared."""
    return f"{src}>{dst}"


class _Rule:
    """One parsed directive for one injection point."""

    __slots__ = ("node", "frame", "rate", "times", "ms", "once",
                 "fired", "seen", "calls")

    def __init__(self, args: dict, continuous: bool = False):
        self.node = args.get("node")
        src, dst = args.get("src"), args.get("dst")
        if (src is None) != (dst is None):
            raise ValueError(
                "faults: link points need BOTH src= and dst= "
                "(the directed region link), or node=<src>><dst>")
        if src is not None:
            if self.node is not None:
                raise ValueError(
                    "faults: give node= OR src=/dst=, not both")
            self.node = link_name(str(src).strip(), str(dst).strip())
        self.frame = (int(args["frame"]) if "frame" in args else None)
        self.rate = (float(args["rate"]) if "rate" in args else None)
        default_times = -1 if (continuous or self.rate is not None) else 1
        self.times = int(args.get("times", default_times))
        self.ms = float(args.get("ms", 0.0))
        # once=1: each selected (node, frame) fires at most ONCE -- the
        # transient-fault shape (a retry of the same frame succeeds),
        # vs the default where a selected frame fails on every attempt
        self.once = str(args.get("once", "")).lower() in ("1", "true")
        self.fired = 0
        self.seen: set = set()
        # consumed-call ordinal for points with NO frame identity
        # (fetch_drop, connection_drop, reply_blackhole): it stands in
        # for frame_id, so rate= draws vary per call instead of
        # degenerating to a constant, and frame=k targets the k-th
        # call (0-based)
        self.calls = 0

    def exhausted(self) -> bool:
        return self.times >= 0 and self.fired >= self.times


class FaultInjector:
    """Parsed fault plan with per-rule consumption state.  One injector
    per pipeline (from the `faults` pipeline parameter) or per process
    (from AIKO_FAULTS); stats() reports every injection fired, keyed by
    point, so harnesses can reconcile injected vs recovered."""

    def __init__(self, spec: str, seed: int = 0,
                 rules: dict | None = None):
        self.spec = spec
        self.seed = seed
        self._rules: dict[str, list[_Rule]] = rules or {}
        self._lock = threading.Lock()
        self._stats: dict[str, int] = {}

    # -- deterministic selection ---------------------------------------

    def _selected(self, rule: _Rule, point: str, node, frame_id,
                  scope) -> bool:
        """Does this rule target (node, frame_id)?  Rate-based selection
        is a pure function of (seed, point, node, scope, frame_id):
        stable across runs, call order, and interleaving.  `scope` (the
        stream id in the pipeline hooks) decorrelates equal frame ids on
        different streams."""
        if rule.node is not None and node is not None \
                and rule.node != str(node):
            return False
        if rule.frame is not None:
            return frame_id is not None and int(frame_id) == rule.frame
        if rule.rate is not None:
            key = (f"{self.seed}:{point}:{node}:{scope}:"
                   f"{frame_id}").encode()
            digest = hashlib.blake2b(key, digest_size=8).digest()
            draw = int.from_bytes(digest, "big") / float(1 << 64)
            return draw < rule.rate
        return True  # bare directive: every call until times exhausted

    def _fire(self, point: str, node=None, frame_id=None,
              scope="") -> _Rule | None:
        rules = self._rules.get(point)
        if not rules:
            return None
        with self._lock:
            for rule in rules:
                if rule.exhausted():
                    continue
                if (rule.node is not None and node is not None
                        and rule.node != str(node)):
                    # node filter BEFORE the ordinal: other nodes' calls
                    # must not consume this rule's draws, or which call
                    # gets poisoned would depend on interleaving --
                    # breaking the determinism contract
                    continue
                rule_frame_id = frame_id
                if frame_id is None:
                    # identity-less call: the per-rule ordinal is the
                    # frame id (each call is one independent draw)
                    rule_frame_id = rule.calls
                    rule.calls += 1
                if not self._selected(rule, point, node, rule_frame_id,
                                      scope):
                    continue
                if rule.once:
                    key = (str(node), scope, rule_frame_id)
                    if key in rule.seen:
                        continue  # this frame already took its fault
                    rule.seen.add(key)
                rule.fired += 1
                self._stats[point] = self._stats.get(point, 0) + 1
                return rule
        return None

    def _peek(self, point: str, node=None, frame_id=None,
              scope="") -> bool:
        rules = self._rules.get(point)
        if not rules:
            return False
        with self._lock:
            return any(
                not rule.exhausted()
                and self._selected(
                    rule, point, node,
                    rule.calls if frame_id is None else frame_id, scope)
                and not (rule.once
                         and (str(node), scope,
                              rule.calls if frame_id is None
                              else frame_id) in rule.seen)
                for rule in rules)

    # -- injection points (engine-facing) ------------------------------

    def element_raise(self, node, frame_id, scope="") -> bool:
        """Consume: should THIS element call fail?"""
        return self._fire("element_raise", node, frame_id,
                          scope) is not None

    def element_raise_pending(self, node, frame_id, scope="") -> bool:
        """Peek without consuming: is (node, frame_id) poisoned?  The
        micro-batch scheduler uses this to fail the whole-group attempts
        (fused, then chained) without burning the poisoned frame's
        consumable, so the per-frame isolation pass still observes it."""
        return self._peek("element_raise", node, frame_id, scope)

    def fetch_drop(self) -> bool:
        return self._fire("fetch_drop") is not None

    def reply_blackhole(self, node) -> bool:
        return self._fire("reply_blackhole", node) is not None

    def dispatch_delay(self, node, frame_id, scope="") -> float:
        rule = self._fire("dispatch_delay", node, frame_id, scope)
        return rule.ms / 1000.0 if rule is not None else 0.0

    def connection_drop(self) -> bool:
        return self._fire("connection_drop") is not None

    def transfer_stall(self) -> float:
        """Consume: stall THIS transfer-plane connection?  Returns the
        injected server-side delay in SECONDS (0.0 = not fired).
        Consulted by TensorTransferServer once per accepted connection
        -- a keeper/producer that accepts but answers slowly -- so
        `frame=k` stalls the k-th connection (per-rule call ordinal)
        and `rate=` draws once per connection.  The CLIENT's socket
        timeout (fetch/adopt/restore timeout), not the stall, bounds
        the caller: the test contract is that adopt_timeout degrades a
        slow keeper to a local re-prefill instead of wedging the
        engine pump."""
        rule = self._fire("transfer_stall")
        return rule.ms / 1000.0 if rule is not None else 0.0

    def replica_kill(self, replica) -> bool:
        """Consume: should `replica` die now?  Consulted by the serving
        gateway once per frame ROUTED to that replica, so `frame=k`
        kills the replica on its k-th routed frame (0-based, the
        per-rule call ordinal) and `rate=` draws once per routed
        frame.  The node filter keeps other replicas' traffic from
        consuming the rule's ordinal (same determinism contract as
        element_raise)."""
        return self._fire("replica_kill", replica) is not None

    # -- process-scoped points (the chaos harness) ---------------------

    def process_kill(self, process) -> bool:
        """Consume: should the whole process `process` die now?
        ProcessManager consults once per monitor poll per OS child;
        chaos harnesses consult once per tick per virtual process --
        either way `frame=k` kills on the k-th consult for that node
        (the node filter isolates each process's ordinal)."""
        return self._fire("process_kill", process) is not None

    def broker_partition(self, client) -> float:
        """Consume: partition `client` from the broker?  Returns the
        partition duration in SECONDS (0.0 = not fired; a fired rule
        with no ms= means "until heal() is called").  Consulted by
        LoopbackTransport once per publish when its `chaos_name` is
        set, so `frame=k` partitions on the client's k-th publish."""
        rule = self._fire("broker_partition", client)
        if rule is None:
            return 0.0
        return rule.ms / 1000.0 if rule.ms > 0 else -1.0

    # -- WAN-shaped points (the region fault plane) --------------------

    def link_drop(self, src, dst, frame_id=None, scope="") -> bool:
        """Consume: drop THIS cross-region delivery over the directed
        (src, dst) link?  The broker consults at fan-out, passing the
        publisher's publish ordinal as `frame_id` and the subscriber's
        name as `scope`, so rate= draws are a pure function of (seed,
        link, subscriber, publish ordinal) -- identical firing
        sequences on every run regardless of dispatch-thread
        interleaving."""
        return self._fire("link_loss", link_name(src, dst), frame_id,
                          scope) is not None

    def link_delay(self, src, dst, frame_id=None, scope="") -> float:
        """Consume: extra delivery latency in SECONDS over the (src,
        dst) link -- link_latency's fixed ms= plus link_jitter's
        deterministic 0..ms= fraction, hashed from (seed, link, scope,
        frame_id) so WAN variance stays bit-reproducible."""
        link = link_name(src, dst)
        delay_ms = 0.0
        rule = self._fire("link_latency", link, frame_id, scope)
        if rule is not None:
            delay_ms += rule.ms
        jitter = self._fire("link_jitter", link, frame_id, scope)
        if jitter is not None and jitter.ms > 0:
            key = (f"{self.seed}:link_jitter:{link}:{scope}:"
                   f"{frame_id}").encode()
            digest = hashlib.blake2b(key, digest_size=8).digest()
            frac = int.from_bytes(digest, "big") / float(1 << 64)
            delay_ms += jitter.ms * frac
        return delay_ms / 1000.0

    def region_partition(self, region, frame_id=None, scope="") -> float:
        """Consume: sever this client's whole REGION from the broker?
        Same return contract as broker_partition (seconds; -1.0 =
        until heal).  Each client in the region consults with its OWN
        publish ordinal as `frame_id` and its name as `scope`, so one
        `region_partition:node=eu:frame=0` spec severs EVERY eu client
        at its first publish -- the region dies as a unit, and the
        firing sequence is identical on every run."""
        rule = self._fire("region_partition", region, frame_id, scope)
        if rule is None:
            return 0.0
        return rule.ms / 1000.0 if rule.ms > 0 else -1.0

    def registrar_kill(self, registrar) -> bool:
        """Consume: should the registrar `registrar` die now?  Same
        shape as process_kill; a separate point so one chaos spec can
        schedule gateway, replica, and registrar deaths independently
        without sharing consumption ordinals."""
        return self._fire("registrar_kill", registrar) is not None

    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats)


def create_injector(spec) -> FaultInjector | None:
    """Parse a fault spec; None/empty spec means no injection (the
    production state: every hook collapses to one is-None check)."""
    if not spec:
        return None
    spec = str(spec)
    parsed = FAULTS_GRAMMAR.parse(spec)
    seed = int(parsed.options.get("seed", 0))
    rules: dict[str, list[_Rule]] = {}
    for head, args in parsed.directives:
        rules.setdefault(head, []).append(
            _Rule(args, continuous=head in _CONTINUOUS_POINTS))
    return FaultInjector(spec, seed=seed, rules=rules)


# Process-global injector: points with no pipeline context (transfer
# plane fetches, transport tests) consult this one, configured by the
# AIKO_FAULTS env var and cached after first read.
_GLOBAL: FaultInjector | None = None
_GLOBAL_READ = False
_GLOBAL_LOCK = threading.Lock()


def get_injector() -> FaultInjector | None:
    global _GLOBAL, _GLOBAL_READ
    if _GLOBAL_READ:
        # lock-free fast path: the plan is fixed after first read, and
        # this sits on the tensor-fetch hot path -- concurrent fetches
        # must not serialize on a mutex for a constant
        return _GLOBAL
    with _GLOBAL_LOCK:
        if not _GLOBAL_READ:
            _GLOBAL = create_injector(os.environ.get("AIKO_FAULTS"))
            _GLOBAL_READ = True
        return _GLOBAL


def reset_injector() -> None:
    """Forget the cached AIKO_FAULTS plan (tests re-read the env)."""
    global _GLOBAL, _GLOBAL_READ
    with _GLOBAL_LOCK:
        _GLOBAL = None
        _GLOBAL_READ = False
