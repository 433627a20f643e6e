# Online SLO autopilot: the guarded control loop that closes the
# observe -> tune gap.  The port's copy of the JAX package's
# serve/autopilot.py: the same grammar, loop, journal records and
# ledger, over the port's tune/, observe/ and gateway.
#
# `aiko tune --apply` rewrites a definition OFFLINE; the AutoPilot runs
# the SAME loader + cost model + recommender against the LIVE fleet and
# applies the result without a restart:
#
#   observe   harvest per-process trace documents over the existing
#             `(publish_trace ...)` wire path -- every live replica
#             plus the gateway itself -- and merge them with
#             merge_trace_documents into one clock-aligned artifact
#   decide    run tune/ on the merged document; convert the supported
#             recommendations (admission bucket rates, autoscale
#             min/max floors, micro_batch, checkpoint cadence) into
#             BOUNDED deltas: each knob moves at most `max_delta_frac`
#             of its current value per tick (ints always move >= 1),
#             so a bad recommendation can only nudge, never lurch
#   gate      a windowed SLO burn-rate signal (observe/metrics
#             SlidingWindow over the gateway's slo_ok/slo_miss
#             counters) arms the apply path: deltas land only while
#             burn over the window exceeds `burn_threshold`; once
#             attainment recovers the loop backs off to observe-only.
#             A fleet with NO declared SLOs has no burn signal at all
#             -- the gate stays open and the loop optimizes throughput
#   act       apply through live setter paths on the running gateway /
#             replicas (serve/gateway.py set_bucket_rate,
#             set_autoscale_floors, set_replica_parameter) -- never a
#             restart, never a recompile-forcing shape change (shape
#             knobs like decode_slots / kv_block_size are counted as
#             skipped, not applied)
#   account   every applied delta is WRITE-AHEAD journaled into the
#             gateway's serve/journal.py store before it is applied.
#             Records carry absolute values (never increments), so
#             replay is idempotent: a crash or HA promote mid-apply
#             replays the committed prefix and lands bit-identical to
#             an unkilled run; the chaos bench arm proves it
#
# Policy grammar (AIKO412, shared directive core):
#
#   interval=<s>;apply=on|off;margin=<frac>;max_delta_frac=<frac>;
#   burn_window=<s>;burn_threshold=<frac>;scope=local|fleet;
#   wait=<s>;slo=throughput|latency;p99_ms=<ms>
#
# `apply=off` (the default) is a first-class operating mode: the loop
# still harvests, tunes, journals nothing, and publishes convergence
# distance -- a dry-run audit of what it WOULD do.
#
# scope=fleet: each gateway group publishes its windowed burn on a
# retained control-plane topic; every group's autopilot sees the fleet
# view and adjusts only ITS OWN autoscale floors (raise when hot while
# a peer idles, donate when cool while a peer burns) -- floors
# rebalance between federated groups with no central coordinator.

from __future__ import annotations

import json

from ..analyze.grammar import DirectiveGrammar, Field
from ..observe.collector import (
    collect_traces, merge_trace_documents, unique_source_name)
from ..runtime.lease import Lease
from ..utils import generate, get_logger, monotonic, parse

__all__ = ["AUTOPILOT_GRAMMAR", "AutoPilot", "AutopilotPolicy",
           "harvest_documents", "tune_documents"]

_LOGGER = get_logger("autopilot")

DEFAULT_INTERVAL_S = 10.0
DEFAULT_MARGIN = 0.15
DEFAULT_MAX_DELTA_FRAC = 0.25
DEFAULT_BURN_WINDOW_S = 30.0
DEFAULT_BURN_THRESHOLD = 0.02
DEFAULT_WAIT_S = 0.5
# per-tick delta ledger entries kept for the bench timeline artifact
LEDGER_CAP = 256

AUTOPILOT_GRAMMAR = DirectiveGrammar(
    "gateway autopilot",
    options={
        "interval": Field("float", minimum=0.0),
        "apply": Field("flag"),
        "margin": Field("float", minimum=0.0),
        "max_delta_frac": Field("float", minimum=0.0, maximum=1.0),
        "burn_window": Field("float", minimum=0.0),
        "burn_threshold": Field("float", minimum=0.0, maximum=1.0),
        "scope": Field("str", choices=("local", "fleet")),
        "wait": Field("float", minimum=0.0),
        "slo": Field("str", choices=("throughput", "latency")),
        "p99_ms": Field("float", minimum=1e-3),
    })


class AutopilotPolicy:
    __slots__ = ("interval_s", "apply", "margin", "max_delta_frac",
                 "burn_window_s", "burn_threshold", "scope", "wait_s",
                 "objective", "p99_ms", "spec")

    def __init__(self):
        self.interval_s = DEFAULT_INTERVAL_S
        self.apply = False          # observe-only is the safe default
        self.margin = DEFAULT_MARGIN
        self.max_delta_frac = DEFAULT_MAX_DELTA_FRAC
        self.burn_window_s = DEFAULT_BURN_WINDOW_S
        self.burn_threshold = DEFAULT_BURN_THRESHOLD
        self.scope = "local"
        self.wait_s = DEFAULT_WAIT_S
        self.objective = "throughput"
        self.p99_ms = None
        self.spec = ""

    @classmethod
    def parse(cls, spec) -> "AutopilotPolicy":
        """Parse an autopilot spec (grammar string, dict of the same
        keys, or None/True for all defaults).  Cross-field constraints
        -- a zero burn window or a zero step bound -- fail HERE and in
        offline lint (analyze/policies.check_autopilot_policy)
        identically."""
        policy = cls()
        if spec is None or spec == "" or spec is True:
            return policy
        policy.spec = spec if isinstance(spec, str) else ""
        parsed = AUTOPILOT_GRAMMAR.parse(spec)
        attributes = {
            "interval": "interval_s",
            "apply": "apply",
            "margin": "margin",
            "max_delta_frac": "max_delta_frac",
            "burn_window": "burn_window_s",
            "burn_threshold": "burn_threshold",
            "scope": "scope",
            "wait": "wait_s",
            "slo": "objective",
            "p99_ms": "p99_ms",
        }
        for key, value in parsed.options.items():
            setattr(policy, attributes[key], value)
        if policy.burn_window_s <= 0:
            raise ValueError("autopilot burn_window must be > 0")
        if policy.max_delta_frac <= 0:
            raise ValueError(
                "autopilot max_delta_frac must be > 0 (a zero step "
                "bound can never move a knob)")
        return policy

    def slo_spec(self) -> str:
        spec = f"slo={self.objective}"
        if self.p99_ms is not None:
            spec += f";p99_ms={self.p99_ms:g}"
        return spec

    def __repr__(self):
        return (f"AutopilotPolicy(interval={self.interval_s}, "
                f"apply={self.apply}, margin={self.margin}, "
                f"max_delta_frac={self.max_delta_frac}, "
                f"scope={self.scope!r})")


# -- shared harvest + tune (autopilot loop, `aiko tune --live`) ------------

def tune_documents(named_documents: list, slo_spec=None,
                   label: str = "live", definition=None,
                   run: str | None = None, static_costs=None) -> dict:
    """[(source, chrome_trace_document), ...] -> tune report dict: the
    ONE merge -> load -> tune path shared by the autopilot's decide
    step and `aiko tune --live` (no artifact files involved; `label`
    stands in for the trace path in the report)."""
    from ..tune import load_trace, run_tune
    merged = merge_trace_documents(list(named_documents))
    loaded = load_trace(label, definition=definition, run=run,
                        document=merged)
    return run_tune(label, slo_spec=slo_spec, loaded=loaded,
                    static_costs=static_costs)


def harvest_documents(process, wait: float = 3.0,
                      protocols: tuple = ("pipeline", "gateway"),
                      targets=None) -> list:
    """Live wire harvest -> deterministically named+ordered
    [(source, document), ...] ready for tune_documents (topic paths
    sort stably; collisions get unique_source_name suffixes)."""
    collected = collect_traces(process, wait=wait, protocols=protocols,
                               targets=targets)
    seen: dict = {}
    return [(unique_source_name(seen, source), collected[source])
            for source in sorted(collected)]


# -- the control loop ------------------------------------------------------

class AutoPilot:
    """The gateway-owned observe -> decide -> act -> account loop.

    Two tick paths share one decide/apply core:

      timer path   `start()` arms a cadence timer; each firing posts
                   `_autopilot_collect` through the gateway mailbox,
                   which wire-harvests every live replica AND the
                   gateway itself (the gateway's own publish_trace
                   reply is processed by its mailbox after collect
                   returns -- the loop never blocks the mailbox), then
                   decides when all respondents answered or the wait
                   lease expires
      tick_now()   synchronous in-process harvest straight from the
                   attached replica pipelines' telemetry -- the
                   deterministic path bench.py and the tests drive
    """

    def __init__(self, gateway, policy: AutopilotPolicy):
        self.gateway = gateway
        self.policy = policy
        self.registry = gateway.telemetry.registry
        self._seq = 0              # last delta sequence number issued
        self._applied: dict = {}   # (target, knob) -> value in effect
        self._pending: dict = {}   # source -> document, current round
        self._round = 0
        self._decided_round = 0
        self._expected = 0
        self._lease = None
        self._timer_installed = False
        self._handler_installed = False
        self._fleet_handler_installed = False
        self._fleet_burns: dict = {}   # group -> {"burn", "floor"}
        self.ledger: list = []         # per-tick delta ledger (capped)
        self.last_report: dict | None = None
        self.convergence: float | None = None
        self.converged = False
        self._response_topic = (f"{gateway.process.topic_path_process}"
                                f"/autopilot/{gateway.name}")
        self._burn_root = f"{gateway.process.namespace}/autopilot/burn"
        gateway.telemetry.configure_slo_window(policy.burn_window_s)
        if policy.scope == "fleet":
            gateway.process.add_message_handler(
                self._on_fleet_burn, f"{self._burn_root}/#")
            self._fleet_handler_installed = True

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Arm the cadence timer (primary/single role only; the
        gateway re-arms on HA promote and disarms on demote)."""
        if self._timer_installed or self.policy.interval_s <= 0:
            return
        self.gateway.process.event.add_timer_handler(
            self._timer_fired, self.policy.interval_s)
        self._timer_installed = True

    def stop(self) -> None:
        """Disarm the cadence timer and any in-flight wait lease (a
        demoted standby must not keep tuning a fleet it no longer
        owns)."""
        if self._timer_installed:
            self.gateway.process.event.remove_timer_handler(
                self._timer_fired)
            self._timer_installed = False
        lease, self._lease = self._lease, None
        if lease is not None and not lease.expired:
            lease.terminate()

    def shutdown(self) -> None:
        self.stop()
        if self._handler_installed:
            self.gateway.process.remove_message_handler(
                self._on_trace, self._response_topic)
            self._handler_installed = False
        if self._fleet_handler_installed:
            self.gateway.process.remove_message_handler(
                self._on_fleet_burn, f"{self._burn_root}/#")
            self._fleet_handler_installed = False

    def _timer_fired(self) -> None:
        # timer thread -> gateway mailbox: the loop's work happens on
        # the gateway's own thread, serialized with stream traffic
        self.gateway.post_message("_autopilot_collect", [])

    # -- observe: wire harvest ---------------------------------------------

    def collect(self) -> None:
        """Start one harvest round (gateway mailbox).  Non-blocking:
        replies accumulate on the transport thread; decide runs when
        every expected respondent answered or the wait lease expires.
        The gateway queries ITSELF over the same wire path -- its own
        publish_trace reply is just another mailbox message."""
        if getattr(self.gateway, "role", "single") == "standby":
            return
        self._round += 1
        round_id = self._round
        self._pending = {}
        if not self._handler_installed:
            self.gateway.process.add_message_handler(
                self._on_trace, self._response_topic)
            self._handler_installed = True
        targets = [self.gateway.topic_path]
        for replica in self.gateway.replicas.values():
            if not replica.dead and not getattr(
                    replica, "draining", False):
                targets.append(replica.topic_path)
        self._expected = len(targets)
        self.registry.counter("autopilot.collections").inc()
        for topic in targets:
            self.gateway.process.publish(
                f"{topic}/in",
                generate("publish_trace", [self._response_topic]))
        lease = self._lease
        if lease is not None and not lease.expired:
            lease.terminate()
        self._lease = Lease(
            self.gateway.process.event, max(self.policy.wait_s, 0.05),
            f"autopilot-{round_id}",
            lease_expired_handler=lambda _uuid: self.gateway.post_message(
                "_autopilot_decide", [round_id]))

    def _on_trace(self, topic, payload) -> None:
        # transport thread: parse + stash; the decide hop back to the
        # gateway mailbox keeps every apply on the owning thread
        try:
            command, parameters = parse(payload)
        except ValueError:
            return
        if command != "trace" or len(parameters) < 2:
            return
        source, document = str(parameters[0]), parameters[1]
        if isinstance(document, (str, bytes)):
            try:
                document = json.loads(document)
            except ValueError:
                return
        if not isinstance(document, dict):
            return
        round_id = self._round
        self._pending[source] = document
        self.registry.counter("autopilot.responses").inc()
        if self._expected and len(self._pending) >= self._expected:
            # early decide: no reason to sit out the rest of the wait
            self.gateway.post_message("_autopilot_decide", [round_id])

    def decide(self, round_id) -> None:
        """Close one harvest round (gateway mailbox; at-most-once per
        round -- the early post and the lease expiry can both land)."""
        round_id = int(round_id)
        if round_id != self._round or self._decided_round >= round_id:
            return
        self._decided_round = round_id
        lease, self._lease = self._lease, None
        if lease is not None and not lease.expired:
            lease.terminate()
        documents = dict(self._pending)
        self._pending = {}
        if self._expected and len(documents) < self._expected:
            self.registry.counter("autopilot.timeouts").inc(
                self._expected - len(documents))
        self._run_decide(documents)

    def tick_now(self, now: float | None = None) -> dict | None:
        """One SYNCHRONOUS control-loop tick: harvest the in-process
        replica pipelines (and the gateway itself) directly, decide,
        apply.  Deterministic -- the bench convergence arm and the
        replay tests drive this instead of the wire timers."""
        from ..observe.trace import chrome_trace_document
        gateway = self.gateway
        telemetry = gateway.telemetry
        documents = {
            gateway.topic_path: chrome_trace_document(
                telemetry.chrome_events(),
                metadata=telemetry.trace_metadata())}
        for replica in gateway.replicas.values():
            pipeline = replica.pipeline
            if replica.dead or pipeline is None:
                continue
            replica_telemetry = getattr(pipeline, "telemetry", None)
            if replica_telemetry is None:
                continue
            documents[replica.topic_path] = chrome_trace_document(
                replica_telemetry.chrome_events(),
                metadata=replica_telemetry.trace_metadata())
        self.registry.counter("autopilot.collections").inc()
        return self._run_decide(documents, now=now)

    # -- decide + act + account --------------------------------------------

    def _run_decide(self, documents: dict,
                    now: float | None = None) -> dict | None:
        gateway = self.gateway
        telemetry = gateway.telemetry
        now = monotonic() if now is None else float(now)
        telemetry.sample_slo_window(now)
        burn = telemetry.windowed_burn()
        if burn is not None:
            self.registry.gauge("autopilot.burn_window").set(burn)
        if not documents:
            return None
        seen: dict = {}
        named = [(unique_source_name(seen, source), documents[source])
                 for source in sorted(documents)]
        try:
            report = tune_documents(
                named, slo_spec=self.policy.slo_spec(),
                label=f"autopilot:{gateway.name}")
        except Exception as error:
            # a malformed / definition-less harvest must never kill
            # the loop (the next round sees a richer fleet)
            self.registry.counter("autopilot.harvest_errors").inc()
            _LOGGER.warning("autopilot tune failed: %s", error)
            return None
        self.last_report = report
        planned, skipped, distance = self._plan(
            report.get("recommendations") or [])
        self.convergence = distance
        self.registry.gauge("autopilot.convergence").set(distance)
        self.converged = distance <= self.policy.margin
        if skipped:
            self.registry.counter("autopilot.deltas_skipped").inc(
                skipped)
        # the gate: act while the windowed burn exceeds the threshold;
        # back off once attainment recovers.  No burn signal at all
        # (no declared SLOs in the window) leaves the gate OPEN -- an
        # SLO-less fleet is tuned for throughput, not frozen
        gate_open = burn is None or burn >= self.policy.burn_threshold
        tick: dict = {"round": self._decided_round or self._round,
                      "sources": len(named),
                      "burn": (round(burn, 4)
                               if burn is not None else None),
                      "convergence": round(distance, 4),
                      "converged": self.converged,
                      "applied": [], "skipped": skipped,
                      "gated": False}
        if planned and self.policy.apply and gate_open:
            records = []
            for delta in planned:
                self._seq += 1
                record = dict(delta)
                record["seq"] = self._seq
                records.append(record)
            rebalance = self._fleet_delta(burn)
            if rebalance is not None:
                self._seq += 1
                rebalance["seq"] = self._seq
                records.append(rebalance)
                self.registry.counter("autopilot.rebalances").inc()
            # WRITE-AHEAD: journal first, apply second.  A crash
            # between the two replays the journaled record into the
            # exact state the apply would have produced
            if gateway.journal is not None and records:
                gateway.journal.write_deltas(records)
            for record in records:
                self._apply_delta(record)
                self.registry.counter("autopilot.deltas_applied").inc()
                if record.get("clamped"):
                    self.registry.counter(
                        "autopilot.deltas_clamped").inc()
            tick["applied"] = records
        elif planned and self.policy.apply and not gate_open:
            # attainment recovered: observe, don't touch
            self.registry.counter("autopilot.backoffs").inc()
            self.registry.counter("autopilot.deltas_skipped").inc(
                len(planned))
            tick["gated"] = True
            tick["skipped"] += len(planned)
        elif planned:
            # apply=off: the dry-run audit mode
            self.registry.counter("autopilot.deltas_skipped").inc(
                len(planned))
            tick["skipped"] += len(planned)
        if self.policy.scope == "fleet":
            self._publish_fleet_burn(burn)
        self.ledger.append(tick)
        del self.ledger[:-LEDGER_CAP]
        telemetry.autopilot_summary = self.summary()
        return report

    def _plan(self, recommendations: list):
        """Recommendation dicts -> (bounded delta plan, skipped count,
        convergence distance).  Only live-mutable knobs are planned;
        shape-changing knobs (decode_slots, kv_block_size,
        micro_batch_fused, frame_window, prefix/disagg policy) would
        force recompiles or restarts and are counted as skipped.
        Distance is the worst relative gap between what is in effect
        and what the recommender wants -- the number the bench
        convergence assertion reads."""
        gateway = self.gateway
        planned: list = []
        skipped = 0
        distance = 0.0

        def gap(current, proposed) -> float:
            if current is None:
                return 1.0
            scale = max(abs(float(proposed)), 1.0)
            return abs(float(proposed) - float(current)) / scale

        for recommendation in recommendations:
            target = str(recommendation.get("target", ""))
            knob = str(recommendation.get("knob", ""))
            proposed = recommendation.get("proposed")
            if target.startswith("element:") and knob == "micro_batch":
                current = self._applied.get((target, knob))
                if current is None and isinstance(
                        recommendation.get("current"), int):
                    current = recommendation["current"]
                value, clamped = self._clamp_step(current,
                                                  int(proposed))
                distance = max(distance, gap(current, proposed))
                if value is not None:
                    planned.append({"target": target,
                                    "knob": knob, "value": value,
                                    "before": current,
                                    "goal": int(proposed),
                                    "clamped": clamped})
            elif target == "gateway" and knob == "gateway_policy":
                delta = self._plan_bucket(recommendation)
                if delta is not None:
                    distance = max(distance,
                                   gap(delta["before"],
                                       delta["goal"]))
                    planned.append(delta)
            elif (target == "gateway" and knob == "autoscale_policy"
                    and gateway.autoscaler is not None):
                for delta in self._plan_floors(recommendation):
                    distance = max(distance,
                                   gap(delta["before"], delta["goal"]))
                    planned.append(delta)
            elif (target == "gateway" and knob == "replicas"
                    and gateway.autoscaler is not None):
                floors = gateway.autoscaler.policy
                current = self._applied.get(
                    ("gateway", "min_replicas"), floors.min_replicas)
                goal = min(int(proposed), floors.max_replicas)
                value, clamped = self._clamp_step(current, goal)
                distance = max(distance, gap(current, goal))
                if value is not None:
                    planned.append({"target": "gateway",
                                    "knob": "min_replicas",
                                    "value": value, "before": current,
                                    "goal": goal, "clamped": clamped})
            elif target.startswith("element:") and knob == "checkpoint":
                delta = self._plan_checkpoint(recommendation)
                if delta is not None:
                    distance = max(distance,
                                   gap(delta["before"], delta["goal"]))
                    planned.append(delta)
            else:
                skipped += 1
        return planned, skipped, distance

    def _plan_bucket(self, recommendation: dict) -> dict | None:
        """`gateway_policy` proposals arrive as a bucket spec
        fragment -- `bucket:<priority>=<rate>/<burst>` -- from
        tune/recommend.admission_recommendation."""
        proposed = str(recommendation.get("proposed", ""))
        head, _, value = proposed.partition("=")
        if not head.startswith("bucket:") or not value:
            return None
        try:
            priority = int(head.split(":", 1)[1])
            rate_text, _, burst_text = value.partition("/")
            rate = float(rate_text)
            burst = float(burst_text) if burst_text else None
        except ValueError:
            return None
        knob = f"bucket:{priority}"
        current = self._applied.get(("gateway", knob))
        if current is None:
            bucket = self.gateway.policy.buckets.get(priority)
            current = bucket.rate if bucket is not None else None
        value, clamped = self._clamp_step(current, rate)
        if value is None:
            return None
        delta = {"target": "gateway", "knob": knob, "value": value,
                 "before": current, "goal": rate, "clamped": clamped}
        if burst is not None:
            delta["burst"] = burst
        return delta

    def _plan_floors(self, recommendation: dict) -> list:
        """`autoscale_policy` proposals arrive as a policy spec
        fragment: `min_replicas=<n>;max_replicas=<m>`."""
        goals = {}
        for part in str(recommendation.get("proposed", "")).split(";"):
            key, _, value = part.partition("=")
            if key.strip() in ("min_replicas", "max_replicas"):
                try:
                    goals[key.strip()] = int(value)
                except ValueError:
                    pass
        floors = self.gateway.autoscaler.policy
        deltas = []
        for knob, live in (("min_replicas", floors.min_replicas),
                           ("max_replicas", floors.max_replicas)):
            goal = goals.get(knob)
            if goal is None:
                continue
            current = self._applied.get(("gateway", knob), live)
            value, clamped = self._clamp_step(current, goal)
            if value is not None:
                deltas.append({"target": "gateway", "knob": knob,
                               "value": value, "before": current,
                               "goal": goal, "clamped": clamped})
        # keep min <= max inside ONE tick: apply max raises before min
        # raises (the apply path clamps again, this just orders nicely)
        deltas.sort(key=lambda delta: delta["knob"] != "max_replicas")
        return deltas

    def _plan_checkpoint(self, recommendation: dict) -> dict | None:
        """`checkpoint` proposals arrive as a full checkpoint policy
        spec; the live-mutable part is the cadence
        (`checkpoint_every`), re-read by the engine's checkpointer on
        its next pump tick."""
        from ..decode.checkpoint import CheckpointPolicy
        target = str(recommendation.get("target", ""))
        try:
            goal = CheckpointPolicy.parse(
                str(recommendation.get("proposed", ""))).checkpoint_every
        except Exception:
            return None
        current = self._applied.get((target, "checkpoint_every"))
        if current is None:
            try:
                current = CheckpointPolicy.parse(
                    str(recommendation.get("current", ""))
                ).checkpoint_every
            except Exception:
                current = None
        value, clamped = self._clamp_step(current, int(goal))
        if value is None:
            return None
        return {"target": target, "knob": "checkpoint_every",
                "value": value, "before": current, "goal": int(goal),
                "clamped": clamped}

    def _clamp_step(self, current, proposed):
        """Bounded move from `current` toward `proposed`: at most
        max_delta_frac of the current value per tick (ints always get
        a step of at least 1, so small knobs are not frozen by the
        fraction).  Returns (value, clamped) -- value None when no
        move is needed, clamped True when the goal was not reached
        this tick."""
        if current is None:
            # nothing in effect yet (e.g. no admission bucket): the
            # proposal IS the bounded first step
            return proposed, False
        if isinstance(proposed, int):
            current = int(current)
            if proposed == current:
                return None, False
            limit = max(int(abs(current) * self.policy.max_delta_frac),
                        1)
            step = max(min(proposed - current, limit), -limit)
            value = current + step
            return value, value != proposed
        current = float(current)
        proposed = float(proposed)
        if proposed == current:
            return None, False
        limit = abs(current) * self.policy.max_delta_frac
        if limit <= 0.0:
            limit = abs(proposed)
        step = max(min(proposed - current, limit), -limit)
        value = current + step
        return value, abs(value - proposed) > 1e-9

    def _apply_delta(self, record: dict) -> None:
        """Apply ONE journaled delta record through the live setter
        paths.  Values are absolute, so applying the same record twice
        is a no-op -- the property journal replay (crash recovery, HA
        adoption) depends on."""
        gateway = self.gateway
        target = str(record.get("target", ""))
        knob = str(record.get("knob", ""))
        value = record.get("value")
        if target == "gateway":
            if knob.startswith("bucket:"):
                gateway.set_bucket_rate(int(knob.split(":", 1)[1]),
                                        float(value),
                                        burst=record.get("burst"))
            elif knob == "min_replicas":
                gateway.set_autoscale_floors(min_replicas=int(value))
            elif knob == "max_replicas":
                gateway.set_autoscale_floors(max_replicas=int(value))
        elif target.startswith("element:"):
            element = target.split(":", 1)[1]
            gateway.set_replica_parameter(element, knob, value)
        self._applied[(target, knob)] = value

    # -- journal adoption (crash recovery / HA promote) --------------------

    def adopt_journal(self) -> int:
        """Replay every journaled delta, in sequence order, through the
        SAME apply path a live tick uses.  Absolute values make this
        idempotent: a promoted standby adopting a journal mid-apply
        neither re-applies (double-steps) nor skips a delta -- it
        lands on exactly the configuration the primary had applied.
        Future ticks continue numbering above the adopted high water."""
        journal = self.gateway.journal
        if journal is None:
            return 0
        records = journal.replay_deltas()
        for record in records:
            try:
                self._apply_delta(record)
            except Exception as error:
                _LOGGER.warning("autopilot delta %s replay failed: %s",
                                record.get("seq"), error)
        if records:
            self._seq = max(self._seq,
                            max(int(record.get("seq", 0))
                                for record in records))
            self.registry.counter("autopilot.deltas_adopted").inc(
                len(records))
            self.gateway.telemetry.autopilot_summary = self.summary()
        return len(records)

    # -- fleet scope: burn-driven floor rebalancing ------------------------

    def _group(self) -> str:
        gateway = self.gateway
        return (getattr(gateway, "federation_group", "")
                or getattr(gateway, "ha_group", "") or gateway.name)

    def _publish_fleet_burn(self, burn) -> None:
        floors = (self.gateway.autoscaler.policy
                  if self.gateway.autoscaler is not None else None)
        payload = {"group": self._group(),
                   "burn": (round(burn, 4)
                            if burn is not None else None),
                   "floor": (floors.min_replicas
                             if floors is not None else None)}
        try:
            self.gateway.process.publish(
                f"{self._burn_root}/{self._group()}",
                json.dumps(payload, sort_keys=True), retain=True)
        except Exception as error:
            _LOGGER.warning("fleet burn publish failed: %s", error)

    def _on_fleet_burn(self, topic, payload) -> None:
        # transport thread: retained per-group burn beacons
        group = str(topic).rsplit("/", 1)[-1]
        if not payload:
            self._fleet_burns.pop(group, None)
            return
        try:
            record = json.loads(payload)
        except ValueError:
            return
        if isinstance(record, dict):
            self._fleet_burns[group] = record

    def _fleet_delta(self, burn) -> dict | None:
        """scope=fleet: adjust OUR OWN autoscale min floor from the
        fleet burn view -- raise while we burn and a peer group idles
        (capacity exists fleet-wide), donate (lower) while we idle and
        a peer burns.  Every group runs the same rule against the same
        retained beacons, so floors rebalance with no coordinator."""
        if (self.policy.scope != "fleet" or burn is None
                or self.gateway.autoscaler is None):
            return None
        my_group = self._group()
        peers = [record for group, record in
                 sorted(self._fleet_burns.items())
                 if group != my_group
                 and isinstance(record.get("burn"), (int, float))]
        if not peers:
            return None
        floors = self.gateway.autoscaler.policy
        current = self._applied.get(("gateway", "min_replicas"),
                                    floors.min_replicas)
        threshold = self.policy.burn_threshold
        hot = burn >= threshold
        peer_cool = any(record["burn"] < threshold / 2.0
                        for record in peers)
        peer_hot = any(record["burn"] >= threshold
                       for record in peers)
        if hot and peer_cool and current < floors.max_replicas:
            value = current + 1
        elif (not hot and burn < threshold / 2.0 and peer_hot
                and current > 1):
            value = current - 1
        else:
            return None
        return {"target": "gateway", "knob": "min_replicas",
                "value": value, "before": current, "goal": value,
                "clamped": False, "rebalance": True}

    # -- reporting ---------------------------------------------------------

    def summary(self) -> dict:
        """Compact scalars for the EC share (staged into the gateway
        telemetry summary under "autopilot") and the dashboard row."""
        counters = self.registry._counters

        def count(name: str) -> int:
            instrument = counters.get(name)
            return instrument.value if instrument is not None else 0

        summary = {
            "apply": self.policy.apply,
            "scope": self.policy.scope,
            "collections": count("autopilot.collections"),
            "deltas_applied": count("autopilot.deltas_applied"),
            "deltas_clamped": count("autopilot.deltas_clamped"),
            "deltas_skipped": count("autopilot.deltas_skipped"),
            "deltas_adopted": count("autopilot.deltas_adopted"),
            "backoffs": count("autopilot.backoffs"),
            "rebalances": count("autopilot.rebalances"),
        }
        if self.convergence is not None:
            summary["convergence"] = round(self.convergence, 4)
            summary["converged"] = self.converged
        burn = self.gateway.telemetry.windowed_burn()
        if burn is not None:
            summary["burn_window"] = round(burn, 4)
        return summary
