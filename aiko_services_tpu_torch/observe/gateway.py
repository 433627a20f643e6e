# GatewayTelemetry: the serving gateway's observability seam.
#
# Mirrors PipelineTelemetry's shape (one registry per gateway, hot-path
# instrument handles resolved once, a periodic snapshot publish on
# `{topic_path}/metrics` plus a compact EC-share summary) but records
# the SERVING-TIER vocabulary: admission decisions (admitted / shed,
# per priority), routing (frames routed, per-replica), backpressure
# (parked queue depth per priority, throttle transitions), and
# failover (replica deaths, streams migrated).  The admitted-latency
# histogram measures submit -> response through the whole tier -- the
# number an SLO is written against.
#
# Fleet tracing: the gateway is the ROOT-SPAN OWNER of every admitted
# frame's distributed trace.  `frame_begin` mints the trace id, the
# gateway's own spans (admit-wait, route decision, shed/throttle,
# failover replay -- see the taxonomy in observe/trace.py) accumulate
# on it, and the propagated context rides the frame data to every
# replica so their spans continue the SAME trace.  `export_trace` /
# `chrome_events` / `trace_metadata` mirror PipelineTelemetry's
# surface, so bench.py harvests a gateway exactly like a pipeline and
# `aiko trace merge` joins both on one timeline.

from __future__ import annotations


from ..utils import get_logger, monotonic
from .metrics import MetricsRegistry, SlidingWindow
from .trace import Tracer, now_us, to_us, trace_metadata

__all__ = ["GatewayTelemetry"]

_LOGGER = get_logger("gateway_telemetry")

DEFAULT_METRICS_INTERVAL = 10.0
# per-stream end-to-end decomposition entries kept in the summary: the
# EC share is a compact view, not a database (totals always ride)
DECOMPOSITION_STREAM_CAP = 32
# default sliding window for SLO burn: long enough to smooth one slow
# frame, short enough that the dashboard row is a LIVE health signal
DEFAULT_BURN_WINDOW_S = 60.0


class GatewayTelemetry:
    def __init__(self, gateway, enabled: bool = True,
                 interval: float = DEFAULT_METRICS_INTERVAL):
        self.gateway = gateway
        self.enabled = enabled
        self.registry = MetricsRegistry()
        self.tracer = Tracer()
        # per-stream end-to-end decomposition accumulators (seconds):
        # admit + route + queue + prefill + decode + emit -- where each
        # admitted stream's latency went, published in the summary/EC
        # share and rendered by the dashboard gateway plugin.  A
        # destroyed stream's stages fold into the persistent fleet
        # total, so the aggregate survives stream churn
        self._decomposition: dict[str, dict] = {}
        self._decomposition_total: dict[str, float] = {}
        registry = self.registry
        self.admitted = registry.counter("gateway.admitted")
        self.shed_streams = registry.counter("gateway.shed_streams")
        self.shed_frames = registry.counter("gateway.shed_frames")
        self.routed = registry.counter("gateway.routed")
        self.completed = registry.counter("gateway.completed")
        self.released = registry.counter("gateway.released")
        self.duplicates = registry.counter("gateway.duplicates")
        self.throttled = registry.counter("gateway.throttled")
        self.unthrottled = registry.counter("gateway.unthrottled")
        self.failovers = registry.counter("gateway.failovers")
        self.replica_deaths = registry.counter("gateway.replica_deaths")
        self.replicas = registry.gauge("gateway.replicas")
        self.parked = registry.gauge("gateway.parked")
        self.latency = registry.histogram("gateway.admit_latency_s")
        # elastic fleet (serve/autoscale.py): pool occupancy, scale
        # decisions, and the bring-up number the warm-start work
        # optimizes -- spawn decision -> replica serving its first frame
        self.pool_size = registry.gauge("gateway.pool_size")
        self.scale_ups = registry.counter("gateway.scale_up")
        self.scale_downs = registry.counter("gateway.scale_down")
        # disaggregated serving (serve/disagg.py): prefill-hop routing
        # plus the two outcomes -- a KV handoff forwarded to the decode
        # pool, or a degradation to local prefill (pool empty, prefill
        # error, or a parked frame whose handoff keys would expire)
        self.prefill_routed = registry.counter("gateway.prefill_routed")
        self.kv_migrations = registry.counter("gateway.kv_migrations")
        self.prefill_fallbacks = registry.counter(
            "gateway.prefill_fallbacks")
        # prefix-affinity routing (decode/prefix.py): hinted stream
        # placements that landed on a replica already holding the
        # stream's prefix chain head vs ones that could not (holder
        # saturated / draining / not yet warm) -- the A/B evidence the
        # prefix_cache bench compares across its affinity arms
        self.affinity_hits = registry.counter("gateway.affinity_hits")
        self.affinity_misses = registry.counter(
            "gateway.affinity_misses")
        # warm KV failover (decode/checkpoint.py): migrated streams
        # whose replay was deferred by the recovery_rate pacing window,
        # plus the LIVE count of cohorts still parked (decremented when
        # a cohort replays, its stream dies, or its stream is destroyed
        # -- the leak the destroy-while-paced regression test watches)
        self.recovery_paced = registry.counter("gateway.recovery_paced")
        self.recovery_paced_pending = registry.gauge(
            "gateway.recovery_paced_pending")
        # region-aware federation (serve/federation.py): streams
        # adopted from a LOST group's journal onto this survivor, and
        # the region-affinity outcome of every region-declaring stream
        # admission (did placement land in the client's region?)
        self.region_migrations = registry.counter(
            "gateway.region_migrations")
        self.region_affinity_hits = registry.counter(
            "gateway.region_affinity_hits")
        self.region_affinity_misses = registry.counter(
            "gateway.region_affinity_misses")
        self.time_to_healthy = registry.histogram(
            "gateway.time_to_healthy_ms")
        self.warm_spawns = registry.counter("gateway.spawns_warm")
        self.cold_spawns = registry.counter("gateway.spawns_cold")
        self.last_time_to_healthy_ms: float | None = None
        # crash consistency (serve/journal.py): HA takeovers and the
        # journal's write/replay accounting -- `takeover_ms` is the
        # recovery bound the chaos bench publishes (standby promote ->
        # every journaled stream re-pinned)
        self.takeovers = registry.counter("gateway.takeovers")
        self.takeover_ms = registry.histogram("gateway.takeover_ms")
        self.last_takeover_ms: float | None = None
        self.journal_appends = registry.counter("gateway.journal_appends")
        self.journal_entries = registry.gauge("gateway.journal_entries")
        self.journal_replayed = registry.counter(
            "gateway.journal_replayed")
        self.journal_dropped_stale = registry.counter(
            "gateway.journal_dropped_stale")
        # windowed SLO burn (observe/metrics.SlidingWindow): the
        # cumulative attainment/burn ratio goes stale as a health
        # signal on long runs, so the autopilot gate and the dashboard
        # `slo:` row both read burn over THIS window instead
        self.slo_window = SlidingWindow(DEFAULT_BURN_WINDOW_S)
        # per-tick summary the serve/autopilot.py loop stages for the
        # EC share (None until an autopilot is attached and has ticked)
        self.autopilot_summary: dict | None = None
        self._interval = interval
        self._timer = None
        if self.enabled and interval > 0:
            self._timer = self._publish_snapshot
            gateway.process.event.add_timer_handler(self._timer, interval)

    # -- fleet tracing: gateway root spans ---------------------------------

    def frame_begin(self, stream_id: str, frame_id: int):
        """Mint the ROOT trace for one admitted frame (the gateway owns
        the fleet-wide trace id); returns None with telemetry off, so
        the wire payload then carries no trace-context bytes at all."""
        if not self.enabled:
            return None
        return self.tracer.begin(stream_id, frame_id)

    def frame_done(self, trace, status: str = "ok") -> None:
        if trace is not None:
            self.tracer.finish(trace, status=status)

    def record_route(self, trace, start_s: float, replica_name: str,
                     pool: str = "decode") -> None:
        """The placement decision for one dispatched frame."""
        if trace is not None:
            trace.span("route:gateway", "gateway", to_us(start_s),
                       {"replica": replica_name, "pool": pool})

    def record_admit_wait(self, trace) -> float:
        """Admit-wait: frame submit -> FIRST replica dispatch.  Covers
        the parked-queue wait (zero-ish for an immediately dispatchable
        frame); THE span the admission-bound floor classifies on.
        Returns the elapsed seconds for the queue-stage decomposition."""
        if trace is None:
            return 0.0
        elapsed_us = now_us() - trace.start_us
        trace.span("admit:gateway", "gateway", trace.start_us)
        return elapsed_us / 1e6

    def record_shed_span(self, trace, reason: str) -> None:
        if trace is not None:
            trace.instant("shed:gateway", "gateway", {"reason": reason})

    def record_shed_stream(self, stream_id: str, reason: str) -> None:
        """A whole STREAM was shed at admission (no frame trace exists
        yet): a global gateway-lane instant."""
        if self.enabled:
            self.tracer.instant_global(
                "shed:gateway", "gateway",
                {"stream": stream_id, "reason": reason})

    def record_throttle_span(self, rate: float) -> None:
        if self.enabled:
            self.tracer.instant_global("throttle:gateway", "gateway",
                                       {"rate": rate})

    def record_replay(self, elapsed_s: float, streams: int,
                      frames: int, paced: bool = False,
                      paced_streams: int = 0,
                      paced_frames: int = 0) -> None:
        """One failover/drain migration wave (_migrate_streams), or a
        deferred paced-recovery wave: a global gateway-lane span so
        recovery storms are visible on the merged fleet timeline.
        `streams`/`frames` count what THIS wave replayed;
        `paced_streams`/`paced_frames` count what it re-pinned but
        deferred to scheduled `paced_replay:` waves."""
        if self.enabled:
            name = "paced_replay:gateway" if paced else "replay:gateway"
            args = {"streams": streams, "frames": frames}
            if paced_streams:
                args["paced_streams"] = paced_streams
                args["paced_frames"] = paced_frames
            self.tracer.span_global(name, "gateway", elapsed_s, args)

    # -- per-stream end-to-end decomposition -------------------------------

    def record_stage(self, stream_id: str, stage: str,
                     elapsed_s: float) -> None:
        """Accumulate one stage's share of a stream's end-to-end
        latency.  Stages: admit (admission processing), route
        (placement decisions), queue (parked wait), prefill (disagg
        hop 1), decode (pinned-replica service), emit (response
        delivery)."""
        if not self.enabled:
            return
        stages = self._decomposition.get(stream_id)
        if stages is None:
            if len(self._decomposition) >= DECOMPOSITION_STREAM_CAP:
                # the map is a compact view, not a database: past the
                # cap a stream's stages fold straight into the
                # persistent fleet total (same place destroyed streams
                # land), keeping memory and publish cost bounded at
                # 10k-stream scale
                self._decomposition_total[stage] = (
                    self._decomposition_total.get(stage, 0.0)
                    + elapsed_s)
                return
            stages = self._decomposition[stream_id] = {}
        stages[stage] = stages.get(stage, 0.0) + elapsed_s

    def forget_stream(self, stream_id: str) -> None:
        stages = self._decomposition.pop(stream_id, None)
        if stages:
            for stage, seconds in stages.items():
                self._decomposition_total[stage] = (
                    self._decomposition_total.get(stage, 0.0) + seconds)

    def stream_decomposition(self) -> dict:
        """Per-LIVE-stream decomposition in ms (bounded by
        DECOMPOSITION_STREAM_CAP; overflow streams accumulate straight
        into the total) plus the fleet `_total` aggregate (destroyed
        streams included) -- where every admitted stream's latency
        went, end to end."""
        totals = dict(self._decomposition_total)
        rendered = {}
        for stream_id in sorted(self._decomposition):
            stages = self._decomposition[stream_id]
            for stage, seconds in stages.items():
                totals[stage] = totals.get(stage, 0.0) + seconds
            rendered[stream_id] = {
                stage: round(seconds * 1e3, 3)
                for stage, seconds in sorted(stages.items())}
        rendered["_total"] = {stage: round(seconds * 1e3, 3)
                              for stage, seconds in sorted(
                                  totals.items())}
        return rendered

    # -- per-priority SLO attainment ---------------------------------------

    def record_slo(self, priority: int, within: bool,
                   tenant: str | None = None) -> None:
        """One completed frame of an SLO-carrying stream judged against
        its declared slo_ms: per-priority-bucket attainment/burn
        counters, plus a parallel per-TENANT family (`:t:{tenant}`)
        when the stream declared one -- the per-tenant accounting
        surface the multi-tenant isolation test reads."""
        if not self.enabled:
            return
        kind = "slo_ok" if within else "slo_miss"
        self.registry.counter(f"gateway.{kind}:p{priority}").inc()
        if tenant:
            self.registry.counter(f"gateway.{kind}:t:{tenant}").inc()

    def configure_slo_window(self, window_s: float) -> None:
        """Re-window the burn accounting (the autopilot aligns it with
        its policy's burn_window).  Existing samples are discarded --
        a window change is a new measurement, not a rescale."""
        self.slo_window = SlidingWindow(max(float(window_s), 1e-9))

    def sample_slo_window(self, now: float | None = None) -> None:
        """Feed the cumulative slo_ok/slo_miss counters into the
        sliding window.  Called from the snapshot timer and from the
        autopilot immediately before it reads the gate, so the window
        is fresh at decision time."""
        values = {name: counter.value
                  for name, counter in list(
                      self.registry._counters.items())
                  if name.startswith(("gateway.slo_ok:p",
                                      "gateway.slo_miss:p"))}
        self.slo_window.sample(monotonic() if now is None else now,
                               values)

    def windowed_burn(self, priority=None) -> float | None:
        """Burn rate miss/(ok+miss) over the sliding window -- across
        ALL priorities by default, or one priority bucket.  None when
        the window saw no judged traffic (no signal != zero burn)."""
        if priority is not None:
            return self.slo_window.burn(
                f"gateway.slo_miss:p{priority}",
                f"gateway.slo_ok:p{priority}")
        ok = miss = 0.0
        if len(self.slo_window._samples) < 2:
            return None
        for name in self.slo_window._samples[-1][2]:
            if name.startswith("gateway.slo_miss:p"):
                miss += self.slo_window.delta(name)
            elif name.startswith("gateway.slo_ok:p"):
                ok += self.slo_window.delta(name)
        total = ok + miss
        if total <= 0:
            return None
        return miss / total

    def slo_summary(self) -> dict:
        """Per-priority {ok, miss, attainment, burn, burn_window}:
        attainment is the in-SLO fraction, burn its cumulative
        complement (the error-budget burn fraction), burn_window the
        SAME ratio over the sliding window only (absent when the
        window saw no judged traffic)."""
        buckets: dict[str, dict] = {}
        snapshot = self.registry.snapshot()
        for name, value in (snapshot.get("counters") or {}).items():
            for kind, prefix in (("ok", "gateway.slo_ok:p"),
                                 ("miss", "gateway.slo_miss:p")):
                if name.startswith(prefix):
                    priority = name[len(prefix):]
                    buckets.setdefault(priority, {"ok": 0, "miss": 0})[
                        kind] = int(value)
        for priority, record in buckets.items():
            judged = record["ok"] + record["miss"]
            record["attainment"] = round(
                record["ok"] / judged, 4) if judged else None
            record["burn"] = round(
                record["miss"] / judged, 4) if judged else None
            windowed = self.windowed_burn(priority)
            if windowed is not None:
                record["burn_window"] = round(windowed, 4)
        # numeric priority order (p2 before p10), odd keys last
        return dict(sorted(
            buckets.items(),
            key=lambda item: (not item[0].isdigit(),
                              int(item[0]) if item[0].isdigit() else 0,
                              item[0])))

    def record_queue_depths(self, depths: dict) -> None:
        """Parked-queue occupancy PER PRIORITY (gauge family
        `gateway.queue_depth:p{n}`): overload triage needs to see WHICH
        priorities are waiting, not only the total."""
        if not self.enabled:
            return
        for priority, depth in depths.items():
            self.registry.gauge(
                f"gateway.queue_depth:p{priority}").set(depth)

    def record_replica_routed(self, replica_name: str) -> None:
        if not self.enabled:
            return
        self.registry.counter(f"gateway.routed:{replica_name}").inc()

    def record_spawn(self, time_to_healthy_ms: float,
                     warm: bool) -> None:
        """One finished replica bring-up: decision -> healthy, labeled
        warm (sibling hand-off + compile-cache) or cold."""
        self.time_to_healthy.record(time_to_healthy_ms)
        self.last_time_to_healthy_ms = round(time_to_healthy_ms, 2)
        (self.warm_spawns if warm else self.cold_spawns).inc()

    def record_takeover(self, takeover_ms: float) -> None:
        """One HA takeover: standby promoted, journal adopted, streams
        re-pinned."""
        self.takeovers.inc()
        self.takeover_ms.record(takeover_ms)
        self.last_takeover_ms = round(takeover_ms, 2)

    def snapshot(self) -> dict:
        return self.registry.snapshot()

    def summary(self) -> dict:
        """Compact scalars for the EC share / dashboards.  Admit-latency
        quantiles come from the ONE shared Histogram.quantile helper
        (the same estimate `aiko tune` and the dashboard read) instead
        of an ad-hoc re-derivation."""
        summary = {
            "admitted": self.admitted.value,
            "shed_streams": self.shed_streams.value,
            "shed_frames": self.shed_frames.value,
            "routed": self.routed.value,
            "completed": self.completed.value,
            "released": self.released.value,
            "throttled": self.throttled.value,
            "failovers": self.failovers.value,
            "replica_deaths": self.replica_deaths.value,
            "replicas": self.replicas.value,
            "parked": self.parked.value,
            "pool_size": self.pool_size.value,
            "scale_ups": self.scale_ups.value,
            "scale_downs": self.scale_downs.value,
        }
        if self.prefill_routed.value:
            summary["prefill_routed"] = self.prefill_routed.value
            summary["kv_migrations"] = self.kv_migrations.value
            summary["prefill_fallbacks"] = self.prefill_fallbacks.value
        if self.recovery_paced.value:
            summary["recovery_paced"] = self.recovery_paced.value
        if self.affinity_hits.value or self.affinity_misses.value:
            summary["affinity_hits"] = self.affinity_hits.value
            summary["affinity_misses"] = self.affinity_misses.value
        if self.region_migrations.value:
            summary["region_migrations"] = self.region_migrations.value
        if (self.region_affinity_hits.value
                or self.region_affinity_misses.value):
            summary["region_affinity_hits"] = (
                self.region_affinity_hits.value)
            summary["region_affinity_misses"] = (
                self.region_affinity_misses.value)
        slo = self.slo_summary()
        if slo:
            # per-priority SLO attainment/burn (the per-tenant
            # accounting surface): only streams that DECLARED slo_ms
            # are judged, so the key is absent on SLO-less fleets
            summary["slo"] = slo
        if self._decomposition or self._decomposition_total:
            summary["stream_decomposition"] = (
                self.stream_decomposition())
        if self.latency.count:
            summary["admit_latency_p50_ms"] = round(
                self.latency.quantile(0.5) * 1000, 3)
            summary["admit_latency_p99_ms"] = round(
                self.latency.quantile(0.99) * 1000, 3)
        if self.last_time_to_healthy_ms is not None:
            summary["time_to_healthy_ms"] = self.last_time_to_healthy_ms
        autoscaler = getattr(self.gateway, "autoscaler", None)
        if autoscaler is not None:
            summary["pool"] = self.gateway.pool_snapshot()
            summary["pending_spawns"] = autoscaler.pending
        journal = getattr(self.gateway, "journal", None)
        if journal is not None:
            ha = {
                "role": getattr(self.gateway, "role", "single"),
                "backend": journal.backend.kind,
                "journal_entries": self.journal_entries.value,
                "journal_appends": self.journal_appends.value,
                "replayed": self.journal_replayed.value,
                "dropped_stale": self.journal_dropped_stale.value,
                "takeovers": self.takeovers.value,
            }
            if self.last_takeover_ms is not None:
                ha["takeover_ms"] = self.last_takeover_ms
            summary["ha"] = ha
        if self.autopilot_summary is not None:
            summary["autopilot"] = self.autopilot_summary
        return summary

    def _publish_snapshot(self) -> None:
        gateway = self.gateway
        try:
            self.sample_slo_window()
            from ..utils import generate
            gateway.process.publish(
                f"{gateway.topic_path}/metrics",
                generate("metrics",
                         [gateway.topic_path, self.snapshot()]))
            if gateway.ec_producer is not None:
                # staged: the summary mirror coalesces with any
                # stream-churn share updates pending this tick
                gateway.ec_producer.stage("metrics", self.summary())
        except Exception as error:  # export must never kill the gateway
            _LOGGER.warning("gateway metrics publish failed: %s", error)

    # -- trace export (PipelineTelemetry-compatible surface) ---------------

    def chrome_events(self) -> list:
        return self.tracer.chrome_events(
            process_name=f"gateway:{self.gateway.name}")

    def trace_metadata(self, config: dict | None = None,
                       config_name: str | None = None) -> dict:
        """Self-describing metadata for the gateway's trace artifact:
        no pipeline definition (a gateway runs no graph), but the
        metrics snapshot, the tracer pid, and -- like every process --
        the clock epoch the fleet merger aligns with."""
        metadata = trace_metadata(config=config,
                                  config_name=config_name,
                                  metrics=self.snapshot(),
                                  clock_epoch=True)
        metadata["pids"] = [self.tracer._pid]
        metadata["role"] = "gateway"
        return metadata

    def export_trace(self, path: str, config: dict | None = None,
                     config_name: str | None = None) -> int:
        return self.tracer.export(
            path, process_name=f"gateway:{self.gateway.name}",
            metadata=self.trace_metadata(config=config,
                                         config_name=config_name))

    def stop(self) -> None:
        if self._timer is not None:
            self.gateway.process.event.remove_timer_handler(self._timer)
            self._timer = None
            self._publish_snapshot()
