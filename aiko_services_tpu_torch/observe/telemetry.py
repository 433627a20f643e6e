# PipelineTelemetry: the pipeline engine's single observability seam.
#
# One object per Pipeline owning a MetricsRegistry + frame Tracer, with
# every hot-path hook written so the DISABLED state (pipeline parameter
# `telemetry: false` -- the latency operating point) costs one attribute
# check and writes ZERO per-frame keys.  Enabled, the hooks keep the
# legacy `frame.metrics["time_*"]` keys byte-compatible (PE_Metrics and
# the bench latency math read them) while also feeding histograms,
# counters, and trace spans.
#
# Export: a periodic timer publishes the merged snapshot (pipeline
# registry + the process-global registry that the transfer plane and
# MQTT client write into) on `{topic_path}/metrics` -- matched by the
# Recorder's `{namespace}/+/+/+/metrics` subscription -- and mirrors a
# compact summary into the pipeline's EC share for dashboards.
#
# Span names/categories and the time_queue_* vs time_* key split
# follow THE taxonomy documented once in observe/trace.py.

from __future__ import annotations

import time

from ..utils import get_logger, truthy
from .metrics import MetricsRegistry, get_registry
from .trace import Tracer, now_us, to_us, trace_metadata

__all__ = ["PipelineTelemetry"]

_LOGGER = get_logger("telemetry")

DEFAULT_METRICS_INTERVAL = 10.0
# group-occupancy ladder: frames per coalesced call, not seconds
OCCUPANCY_BOUNDS = (1, 2, 4, 8, 16, 32, 64, 128)


class PipelineTelemetry:
    def __init__(self, pipeline):
        parameters = pipeline.definition.parameters or {}
        self.enabled = truthy(parameters.get("telemetry", True))
        self.pipeline = pipeline
        self.registry = MetricsRegistry()
        try:
            ring_size = int(parameters.get("trace_ring", 256))
        except (TypeError, ValueError):
            ring_size = 256
        self.tracer = Tracer(ring_size=ring_size)
        try:
            self._interval = float(parameters.get(
                "metrics_interval", DEFAULT_METRICS_INTERVAL) or 0.0)
        except (TypeError, ValueError):
            self._interval = DEFAULT_METRICS_INTERVAL
        self._timer = None
        # hot-path instrument handles resolved ONCE: per-frame hooks do
        # an attribute read + int add / bisect, never a name lookup
        # (the load heartbeat below is timer-driven, so `telemetry:
        # false` still means ZERO per-frame writes)
        registry = self.registry
        self._frames_total = registry.counter("pipeline.frames_total")
        self._frames_dropped = registry.counter(
            "pipeline.frames_dropped")
        self._frames_errored = registry.counter(
            "pipeline.frames_errored")
        self._fused_groups = registry.counter("pipeline.fused_groups")
        self._chained_groups = registry.counter(
            "pipeline.chained_groups")
        self._element_hists: dict = {}
        self._queue_hists: dict = {}
        if self._interval > 0:
            # with telemetry off only the cheap load heartbeat runs:
            # serving gateways age a replica's EC share (`stale_after`)
            # and would otherwise permanently distrust a healthy but
            # idle telemetry-disabled replica
            self._timer = (self._publish_snapshot if self.enabled
                           else self._publish_load)
            pipeline.process.event.add_timer_handler(
                self._timer, self._interval)

    # -- construction-time validation --------------------------------------

    def record_lint(self, report) -> None:
        """Static-analysis findings from construction-time validation:
        `lint.findings` plus a per-rule-code breakdown, so fleets can
        see definitions admitted WITH warnings (error findings never
        get here -- they fail construction).  Recorded even with
        telemetry disabled: this is a once-per-construction write, not
        a per-frame one, and a disabled-telemetry fleet still wants to
        know its definitions carry findings."""
        findings = getattr(report, "findings", None) or []
        self.registry.counter("lint.findings").inc(len(findings))
        for code, count in report.by_code().items():
            self.registry.counter(f"lint.findings.{code}").inc(count)

    # -- frame lifecycle ---------------------------------------------------

    def frame_begin(self, stream, frame, context: dict | None = None
                    ) -> None:
        if not self.enabled:
            return
        frame.trace = self.tracer.begin(stream.stream_id, frame.frame_id)
        if context is not None:
            # cross-process continuation: the gateway (or another
            # upstream hop) minted this trace -- keep its id, parent
            # our frame span under its span id
            frame.trace.adopt(context)

    def frame_end(self, stream, frame, dropped: bool = False,
                  error: bool = False) -> None:
        if not self.enabled:
            return
        self._frames_total.inc()
        if error:
            self._frames_errored.inc()
        elif dropped:
            self._frames_dropped.inc()
        trace = frame.trace
        if trace is not None:
            self.tracer.finish(
                trace, status=("error" if error
                               else "dropped" if dropped else "ok"))
            frame.trace = None

    # -- element execution -------------------------------------------------

    def record_element(self, frame, node: str, start_s: float,
                       elapsed_s: float, path: str = "inline",
                       group: int | None = None) -> None:
        """One element call finished: the legacy time_{node} key, the
        per-node latency histogram, and a trace span tagged with the
        dispatch path (inline / fused / chained / async / remote)."""
        if not self.enabled:
            return
        metrics = frame.metrics
        key = "time_" + node
        metrics[key] = metrics.get(key, 0.0) + elapsed_s
        histogram = self._element_hists.get(node)
        if histogram is None:
            histogram = self._element_hists[node] = (
                self.registry.histogram("element_s:" + node))
        histogram.record(elapsed_s)
        trace = frame.trace
        if trace is not None:
            args = {"path": path}
            if group is not None:
                args["group"] = group
            trace.events.append(
                ("X", node, "element", to_us(start_s), elapsed_s * 1e6,
                 args))

    def record_pipeline_pass(self, frame, start_s: float) -> None:
        if not self.enabled:
            return
        frame.metrics["time_pipeline"] = (
            frame.metrics.get("time_pipeline", 0.0)
            + time.perf_counter() - start_s)

    # -- parks, queues, resumes --------------------------------------------

    def mark_park(self, frame, node: str, kind: str) -> None:
        """A branch left the event loop (micro-batch park, async worker,
        remote hop).  Micro parks also open the queue-wait interval."""
        if not self.enabled:
            return
        trace = frame.trace
        if trace is None:
            return
        trace.instant(f"park:{node}", "park", {"kind": kind})
        if kind == "micro":
            trace.mark(node)

    def record_queue_wait(self, frame, node: str) -> None:
        """Close the park's queue-wait interval at flush time: the span
        between parking and the coalesced dispatch is scheduler-induced
        latency, reported apart from device/element time."""
        if not self.enabled:
            return
        trace = frame.trace
        if trace is None:
            return
        start = trace.take_mark(node)
        if start is None:
            return
        wait_s = (now_us() - start) / 1e6
        key = "time_queue_" + node
        frame.metrics[key] = frame.metrics.get(key, 0.0) + wait_s
        histogram = self._queue_hists.get(node)
        if histogram is None:
            histogram = self._queue_hists[node] = (
                self.registry.histogram("queue_s:" + node))
        histogram.record(wait_s)
        trace.events.append(
            ("X", f"queue:{node}", "queue", start, wait_s * 1e6, None))

    def mark_resume(self, frame, node: str,
                    elapsed_s: float | None = None,
                    path: str = "async") -> None:
        """A parked branch resumed (async reply or remote response);
        `elapsed_s` is the off-loop work time the reply reported and
        `path` attributes the span (async worker vs remote hop)."""
        if not self.enabled:
            return
        if elapsed_s is not None:
            key = "time_" + node
            frame.metrics[key] = frame.metrics.get(key, 0.0) + elapsed_s
            histogram = self._element_hists.get(node)
            if histogram is None:
                histogram = self._element_hists[node] = (
                    self.registry.histogram("element_s:" + node))
            histogram.record(elapsed_s)
        trace = frame.trace
        if trace is not None:
            if elapsed_s is not None:
                trace.events.append(
                    ("X", node, "element", now_us() - elapsed_s * 1e6,
                     elapsed_s * 1e6, {"path": path}))
            trace.instant(f"resume:{node}", "park", None)

    def record_engine_frame(self, frame, node: str, stats_rows) -> None:
        """A continuous-batching engine (LMGenerate `continuous: true`)
        finished every row of a frame: per-slot spans (queue_wait /
        prefill / decode_steps) reconstructed from the engine's
        completion stats onto the frame trace, so Perfetto shows where
        each request's lifetime went even though the engine ran it
        interleaved with other frames' slots."""
        if not self.enabled:
            return
        # queue-wait vs compute split, SAME keys as the micro-batch
        # paths: time_queue_{node} is scheduler/slot-induced wait (the
        # frame completes when its slowest row does, so the frame's
        # wait is the MAX row wait), and the response-side time_{node}
        # (mark_resume) carries compute excluding that wait -- tune's
        # attribution reads these keys identically on the fused,
        # chained, and engine-managed paths
        queue_wait_s = max(
            (float(stats.get("queue_wait_s", 0.0))
             for stats in stats_rows), default=0.0)
        key = "time_queue_" + node
        frame.metrics[key] = frame.metrics.get(key, 0.0) + queue_wait_s
        histogram = self._queue_hists.get(node)
        if histogram is None:
            histogram = self._queue_hists[node] = (
                self.registry.histogram("queue_s:" + node))
        histogram.record(queue_wait_s)
        trace = frame.trace
        if trace is None:
            return
        end = now_us()
        for row, stats in enumerate(stats_rows):
            total = float(stats.get("total_s", 0.0)) * 1e6
            queue = float(stats.get("queue_wait_s", 0.0)) * 1e6
            prefill = float(stats.get("prefill_s", 0.0)) * 1e6
            start = end - total
            suffix = f"[{row}]" if len(stats_rows) > 1 else ""
            trace.events.append(
                ("X", f"queue:{node}{suffix}", "queue", start, queue,
                 None))
            # prefix-cache evidence rides the prefill span: the loader
            # turns prefix_blocks into per-element hit evidence so the
            # tune model can tell a CACHE-BOUND prefill floor (most of
            # the prompt skipped) from a compute-bound one
            prefill_args = None
            if stats.get("prefix_blocks") is not None:
                prefill_args = {
                    "prefix_blocks": stats.get("prefix_blocks")}
            trace.events.append(
                ("X", f"prefill:{node}{suffix}", "engine", start + queue,
                 prefill, prefill_args))
            trace.events.append(
                ("X", f"decode_steps:{node}{suffix}", "engine",
                 start + queue + prefill,
                 max(total - queue - prefill, 0.0),
                 {"decode_steps": stats.get("decode_steps"),
                  "preemptions": stats.get("preemptions"),
                  "tokens": stats.get("tokens")}))

    def record_adopt(self, stream, frame_id, node: str,
                     elapsed_s: float,
                     parent: dict | None = None) -> None:
        """A disaggregated decode element adopted a frame's migrated
        KV blocks (fetch + pool scatter): its own span category so
        `aiko tune` classifies migration-bound elements distinctly
        from queue-bound ones.  `parent` is the prefill hop's trace
        context (it rode the handoff descriptor), recorded as the
        span's cross-process parent link."""
        if not self.enabled:
            return
        self.registry.histogram("adopt_s:" + node).record(elapsed_s)
        frame = (stream.frames.get(frame_id)
                 if stream is not None else None)
        trace = frame.trace if frame is not None else None
        if trace is not None:
            args = None
            if parent and parent.get("span_id"):
                args = {"parent": str(parent["span_id"])}
            trace.events.append(
                ("X", f"adopt:{node}", "engine",
                 now_us() - elapsed_s * 1e6, elapsed_s * 1e6, args))

    def record_checkpoint(self, node: str, elapsed_s: float,
                          checkpoint_bytes: int) -> None:
        """One decode-state snapshot shipped (decode/checkpoint.py):
        per-node latency histogram plus a GLOBAL engine span -- the
        snapshot covers every due slot, so it belongs to no single
        frame -- which the tune loader joins as `checkpoint:{node}`
        and the classifier labels checkpoint-bound when it dominates
        compute/queue/adopt."""
        if not self.enabled:
            return
        self.registry.histogram("checkpoint_s:" + node).record(
            elapsed_s)
        self.tracer.span_global(
            f"checkpoint:{node}", "engine", elapsed_s,
            {"bytes": int(checkpoint_bytes)})

    # -- fault tolerance ---------------------------------------------------

    def record_retry(self, frame, node: str, attempt: int,
                     delay_s: float) -> None:
        """One element call failed and was scheduled for retry under the
        `on_error: retry` policy."""
        if not self.enabled:
            return
        self.registry.counter("pipeline.retries").inc()
        self.registry.counter(f"retries:{node}").inc()
        trace = frame.trace
        if trace is not None:
            trace.instant(f"retry:{node}", "fault",
                          {"attempt": attempt,
                           "delay_ms": round(delay_s * 1000, 3)})

    def record_dead_letter(self, node: str | None, reason: str) -> None:
        if not self.enabled:
            return
        self.registry.counter("pipeline.dead_letters").inc()
        self.registry.counter(f"dead_letters:{reason}").inc()

    def record_park_expired(self, frame, nodes) -> None:
        """The doubtful-park watchdog released a frame: kills must show
        up in telemetry, not only as a log line."""
        if not self.enabled:
            return
        self.registry.counter("pipeline.park_expired").inc()
        trace = frame.trace
        if trace is not None:
            trace.instant("park_expired", "fault",
                          {"nodes": sorted(str(n) for n in nodes)})

    def record_deadline_expired(self, frame) -> None:
        if not self.enabled:
            return
        self.registry.counter("pipeline.deadline_expired").inc()
        trace = frame.trace
        if trace is not None:
            trace.instant("frame_deadline", "fault",
                          {"pending": sorted(str(n) for n
                                             in frame.pending_nodes)})

    def record_stream_collision(self, stream_id: str) -> None:
        """create_stream hit an already-registered stream_id with
        DIFFERENT parameters: the caller got the existing stream, not
        one configured as requested -- counted so id-allocation bugs
        upstream (two clients minting the same id) surface in metrics,
        not only in one warning line."""
        if not self.enabled:
            return
        self.registry.counter("pipeline.stream_id_collision").inc()

    def record_breaker_trip(self, stream_id: str) -> None:
        """A stream blew its error budget and was quarantined."""
        if not self.enabled:
            return
        self.registry.counter("pipeline.breaker_trips").inc()
        self.tracer.instant_global(f"breaker:{stream_id}", "fault", None)

    def record_fused_failure(self, node: str, disabled: bool) -> None:
        """A fused group program failed at run time (the group retried
        on the chained path); `disabled` marks the flap limit tripping,
        after which the element runs chained permanently."""
        if not self.enabled:
            return
        self.registry.counter("pipeline.fused_failures").inc()
        if disabled:
            self.registry.counter("pipeline.fused_disabled").inc()
            self.tracer.instant_global(f"fused_disabled:{node}", "fault",
                                       None)

    # -- micro-batch scheduler ---------------------------------------------

    def record_group(self, node: str, size: int, rows: int,
                     fused: bool) -> None:
        if not self.enabled:
            return
        (self._fused_groups if fused else self._chained_groups).inc()
        self.registry.histogram(
            f"group_frames:{node}", OCCUPANCY_BOUNDS).record(size)
        self.registry.histogram(
            f"group_rows:{node}", OCCUPANCY_BOUNDS).record(rows)

    def record_compile(self, node: str, what: str) -> None:
        if not self.enabled:
            return
        self.registry.counter(f"pipeline.compiles_{what}").inc()
        self.tracer.instant_global(f"compile:{node}", "compile",
                                   {"what": what})

    def record_cohort_split(self, node: str, cohorts: int) -> None:
        if not self.enabled:
            return
        self.registry.counter("pipeline.cohort_splits").inc()
        self.registry.gauge(f"cohorts:{node}").set(cohorts)

    # -- element-side device instruments -----------------------------------

    def record_device(self, node: str, compute_s: float,
                      block_ready_s: float | None = None) -> None:
        """ComputeElement device work: host-observed dispatch+compute
        time, plus the explicit block_until_ready wait when the element
        runs with blocking_metrics."""
        if not self.enabled:
            return
        self.registry.histogram(f"compute_s:{node}").record(compute_s)
        if block_ready_s is not None:
            self.registry.histogram(
                f"block_ready_s:{node}").record(block_ready_s)

    # -- export ------------------------------------------------------------

    def snapshot(self) -> dict:
        """THIS pipeline's registry only (see process_snapshot)."""
        return self.registry.snapshot()

    @staticmethod
    def process_snapshot() -> dict:
        """The process-global registry (transfer plane, MQTT client).
        Published under a PROCESS-scoped source name, never merged into
        a pipeline's snapshot: N pipelines in one process would
        otherwise each republish the same global counters and the
        Recorder's fleet merge would count them N times.  The hand-written
        kernels' launch counts (ops/kernels.py) ride along as
        `kernel_launches.<kernel>` counters, once a kernel has launched,
        so a replica in another OS process shows its path went through
        them."""
        from ..ops import kernels
        snapshot = get_registry().snapshot()
        for name, count in kernels.launch_counts.items():
            if count:
                snapshot["counters"][f"kernel_launches.{name}"] = count
        return snapshot

    def summary(self) -> dict:
        """Compact scalars for the EC share / dashboard plugin.  The
        `load` sub-dict is the serving gateway's periodic load gauge: a
        remote gateway admits/routes against these numbers (refreshed
        every metrics_interval) between the create/destroy-time share
        updates."""
        summary = {
            "load": self.pipeline.load(),
            "frames": self._frames_total.value,
            "dropped": self._frames_dropped.value,
            "errors": self._frames_errored.value,
            "fused_groups": self._fused_groups.value,
            "chained_groups": self._chained_groups.value,
            "compiles_fused": self.registry.counter(
                "pipeline.compiles_fused").value,
            "cohort_splits": self.registry.counter(
                "pipeline.cohort_splits").value,
            "retries": self.registry.counter("pipeline.retries").value,
            "dead_letters": self.registry.counter(
                "pipeline.dead_letters").value,
        }
        decode = self.decode_summary()
        if decode is not None:
            summary["decode"] = decode
        exports = self.registry.counter("prefill.exports").value
        if exports:
            # a prefill-pool replica (LMGenerate role=prefill): its
            # export/queue numbers are what the disagg autoscaler's
            # queue-pressure signal and the dashboard read
            summary["prefill"] = {
                "exports": exports,
                "exported_bytes": self.registry.counter(
                    "prefill.exported_bytes").value,
                "chunks": self.registry.counter(
                    "prefill.chunks").value,
            }
        return summary

    def decode_summary(self) -> dict | None:
        """Continuous-batching engine scalars (decode/ gauges +
        counters) for the EC share, so slot occupancy is visible PER
        REPLICA on the dashboard services page and to the gateway's
        ECConsumer mirrors -- not only on the live-metrics page.  None
        when no engine has registered (the common non-LLM pipeline)."""
        if not self.registry.has_gauge("decode.active_slots"):
            return None
        summary = {
            "active_slots": self.registry.gauge(
                "decode.active_slots").value,
            "free_blocks": self.registry.gauge(
                "decode.free_blocks").value,
            "waiting": self.registry.gauge("decode.waiting").value,
            "admitted": self.registry.counter("decode.admitted").value,
            "completed": self.registry.counter("decode.completed").value,
            "preempted": self.registry.counter("decode.preempted").value,
            "deferred": self.registry.counter(
                "decode.deferred_admissions").value,
        }
        # kernel-floor features surface only when in use, so the
        # summary shape of a plain engine stays unchanged
        chunks = self.registry.counter("decode.prefill_chunks").value
        if chunks:
            summary["prefill_chunks"] = chunks
            summary["chunk_interleaves"] = self.registry.counter(
                "decode.chunk_interleaves").value
        drafted = self.registry.counter("decode.spec_drafted").value
        if drafted:
            accepted = self.registry.counter(
                "decode.spec_accepted").value
            windows = max(
                self.registry.histogram("decode.accepted_len").count, 1)
            summary["accepted_len_mean"] = round(accepted / windows, 3)
        adopted = self.registry.counter("decode.adopted").value
        fallbacks = self.registry.counter(
            "decode.adopt_fallbacks").value
        if adopted or fallbacks:
            # disaggregated decode pool: KV migrations in, and the
            # degradations the prefill-pool autoscaler watches
            summary["adopted"] = adopted
            summary["adopt_fallbacks"] = fallbacks
            summary["kv_migrated_bytes"] = self.registry.counter(
                "decode.kv_migrated_bytes").value
        checkpoints = self.registry.counter("decode.checkpoints").value
        if checkpoints:
            # warm KV failover: snapshot cadence + the restore ledger
            # (restores = re-prefills avoided; fallbacks = degraded)
            summary["checkpoints"] = checkpoints
            summary["checkpoint_bytes"] = self.registry.counter(
                "decode.checkpoint_bytes").value
        restores = self.registry.counter("decode.restores").value
        restore_fallbacks = self.registry.counter(
            "decode.restore_fallbacks").value
        if restores or restore_fallbacks:
            summary["restores"] = restores
            summary["restore_fallbacks"] = restore_fallbacks
            summary["restore_replayed_tokens"] = self.registry.counter(
                "decode.restore_replayed_tokens").value
        return summary

    def _publish_snapshot(self) -> None:
        pipeline = self.pipeline
        try:
            from ..utils import generate
            topic = f"{pipeline.topic_path}/metrics"
            pipeline.process.publish(
                topic, generate("metrics",
                                [pipeline.topic_path, self.snapshot()]))
            # the process-global registry rides the same topic under an
            # OS-process-scoped source: every pipeline (and every
            # framework Process object sharing this interpreter)
            # republishes it, but consumers key by SOURCE, so it merges
            # exactly once.  os.getpid(), NOT process.process_id: a
            # second Process object in one interpreter gets a "-1"
            # suffixed id while sharing the SAME global registry
            import os
            pipeline.process.publish(
                topic, generate("metrics", [
                    f"{pipeline.process.namespace}/"
                    f"{pipeline.process.hostname}/{os.getpid()}/process",
                    self.process_snapshot()]))
            if pipeline.ec_producer is not None:
                summary = self.summary()
                # COALESCED: the summary + load scalars fold into ONE
                # delta payload per lease per tick (stage/flush), with
                # unchanged scalars dropped from the payload -- the
                # telemetry tick costs one control-plane publish per
                # consumer, not three.  The serving gateway's
                # ECConsumer mirror reads plain `inflight` /
                # `queue_depth` keys (nested dicts are awkward over the
                # EC wire), refreshed here between stream-churn updates
                load = summary.get("load") or {}
                pipeline.ec_producer.stage("metrics", summary)
                pipeline.ec_producer.stage(
                    "inflight", load.get("inflight", 0))
                pipeline.ec_producer.stage(
                    "queue_depth", load.get("queue_depth", 0))
        except Exception as error:  # export must never kill the engine
            _LOGGER.warning("metrics publish failed: %s", error)

    def _publish_load(self) -> None:
        """The telemetry-disabled heartbeat: refresh ONLY the EC share
        load scalars (no registry snapshot, no tracing, nothing
        per-frame touched)."""
        pipeline = self.pipeline
        try:
            if pipeline.ec_producer is not None:
                load = pipeline.load()
                # staged, with `inflight` forced: one delta payload per
                # heartbeat (the forced key keeps the gateway's
                # staleness clock -- ECConsumer.last_update -- ticking
                # for an idle replica whose load never changes)
                pipeline.ec_producer.stage(
                    "inflight", load.get("inflight", 0), force=True)
                pipeline.ec_producer.stage(
                    "queue_depth", load.get("queue_depth", 0))
        except Exception as error:
            _LOGGER.warning("load heartbeat failed: %s", error)

    def stop(self) -> None:
        if self._timer is not None:
            self.pipeline.process.event.remove_timer_handler(self._timer)
            self._timer = None
            if self.enabled:
                self._publish_snapshot()  # final flush: no stale window

    # -- trace export ------------------------------------------------------

    def chrome_events(self) -> list:
        return self.tracer.chrome_events(
            process_name=f"pipeline:{self.pipeline.name}")

    def trace_metadata(self, config: dict | None = None,
                       config_name: str | None = None) -> dict:
        """Self-describing metadata for this pipeline's trace export:
        the definition document (reconstructed from the live
        definition, so applied parameter updates are captured), its
        fingerprint, and a metrics snapshot -- everything `aiko tune`
        needs to replay the trace with no side-channel files."""
        from ..pipeline.definition import definition_to_document
        metadata = trace_metadata(
            definition_document=definition_to_document(
                self.pipeline.definition),
            config=config, config_name=config_name,
            metrics=self.snapshot(), clock_epoch=True)
        # this tracer's synthetic pid: when several pipelines' events
        # share one artifact (bench combined file, router replicas),
        # the tune loader filters spans to the selected run's pids
        metadata["pids"] = [self.tracer._pid]
        return metadata

    def export_trace(self, path: str, config: dict | None = None,
                     config_name: str | None = None) -> int:
        return self.tracer.export(
            path, process_name=f"pipeline:{self.pipeline.name}",
            metadata=self.trace_metadata(config=config,
                                         config_name=config_name))
