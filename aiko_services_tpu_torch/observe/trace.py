# Frame tracer: Dapper-style per-frame traces exported as Chrome-trace
# JSON (Perfetto-loadable).
#
# A trace id is minted per frame at stream ingress; the pipeline engine
# appends span records (element execution, queue wait, fused vs chained
# dispatch, park/resume, compile events) to the frame's FrameTrace as the
# frame moves through the graph.  Completed traces land in a bounded ring;
# export renders them as Chrome trace-event JSON ("X" complete events for
# spans, "i" instants for point events, "M" metadata naming the process
# and one thread lane per stream), which chrome://tracing and Perfetto
# both load directly.
#
# SPAN TAXONOMY -- the one canonical reference (telemetry.py, the
# serving gateway, and tune/loader.py all follow this table):
#
#   category   span names                    meaning
#   --------   ---------------------------   ---------------------------
#   frame      "frame {id}"                  one frame's whole lifetime
#                                            in ONE process (per-process
#                                            root; carries span_id and,
#                                            on a propagated trace, the
#                                            upstream parent span id)
#   element    "{node}"                      one element call; args.path
#                                            = inline|fused|chained|
#                                            async|remote
#   queue      "queue:{node}"                scheduler-induced wait
#                                            (micro-batch park -> flush,
#                                            or engine slot wait when
#                                            row-suffixed "queue:lm[3]")
#   engine     "prefill:{node}",             continuous-batching engine
#              "decode_steps:{node}",        phases; "adopt:" = KV
#              "adopt:{node}",               migration (disagg or warm
#              "checkpoint:{node}"           restore), "checkpoint:" =
#                                            snapshot shipping (global
#                                            lane: covers every slot)
#   gateway    "admit:gateway",              serving-tier spans: admit =
#              "route:gateway",              frame submit -> replica
#              "replay:gateway",             dispatch (parked/admission
#              "shed:gateway",               wait), route = placement
#              "throttle:gateway",           decision, replay = failover
#              "paced_replay:gateway"        _migrate_streams wave,
#                                            paced_replay = deferred
#                                            recovery wave; shed/
#                                            throttle are instants
#   compile    "compile:{node}"              (re)compilation instants
#   park/fault instants                      park/resume, retries,
#                                            deadline + breaker events
#   program    "flush:{node}" > "gather:",   the port's own spans of work
#              "element:{node}", "split:";   that belongs to no single
#              "asr.frontend", "asr.encode", frame, on the process-wide
#              "asr.cross_kv", "asr.decode"; tracer PROGRAM (global lane
#              "engine.step" >               0; recorded only while a
#              "engine.admit" >              torch.profiler records or
#              "engine.prefill",             after record_program_spans
#              "engine.prefill_chunk",       (True)).  flush = one
#              "engine.decode",              coalesced group, dispatch to
#              "engine.verify";              the members' downstream run;
#              "queue:engine" (interval)     asr.* and engine.prefill/
#                                            prefill_chunk/decode/verify
#                                            carry device ms (CUDA
#                                            events); queue:engine =
#                                            arrival -> admission
#                                            (">" = encloses)
#
# Program spans on the device trace's clock: torch.profiler's (Kineto's)
# host timestamps are Unix-epoch nanoseconds, so a program span's
# perf_counter start `s` lies at
#     (to_us(s) + clock_epoch_unix_us()) * 1e3   ns
# on a torch.profiler trace -- the metadata's `clock_epoch_unix_us` lines
# an export of PROGRAM up with a torch.profiler Chrome trace in one
# Perfetto view.  Each program span also enters
# torch.profiler.record_function(name), so on a thread the profiler
# captures it nests with the aten ops and kernels it launched.
#
# Naming scheme: "{kind}:{node}" -- tune/loader._node_of strips the
# prefix (and the "[row]" suffix) to join spans to typed graph nodes.
# The matching frame.metrics keys split the SAME way on every dispatch
# path: `time_{node}` is element/device compute, `time_queue_{node}` is
# scheduler wait (micro-batch fill, engine slot wait) -- never mixed.
#
# Cross-process propagation: a TRACE CONTEXT ({trace_id, span_id}) rides
# frame data under TRACE_CONTEXT_KEY.  The serving gateway mints the
# trace at admission (root-span owner); every downstream process pops
# the context at stream ingress and CONTINUES the same trace -- its
# frame span carries the propagated trace_id plus parent = the upstream
# span id, so a merged artifact (observe/collector.py) nests gateway ->
# replica -> prefill/keeper spans on one timeline.
#
# Cost contract: when tracing is disabled the frame carries trace=None
# and every hook is a single `is None` check; when enabled, a span is one
# perf_counter read and one tuple append -- no dict churn on the hot
# path, events materialize only at export.  A program span while nothing
# records is one flag read returning a shared no-op context: no record,
# no record_function, no CUDA event.

from __future__ import annotations

import hashlib
import itertools
import json
import os
import sys
import threading
import time
from collections import deque

__all__ = ["FrameTrace", "PROGRAM", "ProgramSpan", "Tracer",
           "TRACE_CONTEXT_KEY", "attach_trace_context",
           "chrome_trace_document", "clock_epoch_unix_us",
           "definition_fingerprint", "make_trace_context",
           "pop_trace_context", "record_program_spans", "recording",
           "trace_context_of", "trace_metadata", "trace_metadata_of"]

# trace-metadata schema version: bumped when the embedded layout
# changes; the tune/ loader refuses versions it does not understand
# instead of silently mis-reading spans
TRACE_METADATA_SCHEMA = 1

# One clock epoch per process: every span timestamp is microseconds since
# this moment, so spans from different streams/elements line up on one
# export timeline.
_EPOCH = time.perf_counter()


def now_us() -> float:
    return (time.perf_counter() - _EPOCH) * 1e6


def to_us(perf_counter_s: float) -> float:
    """A raw time.perf_counter() reading on the export timeline."""
    return (perf_counter_s - _EPOCH) * 1e6


def clock_epoch_unix_us() -> float:
    """Wall-clock microseconds (Unix epoch) at THIS process's trace
    timestamp 0.  Every export stamps it into trace_metadata so the
    fleet merger (observe/collector.py) can shift per-process
    timestamps onto one shared timeline: two processes whose spans are
    concurrent in wall time stay concurrent in the merged artifact,
    regardless of when each process booted."""
    return time.time() * 1e6 - now_us()


# reserved frame-data key the cross-process trace context rides under:
# popped at stream ingress (never reaches element inputs), absent
# entirely when the sender's telemetry is disabled -- the wire payload
# is then byte-identical to an untraced build's
TRACE_CONTEXT_KEY = "_trace_context"


def make_trace_context(trace: "FrameTrace") -> dict:
    """The propagable identity of one frame trace: the (possibly
    already-propagated) trace id plus THIS process's frame span id as
    the downstream parent."""
    return {"trace_id": trace.trace_id, "span_id": trace.span_id}


def trace_context_of(frame_data) -> dict | None:
    """Read (without removing) the trace context riding `frame_data`."""
    if not isinstance(frame_data, dict):
        return None
    context = frame_data.get(TRACE_CONTEXT_KEY)
    return context if isinstance(context, dict) else None


def attach_trace_context(frame_data: dict, context: dict) -> dict:
    """A COPY of `frame_data` carrying `context` -- the original stays
    untouched so failover replay / byte-compare semantics hold."""
    merged = dict(frame_data)
    merged[TRACE_CONTEXT_KEY] = context
    return merged


def pop_trace_context(frame_data) -> dict | None:
    """Remove and return the trace context (stream-ingress side): the
    context must never leak into element inputs or outputs."""
    if not isinstance(frame_data, dict):
        return None
    context = frame_data.pop(TRACE_CONTEXT_KEY, None)
    return context if isinstance(context, dict) else None


class FrameTrace:
    """Span accumulator for ONE frame: rides Frame.trace through the
    graph.  `marks` holds open interval starts (queue parks) keyed by
    node; `events` holds finished records as tuples
    (kind, name, category, ts_us, dur_us, args).  The frame's own
    top-level span is NOT an event -- it is built at export from
    start/end/status, keeping the per-frame hot path to appends."""

    __slots__ = ("pid", "seq", "stream_id", "frame_id", "start_us",
                 "end_us", "status", "events", "marks",
                 "origin_trace_id", "parent_span_id")

    def __init__(self, pid: int, seq: int, stream_id: str,
                 frame_id: int):
        self.pid = pid
        self.seq = seq
        self.stream_id = stream_id
        self.frame_id = frame_id
        self.start_us = now_us()
        self.end_us = None
        self.status = "ok"
        self.events: list = []
        self.marks: dict | None = None  # lazily built on first park
        # cross-process propagation (see TRACE_CONTEXT_KEY): when an
        # upstream process (the serving gateway) minted the trace, this
        # frame CONTINUES it -- same trace id, parented to the
        # upstream frame span
        self.origin_trace_id: str | None = None
        self.parent_span_id: str | None = None

    @property
    def trace_id(self) -> str:
        # formatted on demand: minting a frame costs no string build
        if self.origin_trace_id is not None:
            return self.origin_trace_id
        return f"{self.pid:x}-{self.seq:x}"

    @property
    def span_id(self) -> str:
        """This frame span's own identity -- what downstream processes
        record as their parent.  (pid, seq) is unique per tracer and
        pids are synthetic-per-process, so ids survive a fleet merge."""
        return f"{self.pid:x}.{self.seq:x}"

    def adopt(self, context: dict | None) -> None:
        """Continue a propagated trace: keep the upstream trace id and
        parent this process's frame span under the upstream span."""
        if not context:
            return
        trace_id = context.get("trace_id")
        if trace_id:
            self.origin_trace_id = str(trace_id)
        parent = context.get("span_id")
        if parent:
            self.parent_span_id = str(parent)

    def span(self, name: str, category: str, start_us: float,
             args: dict | None = None) -> None:
        self.events.append(("X", name, category, start_us,
                            now_us() - start_us, args))

    def instant(self, name: str, category: str,
                args: dict | None = None) -> None:
        self.events.append(("i", name, category, now_us(), 0.0, args))

    def mark(self, key: str) -> None:
        if self.marks is None:
            self.marks = {}
        self.marks[key] = now_us()

    def take_mark(self, key: str) -> float | None:
        if not self.marks:
            return None
        return self.marks.pop(key, None)


# -- program spans ------------------------------------------------------------

_record_all = False   # record_program_spans(True): record with no profiler
_profiler = None      # torch.autograd.profiler, bound once torch is loaded


def record_program_spans(on: bool) -> None:
    """Record program spans with no torch.profiler running (an
    operator's switch; the profiler turns recording on by itself)."""
    global _record_all
    _record_all = bool(on)


def recording() -> bool:
    """Whether program spans record now: record_program_spans(True), or
    a torch.profiler recording anywhere in this process (its flag is
    module-global, so every thread sees it)."""
    global _profiler
    if _record_all:
        return True
    if _profiler is None:
        _profiler = sys.modules.get("torch.autograd.profiler")
        if _profiler is None:
            return False
    return _profiler._is_profiler_enabled


class ProgramSpan:
    """One finished program span or interval: perf_counter start and
    end, the thread that ran it (None for an interval, a wait no thread
    ran), the id of the span that enclosed it on that thread, its key
    (a request id or a group's lead frame trace id; a span given none
    inherits its parent's), and device milliseconds (CUDA events for a
    device span on the card, the host duration for one on the CPU, None
    for host spans) once Tracer.collect has resolved them."""

    __slots__ = ("span_id", "name", "start_s", "end_s", "thread", "parent",
                 "key", "device_ms", "events")

    def __init__(self, span_id: int, name: str, start_s: float,
                 thread: int | None, parent: int | None, key):
        self.span_id = span_id
        self.name = name
        self.start_s = start_s
        self.end_s = start_s
        self.thread = thread
        self.parent = parent
        self.key = key
        self.device_ms = None
        self.events = None        # (start event, end event, card)

    def as_dict(self) -> dict:
        return {"span_id": self.span_id, "name": self.name,
                "start_s": self.start_s, "end_s": self.end_s,
                "thread": self.thread, "parent": self.parent,
                "key": self.key, "device_ms": self.device_ms}


class _NoSpan:
    """The shared context a span returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


class _Span:
    """An open program span: enters torch.profiler.record_function, and
    for a device span records the pooled start event on the thread's
    current CUDA stream."""

    __slots__ = ("tracer", "name", "key", "device", "record", "profiled")

    def __init__(self, tracer: "Tracer", name: str, key, device: bool):
        self.tracer = tracer
        self.name = name
        self.key = key
        self.device = device

    def __enter__(self) -> ProgramSpan:
        import torch
        stack = self.tracer._stack()
        parent = stack[-1] if stack else None
        key = self.key
        if key is None and parent is not None:
            key = parent.key
        self.profiled = torch.profiler.record_function(self.name)
        self.profiled.__enter__()
        record = ProgramSpan(next(self.tracer._span_ids), self.name,
                             time.perf_counter(), threading.get_ident(),
                             None if parent is None else parent.span_id,
                             key)
        if self.device and torch.cuda.is_initialized():
            record.events = self.tracer._take_events()
            record.events[0].record()
        stack.append(record)
        self.record = record
        return record

    def __exit__(self, *exc) -> bool:
        record = self.record
        if record.events is not None:
            record.events[1].record()
        record.end_s = time.perf_counter()
        if self.device and record.events is None:
            record.device_ms = (record.end_s - record.start_s) * 1e3
        self.tracer._stack().pop()
        self.profiled.__exit__(*exc)
        self.tracer._keep(record)
        return False


class Tracer:
    """Mints trace ids, keeps a bounded ring of completed frame traces,
    and renders Chrome-trace documents.  Global (non-frame) events --
    fused-program compiles, scheduler decisions -- accumulate in their
    own bounded list and export on a dedicated lane, beside the program
    spans (span / interval) in a bounded ring of their own."""

    _pids = itertools.count()
    # program spans kept (a window of the benchmark keeps a few hundred)
    PROGRAM_RING = 16384

    def __init__(self, ring_size: int = 256, pid: int | None = None):
        self._ids = itertools.count(1)
        # synthetic per-tracer pid: several pipelines' traces merged
        # into ONE file stay distinct processes in the Perfetto UI
        self._pid = (pid if pid is not None
                     else os.getpid() * 100 + next(Tracer._pids) % 100)
        self.completed: deque = deque(maxlen=ring_size)
        self.global_events: deque = deque(maxlen=1024)
        self._stream_lanes: dict[str, int] = {}
        # frames evicted from the bounded ring: exports surface this so
        # a truncated artifact never silently reads as full coverage
        self.dropped = 0
        # program spans: finished ProgramSpans, the count evicted, the
        # open spans of each thread, and CUDA event pairs by card
        self.program: deque = deque(maxlen=self.PROGRAM_RING)
        self.program_dropped = 0
        self._span_ids = itertools.count(1)
        self._local = threading.local()
        self._events: dict = {}
        self._lock = threading.Lock()

    def begin(self, stream_id: str, frame_id: int) -> FrameTrace:
        return FrameTrace(self._pid, next(self._ids), stream_id,
                          frame_id)

    def finish(self, trace: FrameTrace, status: str = "ok") -> None:
        trace.end_us = now_us()
        trace.status = status
        if len(self.completed) == self.completed.maxlen:
            self.dropped += 1
        self.completed.append(trace)

    def instant_global(self, name: str, category: str,
                       args: dict | None = None) -> None:
        self.global_events.append(("i", name, category, now_us(), 0.0,
                                   args))

    def span_global(self, name: str, category: str, elapsed_s: float,
                    args: dict | None = None) -> None:
        """A finished duration event on the global/scheduler lane --
        work that belongs to no single frame (a decode-state
        checkpoint covering every active slot).  Rendered as an X
        span ending now, so the tune loader can median it like any
        frame-attributed span."""
        self.global_events.append(
            ("X", name, category, now_us() - elapsed_s * 1e6,
             elapsed_s * 1e6, args))

    def span(self, name: str, key=None, device: bool = False):
        """Context manager around one piece of the program's work (the
        taxonomy's `program` row).  While nothing records it returns a
        shared no-op context; while recording() it keeps a ProgramSpan
        parented to the thread's enclosing span, enters
        torch.profiler.record_function(name), and with `device` times
        the work on the thread's current CUDA stream with a pooled
        event pair."""
        if not recording():
            return _NO_SPAN
        return _Span(self, name, key, device)

    def interval(self, name: str, start_s: float, end_s: float,
                 key=None) -> None:
        """Keep a finished wait (perf_counter start and end) that is no
        host call, e.g. a request's arrival -> admission, while
        recording()."""
        if not recording():
            return
        record = ProgramSpan(next(self._span_ids), name, float(start_s),
                             None, None, key)
        record.end_s = float(end_s)
        self._keep(record)

    def collect(self, since: float | None = None) -> list:
        """The kept program spans that end at or after perf_counter
        `since` (all without it), as dicts (ProgramSpan.as_dict), their
        device milliseconds resolved with one synchronise per card."""
        records = [record for record in list(self.program)
                   if since is None or record.end_s >= since]
        self._resolve(records)
        return [record.as_dict() for record in records]

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _take_events(self) -> tuple:
        import torch
        card = torch.cuda.current_device()
        with self._lock:
            pool = self._events.setdefault(card, [])
            if pool:
                return pool.pop()
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True), card)

    def _keep(self, record: ProgramSpan) -> None:
        with self._lock:
            if len(self.program) == self.program.maxlen:
                self.program_dropped += 1
            self.program.append(record)

    def _resolve(self, records: list) -> None:
        """Fill device_ms from each device span's events, returning the
        events to the pool."""
        with self._lock:
            pending = [record for record in records
                       if record.events is not None]
            if not pending:
                return
            import torch
            for card in {record.events[2] for record in pending}:
                torch.cuda.synchronize(card)
            for record in pending:
                start, end, card = record.events
                record.device_ms = start.elapsed_time(end)
                record.events = None
                self._events.setdefault(card, []).append((start, end, card))

    def _lane(self, stream_id: str) -> int:
        lane = self._stream_lanes.get(stream_id)
        if lane is None:
            lane = self._stream_lanes[stream_id] = (
                len(self._stream_lanes) + 1)
        return lane

    def chrome_events(self, process_name: str = "pipeline") -> list:
        """All completed traces + global events as Chrome trace-event
        dicts.  One pid per tracer, one tid lane per stream (lane 0 is
        the global/scheduler lane), metadata events name both."""
        events = [
            {"ph": "M", "name": "process_name", "pid": self._pid,
             "tid": 0, "args": {"name": process_name}},
            {"ph": "M", "name": "thread_name", "pid": self._pid,
             "tid": 0, "args": {"name": "scheduler"}},
        ]
        if self.dropped:
            events.append(self._event(
                "i", f"trace ring dropped {self.dropped} frames",
                "truncation", now_us(), 0.0,
                {"dropped_frames": self.dropped,
                 "ring_size": self.completed.maxlen}, tid=0))
        for kind, name, category, ts, dur, args in self.global_events:
            events.append(self._event(kind, name, category, ts, dur,
                                      args, tid=0))
        if self.program_dropped:
            events.append(self._event(
                "i", f"program span ring dropped {self.program_dropped}",
                "truncation", now_us(), 0.0,
                {"dropped_spans": self.program_dropped,
                 "ring_size": self.program.maxlen}, tid=0))
        for record in self.collect():
            args = {"program_span": record["span_id"]}
            if record["thread"] is not None:
                args["thread"] = record["thread"]
            if record["parent"] is not None:
                args["program_parent"] = record["parent"]
            if record["key"] is not None:
                args["key"] = str(record["key"])
            if record["device_ms"] is not None:
                args["device_ms"] = record["device_ms"]
            events.append(self._event(
                "X", record["name"], "program", to_us(record["start_s"]),
                (record["end_s"] - record["start_s"]) * 1e6, args, tid=0))
        named_lanes = set()
        for trace in list(self.completed):
            lane = self._lane(trace.stream_id)
            if lane not in named_lanes:
                named_lanes.add(lane)
                events.append(
                    {"ph": "M", "name": "thread_name", "pid": self._pid,
                     "tid": lane,
                     "args": {"name": f"stream {trace.stream_id}"}})
            end_us = (trace.end_us if trace.end_us is not None
                      else now_us())
            frame_args = {"trace_id": trace.trace_id,
                          "span_id": trace.span_id,
                          "status": trace.status,
                          "stream": trace.stream_id}
            if trace.parent_span_id is not None:
                # propagated trace: this process's frame span nests
                # under the upstream (gateway) span in a merged artifact
                frame_args["parent"] = trace.parent_span_id
            events.append(self._event(
                "X", f"frame {trace.frame_id}", "frame", trace.start_us,
                end_us - trace.start_us, frame_args, tid=lane))
            for kind, name, category, ts, dur, args in trace.events:
                merged = {"trace_id": trace.trace_id,
                          "frame_id": trace.frame_id}
                if args:
                    merged.update(args)
                events.append(self._event(kind, name, category, ts, dur,
                                          merged, tid=lane))
        return events

    def _event(self, kind, name, category, ts, dur, args, tid) -> dict:
        event = {"ph": kind, "name": name, "cat": category,
                 "ts": round(ts, 3), "pid": self._pid, "tid": tid,
                 "args": args or {}}
        if kind == "X":
            event["dur"] = round(dur, 3)
        if kind == "i":
            event["s"] = "t"  # instant scope: thread
        return event

    def export(self, path: str, process_name: str = "pipeline",
               metadata: dict | None = None) -> int:
        """Write a Perfetto-loadable trace file; returns event count.
        `metadata` (see trace_metadata) makes the artifact
        self-describing for `aiko tune`."""
        document = chrome_trace_document(
            self.chrome_events(process_name=process_name),
            metadata=metadata)
        with open(path, "w") as handle:
            json.dump(document, handle)
        return len(document["traceEvents"])


def chrome_trace_document(events: list,
                          metadata: dict | None = None) -> dict:
    """Chrome-trace JSON document.  The optional `metadata` dict rides
    the spec's top-level "metadata" key under an "aiko" namespace --
    Perfetto/chrome://tracing ignore it, `aiko tune` requires it: a
    trace artifact that embeds its own pipeline definition + parameter
    fingerprint + bench config block is replayable with no side-channel
    files."""
    document = {"traceEvents": list(events), "displayTimeUnit": "ms"}
    if metadata is not None:
        document["metadata"] = {"aiko": metadata}
    return document


def definition_fingerprint(document: dict) -> str:
    """Stable content hash of a definition document (canonical JSON):
    the parameter fingerprint a trace is stamped with, so tune can
    tell whether a recommendation was computed against the SAME
    definition+parameters it is about to be applied to."""
    canonical = json.dumps(document, sort_keys=True, default=str)
    return "sha256:" + hashlib.sha256(
        canonical.encode("utf-8")).hexdigest()


def trace_metadata(definition_document: dict | None = None,
                   config: dict | None = None,
                   config_name: str | None = None,
                   metrics: dict | None = None,
                   clock_epoch: bool = False) -> dict:
    """Assemble the self-describing metadata block one trace artifact
    carries: the pipeline definition it was recorded under (with its
    fingerprint), the bench config block that produced it, and a
    metrics-registry snapshot taken at export.

    `clock_epoch=True` additionally stamps this process's
    clock_epoch_unix_us (what the fleet merger aligns timestamps
    with).  LIVE exporters (PipelineTelemetry / GatewayTelemetry) pass
    it; synthesized fixtures must not -- the stamp is wall-clock
    dependent and would break their byte-deterministic regeneration."""
    metadata: dict = {"schema": TRACE_METADATA_SCHEMA}
    if clock_epoch:
        metadata["clock_epoch_unix_us"] = round(
            clock_epoch_unix_us(), 3)
    if definition_document is not None:
        metadata["definition"] = definition_document
        metadata["fingerprint"] = definition_fingerprint(
            definition_document)
    if config is not None:
        metadata["config"] = config
    if config_name is not None:
        metadata["config_name"] = config_name
    if metrics is not None:
        metadata["metrics"] = metrics
    return metadata


def trace_metadata_of(document: dict) -> dict | None:
    """The aiko metadata block of a loaded trace document, or None for
    pre-metadata traces (any Chrome-trace JSON from another tool)."""
    if not isinstance(document, dict):
        return None
    metadata = document.get("metadata")
    if not isinstance(metadata, dict):
        return None
    aiko = metadata.get("aiko")
    return aiko if isinstance(aiko, dict) else None


# The process-wide tracer of the port's program spans (work that belongs
# to no single frame: a coalesced group's flush, the speech element's
# phases, the decode engine's steps); export it with
# PROGRAM.export(path, metadata=trace_metadata(clock_epoch=True)).
PROGRAM = Tracer(ring_size=1)
