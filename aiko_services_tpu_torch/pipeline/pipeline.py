# Pipeline engine: executes dataflow graphs of PipelineElements over
# streams of frames.
#
# Capability parity with the reference pipeline engine (reference:
# src/aiko_services/main/pipeline.py:522-1283): graph construction from the
# definition (local elements loaded by module/class, remote elements
# discovered by service filter), stream lifecycle with grace-time leases,
# per-frame execution in topological order with map_in/map_out name mapping,
# per-element wall-clock metrics, StreamEvent policy (ERROR destroys the
# stream, STOP destroys gracefully, DROP_FRAME skips the rest of the graph),
# remote element pause/resume (frame pauses at the remote node, resumes via
# Graph.iterate_after on process_frame_response, reference
# pipeline.py:1083-1160), the auto-created "*" default stream, response
# routing (local queue | response topic | /out), and live parameter updates.
#
# Device-first differences: swag values stay on device (torch.Tensor)
# in-process; cross-process hops use the tensor codec; stream context is
# explicit (no thread-locals); the event engine dispatches with microsecond
# latency.
#
# Counterpart of aiko_services_tpu/pipeline/pipeline.py.  Its jitted
# coalesce programs (concat+pad, split, the fused concat -> kernel ->
# split) are the same math run eagerly here: PyTorch has no jit to pay for
# and no per-program dispatch to amortise, so the fused and chained
# micro-batch paths differ only in whether the element's process_frame
# runs between the concat and the split.

from __future__ import annotations

import hashlib
import json
import logging
import time
import traceback
from collections import deque

import torch

from ..faults import create_injector, get_injector
from ..observe import PipelineTelemetry
from ..observe.trace import PROGRAM, pop_trace_context, recording
from ..runtime import Actor, Lease, ServiceFilter, ServicesCache
from ..runtime.service import SERVICE_PROTOCOL_PIPELINE
from ..utils import (
    generate, get_logger, load_module, parse_float, parse_int)
from ..utils.padding import bucket_length, pad_axis_to
from .definition import (
    PipelineDefinition, parse_pipeline_definition,
    validate_pipeline_definition)
from .element import AsyncHostElement, PipelineElement
from .stream import (
    DEFAULT_STREAM_ID, Frame, Stream, StreamEvent, StreamState)
from .tensors import decode_frame_data, encode_frame_data

__all__ = ["Pipeline", "RemoteElement", "create_pipeline"]

_LOGGER = get_logger("pipeline")
DEFAULT_GRACE_TIME = 60.0
# error-budget defaults: disabled unless `error_budget` is declared
# (stream or pipeline parameter); the window is seconds
DEFAULT_ERROR_WINDOW = 10.0
# a fused group program failing this many CONSECUTIVE times at RUN
# time pins the element to the chained path permanently (a flapping
# kernel must not pay fused-failure + chained-retry on every group; a
# healthy fused group in between resets the count)
FUSED_FLAP_LIMIT = 3
# dead-letter diagnostics are truncated: the topic carries evidence,
# not payloads
_DEAD_LETTER_DIAGNOSTIC_CAP = 500
# dead letters embed the ENCODED inputs when they fit under this cap
# (AIKO_DEAD_LETTER_DATA_MAX chars), so `aiko deadletter replay` can
# re-submit the exact frame after a recovered outage; oversized frames
# keep the descriptor-only shape (evidence, not payload)
_DEAD_LETTER_DATA_CAP = 4096


def _diagnostic_of(outputs) -> str:
    """An element's ERROR payload is not guaranteed to be a dict --
    _safe_call only validates the StreamEvent half of the tuple, so
    (StreamEvent.ERROR, "text") reaches the error handlers intact."""
    if isinstance(outputs, dict):
        return str(outputs.get("diagnostic") or outputs)
    return str(outputs)


def _canonical_value(value):
    """Hashable canonical encoding for parameter fingerprints: dict
    order never matters, arrays compare by CONTENT (shape + dtype +
    digest of the bytes, never a truncating repr), unknown types fall
    back to type-tagged repr.  Two values encode equal iff a coalesced
    element resolving either would behave identically."""
    if hasattr(value, "shape") and hasattr(value, "dtype"):
        from .transfer import host_bits
        array, dtype_name = host_bits(value)
        return ("nd", tuple(array.shape), dtype_name,
                hashlib.blake2b(array.tobytes(),
                                digest_size=16).digest())
    if isinstance(value, dict):
        return ("d", tuple(sorted(
            (str(key), _canonical_value(item))
            for key, item in value.items())))
    if isinstance(value, (list, tuple)):
        return ("l", tuple(_canonical_value(item) for item in value))
    if isinstance(value, (str, int, float, bool, bytes, type(None))):
        # type-tagged: Python cross-type equality (True == 1 == 1.0)
        # must not let type-distinct values fingerprint equal -- an
        # element branching on isinstance/dtype would silently take the
        # lead stream's path
        return ("s", type(value).__name__, value)
    return ("r", type(value).__name__, repr(value))

def _as_tensors(arrays) -> list:
    """Tensors for a group's per-frame arrays (numpy arrays become CPU
    tensors), all on the device of the first tensor that lies on one."""
    tensors = [value if isinstance(value, torch.Tensor)
               else torch.as_tensor(value) for value in arrays]
    device = next((tensor.device for tensor in tensors
                   if tensor.device.type != "cpu"), None)
    if device is not None:
        tensors = [tensor.to(device) for tensor in tensors]
    return tensors


def _concat_pad(named: dict, target: int) -> dict:
    """Concat each input's per-frame arrays on axis 0 and pad to
    `target` rows.  The ONE definition of the coalesce math: the chained
    path and the fused group path both run THIS function, so the
    fused==chained equivalence can never drift."""
    out = {}
    for name, arrays in named.items():
        tensors = _as_tensors(arrays)
        value = (tensors[0] if len(tensors) == 1
                 else torch.cat(tensors, dim=0))
        out[name] = pad_axis_to(value, 0, target)
    return out


def _split_leaves(leaves: tuple, counts: tuple) -> tuple:
    """All per-frame row slices of all device leaves: returns frames x
    leaves nested tuples (views, no copies)."""
    frames = []
    offset = 0
    for count in counts:
        frames.append(tuple(leaf[offset:offset + count] for leaf in leaves))
        offset += count
    return tuple(frames)


class RemoteElement:
    """Proxy node for an element hosted by another pipeline service
    (reference PipelineRemote, pipeline.py:1285-1319)."""

    def __init__(self, pipeline, definition):
        self.pipeline = pipeline
        self.definition = definition
        self.name = definition.name
        self.ready = False
        self.topic_path = None
        self._pending: list[str] = []

    def set_remote(self, topic_path: str) -> None:
        self.topic_path = topic_path
        self.ready = True
        pending, self._pending = self._pending, []
        for payload in pending:
            self.pipeline.process.publish(f"{topic_path}/in", payload)
        self.pipeline._update_lifecycle()

    def set_absent(self) -> None:
        self.ready = False
        self.topic_path = None
        self.pipeline._update_lifecycle()

    def call(self, command: str, parameters) -> None:
        payload = generate(command, parameters)
        if self.ready:
            self.pipeline.process.publish(f"{self.topic_path}/in", payload)
        else:
            self._pending.append(payload)


class Pipeline(Actor):
    def __init__(self, process, definition: PipelineDefinition,
                 name: str = None):
        super().__init__(process, name or definition.name,
                         protocol=SERVICE_PROTOCOL_PIPELINE)
        self.definition = definition
        self.graph = validate_pipeline_definition(definition)
        self.streams: dict[str, Stream] = {}
        self._stream_leases: dict[str, Lease] = {}
        self._frame_count = 0
        self.elements: dict[str, object] = {}
        self._services_cache: ServicesCache | None = None
        self._remote_handlers: list = []
        # micro-batching: frames parked PER ELEMENT awaiting a coalesced
        # flush -- across streams, so the many-stream serving scenario
        # batches (SURVEY.md section 7 hard-part #2: batching scheduler
        # that still honors StreamEvent semantics).  Entries are
        # (stream, frame, inputs, signature)
        self._micro_pending: dict[str, list] = {}
        # zero-filler buffers reused across coalesced groups (immutable
        # device arrays; a fresh zeros_like per group is a dispatch)
        self._micro_fillers: dict[tuple, object] = {}
        # fused whole-group programs: node -> {kernel id: (kernel,
        # concat+pad+kernel+split)}.  A DICT per node, not one slot:
        # elements cache one kernel per static parameter value
        # (max_tokens), and alternating cohorts must not evict each
        # other's programs
        self._fused_programs: dict[str, dict] = {}
        self._fused_rejected: set = set()
        # program span names per node ("flush:", "gather:", "element:",
        # "split:" + node), built once so a span costs no string while
        # nothing records (observe/trace.py, the taxonomy's program row)
        self._span_names: dict[str, tuple] = {}
        # fused-path circuit breaker: RUN-time program failures per node;
        # FUSED_FLAP_LIMIT failures pin the node to the chained path
        self._fused_failures: dict[str, int] = {}
        self._fused_disabled: set = set()
        # deterministic fault injection (aiko_services_tpu.faults): the
        # pipeline parameter `faults` takes precedence, else the
        # process-wide AIKO_FAULTS plan; None (the production state)
        # keeps every hook at one is-None check
        fault_spec = (definition.parameters or {}).get("faults")
        self.faults = (create_injector(fault_spec) if fault_spec
                       else get_injector())
        # elements whose parked frames split into parameter-fingerprint
        # cohorts, logged once each (operators see WHY cross-stream
        # coalescing produced small groups)
        self._micro_cohort_logged: set = set()
        # open hold-down windows: node -> timer fn (see
        # _schedule_micro_flush); generations invalidate STALE posted
        # flush messages from superseded windows
        self._micro_timers: dict[str, object] = {}
        self._micro_flush_gen: dict[str, int] = {}
        self.share.update({
            "definition_name": definition.name,
            "element_count": len(definition.elements),
            "stream_count": 0,
            "frame_count": 0,
        })
        # disaggregated serving: a `disagg: "role=prefill"` definition
        # parameter pins this replica's pool; the `role` share key is
        # how a discovering gateway learns pool membership (local
        # attaches read it directly).  Parse errors are left to the
        # construction lint (AIKO408) below
        disagg_spec = (definition.parameters or {}).get("disagg")
        if disagg_spec:
            from ..serve.disagg import DisaggPolicy
            try:
                disagg_role = DisaggPolicy.parse(disagg_spec).role
            except ValueError:
                disagg_role = None
            if disagg_role:
                self.share["role"] = disagg_role
        # telemetry: metrics registry + frame tracer + periodic export
        # (pipeline parameter "telemetry: false" disables ALL per-frame
        # instrument writes -- the latency operating point)
        self.telemetry = PipelineTelemetry(self)
        # definition-time static analysis (analyze/): the cheap passes
        # (graph/port dataflow, tensor-spec flow, policy grammars) run
        # at construction so a shape clash or typo'd grammar fails HERE
        # with a rule code, not mid-stream as a dead-letter.  Opt out
        # with pipeline parameter `validate: false`; error findings
        # raise, warnings are logged and exported through the metrics
        # registry (`lint.findings` + per-rule counters)
        from ..utils import truthy
        if truthy((definition.parameters or {}).get("validate", True)):
            self._run_construction_lint(definition)
        self._produced_keys = self._compute_produced_keys()
        self._create_elements()
        self._update_lifecycle()

    # -- construction ------------------------------------------------------

    def _run_construction_lint(self, definition) -> None:
        """The analyzer's cheap passes at construction: error findings
        raise DefinitionError (the definition is wrong); warnings are
        admitted but logged and counted through the metrics registry so
        fleets can see how many definitions carry findings."""
        from ..analyze import CHEAP_PASSES, analyze_definition
        # re-runs the graph pass validate_pipeline_definition already
        # ran: deliberate -- the passes are pure and run in
        # microseconds, and sharing the report would couple the
        # engine's unconditional structural validation to the
        # opt-out-able lint surface
        report = analyze_definition(definition, passes=CHEAP_PASSES)
        errors = report.errors()
        if errors:
            from .definition import DefinitionError
            raise DefinitionError(
                f"{definition.name}: definition rejected by static "
                "analysis (`validate: false` opts out):\n"
                + "\n".join(d.render() for d in errors))
        self.telemetry.record_lint(report)
        for diagnostic in report.findings:
            _LOGGER.warning("%s: lint: %s", self.name,
                            diagnostic.render())

    def _compute_produced_keys(self) -> set:
        produced = set()
        for element_definition in self.definition.elements:
            for output_name in element_definition.output_names():
                produced.add(element_definition.map_out.get(
                    output_name, output_name))
        return produced

    def _create_elements(self) -> None:
        for element_definition in self.definition.elements:
            if element_definition.is_local:
                module = load_module(element_definition.deploy_local["module"])
                element_class = getattr(
                    module, element_definition.deploy_local["class_name"])
                if not issubclass(element_class, PipelineElement):
                    raise TypeError(
                        f"{element_definition.name}: "
                        f"{element_class.__name__} is not a PipelineElement")
                element = element_class(
                    self.process, self, element_definition)
                if isinstance(element, AsyncHostElement) and (
                        type(element).group_kernel
                        is not PipelineElement.group_kernel):
                    raise TypeError(
                        f"{element_definition.name}: AsyncHostElement "
                        f"cannot expose a group kernel -- its work runs "
                        f"on a host worker thread (device readbacks, "
                        f"blocking I/O) and cannot trace into a fused "
                        f"device program; drop group_kernel or use a "
                        f"ComputeElement")
                self.elements[element_definition.name] = element
            else:
                remote = RemoteElement(self, element_definition)
                self.elements[element_definition.name] = remote
                self._watch_remote(remote)

    def _watch_remote(self, remote: RemoteElement) -> None:
        if self._services_cache is None:
            from ..runtime.share import services_cache_create_singleton
            self._services_cache = services_cache_create_singleton(
                self.process)
        service_filter = ServiceFilter(
            **remote.definition.deploy_remote["service_filter"])

        def handler(command, fields):
            if command == "add" and not remote.ready:
                remote.set_remote(fields.topic_path)
            elif command == "remove" and fields.topic_path == (
                    remote.topic_path):
                remote.set_absent()

        self._services_cache.add_handler(handler, service_filter)
        self._remote_handlers.append(handler)

    def _update_lifecycle(self) -> None:
        ready = all(
            not isinstance(element, RemoteElement) or element.ready
            for element in self.elements.values())
        lifecycle = "ready" if ready else "waiting_remote"
        if self.ec_producer is not None:
            self.ec_producer.update("lifecycle", lifecycle)
        else:
            self.share["lifecycle"] = lifecycle

    @property
    def ready(self) -> bool:
        return self.share.get("lifecycle") == "ready"

    # -- stream lifecycle --------------------------------------------------

    def create_stream(self, stream_id, parameters=None,
                      grace_time=DEFAULT_GRACE_TIME, topic_response=None,
                      queue_response=None, graph_path=None,
                      first_frame_id: int = 0) -> Stream | None:
        stream_id = str(stream_id)
        if stream_id in self.streams:
            existing = self.streams[stream_id]
            if isinstance(parameters, str):
                try:
                    parameters = (json.loads(parameters)
                                  if parameters else {})
                except ValueError:
                    parameters = None
            if parameters and dict(parameters) != existing.parameters:
                # the caller gets the EXISTING stream, configured under
                # the FIRST parameter set -- silent reuse here has
                # masked id-allocation bugs (two clients minting the
                # same id with different configs); name both sets so
                # the losing caller's missing knobs are attributable
                _LOGGER.warning(
                    "%s: create_stream(%s) collided with a live stream;"
                    " keeping existing parameters %r, ignoring %r",
                    self.name, stream_id, existing.parameters,
                    dict(parameters))
                self.telemetry.record_stream_collision(stream_id)
            return existing
        try:
            if isinstance(parameters, str):  # wire call: JSON-encoded
                parameters = json.loads(parameters) if parameters else {}
            if isinstance(grace_time, str):
                grace_time = float(grace_time)
        except ValueError as error:
            _LOGGER.warning("%s: bad create_stream arguments: %s",
                            self.name, error)
            return None
        # wire placeholders: the sexpr codec renders None as an empty
        # list, so positional wire calls (e.g. the serving gateway's
        # create_stream with first_frame_id) deliver [] for the slots
        # they skip -- a falsy responder/path means "not provided"
        if not queue_response:
            queue_response = None
        if not graph_path:
            graph_path = None
        if graph_path and str(graph_path) not in self.graph:
            # validate BEFORE registering: a bad head must not leave a
            # half-created stream holding a lease
            _LOGGER.warning("%s: unknown graph_path %r for stream %s",
                            self.name, graph_path, stream_id)
            return None
        stream = Stream(
            stream_id=stream_id, parameters=parameters or {},
            topic_response=topic_response or None,
            queue_response=queue_response, graph_path=graph_path)
        # cursor must be set BEFORE start_stream: DataSources may begin
        # generating frames the moment they start (checkpoint resume)
        stream.frame_id = int(first_frame_id)
        self.streams[stream_id] = stream
        self._stream_leases[stream_id] = Lease(
            self.process.event, grace_time, stream_id,
            lease_expired_handler=self._stream_lease_expired,
            jitter=self._lease_jitter(stream_id))
        # Remote streams FIRST: a local DataSource may start generating
        # frames the moment start_stream returns, and those frames must not
        # reach a remote pipeline before its create_stream does.
        for node_name in self.graph.get_path(stream.graph_path):
            element = self.elements[node_name]
            if isinstance(element, RemoteElement):
                element.call("create_stream", [
                    stream_id,
                    json.dumps(stream.parameters).encode("ascii"),
                    grace_time,
                    self.topic_in,
                ])
        # Local elements in REVERSE graph order, for the same reason: a
        # source's frames must not reach an element whose start_stream
        # has not run yet (a DataTarget's target path).  The JAX package
        # starts them in graph order, and under load its sink can see a
        # frame first.
        for node_name in reversed(self.graph.get_path(stream.graph_path)):
            element = self.elements[node_name]
            if not isinstance(element, RemoteElement):
                stream_event, diagnostic = self._safe_call(
                    node_name, element.start_stream, stream, stream_id)
                if stream_event == StreamEvent.ERROR:
                    _LOGGER.error("%s: start_stream failed at %s: %s",
                                  self.name, node_name, diagnostic)
                    self.destroy_stream(stream_id, state=StreamState.ERROR)
                    return None
        self._update_stream_share()
        return stream

    def destroy_stream(self, stream_id,
                       state: StreamState = StreamState.STOP,
                       graceful=False) -> None:
        stream_id = str(stream_id)
        if isinstance(state, str):  # wire call
            state = StreamState(state)
        if isinstance(graceful, str):
            graceful = graceful.lower() == "true"
        stream = self.streams.get(stream_id)
        if stream is None:
            return
        if graceful and stream.pending > 0:
            # defer until in-flight frames finish (reference graceful STOP,
            # pipeline.py:1229-1263)
            stream.stop_requested = True
            return
        if stream.destroying:
            return
        stream.destroying = True
        stream.state = state
        # parked frames die with the stream (other streams' entries stay)
        for node_name, entries in list(self._micro_pending.items()):
            kept = [entry for entry in entries
                    if entry[0].stream_id != stream_id]
            if kept:
                self._micro_pending[node_name] = kept
            else:
                self._micro_pending.pop(node_name, None)
        lease = self._stream_leases.pop(stream_id, None)
        if lease is not None:
            lease.terminate()
        for node_name in self.graph.get_path(stream.graph_path):
            element = self.elements[node_name]
            if isinstance(element, RemoteElement):
                element.call("destroy_stream", [stream_id])
            else:
                element.stop_frame_generation(stream_id)
                self._safe_call(node_name, element.stop_stream, stream,
                                stream_id)
        # pop LAST: "stream gone from pipeline.streams" must imply the
        # stop_stream hooks (writer close/flush) have already run --
        # callers synchronize on stream removal
        self.streams.pop(stream_id, None)
        self._update_stream_share()

    def _lease_jitter(self, stream_id: str) -> float:
        """Deterministic per-stream timer jitter decorrelating
        stream-lease expiry checks (thousands of streams created in one
        burst must not tick in lockstep).  Seeded by the fault harness
        (its seed, else 0) so fault-scenario runs reproduce the exact
        timer schedule."""
        from ..runtime.lease import jitter_fraction
        seed = self.faults.seed if self.faults is not None else 0
        return jitter_fraction(seed, stream_id)

    def _stream_lease_expired(self, stream_id) -> None:
        _LOGGER.info("%s: stream %s lease expired", self.name, stream_id)
        self._stream_leases.pop(str(stream_id), None)
        self.destroy_stream(stream_id)

    # -- frame execution ---------------------------------------------------

    def create_frame(self, stream: Stream, frame_data: dict) -> None:
        """Inject a frame locally (element thread or event loop): posts onto
        the pipeline mailbox to preserve actor ordering."""
        stream.pending += 1
        self.post_message(
            "process_frame",
            [{"stream_id": stream.stream_id, "_local": True}, frame_data])

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
        frame_data = frame_data or {}
        stream_id = str(stream_dict.get("stream_id", DEFAULT_STREAM_ID))
        stream = self.streams.get(stream_id)
        if stream is None:
            if stream_id == DEFAULT_STREAM_ID:
                # auto-create the default stream (reference
                # pipeline.py:1131-1137)
                stream = self.create_stream(stream_id)
            if stream is None:
                _LOGGER.debug("%s: frame for unknown stream %s dropped",
                              self.name, stream_id)
                return
        lease = self._stream_leases.get(stream_id)
        if lease is not None:
            lease.extend()
        frame_id = stream_dict.get("frame_id")
        if frame_id is None:
            frame_id = stream.frame_id
        frame_id = int(frame_id)
        if frame_id >= stream.frame_id:
            stream.frame_id = frame_id + 1
        topic_response = stream_dict.get("topic_response")
        if topic_response:  # remote caller overrides response routing
            stream.topic_response = topic_response
        if not stream_dict.get("_local"):
            stream.pending += 1
        # a propagated trace context (serving gateway = root-span
        # owner) rides the frame data under a reserved key: pop it at
        # ingress so it NEVER reaches element inputs, then continue the
        # upstream trace instead of minting a fresh id
        trace_context = pop_trace_context(frame_data)
        frame = Frame(frame_id=frame_id, swag=dict(frame_data))
        stream.frames[frame_id] = frame
        # stream ingress: mint the frame's trace id (spans accumulate on
        # the frame as it moves through the graph)
        self.telemetry.frame_begin(stream, frame, context=trace_context)
        # frame deadline: bounds the WHOLE graph walk including parked
        # remote/async branches -- a dead RemoteElement or lost reply
        # releases the frame (dead-lettered) instead of leaking it until
        # the stream lease expires
        deadline = self._frame_deadline(stream)
        if deadline > 0:
            self._arm_frame_deadline(stream, frame, deadline)
        self._run_frame(stream, frame, resume_after=None)

    def process_frame_response(self, stream_dict, frame_data=None) -> None:
        """A remote element (hosted sub-pipeline) replied: resume the paused
        frame after the remote node (reference pipeline.py:1156-1160)."""
        try:
            if isinstance(stream_dict, str):
                stream_dict = json.loads(stream_dict)
        except ValueError as error:
            _LOGGER.warning("%s: undecodable frame response dropped: %s",
                            self.name, error)
            return
        stream_id = str(stream_dict.get("stream_id", DEFAULT_STREAM_ID))
        stream = self.streams.get(stream_id)
        if stream is None:
            _LOGGER.debug("%s: response for unknown stream %s",
                          self.name, stream_id)
            return
        frame_id = int(stream_dict.get("frame_id", 0))
        frame = stream.frames.get(frame_id)
        if frame is None or (frame.paused_pe_name is None
                             and not frame.pending_nodes):
            _LOGGER.debug("%s: response for unknown frame %s/%s",
                          self.name, stream_id, frame_id)
            return
        # concurrent branches: responses name their node.  An UN-NAMED
        # response can only originate from a remote hop (the reply
        # protocol carries no node) or a CUSTOM PENDING element --
        # AsyncHostElement replies always name their node, and
        # micro-batch parks resume via the flush path, so neither is a
        # candidate for un-named attribution
        resumed_node = stream_dict.get("node")
        if not resumed_node:
            holder = frame.paused_pe_name
            holder_is_remote = isinstance(
                self.elements.get(holder), RemoteElement)
            nameless_capable = [
                node for node in frame.pending_nodes
                if not isinstance(self.elements.get(node),
                                  (AsyncHostElement, RemoteElement))
                and not any(entry[1] is frame
                            for entry in self._micro_pending.get(
                                node, ()))]
            if holder is not None and holder_is_remote:
                resumed_node = holder   # remote replies are un-named
            elif (len(nameless_capable) == 1
                    and not frame.had_remote_park):
                # exactly one park can have sent this, and no remote hop
                # ever touched the frame (so it cannot be a delayed
                # duplicate of a remote reply): unambiguous
                resumed_node = nameless_capable[0]
            elif not nameless_capable:
                # no park can have sent an un-named reply: stale or
                # duplicate -- falls through to the drop below (in-flight
                # async branches keep the frame alive and healthy)
                resumed_node = None
            else:
                # several nameless parks (or a possible remote-reply
                # duplicate): attribution would be a guess.  Don't kill
                # the frame outright -- arm a watchdog over the doubtful
                # parks instead, so a misbehaving custom PENDING element
                # degrades to a delayed dropped frame rather than
                # permanently holding a backpressure slot, while healthy
                # named branches in flight stay untouched
                _LOGGER.warning(
                    "%s: un-named frame response unroutable over parks "
                    "%s on frame %s/%s (custom elements returning "
                    "PENDING alongside siblings or remote hops must "
                    "name their node in process_frame_response); park "
                    "watchdog armed", self.name,
                    sorted(nameless_capable), stream_id, frame_id)
                self._arm_park_watchdog(stream, frame, nameless_capable)
                return
        if resumed_node is None or (
                resumed_node not in frame.pending_nodes
                and resumed_node != frame.paused_pe_name):
            _LOGGER.debug("%s: response for non-pending node %r on "
                          "frame %s/%s", self.name, resumed_node,
                          stream_id, frame_id)
            return
        if (self.faults is not None
                and self.faults.reply_blackhole(resumed_node)):
            # injected lost reply: the frame stays parked, exactly as a
            # dead remote hop leaves it -- frame_deadline is the
            # recovery path under test
            _LOGGER.warning(
                "%s: injected blackhole swallowed %s response on frame "
                "%s/%s", self.name, resumed_node, stream_id, frame_id)
            return
        if isinstance(frame_data, str):
            try:
                frame_data = decode_frame_data(frame_data)
            except (ValueError, KeyError) as error:
                # payload unrecoverable (e.g. transfer-plane producer
                # died): release the parked frame as an error instead of
                # leaking it until the stream lease expires
                _LOGGER.warning(
                    "%s: frame response payload lost (%s); releasing "
                    "frame %s/%s", self.name, error, stream_id, frame_id)
                self._finish_frame(stream, frame, dropped=True, error=True)
                return
        remote_event = stream_dict.get("event")
        if remote_event:  # remote dropped/errored the frame: release it
            self._finish_frame(stream, frame, dropped=True,
                               error=(remote_event == "error"))
            return
        outputs = frame_data or {}
        element = self.elements.get(resumed_node)
        if element is not None and not isinstance(element, RemoteElement):
            # async LOCAL element: its map_out has not been applied yet
            # (remote hops apply map_out on the serving side)
            outputs = self._map_out(outputs, element.definition)
        elapsed = stream_dict.get("time")
        self.telemetry.mark_resume(
            frame, resumed_node,
            float(elapsed) if elapsed is not None else None,
            path=("remote" if isinstance(element, RemoteElement)
                  else "async"))
        frame.swag.update(outputs)
        frame.pending_nodes.discard(resumed_node)
        if frame.paused_pe_name == resumed_node:
            frame.paused_pe_name = None
        if frame.had_remote_park and not any(
                isinstance(self.elements.get(node), RemoteElement)
                for node in frame.pending_nodes):
            # last remote park resumed: un-named replies can again be
            # attributed to a sole local custom park.  (Residual risk: a
            # transport-redelivered duplicate of the remote's reply
            # arriving after this point could be misrouted -- accepted,
            # since blocking it forever would break every legitimate
            # custom PENDING element downstream of a remote hop)
            frame.had_remote_park = False
        self._run_frame(stream, frame, resume_after=resumed_node)

    def _run_frame(self, stream: Stream, frame: Frame,
                   resume_after: str | None) -> None:
        """One execution pass over the frame's graph path.

        Dependency-aware branch concurrency (beyond the reference's
        strictly sequential loop, pipeline.py:1037-1092): a node whose
        work leaves the event loop (async host element, micro-batch
        park) only defers its own DESCENDANTS -- siblings with satisfied
        inputs keep dispatching, so a slow host readback never idles the
        device behind it.  Each resume event re-enters this pass;
        frame.executed / frame.pending_nodes make passes idempotent.
        Remote hops still park the whole frame (their reply cannot name
        a node)."""
        if resume_after is not None:
            frame.executed.add(resume_after)
        time_start = time.perf_counter()
        for node_name in self.graph.get_path(stream.graph_path):
            if stream.state != StreamState.RUN:
                # the stream was destroyed while this frame was in
                # flight: its partial swag is no answer, so the frame
                # is dropped and its caller told (a gateway that
                # drained or failed this replica over knows its replay
                # answers instead).  The JAX package answers here with
                # the partial swag
                self._finish_frame(stream, frame, dropped=True)
                return
            if (node_name in frame.executed
                    or node_name in frame.pending_nodes):
                continue
            if frame.pending_nodes and any(
                    node_name in self.graph.descendants(pending)
                    for pending in frame.pending_nodes):
                # downstream of an in-flight branch: defer by graph
                # reachability, NOT input availability -- an in-flight
                # element may REWRITE a key this node consumes (e.g.
                # text -> text), so a swag hit here could be the stale
                # pre-branch value
                continue
            stream.current_frame_id = frame.frame_id
            element = self.elements[node_name]
            definition = element.definition
            try:
                inputs = self._map_in(frame.swag, definition)
            except KeyError as error:
                if frame.pending_nodes:
                    # input produced off-path by an in-flight branch
                    # (cross-path key): this node retries on that
                    # branch's resume pass
                    continue
                _LOGGER.error("%s: %s missing input %s",
                              self.name, node_name, error)
                self._finish_frame(stream, frame, error=True)
                return
            if isinstance(element, RemoteElement):
                frame.paused_pe_name = node_name
                frame.pending_nodes.add(node_name)
                frame.had_remote_park = True
                self.telemetry.mark_park(frame, node_name, kind="remote")
                element.call("process_frame", [
                    {"stream_id": stream.stream_id,
                     "frame_id": frame.frame_id,
                     "topic_response": self.topic_in},
                    encode_frame_data(inputs).encode("ascii"),
                ])
                return  # frame stays parked in stream.frames
            park_start = time.perf_counter()
            if self._try_park_micro(stream, frame, node_name, element,
                                    inputs):
                if stream.frames.get(frame.frame_id) is not frame:
                    return  # an inline flush already finished the frame
                # an inline flush ran OTHER frames' passes inside the
                # park call: exclude that window from THIS frame's
                # time_pipeline (each resumed frame charged its own)
                time_start += time.perf_counter() - park_start
                continue  # parked branch; siblings keep dispatching
            element_start = time.perf_counter()
            stream_event, outputs = self._dispatch_element(
                stream, frame, node_name, element, inputs)
            self.telemetry.record_element(
                frame, node_name, element_start,
                time.perf_counter() - element_start, path="inline")
            if stream_event == StreamEvent.OKAY:
                frame.executed.add(node_name)
                frame.swag.update(self._map_out(outputs or {}, definition))
            elif stream_event == StreamEvent.PENDING:
                # element continues off the event loop (AsyncHostElement
                # worker thread); the branch parks and resumes through
                # process_frame_response while siblings continue below.
                # The single fallback-identity slot belongs to remote
                # hops (their replies cannot name a node) -- only claim
                # it when free; AsyncHostElement responses always name
                # their node, and custom PENDING elements must too when
                # combined with remote hops
                if frame.paused_pe_name is None:
                    frame.paused_pe_name = node_name
                frame.pending_nodes.add(node_name)
                self.telemetry.mark_park(frame, node_name, kind="async")
            elif stream_event == StreamEvent.DROP_FRAME:
                self._finish_frame(stream, frame, dropped=True)
                return
            elif stream_event == StreamEvent.STOP:
                _LOGGER.info("%s: %s requested stream stop: %s",
                             self.name, node_name, outputs)
                self._finish_frame(stream, frame)
                self.destroy_stream(stream.stream_id, graceful=True)
                return
            else:  # ERROR or unknown: the element's error policy decides
                if self._handle_element_error(stream, frame, node_name,
                                              element, outputs):
                    continue  # parked for retry; siblings keep dispatching
                return  # frame released (dropped or stream destroyed)
        self.telemetry.record_pipeline_pass(frame, time_start)
        if frame.pending_nodes:
            return  # parked branches resume this pass later
        self._finish_frame(stream, frame)

    # -- fault tolerance ---------------------------------------------------
    # Per-element error policy (`on_error: stop_stream | drop_frame |
    # retry` with max_retries + exponential retry_backoff_ms), a
    # per-stream error budget (`error_budget` errors inside
    # `error_window` seconds quarantines the stream), a per-frame
    # `frame_deadline` covering parked remote/async branches, and
    # dead-lettering of every error-released frame on
    # `{topic_path}/dead_letter` (inputs descriptor + diagnostic +
    # trace id; the Recorder subscribes).  At ROADMAP scale transient
    # faults are the steady state: a single element exception must
    # degrade to one retried/dropped frame, never a destroyed stream,
    # unless the operator kept the stop_stream default.

    def _dispatch_element(self, stream: Stream, frame: Frame,
                          node_name: str, element, inputs: dict) -> tuple:
        """One element call for one frame, with the deterministic fault
        hooks in front (no fault plan -> one is-None check)."""
        faults = self.faults
        if faults is not None:
            delay = faults.dispatch_delay(node_name, frame.frame_id,
                                          stream.stream_id)
            if delay > 0:
                time.sleep(delay)
            if faults.element_raise(node_name, frame.frame_id,
                                    stream.stream_id):
                return StreamEvent.ERROR, {
                    "node": node_name,
                    "diagnostic": f"{node_name}: injected fault "
                                  f"(element_raise frame "
                                  f"{frame.frame_id})"}
        with PROGRAM.span(self._names(node_name)[2]):
            return self._safe_call(node_name, element.process_frame,
                                   stream, **inputs)

    def _handle_element_error(self, stream: Stream, frame: Frame,
                              node_name: str, element, outputs) -> bool:
        """Apply the element's error policy to one failed frame.
        Returns True when the frame is still alive (parked for retry) --
        the caller's graph pass may keep dispatching siblings -- and
        False when the frame was released (dropped or stream
        destroyed)."""
        diagnostic = _diagnostic_of(outputs)
        policy = element.resolve_error_policy(stream)
        if policy.on_error == "retry":
            retries = frame.retries
            if retries is None:
                retries = frame.retries = {}
            attempt = retries.get(node_name, 0) + 1
            if attempt <= policy.max_retries:
                retries[node_name] = attempt
                delay = policy.retry_delay(attempt)
                _LOGGER.warning(
                    "%s: %s failed on frame %s/%s (attempt %d/%d), "
                    "retrying in %.0f ms: %s", self.name, node_name,
                    stream.stream_id, frame.frame_id, attempt,
                    policy.max_retries, delay * 1000, diagnostic)
                self.telemetry.record_retry(frame, node_name, attempt,
                                            delay)
                # park while the backoff runs: descendants defer, the
                # frame cannot finish, and the retry message re-enters
                # the graph pass with the node eligible again
                frame.pending_nodes.add(node_name)
                if delay > 0:
                    self.post_message_later(
                        "_retry_element",
                        [stream.stream_id, frame.frame_id, node_name],
                        delay)
                else:
                    self.post_message(
                        "_retry_element",
                        [stream.stream_id, frame.frame_id, node_name])
                return True
        budget_tripped = self._note_stream_error(stream)
        if policy.on_error in ("retry", "drop_frame"):
            reason = ("retries_exhausted" if policy.on_error == "retry"
                      else "drop_frame")
            _LOGGER.error("%s: %s stream %s frame %s error (%s): %s",
                          self.name, node_name, stream.stream_id,
                          frame.frame_id, reason, diagnostic)
            self._dead_letter(stream, frame, node_name, reason,
                              diagnostic)
            self._finish_frame(stream, frame, dropped=True, error=True)
            if budget_tripped:
                self._quarantine_stream(stream)
            return False
        # stop_stream: the original engine contract -- the stream dies,
        # the pipeline survives
        _LOGGER.error("%s: %s stream %s error: %s", self.name,
                      node_name, stream.stream_id, diagnostic)
        self._dead_letter(stream, frame, node_name, "stop_stream",
                          diagnostic)
        self._finish_frame(stream, frame, error=True)
        self.destroy_stream(stream.stream_id, state=StreamState.ERROR)
        return False

    def _retry_element(self, stream_id, frame_id, node_name) -> None:
        """Mailbox/timer continuation of a scheduled retry: un-park the
        node and re-enter the frame's graph pass (the node re-dispatches
        inline or re-parks for micro-batching, exactly like a first
        attempt)."""
        stream = self.streams.get(str(stream_id))
        if stream is None:
            return  # stream destroyed while the backoff ran
        frame = stream.frames.get(int(frame_id))
        if frame is None:
            return  # frame released meanwhile (deadline/watchdog)
        node_name = str(node_name)
        frame.pending_nodes.discard(node_name)
        self._run_frame(stream, frame, resume_after=None)

    def _stream_parameter(self, stream: Stream, name: str, default):
        """Stream-level parameter with pipeline-definition fallback (for
        knobs that are per-stream, not per-element)."""
        if stream.parameters and name in stream.parameters:
            return stream.parameters[name]
        return (self.definition.parameters or {}).get(name, default)

    def _note_stream_error(self, stream: Stream) -> bool:
        """Record one error against the stream's sliding error budget;
        True when the budget tripped (caller quarantines).  Budget off
        (the default) costs one parameter lookup on the ERROR path
        only."""
        budget = parse_int(
            self._stream_parameter(stream, "error_budget", 0), 0)
        if budget <= 0:
            return False
        window = parse_float(
            self._stream_parameter(stream, "error_window",
                                   DEFAULT_ERROR_WINDOW),
            DEFAULT_ERROR_WINDOW) or DEFAULT_ERROR_WINDOW
        times = stream.error_times
        if times is None:
            times = stream.error_times = deque()
        now = time.monotonic()
        times.append(now)
        while times and times[0] < now - window:
            times.popleft()
        return len(times) >= budget

    def _quarantine_stream(self, stream: Stream) -> None:
        _LOGGER.error(
            "%s: stream %s blew its error budget; quarantining",
            self.name, stream.stream_id)
        self.telemetry.record_breaker_trip(stream.stream_id)
        self.destroy_stream(stream.stream_id, state=StreamState.ERROR)

    def _frame_deadline(self, stream: Stream) -> float:
        """The stream's `frame_deadline` seconds (0 = disabled),
        memoized: stream parameters are fixed at create_stream."""
        cached = getattr(stream, "_frame_deadline_s", None)
        if cached is None:
            cached = parse_float(self._stream_parameter(
                stream, "frame_deadline", 0.0), 0.0)
            stream._frame_deadline_s = cached
        return cached

    def _arm_frame_deadline(self, stream: Stream, frame: Frame,
                            deadline_s: float) -> None:
        """Bound the frame's END-TO-END residence time.  Generalizes the
        doubtful-park watchdog: that one only covers parks whose
        attribution came into doubt, while this covers every way a frame
        can stall -- a dead RemoteElement, a lost async reply, a
        wedged element -- and releases the frame (dead-lettered) so its
        backpressure slot returns well before the stream lease expires."""
        stream_id, frame_id = stream.stream_id, frame.frame_id

        def expired(_uuid):
            frame.deadline_lease = None
            live_stream = self.streams.get(stream_id)
            if live_stream is None:
                return
            if live_stream.frames.get(frame_id) is not frame:
                return  # finished in time
            _LOGGER.warning(
                "%s: frame %s/%s exceeded frame_deadline %.2fs "
                "(pending: %s); releasing as error", self.name,
                stream_id, frame_id, deadline_s,
                sorted(frame.pending_nodes) or "none")
            self.telemetry.record_deadline_expired(frame)
            self._dead_letter(
                live_stream, frame, None, "frame_deadline",
                f"frame exceeded {deadline_s}s with "
                f"{sorted(frame.pending_nodes)} in flight")
            self._finish_frame(live_stream, frame, dropped=True,
                               error=True)

        frame.deadline_lease = Lease(
            self.process.event, deadline_s,
            f"deadline:{stream_id}:{frame_id}",
            lease_expired_handler=expired)

    @staticmethod
    def _describe_value(value) -> str:
        """Compact dead-letter descriptor entry: shape/dtype for arrays,
        length for strings -- evidence of WHAT was in flight, never the
        payload itself."""
        if hasattr(value, "shape") and hasattr(value, "dtype"):
            return f"{value.dtype}{list(value.shape)}"
        if isinstance(value, (str, bytes)):
            return f"{type(value).__name__}[{len(value)}]"
        if isinstance(value, (list, tuple)):
            return f"{type(value).__name__}[{len(value)}]"
        return type(value).__name__

    def _dead_letter(self, stream: Stream, frame: Frame,
                     node_name, reason: str, diagnostic) -> None:
        """Publish the failed frame's evidence on
        `{topic_path}/dead_letter`: inputs DESCRIPTOR (swag keys with
        shapes/dtypes), diagnostic, and the frame's trace id so the
        failure joins its trace in the Perfetto export.  Consumed by the
        Recorder; export failures never mask the engine's own
        recovery."""
        self.telemetry.record_dead_letter(node_name, reason)
        trace = frame.trace
        meta = {
            "stream_id": stream.stream_id,
            "frame_id": frame.frame_id,
            "node": str(node_name) if node_name else "",
            "reason": reason,
            "trace_id": trace.trace_id if trace is not None else "",
            "diagnostic":
                str(diagnostic)[:_DEAD_LETTER_DIAGNOSTIC_CAP],
        }
        descriptor = {str(key): self._describe_value(value)
                      for key, value in frame.swag.items()}
        try:
            import os as _os
            cap = int(_os.environ.get("AIKO_DEAD_LETTER_DATA_MAX",
                                      _DEAD_LETTER_DATA_CAP))
            if cap > 0:
                encoded = encode_frame_data(dict(frame.swag))
                if len(encoded) <= cap:
                    meta["data"] = encoded
        except Exception:
            pass  # unencodable swag: descriptor-only dead letter
        try:
            self.process.publish(
                f"{self.topic_path}/dead_letter",
                generate("dead_letter", [meta, descriptor]))
        except Exception as error:
            _LOGGER.warning("%s: dead-letter publish failed: %s",
                            self.name, error)

    def _note_fused_failure(self, node_name: str, outputs) -> None:
        """A fused group program failed at RUN time (resolve-time
        failures already fall back in _resolve_group_kernel).  Count it;
        at FUSED_FLAP_LIMIT CONSECUTIVE failures (a later healthy fused
        group resets the count) the node's fused path is pinned off --
        a flapping kernel must not pay fused-failure + chained-retry on
        every group."""
        count = self._fused_failures.get(node_name, 0) + 1
        self._fused_failures[node_name] = count
        disabled = (count >= FUSED_FLAP_LIMIT
                    and node_name not in self._fused_disabled)
        if disabled:
            self._fused_disabled.add(node_name)
            self._fused_programs.pop(node_name, None)
            _LOGGER.warning(
                "%s: %s fused group path failed %d times; pinned to "
                "the chained path: %s", self.name, node_name, count,
                _diagnostic_of(outputs))
        else:
            _LOGGER.warning(
                "%s: %s fused group failed (%d/%d); retrying the group "
                "on the chained path: %s", self.name, node_name, count,
                FUSED_FLAP_LIMIT, _diagnostic_of(outputs))
        self.telemetry.record_fused_failure(node_name, disabled)

    # -- micro-batching (no reference counterpart: the reference processes
    # one frame per mailbox message, pipeline.py:1037-1092; on TPU the MFU
    # multiplier is coalescing queued frames into ONE jit call) ------------

    @staticmethod
    def _micro_signature(inputs: dict):
        """Frames coalesce only when every input agrees on FULL shape and
        dtype -- including the leading/batch size, so a coalesced group
        is always `k` equal-row stacks and the concat program is
        shape-stable (each distinct eager-op shape costs an XLA compile,
        painful on tunneled devices)."""
        leading = None
        signature = []
        for name in sorted(inputs):
            value = inputs[name]
            if not hasattr(value, "shape") or getattr(value, "ndim", 0) < 1:
                return None  # non-array input: not coalescable
            if leading is None:
                leading = value.shape[0]
            elif value.shape[0] != leading:
                return None  # inputs disagree on the batch axis
            signature.append(
                (name, tuple(value.shape[1:]), str(value.dtype)))
        if leading is None:
            return None
        return (leading, tuple(signature))

    def _micro_param_fingerprint(self, stream: Stream, node_name: str,
                                 definition):
        """Stream-parameter fingerprint gating CROSS-STREAM coalescing:
        frames from different streams may share one jit call only when
        both streams would resolve EVERY parameter identically.
        Conservative by design: the whole stream-parameter dict is
        fingerprinted (not just declared keys), so an element reading
        an undeclared per-stream knob via get_parameter(name, default)
        can never silently share a call resolved under another
        stream's values -- the failure mode is a smaller batch, never
        wrong output.  Values are canonically encoded (sorted keys,
        content-hashed arrays); repr() is not used because it
        truncates large ndarrays, letting different values compare
        equal.  Memoized per stream: stream parameters are fixed at
        create_stream (no mutation path exists), so hashing arrays
        every parked frame would be pure waste."""
        del node_name, definition  # every key participates
        cached = getattr(stream, "_micro_param_fingerprint", None)
        if cached is None:
            cached = _canonical_value(stream.parameters or {})
            stream._micro_param_fingerprint = cached
        return cached

    def _try_park_micro(self, stream: Stream, frame: Frame, node_name: str,
                        element, inputs: dict) -> bool:
        """Park the frame for coalesced execution when the element opts in
        (micro_batch > 1).  The flush message rides the back of the
        pipeline mailbox, so every frame already queued parks first --
        batch size adapts to instantaneous load (deep queue = big batch,
        idle = batch of one, so latency stays flat when unloaded).  The
        pending list is PER ELEMENT, not per stream: the serving
        scenario (many concurrent streams, one frame each) coalesces
        across streams into one jit call, with each frame resuming on
        its own stream.  The mailbox ride is also the starvation bound:
        a parked frame waits at most the messages already queued ahead
        of it, never for more traffic."""
        if isinstance(element, AsyncHostElement):
            return False  # async elements manage their own parking
        if element.engine_managed(stream):
            # the element runs its OWN batching engine (LMGenerate
            # `continuous: true`): frames must reach process_frame
            # one-by-one so the engine can admit them into the running
            # decode loop at prefill boundaries -- holding them in a
            # coalesced group would reintroduce exactly the closed-batch
            # convoy the engine exists to remove
            return False
        try:
            micro = int(element.get_parameter("micro_batch", 1, stream) or 1)
        except (TypeError, ValueError):
            return False
        if micro <= 1:
            return False
        shape_signature = self._micro_signature(inputs)
        if shape_signature is None:
            return False
        signature = (shape_signature, self._micro_param_fingerprint(
            stream, node_name, element.definition))
        pending = self._micro_pending.setdefault(node_name, [])
        frame.pending_nodes.add(node_name)
        pending.append((stream, frame, inputs, signature))
        # opens the queue-wait interval (closed at coalesced dispatch)
        self.telemetry.mark_park(frame, node_name, kind="micro")
        # capacity counts THIS signature only: mixed-signature traffic
        # (stream cohorts with different shapes or parameters) must not
        # trigger a flush that chronically splits every cohort into
        # partial groups -- each cohort fills to its own micro
        same_signature = sum(
            1 for entry in pending if entry[3] == signature)
        if same_signature >= micro:
            self._flush_micro_batch(node_name, signature=signature)
        elif len(pending) == 1:
            # micro_batch_wait_ms > 0: HOLD the flush for a bounded
            # window so trickling arrivals (the serving steady state --
            # each stream replenishes one frame per completion, so the
            # mailbox is usually empty and an immediate flush would run
            # batches of one) can coalesce.  The window is the explicit
            # starvation bound; 0 keeps the pure mailbox ride (batch
            # adapts to queue depth, zero added latency)
            try:
                wait_ms = float(element.get_parameter(
                    "micro_batch_wait_ms", 0, stream) or 0)
            except (TypeError, ValueError):
                wait_ms = 0.0
            if wait_ms > 0:
                self._schedule_micro_flush(node_name, wait_ms / 1000.0)
            else:
                self.post_message("_flush_micro_batch", [node_name])
        return True

    def _schedule_micro_flush(self, node_name: str, wait_s: float) -> None:
        """One-shot timer posting a flush for `node_name` after
        `wait_s` (the continuous-batching hold-down window).  Tracked in
        _micro_timers so a capacity-triggered flush cancels it (an
        orphan timer would fire early into the next batch's window)."""
        if node_name in self._micro_timers:
            return  # a window is already open
        gen = self._micro_flush_gen.get(node_name, 0)

        def fire():
            self.process.event.remove_timer_handler(fire)
            self._micro_timers.pop(node_name, None)
            # the generation rides along: if a capacity flush supersedes
            # this window before the message is processed, it is ignored
            self.post_message("_flush_micro_batch",
                              [node_name, None, gen])

        self._micro_timers[node_name] = fire
        self.process.event.add_timer_handler(fire, wait_s)

    def _flush_micro_batch(self, element_name, _legacy_stream_id=None,
                           gen=None, signature=None):
        node_name = str(element_name)
        if gen is not None and gen != self._micro_flush_gen.get(
                node_name, 0):
            # a hold-down timer's posted message from a window that a
            # capacity flush already superseded: ignoring it keeps it
            # from prematurely flushing the NEXT accumulating batch
            return
        pending = self._micro_pending.pop(node_name, None)
        if signature is not None and pending:
            # capacity flush for ONE ripe signature: other cohorts'
            # partial groups stay parked (their open hold-down window
            # or the mailbox-riding flush message still covers them,
            # so nothing starves)
            rest = [entry for entry in pending if entry[3] != signature]
            pending = [entry for entry in pending
                       if entry[3] == signature]
            if rest:
                self._micro_pending[node_name] = rest
        if node_name not in self._micro_pending:
            # everything consumed: supersede the open window so a
            # stale timer cannot fire early into the NEXT batch
            self._micro_flush_gen[node_name] = (
                self._micro_flush_gen.get(node_name, 0) + 1)
            fire = self._micro_timers.pop(node_name, None)
            if fire is not None:
                self.process.event.remove_timer_handler(fire)
        if not pending:
            return
        element = self.elements.get(node_name)
        if element is None or isinstance(element, RemoteElement):
            return
        if self.telemetry.enabled or (
                node_name not in self._micro_cohort_logged
                and _LOGGER.isEnabledFor(logging.DEBUG)):
            # only scan when someone consumes the result: the counter
            # (telemetry on) or the one-time debug log -- with
            # telemetry disabled and debug off the flush path stays
            # scan-free (the latency operating point's cost contract)
            # same shapes but different parameter fingerprints: streams
            # that cannot share a call.  ONE split event per flush (the
            # widest shape's cohort count), counted so operators watch
            # the rate live; said once (debug) so the log shows WHY
            # coalesced groups came up small instead of it degrading
            # silently
            fingerprints_by_shape: dict = {}
            for entry in pending:
                fingerprints_by_shape.setdefault(
                    entry[3][0], set()).add(entry[3][1])
            cohorts = max((len(prints) for prints
                           in fingerprints_by_shape.values()), default=0)
            if cohorts > 1:
                self.telemetry.record_cohort_split(node_name, cohorts)
                if node_name not in self._micro_cohort_logged:
                    self._micro_cohort_logged.add(node_name)
                    _LOGGER.debug(
                        "%s: %s parked frames split into %d "
                        "parameter-fingerprint cohorts (streams resolve "
                        "parameters differently, so cross-stream "
                        "coalescing runs smaller groups)",
                        self.name, node_name, cohorts)
        # gather-by-signature, FIFO by first occurrence: interleaved
        # streams with matching shapes+parameters coalesce; a
        # mismatched head never blocks later matching entries.  micro
        # capacity resolves per GROUP from its head entry's stream
        # (fingerprint equality makes every member agree, but different
        # fingerprint groups may configure different capacities)
        while pending:
            signature = pending[0][3]
            micro = max(1, int(element.get_parameter(
                "micro_batch", 1, pending[0][0]) or 1))
            group, rest = [], []
            for entry in pending:
                if len(group) < micro and entry[3] == signature:
                    group.append(entry)
                else:
                    rest.append(entry)
            pending = rest
            # frames finished elsewhere / destroyed streams: never resume
            group = [
                entry for entry in group
                if self.streams.get(entry[0].stream_id) is entry[0]
                and entry[0].frames.get(entry[1].frame_id) is entry[1]]
            if group:
                key = self._group_key(group) if recording() else None
                with PROGRAM.span(self._names(node_name)[0], key):
                    self._run_micro_group(element, group, micro)

    def _names(self, node_name: str) -> tuple:
        """The node's program span names: (flush, gather, element,
        split)."""
        names = self._span_names.get(node_name)
        if names is None:
            names = self._span_names[node_name] = tuple(
                f"{kind}:{node_name}"
                for kind in ("flush", "gather", "element", "split"))
        return names

    @staticmethod
    def _group_key(group: list):
        """A coalesced group's span key: its lead frame's trace id,
        else its lead stream and frame ids."""
        stream, frame = group[0][0], group[0][1]
        if frame.trace is not None:
            return frame.trace.trace_id
        return f"{stream.stream_id}:{frame.frame_id}"

    def _run_micro_group(self, element, group: list, micro: int) -> None:
        """One coalesced element call for `group` parked frames
        (possibly from SEVERAL streams): concat inputs on axis 0 --
        padded by default to the FULL micro_batch row count, so
        rampup/drain partial groups reuse the steady-state compilation
        (micro_batch_pad_full=false falls back to power-of-two buckets)
        -- split outputs back per frame, resume each through the normal
        graph path ON ITS OWN STREAM (per-stream response routing).

        Two execution paths: elements exposing a group kernel run
        concat+pad+kernel+split as ONE fused program
        (_call_fused_group); everything else runs the chained
        concat -> process_frame -> split trio."""
        node_name = element.definition.name
        lead_stream = group[0][0]
        rows = [next(iter(inputs.values())).shape[0]
                for _, _, inputs, _ in group]
        total = sum(rows)
        full = rows[0] * micro
        if element.get_parameter("micro_batch_pad_full", True,
                                 lead_stream):
            target = (full if total <= full
                      else bucket_length(total, minimum=rows[0]))
        else:
            target = bucket_length(total, minimum=rows[0])
        # pad the ENTRY LIST to exactly `micro` arrays with zero
        # fillers when padding to full: the concat program is then
        # one fixed shape per signature instead of one per group
        # size (in the JAX package each distinct arity costs an XLA
        # compile; the port keeps the same group shapes so both
        # packages compute the same batches).  split_rows mirrors the
        # fillers so partial (rampup/drain) groups split the same way
        fillers = (micro - len(group)
                   if target == full and len(group) < micro else 0)
        split_rows = rows + [rows[0]] * fillers if fillers else rows
        kernel_spec = self._resolve_group_kernel(element, lead_stream)
        # the element sees the LEAD stream (parameter fingerprints
        # guarantee every stream in the group resolves its parameters
        # identically, so the choice is immaterial)
        lead_stream.current_frame_id = group[0][1].frame_id
        # coalesced dispatch: close every member's queue-wait interval
        # (park -> here is scheduler-induced latency, reported apart
        # from element/device time) and record the group shape
        for _, parked_frame, _, _ in group:
            self.telemetry.record_queue_wait(parked_frame, node_name)
        self.telemetry.record_group(node_name, len(group), target,
                                    fused=kernel_spec is not None)
        per_frame = None
        element_start = time.perf_counter()
        # injected per-frame faults: a SINGLETON group consumes its
        # fault here (it goes straight to the error policy -- no
        # isolation pass would ever consume it); a multi-frame group
        # only PEEKS, so the consumable fires at the per-frame
        # isolation call and healthy cohort members complete
        if self.faults is None:
            poisoned = False
        elif len(group) == 1:
            poisoned = self.faults.element_raise(
                node_name, group[0][1].frame_id, group[0][0].stream_id)
        else:
            poisoned = any(
                self.faults.element_raise_pending(
                    node_name, parked.frame_id, parked_stream.stream_id)
                for parked_stream, parked, _, _ in group)
        if poisoned:
            stream_event, outputs = StreamEvent.ERROR, {
                "diagnostic": f"{node_name}: injected fault in "
                              f"coalesced group"}
            # NOT a fused flap: the kernel never executed (the injected
            # fault models a poisoned ELEMENT input, not a kernel bug),
            # so the breaker must not pin a healthy kernel chained
            kernel_spec = None
        elif kernel_spec is not None:
            stream_event, outputs, per_frame = self._call_fused_group(
                element, group, kernel_spec, target, split_rows, fillers)
            if stream_event == StreamEvent.ERROR:
                # a failed fused group is NOT lost: count the flap
                # (FUSED_FLAP_LIMIT pins the node chained) and retry the
                # whole group through the chained path before any
                # per-frame isolation
                self._note_fused_failure(node_name, outputs)
                per_frame = None
                kernel_spec = None
                stream_event, outputs = self._call_chained_group(
                    element, group, lead_stream, target, total, fillers)
            elif node_name in self._fused_failures:
                # a healthy fused group closes the flap window: only
                # CONSECUTIVE failures trip the breaker, so scattered
                # poison frames over a long deployment never pin a
                # healthy kernel to the chained path
                self._fused_failures.pop(node_name, None)
        else:
            stream_event, outputs = self._call_chained_group(
                element, group, lead_stream, target, total, fillers)
        elapsed = time.perf_counter() - element_start
        share = elapsed / len(group)
        contract_violation = False
        if stream_event == StreamEvent.PENDING:
            if len(group) == 1:
                # element continues off the event loop and resumes the
                # frame via process_frame_response (frame stays parked
                # in pending_nodes; the fallback-identity slot is only
                # claimed when no remote hop holds it)
                if group[0][1].paused_pe_name is None:
                    group[0][1].paused_pe_name = node_name
                return
            contract_violation = True
            stream_event, outputs = StreamEvent.ERROR, {
                "diagnostic": (
                    f"{node_name}: StreamEvent.PENDING is incompatible "
                    f"with micro_batch > 1 (the async continuation can "
                    f"only resume one frame); use an AsyncHostElement "
                    f"or micro_batch: 1")}
        if stream_event == StreamEvent.OKAY:
            if per_frame is None:  # chained path: split as its own program
                shared_outputs = {
                    port["name"] for port in element.definition.output
                    if not port.get("batched", True)}
                with PROGRAM.span(self._names(node_name)[3]):
                    per_frame = self._split_micro_outputs_all(
                        outputs or {}, split_rows, target, shared_outputs)
            for (stream, frame, _, _), frame_outputs in zip(group,
                                                            per_frame):
                if (self.streams.get(stream.stream_id) is not stream
                        or stream.frames.get(frame.frame_id) is not frame):
                    continue  # finished/destroyed meanwhile
                self.telemetry.record_element(
                    frame, node_name, element_start, share,
                    path=("fused" if kernel_spec is not None
                          else "chained"), group=len(group))
                frame.swag.update(self._map_out(frame_outputs,
                                                element.definition))
                frame.pending_nodes.discard(node_name)
                stream.current_frame_id = frame.frame_id
                self._run_frame(stream, frame, resume_after=node_name)
        else:
            # non-OKAY applies to the whole coalesced call: release every
            # frame under the same StreamEvent policy as the inline path,
            # each on its own stream
            for stream, frame, _, _ in group:
                frame.pending_nodes.discard(node_name)
                self.telemetry.record_element(
                    frame, node_name, element_start, share,
                    path=("fused" if kernel_spec is not None
                          else "chained"), group=len(group))
            if stream_event == StreamEvent.DROP_FRAME:
                for stream, frame, _, _ in group:
                    self._finish_frame(stream, frame, dropped=True)
            elif stream_event == StreamEvent.STOP:
                _LOGGER.info("%s: %s requested stream stop: %s",
                             self.name, node_name, outputs)
                for stream, frame, _, _ in group:
                    self._finish_frame(stream, frame)
                for stream_id in dict.fromkeys(
                        stream.stream_id for stream, _, _, _ in group):
                    self.destroy_stream(stream_id, graceful=True)
            elif contract_violation or (
                    len(group) > 1
                    and element.resolve_error_policy(
                        lead_stream).on_error == "stop_stream"):
                # the legacy hard-stop: a misdeclared element (PENDING
                # from a coalesced call) OR a group under the default
                # stop_stream policy -- the parameter fingerprint makes
                # the policy uniform across the group, and re-executing
                # members in isolation would both duplicate side
                # effects and break the historical contract the default
                # preserves
                _LOGGER.error("%s: %s error: %s", self.name, node_name,
                              _diagnostic_of(outputs))
                for stream, frame, _, _ in group:
                    self._dead_letter(stream, frame, node_name,
                                      "stop_stream",
                                      _diagnostic_of(outputs))
                    self._finish_frame(stream, frame, error=True)
                for stream_id in dict.fromkeys(
                        stream.stream_id for stream, _, _, _ in group):
                    self.destroy_stream(stream_id,
                                        state=StreamState.ERROR)
            elif len(group) == 1:
                stream, frame, _, _ = group[0]
                if (self.streams.get(stream.stream_id) is stream
                        and stream.frames.get(frame.frame_id) is frame):
                    self._handle_element_error(stream, frame, node_name,
                                               element, outputs)
            else:
                # both whole-group attempts failed under an opted-in
                # recovery policy (drop_frame/retry): one poison frame
                # must not kill its cohort -- split to per-frame
                # isolation, where each member takes its own
                # error-policy path.  Opting in accepts at-least-once
                # element execution for the group's members
                self._isolate_micro_group(element, group, node_name,
                                          outputs)

    def _call_chained_group(self, element, group: list,
                            lead_stream: Stream, target: int, total: int,
                            fillers: int) -> tuple:
        """The chained micro-batch call: concat+pad, then ONE
        process_frame over the coalesced batch (also the retry path for
        a failed fused group)."""
        node_name = element.definition.name
        _, gather, call, _ = self._names(node_name)
        with PROGRAM.span(gather):
            if len(group) == 1 and target == total:
                coalesced = dict(group[0][2])
            else:
                named_arrays = self._gather_named_arrays(group, fillers)
                coalesced = _concat_pad(named_arrays, target)
        with PROGRAM.span(call):
            return self._safe_call(node_name, element.process_frame,
                                   lead_stream, **coalesced)

    def _isolate_micro_group(self, element, group: list, node_name: str,
                             group_outputs) -> None:
        """Per-frame isolation after a whole-group failure: run each
        member individually with ITS OWN inputs so healthy frames
        complete and only the poison frame takes the element's error
        policy (retry re-parks it through the scheduler; drop_frame
        dead-letters it; stop_stream kills only its own stream)."""
        _LOGGER.warning(
            "%s: %s coalesced group of %d failed (%s); splitting to "
            "per-frame isolation", self.name, node_name, len(group),
            _diagnostic_of(group_outputs))
        for stream, frame, inputs, _ in group:
            if (self.streams.get(stream.stream_id) is not stream
                    or stream.frames.get(frame.frame_id) is not frame):
                continue  # finished/destroyed meanwhile
            stream.current_frame_id = frame.frame_id
            stream_event, outputs = self._dispatch_element(
                stream, frame, node_name, element, inputs)
            if stream_event == StreamEvent.OKAY:
                frame.swag.update(self._map_out(outputs or {},
                                                element.definition))
                self._run_frame(stream, frame, resume_after=node_name)
            elif stream_event == StreamEvent.PENDING:
                # the isolated call parked this frame alone -- the
                # single-frame PENDING contract applies
                frame.pending_nodes.add(node_name)
                if frame.paused_pe_name is None:
                    frame.paused_pe_name = node_name
            elif stream_event == StreamEvent.DROP_FRAME:
                self._finish_frame(stream, frame, dropped=True)
            elif stream_event == StreamEvent.STOP:
                self._finish_frame(stream, frame)
                self.destroy_stream(stream.stream_id, graceful=True)
            else:
                self._handle_element_error(stream, frame, node_name,
                                           element, outputs)

    def _gather_named_arrays(self, group: list, fillers: int) -> dict:
        """{input name: tuple of per-frame arrays}, entry list padded
        with cached zero fillers to keep the group's row count stable."""
        named_arrays = {}
        for name in group[0][2]:
            arrays = [inputs[name] for _, _, inputs, _ in group]
            if fillers:
                key = (tuple(arrays[0].shape), str(arrays[0].dtype))
                filler = self._micro_fillers.get(key)
                if filler is None:
                    if len(self._micro_fillers) >= 32:
                        # bounded: variable-shape workloads must not
                        # pin device buffers forever
                        self._micro_fillers.clear()
                    filler = torch.zeros_like(
                        _as_tensors(arrays[:1])[0])
                    self._micro_fillers[key] = filler
                arrays.extend([filler] * fillers)
            named_arrays[name] = tuple(arrays)
        return named_arrays

    def _resolve_group_kernel(self, element, stream: Stream):
        """The element's fused-path hook, resolved defensively: an
        unimplemented hook, a falsy `micro_batch_fused` parameter, or a
        raising hook all fall back to the chained path (the failure
        mode is the pre-fusion dispatch chain, never a lost frame)."""
        if (type(element).group_kernel
                is PipelineElement.group_kernel):
            return None  # hook not implemented: chained path
        if element.definition.name in self._fused_disabled:
            return None  # circuit breaker: flapping kernel pinned chained
        from ..utils import truthy
        if not truthy(element.get_parameter(
                "micro_batch_fused", True, stream)):
            return None
        try:
            spec = element.group_kernel(stream)
            if spec is None:
                return None
            kernel, context = spec  # malformed return -> chained path
            if not callable(kernel):
                raise TypeError(
                    f"group_kernel must return (callable, context), "
                    f"got ({type(kernel).__name__}, ...)")
        except Exception as error:
            if element.definition.name not in self._fused_rejected:
                self._fused_rejected.add(element.definition.name)
                _LOGGER.warning(
                    "%s: %s group_kernel failed (%s); using the chained "
                    "micro-batch path", self.name,
                    element.definition.name, error)
            return None
        return kernel, context

    def _call_fused_group(self, element, group: list, kernel_spec,
                          target: int, split_rows: list,
                          fillers: int) -> tuple:
        """The whole group as one call: the concat+pad of every input,
        the element's group kernel, and the per-frame output split.
        Returns (StreamEvent, outputs, per-frame output dicts | None)."""
        kernel, context = kernel_spec
        named_arrays = self._gather_named_arrays(group, fillers)
        shared = tuple(sorted(
            port["name"] for port in element.definition.output
            if not port.get("batched", True)))
        program = self._fused_program_for(element.definition.name, kernel)
        try:
            per_frame = program(
                context, named_arrays, target=int(target),
                counts=tuple(int(count) for count in split_rows),
                shared=shared)
        except Exception as error:
            return StreamEvent.ERROR, {
                "diagnostic": f"{element.definition.name}: fused group "
                              f"kernel failed: {error}",
                "traceback": traceback.format_exc()}, None
        return StreamEvent.OKAY, {}, list(per_frame[:len(group)])

    def _fused_program_for(self, node_name: str, kernel):
        """Cached concat+pad -> kernel -> split program for one element,
        keyed by kernel identity: elements keep their kernel objects
        stable (one per static parameter value), so each program persists
        across groups even when cohorts alternate.  The JAX package jits
        this program; here it runs eagerly, and the cache and its
        `record_compile` count are kept so the two packages report the
        same program builds.  The id key stays valid while the entry
        holds the kernel strongly; a reused id after GC fails the
        identity check and rebuilds."""
        programs = self._fused_programs.setdefault(node_name, {})
        entry = programs.get(id(kernel))
        if entry is not None and entry[0] is kernel:
            return entry[1]

        def slice_rows(value, offset, count, target):
            if isinstance(value, dict):
                return {name: slice_rows(child, offset, count, target)
                        for name, child in value.items()}
            if (hasattr(value, "ndim") and getattr(value, "ndim", 0) >= 1
                    and value.shape[0] == target):
                return value[offset:offset + count]
            if isinstance(value, list) and len(value) == target:
                # per-row Python list: same split rule as the chained
                # path's _split_micro_outputs_all host-list branch
                return value[offset:offset + count]
            return value  # leading axis not the batch: shared whole

        _, gather, call, split = self._names(node_name)

        def fused(context, named, target, counts, shared):
            with PROGRAM.span(gather):
                batch = _concat_pad(named, target)
            with PROGRAM.span(call):
                outputs = kernel(context, **batch)
            if not isinstance(outputs, dict):
                raise TypeError(
                    f"{node_name}: group kernel must return a dict, "
                    f"got {type(outputs)}")
            frames = []
            offset = 0
            with PROGRAM.span(split):
                for count in counts:
                    frames.append({
                        name: (value if name in shared
                               else slice_rows(value, offset, count,
                                               target))
                        for name, value in outputs.items()})
                    offset += count
            return tuple(frames)

        if len(programs) >= 8:
            # bounded: an element returning a FRESH closure every call
            # must not leak one dead program per group
            programs.clear()
        programs[id(kernel)] = (kernel, fused)
        # a fresh fused program (a fresh XLA compile in the JAX package):
        # counted + traced so program rebuilds are attributable
        self.telemetry.record_compile(node_name, "fused")
        return fused

    def _split_micro_outputs_all(self, outputs: dict, rows: list,
                                 target: int, shared: set) -> list:
        """Per-frame output dicts for a whole coalesced group.

        Split semantics: arrays (and lists) whose leading size matches
        the coalesced batch split by row range, recursing into nested
        dicts (e.g. the Detector's {"detections": {boxes, scores, ...}}
        contract); anything else -- and outputs named in `shared` (ports
        declared "batched": false) -- is shared by every frame.

        Tensor rows are sliced as views (no device work); the JAX package
        folds the same slicing into one jitted program."""
        device_leaves = []

        def plan(value, top_name=None):
            if top_name is not None and top_name in shared:
                return ("whole", value)
            if isinstance(value, dict):
                return ("dict", {name: plan(child)
                                 for name, child in value.items()})
            if (isinstance(value, torch.Tensor)
                    and getattr(value, "ndim", 0) >= 1
                    and value.shape[0] == target):
                device_leaves.append(value)
                return ("device", len(device_leaves) - 1)
            if (hasattr(value, "shape")
                    and getattr(value, "ndim", 0) >= 1
                    and value.shape[0] == target):
                return ("host", value)   # numpy: slicing is a free view
            if isinstance(value, list) and len(value) == target:
                return ("host", value)
            return ("whole", value)

        skeleton = {name: plan(value, name)
                    for name, value in (outputs or {}).items()}
        counts = tuple(int(count) for count in rows)
        parts = (_split_leaves(tuple(device_leaves), counts)
                 if device_leaves else None)
        offsets = []
        offset = 0
        for count in counts:
            offsets.append(offset)
            offset += count

        def build(node, index):
            kind, payload = node
            if kind == "dict":
                return {name: build(child, index)
                        for name, child in payload.items()}
            if kind == "device":
                return parts[index][payload]
            if kind == "host":
                start = offsets[index]
                return payload[start:start + counts[index]]
            return payload  # whole: shared by every frame

        return [
            {name: build(node, index) for name, node in skeleton.items()}
            for index in range(len(counts))]

    def _arm_park_watchdog(self, stream: Stream, frame: Frame,
                           doubtful) -> None:
        """One-shot timer releasing a frame whose park attribution is in
        doubt: if the DOUBTFUL parks (snapshot at arming) resume normally
        the watchdog is a no-op -- later parks on other nodes are healthy
        and must not be killed; if a doubtful park never resumes
        (misbehaving PENDING element), the frame is released as an error
        instead of leaking until the stream dies."""
        frame.park_doubtful |= set(doubtful)
        if frame.park_watchdog is not None:
            # a later unroutable response over DIFFERENT parks: the
            # union above keeps them covered; restart the clock
            frame.park_watchdog.extend()
            return
        try:
            timeout = float(stream.parameters.get("park_timeout", 10.0))
        except (TypeError, ValueError):
            timeout = 10.0
        stream_id, frame_id = stream.stream_id, frame.frame_id

        def expired(_uuid):
            frame.park_watchdog = None  # always allow a later re-arm
            live_stream = self.streams.get(stream_id)
            if live_stream is None:
                return
            live_frame = live_stream.frames.get(frame_id)
            if live_frame is not frame:
                return  # finished meanwhile
            still_doubtful = frame.pending_nodes & frame.park_doubtful
            if not still_doubtful:
                frame.park_doubtful.clear()
                return  # ambiguity resolved; any current parks are healthy
            _LOGGER.warning(
                "%s: frame %s/%s parks %s still unresolved %.1fs after an "
                "unroutable response; releasing as error", self.name,
                stream_id, frame_id, sorted(still_doubtful), timeout)
            # watchdog kills must show up in telemetry and the dashboard
            # metrics page, not only in this log line
            self.telemetry.record_park_expired(frame, still_doubtful)
            self._dead_letter(
                live_stream, frame, None, "park_expired",
                f"parks {sorted(still_doubtful)} unresolved "
                f"{timeout}s after an unroutable response")
            self._finish_frame(live_stream, frame, dropped=True,
                               error=True)

        frame.park_watchdog = Lease(
            self.process.event, timeout,
            f"park:{stream_id}:{frame_id}", lease_expired_handler=expired)

    def _safe_call(self, node, method, *args, **kwargs) -> tuple:
        """Run one element hook, mapping exceptions and malformed
        returns to StreamEvent.ERROR.  `node` is the graph-node name:
        the diagnostic carries WHICH element blew up, so dead letters
        and logs are attributable without reconstructing the call site
        from a traceback."""
        try:
            result = method(*args, **kwargs)
            if result is None:
                return StreamEvent.OKAY, {}
            if (isinstance(result, tuple) and len(result) == 2
                    and isinstance(result[0], StreamEvent)):
                return result
            return StreamEvent.ERROR, {
                "node": str(node),
                "diagnostic": f"{node}: {method.__qualname__} must "
                              f"return (StreamEvent, dict), got "
                              f"{type(result)}"}
        except Exception as error:
            return StreamEvent.ERROR, {
                "node": str(node),
                "diagnostic": f"{node}: {error}",
                "traceback": traceback.format_exc()}

    def _finish_frame(self, stream: Stream, frame: Frame,
                      dropped: bool = False, error: bool = False) -> None:
        if stream.frames.get(frame.frame_id) is not frame:
            return  # already finished (reentrant resume/flush paths)
        if frame.park_watchdog is not None:
            frame.park_watchdog.terminate()
            frame.park_watchdog = None
        if frame.deadline_lease is not None:
            frame.deadline_lease.terminate()
            frame.deadline_lease = None
        # in-flight branch work for this frame must never resume it:
        # strip it from every micro-batch pending list
        if frame.pending_nodes:
            for node_name, entries in list(self._micro_pending.items()):
                kept = [entry for entry in entries
                        if entry[1] is not frame]
                if len(kept) != len(entries):
                    if kept:
                        self._micro_pending[node_name] = kept
                    else:
                        self._micro_pending.pop(node_name, None)
        stream.frames.pop(frame.frame_id, None)
        if stream.pending > 0:
            stream.pending -= 1
        self._frame_count += 1
        self.telemetry.frame_end(stream, frame, dropped=dropped,
                                 error=error)
        if stream.stop_requested and stream.pending == 0:
            self.destroy_stream(stream.stream_id)
        if not dropped and not error:
            self._respond(stream, frame)
        elif stream.topic_response:
            # A remote caller has this frame parked: notify it the frame was
            # dropped/errored so it releases the frame instead of leaking it.
            # The notice names this pipeline, so a gateway can tell one
            # from a replica it has drained or failed over
            self.process.publish(
                stream.topic_response,
                generate("process_frame_response", [
                    {"stream_id": stream.stream_id,
                     "frame_id": frame.frame_id,
                     "event": "error" if error else "drop_frame",
                     "topic_path": self.topic_path},
                ]))

    def _respond(self, stream: Stream, frame: Frame) -> None:
        outputs = {key: value for key, value in frame.swag.items()
                   if key in self._produced_keys}
        if stream.queue_response is not None:
            stream.queue_response.put((stream, frame, outputs))
        elif stream.topic_response:
            self.process.publish(
                stream.topic_response,
                generate("process_frame_response", [
                    {"stream_id": stream.stream_id,
                     "frame_id": frame.frame_id},
                    encode_frame_data(outputs).encode("ascii"),
                ]))

    # -- name mapping (reference pipeline.py:1184-1212) --------------------

    def _map_in(self, swag: dict, definition) -> dict:
        inputs = {}
        for port in definition.input:
            swag_key = definition.map_in.get(port["name"], port["name"])
            if swag_key not in swag:
                if port.get("optional"):
                    inputs[port["name"]] = None
                    continue
                raise KeyError(swag_key)
            inputs[port["name"]] = swag[swag_key]
        return inputs

    def _map_out(self, outputs: dict, definition) -> dict:
        mapped = {}
        for port in definition.output:
            name = port["name"]
            if name in outputs:
                mapped[definition.map_out.get(name, name)] = outputs[name]
        return mapped

    # -- live parameters & observability -----------------------------------

    def set_parameter(self, name, value) -> None:
        if self.ec_producer is not None:
            self.ec_producer.update(name, value)
        else:
            self.share[name] = value

    def set_element_parameter(self, element_name, name, value) -> None:
        element = self.elements.get(str(element_name))
        if element is not None and not isinstance(element, RemoteElement):
            element.set_parameter(name, value)

    def load(self) -> dict:
        """Instantaneous load summary: `inflight` frames admitted but
        not finished (across streams), `queue_depth` frames parked in
        the micro-batch scheduler awaiting a coalesced flush, and the
        live stream count.  Cheap enough to read per routed frame: the
        serving gateway's replica selection (power-of-two-choices) and
        admission caps consume exactly this dict -- locally for
        in-process replicas, via the EC share (below, plus the periodic
        telemetry summary) for remote ones."""
        # gateways read this CROSS-THREAD per routing decision while
        # this pipeline's own loop churns streams: snapshot the dicts
        # atomically (list() never yields the GIL) before iterating --
        # a generator over the live dict raised "dictionary changed
        # size during iteration" under a 1,000-stream creation storm,
        # silently losing the create that was being routed
        streams = list(self.streams.values())
        pending = list(self._micro_pending.values())
        return {
            "inflight": sum(stream.pending for stream in streams),
            "queue_depth": sum(len(entries) for entries in pending),
            "streams": len(streams),
        }

    def publish_trace(self, topic_response) -> None:
        """Wire query (`aiko trace collect`): publish this pipeline's
        self-describing Perfetto document -- the live-fleet harvest
        path, mirroring the Recorder's paged dead-letter query.  The
        reply shape lives in observe/collector.py (shared with the
        gateway)."""
        from ..observe import publish_trace_document
        publish_trace_document(self.process, self.telemetry,
                               self.topic_path, topic_response)

    def throttle(self, stream_id, rate) -> None:
        """Wire-invocable backpressure: cap `stream_id`'s frame
        generators at `rate` frames/sec (rate <= 0 lifts the cap).
        Sent by the serving gateway as `(throttle stream rate)` when
        every replica saturates -- slowing the source beats shedding
        its frames."""
        stream = self.streams.get(str(stream_id))
        if stream is None:
            return
        rate = parse_float(rate, 0.0)
        for node_name in self.graph.get_path(stream.graph_path):
            element = self.elements[node_name]
            if isinstance(element, RemoteElement):
                element.call("throttle", [stream.stream_id, rate])
            else:
                element.throttle_frame_generation(stream.stream_id, rate)

    def _update_stream_share(self) -> None:
        if self.ec_producer is not None:
            # staged: stream/frame churn folds into one delta payload
            # per drained mailbox burst instead of two publishes per
            # lease per frame (see ECProducer.stage)
            self.ec_producer.stage("stream_count", len(self.streams))
            self.ec_producer.stage("frame_count", self._frame_count)
            # refresh the load gauge consumed by serving gateways --
            # but load() is O(streams + parked), so a creation BURST
            # (thousands of streams, the lease-jitter scenario) must
            # not go quadratic on the event loop: rate-limit to one
            # refresh per 200 ms; the periodic telemetry heartbeat
            # keeps it fresh between churn events anyway
            now = time.monotonic()
            if now - getattr(self, "_load_shared_at", 0.0) >= 0.2:
                self._load_shared_at = now
                load = self.load()
                self.ec_producer.stage("inflight", load["inflight"])
                self.ec_producer.stage("queue_depth",
                                       load["queue_depth"])

    # -- checkpoint / resume (no reference counterpart: SURVEY.md section 5
    # "Checkpoint/resume: absent"; required for preemptible TPU recovery) --

    def checkpoint(self, checkpointer, step: int):
        """Persist every ComputeElement's device state plus per-stream
        frame cursors."""
        from .compute_element import ComputeElement
        states = {
            name: element.state
            for name, element in self.elements.items()
            if isinstance(element, ComputeElement)
            and element.state is not None}
        def json_safe(parameters):
            # metadata is a JSON sidecar: keep only values that survive
            # json round-trip (device arrays / bytes are dropped, not
            # stringified -- a missing parameter beats a corrupt one)
            safe = {}
            for name, value in (parameters or {}).items():
                try:
                    json.dumps(value)
                except (TypeError, ValueError):
                    continue
                safe[name] = value
            return safe

        cursors = {
            stream_id: {"frame_id": stream.frame_id,
                        "parameters": json_safe(stream.parameters),
                        "graph_path": stream.graph_path}
            for stream_id, stream in list(self.streams.items())}
        return checkpointer.save(
            step, states,
            metadata={"pipeline": self.definition.name,
                      "streams": cursors})

    def restore_checkpoint(self, checkpointer, step: int | None = None):
        """Restore element states; returns the metadata dict (callers
        recreate streams from metadata["streams"] cursors)."""
        from .compute_element import ComputeElement
        states, metadata = checkpointer.restore(step)
        if states:
            for name, state in states.items():
                element = self.elements.get(name)
                if isinstance(element, ComputeElement):
                    element.restore_state(state)
        for stream_id, cursor in (metadata.get("streams") or {}).items():
            frame_id = int(cursor.get("frame_id", 0))
            stream = self.streams.get(stream_id)
            if stream is None:
                self.create_stream(stream_id,
                                   parameters=cursor.get("parameters"),
                                   graph_path=cursor.get("graph_path"),
                                   first_frame_id=frame_id)
            elif stream.frame_id < frame_id:
                stream.frame_id = frame_id
        return metadata

    # -- live weight hand-off (elastic-fleet warm start) -------------------
    #
    # A freshly spawned replica re-running setup() re-initializes (or
    # re-loads) every parameter the fleet already holds in HBM.  The
    # transfer plane (pipeline/transfer.py) already moves bulk tensors
    # process-to-process with the broker carrying only descriptors, so a
    # live sibling can STREAM its params instead: export_weights()
    # offers every ComputeElement state leaf and returns a
    # JSON-serializable descriptor tree; the new replica's
    # import_weights() fetches the leaves and installs them through the
    # checkpoint-restore path (restore_state), so mesh placement and
    # the no-double-allocation guarantee are the proven ones.

    def export_weights(self) -> dict:
        """Offer every ComputeElement's device state over the transfer
        plane; returns {element_name: descriptor_tree} where each leaf
        is a `{TENSOR_REF_KEY: descriptor}` marker.  Only elements
        whose state ALREADY exists are exported: this runs on the
        spawner's thread, and forcing a lazy setup() here would race
        the sibling's own event loop mid-frame -- an element that has
        never served simply comes up cold on the importer."""
        from .compute_element import ComputeElement
        from .transfer import TENSOR_REF_KEY, get_transfer_server
        from ..observe.metrics import get_registry
        from ..utils.tree import tree_map

        server = get_transfer_server()
        metrics = get_registry()
        exported = {}
        for name, element in self.elements.items():
            if not isinstance(element, ComputeElement):
                continue
            if element.state is None:
                continue

            def offer(leaf):
                descriptor = server.offer(leaf)
                metrics.counter("warm_start.exported_bytes").inc(
                    int(leaf.nbytes))
                return {TENSOR_REF_KEY: descriptor}

            exported[name] = tree_map(offer, element.state)
        metrics.counter("warm_start.exports").inc()
        return exported

    def import_weights(self, exported: dict) -> list:
        """Fetch a sibling's export_weights() tree and install it:
        returns the element names that received state.  Elements absent
        from the tree (or unknown here) fall back to their own setup()
        untouched -- a partial hand-off is better than none."""
        from .compute_element import ComputeElement
        from .transfer import TENSOR_REF_KEY, fetch_many
        from ..observe.metrics import get_registry

        metrics = get_registry()

        # two passes: collect every descriptor leaf first, then fetch
        # the whole tree through fetch_many -- ONE connection per
        # producing peer instead of one TCP handshake per leaf (the
        # hand-off of a transformer's parameter tree is dozens of
        # leaves from the same sibling)
        pending: list = []

        def collect(node):
            if isinstance(node, dict):
                if TENSOR_REF_KEY in node:
                    pending.append(node[TENSOR_REF_KEY])
                    return
                for value in node.values():
                    collect(value)
                return
            if isinstance(node, (list, tuple)):
                for value in node:
                    collect(value)
                return
            if node is None:
                return
            # leaves were all replaced by descriptor markers at export:
            # anything else is a container this walk cannot rebuild
            raise ValueError(
                f"import_weights: unsupported state container "
                f"{type(node).__name__} (dict/list/tuple pytrees only)")

        def materialize(node, fetched):
            if isinstance(node, dict):
                if TENSOR_REF_KEY in node:
                    array = next(fetched)
                    metrics.counter("warm_start.imported_bytes").inc(
                        array.nbytes)
                    return array
                return {key: materialize(value, fetched)
                        for key, value in node.items()}
            if isinstance(node, tuple) and hasattr(node, "_fields"):
                # namedtuple pytree node (optimizer states etc.):
                # the constructor takes fields positionally
                return type(node)(*(materialize(value, fetched)
                                    for value in node))
            if isinstance(node, (list, tuple)):
                return type(node)(materialize(value, fetched)
                                  for value in node)
            return None

        installed = []
        start = time.perf_counter()
        for name, tree in (exported or {}).items():
            element = self.elements.get(name)
            if not isinstance(element, ComputeElement):
                _LOGGER.warning("%s: import_weights has no local "
                                "ComputeElement %r; skipped",
                                self.name, name)
                continue
            pending = []
            collect(tree)
            fetched = iter(fetch_many(pending))
            element.restore_state(materialize(tree, fetched))
            installed.append(name)
        metrics.histogram("warm_start.import_s").record(
            time.perf_counter() - start)
        return installed

    def stop(self) -> None:
        self.telemetry.stop()  # final snapshot publish + timer teardown
        for stream_id in list(self.streams):
            self.destroy_stream(stream_id)
        if self._services_cache is not None:
            # the cache is process-shared: detach OUR handlers so a
            # stopped pipeline stops reacting to service churn
            for handler in self._remote_handlers:
                self._services_cache.remove_handler(handler)
            self._remote_handlers.clear()
        for element in self.elements.values():
            if not isinstance(element, RemoteElement):
                element.stop()
        super().stop()


def create_pipeline(process, definition_source, name: str = None) -> Pipeline:
    definition = (definition_source
                  if isinstance(definition_source, PipelineDefinition)
                  else parse_pipeline_definition(definition_source))
    return Pipeline(process, definition, name=name)
