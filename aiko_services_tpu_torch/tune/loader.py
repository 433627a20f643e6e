# Trace/metrics loader: one recorded bench run -> a per-element span
# profile joined against the static graph.
#
# Input is a Perfetto/Chrome-trace JSON artifact as exported by
# observe/trace.py (bench.py --trace writes one per config).  A
# round-14+ artifact is SELF-DESCRIBING: its metadata block embeds the
# pipeline definition, a parameter fingerprint, the bench config block,
# and a metrics-registry snapshot, so this loader needs no side-channel
# files.  Older traces still load, but carry an AIKO503 "metadata
# absent" diagnostic and need a --definition side channel before any
# classification can be attributed to typed nodes.
#
# The join: every span is attributed to its graph node by name, per
# THE span taxonomy (categories, "{kind}:{node}" naming scheme, and
# the time_queue_* vs time_* split) documented ONCE in
# observe/trace.py's module docstring; "gateway"-category spans join
# the "gateway" pseudo-node (no definition element by design).  Spans
# naming a node the definition does not declare, and definition
# elements that never produced a span, both surface as diagnostics
# instead of being silently dropped -- tune's whole value is that its
# numbers are attributable.

from __future__ import annotations

import json
from dataclasses import dataclass, field

from ..analyze.diagnostics import Diagnostic
from ..observe.trace import TRACE_METADATA_SCHEMA, trace_metadata_of

__all__ = ["ElementProfile", "LoadedTrace", "TraceLoadError",
           "load_trace"]


class TraceLoadError(ValueError):
    """The artifact is not a loadable trace (not JSON, not a
    Chrome-trace document, or an unknown metadata schema)."""


@dataclass
class ElementProfile:
    """Every span the trace attributes to ONE graph node."""

    name: str
    compute_s: list = field(default_factory=list)   # per-frame share
    queue_s: list = field(default_factory=list)     # scheduler wait
    groups: list = field(default_factory=list)      # coalesced sizes
    paths: dict = field(default_factory=dict)       # path -> count
    compiles: int = 0
    block_ready_s: list = field(default_factory=list)
    # engine-managed (decode/) spans, when present
    engine_queue_s: list = field(default_factory=list)
    engine_prefill_s: list = field(default_factory=list)
    engine_decode_s: list = field(default_factory=list)
    # disaggregated adoption: KV-migration fetch + pool scatter spans
    engine_adopt_s: list = field(default_factory=list)
    # warm KV failover: decode-state snapshot spans (global lane --
    # a checkpoint covers every due slot, not one frame)
    engine_checkpoint_s: list = field(default_factory=list)
    engine_preemptions: int = 0
    engine_tokens: int = 0
    # cross-request prefix reuse: per-completion evidence off the
    # prefill span args (requests with >= 1 borrowed block, and the
    # total blocks borrowed) -- the cache-bound floor's input
    engine_prefix_hits: int = 0
    engine_prefix_requests: int = 0
    engine_prefix_blocks: int = 0
    # serving-gateway spans (fleet-scope traces): admit-wait (frame
    # submit -> replica dispatch, parked wait included), route
    # decision, failover replay waves, and shed/throttle counts --
    # what the admission-bound floor classifies on
    gateway_admit_s: list = field(default_factory=list)
    gateway_route_s: list = field(default_factory=list)
    gateway_replay_s: list = field(default_factory=list)
    gateway_sheds: int = 0
    gateway_throttles: int = 0

    @property
    def calls(self) -> int:
        return len(self.compute_s)

    @property
    def is_engine_managed(self) -> bool:
        return bool(self.engine_prefill_s or self.engine_decode_s
                    or self.engine_adopt_s
                    or self.engine_checkpoint_s)

    @property
    def is_gateway(self) -> bool:
        """A serving-tier profile (the "gateway" pseudo-node): joined
        against no definition element, classified by the
        admission-bound branch instead of the kernel floors."""
        return bool(self.gateway_admit_s or self.gateway_route_s
                    or self.gateway_replay_s or self.gateway_sheds
                    or self.gateway_throttles)


@dataclass
class LoadedTrace:
    """One parsed artifact: profiles + the static context it embeds."""

    path: str
    metadata: dict | None
    definition_document: dict | None
    definition: object | None           # PipelineDefinition when joined
    config: dict = field(default_factory=dict)
    config_name: str = ""
    fingerprint: str = ""
    metrics: dict = field(default_factory=dict)
    elements: dict = field(default_factory=dict)    # name -> profile
    frame_durations_s: list = field(default_factory=list)
    frame_statuses: dict = field(default_factory=dict)
    wall_s: float = 0.0                 # first span start -> last end
    diagnostics: list = field(default_factory=list)

    @property
    def frame_count(self) -> int:
        return len(self.frame_durations_s)

    def diagnostic(self, code: str, message: str) -> None:
        self.diagnostics.append(Diagnostic(
            code, message,
            definition=(self.definition_document or {}).get("name", "")))


def _node_of(name: str) -> str:
    """Span name -> graph node: strip the category prefix
    ("queue:asr" -> "asr") and the engine row suffix
    ("decode_steps:lm[3]" -> "lm")."""
    if ":" in name:
        name = name.split(":", 1)[1]
    if name.endswith("]") and "[" in name:
        name = name[:name.rindex("[")]
    return name


def _select_run(metadata: dict, run: str | None, loaded: LoadedTrace):
    """Combined multi-pipeline artifacts (bench.py's legacy single
    file) carry per-run metadata under "runs"; pick one."""
    runs = metadata.get("runs")
    if not isinstance(runs, dict) or not runs:
        return metadata
    if run is None:
        if len(runs) == 1:
            return next(iter(runs.values()))
        loaded.diagnostic(
            "AIKO503",
            f"combined trace carries {len(runs)} runs "
            f"({sorted(runs)}); pass --run to pick one")
        return {}
    selected = runs.get(run)
    if selected is None:
        loaded.diagnostic(
            "AIKO503",
            f"run {run!r} not in trace (have {sorted(runs)})")
        return {}
    return selected


def load_trace(path: str, definition=None,
               run: str | None = None,
               document: dict | None = None) -> LoadedTrace:
    """Load one trace artifact and join it against the static graph.

    `definition` (document/path/PipelineDefinition) is the side
    channel for metadata-absent traces; when BOTH are present the
    explicit one wins and a fingerprint mismatch is diagnosed.

    Pass `document` to load an IN-MEMORY Chrome-trace document (the
    autopilot and `aiko tune --live` tune a live wire harvest without
    an artifact file); `path` then only labels the report."""
    from ..pipeline.definition import (
        DefinitionError, PipelineDefinition, parse_pipeline_definition)

    if document is None:
        try:
            with open(path) as handle:
                document = json.load(handle)
        except OSError as error:
            raise TraceLoadError(f"cannot read trace {path}: {error}") \
                from None
        except ValueError as error:
            raise TraceLoadError(f"{path} is not JSON: {error}") \
                from None
    if not isinstance(document, dict) \
            or not isinstance(document.get("traceEvents"), list):
        raise TraceLoadError(
            f"{path} is not a Chrome-trace document "
            f"(no traceEvents list)")

    metadata = trace_metadata_of(document)
    loaded = LoadedTrace(path=path, metadata=metadata,
                         definition_document=None, definition=None)
    allowed_pids: set | None = None
    if metadata is None:
        loaded.diagnostic(
            "AIKO503",
            f"{path} carries no aiko metadata block (recorded before "
            f"the self-describing trace schema, or by another tool); "
            f"pass an explicit definition to join its spans")
    else:
        schema = metadata.get("schema")
        if schema != TRACE_METADATA_SCHEMA:
            raise TraceLoadError(
                f"{path}: unknown trace metadata schema {schema!r} "
                f"(this build reads schema {TRACE_METADATA_SCHEMA})")
        combined = isinstance(metadata.get("runs"), dict)
        metadata = _select_run(metadata, run, loaded)
        loaded.definition_document = metadata.get("definition")
        loaded.config = metadata.get("config") or {}
        loaded.config_name = metadata.get("config_name") or ""
        loaded.fingerprint = metadata.get("fingerprint") or ""
        loaded.metrics = metadata.get("metrics") or {}
        if combined:
            # a COMBINED artifact carries every benched pipeline's
            # spans: keep only the selected run's tracer pids, or
            # other configs' same-named nodes would corrupt this
            # run's medians and frame counts
            pids = metadata.get("pids")
            if pids:
                allowed_pids = {int(pid) for pid in pids}
            elif metadata:
                loaded.diagnostic(
                    "AIKO503",
                    "combined trace run carries no tracer pid list; "
                    "spans from every run are ingested -- medians "
                    "may mix configs (re-record with this build)")

    if definition is not None:
        try:
            if isinstance(definition, PipelineDefinition):
                parsed = definition
            else:
                parsed = parse_pipeline_definition(definition,
                                                   validate=False)
            from ..pipeline.definition import definition_to_document
            side_document = definition_to_document(parsed)
            if loaded.definition_document is not None:
                from ..observe.trace import definition_fingerprint
                if (loaded.fingerprint
                        and definition_fingerprint(side_document)
                        != loaded.fingerprint):
                    loaded.diagnostic(
                        "AIKO503",
                        "explicit definition does not match the "
                        "fingerprint embedded in the trace; "
                        "recommendations are joined against the "
                        "EXPLICIT definition")
            loaded.definition_document = side_document
            loaded.definition = parsed
        except DefinitionError as error:
            loaded.diagnostic("AIKO503",
                              f"side-channel definition unusable: "
                              f"{error}")
    elif loaded.definition_document is not None:
        try:
            loaded.definition = parse_pipeline_definition(
                loaded.definition_document, validate=False)
        except DefinitionError as error:
            loaded.diagnostic(
                "AIKO503",
                f"embedded definition does not parse: {error}")

    _ingest_events(loaded, document["traceEvents"],
                   allowed_pids=allowed_pids)
    _join(loaded)
    return loaded


def _ingest_events(loaded: LoadedTrace, events: list,
                   allowed_pids: set | None = None) -> None:
    first_us = None
    last_us = None
    profiles = loaded.elements
    # merged fleet artifacts carry one frame span PER PROCESS for the
    # same logical frame (gateway root + each replica's slice, all
    # sharing one trace id): keep the LONGEST span per trace id -- the
    # root's end-to-end duration -- so frame stats are not inflated
    frames_by_trace: dict = {}
    for event in events:
        if not isinstance(event, dict):
            continue
        if allowed_pids is not None \
                and event.get("pid") not in allowed_pids:
            continue
        kind = event.get("ph")
        category = event.get("cat", "")
        name = str(event.get("name", ""))
        ts = event.get("ts")
        dur = event.get("dur", 0.0)
        if kind in ("X", "i") and isinstance(ts, (int, float)):
            first_us = ts if first_us is None else min(first_us, ts)
            end = ts + (dur if isinstance(dur, (int, float)) else 0.0)
            last_us = end if last_us is None else max(last_us, end)
        if kind == "X" and category == "frame":
            args = event.get("args") or {}
            status = str(args.get("status", "ok"))
            trace_id = args.get("trace_id")
            duration_s = float(dur) / 1e6
            if trace_id:
                known = frames_by_trace.get(trace_id)
                if known is None or duration_s > known[0]:
                    frames_by_trace[trace_id] = (duration_s, status)
            else:
                loaded.frame_durations_s.append(duration_s)
                loaded.frame_statuses[status] = (
                    loaded.frame_statuses.get(status, 0) + 1)
            continue
        node = _node_of(name)
        if not node:
            continue
        if kind == "X" and category == "element":
            profile = profiles.setdefault(node, ElementProfile(node))
            profile.compute_s.append(float(dur) / 1e6)
            args = event.get("args") or {}
            path = str(args.get("path", "inline"))
            profile.paths[path] = profile.paths.get(path, 0) + 1
            group = args.get("group")
            if isinstance(group, (int, float)):
                profile.groups.append(int(group))
        elif kind == "X" and category == "queue":
            profile = profiles.setdefault(node, ElementProfile(node))
            wait = float(dur) / 1e6
            if name.startswith("queue:") and "[" in name:
                profile.engine_queue_s.append(wait)
            else:
                profile.queue_s.append(wait)
        elif kind == "X" and category == "engine":
            profile = profiles.setdefault(node, ElementProfile(node))
            span = float(dur) / 1e6
            if name.startswith("prefill:"):
                profile.engine_prefill_s.append(span)
                args = event.get("args") or {}
                shared = args.get("prefix_blocks")
                if isinstance(shared, (int, float)):
                    # the span carries prefix_blocks ONLY when the
                    # replica ran a prefix cache: its presence marks a
                    # judged request, its value the blocks borrowed
                    profile.engine_prefix_requests += 1
                    if int(shared) > 0:
                        profile.engine_prefix_hits += 1
                        profile.engine_prefix_blocks += int(shared)
            elif name.startswith("adopt:"):
                # disaggregated serving: the decode replica's KV
                # migration (batched transfer-plane fetch + pool
                # scatter) -- classified apart from slot-queue waits
                profile.engine_adopt_s.append(span)
            elif name.startswith("checkpoint:"):
                # warm KV failover: time the engine pump spent
                # building/offering decode-state snapshots -- a
                # cadence set too hot floors the engine here
                profile.engine_checkpoint_s.append(span)
            elif name.startswith("decode_steps:"):
                profile.engine_decode_s.append(span)
                args = event.get("args") or {}
                preempted = args.get("preemptions")
                if isinstance(preempted, (int, float)):
                    profile.engine_preemptions += int(preempted)
                tokens = args.get("tokens")
                if isinstance(tokens, (int, float)):
                    profile.engine_tokens += int(tokens)
            # engine-managed frames report their slot wait under a
            # row-suffixed queue span; an un-suffixed single-row one
            # lands in queue_s above, which is the same quantity
        elif category == "gateway":
            # serving-tier spans: "admit:gateway" / "route:gateway" /
            # "replay:gateway" X spans plus shed/throttle instants --
            # all attributed to the "gateway" pseudo-node (there is no
            # matching definition element; _join skips it)
            profile = profiles.setdefault(node, ElementProfile(node))
            span = float(dur) / 1e6 if isinstance(
                dur, (int, float)) else 0.0
            if kind == "X" and name.startswith("admit:"):
                profile.gateway_admit_s.append(span)
            elif kind == "X" and name.startswith("route:"):
                profile.gateway_route_s.append(span)
            elif kind == "X" and ("replay:" in name):
                profile.gateway_replay_s.append(span)
            elif kind == "i" and name.startswith("shed:"):
                profile.gateway_sheds += 1
            elif kind == "i" and name.startswith("throttle:"):
                # rate 0 is the LIFT instant (backpressure cleared):
                # only count the onset, mirroring gateway.throttled
                # vs gateway.unthrottled
                rate = args.get("rate") if isinstance(args, dict) \
                    else None
                if not isinstance(rate, (int, float)) or rate > 0:
                    profile.gateway_throttles += 1
        elif kind == "i" and category == "compile":
            if name.startswith("compile:"):
                profile = profiles.setdefault(node,
                                              ElementProfile(node))
                profile.compiles += 1
    for duration_s, status in frames_by_trace.values():
        loaded.frame_durations_s.append(duration_s)
        loaded.frame_statuses[status] = (
            loaded.frame_statuses.get(status, 0) + 1)
    if first_us is not None and last_us is not None:
        loaded.wall_s = max((last_us - first_us) / 1e6, 0.0)


def _join(loaded: LoadedTrace) -> None:
    """Attribute every profiled node to a typed graph element; surface
    both directions of mismatch."""
    if loaded.definition is None:
        if loaded.elements and loaded.definition_document is None:
            loaded.diagnostic(
                "AIKO503",
                f"{len(loaded.elements)} profiled node(s) cannot be "
                f"joined: no definition available")
        return
    declared = {element.name for element
                in loaded.definition.elements}
    for name in sorted(loaded.elements):
        if name not in declared:
            if loaded.elements[name].is_gateway:
                # the serving tier is not a graph element by design:
                # its spans classify the admission-bound floor
                continue
            loaded.diagnostic(
                "AIKO503",
                f"trace span node {name!r} is not an element of "
                f"definition {loaded.definition.name!r}")
    for name in sorted(declared):
        if name not in loaded.elements:
            # declared but never observed: keep an empty profile so
            # the classifier reports it as unobserved instead of
            # omitting it from the report
            loaded.elements[name] = ElementProfile(name)
            loaded.diagnostic(
                "AIKO503",
                f"element {name!r} produced no spans in this trace")
