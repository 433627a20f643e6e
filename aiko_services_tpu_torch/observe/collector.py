# Fleet trace collector + merger: many per-process Perfetto artifacts
# -> ONE clock-aligned, parent-linked timeline.
#
# Every process exports its own artifact (bench.py --trace per-config
# files, `pipeline.telemetry.export_trace`, the gateway's
# `telemetry.export_trace`, or the live `(publish_trace ...)` wire
# query), each timed against its OWN perf_counter epoch.  Merging has
# two jobs:
#
#   clock calibration   every artifact's metadata records
#                       `clock_epoch_unix_us` -- the wall-clock moment
#                       of that process's trace timestamp 0
#                       (observe/trace.clock_epoch_unix_us).  The
#                       merger picks the EARLIEST epoch as the shared
#                       reference and shifts every other artifact's
#                       timestamps by (epoch - reference), so spans
#                       concurrent in wall time stay concurrent on the
#                       merged timeline.  Artifacts without an epoch
#                       (pre-fleet traces, foreign tools) merge at
#                       offset 0 with a diagnostic note.
#   identity            synthetic tracer pids are unique per process
#                       but CAN collide across hosts; colliding pids
#                       are deterministically remapped.  Cross-process
#                       parenting needs no rewriting: frame spans carry
#                       their own `span_id` and the propagated
#                       `parent` span id in args (observe/trace.py
#                       taxonomy), both stable under the merge.
#
# Determinism contract: merging the same inputs in the same order is
# BYTE-identical (sorted events, sorted JSON keys, no timestamps or
# environment reads beyond the artifacts themselves), so CI diffs two
# merges of one bench run to prove it.

from __future__ import annotations

import json

from .metrics import merge_snapshots
from .trace import TRACE_METADATA_SCHEMA, trace_metadata_of

__all__ = ["collect_traces", "merge_trace_documents",
           "merge_trace_files", "publish_trace_document",
           "trace_summary", "unique_source_name"]


def unique_source_name(seen: dict, name: str) -> str:
    """Deterministic collision suffixing for merge-source names: two
    distinct sources flattening to one name (same artifact basename on
    two hosts, topic paths collapsing under '/'->'_') must not
    overwrite each other's file or `merged` provenance record.  `seen`
    is the caller's running {name: count} map."""
    count = seen.get(name, 0)
    seen[name] = count + 1
    return f"{name}~{count}" if count else name


def publish_trace_document(process, telemetry, topic_path: str,
                           topic_response) -> None:
    """THE `(publish_trace ...)` reply shape, shared by Pipeline and
    Gateway: publish the actor's self-describing Perfetto document as
    `(trace <topic_path> <json-document>)` on `topic_response`.  JSON
    text, not a nested sexpr tree -- the wire codec would stringify
    every number and the merger needs exact types."""
    from ..utils import generate
    from .trace import chrome_trace_document
    document = chrome_trace_document(
        telemetry.chrome_events(), metadata=telemetry.trace_metadata())
    process.publish(
        str(topic_response),
        generate("trace", [topic_path,
                           json.dumps(document).encode("ascii")]))


def _doc_epoch(metadata: dict | None) -> float | None:
    if not isinstance(metadata, dict):
        return None
    epoch = metadata.get("clock_epoch_unix_us")
    if isinstance(epoch, (int, float)):
        return float(epoch)
    # combined legacy artifacts keep per-run metadata under "runs":
    # the earliest run epoch stands in for the document
    runs = metadata.get("runs")
    if isinstance(runs, dict):
        epochs = [run.get("clock_epoch_unix_us")
                  for run in runs.values() if isinstance(run, dict)]
        epochs = [float(value) for value in epochs
                  if isinstance(value, (int, float))]
        if epochs:
            return min(epochs)
    return None


def _doc_pids(document: dict) -> list:
    pids = set()
    for event in document.get("traceEvents") or []:
        if isinstance(event, dict) and isinstance(
                event.get("pid"), int):
            pids.add(event["pid"])
    return sorted(pids)


def _event_sort_key(event: dict) -> tuple:
    args = event.get("args")
    return (
        0 if event.get("ph") == "M" else 1,
        float(event.get("ts", 0.0) or 0.0),
        int(event.get("pid", 0) or 0),
        int(event.get("tid", 0) or 0),
        str(event.get("name", "")),
        json.dumps(args, sort_keys=True, default=str)
        if args is not None else "",
    )


def merge_trace_documents(named_documents: list) -> dict:
    """[(source_name, chrome_trace_document), ...] -> ONE merged
    document.  Callers pass inputs in a stable order (the CLI sorts
    file paths); the output is then byte-deterministic."""
    reference = None
    prepared = []
    for name, document in named_documents:
        if not isinstance(document, dict) or not isinstance(
                document.get("traceEvents"), list):
            raise ValueError(
                f"{name}: not a Chrome-trace document "
                f"(no traceEvents list)")
        metadata = trace_metadata_of(document)
        epoch = _doc_epoch(metadata)
        prepared.append((str(name), document, metadata, epoch))
        if epoch is not None:
            reference = epoch if reference is None \
                else min(reference, epoch)
    if reference is None:
        reference = 0.0

    used_pids: set = set()
    merged_events: list = []
    merged_sources: dict = {}
    merged_metrics: dict = {}
    definition = None
    fingerprint = ""
    config = None
    config_name = ""
    unaligned = []
    collisions: dict = {}
    all_pids: set = set()
    for name, document, metadata, epoch in prepared:
        offset_us = (epoch - reference) if epoch is not None else 0.0
        if epoch is None:
            unaligned.append(name)
        pid_map: dict = {}
        # trace/span ids embed the minting tracer's pid
        # ({pid:x}-{seq:x} / {pid:x}.{seq:x}), so a remapped pid must
        # also rewrite THIS document's OWN id strings or two unrelated
        # hosts with colliding pids would read as one trace.  Only ids
        # this document minted are rewritten: every span_id (frame
        # spans mint their own), and trace_ids of traces ROOTED here
        # (no `parent` on the frame span).  An ADOPTED trace's id and
        # every `parent` were minted upstream -- rewriting those would
        # sever the cross-process links this merger exists to keep
        # (the propagating process keeps the original strings).  A
        # reference REACHING a remapped document from another document
        # is inherently ambiguous (the same string names the
        # un-remapped twin too), so the collision is flagged in
        # metadata instead of guessed at
        id_rewrites: dict = {}
        for pid in _doc_pids(document):
            if pid in used_pids:
                fresh = max(used_pids) + 1
                while fresh in used_pids:
                    fresh += 1
                pid_map[pid] = fresh
                used_pids.add(fresh)
                id_rewrites[f"{pid:x}"] = f"{fresh:x}"
                collisions.setdefault(pid, []).append(str(name))
            else:
                pid_map[pid] = pid
                used_pids.add(pid)
        all_pids.update(pid_map.values())
        foreign_traces: set = set()
        if id_rewrites:
            # trace ids carried by an adopted (parented) frame span
            # were minted by the UPSTREAM process: every event of that
            # trace keeps the foreign id
            for event in document.get("traceEvents") or []:
                if not isinstance(event, dict) \
                        or event.get("cat") != "frame":
                    continue
                args = event.get("args")
                if isinstance(args, dict) and args.get("parent") \
                        and args.get("trace_id"):
                    foreign_traces.add(str(args["trace_id"]))
        for event in document.get("traceEvents") or []:
            if not isinstance(event, dict):
                continue
            rewritten = dict(event)
            pid = rewritten.get("pid")
            if isinstance(pid, int) and pid in pid_map:
                rewritten["pid"] = pid_map[pid]
            ts = rewritten.get("ts")
            if isinstance(ts, (int, float)):
                rewritten["ts"] = round(float(ts) + offset_us, 3)
            args = rewritten.get("args")
            if id_rewrites and isinstance(args, dict) and args:
                patched = None
                for key, separator in (("trace_id", "-"),
                                       ("span_id", ".")):
                    value = args.get(key)
                    if not isinstance(value, str) \
                            or separator not in value:
                        continue
                    if key == "trace_id" and value in foreign_traces:
                        continue
                    prefix, rest = value.split(separator, 1)
                    fresh_hex = id_rewrites.get(prefix)
                    if fresh_hex is None:
                        continue
                    if patched is None:
                        patched = dict(args)
                    patched[key] = f"{fresh_hex}{separator}{rest}"
                if patched is not None:
                    rewritten["args"] = patched
            merged_events.append(rewritten)
        source: dict = {
            "offset_us": round(offset_us, 3),
            "pids": sorted(pid_map.values()),
        }
        if epoch is not None:
            source["clock_epoch_unix_us"] = round(epoch, 3)
        if isinstance(metadata, dict):
            if metadata.get("role"):
                source["role"] = metadata["role"]
            if metadata.get("config_name"):
                source["config_name"] = metadata["config_name"]
            metrics = metadata.get("metrics")
            if isinstance(metrics, dict):
                merged_metrics = merge_snapshots(merged_metrics,
                                                 metrics)
            if definition is None and isinstance(
                    metadata.get("definition"), dict):
                # the first (in caller order) definition-carrying
                # artifact donates the graph the tune loader joins
                # element spans against; gateway artifacts carry none
                definition = metadata["definition"]
                fingerprint = metadata.get("fingerprint") or ""
                config = metadata.get("config")
                config_name = metadata.get("config_name") or ""
        merged_sources[str(name)] = source

    merged_events.sort(key=_event_sort_key)
    metadata: dict = {
        "schema": TRACE_METADATA_SCHEMA,
        "clock_epoch_unix_us": round(reference, 3),
        "merged": merged_sources,
        "pids": sorted(all_pids),
    }
    if definition is not None:
        metadata["definition"] = definition
        if fingerprint:
            metadata["fingerprint"] = fingerprint
    if config is not None:
        metadata["config"] = config
    if config_name:
        metadata["config_name"] = config_name
    if merged_metrics:
        metadata["metrics"] = merged_metrics
    if unaligned:
        metadata["unaligned_sources"] = sorted(unaligned)
    if collisions:
        # cross-document references into a remapped source cannot be
        # disambiguated (the colliding twin owns the same id strings):
        # consumers must treat parent links touching these pids as
        # unreliable
        metadata["pid_collisions"] = {
            str(pid): sorted(names)
            for pid, names in sorted(collisions.items())}
    return {"traceEvents": merged_events, "displayTimeUnit": "ms",
            "metadata": {"aiko": metadata}}


def merge_trace_files(paths: list, output: str | None = None) -> dict:
    """Merge trace artifacts from disk (inputs sorted by basename then
    path, so the SAME file set always merges byte-identically) and
    optionally write the merged document with sorted keys."""
    import os
    ordered = sorted(paths, key=lambda path: (os.path.basename(path),
                                              path))
    named = []
    seen: dict = {}
    for path in ordered:
        name = unique_source_name(seen, os.path.basename(path))
        with open(path) as handle:
            named.append((name, json.load(handle)))
    merged = merge_trace_documents(named)
    if output:
        with open(output, "w") as handle:
            json.dump(merged, handle, sort_keys=True,
                      separators=(",", ":"))
    return merged


def trace_summary(document: dict) -> dict:
    """Quick shape check of a (merged) artifact: per-trace-id process
    counts and cross-process link integrity -- what the CI trace step
    asserts instead of eyeballing Perfetto."""
    span_ids = set()
    links = []            # (child label, parent span id)
    trace_pids: dict = {}  # trace_id -> set of pids
    categories: dict = {}
    last_end_us = 0.0
    for event in document.get("traceEvents") or []:
        if not isinstance(event, dict) or event.get("ph") not in (
                "X", "i"):
            continue
        category = str(event.get("cat", ""))
        categories[category] = categories.get(category, 0) + 1
        ts = float(event.get("ts", 0.0) or 0.0)
        last_end_us = max(last_end_us,
                          ts + float(event.get("dur", 0.0) or 0.0))
        args = event.get("args") or {}
        trace_id = args.get("trace_id")
        if trace_id:
            trace_pids.setdefault(str(trace_id), set()).add(
                event.get("pid"))
        span_id = args.get("span_id")
        if span_id:
            span_ids.add(str(span_id))
        parent = args.get("parent")
        if parent:
            # spans without their own span_id (adopt spans) still
            # carry cross-process parent links -- label them by name
            # so a broken link never hides from dangling_parents
            child = (str(span_id) if span_id
                     else f"{event.get('name', '')}@{ts}")
            links.append((child, str(parent)))
    max_processes = max((len(pids) for pids in trace_pids.values()),
                        default=0)
    dangling = sorted({child for child, parent in links
                       if parent not in span_ids})
    return {
        "traces": len(trace_pids),
        "max_processes_per_trace": max_processes,
        "multi_process_traces": sum(
            1 for pids in trace_pids.values() if len(pids) >= 2),
        "linked_spans": len(links),
        "dangling_parents": dangling,
        "categories": dict(sorted(categories.items())),
        "span_end_max_us": round(last_end_us, 3),
    }


def collect_traces(process, wait: float = 3.0,
                   protocols: tuple = ("pipeline", "gateway"),
                   targets=None) -> dict:
    """Harvest live per-process trace documents over the control
    plane: discover every pipeline/gateway service through the shared
    ServicesCache (or query the explicit `targets` topic paths and
    skip discovery), send each `(publish_trace <response_topic>)`,
    and gather the `(trace <source> <document>)` replies.  Returns
    {source_topic_path: document} -- feed `.items()` (sorted) to
    merge_trace_documents.

    `wait` is a DEADLINE, not a sleep: once every queried service has
    replied the collector returns immediately (a healthy fleet pays
    round-trip latency, not the timeout).  `collector.responses` /
    `collector.timeouts` counters in the process-global registry make
    partial harvests visible instead of silent."""
    import threading

    from ..utils import generate, parse
    from .metrics import get_registry

    response_topic = f"{process.topic_path_process}/trace_collect"
    collected: dict = {}
    lock = threading.Lock()
    registry = get_registry()

    def on_trace(topic, payload):
        try:
            command, parameters = parse(payload)
        except ValueError:
            return
        if command != "trace" or len(parameters) < 2:
            return
        source, document = str(parameters[0]), parameters[1]
        if isinstance(document, (str, bytes)):
            # documents travel as JSON text (exact numeric types)
            try:
                document = json.loads(document)
            except ValueError:
                return
        if isinstance(document, dict):
            with lock:
                if source not in collected:
                    registry.counter("collector.responses").inc()
                collected[source] = document

    process.add_message_handler(on_trace, response_topic)
    queried: set = set()
    handlers = []
    cache = None
    if targets is not None:
        for topic_path in targets:
            topic_path = str(topic_path)
            if topic_path not in queried:
                queried.add(topic_path)
                process.publish(
                    f"{topic_path}/in",
                    generate("publish_trace", [response_topic]))
    else:
        from ..runtime import ServiceFilter
        from ..runtime.service import SERVICE_PROTOCOL_PIPELINE
        from ..runtime.share import services_cache_create_singleton
        from ..serve import SERVICE_PROTOCOL_GATEWAY
        wanted = {
            "pipeline": SERVICE_PROTOCOL_PIPELINE,
            "gateway": SERVICE_PROTOCOL_GATEWAY,
        }
        cache = services_cache_create_singleton(process)

        def handler(command, fields):
            if command == "add" and fields.topic_path not in queried:
                queried.add(fields.topic_path)
                process.publish(
                    f"{fields.topic_path}/in",
                    generate("publish_trace", [response_topic]))

        for kind in protocols:
            protocol = wanted.get(kind)
            if protocol is None:
                continue
            service_filter = ServiceFilter(protocol=protocol)
            cache.add_handler(handler, service_filter)
            handlers.append((handler, service_filter))
    import time as _time
    start = _time.monotonic()
    deadline = start + max(wait, 0.0)
    # early return needs a CLOSED respondent set: explicit targets are
    # closed by construction; under discovery the set only grows, so a
    # short grace keeps a service registering right behind the first
    # batch from being cut off before it is even queried
    grace = 0.0 if targets is not None else min(max(wait, 0.0), 0.5)
    while _time.monotonic() < deadline:
        with lock:
            answered = len(collected)
        expected = len(queried)
        if expected and answered >= expected \
                and _time.monotonic() - start >= grace:
            break
        _time.sleep(0.01)
    for added, _filter in handlers:
        try:
            cache.remove_handler(added)
        except Exception:
            pass
    process.remove_message_handler(on_trace, response_topic)
    with lock:
        missing = len(queried) - len(collected)
        if missing > 0:
            registry.counter("collector.timeouts").inc(missing)
        return dict(collected)
