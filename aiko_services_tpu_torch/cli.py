# Console entry points: `python -m aiko_services_tpu_torch <command>`.
#
# The port's counterpart of the JAX package's cli.py: the same commands
# (registrar, pipeline, storage, recorder, dashboard, lint, deadletter
# ls|replay, tune, trace merge|collect, bench, system start|stop|status,
# bootstrap), options and printed lines, written on argparse instead of
# click -- the machine with the card has no click, and
# serve/autoscale.py's ProcessReplicaFactory spawns every OS-process
# replica through this module.  Exit codes follow click's: 2 for a usage
# error, 1 for a command error ("Error: ..." on stderr).

from __future__ import annotations

import argparse
import sys

__all__ = ["main", "fetch_dead_letters", "replay_dead_letter",
           "DEFAULT_STATE_FILE"]


class CommandError(Exception):
    """A command's failure: "Error: <message>" on stderr, exit 1."""


def _echo(text: str = "", err: bool = False) -> None:
    print(text, file=sys.stderr if err else sys.stdout, flush=True)


def _flag_pair(parser, name: str, dest: str, default: bool,
               help: str | None = None) -> None:
    """click's `--name/--no-name` boolean option."""
    parser.add_argument(f"--{name}", dest=dest, action="store_true",
                        help=help)
    parser.add_argument(f"--no-{name}", dest=dest, action="store_false")
    parser.set_defaults(**{dest: default})


def _existing_path(value: str) -> str:
    import os
    if not os.path.exists(value):
        raise argparse.ArgumentTypeError(f"path {value!r} does not exist")
    return value


def _existing_dir(value: str) -> str:
    import os
    if not os.path.isdir(value):
        raise argparse.ArgumentTypeError(
            f"directory {value!r} does not exist")
    return value


# -- services -----------------------------------------------------------------

def registrar(args) -> None:
    """Run a service-discovery registrar."""
    from .runtime import Process, Registrar
    process = Process(transport_kind=args.transport)
    Registrar(process, name=args.name)
    process.run()


def pipeline(args) -> None:
    """Create and run a pipeline from a JSON definition (reference
    `aiko_pipeline create`).

    Elastic-fleet children honor two env knobs set by the replica
    factory (serve/autoscale.py): AIKO_COMPILE_CACHE points the kernel
    builds at the fleet's shared build cache (runtime/compile_cache.py),
    and AIKO_WARM_WEIGHTS names a descriptor file whose tensors are
    fetched from a live sibling over the transfer plane instead of
    re-running setup()."""
    import json
    import os

    from .pipeline import create_pipeline
    from .runtime import Process, enable_compile_cache
    enable_compile_cache()  # no-op unless AIKO_COMPILE_CACHE is set
    process = Process(transport_kind=args.transport)
    pipeline_instance = create_pipeline(process, args.definition,
                                        name=args.name)
    warm_weights = os.environ.get("AIKO_WARM_WEIGHTS")
    if warm_weights:
        # a failed hand-off (expired transfer keys, drained sibling)
        # downgrades to a COLD start -- setup() runs lazily as usual;
        # dying here would turn a scale-up into a failed spawn
        try:
            with open(warm_weights) as handoff:
                installed = pipeline_instance.import_weights(
                    json.load(handoff))
            _echo(f"warm start: imported weights for {installed}")
        except Exception as error:
            _echo(f"warm start failed ({error}); starting cold", err=True)
        finally:
            try:  # one-shot descriptor file from the replica factory
                os.unlink(warm_weights)
            except OSError:
                pass
    if args.stream_id is not None:
        pipeline_instance.create_stream(
            args.stream_id, parameters=json.loads(args.stream_parameters),
            grace_time=args.grace_time)
        if args.frame_data is not None:
            pipeline_instance.process_frame(
                {"stream_id": args.stream_id}, json.loads(args.frame_data))
    process.run()


def storage(args) -> None:
    """Run a sqlite storage service."""
    from .runtime import Process, Storage
    process = Process(transport_kind=args.transport)
    Storage(process, name=args.name, database_path=args.database)
    process.run()


def recorder(args) -> None:
    """Run a log-aggregation recorder service."""
    from .runtime import Process, Recorder
    process = Process(transport_kind=args.transport)
    Recorder(process, name=args.name, log_topic_pattern=args.topic)
    process.run()


def dashboard(args) -> None:
    """Service dashboard: curses TUI, or --snapshot for plain text."""
    from .dashboard import run_dashboard
    run_dashboard(transport_kind=args.transport, snapshot=args.snapshot,
                  wait=args.wait)


# -- lint ---------------------------------------------------------------------

def lint(args) -> None:
    """Statically verify pipeline definitions (analyze/ subsystem).

    SOURCES are definition JSON files or directories (searched
    recursively for *.json).  Four passes: graph/port dataflow
    (AIKO1xx), tensor-spec shape/dtype flow (AIKO2xx, the eval pass
    running each element on PyTorch's meta device), element/actor
    safety (AIKO3xx), and policy grammars (AIKO4xx).  With --code,
    SOURCES are Python files/trees and the AIKO6xx static concurrency
    pass runs instead.  Exit status: 0 clean, 1 findings (with
    --strict, warnings count), 2 usage error."""
    from pathlib import Path

    from .analyze import ALL_PASSES, AnalysisReport, analyze_definition

    if args.code_mode:
        sys.exit(_lint_code(args.sources, args.strict, args.fmt,
                            args.output, args.baseline,
                            args.update_baseline))
    if args.baseline or args.update_baseline:
        _echo("--baseline/--update-baseline need --code", err=True)
        sys.exit(2)

    passes = (tuple(part.strip() for part in args.passes_option.split(",")
                    if part.strip())
              if args.passes_option else ALL_PASSES)
    unknown = [name for name in passes if name not in ALL_PASSES]
    if unknown:
        _echo(f"unknown passes: {unknown} (valid: {ALL_PASSES})", err=True)
        sys.exit(2)

    if args.golden is not None:
        sys.exit(_lint_golden(Path(args.golden), passes))

    targets: list = []
    for source in args.sources:
        path = Path(source)
        if path.is_dir():
            targets.extend(sorted(path.rglob("*.json")))
        else:
            targets.append(path)
    if args.bench_configs:
        # bench.py is the JAX package's benchmark: the port runs none of it
        _echo(f"--bench: {_NO_BENCHMARK}", err=True)
        sys.exit(2)
    if not targets:
        _echo("nothing to lint (give files, directories, or --bench)",
              err=True)
        sys.exit(2)

    report = AnalysisReport()
    for target in targets:
        if isinstance(target, tuple):
            label, source = target
        else:
            label, source = str(target), target
        report.extend(analyze_definition(source, passes=passes,
                                         source_path=label))
    rendered = report.to_json() if args.fmt == "json" else report.render()
    _echo(rendered)
    if args.output:
        Path(args.output).write_text(
            rendered if rendered.endswith("\n") else rendered + "\n")
    sys.exit(1 if report.failures(strict=args.strict) else 0)


def _lint_code(sources, strict, fmt, output, baseline,
               update_baseline) -> int:
    """`lint --code`: the AIKO6xx static concurrency pass over Python
    source trees, optionally diffed against a committed baseline of
    accepted findings.  Returns the exit status."""
    from pathlib import Path

    from .analyze import (
        apply_baseline, load_baseline, run_code_pass, write_baseline)

    if not sources:
        _echo("nothing to lint (give Python files or directories)",
              err=True)
        return 2
    missing = [source for source in sources if not Path(source).exists()]
    if missing:
        _echo(f"no such path(s): {missing}", err=True)
        return 2
    report = run_code_pass([Path(source) for source in sources])
    if update_baseline:
        if not baseline:
            _echo("--update-baseline needs --baseline PATH", err=True)
            return 2
        count = write_baseline(baseline, report)
        _echo(f"baseline written: {count} accepted finding(s) -> "
              f"{baseline}")
        return 0
    if baseline:
        try:
            entries = load_baseline(baseline)
        except (OSError, ValueError) as error:
            _echo(f"cannot read baseline: {error}", err=True)
            return 2
        filtered = apply_baseline(report, entries)
        _echo(f"baseline: {filtered} accepted finding(s) filtered",
              err=True)
    rendered = report.to_json() if fmt == "json" else report.render()
    _echo(rendered)
    if output:
        Path(output).write_text(
            rendered if rendered.endswith("\n") else rendered + "\n")
    return 1 if report.failures(strict=strict) else 0


def _lint_golden(corpus, passes) -> int:
    """Golden-corpus mode: every `<code>_*.json` in the corpus must
    yield a finding with that code -- the proof each lint rule still
    fires.  `<code>_*.py` fixtures run through the AIKO6xx concurrency
    pass the same way.  Returns the exit status."""
    from .analyze import RULES, analyze_definition, run_code_pass

    failures = 0
    checked = 0
    for path in sorted(corpus.glob("*.json")) + sorted(corpus.glob("*.py")):
        expected = path.stem.split("_", 1)[0].upper()
        if expected not in RULES:
            _echo(f"SKIP {path.name}: no rule code prefix")
            continue
        checked += 1
        if path.suffix == ".py":
            report = run_code_pass([path], root=corpus)
        else:
            report = analyze_definition(path, passes=passes,
                                        source_path=str(path))
        codes = {diagnostic.code for diagnostic in report.findings}
        if expected in codes:
            _echo(f"ok   {path.name}: {expected} fired")
        else:
            failures += 1
            _echo(f"FAIL {path.name}: expected {expected}, got "
                  f"{sorted(codes) or 'no findings'}")
    _echo(f"{checked} golden definition(s), {failures} failure(s)")
    return 1 if failures or not checked else 0


# -- dead letters -------------------------------------------------------------

def fetch_dead_letters(process, wait: float = 3.0) -> list:
    """Drain the first discovered Recorder's dead-letter ring: decoded
    {"index", "topic", "meta", "descriptor"} records, oldest first.
    Shared by `deadletter ls|replay` and tests."""
    import json
    import threading

    from .runtime import ServiceFilter
    from .runtime.recorder import SERVICE_PROTOCOL_RECORDER
    from .runtime.storage import do_request

    done = threading.Event()
    collected: list = []

    def on_items(items):
        collected.extend(items)
        done.set()

    do_request(process, ServiceFilter(protocol=SERVICE_PROTOCOL_RECORDER),
               lambda proxy, response_topic:
               proxy.deadletters(response_topic),
               on_items)
    done.wait(wait)
    records = []
    for item in collected:
        try:
            records.append(json.loads(item))
        except (TypeError, ValueError):
            continue
    return records


def replay_dead_letter(process, record: dict, gateway_topic: str,
                       create: bool = True, grace_time: float = 60.0,
                       topic_response: str = "") -> bool:
    """Re-submit one dead-lettered frame through a gateway: optionally
    (re)create the stream (a duplicate create gets a harmless typed
    reject), then publish the EXACT embedded frame data under its
    original stream/frame identity -- the gateway's exactly-once dedupe
    makes replay idempotent.  `topic_response` routes the outcome back
    to the caller.  Returns False when the record carries no embedded
    data (it exceeded AIKO_DEAD_LETTER_DATA_MAX)."""
    import json

    from .utils import generate

    meta = record.get("meta") or {}
    data = meta.get("data")
    if not data:
        return False
    stream_id = str(meta.get("stream_id", ""))
    frame_id = meta.get("frame_id", 0)
    if create:
        process.publish(
            f"{gateway_topic}/in",
            generate("create_stream", [
                stream_id, json.dumps({}).encode("ascii"), grace_time,
                topic_response]))
    process.publish(
        f"{gateway_topic}/in",
        generate("process_frame", [
            {"stream_id": stream_id, "frame_id": frame_id},
            str(data).encode("ascii")]))
    return True


def _discover_gateway_topic(process, wait: float) -> str | None:
    import threading

    from .runtime import ServiceFilter
    from .runtime.storage import do_command
    from .serve import SERVICE_PROTOCOL_GATEWAY

    found = threading.Event()
    topics: list = []

    def on_proxy(proxy):
        # RemoteProxy exposes its /in topic; the service root is its
        # parent (any non-underscore attribute would proxy a call)
        topics.append(proxy._topic_in.rsplit("/in", 1)[0])
        found.set()

    do_command(process, ServiceFilter(protocol=SERVICE_PROTOCOL_GATEWAY),
               on_proxy)
    found.wait(wait)
    return topics[0] if topics else None


def deadletter_ls(args) -> None:
    """List the fleet's dead-lettered frames (newest last)."""
    from .runtime import Process
    process = Process(transport_kind=args.transport)
    process.run(in_thread=True)
    try:
        records = fetch_dead_letters(process, wait=args.wait)
        if not records:
            _echo("no dead letters (or no recorder discovered)")
            return
        for record in records:
            meta = record.get("meta") or {}
            _echo(f"[{record.get('index')}] {meta.get('stream_id')}"
                  f"/{meta.get('frame_id')} node={meta.get('node')} "
                  f"reason={meta.get('reason')} "
                  f"data={'yes' if meta.get('data') else 'no'} "
                  f"diag={str(meta.get('diagnostic', ''))[:60]}")
    finally:
        process.terminate()


def deadletter_replay(args) -> None:
    """Re-submit dead letter INDEX through the gateway."""
    import threading

    from .runtime import Process
    from .utils import parse
    process = Process(transport_kind=args.transport)
    process.run(in_thread=True)
    try:
        records = {record.get("index"): record
                   for record in fetch_dead_letters(process,
                                                    wait=args.wait)}
        record = records.get(args.index)
        if record is None:
            raise CommandError(f"no dead letter at index {args.index} "
                               f"(have {sorted(records)})")
        topic = args.gateway or _discover_gateway_topic(process, args.wait)
        if not topic:
            raise CommandError("no gateway given and none discovered")
        outcome = {}
        done = threading.Event()
        response_topic = (f"{process.topic_path_process}/0/"
                          f"deadletter_replay")

        def on_response(_topic, payload):
            try:
                command, parameters = parse(payload)
            except ValueError:
                return
            if command == "process_frame_response" and parameters:
                reply = (parameters[0] if isinstance(parameters[0], dict)
                         else {})
                outcome["status"] = reply.get("event") or "ok"
                done.set()
            elif command == "overloaded":
                outcome["status"] = "overloaded"
                done.set()

        process.add_message_handler(on_response, response_topic)
        if not replay_dead_letter(process, record, topic,
                                  create=args.create_stream,
                                  topic_response=response_topic):
            raise CommandError(
                "record has no embedded frame data (frame exceeded "
                "AIKO_DEAD_LETTER_DATA_MAX when it was dead-lettered)")
        done.wait(args.wait)
        _echo(f"replayed {record['meta'].get('stream_id')}"
              f"/{record['meta'].get('frame_id')} via {topic}: "
              f"{outcome.get('status', 'no response within wait')}")
    finally:
        process.terminate()


# -- tune ---------------------------------------------------------------------

def tune(args) -> None:
    """Profile-guided pipeline optimizer: classify each element's
    dominant floor (dispatch / compute / queue / compile-bound) from a
    recorded trace joined against the static graph, recommend concrete
    settings for the stated SLO, and what-if replay them -- no card
    needed (tune/ subsystem).

    TRACE is a Perfetto artifact from PipelineTelemetry.export_trace;
    `--live TOPIC` harvests one over the wire instead.  Exit status: 0
    report produced, 1 --apply produced a definition that fails lint, 2
    the trace cannot be joined (no metadata and no --definition) or not
    harvested."""
    from pathlib import Path

    from .analyze.grammar import GrammarError
    from .tune import (
        SloSpec, TraceLoadError, render_report, report_json, run_tune)

    trace, live = args.trace, args.live
    definition_path, run_name = args.definition_path, args.run_name
    what_if, apply_path = args.what_if, args.apply_path
    if (trace is None) == (live is None):
        _echo("give exactly one trace source: a TRACE artifact path or "
              "--live TOPIC", err=True)
        sys.exit(2)
    if live is not None and what_if is not None:
        # what-if replays a SPECIFIC recorded trace under explicit
        # settings; a live harvest is point-in-time and unrepeatable,
        # so the comparison would be against a moving target
        _echo("--what-if needs a trace artifact (record one with "
              "export_trace), not --live", err=True)
        sys.exit(2)
    if what_if is not None and apply_path is not None:
        # --what-if scores EXPLICIT settings (no recommender), so there
        # is nothing to apply -- silently ignoring --apply would hand a
        # success exit code and no output file
        _echo("--what-if and --apply are mutually exclusive: what-if "
              "scores explicit settings without producing "
              "recommendations to apply", err=True)
        sys.exit(2)
    try:
        slo_spec = SloSpec.parse(args.slo)
    except GrammarError as error:
        _echo(f"bad --slo spec: {error}", err=True)
        sys.exit(2)
    static_costs = {} if args.no_flops else None
    loaded = None
    try:
        if live is not None:
            # the gateway autopilot's exact harvest+merge+tune path
            # (serve/autopilot.py), run once from the shell
            from .runtime import Process
            from .serve.autopilot import harvest_documents, tune_documents
            process = Process(transport_kind=args.transport)
            process.run(in_thread=True)
            try:
                targets = None if live == "discover" else [live]
                named = harvest_documents(process, wait=args.wait,
                                          targets=targets)
            finally:
                process.terminate()
            if not named:
                _echo(f"no traces harvested: nothing answered "
                      f"publish_trace within {args.wait:g}s "
                      f"({'discovery' if live == 'discover' else live})",
                      err=True)
                sys.exit(2)
            if apply_path is not None:
                # one parse serves both the report and the apply
                from .observe import merge_trace_documents
                from .tune import load_trace
                loaded = load_trace(
                    "live", definition=definition_path, run=run_name,
                    document=merge_trace_documents(list(named)))
                report = run_tune("live", slo_spec=slo_spec, loaded=loaded,
                                  static_costs=static_costs)
            else:
                report = tune_documents(
                    named, slo_spec=slo_spec, definition=definition_path,
                    run=run_name, static_costs=static_costs)
        elif what_if is not None:
            report = _tune_what_if(trace, slo_spec, definition_path,
                                   run_name, what_if,
                                   static_costs=static_costs)
        else:
            if apply_path is not None:
                from .tune import load_trace
                loaded = load_trace(trace, definition=definition_path,
                                    run=run_name)
            report = run_tune(trace, slo_spec=slo_spec,
                              definition=definition_path, run=run_name,
                              static_costs=static_costs, loaded=loaded)
    except TraceLoadError as error:
        _echo(str(error), err=True)
        sys.exit(2)
    if not report.get("pipeline") and what_if is None:
        # nothing joined: the trace carries spans but no definition --
        # fail loudly instead of printing floors that cannot be
        # attributed to typed nodes
        for diagnostic in report.get("diagnostics", []):
            _echo(f"{diagnostic['code']}: {diagnostic['message']}",
                  err=True)
        _echo("trace not joined to a definition: give --definition for "
              "a metadata-absent trace (or --run for a combined one)",
              err=True)
        sys.exit(2)
    rendered = report_json(report) if args.as_json else render_report(report)
    _echo(rendered)
    if args.output:
        Path(args.output).write_text(
            rendered if rendered.endswith("\n") else rendered + "\n")
    if apply_path is not None and what_if is None:
        sys.exit(_tune_apply(loaded, report, apply_path))


_WHAT_IF_ELEMENT_KNOBS = ("micro_batch", "decode_slots", "kv_block_size")
_WHAT_IF_PIPELINE_KNOBS = ("frame_window", "replicas")


def _parse_what_if(spec: str, element_names) -> dict:
    """'element.knob=value;knob=value' -> replay overrides.  Unknown
    elements/knobs are usage errors: a typo'd override would otherwise
    be silently ignored and the what-if replay would print baseline
    numbers as the proposed score."""
    overrides: dict = {"elements": {}}
    for part in str(spec).split(";"):
        part = part.strip()
        if not part:
            continue
        key, _, value = part.partition("=")
        try:
            number = int(value)
        except ValueError:
            raise CommandError(f"--what-if value {value!r} is not an "
                               f"integer (in {part!r})") from None
        if "." in key:
            element, knob = (token.strip() for token in key.split(".", 1))
            if element not in element_names:
                raise CommandError(
                    f"--what-if names unknown element {element!r} "
                    f"(trace has {sorted(element_names)})")
            if knob not in _WHAT_IF_ELEMENT_KNOBS:
                raise CommandError(
                    f"--what-if element knob {knob!r} is not one of "
                    f"{_WHAT_IF_ELEMENT_KNOBS}")
            overrides["elements"].setdefault(element, {})[knob] = number
        else:
            knob = key.strip()
            if knob not in _WHAT_IF_PIPELINE_KNOBS:
                raise CommandError(
                    f"--what-if knob {knob!r} is not one of "
                    f"{_WHAT_IF_PIPELINE_KNOBS} (element knobs are "
                    f"'element.knob=value')")
            overrides[knob] = number
    return overrides


def _tune_what_if(trace, slo_spec, definition_path, run_name, what_if,
                  static_costs=None) -> dict:
    """Score explicit settings against the recorded cost model -- no
    recommender in the loop, so CI can pin pure replay determinism."""
    from .tune import (
        CostModel, build_report, classify_elements, element_settings_of,
        load_trace, predict)
    loaded = load_trace(trace, definition=definition_path, run=run_name)
    if static_costs is None:
        static_costs = {}
        if loaded.definition is not None:
            from .analyze.shape_eval import element_cost_estimates
            try:
                static_costs = element_cost_estimates(loaded.definition)
            except Exception:
                static_costs = {}
    model = CostModel.from_trace(
        loaded, static_costs=static_costs,
        dispatch_floor_s=slo_spec.dispatch_floor_s,
        peak_flops=slo_spec.peak_flops)
    classify_elements(model)
    settings = element_settings_of(loaded.definition_document)
    baseline = predict(model, settings)
    overrides = _parse_what_if(what_if, set(loaded.elements))
    proposed = predict(model, settings, overrides)
    return build_report(loaded, model, slo_spec, [], baseline, proposed)


def _tune_apply(loaded, report, apply_path) -> int:
    """Write the tuned definition (from the ALREADY-loaded trace) and
    re-lint it.  Returns the exit status (0 clean, 1 the applied
    definition fails lint)."""
    import json
    from pathlib import Path

    from .analyze import analyze_definition
    from .tune import Recommendation, apply_recommendations

    if loaded is None or loaded.definition_document is None:
        _echo("--apply needs a definition (embedded metadata or "
              "--definition)", err=True)
        return 2
    recommendations = [
        Recommendation(**{key: record[key] for key in
                          ("target", "knob", "current", "proposed",
                           "reason", "floor", "evidence")})
        for record in report.get("recommendations", [])]
    document, diagnostics = apply_recommendations(
        loaded.definition_document, recommendations)
    for diagnostic in diagnostics:
        _echo(diagnostic.render(), err=True)
    lint_report = analyze_definition(document, passes=("graph", "policy"))
    Path(apply_path).write_text(json.dumps(document, indent=2) + "\n")
    failures = lint_report.failures()
    if failures:
        _echo(f"applied definition FAILS lint ({len(failures)} "
              f"error(s)):", err=True)
        for diagnostic in failures:
            _echo(f"  {diagnostic.render()}", err=True)
        return 1
    _echo(f"applied {len(recommendations)} recommendation(s) -> "
          f"{apply_path} (lint clean)")
    return 0


# -- trace --------------------------------------------------------------------

def trace_merge(args) -> None:
    """Merge trace artifacts into OUTPUT.  Inputs are sorted (basename,
    path) before merging, so the same file set always produces
    byte-identical output."""
    from .observe import merge_trace_files, trace_summary
    try:
        merged = merge_trace_files(list(args.inputs), output=args.output)
    except (OSError, ValueError) as error:
        _echo(f"merge failed: {error}", err=True)
        sys.exit(2)
    summary = trace_summary(merged)
    _echo(f"merged {len(args.inputs)} artifact(s) -> {args.output}: "
          f"{len(merged['traceEvents'])} events, "
          f"{summary['traces']} trace(s), "
          f"{summary['multi_process_traces']} crossing processes "
          f"(max {summary['max_processes_per_trace']} processes/trace), "
          f"{summary['linked_spans']} parent-linked span(s)")
    if summary["dangling_parents"]:
        _echo(f"warning: {len(summary['dangling_parents'])} span(s) name "
              f"a parent outside the merged set (partial harvest?)",
              err=True)


def trace_collect(args) -> None:
    """Harvest every live pipeline/gateway's trace document over the
    control plane into per-process files, optionally merged."""
    import json
    from pathlib import Path

    from .observe import collect_traces, merge_trace_documents
    from .observe.collector import unique_source_name
    from .runtime import Process
    process = Process(transport_kind=args.transport)
    process.run(in_thread=True)
    try:
        collected = collect_traces(process, wait=args.wait)
    finally:
        process.terminate()
    if not collected:
        _echo("no traces collected (no live pipelines/gateways "
              "discovered, or telemetry disabled)", err=True)
        sys.exit(2)
    directory = Path(args.output_dir)
    directory.mkdir(parents=True, exist_ok=True)
    named = []
    seen: dict = {}
    for source in sorted(collected):
        safe = unique_source_name(seen, source.replace("/", "_").strip("_"))
        path = directory / f"{safe}.json"
        path.write_text(json.dumps(collected[source], sort_keys=True))
        named.append((safe, collected[source]))
        _echo(f"collected {source} -> {path}")
    if args.merge_path:
        merged = merge_trace_documents(named)
        Path(args.merge_path).write_text(json.dumps(
            merged, sort_keys=True, separators=(",", ":")))
        _echo(f"merged {len(named)} artifact(s) -> {args.merge_path}")


# -- bench --------------------------------------------------------------------

_NO_BENCHMARK = ("the torch port has no benchmark yet (ROADMAP Queue A: "
                 "the port's `bench` command waits on a benchmark for the "
                 "port); python3 chip_smoke.py drives the port on the card")


def bench(args) -> None:
    """The port has no benchmark yet: exits 1 naming the ROADMAP item
    that waits on one (it never runs the JAX package's bench.py)."""
    raise CommandError(_NO_BENCHMARK)


# -- system -------------------------------------------------------------------

DEFAULT_STATE_FILE = ".aiko_system.json"


def _system_state(state_file: str) -> dict:
    import json
    from pathlib import Path
    path = Path(state_file)
    if not path.is_file():
        return {}
    try:
        return json.loads(path.read_text())
    except (OSError, ValueError):
        return {}


def _pid_alive(pid: int) -> bool:
    import os
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _pid_is_ours(pid: int) -> bool:
    """Guard against pid reuse: a state file that outlives its children
    (reboot, crash) must not let `system stop` signal whatever unrelated
    process now owns the pid.  Where /proc is unavailable the check
    passes -- liveness alone decides."""
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as handle:
            return b"aiko_services_tpu_torch" in handle.read()
    except OSError:
        return True


def system_start(args) -> None:
    """Spawn registrar (+ optional dashboard) + the DEFINITION pipeline.

    Children are detached `python -m aiko_services_tpu_torch <command>`
    processes (ProcessManager with start_new_session, so they survive
    this shell closing); the command returns immediately and `system
    stop` terminates everything it started."""
    import json
    import subprocess
    import time
    from pathlib import Path

    from .runtime import ProcessManager

    definition, name = args.definition, args.name
    transport, state_file = args.transport, args.state_file
    state = _system_state(state_file)
    alive = {service: pid for service, pid
             in (state.get("pids") or {}).items()
             if _pid_alive(pid) and _pid_is_ours(pid)}
    if alive:
        _echo(f"already running ({state_file}): {alive} -- `system stop` "
              f"first", err=True)
        sys.exit(1)

    transport_args = ["--transport", transport] if transport else []
    manager = ProcessManager()
    services = {}
    logs = {}

    def spawn(service_id, *arguments, inherit_stdio=False):
        # own log file per child: an inherited stdout/stderr would pin
        # any pipe on this shell open and die with its terminal.  The
        # curses dashboard is the exception -- it NEEDS the tty.
        command = ["-m", "aiko_services_tpu_torch", *arguments]
        if inherit_stdio:
            child = manager.spawn(service_id, sys.executable, command,
                                  use_interpreter=False,
                                  start_new_session=True)
        else:
            log_path = Path(state_file).with_suffix(
                "." + service_id.replace(":", "_") + ".log")
            with open(log_path, "ab") as log:
                child = manager.spawn(
                    service_id, sys.executable, command,
                    use_interpreter=False, start_new_session=True,
                    stdout=log, stderr=subprocess.STDOUT)
            logs[service_id] = str(log_path)
        services[service_id] = child.pid
        return child

    spawn("registrar", "registrar", *transport_args)
    pipeline_args = ["pipeline", str(Path(definition).resolve()),
                     *transport_args]
    if name:
        pipeline_args += ["--name", name]
    spawn(f"pipeline:{name or Path(definition).stem}", *pipeline_args)
    if args.with_dashboard:
        if not sys.stdout.isatty():
            _echo("--dashboard needs a terminal (curses); skipping -- "
                  "run `dashboard` instead", err=True)
        else:
            spawn("dashboard", "dashboard", *transport_args,
                  inherit_stdio=True)
    Path(state_file).write_text(json.dumps({
        "pids": services,
        "logs": logs,
        "definition": str(Path(definition).resolve()),
        "transport": transport,
        "started": time.time(),
    }, indent=2) + "\n")
    for service_id, pid in services.items():
        log_note = (f" (log {logs[service_id]})"
                    if service_id in logs else "")
        _echo(f"started {service_id}: pid {pid}{log_note}")
    _echo(f"state: {state_file} -- stop with `system stop"
          + (f" --state-file {state_file}`"
             if state_file != DEFAULT_STATE_FILE else "`"))


def system_stop(args) -> None:
    """Terminate every process `system start` recorded: SIGTERM, a grace
    wait, then SIGKILL for stragglers."""
    import os
    import signal
    import time
    from pathlib import Path

    state_file, timeout = args.state_file, args.timeout
    state = _system_state(state_file)
    pids = state.get("pids") or {}
    if not pids:
        _echo(f"nothing recorded in {state_file}", err=True)
        sys.exit(1)
    recycled = set()
    for service_id, pid in pids.items():
        if not _pid_alive(pid):
            _echo(f"{service_id}: pid {pid} already gone")
        elif not _pid_is_ours(pid):
            recycled.add(service_id)
            _echo(f"{service_id}: pid {pid} is no longer an "
                  f"aiko_services_tpu_torch process (recycled after a "
                  f"reboot?) -- leaving it alone", err=True)
        else:
            try:
                os.kill(pid, signal.SIGTERM)
                _echo(f"stopping {service_id}: pid {pid}")
            except OSError as error:
                _echo(f"stop {service_id} pid {pid}: {error}", err=True)
    deadline = time.monotonic() + timeout
    remaining = {service: pid for service, pid in pids.items()
                 if service not in recycled}
    while remaining and time.monotonic() < deadline:
        remaining = {service: pid for service, pid in remaining.items()
                     if _pid_alive(pid)}
        time.sleep(0.05)
    for service_id, pid in remaining.items():
        try:
            os.kill(pid, signal.SIGKILL)
            _echo(f"killed {service_id}: pid {pid} (no SIGTERM exit "
                  f"within {timeout}s)")
        except OSError:
            pass
    Path(state_file).unlink(missing_ok=True)
    _echo("stopped")


def _print_replica_pools(transport: str | None, wait: float) -> int:
    """Discover serving gateways through the registrar and print each
    one's replica pool (replica topic, state, load gauges, warm/cold)
    from its EC share -- rendered by the SAME plugin the dashboard uses,
    so the two views cannot drift.  Returns the number of gateways
    found."""
    import time
    from types import SimpleNamespace

    from .dashboard import _gateway_plugin
    from .runtime import Process
    from .runtime.service import ServiceFilter
    from .runtime.share import ECConsumer, services_cache_create_singleton

    process = Process(transport_kind=transport)
    gateways: dict = {}

    def handler(command, fields):
        if command == "add":
            gateways[fields.topic_path] = fields

    cache = services_cache_create_singleton(process)
    # protocols are full URLs (".../protocol/gateway:0"): the pattern
    # must match the whole string, not just the tail word
    cache.add_handler(handler, ServiceFilter(protocol="*/gateway:*"))
    process.run(in_thread=True)
    try:
        deadline = time.monotonic() + wait
        while time.monotonic() < deadline and not gateways:
            time.sleep(0.05)
        if not gateways:
            _echo(f"pool: no gateway services discovered (waited {wait}s)")
            return 0
        # snapshot: the discovery handler keeps appending from the
        # message-pump thread
        found = sorted(gateways.items())
        shares = {topic_path: {} for topic_path, _ in found}
        consumers = [ECConsumer(process, shares[topic_path], topic_path)
                     for topic_path, _ in found]
        # the pool detail rides the periodic telemetry summary
        while time.monotonic() < deadline and not all(shares.values()):
            time.sleep(0.05)
        for topic_path, fields in found:
            _echo(f"gateway {fields.name} ({topic_path})")
            model = SimpleNamespace(selected_share=shares[topic_path])
            for line in _gateway_plugin(model):
                _echo(f"  {line}")
        for consumer in consumers:
            consumer.terminate()
        return len(found)
    finally:
        process.terminate()


def system_status(args) -> None:
    """Liveness of every recorded process; --pool adds the serving
    tier's replica pools."""
    state = _system_state(args.state_file)
    pids = state.get("pids") or {}
    if not pids and not args.show_pool:
        _echo(f"nothing recorded in {args.state_file}")
        sys.exit(1)
    logs = state.get("logs") or {}
    down = 0
    for service_id, pid in pids.items():
        alive = _pid_alive(pid)
        down += 0 if alive else 1
        suffix = f"  {logs[service_id]}" if service_id in logs else ""
        _echo(f"{service_id:24} pid {pid:<8} "
              f"{'up' if alive else 'DOWN'}{suffix}")
    if args.show_pool:
        _print_replica_pools(args.transport or state.get("transport"),
                             args.wait)
    sys.exit(1 if down else 0)


# -- bootstrap ----------------------------------------------------------------

def bootstrap(args) -> None:
    """MCU bootstrap responder: answers UDP boot datagrams with the
    namespace + broker endpoint."""
    import signal
    import time

    from .utils import BootstrapResponder
    kwargs = {"mqtt_host": args.mqtt_host, "mqtt_port": args.mqtt_port}
    if args.port is not None:
        kwargs["port"] = args.port
    responder = BootstrapResponder(**kwargs)
    _echo(f"bootstrap responder on udp/{responder.port} advertising "
          f"{responder.mqtt_host}:{responder.mqtt_port}")
    stop = []
    signal.signal(signal.SIGTERM, lambda *_: stop.append(True))
    signal.signal(signal.SIGINT, lambda *_: stop.append(True))
    while not stop:
        time.sleep(0.2)
    responder.close()


# -- the parser ---------------------------------------------------------------

def _first_line(function) -> str:
    return (function.__doc__ or "").strip().split("\n")[0]


def _command(subparsers, name: str, function, **kwargs):
    parser = subparsers.add_parser(
        name, help=_first_line(function), description=function.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter, **kwargs)
    parser.set_defaults(handler=function)
    return parser


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m aiko_services_tpu_torch",
        description="aiko_services_tpu_torch: the PyTorch/CUDA port of "
                    "the distributed ML pipeline framework.")
    commands = parser.add_subparsers(dest="command", metavar="COMMAND")

    command = _command(commands, "registrar", registrar)
    command.add_argument("--name", default="registrar")
    command.add_argument("--transport", default=None,
                         help="loopback | mqtt | null (default: auto from "
                              "env)")

    command = _command(commands, "pipeline", pipeline)
    command.add_argument("definition", type=_existing_path)
    command.add_argument("--name", default=None)
    command.add_argument("--transport", default=None)
    command.add_argument("--stream-id", default=None,
                         help="Create this stream immediately")
    command.add_argument("--stream-parameters", default="{}",
                         help="JSON stream parameters")
    command.add_argument("--frame-data", default=None,
                         help="JSON frame data posted to the created "
                              "stream")
    command.add_argument("--grace-time", type=float, default=60.0)

    command = _command(commands, "storage", storage)
    command.add_argument("--name", default="storage")
    command.add_argument("--database", default="storage.db")
    command.add_argument("--transport", default=None)

    command = _command(commands, "recorder", recorder)
    command.add_argument("--name", default="recorder")
    command.add_argument("--topic", default=None, help="Log topic pattern")
    command.add_argument("--transport", default=None)

    command = _command(commands, "dashboard", dashboard)
    command.add_argument("--transport", default=None)
    command.add_argument("--snapshot", action="store_true",
                         help="Print one services-table snapshot and exit")
    command.add_argument("--wait", type=float, default=3.0,
                         help="Seconds to wait for discovery in snapshot "
                              "mode")

    command = _command(commands, "lint", lint)
    command.add_argument("sources", nargs="*")
    command.add_argument("--strict", action="store_true",
                         help="Fail on warnings too (errors always fail)")
    command.add_argument("--format", dest="fmt", choices=["text", "json"],
                         default="text")
    command.add_argument("--output", default=None,
                         help="Also write the report to this file")
    command.add_argument("--passes", dest="passes_option", default=None,
                         help="Comma-separated pass list "
                              "(graph,policy,actor,eval); default: all")
    command.add_argument("--bench", dest="bench_configs",
                         action="store_true",
                         help="Lint the benchmark's definitions (the "
                              "port has no benchmark yet: exits 2)")
    command.add_argument("--golden", default=None, type=_existing_dir,
                         help="Verify a corpus of deliberately-broken "
                              "definitions: each <code>_*.json (or "
                              "<code>_*.py for the AIKO6xx concurrency "
                              "pass) must produce that rule code")
    command.add_argument("--code", dest="code_mode", action="store_true",
                         help="Concurrency lint (AIKO6xx) over Python "
                              "SOURCE files/trees instead of pipeline "
                              "definitions")
    command.add_argument("--baseline", default=None,
                         help="(--code) accepted-findings baseline JSON")
    command.add_argument("--update-baseline", dest="update_baseline",
                         action="store_true",
                         help="(--code) rewrite --baseline from the "
                              "current findings and exit 0")

    group = commands.add_parser(
        "deadletter", help="Inspect and drain dead-lettered frames.",
        description="`ls` lists the Recorder's dead-letter ring, `replay` "
                    "re-submits a selected frame through the serving "
                    "gateway.")
    subcommands = group.add_subparsers(dest="subcommand",
                                       metavar="COMMAND")
    group.set_defaults(handler=lambda args, group=group: group.print_help())
    command = _command(subcommands, "ls", deadletter_ls)
    command.add_argument("--transport", default=None)
    command.add_argument("--wait", type=float, default=3.0,
                         help="Discovery/response wait (s)")
    command = _command(subcommands, "replay", deadletter_replay)
    command.add_argument("index", type=int)
    command.add_argument("--gateway", default=None,
                         help="Gateway topic path (default: discover one)")
    command.add_argument("--transport", default=None)
    command.add_argument("--wait", type=float, default=3.0)
    _flag_pair(command, "create", "create_stream", True,
               "Re-create the stream first (idempotent)")

    command = _command(commands, "tune", tune)
    command.add_argument("trace", nargs="?", default=None,
                         type=_existing_path)
    command.add_argument("--live", default=None, metavar="TOPIC",
                         help="Tune from a LIVE wire harvest: the service "
                              "at TOPIC, or 'discover' for every "
                              "discovered gateway/pipeline")
    command.add_argument("--transport", default=None,
                         help="Transport for --live (default: "
                              "AIKO_TRANSPORT)")
    command.add_argument("--wait", type=float, default=3.0,
                         help="Discovery/response wait for --live (s)")
    command.add_argument("--slo", default="throughput",
                         help="SLO directive: 'throughput', 'latency', or "
                              "a spec like 'slo=throughput;p99_ms=250' "
                              "(AIKO501 grammar)")
    command.add_argument("--json", dest="as_json", action="store_true",
                         help="Machine-readable report (byte-"
                              "deterministic)")
    command.add_argument("--output", default=None,
                         help="Also write the report to this file")
    command.add_argument("--definition", dest="definition_path",
                         default=None, type=_existing_path,
                         help="Side-channel definition for "
                              "metadata-absent traces")
    command.add_argument("--run", dest="run_name", default=None,
                         help="Pick one run out of a combined "
                              "multi-pipeline trace artifact")
    command.add_argument("--apply", dest="apply_path", default=None,
                         help="Write the tuned definition document here "
                              "(re-linted; lint errors fail the command)")
    command.add_argument("--what-if", dest="what_if", default=None,
                         help="Re-score the trace under explicit settings: "
                              "'asr.micro_batch=4;frame_window=8;"
                              "replicas=2'")
    command.add_argument("--no-flops", dest="no_flops",
                         action="store_true",
                         help="Skip the static FLOP/byte estimation (no "
                              "element instantiation)")

    group = commands.add_parser(
        "trace", help="Fleet-scope distributed tracing: collect and merge.",
        description="Harvest per-process Perfetto artifacts from a live "
                    "fleet (`collect`) and merge many artifacts into ONE "
                    "clock-aligned timeline (`merge`).")
    subcommands = group.add_subparsers(dest="subcommand",
                                       metavar="COMMAND")
    group.set_defaults(handler=lambda args, group=group: group.print_help())
    command = _command(subcommands, "merge", trace_merge)
    command.add_argument("output")
    command.add_argument("inputs", nargs="+", type=_existing_path)
    command = _command(subcommands, "collect", trace_collect)
    command.add_argument("--output", dest="output_dir", required=True,
                         help="Directory for the per-process artifacts")
    command.add_argument("--merge", dest="merge_path", default=None,
                         help="Also write the merged artifact here")
    command.add_argument("--transport", default=None)
    command.add_argument("--wait", type=float, default=3.0,
                         help="Discovery/response wait (s)")

    _command(commands, "bench", bench)

    group = commands.add_parser(
        "system", help="Start/stop a whole local deployment.",
        description="One-command bootstrap: start/stop a whole local "
                    "deployment (registrar + dashboard + a named "
                    "pipeline) as detached OS processes tracked in a "
                    "state file.")
    subcommands = group.add_subparsers(dest="subcommand",
                                       metavar="COMMAND")
    group.set_defaults(handler=lambda args, group=group: group.print_help())
    command = _command(subcommands, "start", system_start)
    command.add_argument("definition", type=_existing_path)
    command.add_argument("--name", default=None,
                         help="Pipeline service name")
    command.add_argument("--transport", default=None,
                         help="loopback | mqtt | null (default: auto from "
                              "env)")
    _flag_pair(command, "dashboard", "with_dashboard", False,
               "Also spawn the curses dashboard (it shares this shell's "
               "terminal)")
    command.add_argument("--state-file", default=DEFAULT_STATE_FILE,
                         help="Where the spawned pids are recorded for "
                              "`system stop`")
    command = _command(subcommands, "stop", system_stop)
    command.add_argument("--state-file", default=DEFAULT_STATE_FILE)
    command.add_argument("--timeout", type=float, default=10.0,
                         help="Seconds to wait after SIGTERM before "
                              "SIGKILL")
    command = _command(subcommands, "status", system_status)
    command.add_argument("--state-file", default=DEFAULT_STATE_FILE)
    _flag_pair(command, "pool", "show_pool", False,
               "Also discover serving gateways via the registrar and "
               "print each replica pool")
    command.add_argument("--transport", default=None,
                         help="Transport for --pool discovery (default: "
                              "the start-time transport from the state "
                              "file)")
    command.add_argument("--wait", type=float, default=3.0,
                         help="Seconds to wait for --pool discovery")

    command = _command(commands, "bootstrap", bootstrap)
    command.add_argument("--port", type=int, default=None,
                         help="UDP port to answer on (default 4149)")
    command.add_argument("--mqtt-host", default=None,
                         help="Broker host to advertise")
    command.add_argument("--mqtt-port", type=int, default=None)
    return parser


def main(argv=None) -> None:
    """Parse `argv` (default: sys.argv[1:]) and run the command; exits
    through SystemExit with the command's status."""
    parser = build_parser()
    args = parser.parse_args(argv)
    handler = getattr(args, "handler", None)
    if handler is None:
        parser.print_help()
        sys.exit(0)
    try:
        handler(args)
    except CommandError as error:
        _echo(f"Error: {error}", err=True)
        sys.exit(1)
    sys.exit(0)


if __name__ == "__main__":
    main()
