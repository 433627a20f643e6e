# The port's tune/ on the CPU, mirroring tests/test_tune.py case by case
# (the loader's join, the floor classifier on synthetic traces with
# KNOWN floors, recommender monotonicity, --apply through lint, what-if
# replay determinism, graceful failure on a metadata-absent trace), with
# the CLI driven through the port's argparse main.  The synthetic
# traces' definitions name the port's elements.
#
# Parity with the JAX package: the same trace file through both
# packages' run_tune (without a definition, and without static costs
# where the embedded definition names the JAX package's elements) gives
# byte-identical report_json strings; SloSpec.parse gives the same
# fields and the same diagnostic codes; analyze_definition gives the
# same AIKO501 findings.  With `definition=` naming the port's elements,
# run_tune takes its static costs from the port's meta-device pass
# (analyze/shape_eval.py element_cost_estimates).

import json
from pathlib import Path

import pytest

from aiko_services_tpu import tune as jax_tune
from aiko_services_tpu.analyze import analyze_definition as jax_analyze
from aiko_services_tpu_torch.analyze import analyze_definition
from aiko_services_tpu_torch.observe.trace import (
    chrome_trace_document, definition_fingerprint, trace_metadata)
from aiko_services_tpu_torch.tune import (
    CostModel, Recommendation, SloSpec, apply_recommendations,
    check_tune_spec, classify_elements, load_trace, predict, report_json,
    run_tune)
from aiko_services_tpu_torch.analyze.grammar import GrammarError
from test_torch_cli import _invoke

ASSETS = Path(__file__).parent / "assets"
FIXTURE = ASSETS / "traces" / "config5_smoke.json"
CASE_STUDIES = (ASSETS / "traces" / "longcontext_16k.json",
                ASSETS / "traces" / "train_step.json")
REPORTS = Path(__file__).parent.parent / "reports"


# -- synthetic traces -------------------------------------------------------

def _definition(element_names):
    elements = []
    previous = None
    for name in element_names:
        record = {"name": name,
                  "output": [{"name": f"out_{name}", "type": "any"}],
                  "deploy": {"local": {
                      "module": "aiko_services_tpu_torch.elements",
                      "class_name": "TextSource"}}}
        if previous is not None:
            record["input"] = [{"name": f"out_{previous}",
                                "type": "any"}]
        elements.append(record)
        previous = name
    graph = ""
    for name in reversed(element_names):
        graph = f"({name} {graph})" if graph else f"({name})"
    return {"name": "synthetic", "graph": [graph],
            "elements": elements}


def _make_trace(tmp_path, specs, frames=10, definition=None,
                metadata=True, config=None):
    """specs: {element: {compute_ms, queue_ms, group, compiles,
    path}} -> a trace file with `frames` spans per element."""
    definition = definition or _definition(sorted(specs))
    events = []
    ts = 0.0
    for frame_id in range(frames):
        frame_start = ts
        trace_id = f"1-{frame_id + 1:x}"
        for name in sorted(specs):
            spec = specs[name]
            queue_ms = spec.get("queue_ms", 0.0)
            if queue_ms:
                events.append({
                    "ph": "X", "name": f"queue:{name}",
                    "cat": "queue", "ts": round(ts, 3),
                    "dur": round(queue_ms * 1000, 3),
                    "pid": 1, "tid": 1,
                    "args": {"trace_id": trace_id}})
                ts += queue_ms * 1000
            compiles = spec.get("compiles", 0)
            if frame_id < compiles:
                events.append({
                    "ph": "i", "name": f"compile:{name}",
                    "cat": "compile", "ts": round(ts, 3), "pid": 1,
                    "tid": 0, "s": "t", "args": {}})
            duration = spec["compute_ms"] * 1000
            events.append({
                "ph": "X", "name": name, "cat": "element",
                "ts": round(ts, 3), "dur": round(duration, 3),
                "pid": 1, "tid": 1,
                "args": {"trace_id": trace_id, "frame_id": frame_id,
                         "path": spec.get("path", "inline"),
                         "group": spec.get("group", 1)}})
            ts += duration
        events.append({
            "ph": "X", "name": f"frame {frame_id}", "cat": "frame",
            "ts": round(frame_start, 3),
            "dur": round(ts - frame_start, 3), "pid": 1, "tid": 1,
            "args": {"trace_id": trace_id, "status": "ok",
                     "stream": "s"}})
        ts += 50.0
    document = chrome_trace_document(
        events,
        metadata=(trace_metadata(definition_document=definition,
                                 config=config)
                  if metadata else None))
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(document))
    return str(path)


# -- loader / join -----------------------------------------------------------

class TestLoader:
    def test_fixture_joins_every_config5_element(self):
        loaded = load_trace(str(FIXTURE))
        assert loaded.definition is not None
        declared = {element.name
                    for element in loaded.definition.elements}
        assert declared == {"sources", "asr", "text", "lm", "reply",
                            "detector"}
        # the join covers every element with real spans -- no
        # "produced no spans" or "not an element" diagnostics
        assert declared == set(loaded.elements)
        for profile in loaded.elements.values():
            assert profile.calls > 0
        assert not [d for d in loaded.diagnostics
                    if d.code == "AIKO503"]
        assert loaded.fingerprint == definition_fingerprint(
            loaded.definition_document)
        assert loaded.config_name == "pipeline_multimodal"
        assert loaded.frame_count > 0 and loaded.wall_s > 0
        # the embedded metrics snapshot rode along
        assert "histograms" in loaded.metrics

    def test_span_for_undeclared_node_is_diagnosed(self, tmp_path):
        path = _make_trace(
            tmp_path, {"known": {"compute_ms": 1.0},
                       "ghost": {"compute_ms": 1.0}},
            definition=_definition(["known"]))
        loaded = load_trace(path)
        messages = [d.message for d in loaded.diagnostics
                    if d.code == "AIKO503"]
        assert any("ghost" in message for message in messages)

    def test_declared_but_unobserved_element_kept(self, tmp_path):
        path = _make_trace(
            tmp_path, {"a": {"compute_ms": 1.0}},
            definition=_definition(["a", "silent"]))
        loaded = load_trace(path)
        assert loaded.elements["silent"].calls == 0
        model = CostModel.from_trace(loaded)
        classify_elements(model)
        assert model.elements["silent"].floor == "unobserved"

    def test_metadata_absent_trace_diagnosed_and_joinable_via_side_channel(
            self, tmp_path):
        path = _make_trace(tmp_path, {"a": {"compute_ms": 1.0}},
                           metadata=False)
        loaded = load_trace(path)
        assert loaded.definition is None
        assert any("no aiko metadata" in d.message
                   for d in loaded.diagnostics)
        # the side channel still joins it
        loaded = load_trace(path, definition=_definition(["a"]))
        assert loaded.definition is not None
        assert loaded.elements["a"].calls == 10

    def test_combined_trace_run_selection_filters_by_pid(self,
                                                         tmp_path):
        """A combined multi-run artifact must ingest ONLY the
        selected run's spans: another config's same-named node would
        otherwise corrupt the medians."""
        def span(pid, dur_ms, frame_id):
            return [
                {"ph": "X", "name": "lm", "cat": "element",
                 "ts": 0.0, "dur": dur_ms * 1000, "pid": pid,
                 "tid": 1, "args": {"path": "inline", "group": 1,
                                    "frame_id": frame_id}},
                {"ph": "X", "name": f"frame {frame_id}",
                 "cat": "frame", "ts": 0.0, "dur": dur_ms * 1000,
                 "pid": pid, "tid": 1,
                 "args": {"status": "ok", "stream": "s"}},
            ]
        definition = _definition(["lm"])
        events = (span(1, 10.0, 0) + span(1, 10.0, 1)
                  + span(2, 1000.0, 0))
        document = chrome_trace_document(events, metadata={
            "schema": 1,
            "runs": {
                "fast": dict(trace_metadata(
                    definition_document=definition), pids=[1]),
                "slow": dict(trace_metadata(
                    definition_document=definition), pids=[2]),
            }})
        path = tmp_path / "combined.json"
        path.write_text(json.dumps(document))
        fast = load_trace(str(path), run="fast")
        assert fast.elements["lm"].compute_s == [0.01, 0.01]
        assert len(fast.frame_durations_s) == 2
        slow = load_trace(str(path), run="slow")
        assert slow.elements["lm"].compute_s == [1.0]

    def test_not_a_trace_raises(self, tmp_path):
        from aiko_services_tpu_torch.tune import TraceLoadError
        path = tmp_path / "nope.json"
        path.write_text("{\"hello\": 1}")
        with pytest.raises(TraceLoadError):
            load_trace(str(path))
        path.write_text("not json")
        with pytest.raises(TraceLoadError):
            load_trace(str(path))


# -- floor classifier on known floors ----------------------------------------

class TestClassifier:
    def _classify(self, tmp_path, specs, config=None):
        loaded = load_trace(_make_trace(tmp_path, specs,
                                        config=config))
        model = CostModel.from_trace(loaded)
        classify_elements(model)
        return model

    def test_dispatch_bound(self, tmp_path):
        model = self._classify(
            tmp_path, {"fast": {"compute_ms": 0.3, "group": 1}})
        assert model.elements["fast"].floor == "dispatch-bound"
        evidence = model.elements["fast"].evidence
        assert evidence["per_call_median_ms"] <= \
            evidence["dispatch_floor_ms"]

    def test_compute_bound(self, tmp_path):
        model = self._classify(
            tmp_path, {"heavy": {"compute_ms": 50.0,
                                 "queue_ms": 1.0}})
        assert model.elements["heavy"].floor == "compute-bound"

    def test_queue_bound(self, tmp_path):
        model = self._classify(
            tmp_path, {"starved": {"compute_ms": 2.0,
                                   "queue_ms": 30.0}})
        assert model.elements["starved"].floor == "queue-bound"
        assert model.elements["starved"].evidence[
            "queue_median_ms"] > 2.0

    def test_compile_bound(self, tmp_path):
        # a compile event on EVERY call: hopeless re-specialization
        model = self._classify(
            tmp_path, {"churn": {"compute_ms": 5.0, "compiles": 10}})
        assert model.elements["churn"].floor == "compile-bound"
        assert model.elements["churn"].evidence["compile_ratio"] >= 1.0

    def test_warmup_compiles_do_not_flip_the_floor(self, tmp_path):
        # 1 compile over 10 calls at 5 ms: steady state, compute rules
        model = self._classify(
            tmp_path, {"warm": {"compute_ms": 50.0, "compiles": 0}})
        assert model.elements["warm"].floor == "compute-bound"

    def test_low_utilization_reads_dispatch_bound(self, tmp_path):
        # 3 ms/call is past the 1.5 ms floor, but the static FLOP
        # estimate says the chip did ~nothing: dispatch-bound
        loaded = load_trace(_make_trace(
            tmp_path, {"idle": {"compute_ms": 3.0}},
            config={"peak_tflops_assumed": 100.0}))
        model = CostModel.from_trace(
            loaded, static_costs={"idle": {"rows": 1, "flops": 1e6,
                                           "bytes_in": 4,
                                           "bytes_out": 4}})
        classify_elements(model)
        assert model.elements["idle"].floor == "dispatch-bound"
        assert model.elements["idle"].achieved_utilization < 0.02


# -- recommender -------------------------------------------------------------

class TestRecommender:
    def test_monotonic_micro_batch_under_tightening_p99(self):
        """The contract: a TIGHTER SLO budget never RAISES a proposed
        micro_batch."""
        previous = None
        for budget_ms in (100000.0, 1000.0, 50.0, 5.0, 0.5):
            report = run_tune(
                str(FIXTURE),
                slo_spec=SloSpec.parse(
                    f"slo=throughput;p99_ms={budget_ms}"),
                static_costs={})
            proposed = {}
            for record in report["recommendations"]:
                if record["knob"] == "micro_batch":
                    proposed[record["target"]] = record["proposed"]
            if previous is not None:
                for target in set(previous) | set(proposed):
                    # absent proposal == stays at current (1)
                    assert proposed.get(target, 1) <= \
                        previous.get(target, 1), (budget_ms, target)
            previous = proposed

    def test_latency_slo_proposes_window_one_not_bigger_batches(self):
        report = run_tune(str(FIXTURE),
                          slo_spec=SloSpec.parse("latency"),
                          static_costs={})
        knobs = {(r["target"], r["knob"]): r["proposed"]
                 for r in report["recommendations"]}
        assert knobs.get(("pipeline", "frame_window")) == 1
        for record in report["recommendations"]:
            if record["knob"] == "micro_batch":
                assert record["proposed"] <= record["current"]

    def test_every_recommendation_carries_evidence(self):
        report = run_tune(str(FIXTURE), static_costs={})
        assert report["recommendations"]
        for record in report["recommendations"]:
            assert record["reason"]
            assert isinstance(record["evidence"], dict)
            assert record["evidence"]

    def test_queue_bound_starved_groups_shrink_micro_batch(
            self, tmp_path):
        definition = _definition(["starved"])
        definition["elements"][0]["parameters"] = {"micro_batch": 16}
        path = _make_trace(
            tmp_path,
            {"starved": {"compute_ms": 2.0, "queue_ms": 30.0,
                         "group": 2}},
            definition=definition)
        report = run_tune(path, static_costs={})
        records = {(r["target"], r["knob"]): r
                   for r in report["recommendations"]}
        record = records[("element:starved", "micro_batch")]
        assert record["current"] == 16
        assert record["proposed"] == 2

    def test_engine_slot_wait_raises_decode_slots(self, tmp_path):
        definition = _definition(["lm"])
        definition["elements"][0]["parameters"] = {
            "continuous": True, "decode_slots": 2,
            "kv_block_size": 8, "max_new_tokens": 4}
        events = []
        ts = 0.0
        for frame_id in range(6):
            trace_id = f"1-{frame_id + 1:x}"
            for row in range(2):
                events.append({
                    "ph": "X", "name": f"queue:lm[{row}]",
                    "cat": "queue", "ts": ts, "dur": 50000.0,
                    "pid": 1, "tid": 1, "args": {}})
                events.append({
                    "ph": "X", "name": f"prefill:lm[{row}]",
                    "cat": "engine", "ts": ts + 50000.0,
                    "dur": 2000.0, "pid": 1, "tid": 1, "args": {}})
                events.append({
                    "ph": "X", "name": f"decode_steps:lm[{row}]",
                    "cat": "engine", "ts": ts + 52000.0,
                    "dur": 8000.0, "pid": 1, "tid": 1,
                    "args": {"decode_steps": 4, "preemptions": 0,
                             "tokens": 3}})
            events.append({
                "ph": "X", "name": f"frame {frame_id}",
                "cat": "frame", "ts": ts, "dur": 60000.0,
                "pid": 1, "tid": 1,
                "args": {"trace_id": trace_id, "status": "ok",
                         "stream": "s"}})
            ts += 61000.0
        path = tmp_path / "engine.json"
        path.write_text(json.dumps(chrome_trace_document(
            events, metadata=trace_metadata(
                definition_document=definition))))
        report = run_tune(str(path), static_costs={})
        records = {(r["target"], r["knob"]): r
                   for r in report["recommendations"]}
        slots = records[("element:lm", "decode_slots")]
        assert slots["current"] == 2 and slots["proposed"] == 4
        # completions averaged 3 tokens in 8-token blocks: halve them
        blocks = records[("element:lm", "kv_block_size")]
        assert blocks["proposed"] == 4


# -- apply / lint round trip -------------------------------------------------

class TestApply:
    def test_apply_round_trips_through_lint(self):
        report = run_tune(str(FIXTURE), static_costs={})
        loaded = load_trace(str(FIXTURE))
        recommendations = [
            Recommendation(**{key: record[key] for key in
                              ("target", "knob", "current", "proposed",
                               "reason", "floor", "evidence")})
            for record in report["recommendations"]]
        assert recommendations
        document, diagnostics = apply_recommendations(
            loaded.definition_document, recommendations)
        assert diagnostics == []
        # the applied knobs landed
        applied = {element["name"]:
                   element.get("parameters", {}).get("micro_batch")
                   for element in document["elements"]}
        changed = [record for record in report["recommendations"]
                   if record["knob"] == "micro_batch"]
        for record in changed:
            name = record["target"].split(":", 1)[1]
            assert applied[name] == record["proposed"]
        # and the document passes the same passes `aiko lint` runs at
        # construction time
        lint = analyze_definition(document, passes=("graph", "policy"))
        assert lint.failures() == [], [d.render()
                                       for d in lint.failures()]

    def test_apply_missing_element_is_aiko502(self):
        loaded = load_trace(str(FIXTURE))
        document, diagnostics = apply_recommendations(
            loaded.definition_document,
            [Recommendation("element:nonexistent", "micro_batch",
                            1, 4, "test")])
        assert [d.code for d in diagnostics] == ["AIKO502"]

    def test_apply_never_overwrites_existing_policy(self):
        loaded = load_trace(str(FIXTURE))
        loaded.definition_document.setdefault("parameters", {})[
            "gateway_policy"] = "max_inflight=4"
        document, diagnostics = apply_recommendations(
            loaded.definition_document,
            [Recommendation("gateway", "gateway_policy", None,
                            "bucket:0=9/2", "test")])
        assert document["parameters"]["gateway_policy"] == \
            "max_inflight=4"
        assert [d.code for d in diagnostics] == ["AIKO502"]


# -- what-if replay determinism ----------------------------------------------

class TestReplay:
    def test_report_bit_deterministic(self):
        one = report_json(run_tune(str(FIXTURE), static_costs={}))
        two = report_json(run_tune(str(FIXTURE), static_costs={}))
        assert one == two

    def test_predict_scales_with_settings(self):
        loaded = load_trace(str(FIXTURE))
        model = CostModel.from_trace(loaded)
        classify_elements(model)
        from aiko_services_tpu_torch.tune import element_settings_of
        settings = element_settings_of(loaded.definition_document)
        baseline = predict(model, settings)
        doubled = predict(model, settings, {"replicas": 2})
        assert doubled["frames_per_sec"] == pytest.approx(
            2 * baseline["frames_per_sec"])
        batched = predict(
            model, settings,
            {"elements": {baseline["bottleneck"]:
                          {"micro_batch": 8}}})
        assert batched["frames_per_sec"] >= baseline["frames_per_sec"]

    def test_predict_same_inputs_same_bytes(self):
        loaded = load_trace(str(FIXTURE))
        model = CostModel.from_trace(loaded)
        from aiko_services_tpu_torch.tune import element_settings_of
        settings = element_settings_of(loaded.definition_document)
        overrides = {"elements": {"asr": {"micro_batch": 4}}}
        assert json.dumps(predict(model, settings, overrides)) == \
            json.dumps(predict(model, settings, overrides))


# -- grammar / AIKO501 -------------------------------------------------------

class TestGrammar:
    def test_valid_specs(self):
        assert check_tune_spec("throughput") == []
        assert check_tune_spec("slo=latency;p99_ms=250") == []
        assert check_tune_spec(
            "p99_ms=10;max_micro_batch=8;dispatch_floor_ms=0.05") == []

    def test_bad_value_is_501_unknown_is_404(self):
        assert [code for code, _ in
                check_tune_spec("slo=goodput")] == ["AIKO501"]
        assert [code for code, _ in
                check_tune_spec("p99_ms=-4")] == ["AIKO501"]
        assert [code for code, _ in
                check_tune_spec("slos=latency")] == ["AIKO404"]

    def test_parse_raises_on_bad_spec(self):
        with pytest.raises(GrammarError):
            SloSpec.parse("p99_ms=zero")

    def test_definition_tune_parameter_linted(self):
        definition = _definition(["a"])
        definition["parameters"] = {"tune": "slo=nope"}
        report = analyze_definition(definition, passes=("policy",))
        assert "AIKO501" in {d.code for d in report.findings}


# -- CLI ---------------------------------------------------------------------

class TestCli:
    def _invoke(self, *args):
        return _invoke(*args)

    def test_cli_json_deterministic_on_fixture(self):
        one = self._invoke("tune", str(FIXTURE), "--json",
                           "--no-flops")
        two = self._invoke("tune", str(FIXTURE), "--json",
                           "--no-flops")
        assert one.exit_code == 0, one.output
        assert one.output == two.output
        report = json.loads(one.output)
        assert len(report["elements"]) == 6
        assert all(record["floor"] != "unobserved"
                   for record in report["elements"].values())

    def test_cli_metadata_absent_fails_gracefully(self, tmp_path):
        path = _make_trace(tmp_path, {"a": {"compute_ms": 1.0}},
                           metadata=False)
        result = self._invoke("tune", path)
        assert result.exit_code == 2
        assert "no aiko metadata" in result.output \
            or "not joined" in result.output

    def test_cli_what_if(self):
        result = self._invoke(
            "tune", str(FIXTURE), "--json", "--no-flops",
            "--what-if", "lm.micro_batch=4;replicas=2")
        assert result.exit_code == 0, result.output
        report = json.loads(result.output)
        assert report["recommendations"] == []
        assert report["replay"]["proposed"]["replicas"] == 2

    def test_cli_what_if_rejects_typos_and_apply_combination(
            self, tmp_path):
        # unknown element
        result = self._invoke("tune", str(FIXTURE), "--no-flops",
                              "--what-if", "lmm.micro_batch=4")
        assert result.exit_code != 0
        assert "unknown element" in result.output
        # unknown knob
        result = self._invoke("tune", str(FIXTURE), "--no-flops",
                              "--what-if", "lm.micro_bacth=4")
        assert result.exit_code != 0 and "knob" in result.output
        # --what-if with --apply: loud usage error, no file written
        out = tmp_path / "never.json"
        result = self._invoke("tune", str(FIXTURE), "--no-flops",
                              "--what-if", "lm.micro_batch=4",
                              "--apply", str(out))
        assert result.exit_code == 2
        assert "mutually exclusive" in result.output
        assert not out.exists()

    def test_cli_apply_writes_lintable_definition(self, tmp_path):
        out = tmp_path / "tuned.json"
        result = self._invoke("tune", str(FIXTURE), "--no-flops",
                              "--apply", str(out))
        assert result.exit_code == 0, result.output
        document = json.loads(out.read_text())
        lint = analyze_definition(document, passes=("graph", "policy"))
        assert lint.failures() == []


# -- case studies ------------------------------------------------------------

class TestCaseStudies:
    def test_roofline_traces_classify_compute_bound(self):
        """The two recorded rooflines: the port's tune report must
        EXPLAIN the floor -- compute-bound with achieved utilization
        equal to the recorded MFU -- and equal the committed report the
        JAX package wrote for the same trace."""
        for path in CASE_STUDIES:
            loaded = load_trace(str(path))
            assert loaded.definition is not None, path
        reports = {}
        for trace, committed in zip(CASE_STUDIES, (
                "tune_longcontext_16k.json", "tune_train_step.json")):
            reports[trace.stem] = json.loads(report_json(run_tune(
                str(trace), slo_spec=SloSpec.parse("throughput"),
                static_costs=_case_study_costs(trace))))
            assert reports[trace.stem] == json.loads(
                (REPORTS / committed).read_text())
        report = reports["longcontext_16k"]
        assert report["elements"]["prefill_4k"]["floor"] == \
            "compute-bound"
        assert report["elements"]["prefill_16k"]["floor"] == \
            "compute-bound"
        assert report["elements"]["prefill_4k"][
            "achieved_utilization"] == pytest.approx(0.1308)
        assert report["elements"]["prefill_16k"][
            "achieved_utilization"] == pytest.approx(0.0647)
        train = reports["train_step"]
        assert train["elements"]["train_step"]["floor"] == \
            "compute-bound"
        assert train["elements"]["train_step"][
            "achieved_utilization"] == pytest.approx(0.3845)


def _case_study_costs(trace) -> dict:
    """The analytic costs tests/assets/traces/make_case_studies.py wrote
    its reports with: flops = recorded MFU x time x the peak the trace's
    config assumed."""
    config = json.loads(trace.read_text())["metadata"]["aiko"]["config"]
    peak = config["peak_tflops_assumed"]
    params = int(749e6 * 2)
    if "train_mfu" in config:
        return {"train_step": {
            "rows": 1, "bytes_in": 4 * 1024 * 4, "bytes_out": 4,
            "param_bytes": params,
            "flops": (config["train_mfu"] * round(config["step_ms"] / 1e3, 4)
                      * peak * 1e12)}}
    return {f"prefill_{size}k": {
        "rows": 1, "bytes_in": size * 1024 * 4,
        "bytes_out": size * 1024 * 2048 * 2, "param_bytes": params,
        "flops": (config[f"prefill_{size}k_mfu"]
                  * round(config[f"prefill_{size}k_ms"] / 1e3, 4) * peak
                  * 1e12)}
        for size in (4, 16)}


# -- parity with the JAX package ---------------------------------------------

TRACES = sorted((ASSETS / "traces").glob("*.json"))


@pytest.mark.parametrize("trace", TRACES, ids=[path.stem
                                               for path in TRACES])
def test_report_json_matches_jax(trace):
    """The same trace file through both packages' run_tune: identical
    report_json strings (the embedded definitions name the JAX package's
    elements, so both run without static costs)."""
    assert (report_json(run_tune(str(trace), static_costs={}))
            == jax_tune.report_json(jax_tune.run_tune(str(trace),
                                                      static_costs={})))


def test_report_json_matches_jax_on_synthetic_floors(tmp_path):
    """Every floor of the classifier, and an SLO spec, through both."""
    path = _make_trace(tmp_path, {
        "fast": {"compute_ms": 0.3}, "heavy": {"compute_ms": 50.0,
                                               "queue_ms": 1.0},
        "starved": {"compute_ms": 2.0, "queue_ms": 30.0, "group": 2},
        "churn": {"compute_ms": 5.0, "compiles": 10}})
    for slo in ("throughput", "latency", "slo=throughput;p99_ms=5"):
        assert (report_json(run_tune(path, slo_spec=slo,
                                     static_costs={}))
                == jax_tune.report_json(jax_tune.run_tune(
                    path, slo_spec=slo, static_costs={})))


SLO_SPECS = [None, "", "throughput", "latency", "slo=latency;p99_ms=250",
             "p99_ms=10;max_micro_batch=8;dispatch_floor_ms=0.05",
             "slo=goodput", "p99_ms=-4", "slos=latency", "p99_ms=zero",
             "bogus", {"slo": "latency"}]


@pytest.mark.parametrize("spec", SLO_SPECS,
                         ids=[repr(spec) for spec in SLO_SPECS])
def test_slo_spec_parse_matches_jax(spec):
    def parsed(module, spec):
        try:
            slo = module.SloSpec.parse(spec)
        except Exception as error:
            return (type(error).__name__, str(error))
        return {name: getattr(slo, name)
                for name in slo.__dataclass_fields__}
    assert parsed(jax_tune, spec) == parsed(
        __import__("aiko_services_tpu_torch.tune", fromlist=["x"]), spec)
    if isinstance(spec, str) and spec:
        assert check_tune_spec(spec) == jax_tune.check_tune_spec(spec)


@pytest.mark.parametrize("spec", ["slo=nope", "slos=latency",
                                  "slo=latency;p99_ms=250"])
def test_definition_tune_findings_match_jax(spec):
    definition = _definition(["a"])
    definition["parameters"] = {"tune": spec}
    jax_definition = json.loads(json.dumps(definition).replace(
        "aiko_services_tpu_torch.elements", "aiko_services_tpu.elements"))
    ours = analyze_definition(definition, passes=("graph", "policy"))
    theirs = jax_analyze(jax_definition, passes=("graph", "policy"))
    assert ([(d.code, d.message) for d in ours.findings]
            == [(d.code, d.message) for d in theirs.findings])


def test_static_costs_come_from_the_meta_device(tmp_path):
    """`definition=` naming the port's elements: run_tune takes its
    static costs from the port's meta-device pass -- each element's
    FLOPs and bytes -- and classifies with achieved utilization."""
    from aiko_services_tpu_torch.analyze.shape_eval import (
        element_cost_estimates)
    definition = {
        "name": "meta_costs", "parameters": {"device": "cpu"},
        "graph": ["(scale)"],
        "elements": [{
            "name": "scale",
            "input": [{"name": "tensor", "type": "f32[4,256]"}],
            "output": [{"name": "tensor", "type": "f32[4,256]"}],
            "parameters": {"features": 256, "hidden": 512},
            "deploy": {"local": {
                "module": "aiko_services_tpu_torch.elements",
                "class_name": "JaxMLP"}}}]}
    from aiko_services_tpu_torch.pipeline.definition import (
        parse_pipeline_definition)
    costs = element_cost_estimates(parse_pipeline_definition(definition))
    assert costs["scale"]["flops"] > 0
    path = _make_trace(tmp_path, {"scale": {"compute_ms": 3.0}},
                       definition=definition,
                       config={"peak_tflops_assumed": 100.0})
    report = run_tune(path, definition=definition)
    record = report["elements"]["scale"]
    assert record["flops_per_row"] == costs["scale"]["flops"] / 4
    assert record["achieved_utilization"] is not None
    embedded = run_tune(path, static_costs=costs)
    assert report["elements"] == embedded["elements"]
    assert report["recommendations"] == embedded["recommendations"]
