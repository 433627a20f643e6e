# tune/: profile-guided pipeline optimizer -- the layer that closes
# the analyze -> observe loop.  The port's copy of the JAX package's
# tune/ (same modules, names, grammar, diagnostics and report JSON).
#
# The repo carries a complete STATIC model of every pipeline (analyze/:
# typed tensor-port flow, each element instantiated on PyTorch's meta
# device and run there -- analyze/shape_eval.py) and a complete
# DYNAMIC one (observe/: per-element spans, queue-wait vs compute
# split, Perfetto traces, metrics snapshots).  This package consumes
# them TOGETHER:
#
#   loader.py     ingest one recorded trace artifact (self-describing:
#                 definition + fingerprint + bench config block +
#                 metrics snapshot ride the metadata)
#                 and join every span to a typed graph node
#   model.py      per-element cost model (dynamic medians x static
#                 FLOP/byte estimates) + the analytical floor
#                 classifier: dispatch- / compute- / queue- /
#                 compile-bound, with evidence
#   recommend.py  floors + an SLO -> concrete settings (micro_batch,
#                 frame_window, fused-vs-chained, decode_slots /
#                 kv_block_size, replica floor, admission rate), and
#                 the --apply write-back through the linter
#   replay.py     what-if scoring of a trace under proposed settings:
#                 pure deterministic arithmetic, so CI asserts
#                 recommendation determinism on a fixture trace
#   slo.py        the tune directive grammar (AIKO501 via the shared
#                 directive core)
#
# `run_tune` is the CLI's whole pipeline: trace path in, report dict
# out.  The report is rendered with sorted keys and NO timestamps, so
# the same trace + spec always produces byte-identical JSON.

from __future__ import annotations

import json

from .loader import (                                       # noqa: F401
    ElementProfile, LoadedTrace, TraceLoadError, load_trace)
from .model import (                                        # noqa: F401
    CostModel, ElementCost, classify_elements)
from .recommend import (                                    # noqa: F401
    Recommendation, admission_recommendation, apply_recommendations,
    recommend)
from .replay import element_settings_of, predict            # noqa: F401
from .slo import SloSpec, TUNE_GRAMMAR, check_tune_spec     # noqa: F401

__all__ = [
    "ElementProfile", "LoadedTrace", "TraceLoadError", "load_trace",
    "CostModel", "ElementCost", "classify_elements",
    "Recommendation", "admission_recommendation",
    "apply_recommendations", "recommend",
    "element_settings_of", "predict",
    "SloSpec", "TUNE_GRAMMAR", "check_tune_spec",
    "build_report", "render_report", "run_tune", "report_json",
]

REPORT_VERSION = 1


def build_report(loaded: LoadedTrace, model: CostModel, slo: SloSpec,
                 recommendations: list, baseline: dict,
                 proposed: dict) -> dict:
    """The machine-readable tune report (README "Performance tuning"
    documents the schema).  Deterministic: derived from the trace
    content only."""
    elements = {}
    for name, cost in sorted(model.elements.items()):
        elements[name] = {
            "floor": cost.floor,
            "calls": cost.calls,
            "compute_median_ms": round(cost.compute_median_s * 1e3, 4),
            "queue_median_ms": round(cost.queue_median_s * 1e3, 4),
            "per_call_median_ms": round(
                cost.per_call_median_s * 1e3, 4),
            "group_median": round(cost.group_median, 2),
            "paths": dict(sorted(cost.paths.items())),
            "compiles": cost.compiles,
            "evidence": cost.evidence,
        }
        if cost.flops_per_row is not None:
            elements[name]["flops_per_row"] = cost.flops_per_row
        if cost.bytes_per_row is not None:
            elements[name]["bytes_per_row"] = cost.bytes_per_row
        if cost.achieved_utilization is not None:
            elements[name]["achieved_utilization"] = round(
                cost.achieved_utilization, 5)
        if cost.engine is not None:
            elements[name]["engine"] = {
                key: (round(value, 6)
                      if isinstance(value, float) else value)
                for key, value in cost.engine.items()}
        if cost.gateway is not None:
            elements[name]["gateway"] = {
                key: (round(value, 6)
                      if isinstance(value, float) else value)
                for key, value in cost.gateway.items()}
    dominant = ""
    if elements:
        observed = [(record["per_call_median_ms"], name)
                    for name, record in elements.items()
                    if record["floor"] != "unobserved"]
        if observed:
            dominant = max(observed)[1]
    return {
        "version": REPORT_VERSION,
        "pipeline": (loaded.definition_document or {}).get("name", ""),
        "trace": loaded.path,
        "fingerprint": loaded.fingerprint,
        "config_name": loaded.config_name,
        "slo": {
            "objective": slo.objective,
            "p99_ms": (round(slo.p99_budget_s * 1e3, 3)
                       if slo.p99_budget_s is not None else None),
            "spec": slo.spec,
        },
        "observed": {
            "frames": loaded.frame_count,
            "frame_statuses": dict(sorted(
                loaded.frame_statuses.items())),
            "wall_s": round(loaded.wall_s, 6),
            "frames_per_sec": round(model.frames_per_sec, 4),
            "p50_ms": round(model.frame_p50_s * 1e3, 4),
            "p99_ms": round(model.frame_p99_s * 1e3, 4),
        },
        "dominant_floor_element": dominant,
        "elements": elements,
        "recommendations": [recommendation.to_dict()
                            for recommendation in recommendations],
        "replay": {"baseline": baseline, "proposed": proposed},
        "diagnostics": [
            {"code": diagnostic.code, "severity": diagnostic.severity,
             "message": diagnostic.message}
            for diagnostic in loaded.diagnostics],
    }


def report_json(report: dict) -> str:
    """THE byte-deterministic rendering CI diffs two runs of."""
    return json.dumps(report, indent=2, sort_keys=True)


def render_report(report: dict) -> str:
    """Human-readable rendering of the same report."""
    lines = [f"tune report v{report['version']}: "
             f"{report['pipeline'] or '(unjoined trace)'}"
             + (f" [{report['config_name']}]"
                if report.get("config_name") else "")]
    observed = report["observed"]
    lines.append(
        f"observed: {observed['frames']} frames over "
        f"{observed['wall_s']:.3f}s = "
        f"{observed['frames_per_sec']:g} frames/s, "
        f"p50 {observed['p50_ms']:g} ms, p99 {observed['p99_ms']:g} ms")
    slo = report["slo"]
    lines.append(f"slo: {slo['objective']}"
                 + (f", p99 budget {slo['p99_ms']:g} ms"
                    if slo.get("p99_ms") else ""))
    lines.append("floors:")
    for name, record in sorted(report["elements"].items()):
        extra = ""
        if record.get("achieved_utilization") is not None:
            extra = f"  util {record['achieved_utilization']:.4f}"
        lines.append(
            f"  {name:12} {record['floor']:15} "
            f"compute {record['compute_median_ms']:g} ms  "
            f"queue {record['queue_median_ms']:g} ms  "
            f"group {record['group_median']:g}  "
            f"compiles {record['compiles']}{extra}")
    if report["recommendations"]:
        lines.append("recommendations:")
        for recommendation in report["recommendations"]:
            lines.append(
                f"  {recommendation['target']}: "
                f"{recommendation['knob']} "
                f"{recommendation['current']!r} -> "
                f"{recommendation['proposed']!r}  "
                f"({recommendation['reason']})")
    else:
        lines.append("recommendations: none -- the observed floors "
                     "are already at their configured knobs")
    replay = report["replay"]
    if replay.get("proposed"):
        lines.append(
            f"what-if replay: {replay['baseline']['frames_per_sec']:g}"
            f" -> {replay['proposed']['frames_per_sec']:g} frames/s, "
            f"p99 {replay['baseline']['p99_ms']:g} -> "
            f"{replay['proposed']['p99_ms']:g} ms "
            f"(bottleneck {replay['proposed']['bottleneck'] or '-'})")
    for diagnostic in report["diagnostics"]:
        lines.append(f"  {diagnostic['code']} "
                     f"[{diagnostic['severity']}] "
                     f"{diagnostic['message']}")
    return "\n".join(lines)


def run_tune(trace_path: str, slo_spec=None, definition=None,
             run: str | None = None, include_flops: bool = True,
             static_costs: dict | None = None,
             loaded: LoadedTrace | None = None) -> dict:
    """trace artifact -> tune report dict (loader -> cost model ->
    classifier -> recommender -> what-if replay).  Pass `loaded` to
    reuse an already-parsed trace (the CLI's --apply path loads
    once)."""
    slo = slo_spec if isinstance(slo_spec, SloSpec) \
        else SloSpec.parse(slo_spec)
    if loaded is None:
        loaded = load_trace(trace_path, definition=definition,
                            run=run)
    if static_costs is None and loaded.definition is not None:
        from ..analyze.shape_eval import element_cost_estimates
        try:
            static_costs = element_cost_estimates(
                loaded.definition, include_flops=include_flops)
        except Exception:
            static_costs = {}
    model = CostModel.from_trace(
        loaded, static_costs=static_costs,
        dispatch_floor_s=slo.dispatch_floor_s,
        peak_flops=slo.peak_flops)
    classify_elements(model)
    recommendations = recommend(model, slo,
                                loaded.definition_document)
    admission = admission_recommendation(
        loaded.config,
        (loaded.definition_document or {}).get("parameters"))
    if admission is not None:
        recommendations.append(admission)
    settings = element_settings_of(loaded.definition_document)
    baseline = predict(model, settings)
    overrides: dict = {"elements": {}}
    for recommendation in recommendations:
        if recommendation.target.startswith("element:"):
            element = recommendation.target.split(":", 1)[1]
            if isinstance(recommendation.proposed, int):
                overrides["elements"].setdefault(element, {})[
                    recommendation.knob] = recommendation.proposed
        elif (recommendation.target, recommendation.knob) == (
                "pipeline", "frame_window"):
            overrides["frame_window"] = recommendation.proposed
        elif recommendation.knob == "autoscale_policy":
            try:
                floor = int(str(recommendation.proposed)
                            .split("min_replicas=")[1].split(";")[0])
                overrides["replicas"] = floor
            except (IndexError, ValueError):
                pass
    proposed = predict(model, settings, overrides)
    return build_report(loaded, model, slo, recommendations,
                        baseline, proposed)
