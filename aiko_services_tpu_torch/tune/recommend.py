# Recommender: floor classifications + an SLO -> concrete settings,
# each carrying the evidence spans that justify it, plus the
# write-back (`aiko tune --apply`) that turns recommendations into a
# definition document and re-lints it.
#
# Rules are deliberately mechanical (this is the "stop hand-tuning"
# subsystem -- an operator must be able to read WHY a knob moved):
#
#   dispatch-bound + throughput  double micro_batch (amortize the
#                                per-call floor), cap max_micro_batch;
#                                chained-only elements get
#                                micro_batch_fused re-enabled first
#   queue-bound, starved groups  (median occupancy < micro_batch/2)
#                                shrink micro_batch to the observed
#                                occupancy -- the scheduler is waiting
#                                for frames that are not coming
#   queue-bound, full groups     the element is backlogged: raise the
#                                replica floor (autoscale_policy min=)
#   compute-bound (bottleneck)   no per-element knob helps; raise the
#                                replica floor under a throughput SLO
#   compile-bound                pin frame_window to a micro_batch
#                                multiple so arity stays stable
#   engine queue-bound           raise decode_slots; chronic
#                                preemption notes kv block sizing
#   latency SLO                  frame_window -> 1 and micro_batch -> 1
#                                on elements whose queue wait exceeds
#                                compute (coalescing wait IS the
#                                latency)
#
# A p99_ms budget is enforced through the what-if replayer: proposed
# micro_batch values are halved (largest first) until the predicted
# p99 fits.  A TIGHTER budget therefore never RAISES micro_batch --
# the monotonicity contract tests/test_tune.py pins.

from __future__ import annotations

import copy
from dataclasses import dataclass, field

from ..analyze.diagnostics import Diagnostic
from .replay import element_settings_of, predict

__all__ = ["Recommendation", "recommend", "apply_recommendations"]


@dataclass
class Recommendation:
    target: str          # "element:<name>" | "pipeline" | "gateway"
    knob: str
    current: object
    proposed: object
    reason: str
    floor: str = ""
    evidence: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"target": self.target, "knob": self.knob,
                "current": self.current, "proposed": self.proposed,
                "reason": self.reason, "floor": self.floor,
                "evidence": self.evidence}


def _pow2_at_least(value: float) -> int:
    result = 1
    while result < value:
        result *= 2
    return result


def recommend(model, slo, definition_document: dict | None) -> list:
    """The recommendation list for one cost model under one SLO."""
    recommendations: list = []
    settings = element_settings_of(definition_document)
    element_parameters = {
        element.get("name", ""): element.get("parameters") or {}
        for element in (definition_document or {}).get("elements", [])}
    pipeline_parameters = (definition_document or {}).get(
        "parameters") or {}
    latency_mode = slo.objective == "latency"
    replica_floor = 1
    baseline = predict(model, settings)

    for name, cost in sorted(model.elements.items()):
        if cost.floor == "unobserved":
            continue
        current_micro = settings["elements"].get(name, {}).get(
            "micro_batch", 1)
        parameters = element_parameters.get(name, {})
        if cost.gateway is not None:
            # serving-tier pseudo-node (fleet-scope traces): the
            # kernel-floor branches below prescribe element knobs the
            # gateway does not have
            recommendations.extend(_gateway_floor_recommendations(
                name, cost, pipeline_parameters, slo))
            continue
        if cost.engine is not None:
            recommendations.extend(
                _engine_recommendations(name, cost, parameters, slo))
            continue
        if latency_mode:
            if (cost.queue_median_s > cost.compute_median_s
                    and current_micro > 1):
                recommendations.append(Recommendation(
                    f"element:{name}", "micro_batch", current_micro, 1,
                    "latency SLO: coalescing wait exceeds compute -- "
                    "one frame per call removes the group-fill wait",
                    floor=cost.floor, evidence=cost.evidence))
            continue
        if cost.floor == "dispatch-bound":
            if (cost.paths.get("chained", 0)
                    and not cost.paths.get("fused", 0)
                    and current_micro > 1
                    and parameters.get("micro_batch_fused") is False):
                recommendations.append(Recommendation(
                    f"element:{name}", "micro_batch_fused", False,
                    True,
                    "dispatch-bound on the chained path: fusing the "
                    "concat+kernel+split group removes per-element "
                    "dispatches", floor=cost.floor,
                    evidence=cost.evidence))
            proposed = min(max(current_micro * 2, 2),
                           slo.max_micro_batch)
            if proposed > current_micro:
                recommendations.append(Recommendation(
                    f"element:{name}", "micro_batch", current_micro,
                    proposed,
                    "dispatch-bound: per-call time sits at the "
                    "dispatch floor, so doubling the coalesced group "
                    "amortizes it across more frames",
                    floor=cost.floor, evidence=cost.evidence))
        elif cost.floor == "queue-bound":
            occupancy = cost.group_median
            if current_micro > 1 and occupancy < current_micro / 2.0:
                proposed = max(_pow2_at_least(occupancy), 1)
                if proposed < current_micro:
                    recommendations.append(Recommendation(
                        f"element:{name}", "micro_batch",
                        current_micro, proposed,
                        "queue-bound with starved groups (median "
                        f"occupancy {occupancy:g} of {current_micro}):"
                        " the scheduler waits for frames that are not "
                        "arriving -- shrink the group to what the "
                        "stream actually delivers",
                        floor=cost.floor, evidence=cost.evidence))
            else:
                replica_floor = max(replica_floor, 2)
        elif cost.floor == "compile-bound":
            window = settings.get("frame_window", 16)
            proposed_window = max(current_micro * 2, window)
            if proposed_window % max(current_micro, 1):
                proposed_window = current_micro * 2
            if proposed_window != window:
                recommendations.append(Recommendation(
                    "pipeline", "frame_window", window,
                    proposed_window,
                    f"compile-bound at {name}: a frame_window that is "
                    "a micro_batch multiple keeps group arity stable, "
                    "so one executable serves the steady state",
                    floor=cost.floor, evidence=cost.evidence))
        elif cost.floor == "compute-bound":
            if baseline.get("bottleneck") == name:
                replica_floor = max(replica_floor, 2)

    if latency_mode:
        window = settings.get("frame_window", 16)
        if window != 1:
            recommendations.append(Recommendation(
                "pipeline", "frame_window", window, 1,
                "latency SLO: one frame in flight end-to-end makes "
                "p50 true service latency instead of queueing depth",
                floor="", evidence={"frame_window": window}))
    elif replica_floor > 1 and slo.max_replicas > 1:
        replica_floor = min(replica_floor, slo.max_replicas)
        current_policy = pipeline_parameters.get("autoscale_policy")
        if current_policy:
            recommendations.append(Recommendation(
                "gateway", "replicas",
                str(current_policy), replica_floor,
                "bottleneck element is compute/queue-bound at "
                "capacity; an existing autoscale_policy is left "
                "untouched -- raise its min= floor manually",
                floor="", evidence={"replica_floor": replica_floor}))
        else:
            recommendations.append(Recommendation(
                "gateway", "autoscale_policy", None,
                f"min_replicas={replica_floor};"
                f"max_replicas={slo.max_replicas}",
                "bottleneck element is compute/queue-bound at "
                "capacity: only more replicas raise throughput",
                floor="", evidence={"replica_floor": replica_floor}))

    # gateway admission (measured capacity -> rate) is appended by the
    # caller via admission_recommendation, which sees the bench config
    # block the trace embeds
    return _fit_budget(model, slo, settings, recommendations)


def admission_recommendation(config: dict | None,
                             pipeline_parameters: dict | None) -> \
        "Recommendation | None":
    """Gateway admission rate from a measured capacity in the bench
    config block: admit at 90% of what the pipeline demonstrably
    serves.  Skipped when the definition already pins a
    gateway_policy (never silently overwrite an operator's policy)."""
    capacity = None
    source_key = None
    for key in ("goodput_frames_per_sec", "frames_per_sec_total",
                "frames_per_sec_chip"):
        value = (config or {}).get(key)
        if isinstance(value, (int, float)) and value > 0:
            capacity, source_key = float(value), key
            break
    if capacity is None:
        return None
    if (pipeline_parameters or {}).get("gateway_policy"):
        return None
    rate = round(capacity * 0.9, 2)
    burst = max(int(rate // 4), 1)
    return Recommendation(
        "gateway", "gateway_policy", None,
        f"bucket:0={rate:g}/{burst}",
        f"measured capacity {capacity:g} frames/s ({source_key}): "
        "admitting at 90% keeps queue wait bounded under overload",
        floor="", evidence={source_key: capacity})


def _gateway_floor_recommendations(name, cost, pipeline_parameters,
                                   slo) -> list:
    """The admission-bound branch: admit-wait (submit -> dispatch,
    parked wait included) dominates every element's compute+queue
    share, so streams wait at the GATE -- more replicas drain the
    parked queue, and a rate cap keeps the wait bounded (the paired
    admission_recommendation computes the rate from measured
    capacity).  A dispatch-bound gateway gets no recommendation: it is
    not the bottleneck tier."""
    if cost.floor != "admission-bound":
        return []
    if slo.max_replicas <= 1:
        # the operator pinned the fleet to one replica: recommending a
        # higher floor would overrun the stated ceiling (mirroring the
        # compute-bound replica-floor branch) -- only the paired
        # admission-rate recommendation can help here
        return []
    gateway = cost.gateway or {}
    evidence = dict(cost.evidence)
    recommendations = []
    floor = 2
    current_policy = (pipeline_parameters or {}).get("autoscale_policy")
    admit_ms = gateway.get("admit_median_s", 0.0) * 1e3
    reason = (f"admission-bound: median admit-wait {admit_ms:.1f} ms "
              f"exceeds the busiest element's compute+queue share "
              f"({evidence.get('fleet_busy_ms', 0):g} ms) -- streams "
              f"wait at the gate, not in any kernel; raise the replica "
              f"floor (and cap the admission rate at measured "
              f"capacity)")
    if current_policy:
        recommendations.append(Recommendation(
            "gateway", "replicas", str(current_policy), floor,
            reason + " -- an existing autoscale_policy is left "
            "untouched: raise its min= floor manually",
            floor=cost.floor, evidence=evidence))
    else:
        recommendations.append(Recommendation(
            "gateway", "autoscale_policy", None,
            f"min_replicas={floor};max_replicas="
            f"{max(slo.max_replicas, floor)}",
            reason, floor=cost.floor, evidence=evidence))
    return recommendations


def _engine_recommendations(name, cost, parameters, slo) -> list:
    recommendations = []
    engine = cost.engine or {}
    slots = int(parameters.get("decode_slots", 4) or 4)
    block_size = int(parameters.get("kv_block_size", 16) or 16)
    compute = (engine.get("prefill_median_s", 0.0)
               + engine.get("decode_median_s", 0.0))
    if cost.floor == "migration-bound":
        # the KV migration, not the kernel or the slot pool, floors
        # this element: more decode slots cannot help -- grow the
        # PREFILL pool (or shorten the transfer path) so adoptions
        # stop dominating, and skip the slot-wait heuristic below
        # (it would prescribe slots for a wire problem)
        recommendations.append(Recommendation(
            "gateway", "disagg_min_replicas_prefill",
            None, 2,
            f"migration-bound at {name}: KV adoption (median "
            f"{engine.get('adopt_median_s', 0.0) * 1e3:.1f} ms) "
            "dominates compute and queue wait -- raise the prefill "
            "pool floor (disagg `min_replicas:prefill=`) or move the "
            "pools closer",
            floor=cost.floor, evidence=cost.evidence))
        return recommendations
    if cost.floor == "checkpoint-bound":
        # the warm-failover snapshot cadence floors this engine: the
        # pump spends its ticks gathering/offering KV deltas.  Halve
        # the snapshot frequency (double checkpoint_every, and lift
        # max_checkpoint_lag to match so forced snapshots do not
        # reinstate the old cadence) -- the price is a longer crash-
        # time re-decode, bounded by the new max_checkpoint_lag
        spec = str(parameters.get("checkpoint", "") or "")
        keeper = ""
        try:
            from ..decode.checkpoint import CheckpointPolicy
            policy = CheckpointPolicy.parse(spec)
            current_every = policy.checkpoint_every
            current_lag = policy.max_checkpoint_lag
            keeper = policy.keeper
        except ValueError:
            current_every, current_lag = 8, 32
        proposed_lag = max(current_lag, current_every * 2)
        proposed = (f"checkpoint_every={current_every * 2};"
                    f"max_checkpoint_lag={proposed_lag}")
        if keeper:
            # carry the keeper forward: a proposal that dropped it
            # would silently DISABLE checkpointing when applied
            proposed += f";keeper={keeper}"
        recommendations.append(Recommendation(
            f"element:{name}", "checkpoint", spec or None, proposed,
            f"checkpoint-bound at {name}: snapshot shipping (median "
            f"{engine.get('checkpoint_median_s', 0.0) * 1e3:.1f} ms) "
            "dominates compute and queue wait -- stretch the cadence "
            "(crash-time re-decode grows to the new "
            "max_checkpoint_lag, hot-loop headroom returns)",
            floor=cost.floor, evidence=cost.evidence))
        return recommendations
    if cost.floor == "cache-bound":
        # most prefills borrowed their prompt's leading KV from the
        # prefix cache, so the measured prefill median is the uncached
        # TAIL: the slot/block heuristics below would size the pool
        # for work the cache already absorbed.  The knob that matters
        # is keeping the cache armed across redeploys -- pin
        # prefix_policy when the definition leaves it implicit (and
        # only then: a pin of an already-pinned policy would be a
        # proposed==current no-op)
        if not parameters.get("prefix_policy"):
            recommendations.append(Recommendation(
                f"element:{name}", "prefix_policy", None,
                "prefix_cache=on",
                f"cache-bound at {name}: "
                f"{engine.get('prefix_hit_rate', 0.0):.0%} of judged "
                "prefills borrowed cached prefix KV "
                f"({engine.get('prefix_blocks', 0)} blocks total) -- "
                "pin the policy so redeploys keep the cache, and read "
                "prefill medians as cache-residual tail time, not "
                "kernel time",
                floor=cost.floor, evidence=cost.evidence))
        return recommendations
    if engine.get("queue_median_s", 0.0) > max(compute, 1e-9):
        proposed = min(slots * 2, 64)
        if proposed > slots:
            recommendations.append(Recommendation(
                f"element:{name}", "decode_slots", slots, proposed,
                "engine slot wait exceeds prefill+decode: requests "
                "queue for slots, not for the chip -- more concurrent "
                "slots drain the admission queue",
                floor=cost.floor, evidence=cost.evidence))
    requests = max(engine.get("requests", 0), 1)
    tokens_per_request = engine.get("tokens", 0) / requests
    if (engine.get("preemptions", 0) == 0 and tokens_per_request
            and block_size >= 2
            and tokens_per_request < block_size / 2.0):
        proposed_block = max(block_size // 2, 1)
        recommendations.append(Recommendation(
            f"element:{name}", "kv_block_size", block_size,
            proposed_block,
            f"completions average {tokens_per_request:g} tokens but "
            f"KV blocks hold {block_size}: halving the block halves "
            "over-allocation, so the same pool admits more requests",
            floor=cost.floor, evidence=cost.evidence))
    return recommendations


def _fit_budget(model, slo, settings, recommendations) -> list:
    """Enforce an explicit p99 budget through the replayer: halve the
    LARGEST proposed micro_batch until the prediction fits (or every
    proposal is at 1).  Tighter budget -> monotonically smaller (never
    larger) proposed micro_batch."""
    if slo.p99_budget_s is None:
        return recommendations
    budget_ms = slo.p99_budget_s * 1e3

    def proposal_overrides():
        overrides: dict = {"elements": {}}
        for recommendation in recommendations:
            if (recommendation.knob == "micro_batch"
                    and recommendation.target.startswith("element:")):
                element = recommendation.target.split(":", 1)[1]
                overrides["elements"].setdefault(element, {})[
                    "micro_batch"] = recommendation.proposed
            elif (recommendation.target, recommendation.knob) == (
                    "pipeline", "frame_window"):
                overrides["frame_window"] = recommendation.proposed
        return overrides

    while True:
        score = predict(model, settings, proposal_overrides())
        if score["p99_ms"] <= budget_ms:
            break
        candidates = [r for r in recommendations
                      if r.knob == "micro_batch"
                      and isinstance(r.proposed, int)
                      and r.proposed > 1]
        if not candidates:
            break
        largest = max(candidates, key=lambda r: r.proposed)
        largest.proposed = max(largest.proposed // 2, 1)
        largest.reason += (
            f" [halved to fit p99 budget {budget_ms:g} ms]"
            if "[halved to fit" not in largest.reason else "")
    # proposals reduced all the way to the current value say nothing
    return [r for r in recommendations
            if r.proposed != r.current]


def apply_recommendations(definition_document: dict,
                          recommendations: list) -> tuple:
    """Write recommendations back into a COPY of the definition
    document.  Returns (new_document, diagnostics): knobs whose target
    is missing from the definition become AIKO502 diagnostics instead
    of silent drops."""
    document = copy.deepcopy(definition_document)
    diagnostics: list = []
    elements = {element.get("name"): element
                for element in document.get("elements", [])}
    for recommendation in recommendations:
        if recommendation.target.startswith("element:"):
            name = recommendation.target.split(":", 1)[1]
            element = elements.get(name)
            if element is None:
                diagnostics.append(Diagnostic(
                    "AIKO502",
                    f"recommendation {recommendation.knob}="
                    f"{recommendation.proposed} targets element "
                    f"{name!r}, absent from the definition",
                    definition=document.get("name", "")))
                continue
            element.setdefault("parameters", {})[
                recommendation.knob] = recommendation.proposed
        elif recommendation.target == "pipeline":
            document.setdefault("parameters", {})[
                recommendation.knob] = recommendation.proposed
        elif recommendation.target == "gateway":
            if recommendation.knob in ("autoscale_policy",
                                       "gateway_policy"):
                parameters = document.setdefault("parameters", {})
                if parameters.get(recommendation.knob):
                    diagnostics.append(Diagnostic(
                        "AIKO502",
                        f"{recommendation.knob} already set; "
                        f"proposed {recommendation.proposed!r} NOT "
                        f"applied", definition=document.get("name",
                                                            "")))
                else:
                    parameters[recommendation.knob] = \
                        recommendation.proposed
            else:
                diagnostics.append(Diagnostic(
                    "AIKO502",
                    f"gateway knob {recommendation.knob!r} has no "
                    f"definition representation; apply it to the "
                    f"serving tier directly",
                    definition=document.get("name", "")))
    return document, diagnostics
