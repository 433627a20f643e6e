# What-if replayer: re-score a recorded trace under proposed settings
# WITHOUT hardware.
#
# The cost model gives every element an observed per-call time at an
# observed coalesced group size.  The replayer decomposes that into a
# fixed per-call cost (the dispatch floor -- paid once per call
# regardless of batch) plus a linear per-frame cost, then predicts the
# pipeline's steady-state throughput and latency at a DIFFERENT
# micro_batch / frame_window / replica setting from that decomposition:
#
#   per_call(m)  = fixed + slope * m
#   share(m)     = per_call(m) / m          (per-frame cost)
#   throughput   = replicas / max_e share_e(m_e)  (slowest stage rules)
#   service p50  = sum_e per_call_e(m_e) + coalesce wait
#   coalesce wait= (m_e - 1) / (2 * offered rate)   per micro element
#   p99          = p50 * (observed p99 / observed p50)  (shape carried
#                  over from the recorded distribution)
#
# Deliberately simple, fully deterministic arithmetic over the
# recorded medians: two runs over the same trace + settings produce
# bit-identical scores, which is what lets CI assert recommendation
# determinism on a fixture trace.  The model's job is to RANK settings
# and bound budgets, not to forecast absolute numbers -- every score
# carries the inputs it was computed from.

from __future__ import annotations

__all__ = ["predict", "element_settings_of"]


def element_settings_of(definition_document: dict | None) -> dict:
    """Current knob values per element (micro_batch and the decode
    knobs), plus pipeline-level frame_window -- the baseline the
    replayer scores proposals against."""
    settings: dict = {"elements": {}, "frame_window": 16,
                      "replicas": 1}
    if not definition_document:
        return settings
    parameters = definition_document.get("parameters") or {}
    try:
        settings["frame_window"] = int(
            parameters.get("frame_window", 16))
    except (TypeError, ValueError):
        pass
    for element in definition_document.get("elements") or []:
        element_parameters = element.get("parameters") or {}
        knobs = {}
        for knob in ("micro_batch", "decode_slots", "kv_block_size"):
            value = element_parameters.get(knob)
            if value is not None:
                try:
                    knobs[knob] = int(value)
                except (TypeError, ValueError):
                    continue
        knobs.setdefault("micro_batch", 1)
        settings["elements"][element.get("name", "")] = knobs
    return settings


def _merge(base: dict, overrides: dict | None) -> dict:
    merged = {"elements": {name: dict(knobs) for name, knobs
                           in (base.get("elements") or {}).items()},
              "frame_window": base.get("frame_window", 16),
              "replicas": base.get("replicas", 1)}
    for key, value in (overrides or {}).items():
        if key == "elements":
            for name, knobs in (value or {}).items():
                merged["elements"].setdefault(name, {}).update(knobs)
        else:
            merged[key] = value
    return merged


def predict(model, settings: dict, overrides: dict | None = None,
            offered_rate: float | None = None) -> dict:
    """Score one settings dict against the cost model.  Returns
    {"frames_per_sec", "p50_ms", "p99_ms", "bottleneck",
    "per_element"} -- pure arithmetic, bit-deterministic."""
    merged = _merge(settings, overrides)
    replicas = max(int(merged.get("replicas", 1)), 1)
    offered = offered_rate if offered_rate else model.frames_per_sec
    floor_s = model.dispatch_floor_s
    per_element = {}
    slowest_share = 0.0
    bottleneck = ""
    service_s = 0.0
    for name, cost in sorted(model.elements.items()):
        if cost.calls == 0 and cost.engine is None:
            continue
        knobs = merged["elements"].get(name, {})
        group0 = max(cost.group_median, 1.0)
        per_call0 = max(cost.per_call_median_s,
                        cost.compute_median_s, 0.0)
        micro = max(int(knobs.get("micro_batch", round(group0))), 1)
        if cost.engine is not None:
            # engine-managed: slots scale concurrency, not padding.
            # Service time per request is prefill + decode; the slot
            # wait scales inversely with decode_slots
            slots0 = max(int(knobs.get("decode_slots", 0)) or 1, 1)
            base_slots = max(round(group0), 1)
            wait0 = cost.engine.get("queue_median_s", 0.0)
            wait = wait0 * base_slots / slots0 if slots0 else wait0
            compute = (cost.engine.get("prefill_median_s", 0.0)
                       + cost.engine.get("decode_median_s", 0.0)) \
                or per_call0
            share = compute / max(slots0, 1)
            element_service = compute + wait
        else:
            fixed = min(floor_s, per_call0)
            slope = max((per_call0 - fixed) / group0, 0.0)
            per_call = fixed + slope * micro
            share = per_call / micro
            coalesce_wait = ((micro - 1) / (2.0 * offered)
                             if offered > 0 and micro > 1 else 0.0)
            element_service = per_call + coalesce_wait
        service_s += element_service
        if share > slowest_share:
            slowest_share = share
            bottleneck = name
        per_element[name] = {
            "share_ms": round(share * 1e3, 6),
            "service_ms": round(element_service * 1e3, 6),
        }
    throughput = (replicas / slowest_share if slowest_share > 0
                  else 0.0)
    ratio = (model.frame_p99_s / model.frame_p50_s
             if model.frame_p50_s > 0 else 1.0)
    p50_s = service_s
    return {
        "frames_per_sec": round(throughput, 4),
        "p50_ms": round(p50_s * 1e3, 4),
        "p99_ms": round(p50_s * ratio * 1e3, 4),
        "bottleneck": bottleneck,
        "replicas": replicas,
        "per_element": per_element,
    }
