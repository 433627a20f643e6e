# Per-element cost model + analytical floor classifier.
#
# The cost model joins the trace's DYNAMIC medians (per-frame compute
# share, scheduler queue wait, coalesced group size, compile events)
# with the STATIC side from analyze/ (byte and flop estimates per
# element from its run on the meta device, analyze/shape_eval.py
# element_cost_estimates), so every number in a tune report is
# attributable to a typed graph node.
#
# Floor classifier (detector-roofline style -- BENCH_NOTES "Detector
# roofline" measured the per-call dispatch floor this formalizes).
# Exactly one label per element, checked in priority order:
#
#   admission-bound (gateway pseudo-node only, fleet-scope traces) the
#                   median admit-wait -- frame submit -> replica
#                   dispatch, parked-queue wait included -- exceeds
#                   the busiest element's compute+queue share: streams
#                   wait at the GATE, not in any replica's kernel --
#                   raise the replica floor and/or lower the admission
#                   rate; no per-element knob can move this floor
#   compile-bound   compile events keep firing past warmup: the
#                   element re-specializes (shape churn / cohort
#                   splits) and wall time is dominated by compilation
#   migration-bound a disaggregated decode element spends more wall
#                   time adopting migrated KV blocks (transfer-plane
#                   fetch + pool scatter) than computing or queueing:
#                   the prefill pool is too remote/slow, not the
#                   kernel -- fix the transfer path or colocate,
#                   a bigger slot pool will not help
#   checkpoint-bound a warm-failover decode element spends more wall
#                   time shipping decode-state snapshots
#                   (decode/checkpoint.py gathers + offers) than
#                   computing or queueing: the snapshot cadence, not
#                   the kernel, is the floor -- stretch
#                   checkpoint_every / max_checkpoint_lag
#   queue-bound     median scheduler wait exceeds median compute: the
#                   element starves behind coalescing or a saturated
#                   slot pool, not its own kernel
#   cache-bound     a prefix-caching decode element serves most
#                   prefills from shared KV blocks (hit rate past
#                   CACHE_HIT_RATE_BOUND): the observed prefill span
#                   is the uncached TAIL, not the full prompt, so the
#                   prefill floor is set by what the cache misses --
#                   pin prefix_policy before tuning slots/blocks, and
#                   read prefill medians as cache-residual time
#   dispatch-bound  median per-CALL time is at the runtime's dispatch
#                   floor (and, when FLOP estimates exist, achieved
#                   utilization is far below peak): the chip is idle
#                   waiting for calls -- batch more, not faster
#   compute-bound   none of the above: the kernel itself is the floor;
#                   only replicas / a faster kernel move it
#   unobserved      the definition declares the element but the trace
#                   carries no spans for it
#
# Every classification carries the evidence numbers the label was
# computed from; thresholds are explicit constants so reports are
# reproducible and arguable.

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["ElementCost", "CostModel", "classify_elements",
           "COMPILE_RATIO_BOUND", "LOW_UTILIZATION_BOUND",
           "CACHE_HIT_RATE_BOUND"]

# compile events per call past which an element is compile-bound: a
# healthy steady state compiles each signature once (a handful of
# events over hundreds of calls); 5% means it keeps re-specializing
COMPILE_RATIO_BOUND = 0.05
# achieved fraction of peak below which a fast call is dispatch- (not
# compute-) bound when a FLOP estimate exists
LOW_UTILIZATION_BOUND = 0.02
# dispatch-floor multiple up to which low utilization still reads as
# dispatch-bound (beyond it the kernel is genuinely running long)
DISPATCH_SPAN_MULTIPLE = 8.0
# prefix-cache hit rate (requests with >= 1 borrowed block / judged
# requests) past which an engine element's prefill floor is the cache
# residual, not the kernel: half the traffic skipping most of its
# prefill means slot/block knobs no longer describe the workload
CACHE_HIT_RATE_BOUND = 0.5


def _median(values: list) -> float:
    if not values:
        return 0.0
    ordered = sorted(values)
    middle = len(ordered) // 2
    if len(ordered) % 2:
        return float(ordered[middle])
    return (ordered[middle - 1] + ordered[middle]) / 2.0


def _quantile(values: list, q: float) -> float:
    if not values:
        return 0.0
    ordered = sorted(values)
    if len(ordered) == 1:
        return float(ordered[0])
    position = q * (len(ordered) - 1)
    low = int(position)
    high = min(low + 1, len(ordered) - 1)
    fraction = position - low
    return ordered[low] + (ordered[high] - ordered[low]) * fraction


@dataclass
class ElementCost:
    """The joined static+dynamic cost record for one graph node."""

    name: str
    calls: int = 0
    compute_median_s: float = 0.0      # per-frame share
    compute_p90_s: float = 0.0
    queue_median_s: float = 0.0
    queue_p90_s: float = 0.0
    group_median: float = 1.0
    per_call_median_s: float = 0.0     # share x group
    paths: dict = field(default_factory=dict)
    compiles: int = 0
    engine: dict | None = None
    # serving-gateway pseudo-node (fleet-scope traces): admit/route
    # medians + replay/shed counts from the gateway's own spans
    gateway: dict | None = None
    # static side (analyze/shape_eval.element_cost_estimates)
    flops_per_row: float | None = None
    bytes_per_row: float | None = None
    param_bytes: float | None = None
    achieved_utilization: float | None = None
    # classification, filled by classify_elements
    floor: str = "unobserved"
    evidence: dict = field(default_factory=dict)


@dataclass
class CostModel:
    elements: dict = field(default_factory=dict)   # name -> ElementCost
    frame_p50_s: float = 0.0
    frame_p99_s: float = 0.0
    frames_per_sec: float = 0.0
    frame_count: int = 0
    wall_s: float = 0.0
    dispatch_floor_s: float = 0.0015
    peak_flops: float | None = None

    @classmethod
    def from_trace(cls, loaded, static_costs: dict | None = None,
                   dispatch_floor_s: float = 0.0015,
                   peak_flops: float | None = None) -> "CostModel":
        """Build the model from a LoadedTrace (+ optional static
        estimates).  `peak_flops` defaults to the peak the embedded
        bench config block recorded, when any."""
        if peak_flops is None:
            assumed = (loaded.config or {}).get("peak_tflops_assumed")
            if isinstance(assumed, (int, float)) and assumed:
                peak_flops = float(assumed) * 1e12
        model = cls(dispatch_floor_s=dispatch_floor_s,
                    peak_flops=peak_flops, wall_s=loaded.wall_s,
                    frame_count=loaded.frame_count)
        durations = loaded.frame_durations_s
        model.frame_p50_s = _median(durations)
        model.frame_p99_s = _quantile(durations, 0.99)
        if loaded.wall_s > 0 and durations:
            model.frames_per_sec = len(durations) / loaded.wall_s
        static_costs = static_costs or {}
        for name, profile in sorted(loaded.elements.items()):
            cost = ElementCost(name=name, calls=profile.calls,
                               paths=dict(profile.paths),
                               compiles=profile.compiles)
            cost.compute_median_s = _median(profile.compute_s)
            cost.compute_p90_s = _quantile(profile.compute_s, 0.9)
            cost.queue_median_s = _median(profile.queue_s)
            cost.queue_p90_s = _quantile(profile.queue_s, 0.9)
            cost.group_median = _median(profile.groups) or 1.0
            cost.per_call_median_s = (cost.compute_median_s
                                      * cost.group_median)
            if profile.is_gateway:
                cost.gateway = {
                    "admit_median_s": _median(profile.gateway_admit_s),
                    "admit_p90_s": _quantile(profile.gateway_admit_s,
                                             0.9),
                    "route_median_s": _median(profile.gateway_route_s),
                    "admits": len(profile.gateway_admit_s),
                    "replays": len(profile.gateway_replay_s),
                    "replay_median_s": _median(
                        profile.gateway_replay_s),
                    "sheds": profile.gateway_sheds,
                    "throttles": profile.gateway_throttles,
                }
            if profile.is_engine_managed:
                cost.engine = {
                    "queue_median_s": _median(
                        profile.engine_queue_s or profile.queue_s),
                    "prefill_median_s": _median(
                        profile.engine_prefill_s),
                    "decode_median_s": _median(
                        profile.engine_decode_s),
                    "adopt_median_s": _median(profile.engine_adopt_s),
                    "adoptions": len(profile.engine_adopt_s),
                    "checkpoint_median_s": _median(
                        profile.engine_checkpoint_s),
                    "checkpoints": len(profile.engine_checkpoint_s),
                    "preemptions": profile.engine_preemptions,
                    "tokens": profile.engine_tokens,
                    "requests": len(profile.engine_decode_s),
                    "prefix_requests": profile.engine_prefix_requests,
                    "prefix_hits": profile.engine_prefix_hits,
                    "prefix_blocks": profile.engine_prefix_blocks,
                    "prefix_hit_rate": (
                        profile.engine_prefix_hits
                        / profile.engine_prefix_requests
                        if profile.engine_prefix_requests else 0.0),
                }
            static = static_costs.get(name)
            if static:
                rows = max(int(static.get("rows") or 1), 1)
                flops = static.get("flops")
                if flops is not None:
                    cost.flops_per_row = float(flops) / rows
                bytes_total = (static.get("bytes_in", 0)
                               + static.get("bytes_out", 0))
                cost.bytes_per_row = float(bytes_total) / rows
                cost.param_bytes = float(
                    static.get("param_bytes") or 0.0)
                if (cost.flops_per_row and peak_flops
                        and cost.per_call_median_s > 0):
                    # rows per call ~= coalesced frames (the per-frame
                    # row count is folded into the static estimate's
                    # leading axis, so this is a lower bound)
                    cost.achieved_utilization = (
                        cost.flops_per_row * cost.group_median
                        / (cost.per_call_median_s * peak_flops))
            model.elements[name] = cost
        return model


def classify_elements(model: CostModel) -> None:
    """Label every element's dominant floor, in place, with the
    evidence each label was computed from."""
    floor_s = model.dispatch_floor_s
    # the fleet's busiest per-frame element share (compute + queue,
    # engine phases included): the yardstick the gateway's admit-wait
    # is judged against -- admission-bound means streams wait at the
    # gate LONGER than any replica spends serving them
    fleet_busy_s = 0.0
    for cost in model.elements.values():
        if cost.gateway is not None:
            continue
        engine = cost.engine or {}
        compute = max(cost.compute_median_s,
                      engine.get("prefill_median_s", 0.0)
                      + engine.get("decode_median_s", 0.0))
        queue_wait = max(cost.queue_median_s,
                         engine.get("queue_median_s", 0.0))
        fleet_busy_s = max(fleet_busy_s, compute + queue_wait)
    for cost in model.elements.values():
        evidence = {
            "calls": cost.calls,
            "compute_median_ms": round(cost.compute_median_s * 1e3, 4),
            "per_call_median_ms": round(
                cost.per_call_median_s * 1e3, 4),
            "queue_median_ms": round(cost.queue_median_s * 1e3, 4),
            "group_median": round(cost.group_median, 2),
            "compiles": cost.compiles,
            "dispatch_floor_ms": round(floor_s * 1e3, 4),
            "paths": dict(cost.paths),
        }
        if cost.achieved_utilization is not None:
            evidence["achieved_utilization"] = round(
                cost.achieved_utilization, 5)
        if cost.engine is not None:
            evidence["engine"] = {
                key: (round(value, 6)
                      if isinstance(value, float) else value)
                for key, value in cost.engine.items()}
        if cost.gateway is not None:
            # the serving tier has exactly two states worth a label:
            # the gate is the floor (admission-bound -- raise replicas
            # / lower the rate), or the gateway's own per-frame work
            # sits at the dispatch floor and the bottleneck is
            # elsewhere (dispatch-bound: not the tier to tune)
            gateway = cost.gateway
            evidence["gateway"] = {
                key: (round(value, 6)
                      if isinstance(value, float) else value)
                for key, value in gateway.items()}
            evidence["fleet_busy_ms"] = round(fleet_busy_s * 1e3, 4)
            cost.evidence = evidence
            admit = gateway.get("admit_median_s", 0.0)
            if admit > max(fleet_busy_s, floor_s):
                cost.floor = "admission-bound"
            else:
                cost.floor = "dispatch-bound"
            continue
        cost.evidence = evidence
        if cost.calls == 0 and cost.engine is None:
            cost.floor = "unobserved"
            continue
        compile_ratio = (cost.compiles / cost.calls
                         if cost.calls else 0.0)
        evidence["compile_ratio"] = round(compile_ratio, 4)
        engine_queue = (cost.engine or {}).get("queue_median_s", 0.0)
        engine_adopt = (cost.engine or {}).get("adopt_median_s", 0.0)
        engine_checkpoint = (cost.engine or {}).get(
            "checkpoint_median_s", 0.0)
        queue_wait = max(cost.queue_median_s, engine_queue)
        if cost.compiles and compile_ratio >= COMPILE_RATIO_BOUND:
            cost.floor = "compile-bound"
        elif engine_adopt > max(cost.compute_median_s, queue_wait,
                                engine_checkpoint, floor_s):
            # disaggregated adoption dominates: the KV migration, not
            # the kernel or the slot queue, is the floor
            cost.floor = "migration-bound"
        elif engine_checkpoint > max(cost.compute_median_s, queue_wait,
                                     floor_s):
            # the warm-failover snapshot cadence dominates: the engine
            # pump spends its ticks gathering/offering KV deltas, not
            # decoding -- stretch checkpoint_every/max_checkpoint_lag
            # (trading crash-time re-decode for hot-loop headroom), a
            # bigger slot pool will not help
            cost.floor = "checkpoint-bound"
        elif queue_wait > max(cost.compute_median_s, floor_s):
            cost.floor = "queue-bound"
        elif ((cost.engine or {}).get("prefix_requests", 0)
              and (cost.engine or {}).get("prefix_hit_rate", 0.0)
              >= CACHE_HIT_RATE_BOUND):
            # most prefills borrowed their prompt's leading KV from
            # the prefix cache: the measured prefill span is the
            # uncached tail, so the floor is cache residency (what the
            # cache misses), not the prefill kernel's speed
            cost.floor = "cache-bound"
        elif cost.per_call_median_s <= floor_s or (
                cost.achieved_utilization is not None
                and cost.achieved_utilization < LOW_UTILIZATION_BOUND
                and cost.per_call_median_s
                <= floor_s * DISPATCH_SPAN_MULTIPLE):
            cost.floor = "dispatch-bound"
        else:
            cost.floor = "compute-bound"
